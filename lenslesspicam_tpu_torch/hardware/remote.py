"""Remote hardware control over SSH (port of lenslesspicam_tpu/hardware/remote.py,
host code copied; reference: lensless/hardware/utils.py capture / display,
lensless/hardware/slm.py set_programmable_mask).

Host-side only: nothing here runs on the card.  Gated on paramiko, which a
compute-only environment does not have: every entry point checks the SSH
connection first and raises ``ImportError`` without it.  The commands are
plain ``ssh`` / ``scp`` through ``subprocess``, the same strings as the JAX
package's.  Local scratch files go to ``tempfile.gettempdir()``.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time


def _require_paramiko():
    try:
        import paramiko  # noqa: F401

        return paramiko
    except ImportError as e:
        raise ImportError(
            "Remote capture/display requires paramiko (SSH); install it on a "
            "host with access to the Raspberry Pi."
        ) from e


def check_username_hostname(rpi_username, rpi_hostname, timeout=10):
    """Verify SSH connectivity (hardware/utils.py:293-309); returns the
    connected client."""
    paramiko = _require_paramiko()
    client = paramiko.SSHClient()
    client.load_system_host_keys()
    client.set_missing_host_key_policy(paramiko.WarningPolicy())
    client.connect(rpi_hostname, username=rpi_username, timeout=timeout)
    return client


def capture(
    rpi_username,
    rpi_hostname,
    sensor="rpi_hq",
    bayer=True,
    exp=0.02,
    fn="capture",
    iso=100,
    config_pause=2,
    sensor_mode="0",
    nbits_out=12,
    legacy=True,
    rgb=False,
    gray=False,
    nbits=12,
    down=None,
    awb_gains=None,
    rpi_python="~/LenslessPiCam/lensless_env/bin/python",
    capture_script="~/LenslessPiCam/scripts/measure/on_device_capture.py",
    verbose=False,
    output_path=None,
    **kwargs,
):
    """Capture on the RPi over SSH, scp the file back, and load it
    (hardware/utils.py:23-238).

    Returns ``(localfile, img)``: the local path of the retrieved file
    and the loaded (and, for raw Bayer, ISP-converted) array.  The
    on-device tool prints a ``key : value`` report (distribution,
    frozen AWB gains) that is parsed here to pick the retrieval path
    and the demosaic gains."""
    from .sensor import SensorOptions

    assert sensor in SensorOptions.values(), (
        f"sensor must be one of {SensorOptions.values()}")
    check_username_hostname(rpi_username, rpi_hostname).close()

    remote_fn = "remote_capture"
    pic_command = (
        f"{rpi_python} {capture_script} sensor={sensor} bayer={bayer} "
        f"fn={remote_fn} exp={exp} iso={iso} config_pause={config_pause} "
        f"sensor_mode={sensor_mode} nbits_out={nbits_out} "
        f"legacy={legacy} rgb={rgb} gray={gray}"
    )
    if nbits > 8:
        pic_command += " sixteen=True"
    if down:
        pic_command += f" down={down}"
    if awb_gains:
        pic_command += f" awb_gains=[{awb_gains[0]},{awb_gains[1]}]"
    if verbose:
        print(f"COMMAND : {pic_command}")

    ssh = subprocess.Popen(
        ["ssh", f"{rpi_username}@{rpi_hostname}", pic_command],
        shell=False, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    result = [line.decode("utf-8") for line in ssh.stdout.readlines()]
    error = [line.decode("utf-8") for line in ssh.stderr.readlines()]
    # the libcamera stack logs to stderr even on success
    if error and legacy:
        raise RuntimeError(f"remote capture failed: {error}")
    if not result:
        raise RuntimeError(f"remote capture produced no output: {error}")
    report = {}
    for line in result:
        if ":" in line and len(line) > 3:
            key, _, val = line.partition(":")
            report[key.strip()] = val.strip()
    if verbose:
        print("COMMAND OUTPUT :", report)

    from ..data.io import load_image

    def _scp(remote, local):
        subprocess.run(
            f'scp "{rpi_username}@{rpi_hostname}:{remote}" {local}',
            shell=True, check=True, capture_output=not verbose,
        )

    modern = "bullseye" in report.get("RPi distribution", "") and not legacy
    if modern and bayer:
        localfile = f"{fn}.dng"
        if output_path is not None:
            localfile = os.path.join(output_path, localfile)
        _scp(f"~/{remote_fn}.dng", localfile)
        img = load_image(localfile, verbose=verbose, bayer=bayer, nbits_out=nbits_out)
    else:
        localfile = f"{fn}.png"
        if output_path is not None:
            localfile = os.path.join(output_path, localfile)
        _scp(f"~/{remote_fn}.png", localfile)
        if modern or rgb or gray:
            img = load_image(localfile, verbose=verbose)
        else:
            # raw legacy PNG: demosaic locally with the frozen gains the
            # device reported (or the requested awb_gains for ISP output)
            if bayer:
                red_gain = float(report.get("Red gain", 0) or 0) or None
                blue_gain = float(report.get("Blue gain", 0) or 0) or None
            else:
                red_gain, blue_gain = awb_gains
            img = load_image(localfile, verbose=verbose, bayer=bayer, blue_gain=blue_gain,
                             red_gain=red_gain, nbits_out=nbits_out)
            if not bayer:
                import cv2

                cv2.imwrite(localfile, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return localfile, img


def display(
    fp,
    rpi_username,
    rpi_hostname,
    screen_res=(1920, 1080),
    brightness=100,
    rot90=0,
    pad=0,
    vshift=0,
    hshift=0,
    remote_path="~/LenslessPiCam_display/test.png",
    wait=2,
):
    """Push an image to the RPi display (hardware/utils.py:239-292)."""
    check_username_hostname(rpi_username, rpi_hostname).close()
    subprocess.run(
        f"scp {fp} {rpi_username}@{rpi_hostname}:{remote_path}",
        shell=True, check=True,
    )
    time.sleep(wait)


def set_programmable_mask(pattern, device="adafruit", rpi_username=None, rpi_hostname=None):
    """scp a mask pattern (an array or a tensor on any device) and run the
    slm-controller script on the RPi (slm.py:45-123)."""
    import numpy as np

    from .._device import as_host

    assert rpi_username and rpi_hostname
    check_username_hostname(rpi_username, rpi_hostname).close()
    local = os.path.join(tempfile.gettempdir(), "slm_pattern.npy")
    np.save(local, as_host(pattern, None))
    subprocess.run(
        f"scp {local} {rpi_username}@{rpi_hostname}:~/slm_pattern.npy",
        shell=True, check=True,
    )
    subprocess.run(
        f"ssh {rpi_username}@{rpi_hostname} "
        f"'python ~/slm-controller/examples/set_pattern.py --device {device} "
        f"--pattern ~/slm_pattern.npy'",
        shell=True, check=True,
    )


def set_mask_sensor_distance(distance_mm, rpi_username, rpi_hostname, max_distance_mm=16):
    """Drive the stepper motors to set the mask-sensor distance
    (hardware/utils.py:336+)."""
    assert 0 <= distance_mm <= max_distance_mm
    check_username_hostname(rpi_username, rpi_hostname).close()
    subprocess.run(
        f"ssh {rpi_username}@{rpi_hostname} "
        f"'python ~/StepperDriver/move.py --distance {distance_mm}'",
        shell=True, check=True,
    )
