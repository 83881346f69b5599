"""The port's capture apps (``lenslesspicam_tpu_torch/scripts/measure``:
``remote_display``, ``remote_capture``, ``prep_display_image``,
``on_device_capture``, ``collect_dataset_on_device``; ``scripts/hardware``:
``set_digicam_mask_distance``, ``config_digicam``,
``digicam_measure_psfs``) against the JAX package's scripts of the same
paths, in-process on the CPU (``LPT_PLATFORM=cpu``) on the same seeded
inputs; the helpers and tolerances of ``tests/test_torch_scripts.py``.

The apps on the host reach the Raspberry Pi only through each package's
``hardware/remote.py``, run here under ``StandInPi``: a stand-in
``paramiko`` in ``sys.modules`` and recorders of ``subprocess.Popen`` /
``subprocess.run``.  The SSH capture reports a legacy Pi with its gains,
and the ``scp`` of a capture writes a seeded raw Bayer PNG whose level
grows with the exposure the command asked for.  Both packages must issue
the same commands (run directories and timestamps made equal), print the
same lines and write the same files: a pattern or an 8-bit image bit for
bit where no float arithmetic differs, else within one level, and what
ADMM makes of a capture within TOL_SIM_RECON.

``on_device_capture`` runs on the Pi: stand-in ``picamerax`` /
``picamera2`` modules and recorders of ``subprocess.Popen`` and
``os.system`` take the camera's place.  Its printed lines, which
``hardware/remote.capture`` parses, and its recorded calls are compared
byte for byte on every branch (legacy raw Bayer at 8 and 16 bits, with the
on-device RGB and gray conversion, legacy ISP PNG, modern DNG and PNG).
No test needs the network, paramiko, a camera or a Raspberry Pi.

The last test holds what ``chip_smoke.py``'s phase ``cli3`` rests on: its
stand-in Pi, which runs the port's ``on_device_capture``, and the demo's
red-channel CPU reference.
"""

import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import cv2
import numpy as np
import numpy.testing  # noqa: F401  (its import runs lscpu: before subprocess is recorded)
import pytest
import torch

from test_torch_scripts import (APPS, TOL_ADMM, TOL_SIM_RECON, _nerr, _png_levels,  # noqa: F401
                                _run, one_thread)

pytestmark = pytest.mark.usefixtures("one_thread")

RAW = (48, 64)              # the stand-in Pi's raw Bayer frame
HOT = 2100                  # its one hot green pixel: 12-bit level 866 at 5 ms, 2491 at 10 ms


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("LPT_PLATFORM", "cpu")
    monkeypatch.setattr(time, "sleep", lambda s: None)


class StandInPi:
    """A stand-in ``paramiko`` and recorders of ``subprocess``: the SSH
    capture reports a legacy Raspberry Pi with its gains, and the ``scp``
    of a capture writes ``raw(exp)``, a seeded 12-bit raw Bayer frame
    scaled by the exposure of the last capture command with one hot pixel
    (``load_image`` infers the bit depth from the frame's max), where it
    is fetched to.  ``calls`` records every connection and command, and
    ``patterns`` the content of every mask pattern file sent."""

    REPORT = ["RPi distribution : buster\n", "Red gain : 1.9\n", "Blue gain : 1.6\n"]

    def __init__(self, monkeypatch, shape=RAW, base=0.4, seed=4, raw=None):
        self.calls, self.patterns, self.exps = [], [], []
        rec = self
        frame = np.random.RandomState(seed).rand(*shape)

        def raw_of(exp):
            if raw is not None:
                return raw
            out = np.clip(frame * base * exp / 0.02 * 4095, 0, 4095).astype(np.uint16)
            out[0, 1] = max(out[0, 1], HOT)     # the loader infers 12 bits at every exposure
            return out

        class SSHClient:
            def load_system_host_keys(self):
                pass

            def set_missing_host_key_policy(self, policy):
                pass

            def connect(self, *args, **kw):
                rec.calls.append(("connect", args, kw))

            def close(self):
                pass

        class Popen:
            def __init__(self, args, **kw):
                rec.calls.append(("Popen", args))
                m = re.search(r" exp=(\S+)", args[-1])
                rec.exps.append(float(m.group(1)) if m else None)
                self.stdout = types.SimpleNamespace(readlines=lambda: [
                    ln.encode() for ln in StandInPi.REPORT])
                self.stderr = types.SimpleNamespace(readlines=lambda: [])

        save = np.save

        def save_pattern(fp, arr, *args, **kw):
            # recorded, not written: the stand-in scp never reads it, and the
            # JAX package would write it at the fixed path /tmp/slm_pattern.npy
            if str(fp).endswith("slm_pattern.npy"):
                rec.patterns.append(np.array(arr))
                return None
            return save(fp, arr, *args, **kw)

        def run(cmd, **kw):
            rec.calls.append(("run", re.sub(r"\S*slm_pattern\.npy ", "<pattern> ", cmd)))
            m = re.match(r'scp "[^"]+:~/\S+\.png" (\S+)$', cmd)
            if m:
                assert cv2.imwrite(m.group(1), raw_of(rec.exps[-1]))

        monkeypatch.setitem(sys.modules, "paramiko", types.SimpleNamespace(
            SSHClient=SSHClient, WarningPolicy=type("WarningPolicy", (), {})))
        monkeypatch.setattr(subprocess, "Popen", Popen)
        monkeypatch.setattr(subprocess, "run", run)
        monkeypatch.setattr(np, "save", save_pattern)


def _same(text, tmp_path):
    """``text`` with the two run roots and the timestamps made equal."""
    for side in ("jax", "port"):
        text = text.replace(str(tmp_path / side), "<out>")
    text = re.sub(r"\d{4}-\d\d-\d\d/\d\d-\d\d-\d\d", "<time>", text)
    return re.sub(r"\d+\.\d+ min", "# min", text)


def _sides(tmp_path, name, args_of, monkeypatch, capsys, **pi):
    """Each package's app under its own ``StandInPi``: {side: (result, pi,
    printed lines)}, the run directories, timestamps and timings made
    equal."""
    port, jax_app, entry = APPS[name]
    out = {}
    for side, mod in (("jax", jax_app), ("port", port)):
        rpi = StandInPi(monkeypatch, **pi)
        res = _run(getattr(mod, entry), args_of(side), tmp_path / side)
        rpi.calls = [tuple(_same(str(x), tmp_path) for x in c) for c in rpi.calls]
        out[side] = (res, rpi, _same(capsys.readouterr().out, tmp_path).splitlines())
    return out


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


PI = ["rpi.username=pi", "rpi.hostname=host"]


# --- remote_display, remote_capture, set_digicam_mask_distance ------------------------

def test_remote_display_app_matches_jax(tmp_path, monkeypatch, capsys):
    img = tmp_path / "img.png"
    cv2.imwrite(str(img), np.zeros((4, 4, 3), np.uint8))
    out = _sides(tmp_path, "measure.remote_display",
                 lambda side: [*PI, f"fp={img}", "display.brightness=50"], monkeypatch, capsys)
    assert out["port"][1].calls == out["jax"][1].calls
    assert [c[0] for c in out["port"][1].calls] == ["connect", "run"]
    assert out["port"][2] == out["jax"][2] == [f"displayed {img}"]
    assert out["port"][0] is None


@pytest.mark.parametrize("bayer", [True, False])
def test_remote_capture_app_matches_jax(tmp_path, monkeypatch, capsys, bayer):
    """The capture fetched into the run directory, re-saved with
    ``load_image(bayer=False)`` over the raw PNG: the same commands, lines
    and files."""
    args = [*PI, "capture.exp=0.05", f"capture.bayer={bayer}", "capture.nbits_out=8"]
    if not bayer:
        args.append("capture.awb_gains=[1.5,1.2]")
    out = _sides(tmp_path, "measure.remote_capture", lambda side: args, monkeypatch, capsys)
    assert out["port"][1].calls == out["jax"][1].calls
    assert out["port"][2] == out["jax"][2]
    assert out["port"][2][-1].startswith("captured <out>/")
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for f in _files(tmp_path / "port"):
        if f.endswith(".png"):
            assert _png_levels(tmp_path / "port" / f, tmp_path / "jax" / f) == 0, f


def test_set_digicam_mask_distance_app_matches_jax(tmp_path, monkeypatch, capsys):
    out = _sides(tmp_path, "hardware.set_digicam_mask_distance",
                 lambda side: [*PI, "distance_mm=2.5"], monkeypatch, capsys)
    assert out["port"][1].calls == out["jax"][1].calls
    assert "--distance 2.5" in out["port"][1].calls[-1][1]
    assert out["port"][2] == out["jax"][2] == ["mask-sensor distance set to 2.5 mm"]


# --- prep_display_image --------------------------------------------------------------

@pytest.mark.parametrize("opts", [[], ["pad=10", "rot90=1", "vshift=-7", "hshift=12",
                                       "brightness=60"], ["pad=0.2", "screen_res=[90,160]"]])
def test_prep_display_image_app_matches_jax(tmp_path, capsys, opts):
    """The padded, rotated, shifted and dimmed canvas at the screen's
    resolution (``screen_res`` cut to 108 x 192 for speed unless set)."""
    rng = np.random.RandomState(5)
    img = tmp_path / "img.png"
    cv2.imwrite(str(img), (rng.rand(40, 30, 3) * 255).astype(np.uint8))
    args = [f"fp={img}", *opts]
    if not any(o.startswith("screen_res") for o in opts):
        args.append("screen_res=[108,192]")
    port, jax_app, entry = APPS["measure.prep_display_image"]
    _run(getattr(jax_app, entry), args, tmp_path / "jax")
    _run(getattr(port, entry), args, tmp_path / "port")
    lines = _same(capsys.readouterr().out, tmp_path).splitlines()
    assert lines[0] == lines[1] and lines[0].endswith("display.png")
    a, b = (next((tmp_path / s).rglob("display.png")) for s in ("port", "jax"))
    assert cv2.imread(str(a)).shape[:2] == tuple(int(v) for v in re.findall(
        r"\d+", next(o for o in args if o.startswith("screen_res"))))
    assert _png_levels(a, b) <= 1


# --- config_digicam, digicam_measure_psfs ---------------------------------------------

@pytest.mark.parametrize("source", ["seeded", "file"])
def test_config_digicam_app_matches_jax(tmp_path, monkeypatch, capsys, source):
    """The seeded (or stored) uint8 pattern saved in the run directory and
    set on the Pi: the same pattern file, the same sent pattern, the same
    commands and lines."""
    args = [*PI, "seed=3", "shape=[12,16]"]
    if source == "file":
        np.save(tmp_path / "p.npy", np.random.RandomState(9).randint(0, 255, (3, 8, 10))
                .astype(np.uint8))
        args.append(f"pattern={tmp_path / 'p.npy'}")
    out = _sides(tmp_path, "hardware.config_digicam", lambda side: args, monkeypatch, capsys)
    assert out["port"][1].calls == out["jax"][1].calls
    assert out["port"][2] == out["jax"][2] and out["port"][2][-1] == "mask programmed"
    saved = {s: np.load(next((tmp_path / s).rglob("pattern.npy"))) for s in ("port", "jax")}
    np.testing.assert_array_equal(saved["port"], saved["jax"])
    np.testing.assert_array_equal(out["port"][1].patterns[0], out["jax"][1].patterns[0])
    np.testing.assert_array_equal(out["port"][1].patterns[0], saved["port"])
    assert saved["port"].shape == ((3, 12, 16) if source == "seeded" else (3, 8, 10))


def test_config_digicam_app_without_a_pi(tmp_path, monkeypatch, capsys):
    """No ``rpi.username``: the pattern is only saved; nothing reaches SSH."""
    out = _sides(tmp_path, "hardware.config_digicam", lambda side: ["save=True"],
                 monkeypatch, capsys)
    assert out["port"][1].calls == out["jax"][1].calls == []
    assert out["port"][2] == out["jax"][2] and len(out["port"][2]) == 1


def test_digicam_measure_psfs_app_matches_jax(tmp_path, monkeypatch, capsys):
    """Each pattern set, then its PSF captured as ``psf_{i:04d}``."""
    masks = np.random.RandomState(6).randint(0, 255, (2, 3, 8, 10)).astype(np.uint8)
    np.save(tmp_path / "masks.npy", masks)
    out = _sides(tmp_path, "hardware.digicam_measure_psfs",
                 lambda side: [*PI, f"masks={tmp_path / 'masks.npy'}", "capture.exp=0.05"],
                 monkeypatch, capsys)
    assert out["port"][1].calls == out["jax"][1].calls
    assert out["port"][2] == out["jax"][2]
    assert [ln.split()[0] for ln in out["port"][2]] == ["[0]", "[1]"]
    for side in ("port", "jax"):
        for k in range(2):
            np.testing.assert_array_equal(out[side][1].patterns[k], masks[k])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for f in _files(tmp_path / "port"):
        if f.endswith(".png"):
            assert _png_levels(tmp_path / "port" / f, tmp_path / "jax" / f) == 0, f


# --- on_device_capture (on the Pi) -----------------------------------------------------

class StandInCamera:
    """Stand-in ``picamerax`` (with ``picamerax.array``) and ``picamera2``
    modules, and recorders of ``subprocess.Popen`` and ``os.system``: every
    call and attribute set is appended to ``calls``; captures write seeded
    frames."""

    def __init__(self, monkeypatch):
        from fractions import Fraction

        self.calls = []
        rec = self
        rng = np.random.RandomState(8)
        bayer = np.zeros((32, 48, 3), np.uint16)
        bayer[0::2, 0::2, 0] = rng.randint(0, 1024, (16, 24))
        bayer[0::2, 1::2, 1] = rng.randint(0, 1024, (16, 24))
        bayer[1::2, 0::2, 1] = rng.randint(0, 1024, (16, 24))
        bayer[1::2, 1::2, 2] = rng.randint(0, 1024, (16, 24))
        isp = (rng.rand(24, 32, 3) * 255).astype(np.uint8)

        class PiCamera:
            MAX_RESOLUTION = (4056, 3040)

            def __init__(self, **kw):
                object.__setattr__(self, "_attrs", {
                    "resolution": kw.get("resolution"), "framerate": kw.get("framerate"),
                    "awb_gains": (Fraction(19, 10), Fraction(8, 5)), "iso": 0,
                    "shutter_speed": 0})
                rec.calls.append(("PiCamera", sorted(kw.items(), key=str)))

            def __getattr__(self, name):
                return self._attrs[name]

            def __setattr__(self, name, value):
                rec.calls.append(("set", name, str(value)))
                self._attrs[name] = value

            def close(self):
                rec.calls.append(("close",))

            def capture(self, target, *args, **kw):
                rec.calls.append(("capture", target if isinstance(target, str)
                                  else type(target).__name__, args, sorted(kw.items())))
                if isinstance(target, str):
                    cv2.imwrite(target, isp)
                else:
                    target.array = bayer

        class PiBayerArray:
            def __init__(self, camera):
                self.array = None

        class Config(types.SimpleNamespace):
            def enable_raw(self):
                rec.calls.append(("enable_raw",))

        class Picamera2:
            camera_properties = {"PixelArraySize": (4056, 3040)}

            def __init__(self):
                self.preview_configuration = types.SimpleNamespace(
                    main=types.SimpleNamespace(size=None))
                self.still_configuration = Config(size=None, raw=types.SimpleNamespace(size=None))

            def __getattr__(self, name):
                def method(*args, **kw):
                    rec.calls.append((name, args, sorted(kw.items())))
                    if name == "switch_mode_and_capture_file":
                        cv2.imwrite(args[1], isp)
                    return "config" if name.startswith("create") else None
                return method

        class Popen:
            def __init__(self, args, **kw):
                rec.calls.append(("Popen", args))
                self.stdout = types.SimpleNamespace(readlines=lambda: [])
                self.stderr = types.SimpleNamespace(readlines=lambda: [])

        array = types.ModuleType("picamerax.array")
        array.PiBayerArray = PiBayerArray
        picamerax = types.ModuleType("picamerax")
        picamerax.PiCamera, picamerax.array = PiCamera, array
        picamera2 = types.ModuleType("picamera2")
        picamera2.Picamera2, picamera2.Preview = Picamera2, types.SimpleNamespace(NULL="null")
        monkeypatch.setitem(sys.modules, "picamerax", picamerax)
        monkeypatch.setitem(sys.modules, "picamerax.array", array)
        monkeypatch.setitem(sys.modules, "picamera2", picamera2)
        monkeypatch.setattr(subprocess, "Popen", Popen)
        monkeypatch.setattr(os, "system", lambda cmd: rec.calls.append(("system", cmd)))


ON_DEVICE = {
    "legacy_bayer": ["bayer=True"],
    "legacy_bayer_sixteen": ["bayer=True", "sixteen=True"],
    "legacy_rgb_down": ["bayer=True", "rgb=True", "down=2", "awb_gains=[1.7,1.3]"],
    "legacy_gray_sixteen": ["bayer=True", "gray=True", "sixteen=True"],
    "legacy_png": ["bayer=False", "awb_gains=[1.5,1.2]"],
    "legacy_png_down": ["bayer=False", "down=4"],
    "modern_dng": ["legacy=False", "bayer=True", "iso=200", "exp=0.05"],
    "modern_png": ["legacy=False", "bayer=False", "down=2", "awb_gains=[1.5,1.2]"],
}


@pytest.mark.parametrize("case", ON_DEVICE)
def test_on_device_capture_matches_jax(tmp_path, monkeypatch, capsys, case):
    """The lines ``hardware/remote.capture`` parses and the camera calls,
    byte for byte, and the written frame (bit for bit, or within one level
    after the on-device cubic downsample)."""
    port, jax_app, entry = APPS["measure.on_device_capture"]
    distro = "Raspbian GNU/Linux 11 (bullseye)" if case.startswith("modern") else \
        "Raspbian GNU/Linux 10 (buster)"
    printed, calls = {}, {}
    for side, mod in (("jax", jax_app), ("port", port)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        monkeypatch.setattr(mod, "get_distro", lambda: distro)
        cam = StandInCamera(monkeypatch)
        assert getattr(mod, entry)([*ON_DEVICE[case], "output_dir=runs"]) is None
        printed[side], calls[side] = capsys.readouterr().out, cam.calls
    assert printed["port"] == printed["jax"]
    assert calls["port"] == calls["jax"]
    assert printed["port"].startswith(f"RPi distribution : {distro}\n")
    saved = printed["port"].splitlines()[-1].split(" : ")[1]
    if case == "modern_dng":
        assert saved == "capture.dng" and ("system", "exiftool capture.dng") in calls["port"]
        return
    a, b = (tmp_path / s / saved for s in ("port", "jax"))
    assert _png_levels(a, b) <= (1 if "down" in case and "legacy_rgb" in case else 0)
    if case.startswith("legacy_bayer") or case.startswith("legacy_rgb"):
        assert "Red gain : 1.9\nBlue gain : 1.6\n" in printed["port"]


def test_on_device_capture_distro_and_checks(monkeypatch, tmp_path):
    """``get_distro`` reads the same ``/etc/os-release`` line as the JAX
    app; the sensor, bit depth and exposure checks raise as its do."""
    port, jax_app, entry = APPS["measure.on_device_capture"]
    assert port.get_distro() == jax_app.get_distro()
    monkeypatch.chdir(tmp_path)
    for bad in (["sensor=nope"], ["nbits_out=10"], ["exp=1000"],
                ["sensor=rpi_gs", "legacy=True"]):
        for mod in (jax_app, port):
            with pytest.raises(AssertionError):
                getattr(mod, entry)([*bad, "output_dir=runs"])


def test_on_device_capture_needs_no_card(tmp_path, monkeypatch, capsys):
    """It builds no tensor: without ``LPT_PLATFORM=cpu`` and without a CUDA
    card it still captures (it runs on the Pi, where no card can be), and
    it runs by path as ``hardware/remote.capture`` starts it."""
    port, _, entry = APPS["measure.on_device_capture"]
    monkeypatch.delenv("LPT_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    proc = subprocess.run(
        [sys.executable, str(Path(port.__file__)), "sensor=nope", "output_dir=runs"],
        cwd=tmp_path, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0 and "sensor must be one of" in proc.stderr
    monkeypatch.setattr(port, "get_distro", lambda: "buster")
    StandInCamera(monkeypatch)
    getattr(port, entry)(["bayer=False", "output_dir=runs"])
    assert capsys.readouterr().out.endswith("Image saved to : capture.png\n")


# --- collect_dataset_on_device ---------------------------------------------------------

def _inputs(folder, n=3, shape=(24, 32)):
    folder.mkdir(parents=True)
    rng = np.random.RandomState(12)
    for i in range(n):
        cv2.imwrite(str(folder / f"im{i + 1}.png"), (rng.rand(*shape, 3) * 255).astype(np.uint8))
    return folder


COLLECT = ["capture.nbits_out=12", "min_level=1200", "max_level=3000", "max_tries=3",
           "display.delay=0"]


@pytest.mark.parametrize("case", ["adaptive", "bright", "masks_bg_recon"])
def test_collect_dataset_app_matches_jax(tmp_path, monkeypatch, capsys, case):
    """The adaptive exposure (too dark, then in the band; or too bright at
    the shortest shutter, so the screen dims), the seeded mask pool set in
    turn at its center, the background captures and their mapping, and
    the on-line ADMM of each capture; then a second run resumes and
    captures nothing."""
    inputs = _inputs(tmp_path / "in")
    args = [*PI, f"input_dir={inputs}", *COLLECT]
    if case == "adaptive":
        args.append("capture.exp=0.005")
    elif case == "bright":
        args += ["capture.exp=0.08", "min_shutter_us=100000"]
    else:
        psf = (np.random.RandomState(13).rand(*RAW, 3) * 200 + 20).astype(np.uint8)
        cv2.imwrite(str(tmp_path / "psf.png"), psf)
        args += ["capture.exp=0.04", "masks={n: 2, shape: [6, 8], seed: 1, center: [59, 76]}",
                 "capture.measure_bg=2", f"recon={{psf: {tmp_path / 'psf.png'}, n_iter: 3}}"]
    out = _sides(tmp_path, "measure.collect_dataset_on_device",
                 lambda side: [*args, f"measured_dir={tmp_path / side / 'measured'}"],
                 monkeypatch, capsys)
    assert out["port"][1].calls == out["jax"][1].calls
    assert out["port"][1].exps == out["jax"][1].exps
    assert out["port"][2] == out["jax"][2]
    assert out["port"][0] is None
    lines = "\n".join(out["port"][2])
    if case == "adaptive":
        assert "increasing exposure to 0.0100s" in lines
    elif case == "bright":
        assert "decreasing screen brightness to 90" in lines
    files = _files(tmp_path / "port" / "measured")
    assert files == _files(tmp_path / "jax" / "measured")
    assert {"im1.png", "im2.png", "im3.png"} <= set(files)
    for f in files:
        a, b = tmp_path / "port" / "measured" / f, tmp_path / "jax" / "measured" / f
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        elif f.startswith("recon"):
            assert _png_levels(a, b) <= 1, f
        elif f.endswith(".png"):
            assert _png_levels(a, b) == 0, f
        else:
            assert a.read_text() == b.read_text(), f
    if case == "masks_bg_recon":
        assert {"recon/im1.png", "masks/mask_1.npy", "bg_mappings.json",
                "black_background0.png"} <= set(files)
        for k in range(3):
            np.testing.assert_array_equal(out["port"][1].patterns[k],
                                          out["jax"][1].patterns[k])
    # a second run finds every output and captures nothing
    again = _sides(tmp_path / "again", "measure.collect_dataset_on_device",
                   lambda side: [*args, f"measured_dir={tmp_path / side / 'measured'}"],
                   monkeypatch, capsys)
    assert [c for c in again["port"][1].calls if c[0] == "Popen"] == []
    assert again["port"][2][:2] == again["jax"][2][:2]


def test_collect_dataset_online_admm_matches_jax(tmp_path, monkeypatch):
    """What the on-line ADMM saves is the port's exact ``ADMM`` of the
    capture: within TOL_SIM_RECON of the JAX solve on the same capture
    (the PNGs compared above are quantized)."""
    from lenslesspicam_tpu import ADMM as JADMM
    from lenslesspicam_tpu.data.io import load_image, load_psf
    from lenslesspicam_tpu_torch import ADMM as TADMM

    psf_fp = tmp_path / "psf.png"
    cv2.imwrite(str(psf_fp), (np.random.RandomState(13).rand(*RAW, 3) * 200 + 20)
                .astype(np.uint8))
    inputs = _inputs(tmp_path / "in", n=1)
    saved = {}
    port, _, entry = APPS["measure.collect_dataset_on_device"]
    StandInPi(monkeypatch)
    from lenslesspicam_tpu_torch.data import io as tio

    monkeypatch.setattr(tio, "save_image", lambda img, fp, **kw: saved.setdefault(fp, img))
    _run(getattr(port, entry), [*PI, f"input_dir={inputs}", *COLLECT, "capture.exp=0.04",
                                f"recon={{psf: {psf_fp}, n_iter: 3}}",
                                f"measured_dir={tmp_path / 'measured'}"], tmp_path / "out")
    (fp, res), = saved.items()
    assert fp.endswith("recon/im1.png")
    img = np.asarray(load_image(str(tmp_path / "measured" / "im1.png"), bayer=True,
                                red_gain=1.9, blue_gain=1.6, nbits_out=12), np.float32)
    ref = JADMM(load_psf(str(psf_fp)), n_iter=3)
    ref.set_data((img / img.max())[None])
    assert _nerr(res, np.asarray(ref.apply())) <= TOL_SIM_RECON
    check = TADMM(load_psf(str(psf_fp)), n_iter=3, device="cpu")
    check.set_data((img / img.max())[None])
    assert _nerr(res, check.apply().numpy()) == 0.0


def test_collect_dataset_dummy_copies_inputs(tmp_path, monkeypatch, capsys):
    """``dummy=true``: no hardware, the inputs copied through, a cap of
    ``n_files``."""
    inputs = _inputs(tmp_path / "in")
    out = _sides(tmp_path, "measure.collect_dataset_on_device",
                 lambda side: [f"input_dir={inputs}", "dummy=True", "n_files=2",
                               f"measured_dir={tmp_path / side / 'measured'}"],
                 monkeypatch, capsys)
    assert out["port"][1].calls == out["jax"][1].calls == []
    assert out["port"][2] == out["jax"][2]
    assert "TEST : collecting first 2 files!" in out["port"][2]
    assert _files(tmp_path / "port" / "measured") == ["im1.png", "im2.png"]


# --- chip_smoke.py's phase cli3 ----------------------------------------------------------

def test_cli3_stand_in_pi_and_red_channel_reference(tmp_path):
    """``chip_smoke._StandInPi`` serves the port's ``remote.capture``
    through the port's ``on_device_capture``: a raw capture comes back as
    the frame of its exposure bit for bit, and the on-device RGB conversion
    of ``rgb_mosaic``'s frame peaks at CLI3_LEVEL of full scale at CLI3_EXP
    and at half of it at half the exposure (the collection's adaptive band).
    ``_cli3_cpu_solve`` on the red channel alone is the red channel of the
    three-channel solve (the demo's CPU reference on the card)."""
    import chip_smoke as cs
    from lenslesspicam_tpu_torch.hardware import remote

    yy, xx = np.mgrid[0:64, 0:96] / 64.0
    rgb = np.stack([0.5 + 0.5 * np.sin(5 * xx + c + 3 * yy) for c in range(3)], -1)
    raw = cs.rgb_mosaic(rgb, cs.CLI3_LEVEL)
    home = tmp_path / "pi"
    home.mkdir()
    with cs._StandInPi(raw, str(home)) as pi:
        fp, img = remote.capture("pi", "stand-in", fn="raw", exp=0.02, config_pause=0,
                                 output_path=str(tmp_path))
        levels = [remote.capture("pi", "stand-in", exp=exp, rgb=True, down=2, nbits_out=8,
                                 config_pause=0, output_path=str(tmp_path))[1].max()
                  for exp in (cs.CLI3_EXP, cs.CLI3_EXP / 2)]
    assert pi.exposures == [0.02, cs.CLI3_EXP, cs.CLI3_EXP / 2]
    np.testing.assert_array_equal(cv2.imread(fp, cv2.IMREAD_UNCHANGED),
                                  pi.planes(0.02).sum(-1).astype(np.uint16))
    assert img.shape == (64, 96, 3)
    assert abs(levels[0] / 255 - cs.CLI3_LEVEL) <= 0.05 and abs(levels[1] / levels[0] - 0.5) <= 0.02

    from lenslesspicam_tpu_torch import ADMM

    rng = np.random.RandomState(3)
    with cs._Cli3Records() as rec:
        import lenslesspicam_tpu_torch as lpt

        solver = lpt.ADMM(rng.rand(1, 24, 32, 3).astype(np.float32), device="cpu")
        solver.set_data(rng.rand(1, 24, 32, 3).astype(np.float32))
        solver.apply(n_iter=20, disp_iter=10)
    assert lpt.ADMM is ADMM
    (solve,) = rec.solves
    red = cs._cli3_cpu_solve(solve, slice(0, 1))
    assert red.shape == (1, 24, 32, 1)
    assert _nerr(red, solve["out"][..., :1]) <= TOL_ADMM     # float32, other FFT batches
