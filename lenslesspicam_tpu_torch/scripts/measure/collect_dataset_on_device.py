"""Acquire a dataset with the camera: display each image, set the mask,
capture (the port of ``scripts/measure/collect_dataset_on_device.py``).

* Resume: captures already in the output folder are skipped, so a run
  that stopped carries on where it left off; ``start_idx`` defaults to the
  number of outputs already there.
* Adaptive exposure: each capture is retried (up to ``max_tries``) until
  its largest pixel lies in [``min_level``, ``max_level``]; the exposure
  scales by ``fact_increase`` / ``fact_decrease``, and at the sensor's
  shortest shutter the display is dimmed instead.
* Masks: ``masks.n`` patterns drawn from ``RandomState(masks.seed)`` once
  (kept in the output folder and reloaded on resume), set in turn, one a
  capture.
* Backgrounds: every ``measure_bg`` captures the display goes black and a
  background frame is taken; ``bg_mappings.json`` maps each background to
  the files it covers.
* A runtime budget, a start delay, progress with an estimate of the time
  left, ``dummy`` mode (no hardware: the inputs are copied through), and
  an optional ADMM reconstruction of each capture (``recon``), the port's
  exact ``ADMM`` on the app's device.

    python -m lenslesspicam_tpu_torch.scripts.measure.collect_dataset_on_device \
        rpi.username=pi rpi.hostname=raspberrypi.local input_dir=images

Reads the JAX app's ``_DEFAULTS``.  The display, the mask and the capture
ride the port's ``hardware/remote.py`` over SSH.  The captures go to a
folder that does not change between runs (``measured_dir``, else
``<output_dir>/measured``), so that a run can resume.  Returns None, as
the JAX app does.
"""

import glob
import json
import os
import re
import shutil
import tempfile
import time

import numpy as np

from .._common import app

_DEFAULTS = {
    "rpi": {"username": None, "hostname": None},
    "input_dir": None,           # folder of images to display
    "input_file_ext": "png",
    "output_file_ext": "png",
    "n_files": None,             # cap for test runs
    "masks": None,               # {"n": int, "shape": [h, w], "seed": 0,
                                 #  "device": "adafruit", "center": [59, 76]}
    "capture": {"exp": 0.02, "bayer": True, "measure_bg": 0,
                "bg_fp": "black_background",
                "fact_increase": 2.0, "fact_decrease": 1.5},
    "display": {"brightness": 100, "delay": 2},
    "min_level": 170,            # adaptive-exposure target band (8-bit)
    "max_level": 254,
    "max_tries": 4,              # 0 = fixed exposure
    "min_shutter_us": 13098,     # RPi HQ minimum shutter (reference :445)
    "recon": None,               # {"psf": path, "n_iter": 10} for on-line ADMM
    "runtime_hours": None,
    "start_delay_min": None,
    "start_idx": None,           # None = resume from existing outputs
    "dummy": False,              # no hardware: copy inputs through
    "output_dir": "outputs",
}

_NOT_CAPTURE_KEYS = ("exp", "measure_bg", "bg_fp", "fact_increase", "fact_decrease")


def natural_sort(arr):
    """File names in numeric-aware order (``im2`` before ``im10``)."""
    def key(s):
        return [int(t) if t.isdigit() else t.lower()
                for t in re.split(r"(\d+)", s)]
    return sorted(arr, key=key)


def _prep_masks(config, out_dir):
    """The seeded mask patterns, written once and reloaded on resume."""
    mcfg = config["masks"]
    if mcfg is None:
        return None
    mask_dir = os.path.join(out_dir, "masks")
    os.makedirs(mask_dir, exist_ok=True)
    rng = np.random.RandomState(mcfg.get("seed", 0))
    patterns = []
    for i in range(mcfg["n"]):
        fp = os.path.join(mask_dir, f"mask_{i}.npy")
        vals = rng.uniform(0, 1, tuple(mcfg["shape"]))
        if not os.path.isfile(fp):
            np.save(fp, vals)
        patterns.append(np.load(fp))
    return patterns


def _blank_png(screen_res=(1920, 1080)):
    """A black frame for the background captures."""
    from PIL import Image

    fp = os.path.join(tempfile.gettempdir(), "lpt_blank_display.png")
    Image.fromarray(
        np.zeros((screen_res[1], screen_res[0], 3), np.uint8)).save(fp)
    return fp


def _capture_adaptive(config, fn, exp, brightness, display_fp, stats):
    """A capture with the retries that bring its level into the band;
    returns (output path, image, exposure, brightness)."""
    from ...hardware import remote

    user, host = config["rpi"]["username"], config["rpi"]["hostname"]
    min_level, max_level = config["min_level"], config["max_level"]
    max_tries = config["max_tries"]
    cap = {k: v for k, v in config["capture"].items() if k not in _NOT_CAPTURE_KEYS}
    fact_inc = config["capture"].get("fact_increase", 2.0)
    fact_dec = config["capture"].get("fact_decrease", 1.5)

    n_tries = 0
    out, img = None, None
    while True:
        out, img = remote.capture(user, host, fn=fn, exp=exp,
                                  output_path=config["_out_dir"], **cap)
        arr = np.asarray(img)
        level = arr.max()
        print(f"{out}, range: {arr.min()} - {level}, exp {exp:.4f}s, "
              f"brightness {brightness}")
        n_tries += 1
        if (min_level <= level <= max_level or max_tries == 0
                or n_tries > max_tries):
            if n_tries > max_tries and max_tries != 0:
                print("Max number of tries reached!")
            break
        if level < min_level:
            exp *= fact_inc
            print(f"increasing exposure to {exp:.4f}s")
        else:
            if exp * 1e6 > config["min_shutter_us"]:
                exp /= fact_dec
                print(f"decreasing exposure to {exp:.4f}s")
            else:
                brightness = max(brightness - 10, 0)
                print(f"decreasing screen brightness to {brightness}")
                if display_fp is not None:
                    remote.display(display_fp, user, host,
                                   brightness=brightness)
    stats["exposure"].append(exp)
    stats["brightness"].append(brightness)
    stats["n_tries"].append(n_tries)
    return out, img, exp, brightness


@app(None)
def main(config, device):
    from ...utils.config import apply_defaults

    apply_defaults(config, _DEFAULTS)
    # the captures go to a folder that does not change between runs (not
    # the timestamped run_dir), so that a stopped acquisition resumes
    out_dir = config.get("measured_dir") or os.path.join(
        config["output_dir"], "measured")
    os.makedirs(out_dir, exist_ok=True)
    ext = config["output_file_ext"]

    files = natural_sort(glob.glob(os.path.join(
        config["input_dir"], f"*.{config['input_file_ext']}")))
    assert files, f"no .{config['input_file_ext']} files in input_dir"
    n_files = len(files)
    print(f"Number of {config['input_file_ext']} files : {n_files}")
    if config["n_files"]:
        files = files[: config["n_files"]]
        print(f"TEST : collecting first {len(files)} files!")

    # resume: start where the existing outputs end
    start_idx = config["start_idx"]
    if start_idx is None:
        done = [f for f in glob.glob(os.path.join(out_dir, f"*.{ext}"))
                if "background" not in os.path.basename(f)]
        start_idx = len(done)
        if start_idx:
            print(f"resuming at index {start_idx} "
                  f"({start_idx} outputs already present)")

    masks = _prep_masks(config, out_dir)

    recon = None
    if config["recon"] is not None and not config["dummy"]:
        from ... import ADMM
        from ...data.io import load_psf

        psf = load_psf(config["recon"]["psf"],
                       downsample=config["capture"].get("down") or 1)
        recon = ADMM(psf, n_iter=config["recon"].get("n_iter", 10), device=device)
        recon_dir = os.path.join(out_dir, "recon")
        os.makedirs(recon_dir, exist_ok=True)

    if config["start_delay_min"]:
        print(f"delaying start by {config['start_delay_min']} min")
        time.sleep(config["start_delay_min"] * 60)
    deadline = (time.time() + 3600 * config["runtime_hours"]
                if config["runtime_hours"] else None)
    if deadline:
        print(f"Script will run for (at most) "
              f"{config['runtime_hours']} hour(s).")

    from ...hardware import remote

    user, host = config["rpi"]["username"], config["rpi"]["hostname"]
    config["_out_dir"] = out_dir
    stats = {"exposure": [], "brightness": [], "n_tries": []}
    exp = config["capture"].get("exp", 0.02)
    brightness = config["display"].get("brightness", 100)
    measure_bg = config["capture"].get("measure_bg", 0)
    bg_mappings = {}
    t0 = time.time()
    n_done = 0

    for i, fp in enumerate(files[start_idx:], start_idx):
        if deadline and time.time() > deadline:
            print(f"-- runtime budget exhausted: measured {i} / {n_files}")
            break
        base = os.path.splitext(os.path.basename(fp))[0]
        output_fp = os.path.join(out_dir, f"{base}.{ext}")
        if os.path.isfile(output_fp):
            continue

        img = None
        if config["dummy"]:
            shutil.copyfile(fp, output_fp)
        else:
            assert user and host, "set rpi.username and rpi.hostname"
            if masks is not None:
                mcfg = config["masks"]
                pattern = masks[i % mcfg["n"]]
                if mcfg.get("center") is not None:
                    from ...hardware.slm import adafruit_sub2full

                    pattern = adafruit_sub2full(
                        pattern, center=tuple(mcfg["center"]))
                remote.set_programmable_mask(
                    pattern, mcfg.get("device", "adafruit"),
                    rpi_username=user, rpi_hostname=host)
            remote.display(fp, user, host, brightness=brightness,
                           wait=config["display"].get("delay", 2))
            out, img, exp, brightness = _capture_adaptive(
                config, base, exp, brightness, fp, stats)
            if os.path.abspath(out) != os.path.abspath(output_fp):
                os.replace(out, output_fp)

            # a background capture every measure_bg files, and its mapping
            if measure_bg:
                bg_name = f"{config['capture']['bg_fp']}{i}.{ext}"
                bg_mappings.setdefault(bg_name, []).append(
                    os.path.basename(fp))
                if i % measure_bg == 0 or i == len(files) - 1:
                    with open(os.path.join(out_dir, "bg_mappings.json"),
                              "a") as f:
                        json.dump(bg_mappings, f, indent=4)
                    bg_mappings = {}
                    remote.display(_blank_png(), user, host, brightness=0)
                    cap_bg = {k: v for k, v in config["capture"].items()
                              if k not in _NOT_CAPTURE_KEYS}
                    remote.capture(user, host,
                                   fn=os.path.splitext(bg_name)[0],
                                   exp=exp, output_path=out_dir, **cap_bg)

        if recon is not None and img is not None:
            from ..._device import as_host
            from ...data.io import save_image

            arr = np.asarray(img, np.float32)
            arr /= max(arr.max(), 1e-9)
            recon.set_data(arr[None])
            save_image(as_host(recon.apply()),
                       os.path.join(recon_dir, f"{base}.{ext}"))

        n_done += 1
        elapsed = time.time() - t0
        remaining = (len(files) - i - 1) * elapsed / max(n_done, 1)
        print(f"[{i + 1}/{len(files)}] {output_fp}  "
              f"(elapsed {elapsed / 60:.1f} min, "
              f"ETA {remaining / 60:.1f} min)")

    print(f"\nFinished, {(time.time() - t0) / 60.0:.3f} minutes.")
    if stats["exposure"]:
        print(f"exposure range: {min(stats['exposure'])} - "
              f"{max(stats['exposure'])}")
        print(f"brightness range: {min(stats['brightness'])} - "
              f"{max(stats['brightness'])}")
        print(f"n_tries range: {min(stats['n_tries'])} - "
              f"{max(stats['n_tries'])}")


if __name__ == "__main__":
    main()
