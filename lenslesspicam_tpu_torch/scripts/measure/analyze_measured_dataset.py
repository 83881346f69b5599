"""Check a measured dataset for saturation and underexposure (the port of
``scripts/measure/analyze_measured_dataset.py``).

For every image: record its maximum, flag it when the maximum is below
``desired_range[0]`` (underexposed) or when the share of its pixels at or
above ``desired_range[1]`` exceeds ``saturation_percent`` (saturated).
Save a histogram of the maxima, delete the flagged files with
``delete_bad=True`` (a flag where the reference prompts on stdin), and
check that every measurement has its ``black_background<name>.png`` when
the folder holds background files.

    python -m lenslesspicam_tpu_torch.scripts.measure.analyze_measured_dataset \
        dataset_path=measured/ desired_range=[150,255]

Reads the JAX app's ``_DEFAULTS`` (no YAML); returns the number of bad
files.  Host work only (PIL and matplotlib); it keeps the JAX app's hard
need for matplotlib, so it runs where matplotlib is installed (not on the
CUDA machine).  Deliberate difference: the natural sort is the port's
``data.datasets.natural_sort`` (the same key), where the JAX app keeps a
copy of its own.
"""

import glob
import os
import time

import numpy as np

from ...data.datasets import natural_sort
from .._common import app

_DEFAULTS = {
    "dataset_path": None,
    "ext": "png",
    "desired_range": [150, 255],
    "saturation_percent": 0.05,   # fraction of pixels at/above range max
    "delete_bad": False,
    "start_idx": None,
    "n_files": None,
    "output_dir": "outputs",
}


@app(None)
def main(config, device):
    from PIL import Image

    for k, v in _DEFAULTS.items():
        config.setdefault(k, v)
    folder = config["dataset_path"] or config.get("folder")
    assert folder, "set dataset_path=<folder>"
    lo, hi = (float(v) for v in config["desired_range"])

    files = natural_sort(glob.glob(os.path.join(folder, f"*.{config['ext']}")))
    files_bg = natural_sort(glob.glob(os.path.join(folder, "black_background*.png")))
    files = [fn for fn in files if fn not in files_bg]
    print(f"Found {len(files)} files")
    if config["start_idx"]:
        files = files[int(config["start_idx"]):]
        print(f"Starting at file {files[0]}")
    if config["n_files"]:
        files = files[: int(config["n_files"])]
        print(f"Analyzing first {len(files)} files")
    assert files, "no files to analyze"

    max_vals, bad_files = [], []
    t0 = time.time()
    for fn in files:
        im = np.array(Image.open(fn))
        max_val = im.max()
        max_vals.append(max_val)
        saturation_ratio = float(np.sum(im >= hi) / im.size)
        if max_val < lo:
            bad_files.append(fn)
            print(f"File {fn} has max value {max_val} (underexposed)")
        elif saturation_ratio > float(config["saturation_percent"]):
            bad_files.append(fn)
            print(f"File {fn} has saturation ratio {saturation_ratio:.4f}")

    print(f"Went through {len(files)} files in {time.time() - t0:.2f} seconds")
    print(f"Found {len(bad_files)} / {len(files)} bad files "
          f"({100 * len(bad_files) / len(files):.1f}%)")

    # histogram of per-file maxima
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    output_fp = os.path.join(config["run_dir"], "max_vals.png")
    plt.hist(max_vals, bins=100)
    plt.savefig(output_fp)
    print(f"Saved histogram to {output_fp}")

    if config["delete_bad"]:
        for fn in bad_files:
            os.remove(fn)
            print(f"REMOVED file {fn}")

    # background-file matching
    if files_bg:
        print(f"Found {len(files_bg)} background files")
        files_no_bg = []
        for fn in files:
            bn = os.path.basename(fn).split(".")[0]
            bg_file = os.path.join(folder, f"black_background{bn}.png")
            if bg_file not in files_bg:
                files_no_bg.append(fn)
        print(f"Found {len(files_no_bg)} files without background")
        if config["delete_bad"]:
            for fn in files_no_bg:
                if os.path.exists(fn):
                    os.remove(fn)
                    print(f"REMOVED file {fn} (no background)")
    return len(bad_files)


if __name__ == "__main__":
    main()
