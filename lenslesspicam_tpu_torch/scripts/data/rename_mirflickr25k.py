"""Rename the MirFlickr25k files to the larger dataset's names: drop the
``im`` prefix and count from 0 (``im1.jpg`` -> ``0.jpg``); the port of
``scripts/data/rename_mirflickr25k.py``.

    python -m lenslesspicam_tpu_torch.scripts.data.rename_mirflickr25k dir_path=<mirflickr dir>

Reads the JAX app's ``_DEFAULTS``; the files are renamed in the order of
``data.datasets.natural_sort``.  Returns the number of files, as the JAX
app does.
"""

import glob
import os

from .._common import app

_DEFAULTS = {"dir_path": "data/mirflickr/mirflickr", "output_dir": "outputs"}


@app(None)
def main(config, device):
    for k, v in _DEFAULTS.items():
        config.setdefault(k, v)
    from ...data.datasets import natural_sort

    dir_path = config["dir_path"]
    assert os.path.isdir(dir_path), f"no directory {dir_path}"
    files = natural_sort(glob.glob(os.path.join(dir_path, "*.jpg")))

    for filename in files:
        bn = os.path.basename(filename)
        file_number = int(bn.replace("im", "").split(".")[0])
        new_filename = os.path.join(dir_path, f"{file_number - 1}.jpg")
        os.rename(filename, new_filename)

    print(f"Number of files: {len(files)}")
    print("Done")
    return len(files)


if __name__ == "__main__":
    main()
