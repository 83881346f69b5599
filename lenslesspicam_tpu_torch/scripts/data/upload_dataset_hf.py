"""Upload a measured dataset to the Hugging Face hub (the port of
``scripts/data/upload_dataset_hf.py``).

    python -m lenslesspicam_tpu_torch.scripts.data.upload_dataset_hf repo_id=<user/name> \
        lensless_dir=<dir> lensed_dir=<dir> psf=psf.png

The lensless and lensed files (and ambient ones, with ``ambient_dir``)
in sorted order become the image columns of a ``datasets.Dataset``, split
into ``test`` (the first ``test_size`` share) and ``train`` and pushed to
``repo_id``; the PSF file is uploaded beside them.  ``datasets`` and
``huggingface_hub`` are imported only here, and the upload needs the
network.  Reads the JAX app's ``_DEFAULTS``; returns None, as the JAX app
does.
"""

import glob
import os

from .._common import app

_DEFAULTS = {
    "repo_id": None,
    "lensless_dir": None,
    "lensed_dir": None,
    "psf": None,
    "ambient_dir": None,
    "test_size": 0.15,
    "output_dir": "outputs",
}


@app(None)
def main(config, device):
    for k, v in _DEFAULTS.items():
        config.setdefault(k, v)
    from datasets import Dataset, DatasetDict, Image
    from huggingface_hub import HfApi

    assert config["repo_id"] and config["lensless_dir"] and config["lensed_dir"]
    lensless = sorted(glob.glob(os.path.join(config["lensless_dir"], "*")))
    lensed = sorted(glob.glob(os.path.join(config["lensed_dir"], "*")))
    assert len(lensless) == len(lensed)

    data = {"lensless": lensless, "lensed": lensed}
    if config["ambient_dir"]:
        ambient = sorted(glob.glob(os.path.join(config["ambient_dir"], "*")))
        assert len(ambient) == len(lensless)
        data["ambient"] = ambient

    ds = Dataset.from_dict(data)
    for col in data:
        ds = ds.cast_column(col, Image())
    n_test = int(len(ds) * config["test_size"])
    dd = DatasetDict({"train": ds.select(range(n_test, len(ds))),
                      "test": ds.select(range(n_test))})
    dd.push_to_hub(config["repo_id"])
    if config["psf"]:
        HfApi().upload_file(path_or_fileobj=config["psf"],
                            path_in_repo=os.path.basename(config["psf"]),
                            repo_id=config["repo_id"], repo_type="dataset")
    print(f"uploaded {len(ds)} pairs to {config['repo_id']}")


if __name__ == "__main__":
    main()
