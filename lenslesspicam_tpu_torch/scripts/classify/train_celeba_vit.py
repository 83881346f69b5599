"""Fine-tune a ViT to classify a CelebA attribute from lensless
reconstructions (or raw / lensed images), the port of
``scripts/classify/train_celeba_vit.py``: how well a downstream task does
on the reconstructions.

    python -m lenslesspicam_tpu_torch.scripts.classify.train_celeba_vit data_dir=<pngs + labels.npy>

``transformers.ViTForImageClassification`` (the PyTorch class, imported
here) loads ``model_name`` with a 2-label head (the pretrained model needs
the network or the hub's cache) and trains on the app's device.  The
steps are the JAX app's: each 224 x 224 image unnormalized in [0, 1] and
CHW, the model without dropout (``eval()``, as the flax call's default
``train=False``), the batch's mean softmax cross-entropy, AdamW with
optax's defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4;
PyTorch's default decay is 1e-2).  The JAX step is ``jax.jit``; this one
is eager.  Reads the JAX app's ``_DEFAULTS``; prints the mean loss of each
epoch and returns the trained weights as a dict of numpy arrays (the JAX
app returns its flax parameter tree).
"""

import os

import numpy as np

from .._common import app

_DEFAULTS = {
    "data_dir": None,          # folder with images + labels.npy
    "attribute": "Male",
    "model_name": "google/vit-base-patch16-224-in21k",
    "epochs": 3,
    "batch_size": 16,
    "lr": 2e-4,
    "output_dir": "outputs",
}

ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)     # optax.adamw's defaults


@app(None)
def main(config, device):
    for key, val in _DEFAULTS.items():
        config.setdefault(key, val)
    try:
        from transformers import ViTForImageClassification
    except ImportError as e:
        raise ImportError("requires `transformers` with PyTorch support") from e

    import glob

    import torch
    import torch.nn.functional as F

    from ...data.io import load_image

    assert config["data_dir"], "set data_dir with images + labels.npy"
    files = sorted(glob.glob(os.path.join(config["data_dir"], "*.png")))
    labels = np.load(os.path.join(config["data_dir"], "labels.npy"))
    assert len(files) == len(labels)

    model = ViTForImageClassification.from_pretrained(
        config["model_name"], num_labels=2
    ).to(device)
    model.eval()           # no dropout, as the flax call runs
    opt = torch.optim.AdamW(model.parameters(), lr=float(config["lr"]), **ADAMW)

    def prep(fp):
        img = load_image(fp, return_float=True, shape=(224, 224, 3))
        return np.transpose(img, (2, 0, 1))  # ViT expects CHW

    bs = config["batch_size"]
    for epoch in range(config["epochs"]):
        losses = []
        for i in range(0, len(files), bs):
            batch = torch.from_numpy(np.stack([prep(f) for f in files[i : i + bs]])).to(device)
            y = torch.as_tensor(labels[i : i + bs], dtype=torch.long, device=device)
            loss = F.cross_entropy(model(pixel_values=batch).logits, y)
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.item())
        print(f"epoch {epoch}: loss {np.mean(losses):.4f}")
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


if __name__ == "__main__":
    main()
