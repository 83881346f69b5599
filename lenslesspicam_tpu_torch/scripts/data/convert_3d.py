"""Convert 3-D data: a volume (``.mat`` or ``.npy``) to ``.npy``, ``.npz``,
a stack of 16-bit ``.tiff`` slices or an ``.obj`` mesh of its voxels (the
port of ``scripts/data/convert_3d.py``).

    python -m lenslesspicam_tpu_torch.scripts.data.convert_3d fp=volume.mat format=obj

Reads the JAX app's ``_DEFAULTS``; host numpy (SciPy reads ``.mat``,
OpenCV writes ``.tiff``).  Returns None, as the JAX app does.
"""

import os

import numpy as np

from .._common import app

_DEFAULTS = {"fp": None, "key": None, "format": "npy", "threshold": None,
             "output_dir": "outputs"}


def volume_to_obj(vol, fp_out, threshold=None):
    """Threshold a (D, H, W[, C]) volume and write one octahedron for each
    voxel that passes (6 vertices and 8 faces, its size the voxel's
    intensity) as an ``.obj`` mesh; returns ``fp_out``."""
    vol = np.asarray(vol, np.float32)
    if vol.ndim == 4:
        vol = vol.sum(axis=3)
    assert vol.max() > 0, "data has no positive value"
    vol = vol / vol.max()
    if threshold is None:
        threshold = float(np.mean(vol)) ** 0.5
    z, x, y = np.nonzero(vol >= threshold)
    v = vol[z, x, y] / 2.0
    # vertices: +-z, +-y, +-x tips of each octahedron
    verts = np.empty((len(v), 6, 3), np.float32)
    verts[:, 0] = np.stack([x, y, z - v], 1)
    verts[:, 1] = np.stack([x, y, z + v], 1)
    verts[:, 2] = np.stack([x, y - v, z], 1)
    verts[:, 3] = np.stack([x, y + v, z], 1)
    verts[:, 4] = np.stack([x - v, y, z], 1)
    verts[:, 5] = np.stack([x + v, y, z], 1)
    faces_local = np.array([[1, 3, 5], [1, 3, 6], [1, 4, 5], [1, 4, 6],
                            [2, 3, 5], [2, 3, 6], [2, 4, 5], [2, 4, 6]])
    with open(fp_out, "w") as f:
        for vi in verts.reshape(-1, 3):
            f.write(f"v {vi[0]} {vi[1]} {vi[2]}\n")
        for k in range(len(v)):
            for face in faces_local + 6 * k:
                f.write(f"f {face[0]} {face[1]} {face[2]}\n")
    print(f"wrote {len(v)} voxels ({6 * len(v)} verts) to {fp_out}")
    return fp_out


@app(None)
def main(config, device):
    for k, v in _DEFAULTS.items():
        config.setdefault(k, v)
    assert config["fp"], "set fp=<.mat or .npy file>"
    if str(config["fp"]).endswith(".npy"):
        vol = np.load(config["fp"])
        key = "npy"
    else:
        from scipy.io import loadmat

        mat = loadmat(config["fp"])
        keys = [k for k in mat if not k.startswith("__")]
        key = config["key"] or keys[0]
        vol = np.asarray(mat[key])
    print(f"loaded {key}: {vol.shape} {vol.dtype}")

    base = os.path.join(config["run_dir"],
                        os.path.splitext(os.path.basename(config["fp"]))[0])
    if config["format"] == "npy":
        np.save(base + ".npy", vol)
    elif config["format"] == "npz":
        np.savez_compressed(base + ".npz", vol)
    elif config["format"] == "tiff":
        import cv2

        for i in range(vol.shape[0]):
            sl = vol[i].astype(np.float32)
            sl = ((sl / sl.max() * 65535).astype(np.uint16) if sl.max() > 0
                  else sl.astype(np.uint16))
            cv2.imwrite(f"{base}_{i:03d}.tiff", sl)
    elif config["format"] == "obj":
        thr = float(config["threshold"]) if config["threshold"] else None
        volume_to_obj(vol, base + ".obj", threshold=thr)
    print(f"saved {base}.{config['format']}")


if __name__ == "__main__":
    main()
