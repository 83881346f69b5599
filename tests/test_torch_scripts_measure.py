"""The port's measurement apps (``lenslesspicam_tpu_torch/scripts/measure``:
``digicam_example``, ``analyze_image``, ``analyze_measured_dataset``)
against the JAX package's scripts of the same paths, in-process on the CPU
(``LPT_PLATFORM=cpu``) on the same seeded inputs at
``tests/test_scripts.py``'s sizes (64 x 96 x 3 and 24 x 24 x 3 PNGs,
``capture.down=16``, 3 iterations); the helpers and tolerances of
``tests/test_torch_scripts.py``.

``digicam_example``'s PSF is held within TOL_SIM of its max and its ADMM
result within TOL_SIM_RECON; its SSH path runs both packages'
``hardware/remote.py`` under a stand-in ``paramiko`` (in ``sys.modules``)
with ``subprocess`` recorded: both must issue the same commands, and the
``scp`` of the capture writes a seeded raw Bayer PNG where the app reads
it.  ``analyze_image`` prints the same lines (its -N dB widths) in every
mode; ``analyze_measured_dataset`` flags, counts and deletes the same
files.  No test needs the network, paramiko or a Raspberry Pi.
"""

import os
import re
import subprocess
import sys
import types

import cv2
import numpy as np
import pytest
import torch

from test_torch_scripts import (APPS, TOL_SIM, TOL_SIM_RECON, _both_printed, _nerr, _png_levels,
                                _run, _saved, one_thread)  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("LPT_PLATFORM", "cpu")




@pytest.fixture
def pngs(tmp_path):
    """tests/test_scripts.py's inputs: a 64 x 96 x 3 PSF and measurement."""
    rng = np.random.RandomState(0)
    psf = (rng.rand(64, 96, 3) * 200 + 20).astype(np.uint8)
    data = (rng.rand(64, 96, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "psf.png"), psf)
    cv2.imwrite(str(tmp_path / "data.png"), data)
    return str(tmp_path / "psf.png"), str(tmp_path / "data.png")




def _lines(text, tmp_path):
    """The printed lines with the run directories and timings made equal."""
    text = text.replace(str(tmp_path / "jax"), "<run>").replace(str(tmp_path / "port"), "<run>")
    text = re.sub(r"\d{4}-\d\d-\d\d/\d\d-\d\d-\d\d", "<time>", text)
    return re.sub(r"in \d+\.\d+ seconds", "in # seconds", text).splitlines()


# --- digicam_example ---------------------------------------------------------------------

@pytest.mark.parametrize("psf", ["simulated", "measured"])
def test_digicam_example_app_matches_jax(pngs, tmp_path, capsys, psf):
    """``capture.fp``: the seeded mask's simulated PSF (or a measured PSF
    file), the flip, the resize to the PSF grid and one ADMM solve."""
    args = [f"capture.fp={pngs[1]}", "capture.down=16", "recon.n_iter=3"]
    if psf == "measured":
        args.append(f"psf={pngs[0]}")
    out, ref, port_out, jax_out = _both_printed(tmp_path, "measure.digicam_example", args, capsys)
    assert isinstance(out, np.ndarray) and out.shape == ref.shape
    assert out.shape == ((1, 190, 253, 3) if psf == "simulated" else (1, 4, 6, 3))
    assert _nerr(out, ref) <= TOL_SIM_RECON
    assert _lines(port_out, tmp_path) == _lines(jax_out, tmp_path)
    for name in ("digicam_psf.png", "digicam_raw.png", "digicam_recon.png"):
        assert _png_levels(_saved(tmp_path / "port", name), _saved(tmp_path / "jax", name)) <= 1


def test_digicam_example_psf_matches_jax(tmp_path):
    """The seeded mask values' PSF and a stored pattern file's, from the
    app's ``AdafruitLCD`` settings, with a gamma-corrected PNG."""
    from lenslesspicam_tpu.hardware.trainable_mask import AdafruitLCD as JLCD
    from lenslesspicam_tpu_torch.hardware.trainable_mask import AdafruitLCD as TLCD

    vals = np.random.RandomState(0).uniform(0, 1, (18, 26)).astype(np.float32)
    kw = dict(sensor="rpi_hq", downsample=16, flipud=True, scene2mask=0.3, mask2sensor=0.002,
              deadspace=True)
    j, t = JLCD(initial_vals=vals, **kw), TLCD(initial_vals=vals, device="cpu", **kw)
    with torch.no_grad():
        assert _nerr(t.get_psf(t.params).numpy(), np.asarray(j.get_psf(j.params))) <= TOL_SIM
    np.save(tmp_path / "vals.npy", vals)
    cv2.imwrite(str(tmp_path / "raw.png"), (np.random.RandomState(1).rand(64, 96, 3) * 255)
                .astype(np.uint8))
    args = [f"mask.fp={tmp_path / 'vals.npy'}", f"capture.fp={tmp_path / 'raw.png'}",
            "capture.down=16", "recon.n_iter=3", "simulation.gamma=2.2", "capture.flip=False"]
    port, jax_app, entry = APPS["measure.digicam_example"]
    ref = _run(getattr(jax_app, entry), args, tmp_path / "jax")
    out = _run(getattr(port, entry), args, tmp_path / "port")
    assert _nerr(out, ref) <= TOL_SIM_RECON
    assert _png_levels(_saved(tmp_path / "port", "digicam_psf.png"),
                       _saved(tmp_path / "jax", "digicam_psf.png")) <= 1


class _Pi:
    """A stand-in ``paramiko`` and recorders of ``subprocess``: the SSH
    capture reports a legacy Raspberry Pi with its gains, and the ``scp``
    of the capture writes a seeded 12-bit raw Bayer PNG where it is
    fetched to; a mask pattern sent is not written."""

    REPORT = ["RPi distribution : buster\n", "Red gain : 1.9\n", "Blue gain : 1.6\n"]

    def __init__(self, monkeypatch):
        self.calls = []
        rec = self
        raw = (np.random.RandomState(4).rand(48, 64) * 4095).astype(np.uint16)

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
                self.stdout = types.SimpleNamespace(readlines=lambda: [
                    ln.encode() for ln in _Pi.REPORT])
                self.stderr = types.SimpleNamespace(readlines=lambda: [])

        def run(cmd, **kw):
            rec.calls.append(("run", re.sub(r"\S*slm_pattern\.npy ", "<pattern> ", cmd)))
            m = re.match(r'scp "[^"]+:~/\S+\.png" (\S+)$', cmd)
            if m:
                assert cv2.imwrite(m.group(1), raw)

        real_save = np.save

        def save(fp, arr, *args, **kw):
            # the pattern is not written: the stand-in scp never reads it, and
            # the JAX package would write it at the fixed path /tmp/slm_pattern.npy
            if not str(fp).endswith("slm_pattern.npy"):
                return real_save(fp, arr, *args, **kw)

        monkeypatch.setitem(sys.modules, "paramiko", types.SimpleNamespace(
            SSHClient=SSHClient, WarningPolicy=type("WarningPolicy", (), {})))
        monkeypatch.setattr(subprocess, "Popen", Popen)
        monkeypatch.setattr(subprocess, "run", run)
        monkeypatch.setattr(np, "save", save)


def test_digicam_example_app_captures_over_ssh(tmp_path, capsys, monkeypatch):
    """No ``capture.fp``: the pattern set and the capture made through each
    package's ``hardware/remote.py``; the same commands (the run
    directories made equal), the same pattern file, the same result."""
    import time

    monkeypatch.setattr(time, "sleep", lambda s: None)
    args = ["rpi.username=pi", "rpi.hostname=host", "capture.down=16", "recon.n_iter=3"]
    port, jax_app, entry = APPS["measure.digicam_example"]
    calls, patterns = {}, {}
    for side, fn in (("jax", getattr(jax_app, entry)), ("port", getattr(port, entry))):
        pi = _Pi(monkeypatch)
        out = _run(fn, args, tmp_path / side)
        calls[side] = [tuple(str(x).replace(str(tmp_path / side), "<out>")
                             for x in c) for c in pi.calls]
        calls[side] = [tuple(re.sub(r"\d{4}-\d\d-\d\d/\d\d-\d\d-\d\d", "<time>", x) for x in c)
                       for c in calls[side]]
        patterns[side] = out
    printed = capsys.readouterr().out
    assert calls["port"] == calls["jax"]
    assert [c[0] for c in calls["port"]].count("run") == 3     # pattern scp, ssh, capture scp
    assert printed.count("Setting mask...") == printed.count("Captured to ") == 2
    assert _nerr(patterns["port"], patterns["jax"]) <= TOL_SIM_RECON


def test_digicam_example_app_needs_a_capture_or_a_pi(tmp_path):
    port, _, entry = APPS["measure.digicam_example"]
    with pytest.raises(AssertionError, match="no capture.fp"):
        _run(getattr(port, entry), ["capture.down=16"], tmp_path)


# --- analyze_image ------------------------------------------------------------------------

def _psf_like(tmp_path):
    """A peaked 64 x 96 x 3 PSF-like image (a Gaussian spot on noise), so
    that the cross sections find their -3 dB points."""
    rng = np.random.RandomState(2)
    y, x = np.mgrid[:64, :96]
    spot = np.exp(-((y - 30) ** 2 + (x - 50) ** 2) / (2 * 3.0 ** 2))
    img = np.clip(spot[..., None] * [250, 220, 200] + rng.rand(64, 96, 3) * 10, 0, 255)
    fp = str(tmp_path / "spot.png")
    cv2.imwrite(fp, img.astype(np.uint8))
    return fp


ANALYZE = {
    "default": [],
    "lens": ["lens=True", "width=3"],
    "lensless": ["lensless=True"],
    "lensless_6db": ["lensless=True", "width=6", "plot_width=40"],
}


@pytest.mark.parametrize("mode", ANALYZE)
def test_analyze_image_app_matches_jax(tmp_path, capsys, mode):
    """Each mode prints the JAX app's lines, the -N dB widths of each
    cross section among them, and saves its figures."""
    args = [f"fp={_psf_like(tmp_path)}", *ANALYZE[mode]]
    out, ref, port_out, jax_out = _both_printed(tmp_path, "measure.analyze_image", args, capsys)
    assert out is ref is None
    assert _lines(port_out, tmp_path) == _lines(jax_out, tmp_path)
    widths = re.findall(r"^-\d+dB width = \d+ pixels$", port_out, re.M)
    # one a colour channel (the grayscale view of a uint8 image is zero in
    # both packages: rgb2gray's weights take the image's dtype)
    assert len(widths) == (0 if mode == "default" else 3)
    names = {"rgb_analysis.png", "grey_analysis.png"} | (
        set() if mode == "default" else {"autocorrelation.png"})
    assert {p.name for p in (tmp_path / "port").rglob("*.png")} == names


def test_analyze_image_widths_match_jax(tmp_path, capsys):
    """The -3 dB widths themselves: the lens mode's cross sections and the
    lensless mode's autocorrelations, channel by channel, number for
    number."""
    fp = _psf_like(tmp_path)
    got = {}
    for mode in ("lens", "lensless"):
        _, _, port_out, jax_out = _both_printed(tmp_path / mode, "measure.analyze_image",
                                            [f"fp={fp}", f"{mode}=True"], capsys)
        got[mode] = [re.findall(r"^(-- \S+|-3dB width = (\d+) pixels)", t, re.M)
                     for t in (port_out, jax_out)]
        assert got[mode][0] == got[mode][1] and len(got[mode][0]) >= 6
    assert any(int(w) > 0 for _, w in got["lens"][0] if w)


def test_analyze_image_app_saves_a_bayer_result(tmp_path, capsys):
    """``bayer=True`` with gains and ``save=``: the colour-corrected RGB and
    its 8-bit version, as the JAX app writes them."""
    raw = (np.random.RandomState(3).rand(48, 64) * 4095).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "raw.png"), raw)
    for side in ("jax", "port"):
        args = [f"fp={tmp_path / 'raw.png'}", "bayer=True", "rg=1.9", "bg=1.6", "nbits=8",
                f"save={tmp_path / side}_rgb.png"]
        port, jax_app, entry = APPS["measure.analyze_image"]
        _run(getattr(port if side == "port" else jax_app, entry), args, tmp_path / side)
    printed = capsys.readouterr().out
    assert printed.count("Color-corrected RGB image saved to") == 2
    for suffix in ("_rgb.png", "_rgb_8bit.png"):
        assert _png_levels(tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}") <= 1


# --- analyze_measured_dataset -------------------------------------------------------------

def _measured(folder, backgrounds=True):
    """Twelve 24 x 24 x 3 files (natural order im1 .. im12): two
    underexposed, two saturated, the rest fine; backgrounds for all but
    two."""
    rng = np.random.RandomState(0)
    folder.mkdir()
    for i in range(1, 13):
        img = rng.rand(24, 24, 3) * 200
        if i in (3, 11):
            img *= 0.3                      # max < 150
        if i in (5, 12):
            img[:8] = 255                   # a third saturated
        cv2.imwrite(str(folder / f"im{i}.png"), img.astype(np.uint8))
        if backgrounds and i not in (2, 9):
            cv2.imwrite(str(folder / f"black_backgroundim{i}.png"),
                        (rng.rand(24, 24, 3) * 20).astype(np.uint8))
    return folder


MEASURED = {"all": [], "start_n": ["start_idx=2", "n_files=8"],
            "range": ["desired_range=[100,250]", "saturation_percent=0.2"]}


@pytest.mark.parametrize("case", MEASURED)
def test_analyze_measured_dataset_app_matches_jax(tmp_path, capsys, case):
    """The same flags, count, printed lines (natural order, the background
    check) and histogram."""
    args = [f"dataset_path={_measured(tmp_path / 'meas')}", *MEASURED[case]]
    out, ref, port_out, jax_out = _both_printed(tmp_path, "measure.analyze_measured_dataset", args,
                                            capsys)
    assert out == ref
    assert _lines(port_out, tmp_path) == _lines(jax_out, tmp_path)
    if case == "all":
        assert out == 4
        flagged = re.findall(r"^File \S+/(im\d+)\.png", port_out, re.M)
        assert flagged == ["im3", "im5", "im11", "im12"]
        assert "Found 2 files without background" in port_out
    assert _saved(tmp_path / "port", "max_vals.png").is_file()


def test_analyze_measured_dataset_app_deletes_what_jax_deletes(tmp_path, capsys):
    """``delete_bad=True``: the bad files and those without a background
    removed, the same files left in each package's copy."""
    left = {}
    for side in ("jax", "port"):
        folder = _measured(tmp_path / f"meas_{side}")
        port, jax_app, entry = APPS["measure.analyze_measured_dataset"]
        n = _run(getattr(port if side == "port" else jax_app, entry),
                 [f"dataset_path={folder}", "delete_bad=True"], tmp_path / side)
        assert n == 4
        left[side] = sorted(os.listdir(folder))
    assert left["port"] == left["jax"]
    assert "im3.png" not in left["port"] and "im2.png" not in left["port"]
    assert capsys.readouterr().out.count("REMOVED file") == 2 * 6
