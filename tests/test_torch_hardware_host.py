"""The port's host-side hardware modules against the JAX package's on the
CPU: ``hardware/remote.py`` (SSH capture, display, the programmable mask
and the stepper motors of a Raspberry Pi) and ``hardware/fabrication.py``
(the geometry of 3-D-printable masks, molds and adapters).

``remote`` runs under a stand-in ``paramiko`` (put in ``sys.modules``) with
``subprocess.Popen`` / ``subprocess.run``, the image loader, ``np.save``,
``cv2.imwrite`` and ``time.sleep`` replaced by recorders: both packages
must issue the same ``ssh`` / ``scp`` commands, parse the on-device
report to the same retrieval path and demosaic gains, and raise on the
same faults.  ``fabrication``'s geometry is numpy: every helper's result
equals the JAX package's, and ``from_mask`` reads the port's mask classes
to the JAX classes' arrays.  Without paramiko or cadquery (``None`` in
``sys.modules``) both gates raise ``ImportError``.  No test needs the
network, paramiko or cadquery.  Every comparison is exact.
"""

import subprocess
import sys
import time
import types

import cv2
import numpy as np
import pytest

from lenslesspicam_tpu.data import io as jio
from lenslesspicam_tpu.hardware import fabrication as jfab
from lenslesspicam_tpu.hardware import mask as jmask
from lenslesspicam_tpu.hardware import remote as jremote

from lenslesspicam_tpu_torch.data import io as tio
from lenslesspicam_tpu_torch.hardware import fabrication as tfab
from lenslesspicam_tpu_torch.hardware import mask as tmask
from lenslesspicam_tpu_torch.hardware import remote as tremote

CPU = "cpu"
PACKAGES = {"jax": (jremote, jio), "port": (tremote, tio)}


# --- hardware/remote.py ------------------------------------------------------------------

class _Record:
    """Recorders in place of paramiko, subprocess, the image loader and the
    other side effects of ``remote``; ``calls`` lists what each call got."""

    def __init__(self, monkeypatch, stdout=(), stderr=()):
        self.calls = []
        self.stdout, self.stderr = list(stdout), list(stderr)
        rec = self

        class SSHClient:
            def load_system_host_keys(self):
                rec.calls.append(("load_system_host_keys",))

            def set_missing_host_key_policy(self, policy):
                rec.calls.append(("set_missing_host_key_policy", type(policy).__name__))

            def connect(self, *args, **kw):
                rec.calls.append(("connect", args, kw))

            def close(self):
                rec.calls.append(("close",))

        class Popen:
            def __init__(self, args, **kw):
                rec.calls.append(("Popen", args, {k: v for k, v in kw.items()
                                                  if k not in ("stdout", "stderr")}))
                self.stdout = types.SimpleNamespace(readlines=lambda: [
                    ln.encode() for ln in rec.stdout])
                self.stderr = types.SimpleNamespace(readlines=lambda: [
                    ln.encode() for ln in rec.stderr])

        monkeypatch.setitem(sys.modules, "paramiko", types.SimpleNamespace(
            SSHClient=SSHClient, WarningPolicy=type("WarningPolicy", (), {})))
        monkeypatch.setattr(subprocess, "Popen", Popen)
        monkeypatch.setattr(subprocess, "run", lambda *a, **kw: self.calls.append(
            ("run", a, kw)))
        monkeypatch.setattr(time, "sleep", lambda s: self.calls.append(("sleep", s)))
        monkeypatch.setattr(np, "save", lambda fp, arr: self.calls.append(
            ("np.save", fp, np.asarray(arr).tolist())))
        monkeypatch.setattr(cv2, "imwrite", lambda fp, img: self.calls.append(
            ("imwrite", fp, np.asarray(img).tolist())) or True)
        self.image = np.random.RandomState(3).rand(6, 8, 3).astype(np.float32)
        for _, io in PACKAGES.values():
            monkeypatch.setattr(io, "load_image", lambda fp, **kw: self.calls.append(
                ("load_image", fp, kw)) or self.image)


def _both(monkeypatch, call, **record):
    """``call(remote)`` of each package under fresh recorders: the two
    (result or exception, calls) pairs, JAX's first."""
    out = []
    for remote, _ in PACKAGES.values():
        rec = _Record(monkeypatch, **record)
        try:
            result = call(remote)
        except Exception as e:          # the same fault in both is asserted by the caller
            result = (type(e), str(e))
        if isinstance(result, tuple) and len(result) == 2 and isinstance(result[1],
                                                                         np.ndarray):
            result = (result[0], result[1].tolist())
        out.append((result, rec.calls))
    return out


REPORT = ["RPi distribution : buster\n", "Red gain : 1.9\n", "Blue gain : 1.6\n", "x\n"]
MODERN = ["RPi distribution : Debian bullseye\n", "Red gain : 2.0\n"]
CAPTURES = {
    "legacy_bayer": (dict(), REPORT, []),
    "legacy_bayer_no_gains": (dict(fn="raw", output_path="out"), ["RPi distribution : x\n"], []),
    "legacy_rgb": (dict(rgb=True, nbits=8, down=4), REPORT, []),
    "legacy_isp_gains": (dict(bayer=False, awb_gains=[2.0, 1.5], exp=0.1, iso=200), REPORT, []),
    "modern_bayer": (dict(legacy=False, sensor="rpi_gs", output_path="out"), MODERN,
                     ["libcamera log\n"]),
    "modern_png": (dict(legacy=False, bayer=False, gray=True, verbose=True), MODERN, []),
    "legacy_stderr": (dict(), REPORT, ["error\n"]),
    "no_output": (dict(legacy=False), [], ["error\n"]),
    "unknown_sensor": (dict(sensor="webcam"), REPORT, []),
}


@pytest.mark.parametrize("case", CAPTURES)
def test_capture_matches_jax(monkeypatch, capsys, case):
    """The capture command over ``ssh``, the report parsed to the retrieval
    path (``.dng`` on a modern system's Bayer capture, else ``.png``), the
    ``scp`` back, the loader's arguments (the reported or requested gains)
    and the BGR file rewritten after an ISP capture; the same faults on an
    error report, an empty one or an unknown sensor."""
    kw, stdout, stderr = CAPTURES[case]
    (jres, jcalls), (tres, tcalls) = _both(
        monkeypatch, lambda r: r.capture("pi", "rpi.local", **kw), stdout=stdout,
        stderr=stderr)
    assert tres == jres and tcalls == jcalls
    if case in ("legacy_stderr", "no_output"):
        assert tres[0] is RuntimeError
    elif case == "unknown_sensor":
        assert tres[0] is AssertionError
    else:
        assert [c[0] for c in tcalls][:6] == ["load_system_host_keys",
                                              "set_missing_host_key_policy", "connect",
                                              "close", "Popen", "run"]
        assert tcalls[2] == ("connect", ("rpi.local",), {"username": "pi", "timeout": 10})
    if case == "legacy_bayer":
        assert tcalls[-1] == ("load_image", "capture.png", dict(
            verbose=False, bayer=True, blue_gain=1.6, red_gain=1.9, nbits_out=12))
    if case == "modern_bayer":
        assert tres[0] == "out/capture.dng"
    capsys.readouterr()


@pytest.mark.parametrize("call", [
    lambda r: r.display("shown.png", "pi", "rpi.local"),
    lambda r: r.display("a.png", "pi", "host", remote_path="~/x.png", wait=0.5),
    lambda r: r.set_programmable_mask(np.arange(6, dtype=np.float32).reshape(2, 3),
                                      rpi_username="pi", rpi_hostname="rpi.local"),
    lambda r: r.set_programmable_mask(np.ones((2, 2)), device="other", rpi_username="u",
                                      rpi_hostname="h"),
    lambda r: r.set_programmable_mask(np.ones(2)),
    lambda r: r.set_mask_sensor_distance(2.5, "pi", "rpi.local"),
    lambda r: r.set_mask_sensor_distance(17, "pi", "rpi.local"),
    lambda r: r.check_username_hostname("pi", "rpi.local", timeout=3).close(),
])
def test_remote_commands_match_jax(monkeypatch, call):
    """``display`` (scp, then the wait), ``set_programmable_mask`` (the
    pattern saved to the temporary folder, scp, the slm-controller
    script), ``set_mask_sensor_distance`` and the connection check issue
    the JAX package's commands; out-of-range or missing arguments raise
    the same assertion.  The temporary folder is ``/tmp`` here, as in the
    JAX package."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", "/tmp")
    (jres, jcalls), (tres, tcalls) = _both(monkeypatch, call)
    assert tres == jres and tcalls == jcalls


@pytest.mark.parametrize("call", [
    lambda r: r.check_username_hostname("pi", "rpi.local"),
    lambda r: r.capture("pi", "rpi.local"),
    lambda r: r.display("a.png", "pi", "rpi.local"),
    lambda r: r.set_programmable_mask(np.ones(2), rpi_username="pi", rpi_hostname="h"),
    lambda r: r.set_mask_sensor_distance(1, "pi", "rpi.local"),
])
def test_remote_gated_on_paramiko(monkeypatch, call):
    """Without paramiko every entry point raises ImportError, with the JAX
    package's message, before any command."""
    monkeypatch.setitem(sys.modules, "paramiko", None)
    monkeypatch.setattr(subprocess, "run", None)
    monkeypatch.setattr(subprocess, "Popen", None)
    messages = []
    for remote, _ in PACKAGES.values():
        with pytest.raises(ImportError, match="requires paramiko") as e:
            call(remote)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


# --- hardware/fabrication.py -------------------------------------------------------------

def _same(a, b):
    """Exact equality of nested tuples / lists / arrays of numbers."""
    if isinstance(b, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mask_size", [(10, 8), (3.5, 12.25)])
@pytest.mark.parametrize("line_width", [0.1, 0.35])
def test_connection_and_frame_geometry_matches_jax(mask_size, line_width):
    """Frame outlines (padding and explicit size), the cross's bars, the
    saltire's polygons, the three-point connection's bar and polygons."""
    for frame in (dict(padding=1.5), dict(size=(20, 21))):
        _same(tfab.SimpleFrame(**frame).outline(mask_size),
              jfab.SimpleFrame(**frame).outline(mask_size))
    _same(tfab.CrossConnection(line_width).bars(mask_size),
          jfab.CrossConnection(line_width).bars(mask_size))
    _same(tfab.SaltireConnection(line_width, mask_radius=2.0).polygons(mask_size),
          jfab.SaltireConnection(line_width, mask_radius=2.0).polygons(mask_size))
    _same(tfab.ThreePointConnection(line_width).geometry(mask_size),
          jfab.ThreePointConnection(line_width).geometry(mask_size))


@pytest.mark.parametrize("kind", ["binary", "graded", "empty"])
def test_mask_to_points_matches_jax(kind):
    """Cells to coordinates: a binary mask's value-0 cells, a graded mask's
    nonzero cells with their heights."""
    rng = np.random.RandomState(4)
    mask = {"binary": (rng.rand(9, 7) > 0.5).astype(float),
            "graded": np.round(rng.rand(9, 7) * 4) / 4,
            "empty": np.ones((5, 5))}[kind]
    px = (0.25, 0.5)
    pts, heights = tfab.Mask3DModel.mask_to_points(mask, px)
    jpts, jheights = jfab.Mask3DModel.mask_to_points(mask, px)
    _same(pts, jpts)
    assert (heights is None) == (jheights is None) == (kind != "graded")
    if heights is not None:
        _same(heights, jheights)


@pytest.mark.parametrize("pattern", ["blocks", "mls"])
def test_coded_aperture_joints_match_jax(pattern):
    """Joint posts at the crossings of a separable coded aperture's cell
    boundaries."""
    if pattern == "blocks":
        mask = np.kron(np.array([[1, 0, 1], [0, 1, 0], [1, 1, 0]]), np.ones((4, 4)))
    else:
        kw = dict(method="MLS", n_bits=4, resolution=(30, 30), feature_size=30e-6)
        mask = jmask.CodedAperture(**kw).mask
    _same(tfab.CodedApertureConnection(0.2).joint_points(mask, (6.0, 6.0)),
          jfab.CodedApertureConnection(0.2).joint_points(mask, (6.0, 6.0)))


@pytest.mark.parametrize("dims,ok", [((10, 8, 12.9, 9.9, 0.4), True),
                                     ((13, 8, 12.9, 9.9, 0.4), False),
                                     ((10, 9.8, 12.9, 9.9, 0.4), False),
                                     ((1, 8, 12.9, 9.9, 0.45), False)])
def test_adapter_dimensions_match_jax(dims, ok):
    for mod in (tfab, jfab):
        if ok:
            assert mod.adapter_dimensions_ok(*dims)
        else:
            with pytest.raises(AssertionError):
                mod.adapter_dimensions_ok(*dims)


def test_from_mask_reads_the_port_masks(monkeypatch):
    """``Mask3DModel.from_mask`` of the port's coded aperture and FZA and
    ``MultiLensMold.from_mask`` of its micro-lens array (the mold's CAD
    step skipped) hold the JAX classes' arrays in mm; a mask of another
    class is refused."""
    kw = dict(resolution=(24, 30), feature_size=30e-6)
    for name, extra in (("CodedAperture", dict(method="MLS", n_bits=4)),
                        ("FresnelZoneAperture", dict(radius=0.2e-3))):
        t = tfab.Mask3DModel.from_mask(getattr(tmask, name)(device=CPU, **extra, **kw),
                                       height=0.3, generate=False)
        j = jfab.Mask3DModel.from_mask(getattr(jmask, name)(**extra, **kw), height=0.3,
                                       generate=False)
        assert isinstance(t.mask, np.ndarray)
        _same(t.mask, j.mask)
        _same(t.mask_size, j.mask_size)
        _same(tfab.Mask3DModel.mask_to_points(t.mask, t.mask_size / np.array(t.mask.shape)),
              jfab.Mask3DModel.mask_to_points(j.mask, j.mask_size / np.array(j.mask.shape)))
    for mod in (tfab, jfab):
        monkeypatch.setattr(mod.MultiLensMold, "_generate", lambda self: None)
    mla = dict(N=5, seed=2, **kw)
    t = tfab.MultiLensMold.from_mask(tmask.MultiLensArray(device=CPU, **mla),
                                     mold_size=(2e-3, 2e-3, 3e-3), base_height_mm=0.5)
    j = jfab.MultiLensMold.from_mask(jmask.MultiLensArray(**mla),
                                     mold_size=(2e-3, 2e-3, 3e-3), base_height_mm=0.5)
    assert t.n_lens == j.n_lens
    _same(t.sphere_centers_mm(), j.sphere_centers_mm())
    _same(t.sphere_radius, j.sphere_radius)
    with pytest.raises(AssertionError, match="MultiLensArray"):
        tfab.MultiLensMold.from_mask(tmask.FresnelZoneAperture(device=CPU, **kw))
    with pytest.raises(AssertionError, match="CodedAperture or FresnelZoneAperture"):
        tfab.Mask3DModel.from_mask(tmask.MultiLensArray(device=CPU, **mla))


@pytest.mark.parametrize("call", [
    lambda f: f.Mask3DModel(np.ones((8, 8)), (1e-2, 1e-2), height=0.3),
    lambda f: f.Mask3DModel(np.ones((8, 8)), (1e-2, 1e-2), generate=False).generate_3d_model(),
    lambda f: f.SimpleFrame().generate((10, 8), 0.5),
    lambda f: f.CrossConnection(mask_radius=1.0).generate(None, (10, 8), 0.5),
    lambda f: f.CodedApertureConnection().generate(np.eye(4), (4.0, 4.0), 0.5),
    lambda f: f.MultiLensMold([[1e-3, 1e-3]], [2e-4], (4e-3, 4e-3)),
    lambda f: f.create_mask_adapter("adapter.stl", 10, 8, 0.5),
])
def test_fabrication_gated_on_cadquery(monkeypatch, call):
    """Without cadquery every CAD step raises ImportError with the JAX
    package's message (the adapter after its dimension check)."""
    monkeypatch.setitem(sys.modules, "cadquery", None)
    messages = []
    for mod in (jfab, tfab):
        with pytest.raises(ImportError, match="requires cadquery") as e:
            call(mod)
        messages.append(str(e.value))
    assert messages[0] == messages[1]
