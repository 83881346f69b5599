"""The port's evaluation apps (``lenslesspicam_tpu_torch/scripts/eval``:
``quality_baseline``, ``benchmark_recon``, ``compute_metrics_from_original``)
against the JAX package's scripts of the same paths, in-process on the CPU
(``LPT_PLATFORM=cpu``); the helpers and tolerances of
``tests/test_torch_scripts.py``.

``quality_baseline``: its scenes, PSF and measurement, each algorithm's
reconstruction at n = 20 (``admm``, ``admm_rfused``, ``admm_split`` within
1e-5 of the max, the GD family within 1e-4) and the sweep of the six
algorithms over ``rects`` at n = 5, 20 (the same entries, PSNR within 0.01
dB); a failed solve raises where the JAX app skips it, and the results go
to ``outputs/quality_baseline_torch.json``.  ``benchmark_recon``: the
results of ADMM and FISTA at n = 2, 5 over 4 simulated files (the noise
drawn as the JAX simulator draws it), each metric within 1e-4 relative.
"""

import json
import re

import numpy as np
import pytest

from lenslesspicam_tpu_torch.scripts.eval import benchmark_recon as t_bench
from lenslesspicam_tpu_torch.scripts.eval import compute_metrics_from_original as t_metrics
from lenslesspicam_tpu_torch.scripts.eval import quality_baseline as t_qb

from test_torch_scripts import (CPU, TOL_ADMM, TOL_GD, TOL_METRIC, TOL_PSNR_DB, _both, _nerr,
                                _rel, _run, _saved, jax_noise, one_thread, pngs)  # noqa: F401
from scripts.eval import benchmark_recon as j_bench
from scripts.eval import compute_metrics_from_original as j_metrics
from scripts.eval import quality_baseline as j_qb

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("LPT_PLATFORM", "cpu")


# --- eval: quality_baseline, benchmark_recon, compute_metrics ---------------------------

@pytest.fixture(scope="module")
def rects():
    scene = j_qb.make_scenes()["rects"]
    psf = j_qb.make_psf()
    return scene, psf, j_qb.simulate(scene, psf)


def test_quality_baseline_scenes_psf_and_measurement_are_jax(rects):
    for name, scene in j_qb.make_scenes().items():
        np.testing.assert_array_equal(t_qb.make_scenes()[name], scene)
    np.testing.assert_array_equal(t_qb.make_psf(), j_qb.make_psf())
    assert t_qb.N_ITER_SWEEP == j_qb.N_ITER_SWEEP and t_qb.SHAPE == j_qb.SHAPE
    scene, psf, meas = rects
    assert _nerr(t_qb.simulate(scene, psf), meas) <= TOL_ADMM


@pytest.mark.parametrize("algo", ["admm", "admm_rfused", "admm_split", "fista", "gd",
                                  "nesterov"])
def test_quality_baseline_reconstruct_matches_jax(rects, algo):
    _, psf, meas = rects
    ref = j_qb.reconstruct(algo, psf, meas, 20)
    out = t_qb.reconstruct(algo, psf, meas, 20)
    tol = TOL_ADMM if algo.startswith("admm") else TOL_GD
    assert out.dtype == np.float32 and _nerr(out, ref) <= tol


def test_quality_baseline_sweep_matches_jax(rects):
    """The six algorithms on ``rects`` at n = 5, 20: the same entries, the
    same metrics' names, PSNR within 0.01 dB."""
    scene = {"rects": rects[0]}
    ref = j_qb.run_sweep(scenes=scene, sweep=[5, 20])
    out = t_qb.run_sweep(scenes=scene, sweep=[5, 20])
    assert t_qb.ALGOS == list(ref["rects"])
    assert {s: {a: {n: sorted(m) for n, m in v.items()} for a, v in d.items()}
            for s, d in out.items()} == \
        {s: {a: {n: sorted(m) for n, m in v.items()} for a, v in d.items()}
         for s, d in ref.items()}
    for algo, sweep in ref["rects"].items():
        for n, m in sweep.items():
            assert abs(out["rects"][algo][n]["psnr"] - m["psnr"]) <= TOL_PSNR_DB, (algo, n)


def test_quality_baseline_lets_a_failure_raise(monkeypatch):
    """Where the JAX app prints a failed solve as skipped, the port's sweep
    raises it."""
    def broken(algo, psf, meas, n_iter, device=None):
        raise RuntimeError(f"{algo} failed")

    monkeypatch.setattr(t_qb, "reconstruct", broken)
    with pytest.raises(RuntimeError, match="admm failed"):
        t_qb.run_sweep(algos=["admm"], scenes={"rects": t_qb.make_scenes()["rects"]},
                       sweep=[5])


def test_quality_baseline_main_writes_outputs_not_benchmarks(tmp_path, monkeypatch):
    """``--quick`` writes the JAX app's payload to
    ``outputs/quality_baseline_torch.json`` by default."""
    monkeypatch.chdir(tmp_path)
    results = t_qb.main(["--quick"])
    with open(tmp_path / "outputs" / "quality_baseline_torch.json") as f:
        payload = json.load(f)
    assert payload["results"] == json.loads(json.dumps(results))
    assert sorted(payload["results"]["rects"]) == ["admm", "fista"]
    assert sorted(payload["results"]["rects"]["admm"]) == ["20", "5"]
    assert payload["protocol"]["n_iter_sweep"] == j_qb.N_ITER_SWEEP
    assert payload["protocol"]["device"] == CPU


def test_benchmark_recon_app_matches_jax(tmp_path, jax_noise):
    """The results of ADMM and FISTA at n = 2, 5 over 4 simulated files in
    batches of 2: the same keys, each metric within 1e-4 relative; the same
    results.json with the copied BASELINES."""
    assert t_bench.BASELINES == j_bench.BASELINES
    out, ref = _both(tmp_path, "eval.benchmark_recon",
                     ["n_files=4", "batchsize=2", "algorithms=[ADMM,FISTA]",
                      "n_iter_range=[2,5]"])
    assert sorted(out) == sorted(ref) == ["ADMM", "FISTA"]
    for algo, sweep in ref.items():
        assert sorted(out[algo]) == sorted(sweep) == [2, 5]
        for n, metrics in sweep.items():
            assert sorted(out[algo][n]) == sorted(metrics)
            for k, v in metrics.items():
                assert _rel(out[algo][n][k], v) <= TOL_METRIC, (algo, n, k)
    with open(_saved(tmp_path / "port", "results.json")) as f:
        saved = json.load(f)
    assert saved["baselines"] == j_bench.BASELINES and sorted(saved["results"]) == ["ADMM", "FISTA"]


def test_compute_metrics_app_matches_jax(pngs, tmp_path, capsys):
    rec = np.random.RandomState(1).rand(32, 48, 3).astype(np.float32)
    np.save(tmp_path / "rec.npy", rec)
    args = [f"files.recon={tmp_path / 'rec.npy'}", f"files.original={pngs[1]}",
            "alignment.rotation=3"]
    _run(j_metrics.compute_metrics, args, tmp_path / "jax")
    printed = capsys.readouterr().out
    out = _run(t_metrics.compute_metrics, args, tmp_path / "port")
    for name in ("MSE", "PSNR", "SSIM"):
        ref = float(re.search(rf"^{name} (\S+)$", printed, re.M).group(1))
        assert _rel(out[name], ref) <= TOL_METRIC, name
    assert _saved(tmp_path / "port", "comparison.png").is_file()
