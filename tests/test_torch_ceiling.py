"""PyTorch port: the generators' latents and the performance ceilings,
held to the JAX package on the CPU.

* Latents: ``generate_synthetic_tables(spec, return_latents=True)`` of the
  flat and the eicu generator (and the flat edges' latents) against JAX's:
  ``z`` and ``w_lab`` bit for bit, the eicu mode's derived arrays within
  ``1e-12`` relative, the tables still bit-equal.
* Ceilings: ``gaussian_posterior_means`` (one chunk and many),
  ``gaussian_conditional_ceiling``, ``crossfit_oracle_ceiling`` and
  ``lmmse_conditional_ceiling`` in float64 on the CPU against JAX's numpy
  on the same inputs, within ``1e-10`` relative (another summation order).
* The eicu LMMSE recipe of ``scripts/validate_generator.py`` and
  ``tools/diagnose_quality.py --spec eicu --skip-train`` against
  ``scripts/diagnose_quality.py``'s yardsticks, within ``1e-9``.
"""

import dataclasses
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import generate_synthetic_tables as jax_tables
from multi_modal_gnn_tpu.evaluation import ceiling as jax_ceiling
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_edges, generate_synthetic_tables
from multi_modal_gnn_tpu_torch.evaluation import ceiling
from multi_modal_gnn_tpu_torch.tools import diagnose_quality

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
REL = 1e-10
DERIVED = ("w_eff", "noise_var", "mean_shift", "sev_share", "special_labs", "heavy_labs")


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want), initial=0.0)), 1e-300)
    assert float(np.max(np.abs(got - want), initial=0.0)) <= rel * scale, what


def _metrics_close(got: dict, want: dict, rel=REL):
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=rel, abs=1e-14), k


@pytest.mark.parametrize(
    "spec",
    [
        SyntheticSpec.tiny(0),
        SyntheticSpec.tiny(3),
        dataclasses.replace(SyntheticSpec.eicu_real(0), num_patients=400),
        dataclasses.replace(SyntheticSpec.eicu_real(2), num_patients=300, num_labs=30),
    ],
    ids=["flat-tiny0", "flat-tiny3", "eicu-400", "eicu-300x30"],
)
def test_latents_equal_jax(spec):
    tables, lat = generate_synthetic_tables(spec, return_latents=True)
    jt, jl = jax_tables(JaxSpec(**dataclasses.asdict(spec)), return_latents=True)
    assert np.array_equal(lat.z, jl.z) and np.array_equal(lat.w_lab, jl.w_lab)
    assert lat.signal == jl.signal
    for name in DERIVED:
        want = getattr(jl, name)
        if want is None:
            assert getattr(lat, name) is None, name
        else:
            _close(getattr(lat, name), want, rel=1e-12, what=name)
    for name, frame in jt.items():
        assert list(tables[name]) == list(frame.columns), name
        for col in frame.columns:
            assert np.array_equal(np.asarray(tables[name][col]), frame[col].to_numpy()), (name, col)
    # the same draws with and without the latents
    plain = generate_synthetic_tables(spec)
    for name in plain:
        for col in plain[name]:
            assert np.array_equal(plain[name][col], tables[name][col]), (name, col)
    if spec.phenomenology == "flat":
        edges, counts, elat = generate_synthetic_edges(spec, return_latents=True)
        assert np.array_equal(elat.z, jl.z) and np.array_equal(elat.w_lab, jl.w_lab)
        assert (edges, counts) is not None and elat.w_eff is None


def _observations(seed=0, patients=60, labs=12, k=4, edges=400, queries=150):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((labs, k))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    obs_p = rng.integers(0, patients - 3, edges)  # the last patients observe nothing
    obs_l = rng.integers(0, labs, edges)
    obs_v = rng.standard_normal(edges)
    q_p, q_l, q_v = rng.integers(0, patients, queries), rng.integers(0, labs, queries), rng.standard_normal(queries)
    return w, obs_p, obs_l, obs_v, q_p, q_l, q_v


@pytest.mark.parametrize("chunk", [None, 7])
def test_gaussian_posterior_means_match_jax(chunk, monkeypatch):
    if chunk:
        monkeypatch.setattr(ceiling, "EDGE_CHUNK", chunk)
    w, obs_p, obs_l, obs_v, *_ = _observations()
    mu, cov = ceiling.gaussian_posterior_means(w, 0.6, obs_p, obs_l, obs_v, 60, device=CPU)
    want_mu, want_cov = jax_ceiling.gaussian_posterior_means(w, 0.6, obs_p, obs_l, obs_v, 60)
    _close(mu.numpy(), want_mu, what="mu")
    _close(cov.numpy(), want_cov, what="cov")
    # patients without observations keep the prior
    np.testing.assert_array_equal(mu.numpy()[-3:], 0.0)
    np.testing.assert_allclose(cov.numpy()[-1], np.eye(4), rtol=0, atol=1e-15)


@pytest.mark.parametrize("with_values", [True, False])
def test_gaussian_conditional_ceiling_matches_jax(with_values):
    w, obs_p, obs_l, obs_v, q_p, q_l, q_v = _observations(seed=1)
    values = q_v if with_values else None
    got = ceiling.gaussian_conditional_ceiling(w, 0.7, obs_p, obs_l, obs_v, q_p, q_l, values, device=CPU)
    want = jax_ceiling.gaussian_conditional_ceiling(w, 0.7, obs_p, obs_l, obs_v, q_p, q_l, values)
    assert list(got) == list(want)
    _metrics_close(got["expected"], want["expected"])
    assert got["unconditional_r2"] == want["unconditional_r2"]
    assert got["mean_posterior_var"] == pytest.approx(want["mean_posterior_var"], rel=REL)
    _close(got["predictions"], want["predictions"], what="predictions")
    if with_values:
        _metrics_close(got["realized"], want["realized"])


def test_crossfit_oracle_ceiling_matches_jax():
    w, obs_p, obs_l, obs_v, q_p, q_l, q_v = _observations(seed=2)
    rng = np.random.default_rng(5)
    z = rng.standard_normal((60, 4))
    feats = np.hstack([z + 0.5 * rng.standard_normal((60, 4)), rng.random((60, 9)) < 0.3])
    got = ceiling.crossfit_oracle_ceiling(w, 0.6, z, feats, q_p, q_l, q_v, device=CPU)
    want = jax_ceiling.crossfit_oracle_ceiling(w, 0.6, z, feats, q_p, q_l, q_v)
    assert list(got) == list(want) and got["reg"] == want["reg"] and got["folds"] == want["folds"]
    _metrics_close(got["realized"], want["realized"])


@pytest.mark.parametrize("shift", [True, False])
def test_lmmse_conditional_ceiling_matches_jax(shift, monkeypatch):
    monkeypatch.setattr(ceiling, "EDGE_CHUNK", 64)
    w, obs_p, obs_l, obs_v, q_p, q_l, q_v = _observations(seed=3)
    rng = np.random.default_rng(6)
    w_eff = w * rng.uniform(0.2, 1.5, (12, 1))
    noise_var = rng.uniform(0.05, 0.9, 12)
    z_cov = np.cov(rng.standard_normal((200, 4)) * [2.0, 1.0, 0.5, 1.0], rowvar=False)
    mean_shift = rng.standard_normal(12) if shift else None
    args = (w_eff, noise_var, z_cov, obs_p, obs_l, obs_v, q_p, q_l, q_v)
    got = ceiling.lmmse_conditional_ceiling(*args, mean_shift=mean_shift, device=CPU)
    want = jax_ceiling.lmmse_conditional_ceiling(*args, mean_shift=mean_shift)
    _close(got["predictions"], want["predictions"], what="predictions")
    _metrics_close(got["realized"], want["realized"])


def test_eicu_lmmse_recipe_matches_jax():
    """``validate_generator``'s LMMSE ceiling (the recipe of
    ``tests/jax_lmmse_ceiling.py``) on a 400-patient eicu cohort."""
    spec = dataclasses.replace(SyntheticSpec.eicu_real(0), num_patients=400)
    got = diagnose_quality.eicu_lmmse_ceiling(spec, device=CPU)
    jax_spec = JaxSpec(**dataclasses.asdict(spec))
    sys.path.insert(0, str(REPO / "tests"))
    try:
        import jax_lmmse_ceiling
    finally:
        sys.path.remove(str(REPO / "tests"))
    _metrics_close(got, jax_lmmse_ceiling.lmmse_realized(jax_spec), rel=1e-9)


def test_flat_graph_loadings_give_the_bundle_ceiling():
    """The loadings in ``make_synthetic_graph``'s numbering (number_nodes on
    the generator's edges) give the ceiling of the graph built from the
    tables, whose labs are mapped through their ITEMIDs."""
    from multi_modal_gnn_tpu_torch.config import Config
    from multi_modal_gnn_tpu_torch.data import make_synthetic_graph
    from multi_modal_gnn_tpu_torch.graph import build_heterogeneous_graph
    from multi_modal_gnn_tpu_torch.training import EdgeMasker

    spec, config = SyntheticSpec.tiny(1), Config()
    w, signal = diagnose_quality.flat_graph_loadings(spec, config)
    masker = EdgeMasker(make_synthetic_graph(spec, config, device=CPU), seed=42)
    tables, latents = generate_synthetic_tables(spec, return_latents=True)
    bundle = build_heterogeneous_graph(
        labs=tables["labs_normalized"], diagnoses=tables["diagnoses"], medications=tables["medications"],
        cohort=tables["cohort"], labitems=tables["labitems"], config=config,
    )
    w_bundle, _ = diagnose_quality.generator_rows(bundle, latents)
    bundle_masker = EdgeMasker(bundle.graph, seed=42)
    got = ceiling.gaussian_conditional_ceiling(
        w, signal, *masker.split_arrays("train"), *masker.split_arrays("test"), device=CPU)
    want = ceiling.gaussian_conditional_ceiling(
        w_bundle, latents.signal, *bundle_masker.split_arrays("train"), *bundle_masker.split_arrays("test"), device=CPU)
    np.testing.assert_array_equal(w, w_bundle)
    _metrics_close(got["realized"], want["realized"], rel=1e-12)


def test_diagnose_quality_yardsticks_match_jax_script(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["diagnose_quality.py", "--skip-train", "--tag", "jax"])
    runpy.run_path(str(REPO / "scripts" / "diagnose_quality.py"), run_name="__main__")
    want = json.loads((tmp_path / "outputs" / "diagnostics" / "quality_jax.json").read_text())
    capsys.readouterr()
    report = diagnose_quality.main(["--skip-train", "--device", "cpu", "--tag", "port", "--out-dir", str(tmp_path)])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(report))
    assert json.loads((tmp_path / "quality_port.json").read_text())["ceiling"] == last["ceiling"]
    assert report["spec"] == want["spec"] and report["splits"] == want["splits"]
    for key in ("expected", "realized"):
        _metrics_close(report["ceiling"][key], want["ceiling"][key], rel=1e-9)
    for key in ("unconditional_r2", "mean_posterior_var"):
        assert report["ceiling"][key] == pytest.approx(want["ceiling"][key], rel=1e-9)
    _metrics_close(report["combined_ceiling"]["realized"], want["combined_ceiling"]["realized"], rel=1e-9)
    assert report["combined_ceiling"]["reg"] == want["combined_ceiling"]["reg"]
    _metrics_close(report["als"], want["als"], rel=1e-9)
