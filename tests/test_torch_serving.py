"""PyTorch port: the serving artifact and its cold-start channel against the
JAX package, on the CPU.

One cohort (300 patients, 20 labs), built from the same tables by both
packages, so node numbering, lab names and stats agree.  For each model
(RGCN with concat heads, RGCN with factored heads, HGT; hidden 32, heads
(16, 8), dropout 0) the port's trainer trains 2 epochs and a JAX trainer
takes the same parameters as a flax tree (:func:`_flax_variables`, the
inverse of ``models/convert.py``'s bridge, held to it).  Then:

* the port's artifact, exported and loaded on the CPU, answers like
  ``build_trainer_serving_fn``, and like the JAX artifact (``jax.export``,
  loaded by JAX's ``ServingModel``) of the same weights, within
  ``1e-5 + 1e-5 |ref|`` (f32 sums in another order);
* requests past the largest bucket are chunked; the manifest carries every
  key of the JAX manifest of record; the validation errors and
  ``predict_patient(denormalize=True)`` match JAX's; a JAX artifact is
  refused; each ``.pt2`` is under 1 % of ``weights.npz`` at hidden 128;
* the ALS fold-ins equal JAX's on the same factors within ``1e-10``
  (float64 numpy), a JAX-written ``coldstart.npz`` served by the port gives
  JAX's answers, and ``calibrate_cold_start`` radii equal JAX's on the same
  splits and factors, with and without a "cal" split;
* ``_as_index`` checks a host batch without touching the device;
* a factored RGCN with value context and the ``context`` or ``head``
  bilinear source: the port's artifact (``bl_u`` / ``bl_l`` in its state,
  or the heads' own factors) against the trainer and the JAX artifact of
  the same weights.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.evaluation import baselines as jax_baselines
from multi_modal_gnn_tpu.evaluation.conformal import calibrate_cold_start as jax_calibrate_cold_start
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.serving import ServingModel as JaxServingModel
from multi_modal_gnn_tpu.serving import export_serving as jax_export_serving
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxEdgeMasker
from multi_modal_gnn_tpu.training.trainer import Trainer as JaxTrainer
from multi_modal_gnn_tpu.training.warmstart import bundle_membership_matrix
from multi_modal_gnn_tpu_torch import serving
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_tables
from multi_modal_gnn_tpu_torch.evaluation import (
    ALSBaseline,
    SideInfoALSBaseline,
    calibrate_cold_start,
    graph_membership_matrix,
)
from multi_modal_gnn_tpu_torch.graph import build_heterogeneous_graph
from multi_modal_gnn_tpu_torch.models import build_model, state_dict_from_flax
from multi_modal_gnn_tpu_torch.serving import ServingModel, build_trainer_serving_fn, export_serving
from multi_modal_gnn_tpu_torch.training import EdgeMasker, Trainer, masker_from_config

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
COLD_TOL = dict(rtol=1e-10, atol=1e-10)
BUCKETS = (64, 256)
SPEC = dict(
    num_patients=300, num_labs=20, num_diagnoses=15, num_medications=10,
    mean_labs_per_patient=8.0, mean_diagnoses_per_patient=2.0,
    mean_medications_per_patient=2.0, latent_dim=4, seed=3,
)
MODELS = {
    "rgcn_concat": dict(architecture="RGCN", extras={"head_style": "concat"}),
    "rgcn_factored": dict(architecture="RGCN", extras={"head_style": "factored"}),
    "hgt": dict(architecture="HGT", num_heads=4),
}


def _jax_config(model):
    cfg = JaxConfig()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, hidden_dim=32, dropout=0.0, **model,
            edge_head=dataclasses.replace(cfg.model.edge_head, hidden_dims=(16, 8)),
        ),
    )


def _port_bundle(cfg, spec=SPEC):
    t = generate_synthetic_tables(SyntheticSpec(**spec))
    return build_heterogeneous_graph(
        t["labs_normalized"], t["diagnoses"], t["medications"], t["cohort"], t["labitems"], cfg
    )


def _pairs(n, seed, num_p=SPEC["num_patients"], num_l=SPEC["num_labs"]):
    rng = np.random.default_rng(seed)
    return rng.integers(0, num_p, n).astype(np.int32), rng.integers(0, num_l, n).astype(np.int32)


def _flax_variables(model) -> dict:
    """The port model's parameters and BatchNorm statistics as the JAX
    model's flax tree: the port's module names are the flax names."""
    leaf_names = {}
    for name, module in model.named_modules():
        if isinstance(module, torch.nn.Embedding):
            leaf_names[name] = {"weight": "embedding"}
        elif isinstance(module, torch.nn.Linear):
            leaf_names[name] = {"weight": "kernel", "bias": "bias"}
        elif isinstance(module, torch.nn.BatchNorm1d):
            leaf_names[name] = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
        else:  # the bilinear factors, raw parameters of the model or a head
            leaf_names[name] = {"bilinear_u": "bilinear_u", "bilinear_l": "bilinear_l"}
    variables = {"params": {}}
    for key, value in model.state_dict().items():
        mod, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        section = "batch_stats" if leaf.startswith("running_") else "params"
        node = variables.setdefault(section, {})
        for part in filter(None, mod.split(".")):
            node = node.setdefault(part, {})
        arr = value.detach().numpy()
        node[leaf_names[mod][leaf]] = arr.T if leaf_names[mod][leaf] == "kernel" else arr
    converted = state_dict_from_flax(variables)
    assert converted.keys() == model.state_dict().keys()
    for key, value in converted.items():  # flax keeps no BatchNorm step count
        assert key.endswith("num_batches_tracked") or torch.equal(value, model.state_dict()[key]), key
    return variables


def _jax_trainer(jcfg, jbundle, model, masker=None):
    """A JAX eval-only trainer on the port model's parameters."""
    masker = masker or JaxEdgeMasker(jbundle.graph, seed=jcfg.train.seed, host_edges=jbundle.patient_lab_host())
    return JaxTrainer(jax_build_model(jcfg, jbundle.graph), jbundle.graph, masker, jcfg,
                      variables=_flax_variables(model), eval_only=True)


@pytest.fixture(scope="module", params=list(MODELS))
def artifacts(request, tmp_path_factory):
    """The port's trainer after 2 epochs, a JAX trainer on its parameters,
    and both artifacts (buckets 64 and 256)."""
    jcfg = _jax_config(MODELS[request.param])
    jbundle = make_synthetic_bundle(JaxSpec(**SPEC), jcfg)
    cfg = Config.from_dict(jcfg.to_dict())
    bundle = _port_bundle(cfg)
    model = build_model(cfg, bundle.graph, device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, bundle.graph, masker_from_config(cfg, bundle.graph), cfg, device="cpu")
    for _ in range(2):
        trainer.train_epoch()
    jtrainer = _jax_trainer(jcfg, jbundle, trainer.model)
    out = tmp_path_factory.mktemp(request.param)
    export_serving(trainer, bundle, out / "port", buckets=BUCKETS)
    jax_export_serving(jtrainer, jbundle, out / "jax", buckets=BUCKETS)
    return dict(name=request.param, trainer=trainer, path=out / "port", jax_path=out / "jax",
                served=ServingModel.load(out / "port", device="cpu"),
                jax_served=JaxServingModel.load(out / "jax"))


def test_artifact_round_trip_answers_like_the_trainer(artifacts):
    p, l = _pairs(300, seed=1)
    fn, _ = build_trainer_serving_fn(artifacts["trainer"])
    want = fn(p, l).numpy()
    np.testing.assert_allclose(artifacts["served"].predict(p, l), want, **TOL)
    files = sorted(f.name for f in artifacts["path"].iterdir())
    assert files == ["pairs_b256.pt2", "pairs_b64.pt2", "serving.json", "weights.npz"]


def test_artifact_answers_like_the_jax_artifact(artifacts):
    p, l = _pairs(300, seed=2)
    np.testing.assert_allclose(artifacts["served"].predict(p, l), artifacts["jax_served"].predict(p, l), **TOL)
    ours = artifacts["served"].predict_patient(7, denormalize=True)
    theirs = artifacts["jax_served"].predict_patient(7, denormalize=True)
    assert list(ours) == list(theirs)
    np.testing.assert_allclose(list(ours.values()), list(theirs.values()), **TOL)


def test_manifest_has_every_key_of_the_jax_manifest(artifacts):
    ours = artifacts["served"].manifest
    record = json.loads((REPO / "outputs/eicu_real/serving/serving.json").read_text())
    theirs = artifacts["jax_served"].manifest
    assert set(record) <= set(ours) and set(theirs) <= set(ours)
    assert ours["format"] == serving.FORMAT and ours["export_platform"] == "cpu"
    for key in ("buckets", "num_patients", "num_labs", "model_hash", "architecture", "lab_names",
                "normalize_method"):
        assert ours[key] == theirs[key], key
    assert list(ours["lab_stats"]) == list(theirs["lab_stats"])
    for lab, want in theirs["lab_stats"].items():
        for key in ("mean", "std"):  # the graph builds' float32 means: within an ulp
            assert ours["lab_stats"][lab][key] == pytest.approx(want[key], rel=2e-7), (lab, key)
    # the leaves: the head parameters the request path reads, then the state
    state_keys = {"final_l", "final_p"} | ({"degree", "init_l", "init_p"} if artifacts["name"] != "hgt" else set())
    assert [n for n in ours["leaves"] if n.startswith("state.")] == [f"state.{k}" for k in sorted(state_keys)]
    heads = [n for n in ours["leaves"] if not n.startswith("state.")]
    assert heads and all(n.split(".")[0] in ("tabular_mlp", "edge_predictor") for n in heads)
    with np.load(artifacts["path"] / "weights.npz") as z:
        assert len(z.files) == len(ours["leaves"])


@pytest.mark.parametrize("artifacts", ["rgcn_concat"], indirect=True)
def test_requests_chunk_and_validate_as_jax(artifacts):
    served, jax_served = artifacts["served"], artifacts["jax_served"]
    p, l = _pairs(1000, seed=3)  # > the largest bucket (256): 4 chunks
    out = served.predict(p, l)
    assert out.shape == (1000,)
    np.testing.assert_allclose(out[:300], served.predict(p[:300], l[:300]), rtol=1e-6)
    np.testing.assert_allclose(out, jax_served.predict(p, l), **TOL)
    n_pat, n_lab = served.manifest["num_patients"], served.manifest["num_labs"]
    for model in (served, jax_served):
        with pytest.raises(ValueError, match=r"patient index out of range \[0, 300\)"):
            model.predict([n_pat], [0])
        with pytest.raises(ValueError, match=r"lab index out of range \[0, 20\)"):
            model.predict([0], [n_lab])
        with pytest.raises(ValueError, match="patient/lab shape mismatch"):
            model.predict([0, 1], [0])
        with pytest.raises(ValueError, match="artifact has no conformal.json"):
            model.predict([0], [0], return_interval=True)
        with pytest.raises(ValueError, match="artifact has no coldstart.npz"):
            model.predict_cold_start({0: 0.1})
        with pytest.raises(ValueError, match="exceeds the largest bucket 256"):
            model._call_padded(p[:257], l[:257])
        assert model.predict([], []).shape == (0,)
    assert served.buckets == jax_served.buckets == list(BUCKETS)


@pytest.mark.parametrize("artifacts", ["rgcn_concat"], indirect=True)
def test_a_jax_artifact_is_refused(artifacts):
    for path in (artifacts["jax_path"], REPO / "outputs/eicu_real/serving"):
        with pytest.raises(ValueError, match=r"format 'multi_modal_gnn_tpu.serving/v1' is not"):
            ServingModel.load(path, device="cpu")


def test_programs_hold_no_weights(tmp_path):
    """At hidden 128 on 8,000 patients each bucket's program is under 1 % of
    ``weights.npz``: the weights are inputs, stored once."""
    cfg = Config.from_dict({"model": {"hidden_dim": 128, "extras": {"head_style": "factored"}}})
    spec = dict(SPEC, num_patients=8000, mean_labs_per_patient=3.0)
    bundle = _port_bundle(cfg, spec)
    model = build_model(cfg, bundle.graph, device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, bundle.graph, masker_from_config(cfg, bundle.graph), cfg, device="cpu")
    export_serving(trainer, bundle, tmp_path, buckets=BUCKETS)
    weights = (tmp_path / "weights.npz").stat().st_size
    assert weights > 8000 * 128 * 4 * 2
    for b in BUCKETS:
        assert (tmp_path / f"pairs_b{b}.pt2").stat().st_size < 0.01 * weights, b
    p, l = _pairs(100, seed=4, num_p=8000)
    fn, _ = build_trainer_serving_fn(trainer)
    np.testing.assert_allclose(ServingModel.load(tmp_path, device="cpu").predict(p, l), fn(p, l).numpy(), **TOL)


@pytest.mark.parametrize("source", ["context", "head"])
def test_value_context_artifact_answers_like_jax(tmp_path, source):
    """A factored RGCN with value context and the ``context`` (or ``head``)
    bilinear source, trained 2 epochs by the port: its artifact carries
    ``bl_u`` / ``bl_l`` in the state (computed under the eval visibility
    template), or each head's own factors among the head parameters, and
    answers like the trainer and like the JAX artifact of the same weights."""
    jcfg = _jax_config(dict(architecture="RGCN", extras={"head_style": "factored", "value_context": True}))
    head = dataclasses.replace(jcfg.model.edge_head, extras={"bilinear_rank": 4, "bilinear_source": source})
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, edge_head=head))
    jbundle = make_synthetic_bundle(JaxSpec(**SPEC), jcfg)
    cfg = Config.from_dict(jcfg.to_dict())
    bundle = _port_bundle(cfg)
    model = build_model(cfg, bundle.graph, device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, bundle.graph, masker_from_config(cfg, bundle.graph), cfg, device="cpu")
    for _ in range(2):
        trainer.train_epoch()
        trainer.epoch += 1
    export_serving(trainer, bundle, tmp_path / "port", buckets=BUCKETS)
    jax_export_serving(_jax_trainer(jcfg, jbundle, trainer.model), jbundle, tmp_path / "jax", buckets=BUCKETS)
    served, jax_served = ServingModel.load(tmp_path / "port", device="cpu"), JaxServingModel.load(tmp_path / "jax")
    leaves = set(served.manifest["leaves"])
    if source == "context":
        assert {"state.bl_u", "state.bl_l"} <= leaves
    else:
        assert {f"{m}.bilinear_{s}" for m in ("tabular_mlp", "edge_predictor") for s in "ul"} <= leaves
        assert "state.bl_u" not in leaves
    p, l = _pairs(300, seed=6)
    fn, _ = build_trainer_serving_fn(trainer)
    np.testing.assert_allclose(served.predict(p, l), fn(p, l).numpy(), **TOL)
    np.testing.assert_allclose(served.predict(p, l), jax_served.predict(p, l), **TOL)


# -- cold start ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cold():
    """Both packages' graphs, maskers (with and without a "cal" split) and
    ALS / side-information ALS fits on the train split."""
    jcfg = _jax_config(MODELS["rgcn_concat"])
    jbundle = make_synthetic_bundle(JaxSpec(**SPEC), jcfg)
    bundle = _port_bundle(Config.from_dict(jcfg.to_dict()))
    out = dict(jbundle=jbundle, bundle=bundle, num_p=SPEC["num_patients"], num_l=SPEC["num_labs"])
    for cal in (0.0, 0.2):
        ours = EdgeMasker(bundle.graph, seed=5, calibration_split=cal)
        theirs = JaxEdgeMasker(jbundle.graph, seed=5, host_edges=jbundle.patient_lab_host(), calibration_split=cal)
        out[cal] = (ours, theirs)
    p, l, v = out[0.0][1].split_arrays("train")
    out["train"] = (p, l, v)
    out["jax_als"] = jax_baselines.ALSBaseline(out["num_p"], out["num_l"], rank=4, iters=8).fit(v, p, l)
    out["jax_mem"] = bundle_membership_matrix(jbundle)
    out["jax_si"] = jax_baselines.SideInfoALSBaseline(out["num_p"], out["num_l"], rank=4, mem_rank=3, iters=8).fit(
        v, p, l, out["jax_mem"]
    )
    return out


def _port_als(jax_als):
    als = ALSBaseline(jax_als.num_patients, jax_als.num_labs, rank=jax_als.rank, reg=jax_als.reg)
    als.C, als.lab_bias = jax_als.C, jax_als.lab_bias
    return als


def _port_si(jax_si):
    si = SideInfoALSBaseline(jax_si.num_patients, jax_si.num_labs, rank=jax_si.rank, mem_rank=jax_si.mem_rank,
                             reg=jax_si.reg)
    si.C, si.lab_bias, si.H, si.mem_proj = jax_si.C, jax_si.lab_bias, jax_si.H, jax_si.mem_proj
    return si


def test_fold_ins_equal_jax_on_the_same_factors(cold):
    p, l, v = cold["train"]
    als, si = _port_als(cold["jax_als"]), _port_si(cold["jax_si"])
    memberships = graph_membership_matrix(cold["bundle"].graph)
    np.testing.assert_array_equal(memberships, cold["jax_mem"])
    queries = np.arange(cold["num_l"])
    for pid in (0, 17, 123):
        labs, vals = l[p == pid], v[p == pid]
        np.testing.assert_allclose(als.fold_in(labs, vals), cold["jax_als"].fold_in(labs, vals), **COLD_TOL)
        np.testing.assert_allclose(
            als.predict_cold_start(labs, vals, queries),
            cold["jax_als"].predict_cold_start(labs, vals, queries), **COLD_TOL,
        )
        for ours, theirs in zip(si.fold_in(labs, vals, memberships[pid]),
                                cold["jax_si"].fold_in(labs, vals, memberships[pid])):
            np.testing.assert_allclose(ours, theirs, **COLD_TOL)
        np.testing.assert_allclose(
            si.predict_cold_start(labs, vals, queries, memberships[pid]),
            cold["jax_si"].predict_cold_start(labs, vals, queries, memberships[pid]), **COLD_TOL,
        )
    assert als.fold_in([], []).shape == (4,)
    u, g = si.fold_in([], [], memberships[3])
    assert not u.any() and g.shape == (3,)
    with pytest.raises(ValueError, match="membership width"):
        si.fold_in([], [], memberships[3][:-1])
    # the ALS fit itself is the JAX fit, so fold_in is its U half-step
    ours = ALSBaseline(cold["num_p"], cold["num_l"], rank=4, iters=8).fit(v, p, l)
    np.testing.assert_allclose(ours.C, cold["jax_als"].C, **COLD_TOL)
    labs, vals = l[p == 17], v[p == 17]
    c = ours.C[labs]
    want = np.linalg.solve(ours.reg * np.eye(4) + c.T @ c, c.T @ (vals - ours.lab_bias[labs]))
    np.testing.assert_allclose(ours.fold_in(labs, vals), want, **COLD_TOL)


@pytest.mark.parametrize("cal", [0.0, 0.2])
@pytest.mark.parametrize("side_info", [False, True])
def test_cold_start_radii_equal_jax(cold, cal, side_info):
    ours_m, theirs_m = cold[cal]
    assert ours_m.has_calibration_split == theirs_m.has_calibration_split == (cal > 0)
    for split in ("train", "cal" if cal else "val"):
        for a, b in zip(ours_m.split_arrays(split), theirs_m.split_arrays(split)):
            np.testing.assert_array_equal(a, b)
    if side_info:
        mem = cold["jax_mem"]
        ours = calibrate_cold_start(_port_si(cold["jax_si"]), ours_m, cold["num_l"], min_per_lab=5, memberships=mem)
        theirs = jax_calibrate_cold_start(cold["jax_si"], theirs_m, cold["num_l"], min_per_lab=5, memberships=mem)
    else:
        ours = calibrate_cold_start(_port_als(cold["jax_als"]), ours_m, cold["num_l"], min_per_lab=5)
        theirs = jax_calibrate_cold_start(cold["jax_als"], theirs_m, cold["num_l"], min_per_lab=5)
    assert ours.to_dict() == theirs.to_dict()


@pytest.mark.parametrize("side_info", [False, True])
def test_a_jax_coldstart_file_serves_jax_answers(cold, side_info, tmp_path):
    """The port's ServingModel reads a JAX-written ``coldstart.npz`` and
    ``conformal_cold.json`` and answers as JAX's does."""
    jcfg = _jax_config(MODELS["rgcn_concat"])
    cfg = Config.from_dict(jcfg.to_dict())
    model = build_model(cfg, cold["bundle"].graph, device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, cold["bundle"].graph, cold[0.0][0], cfg, device="cpu")
    export_serving(trainer, cold["bundle"], tmp_path / "port", buckets=(64,))
    factors = cold["jax_si"] if side_info else cold["jax_als"]
    kw = dict(memberships=cold["jax_mem"]) if side_info else {}
    radii = jax_calibrate_cold_start(factors, cold[0.0][1], cold["num_l"], min_per_lab=5, **kw)
    jtrainer = _jax_trainer(jcfg, cold["jbundle"], model, cold[0.0][1])
    jax_export_serving(jtrainer, cold["jbundle"], tmp_path / "jax", buckets=(64,), cold_start=factors,
                       conformal_cold=radii)
    for name in ("coldstart.npz", "conformal_cold.json"):
        shutil.copy(tmp_path / "jax" / name, tmp_path / "port" / name)
    ours, theirs = ServingModel.load(tmp_path / "port", device="cpu"), JaxServingModel.load(tmp_path / "jax")
    member = cold["jax_mem"][11] if side_info else None
    p, l, v = cold["train"]
    observed = {int(lab): float(val) for lab, val in zip(l[p == 11], v[p == 11])}
    for obs in (observed, {}):
        # denormalized: the graph builds' float32 lab stats agree within an ulp
        for denorm, tol in ((False, COLD_TOL), (True, dict(rtol=2e-7, atol=0))):
            a = ours.predict_cold_start(obs, denormalize=denorm, memberships=member)
            b = theirs.predict_cold_start(obs, denormalize=denorm, memberships=member)
            assert list(a) == list(b)
            np.testing.assert_allclose(list(a.values()), list(b.values()), **tol)
        a = ours.predict_cold_start(obs, memberships=member, return_interval=True)
        b = theirs.predict_cold_start(obs, memberships=member, return_interval=True)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_allclose(a[k]["predicted"], b[k]["predicted"], **COLD_TOL)
            np.testing.assert_allclose(a[k]["interval"], b[k]["interval"], **COLD_TOL)
    if not side_info:
        with pytest.raises(ValueError, match="side-information"):
            ours.predict_cold_start(observed, memberships=cold["jax_mem"][11])
    with pytest.raises(ValueError, match=r"observed lab index out of range \[0, 20\)"):
        ours.predict_cold_start({20: 0.5}, memberships=member)


# -- _as_index -------------------------------------------------------------------------


def test_as_index_checks_host_batches_on_the_host(monkeypatch):
    def no_device_readback(*args, **kwargs):
        raise AssertionError("a host batch was checked on the device")

    monkeypatch.setattr(torch, "aminmax", no_device_readback)
    for batch in ([0, 3, 9], np.array([0, 3, 9], np.int32), torch.tensor([0, 3, 9], dtype=torch.int32)):
        t = serving._as_index(batch, 10, "lab", "cpu")
        assert t.dtype == torch.long and t.tolist() == [0, 3, 9]
    assert serving._as_index([], 0, "lab", "cpu").shape == (0,)
    with pytest.raises(ValueError, match="lab: expected a 1-D index batch, got shape"):
        serving._as_index(np.zeros((2, 2), np.int64), 10, "lab", "cpu")
    with pytest.raises(IndexError, match=r"patient: indices must lie in \[0, 10\)"):
        serving._as_index([0, 10], 10, "patient", "cpu")
    with pytest.raises(IndexError, match=r"patient: indices must lie in \[0, 10\)"):
        serving._as_index(torch.tensor([-1, 2]), 10, "patient", "cpu")


# -- the serving bench -----------------------------------------------------------------

# the report keys of scripts/bench_serving.py but "backend", whose place
# "device" takes (the card's name and power limit)
JAX_BENCH_KEYS = {
    "buckets", "export_s", "load_s", "single_patient", "batch_bucket", "batch_pairs_per_s",
    "cold_start", "full_forward_per_request", "speedup_vs_full_forward_p50",
}


def test_serving_bench_reports_the_jax_keys_on_the_cpu():
    from multi_modal_gnn_tpu_torch.tools import bench_serving

    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        report = bench_serving.run_bench_serving(requests=3, batch_requests=1, device="cpu")
    finally:
        torch.set_num_threads(torch_threads)
    assert JAX_BENCH_KEYS | {"device", "eager_single_patient", "config", "graph_build_s"} == set(report)
    assert report["device"] == "cpu" and report["buckets"] == [256, 4096] and report["batch_bucket"] == 4096
    for key in ("single_patient", "eager_single_patient", "cold_start", "full_forward_per_request"):
        assert set(report[key]) == {"p50_ms", "p95_ms", "mean_ms"} and report[key]["p50_ms"] > 0, key
    assert json.loads(json.dumps(report)) == report


def test_serving_bench_has_no_cpu_fallback(monkeypatch):
    from multi_modal_gnn_tpu_torch.tools import bench_serving

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_serving.main(["--requests", "1"])
