"""PyTorch port: bfloat16 beyond the segment and pair-head path against the
JAX package, on the CPU.

JAX's bfloat16 side runs op by op, uncompiled (under ``jax.jit`` XLA on the
CPU keeps bfloat16 values in float32 across fused ops, so its casts would
not round), its float32 side compiled; both packages get the same weights
and the port's numpy supervision mask, dropout 0, and both run the kernel
path (JAX's Pallas kernels in interpret mode sum in float32, as the port's
do: JAX's XLA path rounds each add, where the port sums in float32).  "Within the ratio" means
``|port_bf16 - jax_bf16| <= 0.5 |jax_bf16 - jax_f32|`` in the 2-norm
(``test_torch_bf16.RATIO``: the port's disagreement with JAX well under
bfloat16's own effect; the ratios print with ``-s``).

* Value context (``model.extras.value_context``) on JAX-initialised
  weights: the RGCN on the kernel path and the HGT, whose only bfloat16
  modules are its ``vctx_*`` projections.  The eval template's node state
  and cached requests, and one train step's loss and gradients (Adam's
  first moment), within the ratio, JAX's context sums rounded once as the
  port's are (the stated deviation; the ratio to JAX's own sums, rounded at
  every add, is printed).  Both routes of the context sums on a bfloat16
  table within one bfloat16 spacing of their float64 sums (the card's
  route drops the rounding of each product that the plain route keeps).
* Cluster-GCN in bfloat16: ``tests/test_torch_bf16_clusters.py``.
* The serving artifact: a bfloat16 RGCN's ``export_serving`` writes each
  bfloat16 leaf as its ``uint16`` bit pattern and names every leaf's dtype;
  ``ServingModel`` answers in float32 within ``1e-5 + 1e-5 |ref|`` of the
  port's eager bfloat16 serving, and (the value-context RGCN's) within the
  ratio of JAX's bfloat16 ``build_serving_fn``.  A float32 artifact keeps float32 leaves, and one
  whose manifest has no ``leaf_dtypes`` (written before bfloat16 leaves
  existed) loads and answers alike.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu import serving as jax_serving
from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.graph.build import assemble_graph as jax_assemble
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.models.factory import init_model_variables
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxEdgeMasker
from multi_modal_gnn_tpu.training.trainer import Trainer as JaxTrainer
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import generate_synthetic_edges, make_synthetic_graph
from multi_modal_gnn_tpu_torch.graph.attn_plan import ensure_attn_plans
from multi_modal_gnn_tpu_torch.graph.build import GraphBundle, GraphMeta, assemble_graph
from multi_modal_gnn_tpu_torch.graph.hetero import build_value_plan
from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT, PATIENT_LAB
from multi_modal_gnn_tpu_torch.models import build_model, context, state_dict_from_flax
from multi_modal_gnn_tpu_torch.serving import ServingModel, build_trainer_serving_fn, export_serving
from multi_modal_gnn_tpu_torch.training import EdgeMasker, Trainer
from test_torch_bf16 import RATIO, _adam_first_moments, _feeds_batch_norm, _ratio, _within_one_bf16_spacing
from test_torch_bf16 import SPEC as BF16_SPEC
from test_torch_bf16 import _jax_config as _bf16_config
from test_torch_value_context import SPEC, _config_dict, flax_variables

BF = "bfloat16"
# the value-context cohort: test_torch_bf16's (600 patients, 40 labs)
VC_SPEC = BF16_SPEC


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cohort():
    """``test_torch_value_context``'s cohort (300 patients, 20 labs, hidden
    16), graphs assembled by both packages from the same edge arrays."""
    edge_arrays, node_counts = generate_synthetic_edges(SPEC)
    d = _config_dict("rgcn_concat", False, "head")
    jgraph = jax_assemble(edge_arrays, node_counts, config=JaxConfig.from_dict(d))
    graph = assemble_graph(edge_arrays, node_counts, Config.from_dict(d))
    masker = EdgeMasker(graph, seed=4)
    return dict(jgraph=jgraph, graph=graph, masker=masker, jmasker=JaxEdgeMasker(jgraph, seed=4))


def _ratio_or_close(port, jax_bf16, jax_f32, name):
    """The ratio of ``port``'s disagreement with JAX's bfloat16 value to
    bfloat16's effect; where JAX's two dtypes agree (a float32 path in both),
    ``port`` is held to ``1e-5 + 1e-5 |ref|`` instead and the ratio is 0."""
    a, b = (np.asarray(jnp.asarray(v, jnp.float32)) for v in (jax_bf16, jax_f32))
    if np.array_equal(a, b):
        got = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
        np.testing.assert_allclose(got, a, rtol=1e-5, atol=1e-5, err_msg=name)
        return 0.0
    return _ratio(port, jax_bf16, jax_f32)


# -- value context ----------------------------------------------------------------


def _vc_config(arch, dtype):
    """``test_torch_bf16``'s configuration (hidden 32, factored heads,
    dropout 0) with value context: the RGCN on the kernel path (JAX's Pallas
    kernels sum in float32, as the port's do), the HGT on the segment tier."""
    cfg = _bf16_config(arch, dtype, use_pallas=arch == "RGCN")
    return cfg.replace(model=dataclasses.replace(cfg.model, extras={**cfg.model.extras, "value_context": True}))


def _init(arch, graph):
    """JAX's initial weights of the float32 value-context model."""
    return init_model_variables(jax_build_model(_vc_config(arch, "float32"), graph), graph, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def kernel_cohort():
    """``VC_SPEC``'s cohort (slot-major train batches) and JAX-initialised
    weights of each value-context model."""
    jcfg = _vc_config("RGCN", BF)
    bundle = make_synthetic_bundle(JaxSpec(**dataclasses.asdict(VC_SPEC)), jcfg)
    graph = make_synthetic_graph(VC_SPEC, Config.from_dict(jcfg.to_dict()), device="cpu")
    return dict(
        bundle=bundle, graph=graph,
        masker=EdgeMasker(graph, seed=4, slot_major_train=True, slot_major_min_rows=0),
        jmasker=JaxEdgeMasker(bundle.graph, seed=4, slot_major_train=True, slot_major_min_rows=0),
        variables={arch: _init(arch, bundle.graph) for arch in ("RGCN", "HGT")},
    )


def _segment_sum_rounded_once(data, segment_ids, num_segments=None, **kwargs):
    """``jax.ops.segment_sum`` of bfloat16 rows in float32, rounded once:
    the port's context sums (the stated deviation from JAX's sum, which
    rounds at every add)."""
    total = jax.ops.segment_sum(data.astype(jnp.float32), segment_ids, num_segments=num_segments, **kwargs)
    return total.astype(data.dtype)


@pytest.fixture
def sums_rounded_once(monkeypatch):
    """JAX's value-context module with its sums rounded once (the JAX
    package's files are unchanged)."""
    from types import SimpleNamespace

    from multi_modal_gnn_tpu.models import context as jax_context

    monkeypatch.setattr(jax_context, "jax", SimpleNamespace(
        ops=SimpleNamespace(segment_sum=_segment_sum_rounded_once), lax=jax.lax))


def _is_translation_free(name, arch):
    """Parameters with a gradient of exactly 0 in exact arithmetic, where
    each side holds only its rounding noise: a bias feeding a BatchNorm
    (``test_torch_bf16._feeds_batch_norm``); in the RGCN the value-context
    biases too (they shift every patient or lab row alike, and those rows
    reach the loss only through mean aggregations into BatchNorm); and an
    HGT key bias (it shifts every logit of a query alike, which the softmax
    takes out)."""
    if arch == "RGCN":
        return _feeds_batch_norm(name) or name in ("vctx_patient.bias", "vctx_lab.bias")
    return name.startswith("hgt_") and ".k_" in name and name.endswith(".bias")


def _jax_serving(jtrainer, dtype, p, l):
    """JAX ``build_serving_fn(trainer)``: its node state and its answers to
    ``(p, l)`` (bfloat16 uncompiled, float32 compiled)."""
    def run():
        fn, state = jax_serving.build_serving_fn(jtrainer)
        return state, fn(jnp.asarray(p), jnp.asarray(l))

    if dtype == BF:
        with jax.disable_jit():
            return run()
    return run()


@pytest.mark.parametrize("arch", ["RGCN", "HGT"])
def test_bf16_value_context_matches_jax(kernel_cohort, sums_rounded_once, monkeypatch, tmp_path, arch):
    """Bridged JAX weights, dropout 0: the eval-template node state and 300
    requests against JAX ``build_serving_fn`` (for the RGCN also the
    serving artifact's answers, within ``1e-5 + 1e-5 |ref|`` of the eager
    serving path), then one train step of JAX's ``Trainer`` (the
    visibility knockout, BatchNorm on batch statistics, Adam) with one
    supervision mask: loss and Adam's first moment (the step's gradient)
    within the ratio, parameters within ``2e-3``.  JAX's context sums are
    rounded once here, as the port's are; the state's ratio to JAX's own
    sums (rounded at every add) is printed beside."""
    from multi_modal_gnn_tpu.models import context as jax_context

    co = kernel_cohort
    variables = co["variables"][arch]
    cfg = Config.from_dict(_vc_config(arch, BF).to_dict())
    graph = ensure_attn_plans(co["graph"], cfg) if arch == "HGT" else co["graph"]
    model = build_model(cfg, graph, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    trainer = Trainer(model, graph, co["masker"], cfg, device="cpu")
    assert model.compute_dtype == torch.bfloat16 and model.vctx_patient.compute_dtype == torch.bfloat16
    jtrainers = {dtype: JaxTrainer(jax_build_model(_vc_config(arch, dtype), co["bundle"].graph), co["bundle"].graph,
                                   co["jmasker"], _vc_config(arch, dtype), variables=variables)
                 for dtype in (BF, "float32")}

    # the eval template's node state and JAX's serving answers, and the
    # port's artifact (RGCN) against its eager serving and JAX's
    rng = np.random.default_rng(1)
    p = rng.integers(0, VC_SPEC.num_patients, 300).astype(np.int32)
    l = rng.integers(0, VC_SPEC.num_labs, 300).astype(np.int32)
    want = {dtype: _jax_serving(jt, dtype, p, l) for dtype, jt in jtrainers.items()}
    fn, state = build_trainer_serving_fn(trainer)
    assert set(state) == set(want[BF][0])
    ratios = {f"state.{key}": _ratio_or_close(state[key], want[BF][0][key], want["float32"][0][key], key)
              for key in ("final_p", "final_l", *(("init_p", "init_l") if arch == "RGCN" else ()))}
    eager = fn(p, l).numpy()
    ratios["answers"] = _ratio_or_close(eager, want[BF][1], want["float32"][1], "answers")
    if arch == "RGCN":
        path = export_serving(trainer, _bundle(graph), tmp_path / "serving", buckets=(128,))
        served = ServingModel.load(path, device="cpu").predict(p, l)
        assert served.dtype == np.float32
        np.testing.assert_allclose(served, eager, rtol=1e-5, atol=1e-5)
        ratios["artifact"] = _ratio(served, want[BF][1], want["float32"][1])
    with monkeypatch.context() as m:  # JAX's own sums, each add rounded
        m.setattr(jax_context, "jax", jax)
        own = _jax_serving(jtrainers[BF], BF, p, l)[0]
    own_ratio = _ratio(state["final_p"], own["final_p"], want["float32"][0]["final_p"])

    # one train step
    sup = (np.random.default_rng(0).random(co["masker"].get_split("train").valid.shape[0]) < 0.4)
    results = {}
    for dtype, jt in jtrainers.items():
        jbatch = jt._get_batch("train")
        copy = lambda s: jax.tree_util.tree_map(jnp.array, s)  # noqa: E731 (donation)
        args = (copy(jt.state), jt.graph, jbatch, jt.lab_weights,
                jnp.asarray(sup.astype(np.float32)) * jbatch.valid, jax.random.key(7))
        jstate, jloss = jt._train_step_impl(*args) if dtype == BF else jt._train_step(*args)
        results[dtype] = (float(jloss), state_dict_from_flax({"params": jstate.params}),
                          state_dict_from_flax({"params": _adam_first_moments(jstate.opt_state)}))
    batch = trainer.get_batch("train")
    loss = trainer.train_step(batch, torch.from_numpy(sup.astype(np.float32)) * batch.valid, 0)
    (lb, pb, mb), (lf, _, mf) = results[BF], results["float32"]
    ratios["loss"] = _ratio(np.float32(loss), lb, lf)
    largest = max(np.linalg.norm(v.numpy()) for v in mb.values())
    for name, value in model.named_parameters():
        got = trainer.optimizer.state[value]["exp_avg"].numpy()
        if _is_translation_free(name, arch):
            assert np.linalg.norm(got) <= 2 * np.linalg.norm(mb[name].numpy()) + 1e-6 * largest, name
            continue
        diff, effect = np.linalg.norm(got - mb[name].numpy()), np.linalg.norm(mb[name].numpy() - mf[name].numpy())
        assert diff <= RATIO * effect + 1e-6 * largest, (name, diff, effect)
        if effect > 1e-6 * largest:
            ratios[f"grad.{name}"] = diff / effect
        np.testing.assert_allclose(value.detach().numpy(), pb[name].numpy(), atol=2e-3, err_msg=name)
    print(f"\n{arch} bf16 value context: largest ratios", sorted(ratios.items(), key=lambda kv: -kv[1])[:12],
          f"; final_p against JAX's sums rounded at every add: {own_ratio:.4f}")
    assert max(ratios.values()) <= RATIO, ratios


def test_bf16_context_sums_round_once_on_both_routes(cohort, monkeypatch):
    """The context sums of a bfloat16 patient table (the bfloat16 RGCN's;
    its lab table is float32) on the card's route (sparse products over
    float32 copies, forced onto the CPU) and the plain route (``index_add_``
    of products rounded to bfloat16, as JAX rounds them): each within one
    bfloat16 spacing of its float64 sum, rounded once; the lab side in
    float32 on both; the counts equal; the sparse route's gradient of the
    patient rows within one spacing of the float64 transposed product."""
    graph = cohort["graph"]
    es = graph.edges[PATIENT_LAB]
    vis = torch.from_numpy(cohort["masker"].visibility_base(es.src.shape[0]))
    es = dataclasses.replace(es, val_vis=vis, value_plan=build_value_plan(es))
    gen = torch.Generator().manual_seed(3)
    x_p = torch.randn(SPEC.num_patients, 16, generator=gen).bfloat16()
    x_l = torch.randn(SPEC.num_labs, 16, generator=gen)
    g = torch.randn(es.num_dst, 16, generator=gen).bfloat16()
    e = es.num_valid
    src, dst = es.src[:e].long().numpy(), es.dst[:e].long().numpy()
    v = (es.val * vis)[:e].bfloat16().double().numpy()
    rows_p = x_p.double().numpy()[src]
    exact = {True: rows_p * v[:, None],  # float32 products: exact in float64
             False: (x_p[torch.from_numpy(src)] * (es.val * vis)[:e].bfloat16()[:, None]).double().numpy()}
    counts = {}
    for sparse in (True, False):
        monkeypatch.setattr(context, "csr_route", lambda es, device, sparse=sparse: sparse)
        leaf = x_p.clone().requires_grad_()
        sums = context._Sums(es, torch.device("cpu"))
        (wsum_l, cnt_l), (wsum_p, cnt_p) = sums.lab(leaf), sums.patient(x_l)
        assert wsum_l.dtype == torch.bfloat16 and wsum_p.dtype == torch.float32
        want = np.zeros((es.num_dst, 16))
        np.add.at(want, dst, exact[sparse])
        _within_one_bf16_spacing(wsum_l.detach(), torch.from_numpy(want).bfloat16(), f"sparse={sparse}")
        want_p = np.zeros((es.num_src, 16))
        np.add.at(want_p, src, x_l.double().numpy()[dst] * (es.val * vis)[:e].double().numpy()[:, None])
        np.testing.assert_allclose(wsum_p.numpy(), want_p, rtol=1e-5, atol=1e-5)
        counts[sparse] = (cnt_l, cnt_p)
        if sparse:
            wsum_l.backward(g)
            grad = np.zeros((es.num_src, 16))
            np.add.at(grad, src, g.double().numpy()[dst] * v[:, None])
            _within_one_bf16_spacing(leaf.grad, torch.from_numpy(grad).bfloat16(), "gradient")
    assert all(torch.equal(a, b) for a, b in zip(counts[True], counts[False]))


def _bundle(graph):
    return GraphBundle(graph=graph, meta=GraphMeta(), host_edges=None)


def test_bf16_serving_artifact_stores_bit_patterns(cohort, tmp_path):
    """The artifact of a bfloat16 RGCN (the row-major path) names each
    leaf's dtype, stores its bfloat16 leaves as their bit patterns, and
    answers in float32 within ``1e-5 + 1e-5 |ref|`` of the eager serving
    path (against JAX: ``test_bf16_value_context_matches_jax``)."""
    d = _config_dict("rgcn_factored", False, "embedding", compute_dtype=BF)
    cfg = Config.from_dict(d)
    model = build_model(cfg, cohort["graph"], device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, cohort["graph"], cohort["masker"], cfg, device="cpu")
    path = export_serving(trainer, _bundle(cohort["graph"]), tmp_path / "bf16", buckets=(64, 256))
    manifest = json.loads((path / "serving.json").read_text())
    dtypes = dict(zip(manifest["leaves"], manifest["leaf_dtypes"]))
    assert dtypes["state.init_p"] == "bfloat16" and dtypes["state.degree"] == "int32"
    assert {dtypes[n] for n in manifest["leaves"] if not n.startswith("state.")} == {"float32"}
    with np.load(path / "weights.npz") as z:
        stored = {name: z[f"w{i}"] for i, name in enumerate(manifest["leaves"])}
    fn, state = build_trainer_serving_fn(trainer)
    assert stored["state.init_p"].dtype == np.uint16
    assert np.array_equal(stored["state.init_p"], state["init_p"].view(torch.int16).numpy().view(np.uint16))
    rng = np.random.default_rng(1)
    p = rng.integers(0, SPEC.num_patients, 300).astype(np.int32)
    l = rng.integers(0, SPEC.num_labs, 300).astype(np.int32)
    got = ServingModel.load(path, device="cpu").predict(p, l)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, fn(p, l).numpy(), rtol=1e-5, atol=1e-5)


def test_float32_artifact_without_leaf_dtypes_still_loads(cohort, tmp_path):
    """A float32 artifact stores float32 leaves as before; with
    ``leaf_dtypes`` taken out of its manifest, as an artifact written before
    bfloat16 leaves existed, it loads and answers the same."""
    d = _config_dict("rgcn_factored", False, "embedding")
    cfg = Config.from_dict(d)
    model = build_model(cfg, cohort["graph"], device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, cohort["graph"], cohort["masker"], cfg, device="cpu")
    path = export_serving(trainer, _bundle(cohort["graph"]), tmp_path / "f32", buckets=(64,))
    with np.load(path / "weights.npz") as z:
        assert {z[k].dtype for k in z.files} <= {np.dtype(np.float32), np.dtype(np.int32)}
    p, l = np.arange(0, 300, 5, dtype=np.int32), np.arange(60, dtype=np.int32) % SPEC.num_labs
    want = ServingModel.load(path, device="cpu").predict(p, l)
    manifest = json.loads((path / "serving.json").read_text())
    assert set(manifest["leaf_dtypes"]) <= {"float32", "int32"}
    del manifest["leaf_dtypes"]
    (path / "serving.json").write_text(json.dumps(manifest))
    np.testing.assert_array_equal(ServingModel.load(path, device="cpu").predict(p, l), want)
    np.testing.assert_allclose(want, build_trainer_serving_fn(trainer)[0](p, l).numpy(), rtol=1e-5, atol=1e-5)
