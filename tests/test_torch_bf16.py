"""PyTorch port: the bfloat16 compute path (``model.compute_dtype: bfloat16 |
auto``) against the JAX package.

The same numpy inputs go through both packages in bfloat16; JAX runs its
Pallas kernels in interpret mode and the port's wrappers take their plain
versions on the CPU.

* The segment kernels K1, K2f, K2b and K3 on bfloat16 rows, a 601-fold
  duplicate edge among them: their float32 sums within ``1e-5 + 1e-5 |ref|``
  (both sides sum the same bfloat16 values in float32); the tiers
  (``aggregate_neighbors``), whose outputs and gradients leave in bfloat16,
  within one bfloat16 spacing of JAX's, the span and paired backwards
  included.
* ``fused_pair_head`` and ``fused_pair_head_dual``: the float32 outputs
  within ``1e-5``, ``jax.grad`` within ``1e-4 max |ref|`` per tensor and in
  the operands' dtypes.
* The slice: a bridged RGCN (factored heads, dual off and on) at dropout 0.
  Predictions, ``compute_node_state``, the gradients and one train step
  against JAX ``Trainer._train_step``: ``|port_bf16 - jax_bf16| <= 0.5
  |jax_bf16 - jax_f32|`` in the 2-norm, per output and per tensor (the
  port's disagreement with JAX well under bfloat16's own effect; the
  ratios are printed with ``-s``).  The HGT: JAX gives the compute dtype
  only to its value-context projections, so its bfloat16 model is its
  float32 model; the port's bfloat16 HGT equals its float32 HGT bit for bit
  and JAX's within the float32 parity bounds.
* The segment path and an unplanned gather's backward sum bfloat16 rows in
  float32 and round each total once: 1,000 copies of 1.0 sum to 1,000
  (rounding at every add stops at 256).
* The probe and the config: ``resolve_compute_dtype`` with the probe
  patched, ``auto`` on the CPU without probing, ``build_model`` with
  ``auto``, the refusals (value context, clusters, the serving artifact),
  and ``test_bf16_compute_path`` (3 finite epochs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.graph import hetero as jax_hetero
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.models.factory import init_model_variables
from multi_modal_gnn_tpu.ops import pallas_pairhead as jph
from multi_modal_gnn_tpu.ops import pallas_segment as jps
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxEdgeMasker
from multi_modal_gnn_tpu.training.trainer import Trainer as JaxTrainer
from multi_modal_gnn_tpu_torch.config import Config, ConfigError
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
from multi_modal_gnn_tpu_torch.graph import hetero
from multi_modal_gnn_tpu_torch.graph.attn_plan import ensure_attn_plans
from multi_modal_gnn_tpu_torch.models import build_model, state_dict_from_flax
from multi_modal_gnn_tpu_torch.ops import aggregate_neighbors, aggregation_tier, gather_rows, segment_sum
from multi_modal_gnn_tpu_torch.ops import segment_kernels as sk
from multi_modal_gnn_tpu_torch.ops.pairhead import fused_pair_head, fused_pair_head_dual
from multi_modal_gnn_tpu_torch.serving import build_serving_fn, compute_node_state, export_serving
from multi_modal_gnn_tpu_torch.tools import bench
from multi_modal_gnn_tpu_torch.training import EdgeMasker, MiniBatchTrainer, Trainer
from multi_modal_gnn_tpu_torch.utils import mxu_probe

BF = jnp.bfloat16
TOTAL_TOL = dict(rtol=1e-5, atol=1e-5)
RATIO = 0.5  # |port_bf16 - jax_bf16| <= RATIO * |jax_bf16 - jax_f32|


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) else x.detach().float().numpy()


def _within_one_bf16_spacing(got, want, name=""):
    """Each element within one bfloat16 spacing of ``want`` (2^-7 of it at
    most, 2^-133 near 0), plus float32 rounding."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), name
    spacing = np.maximum(np.abs(want) * 2.0 ** -7, 1e-30)
    assert (np.abs(got - want) <= spacing + 1e-6 * np.abs(want).max()).all(), name


# -- the segment kernels and tiers --------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread: the suite's workers share the cores, and a
    worker's torch on every core slows all of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def edges():
    """patient -> lab edges (4,200 patients, 60 labs), one of them 601 times,
    with the span plan, and the mirror lab -> patient relation: the span,
    paired and fused-table tiers, in both packages from the same arrays."""
    rng = np.random.default_rng(15)
    num_p, num_l = 4200, 60
    src = np.concatenate([np.full(601, 321), rng.integers(0, num_p, 20_000)])
    dst = np.concatenate([np.full(601, 7), rng.integers(0, num_l, 20_000)])
    out = {}
    for name, h in (("port", hetero), ("jax", jax_hetero)):
        fwd = h.pad_edge_set(src, dst, num_p, num_l, src_span_rows=256)
        rev = h.pad_edge_set(dst, src, num_l, num_p)
        out[name] = (fwd, rev)
    return out


def test_segment_kernels_sum_bf16_rows_in_float32(edges):
    (fwd, rev), (jfwd, jrev) = edges["port"], edges["jax"]
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((fwd.num_src, 32)), BF)  # patient rows
    xl = jnp.asarray(rng.standard_normal((rev.num_src, 32)), BF)  # lab rows
    g = jnp.asarray(rng.standard_normal((rev.num_dst, 32)), BF)  # patient-side gradient
    t = lambda a: torch.from_numpy(_np(a).copy()).to(torch.bfloat16)  # noqa: E731 (exact)
    mode = "take" if jps._vmem_take_supported() else "indicator"
    pad = max(128, -(-rev.num_src // 128) * 128)
    pairs = {
        "K1": (
            sk.segment_sum_windowed(t(x), fwd.win_src, fwd.win_local, fwd.win_tile_map, fwd.num_windows),
            jps._windowed_segment_sum_fwd(
                jnp.take(x, jfwd.win_src, axis=0), jfwd.win_local, jfwd.win_tile_map, jfwd.num_windows, True
            ),
        ),
        "K2f": (
            sk.fused_table_segment_sum(t(xl), rev.win_src, rev.win_local, rev.win_tile_map, rev.num_windows),
            jps._fused_table_segment_sum_fwd(
                xl, jrev.win_src, jrev.win_local, jrev.win_tile_map, jrev.num_windows, pad, True, mode
            ),
        ),
        "K2b": (
            sk.fused_table_segment_sum_bwd(t(g), rev.win_src, rev.win_local, rev.win_tile_map, rev.num_src),
            jps._fused_table_segment_sum_bwd(
                jnp.pad(g, ((0, jrev.num_windows * 128 - g.shape[0]), (0, 0))),
                jrev.win_src, jrev.win_local, jrev.win_tile_map, pad, True, mode,
            )[: rev.num_src],
        ),
        "K3": (
            sk.span_segment_sum(
                t(x), fwd.span_src, fwd.span_local, fwd.span_tile_map, fwd.span_base, fwd.num_windows,
                fwd.span_rows,
            ),
            jps._span_dma_segment_sum_fwd(
                x, jfwd.span_src, jfwd.span_local, jfwd.span_tile_map, jfwd.span_base, jfwd.num_windows,
                jfwd.span_rows, True,
            ),
        ),
    }
    for name, (got, want) in pairs.items():
        assert got.dtype == torch.float32 and jnp.asarray(want).dtype == jnp.float32, name
        np.testing.assert_allclose(got.numpy(), _np(want), **TOTAL_TOL, err_msg=name)
    # the 601 copies of (321 -> 7) count 601 times, not bfloat16's 600
    row = float(np.asarray(jnp.asarray(x[321], jnp.float32))[0])
    single = pairs["K3"][0][7, 0] - 601 * row
    others = np.asarray(jnp.asarray(x, jnp.float32))[:, 0][
        np.asarray(fwd.src[: fwd.num_valid])[np.asarray(fwd.dst[: fwd.num_valid]) == 7]
    ]
    assert abs(float(single) - (float(others.sum()) - 601 * row)) < 1e-3


@pytest.mark.parametrize("shape", [(3,), (3, 8)], ids=["vector", "rows"])
def test_bf16_scatters_sum_in_float32(shape):
    """gather_rows' backward and segment_sum on bfloat16 sum in float32 and
    round each total once: 1,000 adds of 1.0 give 1,000, where a bfloat16
    accumulator stops at 256 (256 + 1 rounds back to 256)."""
    idx = torch.zeros(1000, dtype=torch.long)
    x = torch.zeros(shape, dtype=torch.bfloat16, requires_grad=True)
    rows = gather_rows(x, idx)
    assert rows.dtype == torch.bfloat16 and rows.shape == (1000,) + shape[1:]
    rows.backward(torch.ones_like(rows))
    assert x.grad.dtype == torch.bfloat16 and (x.grad[0] == 1000).all() and (x.grad[1:] == 0).all()
    total = segment_sum(torch.ones((1000,) + shape[1:], dtype=torch.bfloat16), idx, 2)
    assert total.dtype == torch.bfloat16 and (total[0] == 1000).all() and (total[1] == 0).all()
    # 1,001 rounds once, to bfloat16's 1,000
    assert (segment_sum(torch.ones((1001,) + shape[1:], dtype=torch.bfloat16), idx[:1].repeat(1001), 1) == 1000).all()


@pytest.mark.parametrize("tier", ["fused_table", "span", "paired"])
def test_segment_tiers_match_jax_in_bf16(edges, tier):
    (fwd, rev), (jfwd, jrev) = edges["port"], edges["jax"]
    if tier == "fused_table":
        es, mirror, jes, jmirror = rev, fwd, jrev, jfwd
        fn = lambda a: jps.fused_table_aggregate(a, jes, "mean", interpret=True)  # noqa: E731
    elif tier == "span":
        es, mirror, jes, jmirror = fwd, rev, jfwd, jrev
        fn = lambda a: jps.span_dma_aggregate(a, jes, jmirror, "mean", interpret=True)  # noqa: E731
    else:
        es, mirror = dataclasses.replace(fwd, span_rows=0), rev
        jes, jmirror = jfwd, jrev
        fn = lambda a: jps.gather_segment_aggregate_paired(a, jes, jmirror, "mean", interpret=True)  # noqa: E731
    assert aggregation_tier(es, mirror, 32, itemsize=2) == tier
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((es.num_src, 32)), BF)
    g = jnp.asarray(rng.standard_normal((es.num_dst, 32)), BF)
    want = fn(x)
    want_grad = jax.grad(lambda a: jnp.sum((fn(a) * g).astype(jnp.float32)))(x)
    xt = torch.from_numpy(_np(x).copy()).to(torch.bfloat16).requires_grad_()
    out = aggregate_neighbors(xt, es, "mean", impl="pallas", edges_rev=mirror)
    (out.float() * torch.from_numpy(_np(g).copy())).sum().backward()
    assert out.dtype == xt.grad.dtype == torch.bfloat16 and want.dtype == want_grad.dtype == BF
    _within_one_bf16_spacing(out, want, f"{tier} forward")
    _within_one_bf16_spacing(xt.grad, want_grad, f"{tier} backward")


# -- the pair heads -----------------------------------------------------------


@pytest.fixture(scope="module")
def head_problem():
    """``tests/test_pairhead_kernel.py``'s problem: 300 patients, 37 labs,
    2,000 pairs in a slot-major layout; two heads' weights."""
    rng = np.random.default_rng(0)
    num_p, num_l, batch = 300, 37, 2000
    p_idx = rng.integers(0, num_p, batch).astype(np.int32)
    l_idx = rng.integers(0, num_l, batch).astype(np.int32)
    plan = jax_hetero.build_gather_plan(p_idx, num_p)
    win_local = np.asarray(plan.win_local, np.int32)
    l_s = np.where(win_local < 128, l_idx[np.asarray(plan.win_src)], 0).astype(np.int32)

    def head(r, b2):
        return [
            r.standard_normal((num_p, 64)).astype(np.float32), r.standard_normal((num_l, 64)).astype(np.float32),
            (r.standard_normal((64, 32)) * 0.1).astype(np.float32), (r.standard_normal(32) * 0.1).astype(np.float32),
            (r.standard_normal(32) * 0.1).astype(np.float32), np.float32(b2),
        ]

    num_tiles = len(win_local) // 1024
    return dict(
        plan=plan, l_s=l_s, win_local=win_local, tile_map=np.asarray(plan.win_tile_map, np.int32),
        heads=head(rng, 0.3) + head(np.random.default_rng(11), -0.2),
        masks=np.random.default_rng(9).integers(0, 2, (2, num_tiles)).astype(np.int32),
        g=np.random.default_rng(5).standard_normal((2, len(win_local))).astype(np.float32),
    )


def _jax_head(values):
    """The operands as JAX takes them in bfloat16: proj_p, proj_l and w1 in
    bfloat16, b1, w2 and b2 in float32."""
    return [jnp.asarray(v, BF if i % 6 < 3 else jnp.float32) for i, v in enumerate(values)]


def _port_head(values):
    out = [torch.from_numpy(_np(v).copy()).to(torch.bfloat16 if i % 6 < 3 else torch.float32)
           for i, v in enumerate(_jax_head(values))]
    for i in range(5, len(out), 6):
        out[i] = out[i].reshape(1)
    return [x.requires_grad_() for x in out]


def _compare_grads(got, want, names):
    for name, a, b in zip(names, got, want):
        assert a.dtype == (torch.bfloat16 if b.dtype == BF else torch.float32), name
        a, b = _np(a).reshape(np.shape(b)), _np(b)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), name


@pytest.mark.parametrize("masked", [False, True])
def test_fused_pair_head_matches_jax_in_bf16(head_problem, masked):
    pb = head_problem
    mask = pb["masks"][0] if masked else None
    plan = (jnp.asarray(pb["l_s"]), jnp.asarray(pb["win_local"]), jnp.asarray(pb["tile_map"]), jnp.zeros(2, jnp.uint32))

    def jfn(*a):
        return jph.fused_pair_head(*a, *plan, None if mask is None else jnp.asarray(mask), None,
                                   pb["plan"].num_windows, 0.0, True)

    jargs = _jax_head(pb["heads"][:6])
    want = jfn(*jargs)
    want_grads = jax.grad(lambda *a: jnp.sum(jfn(*a) * pb["g"][0]), argnums=tuple(range(6)))(*jargs)
    targs = _port_head(pb["heads"][:6])
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    out = fused_pair_head(
        *targs, t(pb["l_s"]), t(pb["win_local"]), t(pb["tile_map"]), (0, 0),
        None if mask is None else t(mask), None, pb["plan"].num_windows,
    )
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(out.detach().numpy(), _np(want), atol=1e-5)
    (out * t(pb["g"][0])).sum().backward()
    _compare_grads([x.grad for x in targs], want_grads, ("proj_p", "proj_l", "w1", "b1", "w2", "b2"))


def test_fused_pair_head_dual_matches_jax_in_bf16(head_problem):
    pb = head_problem
    jargs = _jax_head(pb["heads"])
    plan = (jnp.asarray(pb["l_s"]), jnp.asarray(pb["win_local"]), jnp.asarray(pb["tile_map"]),
            jnp.zeros(4, jnp.uint32), *map(jnp.asarray, pb["masks"]))

    def jfn(*a):
        return jph.fused_pair_head_dual(*a, *plan, pb["plan"].num_windows, 0.0, True)

    want = jfn(*jargs)
    want_grads = jax.grad(
        lambda *a: sum(jnp.sum(o * g) for o, g in zip(jfn(*a), pb["g"])), argnums=tuple(range(12))
    )(*jargs)
    targs = _port_head(pb["heads"])
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    outs = fused_pair_head_dual(
        *targs, t(pb["l_s"]), t(pb["win_local"]), t(pb["tile_map"]), (0, 0, 0, 0),
        t(pb["masks"][0]), t(pb["masks"][1]), pb["plan"].num_windows,
    )
    for a, b in zip(outs, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.detach().numpy(), _np(b), atol=1e-5)
    sum((o * t(g)).sum() for o, g in zip(outs, pb["g"])).backward()
    names = [f"{h}.{n}" for h in ("tab", "gnn") for n in ("proj_p", "proj_l", "w1", "b1", "w2", "b2")]
    _compare_grads([x.grad for x in targs], want_grads, names)


# -- the slice: RGCN and HGT ----------------------------------------------------

SPEC = SyntheticSpec(
    num_patients=600, num_labs=40, num_diagnoses=30, num_medications=20,
    mean_labs_per_patient=8.0, mean_diagnoses_per_patient=2.0,
    mean_medications_per_patient=2.0, latent_dim=4, seed=1,
)


def _jax_config(arch="RGCN", dtype="bfloat16", dual="off", use_pallas=True):
    cfg = JaxConfig()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, architecture=arch, hidden_dim=32, num_heads=4, dropout=0.0, use_pallas=use_pallas,
            compute_dtype=dtype, extras={"head_style": "factored", "dual_head_fusion": dual},
        ),
        graph=dataclasses.replace(cfg.graph, dense_adjacency_max_bytes=0),
    )


@pytest.fixture(scope="module")
def cohort():
    jcfg = _jax_config()
    bundle = make_synthetic_bundle(JaxSpec(**dataclasses.asdict(SPEC)), jcfg)
    cfg = Config.from_dict(jcfg.to_dict())
    graph = ensure_attn_plans(make_synthetic_graph(SPEC, cfg, device="cpu"), cfg)
    return dict(
        bundle=bundle, graph=graph,
        masker=EdgeMasker(graph, seed=4, slot_major_train=True, slot_major_min_rows=0),
        jmasker=JaxEdgeMasker(bundle.graph, seed=4, slot_major_train=True, slot_major_min_rows=0),
        variables={arch: init_model_variables(
            jax_build_model(_jax_config(arch), bundle.graph), bundle.graph, jax.random.PRNGKey(0)
        ) for arch in ("RGCN", "HGT")},
    )


def _port_model(cohort, jcfg):
    model = build_model(Config.from_dict(jcfg.to_dict()), cohort["graph"], device="cpu")
    model.load_state_dict(state_dict_from_flax(cohort["variables"][jcfg.model.architecture]), strict=True)
    return model


def _ratio(port, jax_bf16, jax_f32):
    port, a, b = (np.asarray(_np(v), np.float64).ravel() for v in (port, jax_bf16, jax_f32))
    diff, effect = np.linalg.norm(port - a), np.linalg.norm(a - b)
    return float(diff / effect) if effect else (0.0 if diff == 0 else np.inf)


def _jax_run(cohort, jcfg, batch):
    """JAX's predictions, loss and gradients (eval mode) on ``batch``, and
    its node state.  bfloat16 runs op by op: under ``jax.jit`` XLA on the
    CPU keeps bfloat16 values in float32 across fused ops, so the program's
    casts to bfloat16 do not all round there (the TPU, whose ops take
    bfloat16, rounds at each); float32 runs compiled."""
    run = (lambda f, *a: f(*a)) if jcfg.model.compute_dtype == "bfloat16" else (lambda f, *a: jax.jit(f)(*a))
    jmodel = jax_build_model(jcfg, cohort["bundle"].graph)
    graph, variables = cohort["bundle"].graph, cohort["variables"][jcfg.model.architecture]
    jdeg = jnp.take(graph.patient_lab_degree, batch.patient_idx)

    def loss(v):
        preds = jmodel.apply(
            v, graph, batch.patient_idx, batch.lab_idx, train=False, method=jmodel.predict_lab_values,
            patient_plan=batch.patient_plan, lab_plan=batch.lab_plan, degrees=jdeg,
        )
        return jnp.sum((preds.astype(jnp.float32) - batch.values) ** 2 * batch.valid), preds

    (value, preds), grads = run(jax.value_and_grad(loss, has_aux=True), variables)
    state = run(lambda v: jmodel.apply(v, graph, method=jmodel.compute_node_state), variables)
    return preds, value, state_dict_from_flax({"params": grads["params"]}), state


def _port_run(model, cohort, batch):
    preds = model.predict_lab_values(
        cohort["graph"], batch.patient_idx, batch.lab_idx, train=False, patient_plan=batch.patient_plan,
        lab_plan=batch.lab_plan, degrees=cohort["graph"].patient_lab_degree[batch.patient_idx.long()],
    )
    loss = (((preds.float() - batch.values) ** 2) * batch.valid).sum()
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return preds, loss, grads, compute_node_state(model, cohort["graph"])


def test_rgcn_bf16_matches_jax(cohort):
    """Eval mode, single fused heads (K4; the dual head, K5, in the train
    step below): predictions, loss, every gradient and the node state."""
    dual = "off"
    batch, jbatch = cohort["masker"].get_split("train"), cohort["jmasker"].get_split("train")
    model = _port_model(cohort, _jax_config(dual=dual))
    assert model.compute_dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in model.parameters())
    preds, loss, grads, state = _port_run(model, cohort, batch)
    jb = _jax_run(cohort, _jax_config(dual=dual), jbatch)
    jf = _jax_run(cohort, _jax_config(dtype="float32", dual=dual), jbatch)
    ratios = {"predictions": _ratio(preds, jb[0], jf[0]), "loss": _ratio(loss, jb[1], jf[1])}
    for key in ("init_p", "init_l", "final_p", "final_l"):
        assert state[key].dtype == (torch.bfloat16 if jb[3][key].dtype == BF else torch.float32), key
        ratios[f"state.{key}"] = _ratio(state[key], jb[3][key], jf[3][key])
    for name, grad in grads.items():
        assert grad.dtype == torch.float32, name
        ratios[f"grad.{name}"] = _ratio(grad, jb[2][name], jf[2][name])
    print(f"\nRGCN bf16, dual {dual}: largest ratios", sorted(ratios.items(), key=lambda kv: -kv[1])[:5])
    assert max(ratios.values()) <= RATIO, ratios


def _adam_first_moments(opt_state):
    """``mu`` of optax's Adam state: (1 - b1) times the step's gradient."""
    found = []

    def visit(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.append(node.mu)
        elif isinstance(node, (tuple, list)):
            for child in node:
                visit(child)
        elif hasattr(node, "inner_state"):
            visit(node.inner_state)

    visit(opt_state)
    assert len(found) == 1
    return found[0]


def _feeds_batch_norm(name):
    """A bias added right before a BatchNorm (the encoder's hidden layers,
    the convolutions' summed neighbor biases)."""
    return name.endswith(".bias") and (
        name.startswith("conv_") or name in ("patient_encoder.dense_0.bias", "patient_encoder.dense_1.bias")
    )


def test_rgcn_bf16_train_step_matches_jax(cohort):
    """One train step of JAX's ``Trainer`` (``_train_step_impl``: BatchNorm
    on batch statistics, the dual fused head K5, Adam) with one supervision
    mask: the loss and the step's gradient (Adam's first moment) by the
    ratio bound, the parameters after the step within ``2e-3`` (a
    near-zero gradient of the other sign moves a parameter by ``2 lr``)."""
    sup = (np.random.default_rng(0).random(cohort["masker"].get_split("train").valid.shape[0]) < 0.4)
    results = {}
    for dtype in ("bfloat16", "float32"):
        jcfg = _jax_config(dtype=dtype, dual="on")
        jtrainer = JaxTrainer(
            jax_build_model(jcfg, cohort["bundle"].graph), cohort["bundle"].graph, cohort["jmasker"], jcfg,
            variables=cohort["variables"]["RGCN"],
        )
        jbatch = jtrainer._get_batch("train")
        copy = lambda s: jax.tree_util.tree_map(jnp.array, s)  # noqa: E731 (donation)
        args = (copy(jtrainer.state), cohort["bundle"].graph, jbatch, jtrainer.lab_weights,
                jnp.asarray(sup.astype(np.float32)) * jbatch.valid, jax.random.key(7))
        # bfloat16 op by op (see _jax_run), float32 as the trainer compiles it
        jstate, jloss = jtrainer._train_step_impl(*args) if dtype == "bfloat16" else jtrainer._train_step(*args)
        results[dtype] = (
            float(jloss), state_dict_from_flax({"params": jstate.params}),
            state_dict_from_flax({"params": _adam_first_moments(jstate.opt_state)}),
        )
    model = _port_model(cohort, _jax_config(dual="on"))
    trainer = Trainer(model, cohort["graph"], cohort["masker"], Config.from_dict(_jax_config(dual="on").to_dict()),
                      device="cpu")
    batch = trainer.get_batch("train")
    loss = trainer.train_step(batch, torch.from_numpy(sup.astype(np.float32)) * batch.valid, 0)
    (lb, pb, mb), (lf, _, mf) = results["bfloat16"], results["float32"]
    assert _ratio(np.float32(loss), lb, lf) <= RATIO
    # each tensor's bound also allows 1e-6 of the step's largest gradient
    # (tests/test_torch_hgt.py's floor): a gradient both JAX runs share to the
    # bit leaves the port only its own float32 sums in another order
    largest = max(np.linalg.norm(m.numpy()) for m in mb.values())
    ratios = {}
    for name, value in model.named_parameters():
        got = trainer.optimizer.state[value]["exp_avg"].numpy()
        if _feeds_batch_norm(name):
            # 0 in exact arithmetic (BatchNorm on batch statistics takes out
            # a constant), so what each side holds is its bfloat16 rounding
            # noise: the port's no larger than twice JAX's
            assert np.linalg.norm(got) <= 2 * np.linalg.norm(mb[name].numpy()) + 1e-6 * largest, name
            continue
        diff, effect = np.linalg.norm(got - mb[name].numpy()), np.linalg.norm(mb[name].numpy() - mf[name].numpy())
        assert diff <= RATIO * effect + 1e-6 * largest, (name, diff, effect)
        if effect > 1e-6 * largest:
            ratios[name] = diff / effect
        np.testing.assert_allclose(value.detach().numpy(), pb[name].numpy(), atol=2e-3, err_msg=name)
    print("\nRGCN bf16 train step: largest gradient ratios", sorted(ratios.items(), key=lambda kv: -kv[1])[:5])


def test_hgt_bf16_is_its_f32_model(cohort):
    """JAX's HGT takes the compute dtype only in its value-context
    projections (``hgt.py:257-291``), so its bfloat16 model is its float32
    model; the port's bfloat16 HGT (flash tier, plain kernel versions) is
    its float32 HGT bit for bit, and agrees with JAX's (segment tier,
    compiled) within ``tests/test_torch_hgt.py``'s bounds."""
    batch, jbatch = cohort["masker"].get_split("train"), cohort["jmasker"].get_split("train")
    runs = [_port_run(_port_model(cohort, _jax_config("HGT", dtype)), cohort, batch)
            for dtype in ("bfloat16", "float32")]
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][0].dtype == torch.float32
    for name, grad in runs[0][2].items():
        assert torch.equal(grad, runs[1][2][name]), name
    for key, value in runs[0][3].items():
        assert torch.equal(value, runs[1][3][key]), key
    jb = _jax_run(cohort, _jax_config("HGT", "float32", use_pallas=False), jbatch)
    np.testing.assert_allclose(runs[0][0].detach().numpy(), _np(jb[0]), rtol=1e-4, atol=1e-4)
    for key in ("final_p", "final_l"):
        np.testing.assert_allclose(runs[0][3][key].numpy(), _np(jb[3][key]), rtol=1e-4, atol=1e-4)


def test_bf16_serving_path_answers_in_float32(cohort):
    model = _port_model(cohort, _jax_config(dual="on"))
    fn, state = build_serving_fn(model, cohort["graph"])
    p, l = np.arange(0, 600, 7), np.arange(0, 600, 7) % 40
    out = fn(p, l)
    assert out.dtype == torch.float32 and np.isfinite(out.numpy()).all()
    want = model.predict_pairs_cached(state, torch.from_numpy(p).long(), torch.from_numpy(l).long())
    assert torch.equal(out, want.float())


# -- the probe, the config and the refusals -----------------------------------


def _stats(median, lo=None):
    return {"ratio": median, "ratio_min": median if lo is None else lo, "ratio_max": median,
            "repeats": 3, "t_f32_ms": [], "t_bf16_ms": []}


def test_resolve_compute_dtype(monkeypatch):
    """JAX ``tests/test_mxu_probe.py::test_resolution_logic`` for the card."""
    assert mxu_probe.resolve_compute_dtype("float32") == "float32"
    assert mxu_probe.resolve_compute_dtype("bfloat16") == "bfloat16"

    def no_probe(*args, **kwargs):
        raise AssertionError("the probe must not run for the CPU")

    monkeypatch.setattr(mxu_probe, "probe_bf16_stats", no_probe)
    assert mxu_probe.resolve_compute_dtype("auto", device="cpu") == "float32"
    if not torch.cuda.is_available():
        assert mxu_probe.resolve_compute_dtype("auto") == "float32"
    for stats, want in ((_stats(0.98), "float32"), (_stats(3.7), "bfloat16"), (_stats(1.5, lo=1.1), "float32")):
        monkeypatch.setattr(mxu_probe, "probe_bf16_stats", lambda s=stats: s)
        assert mxu_probe.resolve_compute_dtype("auto", device="cuda") == want

    def boom():
        raise RuntimeError("no device")

    monkeypatch.setattr(mxu_probe, "probe_bf16_stats", boom)
    assert mxu_probe.resolve_compute_dtype("auto", device="cuda") == "float32"


def test_probe_cache_is_the_ports_own(monkeypatch, tmp_path):
    """Entries per device name in ``_build/mxu_probe.json`` (not the JAX
    package's ``.mxu_probe.json``), read back without probing."""
    assert mxu_probe.CACHE_PATH.parent.name == "_build"
    assert mxu_probe.CACHE_PATH.name != ".mxu_probe.json"
    path = tmp_path / "mxu_probe.json"
    path.write_text('{"Card": {"ratio": 2.0, "ratio_min": 1.9, "ratio_max": 2.1, "repeats": 3}}')
    monkeypatch.setattr(mxu_probe, "CACHE_PATH", path)
    monkeypatch.setattr(mxu_probe, "_memo", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "Card")
    monkeypatch.setattr(mxu_probe, "_time_matmul", lambda *a, **k: pytest.fail("probed"))
    assert mxu_probe.probe_bf16_speedup() == 2.0


def test_auto_routes_through_the_factory(monkeypatch, cohort):
    """JAX ``test_auto_routes_through_factory``: ``auto`` with a probe that
    clears the bar builds a bfloat16 model; on the CPU ``auto`` builds a
    float32 one without probing."""
    jcfg = _jax_config(dtype="auto")
    cfg = Config.from_dict(jcfg.to_dict())
    assert cfg.model.compute_dtype == "auto"
    monkeypatch.setattr(mxu_probe, "probe_bf16_stats", lambda: _stats(4.0))
    assert build_model(cfg, cohort["graph"], device="cpu").compute_dtype is None
    monkeypatch.setattr(mxu_probe, "resolve_compute_dtype", lambda configured, device=None: "bfloat16")
    assert build_model(cfg, cohort["graph"], device="cpu").compute_dtype == torch.bfloat16


def test_config_takes_jax_dtypes_and_hashes_them():
    for dtype in ("float32", "bfloat16", "auto"):
        d = JaxConfig().to_dict()
        d["model"]["compute_dtype"] = dtype
        cfg = Config.from_dict(d)
        assert cfg.to_dict() == JaxConfig.from_dict(d).to_dict()
        assert cfg.model_hash() == JaxConfig.from_dict(d).model_hash()
    with pytest.raises(ConfigError, match="float32\\|bfloat16\\|auto"):
        Config.from_dict({"model": {"compute_dtype": "float16"}})
    assert Config.from_dict({"model": {"compute_dtype": "bfloat16"}}).model_hash() != Config().model_hash()


@pytest.mark.parametrize(
    "section",
    [{"model": {"compute_dtype": "bfloat16"}, "train": {"extras": {"parallel": "gspmd"}}},
     {"model": {"compute_dtype": "float16", "extras": {"value_context": True}}}],
    ids=["parallel", "float16"],
)
def test_config_refuses_what_the_bf16_slice_does_not_run(section):
    """bfloat16 runs everything the float32 config runs on one card; what is
    refused stays refused (``gspmd``, queue 1 item 8c; other dtypes)."""
    with pytest.raises(ConfigError, match="queue 1 item 8|float32\\|bfloat16\\|auto"):
        Config.from_dict(section)


@pytest.mark.parametrize(
    "section",
    [{"model": {"compute_dtype": "bfloat16", "extras": {"value_context": True}}},
     {"model": {"compute_dtype": "bfloat16"}, "train": {"extras": {"num_clusters": 4}}}],
    ids=["value_context", "clusters"],
)
def test_config_takes_bf16_with(section):
    """Taken, and hashed as JAX hashes it (JAX runs both in bfloat16)."""
    cfg = Config.from_dict(section)
    assert cfg.model.compute_dtype == "bfloat16"
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    assert jcfg.to_dict() == cfg.to_dict() and jcfg.model_hash() == cfg.model_hash()


def test_bf16_clusters_and_serving_artifact_run(cohort, tmp_path):
    """A bfloat16 model trains in clusters and exports its serving
    artifact, which loads and answers in float32 (JAX's side of both:
    ``tests/test_torch_bf16_slice.py``)."""
    from multi_modal_gnn_tpu_torch.graph.build import GraphBundle, GraphMeta
    from multi_modal_gnn_tpu_torch.serving import ServingModel

    cfg = Config.from_dict(_jax_config().to_dict())
    model = _port_model(cohort, _jax_config())
    clusters = MiniBatchTrainer(model, cohort["graph"], cohort["masker"], cfg, num_clusters=2, device="cpu")
    losses, _ = clusters.train_epochs(1)
    assert np.isfinite(losses).all()
    trainer = Trainer(model, cohort["graph"], cohort["masker"], cfg, device="cpu")
    path = export_serving(trainer, GraphBundle(graph=cohort["graph"], meta=GraphMeta(), host_edges=None),
                          tmp_path / "serving", buckets=(128,))
    p, l = np.arange(0, 600, 7), np.arange(0, 600, 7) % 40
    got = ServingModel.load(path, device="cpu").predict(p, l)
    want = build_serving_fn(model, cohort["graph"])[0](p, l).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bf16_checkpoint_restores_into_float32_only_when_forced(cohort, tmp_path):
    """``model_hash`` covers ``compute_dtype`` (JAX hashes the whole model
    section, ``config.py:419-428``): a bfloat16 run's checkpoint is refused
    by a float32 run unless forced, and its parameters are float32 either
    way."""
    cfg_bf = Config.from_dict(_jax_config().to_dict())
    cfg_f32 = Config.from_dict(_jax_config(dtype="float32").to_dict())
    assert cfg_bf.model_hash() != cfg_f32.model_hash()
    trainer = Trainer(_port_model(cohort, _jax_config()), cohort["graph"], cohort["masker"], cfg_bf, device="cpu")
    trainer.train_epochs(1)
    trainer._save(tmp_path / "bf16.ckpt")
    live = Trainer(build_model(cfg_f32, cohort["graph"], device="cpu"), cohort["graph"], cohort["masker"], cfg_f32,
                   device="cpu")
    with pytest.raises(ValueError, match="model hash"):
        live.restore(tmp_path / "bf16.ckpt")
    live.restore(tmp_path / "bf16.ckpt", force=True)
    for (name, got), want in zip(live.model.state_dict().items(), trainer.model.state_dict().values()):
        assert got.dtype == want.dtype and torch.equal(got, want), name


def test_bf16_compute_path(cohort):
    """JAX ``tests/test_observability.py::test_bf16_compute_path``: bfloat16
    trains 3 finite epochs; the losses come back as float32."""
    jcfg = _jax_config()
    cfg = Config.from_dict(jcfg.to_dict())
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.2))
    trainer = Trainer(build_model(cfg, cohort["graph"], device="cpu"), cohort["graph"], cohort["masker"], cfg,
                      device="cpu")
    losses, val = trainer.train_epochs(3, with_val=True)
    assert losses.dtype == np.float32 and np.isfinite(losses).all() and np.isfinite(val).all()
    assert np.isfinite(trainer.predict("test")).all()


def test_bench_runs_bf16():
    result = bench.run_bench(epochs=1, bf16=True, device="cpu")
    assert result["compute_dtype"] == "bfloat16" and "mxu_bf16_speedup" not in result
    assert np.isfinite(result["final_train_loss"])
