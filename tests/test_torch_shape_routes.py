"""PyTorch port: a shape that a CUDA kernel refuses goes to another tier, and
the choice is made from shapes before any launch.

* K3 stages at most ``SPAN_MAX_ROWS`` span rows: the span tier is taken only
  for such plans, taller spans take the paired tier (K1), where the JAX
  kernel stages any height.
* K6-K8 take ``h <= 128`` in heads of ``4 * 2^n`` columns
  (``attention_kernels.heads_supported``, the predicate the wrappers check):
  other HGT widths take the segment tier, where JAX's flash kernels take
  any width.
* K4 / K5 are compiled for the (64, 32) pair head: other widths take the
  unfused heads, single or dual, where JAX's kernels take any widths.

For each: the dispatch picks a kernel only for shapes its checks take, and
the rerouted configuration matches the JAX package on the CPU at a small
size (the port's wrappers run their plain versions on the CPU).
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
from multi_modal_gnn_tpu.graph.build import assemble_graph as jax_assemble
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.models.factory import init_model_variables
from multi_modal_gnn_tpu.ops.segment import aggregate_neighbors as jax_aggregate
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxEdgeMasker
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_edges, make_synthetic_graph
from multi_modal_gnn_tpu_torch.graph import hetero
from multi_modal_gnn_tpu_torch.graph.attn_plan import ensure_attn_plans
from multi_modal_gnn_tpu_torch.graph.build import assemble_graph
from multi_modal_gnn_tpu_torch.models import build_model, layers, rgcn, state_dict_from_flax
from multi_modal_gnn_tpu_torch.ops import aggregate_neighbors, aggregation_tier
from multi_modal_gnn_tpu_torch.ops import attention_kernels as ak
from multi_modal_gnn_tpu_torch.ops import pairhead_kernels as pk
from multi_modal_gnn_tpu_torch.ops import segment_kernels as sk
from multi_modal_gnn_tpu_torch.training import EdgeMasker

# -- the span tier (K3) ---------------------------------------------------------

NUM_SRC, NUM_DST, D = 4996, 300, 16


def _span_edges(span_rows):
    rng = np.random.default_rng(span_rows)
    src, dst = rng.integers(0, NUM_SRC, 80_000), rng.integers(0, NUM_DST, 80_000)
    port = (
        hetero.pad_edge_set(src, dst, NUM_SRC, NUM_DST, src_span_rows=span_rows),
        hetero.pad_edge_set(dst, src, NUM_DST, NUM_SRC),
    )
    jax_fwd = jax_hetero.pad_edge_set(src, dst, NUM_SRC, NUM_DST, src_span_rows=span_rows)
    return port, jax_fwd


@pytest.mark.parametrize("span_rows", [256, 512, 1024, 2048])
def test_span_tier_only_for_spans_k3_stages(span_rows):
    (fwd, rev), _ = _span_edges(span_rows)
    assert fwd.span_rows == span_rows  # the plan is built at any height
    tier = aggregation_tier(fwd, rev, D)
    assert tier == ("span" if span_rows <= sk.SPAN_MAX_ROWS else "paired")
    assert sk.SPAN_MAX_ROWS == sk._MMA_MAX_K  # the wrapper's own limit


@pytest.mark.parametrize("span_rows", [512, 1024])
def test_tall_spans_match_jax(span_rows):
    (fwd, rev), jax_fwd = _span_edges(span_rows)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(NUM_SRC, D)).astype(np.float32)
    g = rng.normal(size=(NUM_DST, D)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = aggregate_neighbors(xt, fwd, "mean", impl="pallas", edges_rev=rev)
    (out * torch.from_numpy(g)).sum().backward()

    def jloss(xj):
        agg = jax_aggregate(xj, jax_fwd, "mean", impl="xla")
        return jnp.sum(agg * g), agg

    (_, want), want_grad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-5)


# -- the HGT flash tier (K6-K8) -----------------------------------------------

HGT_SPEC = dict(
    num_patients=300, num_labs=20, num_diagnoses=15, num_medications=10,
    mean_labs_per_patient=6.0, mean_diagnoses_per_patient=2.0,
    mean_medications_per_patient=2.0, latent_dim=4, seed=2,
)


@pytest.mark.parametrize(
    "h,heads,kernels",
    [(32, 4, True), (128, 4, True), (64, 2, True), (256, 4, False), (48, 4, False), (40, 4, False)],
)
def test_hgt_tier_follows_the_kernels_widths(h, heads, kernels):
    assert ak.heads_supported(h, heads) == kernels
    if kernels:
        ak._check_heads("K6", h, heads)
    else:
        with pytest.raises(ValueError):
            ak._check_heads("K6", h, heads)
    cfg = Config.from_dict({
        "model": {"architecture": "HGT", "hidden_dim": h, "num_heads": heads, "use_pallas": True},
        "graph": {"dense_adjacency_max_bytes": 0},
    })
    graph = ensure_attn_plans(make_synthetic_graph(SyntheticSpec(**HGT_SPEC), cfg, device="cpu"), cfg)
    assert graph.attn_plans  # the flash tier's plans exist either way
    model = build_model(cfg, graph, device="cpu")
    tiers = {model.hgt_0.tier(graph, nt) for nt in model.hgt_0.groups()}
    assert tiers == ({"flash"} if kernels else {"segment"})


def test_hgt_at_a_width_the_kernels_refuse_matches_jax():
    """hidden 48 in 4 heads of 12 columns: the port's kernel path runs the
    segment tier; the same weights in the JAX package agree."""
    jcfg = JaxConfig()
    jcfg = jcfg.replace(
        model=dataclasses.replace(
            jcfg.model, architecture="HGT", hidden_dim=48, num_heads=4, dropout=0.0, use_pallas=False,
            edge_head=dataclasses.replace(jcfg.model.edge_head, hidden_dims=(16, 8)),
        ),
        graph=dataclasses.replace(jcfg.graph, dense_adjacency_max_bytes=0),
    )
    bundle = make_synthetic_bundle(JaxSpec(**HGT_SPEC), jcfg)
    jmodel = jax_build_model(jcfg, bundle.graph)
    variables = init_model_variables(jmodel, bundle.graph, jax.random.PRNGKey(0))
    want = jax.jit(lambda v, g: jmodel.apply(v, g, method=jmodel.compute_node_state))(variables, bundle.graph)
    cfg = Config.from_dict(jcfg.to_dict())
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_pallas=True))
    graph = ensure_attn_plans(make_synthetic_graph(SyntheticSpec(**HGT_SPEC), cfg, device="cpu"), cfg)
    model = build_model(cfg, graph, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert {model.hgt_0.tier(graph, nt) for nt in model.hgt_0.groups()} == {"segment"}
    model.eval()
    ak.reset_launch_counts()
    with torch.no_grad():
        got = model.compute_node_state(graph)
    for key in ("final_p", "final_l"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-4, atol=1e-4, err_msg=key)


# -- the fused pair heads (K4, K5) ---------------------------------------------


class _Took(Exception):
    pass


def _rgcn_cohort(head_dims, mode):
    spec = SyntheticSpec(**HGT_SPEC)
    edge_arrays, node_counts = generate_synthetic_edges(spec)
    jcfg = JaxConfig()
    jcfg = jcfg.replace(
        model=dataclasses.replace(
            jcfg.model, hidden_dim=32, dropout=0.0, use_pallas=True,
            edge_head=dataclasses.replace(jcfg.model.edge_head, hidden_dims=head_dims),
            extras={"head_style": "factored", "dual_head_fusion": mode},
        ),
        graph=dataclasses.replace(jcfg.graph, dense_adjacency_max_bytes=0),
    )
    jax_graph = jax_assemble(edge_arrays, node_counts, config=jcfg)
    cfg = Config.from_dict(jcfg.to_dict())
    graph = assemble_graph(edge_arrays, node_counts, cfg)
    jmodel = jax_build_model(jcfg, jax_graph)
    variables = init_model_variables(jmodel, jax_graph, jax.random.PRNGKey(0))
    model = build_model(cfg, graph, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    masker = EdgeMasker(graph, seed=4, slot_major_train=True, slot_major_min_rows=0)
    jmasker = JaxEdgeMasker(jax_graph, seed=4, slot_major_train=True, slot_major_min_rows=0)
    return model, graph, masker, jmodel, jax_graph, jmasker, variables


@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("head_dims,fused", [((64, 32), True), ((32, 16), False), ((64, 16), False)])
def test_fused_heads_only_at_the_kernels_widths(monkeypatch, head_dims, fused, mode):
    model, graph, masker, *_ = _rgcn_cohort(head_dims, mode)
    assert model.edge_predictor.fused_widths() == fused == pk.head_widths_supported(head_dims)

    def took(path):
        def stub(*args, **kwargs):
            raise _Took(path)
        return stub

    monkeypatch.setattr(layers, "fused_pair_head", took("single"))
    monkeypatch.setattr(rgcn, "fused_pair_head_dual", took("dual"))
    batch = masker.get_split("train")
    assert batch.patient_plan.identity
    run = lambda: model.predict_lab_values(  # noqa: E731
        graph, batch.patient_idx, batch.lab_idx, train=False, patient_plan=batch.patient_plan,
        lab_plan=batch.lab_plan, degrees=graph.patient_lab_degree[batch.patient_idx.long()],
    )
    if fused:
        with pytest.raises(_Took) as path:
            run()
        assert str(path.value) == ("dual" if mode == "on" else "single")
    else:
        assert torch.isfinite(run()).all()  # the unfused heads, no kernel


@pytest.mark.parametrize("mode", ["off", "on"])
def test_heads_at_other_widths_match_jax(mode):
    """A (32, 16) factored head on a slot-major batch: the port's unfused
    heads against JAX's fused kernels (interpret mode), predictions and
    every gradient."""
    model, graph, masker, jmodel, jax_graph, jmasker, variables = _rgcn_cohort((32, 16), mode)
    batch, jbatch = masker.get_split("train"), jmasker.get_split("train")
    degrees = graph.patient_lab_degree[batch.patient_idx.long()]
    pk.reset_launch_counts()
    preds = model.predict_lab_values(
        graph, batch.patient_idx, batch.lab_idx, train=False, patient_plan=batch.patient_plan,
        lab_plan=batch.lab_plan, degrees=degrees,
    )
    assert not any(pk.launch_counts.values())
    (((preds - batch.values) ** 2) * batch.valid).sum().backward()
    jdeg = jnp.take(jax_graph.patient_lab_degree, jbatch.patient_idx)

    def jloss(v):
        p = jmodel.apply(
            v, jax_graph, jbatch.patient_idx, jbatch.lab_idx, train=False, method=jmodel.predict_lab_values,
            patient_plan=jbatch.patient_plan, lab_plan=jbatch.lab_plan, degrees=jdeg,
        )
        return jnp.sum((p - jbatch.values) ** 2 * jbatch.valid), p

    (_, jpreds), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables)
    # padding slots: JAX's kernel writes 0 there, the unfused heads a value
    # that no loss reads; the real slots must agree
    valid = batch.valid.numpy() > 0
    np.testing.assert_allclose(preds.detach().numpy()[valid], np.asarray(jpreds)[valid], atol=1e-4)
    want = state_dict_from_flax({"params": jgrads["params"]})
    for name, p in model.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=1e-4, err_msg=name)
