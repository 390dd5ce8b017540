"""PyTorch port: gradients of the kernel aggregation tiers against the JAX
package's ``custom_vjp``s.

The graph is ``tests/test_torch_model.py``'s (4,500 patients, dense budget
0), on which every kernel tier engages: ``fused_table`` (K2f forward, K2b
backward) for the lab / diagnosis / medication -> patient relations,
``span`` (K3 forward, K1 over the mirror plan backward) for patient -> lab
and ``paired`` (K1 both ways) for patient -> diagnosis / medication.  JAX
runs its Pallas kernels in interpret mode; the port's wrappers take their
plain versions on the CPU.  ``jax.grad`` and torch autograd of
``sum(aggregate(x) * G)`` agree to ``rtol=atol=1e-5``: f32 sums of at most a
few hundred terms of magnitude ~1 in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.graph.build import assemble_graph as jax_assemble
from multi_modal_gnn_tpu.ops import pallas_segment as jps
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_edges
from multi_modal_gnn_tpu_torch.graph.build import assemble_graph
from multi_modal_gnn_tpu_torch.graph.schema import mirror_edge_type
from multi_modal_gnn_tpu_torch.ops import aggregate_neighbors, aggregation_tier

D = 32
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def graphs():
    spec = SyntheticSpec(
        num_patients=4500, num_labs=50, num_diagnoses=100, num_medications=80,
        mean_labs_per_patient=30.0, mean_diagnoses_per_patient=2.0,
        mean_medications_per_patient=3.0, latent_dim=4, seed=3,
    )
    edge_arrays, node_counts = generate_synthetic_edges(spec)
    cfg = JaxConfig()
    cfg = cfg.replace(graph=dataclasses.replace(cfg.graph, dense_adjacency_max_bytes=0))
    return (
        assemble_graph(edge_arrays, node_counts, Config.from_dict(cfg.to_dict())),
        jax_assemble(edge_arrays, node_counts, config=cfg),
    )


_JAX_TIER = {
    "fused_table": lambda x, es, rev: jps.fused_table_aggregate(x, es, "mean", interpret=True),
    "span": lambda x, es, rev: jps.span_dma_aggregate(x, es, rev, "mean", interpret=True),
    "paired": lambda x, es, rev: jps.gather_segment_aggregate_paired(
        x, es, rev, "mean", interpret=True
    ),
}


def _relations(graph, tier):
    return [
        et for et, es in graph.edges.items()
        if aggregation_tier(es, graph.edges.get(mirror_edge_type(et)), D) == tier
    ]


@pytest.mark.parametrize("tier", ["fused_table", "span", "paired"])
def test_tier_gradient_matches_jax(graphs, tier):
    graph, jax_graph = graphs
    relations = _relations(graph, tier)
    assert relations, f"no relation takes the {tier} tier"
    for i, et in enumerate(relations):
        es, rev = graph.edges[et], graph.edges[mirror_edge_type(et)]
        jes, jrev = jax_graph.edges[et], jax_graph.edges[mirror_edge_type(et)]
        rng = np.random.default_rng(i)
        x = rng.standard_normal((es.num_src, D)).astype(np.float32)
        g = rng.standard_normal((es.num_dst, D)).astype(np.float32)
        fn = _JAX_TIER[tier]
        want_out = fn(jnp.asarray(x), jes, jrev)
        want = jax.grad(lambda a: jnp.sum(fn(a, jes, jrev) * g))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        out = aggregate_neighbors(xt, es, "mean", impl="pallas", edges_rev=rev)
        (out * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL, err_msg=str(et))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL, err_msg=str(et))


@pytest.mark.parametrize("aggregation", ["mean", "sum"])
def test_windowed_tier_gradient_matches_autograd_of_the_segment_path(graphs, aggregation):
    """Without a mirror plan the windowed tier's backward gathers the
    gradient rows back to the slots; it equals autograd through the
    index_add_ segment path."""
    graph, _ = graphs
    et = _relations(graph, "paired")[0]
    es = graph.edges[et]
    assert aggregation_tier(es, None, D) == "windowed"
    x = np.random.default_rng(7).standard_normal((es.num_src, D)).astype(np.float32)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal((es.num_dst, D)).astype(np.float32))
    grads = []
    for impl in ("pallas", "xla"):
        xt = torch.from_numpy(x).requires_grad_()
        (aggregate_neighbors(xt, es, aggregation, impl=impl) * g).sum().backward()
        grads.append(xt.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], **TOL)


def test_take_with_plan_gradient(graphs):
    """A row gather whose backward is K1 over a GatherPlan equals the plain
    gather's autograd, for a row-major plan and for an identity plan."""
    from multi_modal_gnn_tpu_torch.graph.hetero import WINDOW, build_gather_plan
    from multi_modal_gnn_tpu_torch.ops.segment import take_with_plan

    rng = np.random.default_rng(9)
    idx = rng.integers(0, 700, 5000).astype(np.int32)
    x = torch.from_numpy(rng.standard_normal((700, D)).astype(np.float32))
    plan = build_gather_plan(idx, 700)
    # identity: the batch laid out in the plan's slot order
    real = plan.win_local < WINDOW
    slot_idx = torch.where(real, torch.from_numpy(idx)[plan.win_src.long()], 0)
    identity = dataclasses.replace(plan, identity=True)
    for index, p in ((torch.from_numpy(idx), plan), (slot_idx, identity)):
        g = torch.from_numpy(rng.standard_normal((index.shape[0], D)).astype(np.float32))
        if p.identity:
            g = g * real[:, None]
        xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
        (take_with_plan(xa, index, p) * g).sum().backward()
        (xb[index.long()] * g).sum().backward()
        np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), **TOL)
