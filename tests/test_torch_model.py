"""PyTorch port: the flax weight bridge, and the whole serving slice against
the JAX package.

The slice runs on one graph (4,500 patients, dense budget 0) on which the
fused-table, span and paired tiers all engage.  JAX ``compute_node_state``
(Pallas kernels in interpret mode) + ``predict_pairs_cached`` and the port's
(plain kernel versions on the CPU) share the weights through the bridge and
are held to ``rtol=atol=1e-4`` (f32 throughout; TF32 plays no part on the
CPU).  Batch statistics are drawn with numpy so eval-mode BatchNorm is not
the identity.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.graph.build import assemble_graph as jax_assemble
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.models.factory import init_model_variables
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_edges
from multi_modal_gnn_tpu_torch.graph.build import assemble_graph
from multi_modal_gnn_tpu_torch.graph.schema import mirror_edge_type
from multi_modal_gnn_tpu_torch.models import build_model, state_dict_from_flax
from multi_modal_gnn_tpu_torch.ops import aggregation_tier
from multi_modal_gnn_tpu_torch.serving import build_serving_fn, compute_node_state, predict_patient

TOL = dict(rtol=1e-4, atol=1e-4)
HEAD_STYLES = ("factored", "concat")


def _jax_config(head_style, use_pallas=True, dense_bytes=0):
    cfg = JaxConfig()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, hidden_dim=32, use_pallas=use_pallas, extras={"head_style": head_style},
            edge_head=dataclasses.replace(cfg.model.edge_head, hidden_dims=(16, 8)),
        ),
        graph=dataclasses.replace(cfg.graph, dense_adjacency_max_bytes=dense_bytes),
    )


def _perturb_batch_stats(variables, seed=0):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "mean":
            return rng.normal(0.0, 0.1, shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(draw, variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _jax_variables(model, graph, seed=0):
    # params do not depend on the aggregation backend: init through the XLA
    # path, which compiles faster than the interpret-mode Pallas one
    return _perturb_batch_stats(init_model_variables(model, graph, jax.random.PRNGKey(seed)))


def test_bridge_loads_strict(tiny_bundle):
    for head_style in HEAD_STYLES:
        cfg = _jax_config(head_style, use_pallas=False, dense_bytes=268_435_456)
        jax_model = jax_build_model(cfg, tiny_bundle.graph)
        variables = _jax_variables(jax_model, tiny_bundle.graph)
        edge_arrays = {et: tuple(tiny_bundle.host_edges[et]) for et in tiny_bundle.host_edges}
        graph = assemble_graph(edge_arrays, dict(tiny_bundle.graph.node_counts), Config.from_dict(cfg.to_dict()))
        model = build_model(Config.from_dict(cfg.to_dict()), graph, device="cpu")
        sd = state_dict_from_flax(variables)
        result = model.load_state_dict(sd, strict=True)
        assert not result.missing_keys and not result.unexpected_keys
        n_flax = sum(np.size(x) for x in jax.tree_util.tree_leaves(variables))
        n_bn = sum(1 for k in sd if k.endswith("num_batches_tracked"))
        assert sum(v.numel() for v in model.state_dict().values()) == n_flax + n_bn
        np.testing.assert_array_equal(
            model.conv_0.get_submodule("neigh_patient__has_lab__lab").weight.detach().numpy(),
            np.asarray(variables["params"]["conv_0"]["neigh_patient__has_lab__lab"]["kernel"]).T,
        )


@pytest.fixture(scope="module")
def slice_case():
    spec = SyntheticSpec(
        num_patients=4500, num_labs=50, num_diagnoses=100, num_medications=80,
        mean_labs_per_patient=30.0, mean_diagnoses_per_patient=2.0,
        mean_medications_per_patient=3.0, latent_dim=4, seed=3,
    )
    edge_arrays, node_counts = generate_synthetic_edges(spec)
    cfg = {s: _jax_config(s) for s in HEAD_STYLES}
    jax_graph = jax_assemble(edge_arrays, node_counts, config=cfg["factored"])
    graph = assemble_graph(edge_arrays, node_counts, Config.from_dict(cfg["factored"].to_dict()))
    variables = {
        s: _jax_variables(jax_build_model(_jax_config(s, use_pallas=False), jax_graph), jax_graph)
        for s in HEAD_STYLES
    }
    # one node state serves both head styles: give the concat variables the
    # factored ones' non-head params, so the two share it
    heads = ("edge_predictor", "tabular_mlp")
    variables["concat"] = {
        "params": {
            k: (variables["concat"] if k in heads else variables["factored"])["params"][k]
            for k in variables["factored"]["params"]
        },
        "batch_stats": variables["factored"]["batch_stats"],
    }
    jax_models = {s: jax_build_model(cfg[s], jax_graph) for s in HEAD_STYLES}
    m = jax_models["factored"]
    jax_state = jax.jit(lambda v: m.apply(v, jax_graph, method=m.compute_node_state))(
        variables["factored"]
    )
    rng = np.random.default_rng(0)
    p = rng.integers(0, node_counts["patient"], 2048).astype(np.int32)
    l = rng.integers(0, node_counts["lab"], 2048).astype(np.int32)
    return dict(
        graph=graph, cfg=cfg, variables=variables, jax_models=jax_models,
        jax_state=jax_state, p=p, l=l,
    )


def test_slice_engages_every_kernel_tier(slice_case):
    graph = slice_case["graph"]
    tiers = {
        aggregation_tier(es, graph.edges.get(mirror_edge_type(et)), 32)
        for et, es in graph.edges.items()
    }
    assert tiers == {"fused_table", "span", "paired"}


@pytest.mark.parametrize("head_style", HEAD_STYLES)
def test_slice_matches_jax(slice_case, head_style):
    graph, variables = slice_case["graph"], slice_case["variables"][head_style]
    model = build_model(Config.from_dict(slice_case["cfg"][head_style].to_dict()), graph, device="cpu")
    assert model.head_style == head_style
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    state = compute_node_state(model, graph)
    jax_state = slice_case["jax_state"]
    for key in ("init_p", "init_l", "final_p", "final_l", "degree"):
        np.testing.assert_allclose(state[key].numpy(), np.asarray(jax_state[key]), **TOL, err_msg=key)

    jm = slice_case["jax_models"][head_style]
    p, l = slice_case["p"], slice_case["l"]
    want = np.asarray(jm.apply(variables, jax_state, p, l, method=jm.predict_pairs_cached))
    fn, _ = build_serving_fn(model, graph, state)
    np.testing.assert_allclose(fn(p, l).numpy(), want, **TOL)
    # the cached path equals the full eval-mode forward
    with torch.no_grad():
        full = model.predict_lab_values(graph, torch.from_numpy(p).long(), torch.from_numpy(l).long())
    np.testing.assert_allclose(full.numpy(), fn(p, l).numpy(), rtol=1e-6, atol=1e-6)
    # one patient, every lab
    np.testing.assert_allclose(
        predict_patient(fn, int(p[0]), 50).numpy(),
        np.asarray(jm.apply(variables, jax_state, np.full(50, p[0], np.int32),
                            np.arange(50, dtype=np.int32), method=jm.predict_pairs_cached)),
        **TOL,
    )


def test_serving_rejects_bad_requests(slice_case):
    graph = slice_case["graph"]
    model = build_model(Config.from_dict(slice_case["cfg"]["factored"].to_dict()), graph, device="cpu")
    fn, _ = build_serving_fn(model, graph)
    with pytest.raises(IndexError):
        fn([graph.num_nodes("patient")], [0])
    with pytest.raises(ValueError):
        fn([0, 1], [0])
    model.train()
    with pytest.raises(RuntimeError):
        model.compute_node_state(graph)
