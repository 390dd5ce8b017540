"""PyTorch port: host plan builders, graph assembly, the graph.npz reader and
the config bridge, held equal to the JAX package.

Plans are integer layouts, so every comparison here is exact: the port's
numpy copies must give the same arrays as ``multi_modal_gnn_tpu.graph``
(which may take its native library or its numpy path; both are
bit-identical by the JAX package's own tests).  Cases follow
``tests/test_pallas_segment.py`` and ``tests/test_span_dma.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.graph import build as jax_build
from multi_modal_gnn_tpu.graph import hetero as jax_hetero
from multi_modal_gnn_tpu.graph.serialize import load_graph as jax_load_graph
from multi_modal_gnn_tpu.graph.serialize import save_graph as jax_save_graph
from multi_modal_gnn_tpu_torch import config as port_config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_edges
from multi_modal_gnn_tpu_torch.graph import hetero as port_hetero
from multi_modal_gnn_tpu_torch.graph.build import assemble_graph, build_heterogeneous_graph
from multi_modal_gnn_tpu_torch.graph.serialize import load_graph

_ARRAYS = (
    "src", "dst", "mask", "val", "dst_count", "row_ptr", "win_src", "win_local",
    "win_tile_map", "dense_adj", "span_src", "span_local", "span_tile_map", "span_base",
)
_SCALARS = ("num_valid", "num_src", "num_dst", "num_windows", "span_rows")


def assert_edge_sets_equal(port_es, jax_es):
    for name in _ARRAYS:
        got, want = getattr(port_es, name), getattr(jax_es, name)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    for name in _SCALARS:
        assert getattr(port_es, name) == getattr(jax_es, name), name


def assert_graphs_equal(port_g, jax_g):
    assert port_g.node_counts == jax_g.node_counts
    assert port_g.edge_types == jax_g.edge_types
    np.testing.assert_array_equal(
        port_g.patient_lab_degree.numpy(), np.asarray(jax_g.patient_lab_degree)
    )
    for et in jax_g.edge_types:
        assert_edge_sets_equal(port_g.edges[et], jax_g.edges[et])


def _span_case(seed=0, num_src=4096 + 900, num_dst=300, num_edges=80_000):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, num_src, size=num_edges).astype(np.int32),
        rng.integers(0, num_dst, size=num_edges).astype(np.int32),
        num_src,
        num_dst,
    )


def _duplicate_case():
    rng = np.random.default_rng(5)
    src = np.repeat(rng.integers(0, 4996, size=3_000).astype(np.int32), 8)
    dst = np.repeat(rng.integers(0, 64, size=3_000).astype(np.int32), 8)
    return src, dst, 4996, 64


def _sparse_case():
    # one edge per destination over 40k sources: the inflation guard refuses
    rng = np.random.default_rng(3)
    src = rng.integers(0, 40_000, size=20_000).astype(np.int32)
    return src, np.arange(20_000, dtype=np.int32), 40_000, 20_000


def _small_case(num_src=50, num_dst=300, e=2000):
    rng = np.random.default_rng(0)
    src = rng.integers(0, num_src, e).astype(np.int32)
    dst = rng.integers(0, num_dst, e).astype(np.int32)
    return src, dst, num_src, num_dst


@pytest.mark.parametrize(
    "case, kwargs",
    [
        (_span_case(), dict(src_span_rows=256)),
        (_duplicate_case(), dict(src_span_rows=256)),
        (_sparse_case(), dict(src_span_rows=64)),
        (_span_case(num_src=512, num_edges=4_000), dict(src_span_rows=256)),
        (_small_case(), dict(pad_multiple=512, dense_max_bytes=1 << 20)),
        (_small_case(10, 10, 50), dict(pad_multiple=512)),
    ],
    ids=["span", "duplicates", "inflation_guard", "small_src_no_plan", "dense", "tiny"],
)
def test_pad_edge_set_matches_jax(case, kwargs):
    src, dst, num_src, num_dst = case
    val = np.random.default_rng(1).standard_normal(len(src)).astype(np.float32)
    port_es = port_hetero.pad_edge_set(src, dst, num_src, num_dst, val=val, **kwargs)
    jax_es = jax_hetero.pad_edge_set(src, dst, num_src, num_dst, val=val, **kwargs)
    assert_edge_sets_equal(port_es, jax_es)


def test_plan_gates_engage():
    span_es = port_hetero.pad_edge_set(*_span_case(), src_span_rows=256)
    assert span_es.span_rows == 256
    assert port_hetero.pad_edge_set(*_sparse_case(), src_span_rows=64).span_rows == 0
    dense_es = port_hetero.pad_edge_set(*_small_case(), dense_max_bytes=1 << 20)
    assert dense_es.dense_adj is not None


@pytest.mark.parametrize("num_dst", [256, 300, 1])
def test_window_plan_matches_jax(num_dst):
    rng = np.random.default_rng(num_dst)
    src = rng.integers(0, 50, 2000).astype(np.int32)
    dst = np.sort(rng.integers(0, min(num_dst, 128), 2000)).astype(np.int32)
    got = port_hetero.build_window_plan(src, dst, num_dst)
    want = jax_hetero.build_window_plan(src, dst, num_dst)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_span_packer_matches_jax_numpy_packer():
    src, dst, num_src, num_dst = _span_case(seed=7)
    es = jax_hetero.pad_edge_set(src, dst, num_src, num_dst)
    args = (np.asarray(es.win_local), np.asarray(es.win_tile_map), np.asarray(es.win_src), num_src, 256)
    got = port_hetero.regroup_slots_by_lab_span(*args)
    want = jax_hetero._regroup_slots_by_lab_span_numpy(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _small_cohort():
    return SyntheticSpec(
        num_patients=4500, num_labs=50, num_diagnoses=100, num_medications=80,
        mean_labs_per_patient=30.0, mean_diagnoses_per_patient=2.0,
        mean_medications_per_patient=3.0, latent_dim=4, seed=3,
    )


def _jax_config(dense_bytes):
    cfg = JaxConfig()
    return cfg.replace(graph=dataclasses.replace(cfg.graph, dense_adjacency_max_bytes=dense_bytes))


@pytest.mark.parametrize("dense_bytes", [0, 268_435_456], ids=["span", "dense"])
def test_assemble_graph_matches_jax(dense_bytes):
    edge_arrays, node_counts = generate_synthetic_edges(_small_cohort())
    jax_cfg = _jax_config(dense_bytes)
    want = jax_build.assemble_graph(edge_arrays, node_counts, config=jax_cfg)
    got = assemble_graph(edge_arrays, node_counts, port_config.Config.from_dict(jax_cfg.to_dict()))
    assert_graphs_equal(got, want)


@pytest.mark.parametrize("dense_bytes", [0, 268_435_456], ids=["span", "dense"])
def test_load_graph_matches_jax(tmp_path, dense_bytes):
    from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
    from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle

    bundle = make_synthetic_bundle(
        JaxSpec(**dataclasses.asdict(_small_cohort())), _jax_config(dense_bytes)
    )
    path = jax_save_graph(bundle, tmp_path / "graph")
    want = jax_load_graph(path).graph
    got = load_graph(path, device="cpu")
    assert_graphs_equal(got, want)
    if dense_bytes == 0:
        assert any(es.span_rows for es in got.edges.values())


def test_graph_moves_to_device():
    edge_arrays, node_counts = generate_synthetic_edges(SyntheticSpec.tiny())
    g = assemble_graph(edge_arrays, node_counts).to("meta")
    assert g.patient_lab_degree.device.type == "meta"
    for es in g.edges.values():
        assert es.win_src.device.type == "meta" and es.win_src.dtype == torch.int32
        assert es.dense_adj is None or es.dense_adj.device.type == "meta"


def test_config_accepts_jax_to_dict():
    cfg = port_config.Config.from_dict(JaxConfig().to_dict())
    assert cfg == port_config.Config()
    jax_cfg = JaxConfig()
    jax_cfg = jax_cfg.replace(
        model=dataclasses.replace(
            jax_cfg.model, hidden_dim=32, use_pallas=True, extras={"head_style": "factored"},
            edge_head=dataclasses.replace(jax_cfg.model.edge_head, hidden_dims=(16, 8)),
        ),
        graph=dataclasses.replace(jax_cfg.graph, dense_adjacency_max_bytes=0, src_span_rows=128),
    )
    cfg = port_config.Config.from_dict(jax_cfg.to_dict())
    assert (cfg.model.hidden_dim, cfg.model.use_pallas, cfg.model.head_style) == (32, True, "factored")
    assert cfg.model.edge_head.hidden_dims == (16, 8)
    assert (cfg.graph.dense_adjacency_max_bytes, cfg.graph.src_span_rows) == (0, 128)


@pytest.mark.parametrize(
    "model",
    [
        {"architecture": "GAT"},
        {"compute_dtype": "float16"},
        {"compute_dtype": "half"},  # bfloat16 with value context runs (tests/test_torch_bf16.py)
        {"edge_head": {"bilinear_rank": 4, "bilinear_source": "context"}},
        {"edge_head": {"bilinear_rank": 4, "bilinear_source": "hidden"}},
        {"unknown_knob": 1},
        {"architecture": "HGT", "edge_head": {"bilinear_rank": 4, "bilinear_source": "context"}},
        {"architecture": "HGT", "edge_head": {"extras": {"bilinear_rank": 4}}},
        {"architecture": "HGT", "num_heads": 3},
        {"architecture": "HGT", "extras": {"hgt_flash": "always"}},
    ],
)
def test_config_rejects_unsupported(model):
    with pytest.raises(port_config.ConfigError):
        port_config.Config.from_dict({"model": model})


@pytest.mark.parametrize(
    "model",
    [
        {"value_context": True},
        {"edge_head": {"bilinear_rank": 4}},
        {"architecture": "HGT", "value_context": True},
        {"architecture": "HGT", "edge_head": {"bilinear_rank": 4}},
    ],
)
def test_config_takes_the_quality_channels(model):
    """The four settings the port refused before the value-context slice
    load, and write JAX's dict and model hash."""
    d = JaxConfig().to_dict()
    d["model"].update({k: v for k, v in model.items() if k != "edge_head"})
    d["model"]["edge_head"].update(model.get("edge_head", {}))
    cfg, jax_cfg = port_config.Config.from_dict(d), JaxConfig.from_dict(d)
    assert cfg.to_dict() == jax_cfg.to_dict()
    assert cfg.model_hash() == jax_cfg.model_hash()
    assert cfg.model.value_context == bool(model.get("value_context"))
    assert cfg.model.edge_head.bilinear_rank == model.get("edge_head", {}).get("bilinear_rank", 0)


def test_config_reads_the_jax_hgt_settings():
    jax_cfg = JaxConfig()
    jax_cfg = jax_cfg.replace(
        model=dataclasses.replace(
            jax_cfg.model, architecture="HGT", num_heads=8,
            extras={"hgt_flash": "off", "hgt_dense_attn_bytes": 0},
        ),
        graph=dataclasses.replace(jax_cfg.graph, cluster_labs_by_frequency=False),
    )
    cfg = port_config.Config.from_dict(jax_cfg.to_dict())
    assert (cfg.model.architecture, cfg.model.num_heads) == ("HGT", 8)
    assert (cfg.model.hgt_flash, cfg.model.hgt_dense_attn_bytes) == ("off", 0)
    assert (cfg.graph.cluster_patients_by_degree, cfg.graph.cluster_labs_by_frequency) == (True, False)


def test_config_rejects_one_way_relations():
    """One-way and disabled relations are taken as JAX takes them; only a
    disabled ``patient_lab`` is refused, at the graph build, as in JAX."""
    raw = JaxConfig().to_dict()
    raw["graph"]["edge_types"]["patient_lab"]["bidirectional"] = False
    raw["graph"]["edge_types"]["patient_diagnosis"]["enabled"] = False
    jax_cfg = JaxConfig.from_dict(raw)
    cfg = port_config.Config.from_dict(raw)
    assert cfg.to_dict() == jax_cfg.to_dict()
    assert (cfg.content_hash(), cfg.model_hash()) == (jax_cfg.content_hash(), jax_cfg.model_hash())
    edge_arrays, node_counts = generate_synthetic_edges(SyntheticSpec.tiny())
    graph = assemble_graph(edge_arrays, node_counts, cfg)
    assert set(graph.edge_types) == set(jax_build.assemble_graph(edge_arrays, node_counts, config=jax_cfg).edge_types)
    off = port_config.Config.from_dict({"graph": {"edge_types": {"patient_lab": {"enabled": False}}}})
    tables = {"SUBJECT_ID": np.arange(3), "ITEMID": np.arange(3), "VALUE_NORMALIZED": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="patient_lab"):
        build_heterogeneous_graph(tables, None, None, {"SUBJECT_ID": np.arange(3)}, None, off)
