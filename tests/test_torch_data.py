"""PyTorch port: the flat synthetic generator reproduces the JAX one.

The JAX bundle re-indexes nodes while building the graph (patients by lab
degree, labs by frequency, diagnoses and medications in first-seen order),
so its ``host_edges`` are mapped back through the bundle's indexers to the
generator's own ids before the comparison, which is exact.  The port's
``make_synthetic_graph`` numbers the nodes the same way, and its graph must
equal the JAX bundle's graph field for field.
"""

import dataclasses

import numpy as np
import pytest

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.graph.schema import (
    DIAGNOSIS,
    LAB,
    MEDICATION,
    PATIENT,
    PATIENT_DIAGNOSIS,
    PATIENT_LAB,
    PATIENT_MEDICATION,
)
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_edges, make_synthetic_graph
from multi_modal_gnn_tpu_torch.graph.build import assemble_graph
from test_torch_plans import assert_graphs_equal

# entity id -> generator index, per node type (data/synthetic.py id formats)
_TO_INDEX = {
    PATIENT: lambda i: int(i) - 100000,
    LAB: lambda i: int(i) - 51000,
    DIAGNOSIS: lambda code: int(code) - 250,
    MEDICATION: lambda name: int(str(name).split("_")[1]),
}


def _to_generator_ids(bundle, node_type, idx):
    table = np.array([_TO_INDEX[node_type](e) for e in bundle.meta.indexers[node_type].index_to_id])
    return table[np.asarray(idx)]


def _sorted_triples(src, dst, val):
    cols = [np.asarray(src, np.int64), np.asarray(dst, np.int64)]
    order = np.lexsort(cols[::-1])
    out = [c[order] for c in cols]
    return out + ([np.asarray(val)[order]] if val is not None else [])


@pytest.mark.parametrize("seed", [0, 1])
def test_generator_reproduces_jax_host_edges(config, seed):
    bundle = make_synthetic_bundle(JaxSpec.tiny(seed), config)
    edge_arrays, node_counts = generate_synthetic_edges(SyntheticSpec.tiny(seed))
    for et in (PATIENT_LAB, PATIENT_DIAGNOSIS, PATIENT_MEDICATION):
        src_t, _, dst_t = et
        h_src, h_dst, h_val = bundle.host_edges[et]
        want = _sorted_triples(
            _to_generator_ids(bundle, src_t, h_src), _to_generator_ids(bundle, dst_t, h_dst), h_val
        )
        got = _sorted_triples(*edge_arrays[et])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # every id the JAX bundle indexed lies inside the port's node ranges
    for nt, n in node_counts.items():
        assert len(bundle.meta.indexers[nt]) <= n


def test_scale_preset_matches_jax():
    ours, theirs = SyntheticSpec.scale_100k(), JaxSpec.scale_100k()
    for name in SyntheticSpec.__dataclass_fields__:
        assert getattr(ours, name) == getattr(theirs, name), name


def _sparse_spec(seed):
    """Few draws over many items: labs, diagnoses and medications that never
    occur, and lab frequencies that tie."""
    return SyntheticSpec(
        num_patients=40, num_labs=60, num_diagnoses=50, num_medications=45,
        mean_labs_per_patient=2.0, mean_diagnoses_per_patient=1.0,
        mean_medications_per_patient=1.0, latent_dim=4, seed=seed,
    )


def _flags(by_degree, by_frequency):
    cfg = JaxConfig()
    return cfg.replace(
        graph=dataclasses.replace(
            cfg.graph, cluster_patients_by_degree=by_degree, cluster_labs_by_frequency=by_frequency
        )
    )


@pytest.mark.parametrize(
    "spec", [SyntheticSpec.tiny(0), SyntheticSpec.tiny(1), _sparse_spec(2)], ids=["tiny0", "tiny1", "sparse"]
)
@pytest.mark.parametrize("flags", [(True, True), (True, False), (False, True)], ids=["both", "degree", "frequency"])
def test_graph_numbering_equals_jax_bundle(spec, flags):
    jcfg = _flags(*flags)
    bundle = make_synthetic_bundle(JaxSpec(**dataclasses.asdict(spec)), jcfg)
    graph = make_synthetic_graph(spec, Config.from_dict(jcfg.to_dict()), device="cpu")
    assert_graphs_equal(graph, bundle.graph)
    if spec.seed == 2:  # entities that never occur are no nodes, in both packages
        counts = graph.node_count_map
        assert counts["lab"] < spec.num_labs and counts["diagnosis"] < spec.num_diagnoses
        freq = np.bincount(generate_synthetic_edges(spec)[0][PATIENT_LAB][1])
        assert len(np.unique(freq[freq > 0])) < counts["lab"]  # frequencies tie


def test_flags_off_keep_the_generator_order():
    cfg = Config.from_dict(_flags(False, False).to_dict())
    graph = make_synthetic_graph(SyntheticSpec.tiny(0), cfg, device="cpu")
    want = assemble_graph(*generate_synthetic_edges(SyntheticSpec.tiny(0)), cfg)
    assert graph.node_counts == want.node_counts
    for et, es in want.edges.items():
        for name in ("src", "dst", "win_src", "win_local"):
            np.testing.assert_array_equal(getattr(graph.edges[et], name).numpy(), getattr(es, name).numpy())
