"""PyTorch port: the flat synthetic generator reproduces the JAX one.

The JAX bundle re-indexes nodes while building the graph (patients by lab
degree, labs by frequency, diagnoses and medications in first-seen order),
so its ``host_edges`` are mapped back through the bundle's indexers to the
generator's own ids before the comparison, which is exact.
"""

import numpy as np
import pytest

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
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_edges

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
