"""Graph assembly from COO arrays (``multi_modal_gnn_tpu/graph/build.py``
``assemble_graph``): every relation is padded, sorted and planned, then
mirrored by its reverse relation; ``patient_lab_degree`` counts each
patient's lab edges."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.graph.hetero import EdgeSet, HeteroGraph, pad_edge_set
from multi_modal_gnn_tpu_torch.graph.schema import (
    PATIENT,
    PATIENT_LAB,
    EdgeTypeKey,
    reverse_edge_type,
)


def assemble_graph(
    edge_arrays: Dict[EdgeTypeKey, tuple],
    node_counts: Dict[str, int],
    config: Optional[Config] = None,
) -> HeteroGraph:
    """``edge_arrays[et] = (src, dst, val_or_None)`` per forward relation,
    node indices in ``[0, node_counts[type])``.  The graph lives on the CPU;
    move it with ``.to(device)``."""
    gc = (config or Config()).graph
    edges: Dict[EdgeTypeKey, EdgeSet] = {}
    for et, (src, dst, val) in edge_arrays.items():
        s_type, _, d_type = et
        common = dict(
            pad_multiple=gc.edge_pad_multiple,
            dense_max_bytes=gc.dense_adjacency_max_bytes,
            src_span_rows=gc.src_span_rows,
        )
        edges[et] = pad_edge_set(
            src, dst, num_src=node_counts[s_type], num_dst=node_counts[d_type],
            val=val, **common,
        )
        edges[reverse_edge_type(et)] = pad_edge_set(
            dst, src, num_src=node_counts[d_type], num_dst=node_counts[s_type],
            **common,
        )
    pl_src = np.asarray(edge_arrays[PATIENT_LAB][0], dtype=np.int64)
    degree = np.bincount(pl_src, minlength=node_counts[PATIENT]).astype(np.int32)
    return HeteroGraph(
        edges=edges,
        patient_lab_degree=torch.from_numpy(degree),
        node_counts=tuple(sorted(node_counts.items())),
    )
