"""Graph assembly from COO arrays (``multi_modal_gnn_tpu/graph/build.py``).

:func:`number_nodes` numbers the nodes as the JAX package's graph build does;
:func:`assemble_graph` pads, sorts and plans every relation, then mirrors it
by its reverse relation; ``patient_lab_degree`` counts each patient's lab
edges."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.graph.hetero import EdgeSet, HeteroGraph, pad_edge_set
from multi_modal_gnn_tpu_torch.graph.schema import (
    DIAGNOSIS,
    LAB,
    MEDICATION,
    PATIENT,
    PATIENT_DIAGNOSIS,
    PATIENT_LAB,
    PATIENT_MEDICATION,
    EdgeTypeKey,
    reverse_edge_type,
)


def _first_seen(ids: np.ndarray) -> np.ndarray:
    """The distinct values of ``ids`` in the order they first appear."""
    values, first = np.unique(ids, return_index=True)
    return values[np.argsort(first, kind="stable")]


def number_nodes(
    edge_arrays: Dict[EdgeTypeKey, tuple],
    node_counts: Dict[str, int],
    by_degree: bool = True,
    by_frequency: bool = True,
) -> Tuple[Dict[EdgeTypeKey, tuple], Dict[str, int]]:
    """Renumber the nodes of generator-ordered COO arrays as the JAX graph
    build does (``build_heterogeneous_graph``, ``graph/build.py:140-170``),
    keeping every relation's row order:

    * patients: the whole cohort, by ascending lab degree when
      ``by_degree`` (a stable sort: ties keep the cohort's order), else in
      cohort order;
    * labs: only labs that occur, by descending frequency when
      ``by_frequency`` (pandas' stable ``value_counts``: ties keep first-seen
      order), else in first-seen order;
    * diagnoses and medications: those that occur, in first-seen order.

    Node counts shrink to the entities that occur, as the JAX indexers'."""
    p_idx, l_idx, val = edge_arrays[PATIENT_LAB]
    num_p = node_counts[PATIENT]
    p_order = (
        np.argsort(np.bincount(p_idx, minlength=num_p), kind="stable")
        if by_degree else np.arange(num_p)
    )
    l_order = _first_seen(l_idx)
    if by_frequency:
        freq = np.bincount(l_idx, minlength=node_counts[LAB])[l_order]
        l_order = l_order[np.argsort(-freq, kind="stable")]
    orders = {PATIENT: p_order, LAB: l_order}
    for et, nt in ((PATIENT_DIAGNOSIS, DIAGNOSIS), (PATIENT_MEDICATION, MEDICATION)):
        orders[nt] = _first_seen(edge_arrays[et][1])
    new_ids = {}
    for nt, order in orders.items():
        new_ids[nt] = np.full(node_counts[nt], -1, np.int64)
        new_ids[nt][order] = np.arange(len(order))
    out = {
        et: (new_ids[et[0]][src], new_ids[et[2]][dst], v)
        for et, (src, dst, v) in edge_arrays.items()
    }
    return out, {nt: len(order) for nt, order in orders.items()}


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
