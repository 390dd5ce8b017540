"""Graph validation and statistics (``multi_modal_gnn_tpu/graph/stats.py``)."""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np

from multi_modal_gnn_tpu_torch.graph.hetero import HeteroGraph
from multi_modal_gnn_tpu_torch.graph.schema import PATIENT, PATIENT_LAB

logger = logging.getLogger(__name__)


class GraphValidationError(ValueError):
    pass


def validate_graph(graph: HeteroGraph) -> None:
    """Bounds, shape and consistency checks on every relation's padded
    arrays: valid rows in range and dst-sorted, padding rows at the dummy
    segment ``num_dst``, a CSR ``row_ptr`` that ends at ``num_valid``."""
    counts = graph.node_count_map
    for et, es in graph.edges.items():
        s_type, _, d_type = et
        if es.num_src != counts[s_type]:
            raise GraphValidationError(f"{et}: num_src {es.num_src} != {counts[s_type]}")
        if es.num_dst != counts[d_type]:
            raise GraphValidationError(f"{et}: num_dst {es.num_dst} != {counts[d_type]}")
        src, dst = es.src.cpu().numpy(), es.dst.cpu().numpy()
        mask = es.mask.cpu().numpy() > 0
        if src.shape != dst.shape or src.shape != mask.shape:
            raise GraphValidationError(f"{et}: padded array shape mismatch")
        if int(mask.sum()) != es.num_valid:
            raise GraphValidationError(f"{et}: mask count {int(mask.sum())} != num_valid {es.num_valid}")
        if es.num_valid:
            if src[mask].min() < 0 or src[mask].max() >= es.num_src:
                raise GraphValidationError(f"{et}: src index out of bounds")
            if dst[mask].min() < 0 or dst[mask].max() >= es.num_dst:
                raise GraphValidationError(f"{et}: dst index out of bounds")
            if not np.all(np.diff(dst[mask]) >= 0):
                raise GraphValidationError(f"{et}: valid dst indices not sorted")
        if (~mask).any() and not np.all(dst[~mask] == es.num_dst):
            raise GraphValidationError(f"{et}: padding dst must equal num_dst")
        row_ptr = es.row_ptr.cpu().numpy()
        if row_ptr.shape[0] != es.num_dst + 1 or row_ptr[-1] != es.num_valid:
            raise GraphValidationError(f"{et}: CSR row_ptr inconsistent")
        if es.val is not None and tuple(es.val.shape) != src.shape:
            raise GraphValidationError(f"{et}: val shape mismatch")
    logger.info("Graph validation passed (%d relations)", len(graph.edges))


def compute_graph_statistics(graph: HeteroGraph) -> Dict:
    """Node and edge counts, per-relation patient-degree stats and the
    patient-lab density."""
    counts = graph.node_count_map
    stats: Dict = {
        "num_nodes": dict(counts),
        "num_edges": {"__".join(et): es.num_valid for et, es in graph.edges.items()},
        "padded_edges": {"__".join(et): int(es.src.shape[0]) for et, es in graph.edges.items()},
    }
    num_patients = counts.get(PATIENT, 0)
    degree_stats = {}
    for et, es in graph.edges.items():
        if et[0] != PATIENT or es.num_valid == 0:
            continue
        deg = np.bincount(es.src[: es.num_valid].cpu().numpy(), minlength=num_patients)
        degree_stats["__".join(et)] = {
            "mean": float(deg.mean()),
            "std": float(deg.std()),
            "min": int(deg.min()),
            "max": int(deg.max()),
            "isolated": int((deg == 0).sum()),
        }
    stats["patient_degree"] = degree_stats
    pl = graph.edges.get(PATIENT_LAB)
    if pl is not None and num_patients and pl.num_dst:
        stats["patient_lab_density"] = pl.num_valid / (num_patients * pl.num_dst)
    return stats
