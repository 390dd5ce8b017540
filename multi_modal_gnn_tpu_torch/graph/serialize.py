"""Reader for the JAX package's graph artifact (``graph.npz`` +
``graph.meta.json``, written by ``multi_modal_gnn_tpu/graph/serialize.py``
``save_graph``), with numpy and json only.

The artifact stores each relation's padded COO + CSR arrays; the windowed,
dense and span plans are derived, so they are re-derived here under the
budgets recorded in the artifact's config, exactly as the JAX ``load_graph``
does.  A graph built by the JAX package thus loads into the port, with the
lab names its sidecar records."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.graph.hetero import (
    SPAN_MIN_SRC,
    EdgeSet,
    HeteroGraph,
    _tensor,
    build_dense_adjacency,
    build_src_span_plan,
    build_window_plan,
)
from multi_modal_gnn_tpu_torch.graph.schema import EdgeTypeKey
from multi_modal_gnn_tpu_torch.utils.device import resolve_device

_SEP = "||"


def load_graph(path, device=None) -> HeteroGraph:
    """Load ``<path>.npz`` + ``<path>.meta.json`` onto ``device`` (default:
    the card; raises without one)."""
    device = resolve_device(device)
    path = Path(path)
    if path.suffix == ".npz":
        path = path.with_suffix("")
    sidecar = json.loads(path.with_suffix(".meta.json").read_text())
    graph_cfg = (sidecar.get("meta", {}).get("config") or {}).get("graph", {})
    dense_budget = int(graph_cfg.get("dense_adjacency_max_bytes", 268_435_456))
    span_rows = int(graph_cfg.get("src_span_rows", 256))
    edges: Dict[EdgeTypeKey, EdgeSet] = {}
    with np.load(path.with_suffix(".npz")) as data:
        for entry in sidecar["edges"]:
            et = tuple(entry["edge_type"])
            key = _SEP.join(et)
            n_valid = int(entry["num_valid"])
            num_src, num_dst = int(entry["num_src"]), int(entry["num_dst"])
            src_host = data[f"{key}{_SEP}src"][:n_valid].astype(np.int32)
            dst_host = data[f"{key}{_SEP}dst"][:n_valid].astype(np.int32)
            dst_count = data[f"{key}{_SEP}dst_count"]
            win_src, win_local, win_tile_map, num_windows = build_window_plan(
                src_host, dst_host, num_dst
            )
            dense = build_dense_adjacency(
                src_host, dst_host, num_src, num_dst, dst_count, dense_budget
            )
            span = None
            if span_rows and dense is None and num_src >= SPAN_MIN_SRC and n_valid:
                span = build_src_span_plan(win_src, win_local, win_tile_map, num_src, span_rows)
            edges[et] = EdgeSet(
                src=_tensor(data[f"{key}{_SEP}src"]),
                dst=_tensor(data[f"{key}{_SEP}dst"]),
                mask=_tensor(data[f"{key}{_SEP}mask"]),
                val=_tensor(data[f"{key}{_SEP}val"]) if entry["has_val"] else None,
                dst_count=_tensor(dst_count),
                row_ptr=_tensor(data[f"{key}{_SEP}row_ptr"]),
                win_src=_tensor(win_src),
                win_local=_tensor(win_local),
                win_tile_map=_tensor(win_tile_map),
                dense_adj=_tensor(dense),
                span_src=_tensor(span[0]) if span is not None else None,
                span_local=_tensor(span[1]) if span is not None else None,
                span_tile_map=_tensor(span[2]) if span is not None else None,
                span_base=_tensor(span[3]) if span is not None else None,
                num_valid=n_valid,
                num_src=num_src,
                num_dst=num_dst,
                num_windows=num_windows,
                span_rows=span_rows if span is not None else 0,
            )
        degree = torch.from_numpy(np.ascontiguousarray(data["patient_lab_degree"]))
    return HeteroGraph(
        edges=edges,
        patient_lab_degree=degree,
        node_counts=tuple(sorted(sidecar["node_counts"].items())),
        lab_names={int(k): v for k, v in (sidecar.get("meta", {}).get("lab_names") or {}).items()},
    ).to(device)
