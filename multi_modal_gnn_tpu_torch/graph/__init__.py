"""Graph representation, construction from tables, assembly, validation
and the ``graph.npz`` artifact."""

from multi_modal_gnn_tpu_torch.graph.build import (
    GraphBundle,
    GraphMeta,
    assemble_graph,
    build_graph_from_preprocessed,
    build_heterogeneous_graph,
)
from multi_modal_gnn_tpu_torch.graph.hetero import EdgeSet, HeteroGraph, pad_edge_set
from multi_modal_gnn_tpu_torch.graph.serialize import load_bundle, load_graph, save_graph

__all__ = [
    "EdgeSet", "GraphBundle", "GraphMeta", "HeteroGraph", "assemble_graph",
    "build_graph_from_preprocessed", "build_heterogeneous_graph", "load_bundle", "load_graph",
    "pad_edge_set", "save_graph",
]
