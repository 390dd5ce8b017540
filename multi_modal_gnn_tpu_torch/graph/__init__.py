"""Graph representation, assembly and artifact loading."""

from multi_modal_gnn_tpu_torch.graph.build import assemble_graph
from multi_modal_gnn_tpu_torch.graph.hetero import EdgeSet, HeteroGraph, pad_edge_set
from multi_modal_gnn_tpu_torch.graph.serialize import load_graph

__all__ = ["EdgeSet", "HeteroGraph", "assemble_graph", "load_graph", "pad_edge_set"]
