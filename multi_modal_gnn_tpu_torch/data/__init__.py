"""Synthetic cohort generation."""

from multi_modal_gnn_tpu_torch.data.synthetic import (
    SyntheticSpec,
    generate_synthetic_edges,
    make_synthetic_graph,
)

__all__ = ["SyntheticSpec", "generate_synthetic_edges", "make_synthetic_graph"]
