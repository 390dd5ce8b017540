"""Synthetic cohort generation and the preprocess stage."""

from multi_modal_gnn_tpu_torch.data.synthetic import (
    SyntheticSpec,
    generate_synthetic_edges,
    generate_synthetic_tables,
    make_synthetic_graph,
    spec_from_config,
)

__all__ = [
    "SyntheticSpec", "generate_synthetic_edges", "generate_synthetic_tables",
    "make_synthetic_graph", "spec_from_config",
]
