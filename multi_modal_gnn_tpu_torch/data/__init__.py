"""Synthetic cohort generation, the raw eICU and MIMIC-III loaders
(:mod:`.eicu`, :mod:`.mimic`) and the preprocess stage."""

from multi_modal_gnn_tpu_torch.data.synthetic import (
    SyntheticLatents,
    SyntheticSpec,
    generate_synthetic_edges,
    generate_synthetic_tables,
    make_synthetic_graph,
    spec_from_config,
)

__all__ = [
    "SyntheticLatents", "SyntheticSpec", "generate_synthetic_edges", "generate_synthetic_tables",
    "make_synthetic_graph", "spec_from_config",
]
