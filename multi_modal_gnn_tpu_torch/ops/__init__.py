"""Neighbor aggregation, HGT flash attention, and their CUDA kernels."""

from multi_modal_gnn_tpu_torch.ops.segment import (
    aggregate_neighbors,
    aggregation_tier,
    gather_rows,
    segment_mean,
    segment_sum,
)

__all__ = ["aggregate_neighbors", "aggregation_tier", "gather_rows", "segment_mean", "segment_sum"]
