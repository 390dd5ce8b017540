"""Model factory (``multi_modal_gnn_tpu/models/factory.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.graph.hetero import HeteroGraph
from multi_modal_gnn_tpu_torch.models.rgcn import HeteroRGCN
from multi_modal_gnn_tpu_torch.utils.device import resolve_device

# head_style "auto": factored heads from this many patients up
FACTORED_HEAD_MIN_PATIENTS = 20_000


def build_model(
    config: Config,
    graph: HeteroGraph,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> HeteroRGCN:
    """RGCN sized to ``graph``, weights drawn from ``generator`` (on the
    CPU) and moved to ``device`` (default: the card; raises without one)."""
    device = resolve_device(device)
    mc = config.model
    head_style = mc.head_style
    if head_style == "auto":
        num_patients = graph.node_count_map.get("patient", 0)
        head_style = "factored" if num_patients >= FACTORED_HEAD_MIN_PATIENTS else "concat"
    model = HeteroRGCN(
        node_counts=graph.node_counts,
        edge_types=graph.edge_types,
        hidden_dim=mc.hidden_dim,
        num_layers=mc.num_layers,
        dropout=mc.dropout,
        activation=mc.activation,
        use_batch_norm=mc.use_batch_norm,
        aggregation=mc.aggregation,
        head_hidden_dims=mc.edge_head.hidden_dims,
        degree_threshold=mc.degree_threshold,
        impl="pallas" if mc.use_pallas else "xla",
        head_style=head_style,
        generator=generator,
    )
    return model.to(device)
