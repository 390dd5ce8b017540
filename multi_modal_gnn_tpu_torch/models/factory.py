"""Model factory (``multi_modal_gnn_tpu/models/factory.py``)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.graph.hetero import HeteroGraph
from multi_modal_gnn_tpu_torch.models.hgt import HeteroGT
from multi_modal_gnn_tpu_torch.models.rgcn import HeteroRGCN
from multi_modal_gnn_tpu_torch.utils import mxu_probe
from multi_modal_gnn_tpu_torch.utils.device import resolve_device

# head_style "auto": factored heads from this many patients up
FACTORED_HEAD_MIN_PATIENTS = 20_000
_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(config: Config, device=None) -> Optional[torch.dtype]:
    """The model's compute dtype (None: float32), as JAX
    ``factory.py:30-37`` resolves ``model.compute_dtype``: ``auto`` through
    the tensor-core probe (:func:`~multi_modal_gnn_tpu_torch.utils.mxu_probe.resolve_compute_dtype`;
    float32 on the CPU)."""
    name = mxu_probe.resolve_compute_dtype(config.model.compute_dtype, device)
    return _DTYPES.get(name)


def build_model(
    config: Config,
    graph: HeteroGraph,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> Union[HeteroRGCN, HeteroGT]:
    """The configured architecture sized to ``graph``, weights drawn from
    ``generator`` (on the CPU) and moved to ``device`` (default: the card;
    raises without one).  The config has already refused the ``context``
    bilinear source without ``value_context`` (JAX refuses it here).

    ``model.compute_dtype`` (:func:`compute_dtype`) goes to the RGCN, which
    computes in it end to end, the value context included.  The JAX HGT
    takes it only in its value-context projections (``hgt.py:285-291``): a
    bfloat16 HGT without value context is its float32 program, and with it
    only ``vctx_patient`` / ``vctx_lab`` compute in bfloat16, as JAX's do."""
    device = resolve_device(device)
    mc = config.model
    dtype = compute_dtype(config, device)
    impl = "pallas" if mc.use_pallas else "xla"
    common = dict(
        node_counts=graph.node_counts,
        edge_types=graph.edge_types,
        hidden_dim=mc.hidden_dim,
        num_layers=mc.num_layers,
        dropout=mc.dropout,
        head_hidden_dims=mc.edge_head.hidden_dims,
        impl=impl,
        bilinear_rank=mc.edge_head.bilinear_rank,
        bilinear_source=mc.edge_head.bilinear_source,
        value_context=mc.value_context,
        generator=generator,
        dtype=dtype,
    )
    if mc.architecture == "HGT":
        model = HeteroGT(
            **common, num_heads=mc.num_heads, dense_attn_max_bytes=mc.hgt_dense_attn_bytes
        )
        return model.to(device)
    head_style = mc.head_style
    if head_style == "auto":
        num_patients = graph.node_count_map.get("patient", 0)
        head_style = "factored" if num_patients >= FACTORED_HEAD_MIN_PATIENTS else "concat"
    model = HeteroRGCN(
        **common,
        activation=mc.activation,
        use_batch_norm=mc.use_batch_norm,
        aggregation=mc.aggregation,
        degree_threshold=mc.degree_threshold,
        head_style=head_style,
        dual_head_fusion=mc.dual_head_fusion,
    )
    return model.to(device)
