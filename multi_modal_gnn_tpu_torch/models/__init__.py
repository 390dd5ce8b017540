"""The RGCN and HGT models, their factory and the flax weight bridge."""

from multi_modal_gnn_tpu_torch.models.convert import state_dict_from_flax
from multi_modal_gnn_tpu_torch.models.factory import build_model
from multi_modal_gnn_tpu_torch.models.hgt import HeteroGT, HGTLayer
from multi_modal_gnn_tpu_torch.models.rgcn import HeteroRGCN, HeteroSAGELayer

__all__ = [
    "HGTLayer", "HeteroGT", "HeteroRGCN", "HeteroSAGELayer", "build_model", "state_dict_from_flax",
]
