"""The RGCN model, its factory and the flax weight bridge."""

from multi_modal_gnn_tpu_torch.models.convert import state_dict_from_flax
from multi_modal_gnn_tpu_torch.models.factory import build_model
from multi_modal_gnn_tpu_torch.models.rgcn import HeteroRGCN, HeteroSAGELayer

__all__ = ["HeteroRGCN", "HeteroSAGELayer", "build_model", "state_dict_from_flax"]
