"""Full-batch training: splits and supervision, schedulers, the trainer."""

from multi_modal_gnn_tpu_torch.training.masker import EdgeMasker, SplitBatch, masker_from_config
from multi_modal_gnn_tpu_torch.training.trainer import Trainer, build_optimizer

__all__ = ["EdgeMasker", "SplitBatch", "Trainer", "build_optimizer", "masker_from_config"]
