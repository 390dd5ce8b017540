"""Full-batch training: splits and supervision, schedulers, the trainer,
checkpoints."""

from multi_modal_gnn_tpu_torch.training.checkpoint import (
    load_checkpoint,
    load_flax_checkpoint,
    save_checkpoint,
)
from multi_modal_gnn_tpu_torch.training.masker import EdgeMasker, SplitBatch, masker_from_config
from multi_modal_gnn_tpu_torch.training.trainer import Trainer, build_optimizer, train_pipeline

__all__ = [
    "EdgeMasker", "SplitBatch", "Trainer", "build_optimizer", "load_checkpoint",
    "load_flax_checkpoint", "masker_from_config", "save_checkpoint", "train_pipeline",
]
