"""Training: splits and supervision, schedulers, the full-batch trainer and
the Cluster-GCN mini-batch trainer, checkpoints, the ALS / side-information
warm start."""

from multi_modal_gnn_tpu_torch.training.checkpoint import (
    load_checkpoint,
    load_flax_checkpoint,
    save_checkpoint,
)
from multi_modal_gnn_tpu_torch.training.masker import EdgeMasker, SplitBatch, masker_from_config
from multi_modal_gnn_tpu_torch.training.trainer import Trainer, build_optimizer, train_pipeline
from multi_modal_gnn_tpu_torch.training.minibatch import MiniBatchTrainer, build_patient_clusters
from multi_modal_gnn_tpu_torch.training.warmstart import (
    als_warm_start_params,
    bundle_membership_matrix,
    sideinfo_warm_start_params,
    warm_start_from_config,
    warm_start_trainer,
)

__all__ = [
    "EdgeMasker", "MiniBatchTrainer", "SplitBatch", "Trainer", "als_warm_start_params",
    "build_optimizer", "build_patient_clusters", "bundle_membership_matrix", "load_checkpoint", "load_flax_checkpoint", "masker_from_config",
    "save_checkpoint", "sideinfo_warm_start_params", "train_pipeline", "warm_start_from_config",
    "warm_start_trainer",
]
