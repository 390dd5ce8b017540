"""Full-batch training with early stopping and a plateau learning rate
(``multi_modal_gnn_tpu/training/trainer.py``).

Each epoch is one step: draw the epoch's supervision mask, run the whole
graph forward with ``train=True`` through the dual degree-gated heads,
take the lab-weighted masked loss, backpropagate through the kernels'
backward passes, and take one Adam step.  The JAX package jits that step;
here it runs eagerly on the card.

Optimizer: ``torch.optim.Adam`` with ``weight_decay``, which adds
``weight_decay * param`` to the gradient before the moments: the coupled L2
of the JAX chain ``add_decayed_weights -> adam``.  ``embedding_weight_decay``
adds to it on the ``embed_*`` tables, as the JAX masked decay does.
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.graph.attn_plan import ensure_attn_plans
from multi_modal_gnn_tpu_torch.graph.hetero import HeteroGraph
from multi_modal_gnn_tpu_torch.graph.schema import LAB
from multi_modal_gnn_tpu_torch.models.losses import (
    compute_lab_weights,
    masked_mean_loss,
    weighted_regression_loss,
)
from multi_modal_gnn_tpu_torch.models.hgt import HeteroGT
from multi_modal_gnn_tpu_torch.models.rgcn import HeteroRGCN
from multi_modal_gnn_tpu_torch.training.masker import EdgeMasker, SplitBatch
from multi_modal_gnn_tpu_torch.training.schedulers import build_scheduler
from multi_modal_gnn_tpu_torch.utils.device import resolve_device
from multi_modal_gnn_tpu_torch.utils.rng import stream_seed

logger = logging.getLogger(__name__)


def build_optimizer(model: torch.nn.Module, train_config) -> torch.optim.Adam:
    """Adam with coupled L2 decay; ``embed_*`` tables get
    ``weight_decay + embedding_weight_decay``."""
    oc = train_config.optimizer
    embed, rest = [], []
    for name, param in model.named_parameters():
        (embed if name.startswith("embed_") else rest).append(param)
    groups = [{"params": rest, "weight_decay": oc.weight_decay}]
    if embed:
        groups.append(
            {"params": embed, "weight_decay": oc.weight_decay + oc.embedding_weight_decay}
        )
    return torch.optim.Adam(groups, lr=oc.lr, betas=(0.9, 0.999), eps=1e-8)


class Trainer:
    """Drives the train and eval steps over a static graph on ``device``
    (default: the card; raises without one).  The model and graph are moved
    there; an HGT on the kernel path gets the graph's attention plans
    (:func:`~multi_modal_gnn_tpu_torch.graph.attn_plan.ensure_attn_plans`)."""

    def __init__(
        self,
        model: Union[HeteroRGCN, HeteroGT],
        graph: HeteroGraph,
        masker: EdgeMasker,
        config: Config,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.graph = ensure_attn_plans(graph, config).to(self.device)
        self.masker = masker
        self.config = config
        tc = config.train
        self.optimizer = build_optimizer(self.model, tc)
        # every parameter gets a gradient, zero where the loss does not reach
        # it (the RGCN's last non-patient, non-lab BatchNorms; the HGT's last
        # groups into diagnosis and medication), so that Adam's coupled decay
        # moves it as the JAX chain does
        for param in self.model.parameters():
            param.grad = torch.zeros_like(param)

        # lab-wise inverse-variance loss weights from the train split;
        # train.extras.lab_reweighting: false gives uniform weights
        _, train_lab_idx, train_values = masker.split_arrays("train")
        if bool(tc.extras.get("lab_reweighting", True)):
            weights = compute_lab_weights(train_values, train_lab_idx, graph.num_nodes(LAB))
        else:
            weights = np.ones(graph.num_nodes(LAB), dtype=np.float32)
        self.lab_weights = torch.from_numpy(weights).to(self.device)
        self._batches: Dict[str, SplitBatch] = {}
        self._loss_type = tc.loss

        self.scheduler = build_scheduler(tc)
        self.best_val_loss = float("inf")
        self.patience_counter = 0
        self.epoch = 0
        self.history: Dict[str, list] = {"train_loss": [], "val_loss": [], "learning_rates": []}
        self.best_state: Optional[dict] = None

    # -- batches -----------------------------------------------------------

    def get_batch(self, split: str) -> SplitBatch:
        """The split's batch on the trainer's device, with the per-slot
        degrees and lab loss weights attached (once)."""
        if split not in self._batches:
            batch = self.masker.get_split(split).to(self.device)
            batch.degrees = self.graph.patient_lab_degree[batch.patient_idx.long()]
            batch.sample_weights = self.lab_weights[batch.lab_idx.long()]
            self._batches[split] = batch
        return self._batches[split]

    # -- steps -------------------------------------------------------------

    def train_step(self, batch: SplitBatch, sup_mask: torch.Tensor, dropout_seed: int) -> float:
        """One forward, weighted masked loss, backward and Adam step;
        returns the loss."""
        self.model.train()
        preds = self.model.predict_lab_values(
            self.graph, batch.patient_idx, batch.lab_idx, train=True,
            patient_plan=batch.patient_plan, lab_plan=batch.lab_plan, degrees=batch.degrees,
            dropout_seed=dropout_seed,
        )
        # lab-wise weights apply to mae / mse only, as in the reference
        if self._loss_type in ("mae", "mse"):
            weights = batch.sample_weights
        else:
            weights = torch.ones_like(batch.values)
        loss = weighted_regression_loss(preds, batch.values, weights, sup_mask, self._loss_type)
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        self.optimizer.step()
        return float(loss.detach())

    def train_epoch(self) -> float:
        batch = self.get_batch("train")
        sup_mask = self.masker.supervision_mask(self.epoch, batch)
        seed = stream_seed(self.config.train.seed, "dropout", self.epoch)
        return self.train_step(batch, sup_mask, seed)

    def eval_model(self, state: Optional[dict] = None) -> torch.nn.Module:
        """The model in eval mode with the parameters and buffers of
        ``state`` (a ``state_dict``), or the live model when ``state`` is
        None.  A state gets its own copy of the model, so the live
        parameters and the optimizer's state stay as they are."""
        if state is None:
            model = self.model
        else:
            model = copy.deepcopy(self.model)
            model.load_state_dict(state)
        return model.eval()

    def _eval_preds(self, batch: SplitBatch, state: Optional[dict] = None) -> torch.Tensor:
        model = self.eval_model(state)
        with torch.no_grad():
            return model.predict_lab_values(
                self.graph, batch.patient_idx, batch.lab_idx, train=False,
                patient_plan=batch.patient_plan, lab_plan=batch.lab_plan, degrees=batch.degrees,
            )

    def validate(self, split: str = "val", state: Optional[dict] = None) -> float:
        """The masked loss on ``split`` of the live model, or of ``state``
        (``best_state`` for the test loss, as JAX ``train_pipeline`` reports)."""
        batch = self.get_batch(split)
        preds = self._eval_preds(batch, state)
        return float(masked_mean_loss(preds, batch.values, batch.valid, self._loss_type))

    def predict(self, split: str, state: Optional[dict] = None) -> np.ndarray:
        """Unpadded predictions for a split, in split order (slot-major
        batches are inverted back to row order), of the live model or of
        ``state``."""
        batch = self.get_batch(split)
        preds = self._eval_preds(batch, state).cpu().numpy()
        slots = self.masker.slot_map(split)
        if slots is not None:
            preds = preds[slots]
        return preds[: batch.num_valid]

    # -- the loop ----------------------------------------------------------

    def fit(self) -> Dict:
        """Train for ``train.epochs`` epochs with the plateau scheduler and
        early stopping; keeps the best validation state in ``best_state``."""
        tc = self.config.train
        t_start = time.perf_counter()
        epoch_times = []
        while self.epoch < tc.epochs:
            t0 = time.perf_counter()
            train_loss = self.train_epoch()
            val_loss = self.validate("val")
            self.epoch += 1
            epoch_times.append(time.perf_counter() - t0)

            new_lr = self.scheduler.step(val_loss)
            self.history["train_loss"].append(train_loss)
            self.history["val_loss"].append(val_loss)
            self.history["learning_rates"].append(new_lr)
            if abs(new_lr - self.optimizer.param_groups[0]["lr"]) > 1e-12:
                logger.info("Epoch %d: reducing lr to %.2e", self.epoch, new_lr)
                for group in self.optimizer.param_groups:
                    group["lr"] = new_lr
            logger.info(
                "Epoch %3d | train %.4f | val %.4f | lr %.2e | %.3fs",
                self.epoch, train_loss, val_loss, new_lr, epoch_times[-1],
            )
            if val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                self.patience_counter = 0
                self.best_state = copy.deepcopy(self.model.state_dict())
            else:
                self.patience_counter += 1
                if self.patience_counter >= tc.early_stopping_patience:
                    logger.info("Early stopping at epoch %d", self.epoch)
                    break

        total_time = time.perf_counter() - t_start
        n_train = self.masker.split_sizes()["train"]
        self.history["total_time_s"] = total_time
        self.history["mean_epoch_time_s"] = float(np.mean(epoch_times)) if epoch_times else 0.0
        self.history["train_edges_per_sec"] = (
            n_train * len(epoch_times) / total_time if total_time > 0 else 0.0
        )
        return self.history
