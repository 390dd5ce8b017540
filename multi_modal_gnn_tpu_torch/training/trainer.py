"""Full-batch training with early stopping, a plateau learning rate,
checkpoints and resume (``multi_modal_gnn_tpu/training/trainer.py``).

Each epoch is one step: draw the epoch's supervision mask, run the whole
graph forward with ``train=True`` through the dual degree-gated heads,
take the lab-weighted masked loss, backpropagate through the kernels'
backward passes, and take one Adam step.  The JAX package jits that step;
here it runs eagerly on the card.  :meth:`Trainer.train_epochs` runs k
epochs back to back with no host readback between them, the counterpart
of the JAX ``train_epochs_scanned``.

Optimizer: ``torch.optim.Adam`` with ``weight_decay``, which adds
``weight_decay * param`` to the gradient before the moments: the coupled L2
of the JAX chain ``add_decayed_weights -> adam``.  ``embedding_weight_decay``
adds to it on the ``embed_*`` tables, as the JAX masked decay does.

With the value-context channel (``model.extras.value_context``) the graph
carries the visibility template (train edges' values visible, val / test
hidden) and each train step also hides the epoch's supervised edges
(:meth:`Trainer._visible_graph`), on the device; eval forwards read the
template as it is.  ``train.extras.warm_start`` plants the ALS or
side-information baseline before ``fit`` (``training/warmstart.py``).

Every draw of an epoch (supervision mask, dropout) is keyed by (seed,
epoch), so a run restored from a checkpoint (:meth:`Trainer.restore`) continues as the unbroken run would:
bit for bit on the CPU; on the card within the order of the kernels' float
atomics.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import time
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.graph.attn_plan import ensure_attn_plans
from multi_modal_gnn_tpu_torch.graph.hetero import HeteroGraph, build_value_plan
from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT_LAB
from multi_modal_gnn_tpu_torch.models.factory import build_model
from multi_modal_gnn_tpu_torch.models.losses import (
    compute_lab_weights,
    masked_mean_loss,
    weighted_regression_loss,
)
from multi_modal_gnn_tpu_torch.models.hgt import HeteroGT
from multi_modal_gnn_tpu_torch.models.rgcn import HeteroRGCN
from multi_modal_gnn_tpu_torch.training.checkpoint import (
    adam_state_by_name,
    load_adam_state,
    load_checkpoint,
    save_checkpoint,
)
from multi_modal_gnn_tpu_torch.training.masker import (
    EdgeMasker,
    SplitBatch,
    _pad_batch,
    masker_from_config,
)
from multi_modal_gnn_tpu_torch.training.schedulers import build_scheduler
from multi_modal_gnn_tpu_torch.training.warmstart import warm_start_from_config, wire_warm_start
from multi_modal_gnn_tpu_torch.utils.device import resolve_device
from multi_modal_gnn_tpu_torch.utils.io import save_json
from multi_modal_gnn_tpu_torch.utils.profiling import MetricsWriter
from multi_modal_gnn_tpu_torch.utils.rng import apply_reproducibility, stream_seed

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
        # value visibility: the template rides on the graph, so every eval
        # forward (and the serving state) conditions on the train values only
        self._value_context = bool(getattr(self.model, "value_context", False))
        if self._value_context:
            es = self.graph.edges[PATIENT_LAB]
            base = torch.from_numpy(masker.visibility_base(es.src.shape[0])).to(self.device)
            es = dataclasses.replace(es, val_vis=base, value_plan=build_value_plan(es))
            edges = {**self.graph.edges, PATIENT_LAB: es}
            self.graph = dataclasses.replace(self.graph, edges=edges)
            # each train-batch slot's edge position (padding slots: 0)
            self._vis_train_pos = torch.from_numpy(masker.train_positions()).long().to(self.device)
        self.optimizer = build_optimizer(self.model, tc)
        # every parameter gets a gradient, zero where the loss does not reach
        # it (the RGCN's last non-patient, non-lab BatchNorms; the HGT's last
        # groups into diagnosis and medication), so that Adam's coupled decay
        # moves it as the JAX chain does
        for param in self.model.parameters():
            param.grad = torch.zeros_like(param)

        # lab-wise inverse-variance loss weights from the train split;
        # train.extras.lab_reweighting: false gives uniform weights.  The host
        # copy serves host-side consumers (the cluster batches) with no readback
        _, train_lab_idx, train_values = masker.split_arrays("train")
        if bool(tc.extras.get("lab_reweighting", True)):
            self.host_lab_weights = compute_lab_weights(train_values, train_lab_idx, graph.num_nodes(LAB))
        else:
            self.host_lab_weights = np.ones(graph.num_nodes(LAB), dtype=np.float32)
        self.lab_weights = torch.from_numpy(self.host_lab_weights).to(self.device)
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

    def _visible_graph(
        self,
        sup_mask: torch.Tensor,
        graph: Optional[HeteroGraph] = None,
        positions: Optional[torch.Tensor] = None,
    ) -> HeteroGraph:
        """``graph`` (default: the trainer's) with the train step's value
        visibility: its template with the supervised train edges hidden too,
        so no edge reads its own target (JAX ``Trainer._visible_graph``,
        single device).  ``positions`` are the batch slots' edge positions
        in ``graph`` (default: the full graph's train positions; a cluster
        batch carries its own, ``SplitBatch.vis_positions``).  Padding
        slots point at position 0 with supervision 0: the product over every
        slot's factor keeps edge 0 hidden when it is supervised, whatever
        the order of the duplicate writes."""
        graph = self.graph if graph is None else graph
        if not self._value_context:
            return graph
        positions = self._vis_train_pos if positions is None else positions.long()
        es = graph.edges[PATIENT_LAB]
        vis = es.val_vis.clone().index_reduce_(0, positions, 1.0 - sup_mask, "prod")
        edges = {**graph.edges, PATIENT_LAB: dataclasses.replace(es, val_vis=vis)}
        return dataclasses.replace(graph, edges=edges)

    def _train_step(
        self,
        batch: SplitBatch,
        sup_mask: torch.Tensor,
        dropout_seed: int,
        graph: Optional[HeteroGraph] = None,
    ) -> torch.Tensor:
        """One forward, weighted masked loss, backward and Adam step; the
        loss stays on the device.  ``batch`` is the train batch of ``graph``
        (default: the trainer's graph)."""
        self.model.train()
        preds = self.model.predict_lab_values(
            self._visible_graph(sup_mask, graph, batch.vis_positions), batch.patient_idx, batch.lab_idx, train=True,
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
        return loss.detach()

    def train_step(
        self,
        batch: SplitBatch,
        sup_mask: torch.Tensor,
        dropout_seed: int,
        graph: Optional[HeteroGraph] = None,
    ) -> float:
        """:meth:`_train_step`, the loss read back."""
        return float(self._train_step(batch, sup_mask, dropout_seed, graph))

    def _seeded_step(
        self, batch: SplitBatch, sup_mask: torch.Tensor, seed: int, graph: Optional[HeteroGraph] = None
    ) -> torch.Tensor:
        """:meth:`_train_step` with its dropout stream ``seed``: the fused
        heads' counter-based dropout and torch's generator (every other
        dropout) are both seeded from it, the caller's generator state
        restored after."""
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(seed)
            return self._train_step(batch, sup_mask, seed, graph)

    def _epoch_step(self, epoch: int) -> torch.Tensor:
        """Epoch ``epoch``'s step with its (seed, epoch) supervision mask and
        dropout stream.  The loss stays on the device."""
        batch = self.get_batch("train")
        sup_mask = self.masker.supervision_mask(epoch, batch)
        return self._seeded_step(batch, sup_mask, stream_seed(self.config.train.seed, "dropout", epoch))

    def train_epoch(self) -> float:
        return float(self._epoch_step(self.epoch))

    def train_epochs(
        self, k: int, with_val: bool = False, as_numpy: bool = True
    ) -> Tuple[Union[np.ndarray, torch.Tensor], Optional[Union[np.ndarray, torch.Tensor]]]:
        """Run ``k`` epochs back to back, with the validation loss after each
        when ``with_val``; nothing is read back to the host until the end.

        Epoch ``self.epoch + i`` draws the same supervision mask and dropout
        stream as :meth:`train_epoch` would, so the losses equal ``k`` calls
        of it.  The scheduler and early stopping do not act inside the
        chunk.  Advances ``self.epoch`` by ``k``.  Returns ``(train_losses[k],
        val_losses[k] or None)``, as numpy arrays, or as device tensors when
        ``as_numpy`` is false."""
        train_losses, val_losses = [], []
        for i in range(k):
            train_losses.append(self._epoch_step(self.epoch + i))
            if with_val:
                val_losses.append(self._eval_loss("val"))
        self.epoch += k
        tl = torch.stack(train_losses)
        vl = torch.stack(val_losses) if with_val else None
        if not as_numpy:
            return tl, vl
        return tl.float().cpu().numpy(), (vl.float().cpu().numpy() if with_val else None)

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

    @staticmethod
    def _forward_eval(model: torch.nn.Module, graph: HeteroGraph, batch: SplitBatch) -> torch.Tensor:
        """``model``'s eval-mode predictions for ``batch`` over ``graph``."""
        with torch.no_grad():
            return model.predict_lab_values(
                graph, batch.patient_idx, batch.lab_idx, train=False,
                patient_plan=batch.patient_plan, lab_plan=batch.lab_plan, degrees=batch.degrees,
            )

    def _eval_preds(self, batch: SplitBatch, state: Optional[dict] = None) -> torch.Tensor:
        return self._forward_eval(self.eval_model(state), self.graph, batch)

    def _eval_loss(self, split: str, state: Optional[dict] = None) -> torch.Tensor:
        batch = self.get_batch(split)
        preds = self._eval_preds(batch, state)
        return masked_mean_loss(preds, batch.values, batch.valid, self._loss_type)

    def validate(self, split: str = "val", state: Optional[dict] = None) -> float:
        """The masked loss on ``split`` of the live model, or of ``state``
        (``best_state`` for the test loss, as JAX ``train_pipeline`` reports)."""
        return float(self._eval_loss(split, state))

    def predict(self, split: str, state: Optional[dict] = None) -> np.ndarray:
        """Unpadded predictions for a split, in split order (slot-major
        batches are inverted back to row order), of the live model or of
        ``state``."""
        batch = self.get_batch(split)
        preds = self._eval_preds(batch, state).float().cpu().numpy()
        slots = self.masker.slot_map(split)
        if slots is not None:
            preds = preds[slots]
        return preds[: batch.num_valid]

    def predict_pairs(
        self,
        patient_idx: np.ndarray,
        lab_idx: np.ndarray,
        state: Optional[dict] = None,
        pad_multiple: int = 256,
    ) -> np.ndarray:
        """Predictions for any (patient, lab) pairs, in their order, from one
        eval forward over a row-major batch padded to ``pad_multiple``."""
        patient_idx = np.asarray(patient_idx, dtype=np.int32)
        lab_idx = np.asarray(lab_idx, dtype=np.int32)
        n = len(patient_idx)
        batch, _ = _pad_batch(patient_idx, lab_idx, np.zeros(n, np.float32), pad_multiple)
        batch = batch.to(self.device)
        batch.degrees = self.graph.patient_lab_degree[batch.patient_idx.long()]
        return self._eval_preds(batch, state).float().cpu().numpy()[:n]

    # -- the loop ----------------------------------------------------------

    def fit(self, output_dir=None, resume_from=None, scan_chunk: int = 1) -> Dict:
        """Train to ``train.epochs`` with the plateau scheduler and early
        stopping; keeps the best validation state in ``best_state``.

        With ``output_dir``: ``best_model.ckpt`` whenever validation
        improves, ``checkpoint_epoch_N.ckpt`` every
        ``logging.checkpoint_interval`` epochs, ``metrics.jsonl`` and
        ``training_history.json``.  ``resume_from``: a checkpoint to
        :meth:`restore` first, or ``"auto"`` for the newest periodic one in
        ``output_dir`` (none: a fresh start).

        Each chunk of ``scan_chunk`` epochs is one :meth:`train_epochs`
        call, validation inside the chunk.  With ``scan_chunk > 1`` the scheduler's learning rate and
        the early stop then take effect on chunk boundaries, and the best
        state is the state at the end of the chunk, as in JAX ``fit``."""
        tc = self.config.train
        lc = self.config.logging
        output_dir = Path(output_dir) if output_dir is not None else None
        if output_dir is not None:
            output_dir.mkdir(parents=True, exist_ok=True)
        if resume_from == "auto":
            resume_from = self.latest_checkpoint(output_dir) if output_dir is not None else None
            if resume_from is not None:
                logger.info("Auto-resume from %s", resume_from)
        if resume_from is not None:
            self.restore(resume_from)
        metrics = MetricsWriter(output_dir / "metrics.jsonl") if output_dir is not None else None

        logger.info("Starting training: %d epochs (from epoch %d)", tc.epochs, self.epoch)
        t_start = time.perf_counter()
        epoch_times = []
        stop = False
        while self.epoch < tc.epochs and not stop:
            t0 = time.perf_counter()
            k = min(max(scan_chunk, 1), tc.epochs - self.epoch)
            train_losses, val_losses = self.train_epochs(k, with_val=True)
            chunk = list(zip(train_losses.tolist(), val_losses.tolist()))
            chunk_time = time.perf_counter() - t0
            epoch_times.extend([chunk_time / len(chunk)] * len(chunk))

            for train_loss, val_loss in chunk:
                new_lr = self.scheduler.step(val_loss)
                self.history["train_loss"].append(train_loss)
                self.history["val_loss"].append(val_loss)
                self.history["learning_rates"].append(new_lr)
            if abs(new_lr - self.optimizer.param_groups[0]["lr"]) > 1e-12:
                logger.info("Epoch %d: reducing lr to %.2e", self.epoch, new_lr)
                self._set_lr(new_lr)
            if self.epoch % max(lc.log_interval, 1) == 0 or len(chunk) > 1:
                logger.info(
                    "Epoch %3d | train %.4f | val %.4f | lr %.2e | %.3fs",
                    self.epoch, train_loss, val_loss, new_lr, epoch_times[-1],
                )
            if metrics is not None:
                base = self.epoch - len(chunk)
                for i, (tl, vl) in enumerate(chunk):
                    metrics.write(
                        base + i + 1, train_loss=tl, val_loss=vl, lr=new_lr,
                        epoch_time_s=epoch_times[-1],
                    )

            improved = False
            for train_loss, val_loss in chunk:
                if val_loss < self.best_val_loss:
                    self.best_val_loss = val_loss
                    self.patience_counter = 0
                    improved = True
                else:
                    self.patience_counter += 1
                    if self.patience_counter >= tc.early_stopping_patience:
                        logger.info("Early stopping at epoch %d", self.epoch)
                        stop = True
                        break
            if improved:
                self.best_state = copy.deepcopy(self.model.state_dict())
                if output_dir is not None:
                    self._save(output_dir / "best_model.ckpt")
            if (
                output_dir is not None
                and lc.save_checkpoints
                and not stop
                and self.epoch % max(lc.checkpoint_interval, 1) == 0
            ):
                self._save(output_dir / f"checkpoint_epoch_{self.epoch}.ckpt")

        total_time = time.perf_counter() - t_start
        n_train = self.masker.split_sizes()["train"]
        self.history["total_time_s"] = total_time
        self.history["mean_epoch_time_s"] = float(np.mean(epoch_times)) if epoch_times else 0.0
        self.history["train_edges_per_sec"] = (
            n_train * len(epoch_times) / total_time if total_time > 0 else 0.0
        )
        if metrics is not None:
            metrics.close()
        if output_dir is not None:
            save_json(
                {k: self.history[k] for k in ("train_loss", "val_loss", "learning_rates")},
                output_dir / "training_history.json",
            )
        return self.history

    # -- checkpoint / resume -------------------------------------------------

    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _checkpoint_payload(self) -> dict:
        live = self.model.state_dict()
        return {
            "model": live,
            "best_model": self.best_state if self.best_state is not None else live,
            "adam": adam_state_by_name(self.model, self.optimizer),
        }

    def _host_metadata(self) -> dict:
        return {
            "epoch": self.epoch,
            "best_val_loss": self.best_val_loss,
            "patience_counter": self.patience_counter,
            "scheduler": dict(self.scheduler.__dict__),
            "history": {k: v for k, v in self.history.items() if isinstance(v, list)},
            "config_hash": self.config.content_hash(),
            "model_hash": self.config.model_hash(),
            "config": self.config.to_dict(),
        }

    def _save(self, path: Path) -> None:
        save_checkpoint(path, self._checkpoint_payload(), self._host_metadata())

    @staticmethod
    def latest_checkpoint(output_dir) -> Optional[Path]:
        """The ``checkpoint_epoch_N.ckpt`` of ``output_dir`` with the largest
        N, or None."""
        candidates = {}
        for p in Path(output_dir).glob("checkpoint_epoch_*.ckpt"):
            try:
                candidates[int(p.stem.rsplit("_", 1)[1])] = p
            except ValueError:
                continue
        return candidates[max(candidates)] if candidates else None

    def load_best_model(self, output_dir, force: bool = False) -> None:
        """Restore ``<output_dir>/best_model.ckpt`` and make it the live and
        the best state."""
        self.restore(Path(output_dir) / "best_model.ckpt", force=force)
        self.best_state = copy.deepcopy(self.model.state_dict())

    def restore(self, path, force: bool = False) -> None:
        """Resume from a checkpoint of the port or of the JAX package: the
        live and best states, Adam's state, the epoch, the early-stopping
        counters, the scheduler and the history.  Refuses a checkpoint whose
        ``model_hash`` (the ``model``, ``graph`` and ``feature_space``
        sections) differs from the live config's unless ``force``;
        run-length settings such as ``train.epochs`` may differ."""
        payload, meta = load_checkpoint(path)
        ckpt_hash = meta.get("model_hash")
        live_hash = self.config.model_hash()
        if ckpt_hash and ckpt_hash != live_hash and not force:
            raise ValueError(
                f"Checkpoint {path} was trained with an incompatible config "
                f"(checkpoint model hash {ckpt_hash[:12]}.. != live {live_hash[:12]}..). "
                "Pass force=True to restore anyway."
            )
        self.model.load_state_dict(payload["model"])
        load_adam_state(self.model, self.optimizer, payload["adam"])
        self.best_state = {k: v.to(self.device) for k, v in payload["best_model"].items()}
        self.epoch = int(meta.get("epoch", 0))
        self.best_val_loss = float(meta.get("best_val_loss", float("inf")))
        self.patience_counter = int(meta.get("patience_counter", 0))
        for k, v in (meta.get("scheduler") or {}).items():
            if hasattr(self.scheduler, k):
                setattr(self.scheduler, k, v)
        self._set_lr(float(self.scheduler.lr))
        for k, v in (meta.get("history") or {}).items():
            self.history[k] = list(v)
        logger.info("Resumed training at epoch %d (best val %.4f)", self.epoch, self.best_val_loss)


def cluster_count(config: Config, num_train: int) -> int:
    """The number of mini-batch clusters the config asks for:
    ``train.extras.num_clusters`` (default 1), raised to
    ``ceil(num_train / train.batch_size)`` when ``batch_size`` is set (JAX
    ``train_pipeline``)."""
    tc = config.train
    n = max(int(tc.extras.get("num_clusters", 1) or 1), 1)
    if tc.batch_size:
        n = max(n, -(-num_train // int(tc.batch_size)))
    return n


def train_pipeline(
    config: Config, graph, output_dir, resume_from=None, device=None
) -> Tuple[Trainer, Dict]:
    """The training stage: the model from ``config`` (weights drawn from
    ``train.seed``), the masker from the config, :meth:`Trainer.fit` into
    ``output_dir`` (``scan_chunk`` from ``train.scan_chunk``), then the best
    state's test loss in ``test_results.json``.  ``graph`` is a
    :class:`HeteroGraph` or a ``GraphBundle``.  Runs on ``device``
    (default: the card; raises without one), under
    ``config.reproducibility`` (:func:`apply_reproducibility`).

    More than one cluster (:func:`cluster_count`: ``train.batch_size`` or
    ``train.extras.num_clusters``) trains with
    :class:`~multi_modal_gnn_tpu_torch.training.minibatch.MiniBatchTrainer`,
    host-resident under ``train.extras.host_resident``.
    ``train.extras.warm_start: als | sideinfo`` wires the bilinear channel
    into the model config (:func:`~multi_modal_gnn_tpu_torch.training.warmstart.wire_warm_start`)
    and plants the baseline before ``fit``, as JAX ``train_pipeline`` does."""
    debug_context = apply_reproducibility(config)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    config = wire_warm_start(config)
    tc = config.train
    bundle = graph
    graph = getattr(bundle, "graph", bundle)
    masker = masker_from_config(config, graph)
    logger.info("Edge splits: %s", masker.split_sizes())
    generator = torch.Generator().manual_seed(stream_seed(tc.seed, "init"))
    model = build_model(config, graph, device=device, generator=generator)
    n_clusters = cluster_count(config, masker.split_sizes()["train"])
    if n_clusters > 1:
        from multi_modal_gnn_tpu_torch.training.minibatch import MiniBatchTrainer

        logger.info("Mini-batch training over %d patient clusters", n_clusters)
        trainer = MiniBatchTrainer(
            model, bundle, masker, config, num_clusters=n_clusters,
            host_resident=bool(tc.extras.get("host_resident", False)), device=device,
        )
    else:
        trainer = Trainer(model, graph, masker, config, device=device)
    warm_start_from_config(trainer, config)
    with debug_context:
        trainer.fit(output_dir=output_dir, resume_from=resume_from, scan_chunk=tc.scan_chunk)
    test_loss = trainer.validate("test", state=trainer.best_state)
    results = {
        "test_loss": test_loss,
        "best_val_loss": trainer.best_val_loss,
        "num_epochs": len(trainer.history["train_loss"]),
    }
    save_json(results, output_dir / "test_results.json")
    logger.info("Test loss (%s): %.4f", tc.loss, test_loss)
    return trainer, results
