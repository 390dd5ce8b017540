"""The explicit 2-D trainer (``multi_modal_gnn_tpu/parallel/dp2d.py``,
``train.extras.parallel: 2d | dp2d``, ``model_parallel`` m, default 2).

The layout is JAX's, over the ``D x m`` ranks of
:func:`~multi_modal_gnn_tpu_torch.parallel.mesh.init_2d_axes`:

* edge arrays and the supervised batch are cut over the **data** axis,
  exactly as under 1-D data parallelism (:class:`~.dp.DataParallelTrainer`,
  whose steps this trainer runs);
* the patient ID table (``embed_patient``) and so its optimizer state
  (Adam's two moments, SGD's momentum buffer) are cut row-wise over the
  **model** axis: rank ``(d, k)`` holds rows ``[k P / m, (k + 1) P / m)``
  (:class:`~multi_modal_gnn_tpu_torch.models.layers.ShardedEmbedding`);
* everything else is replicated.

Collectives:

* forward: one all-gather of the table over the model axis, once a
  forward (JAX ``_prepare_params``); its backward is the rank's row slice
  of the table's gradient (``parallel/collectives.py``): the model axis's
  ranks of one data shard see the same batch and the same table, so each
  computes the same full gradient, and a sum over the model axis would
  count it ``m`` times;
* the per-relation partial sums, the loss and the value context's sums are
  all-reduced over the data axis (the model's ``axis``);
* the table's gradient slice is summed over the data axis; every other
  gradient over the whole world and divided by ``m``, so every rank takes
  the same optimizer step bit for bit, and the BatchNorm statistics are rank
  ``(d, 0)``'s on the model axis after every step.  On the card K1's
  atomics may sum the model axis's replicas of one shard in other orders:
  without this their parameters would drift apart step by step.  For the
  same reason every rank reads model rank 0's validation loss, on which
  ``fit`` decides.

With ``host_edges`` (``model.use_pallas``) every relation aggregates
through K1 over its per-shard plan of the data axis, forward and as the
mirror backward; no other kernel runs (the pair heads are plain, the HGT
takes its segment tier, as under 1-D).

Checkpoints are JAX's sharded format: every rank writes its
``<path>.procNNN.npz`` with the chunks it is the lowest holder of (rank 0
the replicated leaves, ranks ``(0, k)`` their table rows), rank 0 the
sidecar (``training/checkpoint.py``).  :meth:`TwoDTrainer.restore` reads
any checkpoint (this format from any partition, JAX's, the port's single
file) and keeps its rows.  Serving (``serving.py``) runs an unsharded copy
with the whole table over the whole graph; every rank must ask for it (the
table is gathered).
"""

from __future__ import annotations

import copy
import logging
from pathlib import Path
from typing import Optional

import torch
from torch import nn

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.graph.hetero import HeteroGraph
from multi_modal_gnn_tpu_torch.graph.schema import PATIENT
from multi_modal_gnn_tpu_torch.models.layers import ShardedEmbedding
from multi_modal_gnn_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_grads,
    barrier,
    broadcast_,
    broadcast_module,
)
from multi_modal_gnn_tpu_torch.parallel.dp import DataParallelTrainer, sharded_model
from multi_modal_gnn_tpu_torch.parallel.mesh import Mesh2D, init_2d_axes
from multi_modal_gnn_tpu_torch.training.checkpoint import (
    jax_state_leaves,
    optimizer_kind,
    optimizer_state_by_name,
    save_sharded_checkpoint,
)
from multi_modal_gnn_tpu_torch.training.masker import EdgeMasker
from multi_modal_gnn_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

TABLE = f"embed_{PATIENT}.weight"


def model_parallel_of(config: Config) -> int:
    """``train.extras.model_parallel`` (default 2, JAX ``trainer.py:885``)."""
    return int(config.train.extras.get("model_parallel", 2) or 2)


class TwoDTrainer(DataParallelTrainer):
    """:class:`DataParallelTrainer` over the data axis with the patient
    table cut over the model axis (module docstring).

    ``graph`` is the full graph (on the host); ``model`` an unsharded model
    (default: built from ``config``), whose weights every rank takes from
    global rank 0; ``mesh`` the rank's axes (default:
    :func:`~multi_modal_gnn_tpu_torch.parallel.mesh.init_2d_axes` from the
    launch, ``train.num_devices`` and ``train.extras.model_parallel``)."""

    def __init__(
        self,
        graph: HeteroGraph,
        masker: EdgeMasker,
        config: Config,
        model=None,
        mesh: Optional[Mesh2D] = None,
        device=None,
        host_edges=None,
    ):
        device = resolve_device(device)
        if mesh is None:
            mesh = init_2d_axes(device, config.train.num_devices, model_parallel_of(config))
        num_patients = graph.num_nodes(PATIENT)
        if num_patients % mesh.model.size:
            raise ValueError(f"patient count {num_patients} not divisible by model axis {mesh.model.size}")
        self.mesh = mesh
        self.model_axis = mesh.model
        self.world = mesh.world
        super().__init__(graph, masker, config, model=model, axis=mesh.data, device=device, host_edges=host_edges)
        logger.info(
            "2-D trainer: rank %d of %d, data %d of %d, model %d of %d (patient rows %s)",
            self.world.rank, self.world.size, self.axis.rank, self.axis.size, self.model_axis.rank,
            self.model_axis.size, self.model.embed_patient.row_range,
        )

    def _shard_model(self, model, config: Config, graph: HeteroGraph, device):
        """Global rank 0's weights on every rank, the data axis set, and
        the patient table cut to this rank's rows (so the optimizer, built
        over the parameters next, holds those rows of its state)."""
        model = sharded_model(model, config, graph, self.world, device)
        model.axis = self.axis
        model.embed_patient = ShardedEmbedding(model.embed_patient.weight, self.model_axis)
        return model

    @property
    def saves_checkpoints(self) -> bool:
        return True  # every rank writes its own file

    # -- the step ----------------------------------------------------------

    def _reduce_grads(self) -> None:
        """The table's row slice summed over the data axis; every other
        gradient summed over the world and divided by ``m``; the BatchNorm
        statistics made the model axis's rank 0's (module docstring)."""
        table = self.model.embed_patient.weight
        all_reduce_grads([table], self.axis)
        rest = [p for p in self.model.parameters() if p is not table]
        all_reduce_grads(rest, self.world, scale=1.0 / self.model_axis.size)
        broadcast_module(self.model, self.model_axis, buffers_only=True)

    def _eval_loss(self, split: str, state: Optional[dict] = None) -> torch.Tensor:
        """The split's loss, model rank 0's on every rank: the data axis's
        groups sum in their own orders on the card, and ``fit``'s best
        state, plateau and early stop must decide alike everywhere (a rank
        that saved alone would wait for the others forever)."""
        return broadcast_(super()._eval_loss(split, state).clone(), self.model_axis)

    # -- whole tables --------------------------------------------------------

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        lo, hi = self.model.embed_patient.row_range
        return t[lo:hi]

    def global_state(self, state: Optional[dict] = None) -> dict:
        state = dict(self.model.state_dict() if state is None else state)
        state[TABLE] = all_gather(state[TABLE].detach(), self.model_axis, "table_gather")
        return state

    def load_global_state(self, state: dict) -> None:
        self.model.load_state_dict({**state, TABLE: self._rows(state[TABLE])})

    def serving_model(self) -> nn.Module:
        """An unsharded copy of the best (else live) state with the whole
        table, in eval mode; every rank must call it (the table is
        gathered over the model axis)."""
        state = self.global_state(self.best_state)
        model = copy.deepcopy(self.model)
        model.embed_patient = nn.Embedding(*state[TABLE].shape, _weight=state[TABLE].clone())
        model.load_state_dict(state)
        model.axis = None
        return model.eval()

    # -- checkpoints -----------------------------------------------------------

    def _save(self, path: Path) -> None:
        """This rank's file of JAX's sharded format (module docstring); the
        best state's optimizer leaves are the live optimizer state's (the port
        keeps no optimizer state with its best parameters).  Returns once
        every rank has written."""
        live = self.model.state_dict()
        best = self.best_state if self.best_state is not None else live
        named = optimizer_state_by_name(self.model, self.optimizer)
        lr, kind = self.optimizer.param_groups[0]["lr"], optimizer_kind(self.optimizer)
        leaves = jax_state_leaves(self.model, best, named, lr, kind) + jax_state_leaves(self.model, live, named, lr, kind)
        save_sharded_checkpoint(
            path, leaves, self._host_metadata(), self.world.rank, self.world.size,
            rows={TABLE: self.model.embed_patient.row_range}, owns_rows=self.axis.rank == 0,
        )
        barrier(self.world)

    def _load_payload(self, payload: dict) -> None:
        """A payload of whole tables (any checkpoint the reader takes), cut
        to this rank's rows (JAX ``dp2d.py:228-234``)."""
        kind = optimizer_kind(self.optimizer)
        named = dict(payload.get(kind) or {})
        if TABLE in named:
            named[TABLE] = {k: v if k == "step" else self._rows(v) for k, v in named[TABLE].items()}
        super()._load_payload({
            "model": {**payload["model"], TABLE: self._rows(payload["model"][TABLE])},
            "best_model": {**payload["best_model"], TABLE: self._rows(payload["best_model"][TABLE])},
            **({kind: named} if kind in payload else {}),
        })
