"""The full-batch data-parallel trainer (``multi_modal_gnn_tpu/parallel/dp.py``).

Each rank runs :class:`~multi_modal_gnn_tpu_torch.training.trainer.Trainer`'s
step on its shard (``parallel/sharding.py``), with the numerics of one
process:

* the parameters are initialized once, identically on every rank (the
  same ``train.seed`` stream, then rank 0's broadcast), and stay
  replicated: the gradients are summed over the ranks before every
  optimizer step (``parallel/collectives.py``);
* the epoch's supervision mask is the draw over the *whole* train batch,
  which every rank makes from the same generator and then cuts to its
  chunk (JAX ``dp.py:122-170``);
* node dropout draws from the stream every rank shares, the edge heads'
  from a stream of the rank's own;
* :meth:`predict` and :meth:`validate` gather the shards' predictions in
  split order (JAX's ``out_specs P(DATA_AXIS)``);
* ``fit``, checkpoints and resume are the base class's; rank 0 writes;
* ``predict_pairs`` runs the given pairs whole on every rank (every rank
  must call it: the forward all-reduces);
* serving (``serving.py``) runs the unsharded model over the whole graph
  (:meth:`DataParallelTrainer.serving_graph`), with no collective.

With ``host_edges`` (a bundle's host edges, ``model.use_pallas``) every
relation aggregates through K1 over its per-shard windowed plan, forward
and backward; without them, through the segment path and an all-reduce.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import torch

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.graph.hetero import HeteroGraph
from multi_modal_gnn_tpu_torch.models.factory import build_model
from multi_modal_gnn_tpu_torch.parallel.collectives import broadcast_module
from multi_modal_gnn_tpu_torch.parallel.mesh import DataAxis, init_axis
from multi_modal_gnn_tpu_torch.parallel.sharding import (
    check_graph_divisible,
    shard_batch,
    shard_graph,
    shard_rows,
)
from multi_modal_gnn_tpu_torch.training.masker import EdgeMasker, SplitBatch
from multi_modal_gnn_tpu_torch.training.trainer import Trainer
from multi_modal_gnn_tpu_torch.utils.device import resolve_device
from multi_modal_gnn_tpu_torch.utils.rng import stream_seed

logger = logging.getLogger(__name__)


def init_generator(config: Config) -> torch.Generator:
    """The generator the model's weights are drawn from (``train.seed``'s
    ``init`` stream, as ``train_pipeline`` draws them)."""
    return torch.Generator().manual_seed(stream_seed(config.train.seed, "init"))


def sharded_model(model, config: Config, graph: HeteroGraph, axis: DataAxis, device):
    """``model`` (default: one built from ``config``) on ``device`` with its
    data axis set, and every rank's weights rank 0's."""
    if model is None:
        model = build_model(config, graph, device=device, generator=init_generator(config))
    model = model.to(device)
    model.axis = axis
    broadcast_module(model, axis)
    return model


class DataParallelTrainer(Trainer):
    """:class:`Trainer` over this rank's edge shard (module docstring).

    ``graph`` is the full graph (on the host); ``model`` an unsharded model
    whose weights every rank shares (default: built from ``config``);
    ``axis`` the data axis (default: :func:`~multi_modal_gnn_tpu_torch.parallel.mesh.init_axis`
    from the launch's environment and ``train.num_devices``)."""

    def __init__(
        self,
        graph: HeteroGraph,
        masker: EdgeMasker,
        config: Config,
        model=None,
        axis: Optional[DataAxis] = None,
        device=None,
        host_edges=None,
    ):
        device = resolve_device(device)
        self.axis = axis if axis is not None else init_axis(device, config.train.num_devices)
        if self.world is None:  # 1-D: the data axis is every rank
            self.world = self.axis
        check_graph_divisible(graph, self.axis.size)
        self.full_graph = graph
        self._host_edges = host_edges
        self._full_batches: Dict[str, SplitBatch] = {}
        self._serving_graph: Optional[HeteroGraph] = None
        model = self._shard_model(model, config, graph, device)
        super().__init__(model, graph, masker, config, device=device)
        logger.info("Data-parallel trainer: rank %d of %d", self.axis.rank, self.axis.size)

    def _shard_model(self, model, config: Config, graph: HeteroGraph, device):
        """The model every rank trains: rank 0's weights, the data axis set."""
        return sharded_model(model, config, graph, self.axis, device)

    def _place_graph(self, graph: HeteroGraph) -> HeteroGraph:
        """This rank's shard, with the value context's template cut from
        the whole graph's, and its per-shard K1 plans."""
        graph = shard_graph(self._attach_visibility(graph), self.axis, host_edges=self._host_edges)
        return self._attach_value_plan(graph.to(self.device))

    def serving_model(self) -> torch.nn.Module:
        return super().serving_model().unsharded()

    def serving_graph(self) -> HeteroGraph:
        """The whole graph, placed as a single process places it (the
        visibility template, the value plan, the HGT's attention plans)."""
        if self._serving_graph is None:
            self._serving_graph = Trainer._place_graph(self, self.full_graph)
        return self._serving_graph

    def full_batch(self, split: str) -> SplitBatch:
        """The whole split's batch on the device, with its degrees and lab
        weights (the base trainer's :meth:`get_batch`)."""
        if split not in self._full_batches:
            self._full_batches[split] = super().get_batch(split)
        return self._full_batches[split]

    def get_batch(self, split: str) -> SplitBatch:
        """This rank's chunk of :meth:`full_batch`."""
        key = f"shard:{split}"
        if key not in self._batches:
            self._batches[key] = shard_batch(self.full_batch(split), self.axis)
        return self._batches[key]

    def _epoch_step(self, epoch: int) -> torch.Tensor:
        sup = self.masker.supervision_mask(epoch, self.full_batch("train"))
        seed = stream_seed(self.config.train.seed, "dropout", epoch)
        return self._seeded_step(self.get_batch("train"), shard_rows(sup, self.axis), seed)
