"""Cluster-GCN composed with edge-sharded data parallelism
(``multi_modal_gnn_tpu/parallel/minibatch_dp.py``): every step, every rank
works on the *same* cluster and takes a contiguous ``1 / size`` chunk of its
(dst-sorted, 1024-padded) edge arrays and of its supervised batch, the
layout of ``parallel/dp.py``.

* The partition is :class:`~multi_modal_gnn_tpu_torch.training.minibatch.MiniBatchTrainer`'s
  (the same ranges, one global patient table read through
  ``patient_id_base``); the epoch visits the clusters in the same order and
  each cluster's supervision mask is the draw over its whole batch, cut to
  the rank's chunk.
* With ``model.use_pallas`` each cluster's edge sets get their own
  per-shard windowed plans, from the cluster's host edges (JAX
  ``_cluster_host_edges``), so aggregation runs K1 on every rank.
* ``host_resident``: each rank's cluster shards stay in page-locked host
  memory and reach the card one cluster ahead (the base class's side
  stream), so a rank's card holds ``1 / size`` of a few clusters' edges.
* The value context composes: each cluster's visibility template is cut
  with its edge arrays, and a batch's ``vis_positions`` stay whole
  (``parallel/sharding.py``), mapped into the rank's chunk by the step.
* Evaluation and :meth:`predict` run cluster by cluster, the shards'
  predictions gathered in order; ``predict_pairs`` runs the unsharded twin
  on the whole graph, which the trainer keeps on the card as
  :class:`MiniBatchTrainer` does.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.graph.build import GraphBundle, GraphMeta, host_edges_of
from multi_modal_gnn_tpu_torch.graph.hetero import build_value_plan
from multi_modal_gnn_tpu_torch.graph.schema import PATIENT, PATIENT_LAB, mirror_edge_type
from multi_modal_gnn_tpu_torch.parallel.collectives import all_gather
from multi_modal_gnn_tpu_torch.parallel.dp import sharded_model
from multi_modal_gnn_tpu_torch.parallel.mesh import DataAxis, init_axis
from multi_modal_gnn_tpu_torch.parallel.sharding import (
    attach_shard_plans,
    check_graph_divisible,
    graph_shard,
    shard_batch,
    shard_rows,
)
from multi_modal_gnn_tpu_torch.training.masker import EdgeMasker, SplitBatch
from multi_modal_gnn_tpu_torch.training.minibatch import ClusterData, MiniBatchTrainer, build_patient_clusters
from multi_modal_gnn_tpu_torch.utils.device import resolve_device
from multi_modal_gnn_tpu_torch.utils.rng import fold_in, stream_seed

logger = logging.getLogger(__name__)


class MiniBatchDPTrainer(MiniBatchTrainer):
    """:class:`MiniBatchTrainer` whose cluster step runs over this rank's
    shard of the cluster (module docstring).  ``model`` and ``axis`` as in
    :class:`~multi_modal_gnn_tpu_torch.parallel.dp.DataParallelTrainer`."""

    def __init__(
        self,
        bundle,
        masker: EdgeMasker,
        config: Config,
        num_clusters: int,
        model=None,
        axis: Optional[DataAxis] = None,
        host_resident: bool = False,
        balance: Optional[str] = None,
        device=None,
        clusters: Optional[ClusterData] = None,
    ):
        device = resolve_device(device)
        self.axis = axis if axis is not None else init_axis(device, config.train.num_devices)
        self.world = self.axis
        if not isinstance(bundle, GraphBundle):
            bundle = GraphBundle(graph=bundle, meta=GraphMeta(), host_edges=host_edges_of(bundle))
        self.full_graph = bundle.graph
        # each cluster's whole batches (the supervision draw's shape)
        self._full_cluster_batches: Dict[str, List[Optional[SplitBatch]]] = {}
        model = sharded_model(model, config, bundle.graph, self.axis, device)
        super().__init__(
            model, bundle, masker, config, num_clusters, host_resident=host_resident, balance=balance,
            device=device, clusters=clusters,
        )
        logger.info(
            "Mini-batch DP: %d clusters, rank %d of %d%s", self.num_clusters, self.axis.rank,
            self.axis.size, " (host-resident)" if host_resident else "",
        )

    def _eval_preds(self, batch: SplitBatch, state: Optional[dict] = None) -> torch.Tensor:
        """``predict_pairs``: the trainer's graph is the whole graph (as
        :class:`MiniBatchTrainer` keeps it), so the unsharded twin runs it,
        with no collective."""
        return self._forward_eval(self.eval_model(state).unsharded(), self.graph, batch)

    def serving_model(self) -> torch.nn.Module:
        return super().serving_model().unsharded()

    def _ensure_clusters(self) -> ClusterData:
        """The partition, each cluster's edge sets and batches cut to this
        rank's chunk: the edge shards on the card, or pinned on the host
        when ``host_resident``; the batches on the card."""
        if self._cluster_data is not None:
            return self._cluster_data
        n = self.axis.size
        cd = self._prebuilt or build_patient_clusters(
            self._bundle, self.masker, self.config, self.num_clusters,
            lab_weights=self.host_lab_weights, value_context=self._value_context,
            balance=self.cluster_balance,
        )
        cd = dataclasses.replace(cd)
        host_edges = self._cluster_host_edges(cd) if self.config.model.use_pallas else None
        subgraphs = []
        for k, sg in enumerate(cd.subgraphs):
            check_graph_divisible(sg, n)
            if host_edges is not None:
                sg = attach_shard_plans(sg, host_edges[k], n)
            sg = graph_shard(sg, self.axis.rank, n)
            if self._value_context:
                es = sg.edges[PATIENT_LAB]
                sg.edges[PATIENT_LAB] = dataclasses.replace(es, value_plan=build_value_plan(es))
            subgraphs.append(sg)
        if self._copy_stream is not None:
            cd.subgraphs = [g.pin_memory() for g in subgraphs]
        elif not self.host_resident:
            cd.subgraphs = [g.to(self.device) for g in subgraphs]
        else:
            cd.subgraphs = subgraphs
        self._full_cluster_batches = {}
        batches = {}
        for split, entries in cd.batches.items():
            full = [None if b is None else b.to(self.device) for b, _ in entries]
            self._full_cluster_batches[split] = full
            batches[split] = [
                (None if b is None else shard_batch(b, self.axis), pos) for b, (_, pos) in zip(full, entries)
            ]
        cd.batches = batches
        self._cluster_data = cd
        return cd

    def _cluster_host_edges(self, cd: ClusterData):
        """Each cluster's host edges ``{et: (src_local, dst, val)}`` in its
        dst-sorted valid order, from the bundle's with the partition's
        ranges (JAX ``_cluster_host_edges``)."""
        out = [dict() for _ in range(self.num_clusters)]
        for et, (src, dst, val) in self._bundle.host_edges.items():
            if et[0] != PATIENT:
                if mirror_edge_type(et) in self._bundle.host_edges:
                    continue
                raise ValueError(f"non-patient-centric relation {et}")
            src = np.asarray(src)
            cid = cd.cluster_of(src)
            for k in range(self.num_clusters):
                m = cid == k
                out[k][et] = (
                    (src[m] - cd.bases[k]).astype(np.int32),
                    np.asarray(dst)[m].astype(np.int32),
                    None if val is None else np.asarray(val)[m],
                )
        return out

    def _epoch_step(self, epoch: int) -> torch.Tensor:
        """:meth:`MiniBatchTrainer._epoch_step` with each cluster's
        supervision mask drawn over its whole batch, then cut."""
        seed = self.config.train.seed
        order = np.random.default_rng(stream_seed(seed, "cluster_order", epoch)).permutation(self.num_clusters)
        drop_seed = stream_seed(seed, "dropout", epoch)
        total, n = None, 0
        for k, graph, batch in self._clusters("train", order):
            full = self._full_cluster_batches["train"][k]
            sup = shard_rows(self.masker.supervision_mask(epoch, full, cluster=k), self.axis)
            loss = self._seeded_step(batch, sup, fold_in(drop_seed, k), graph)
            contrib = loss * batch.num_valid
            total = contrib if total is None else total + contrib
            n += batch.num_valid
        if total is None:
            return torch.zeros((), device=self.device)
        return total / max(n, 1)

    def predict(self, split: str, state: Optional[dict] = None) -> np.ndarray:
        """Predictions in split order: each cluster's shards gathered."""
        model = self.eval_model(state)
        cd = self._ensure_clusters()
        out = np.zeros(len(self.masker.split_indices(split)), dtype=np.float32)
        for k, graph, batch in self._clusters(split, range(self.num_clusters)):
            preds = all_gather(self._forward_eval(model, graph, batch).float(), self.axis)
            out[cd.batches[split][k][1]] = preds[: batch.num_valid].cpu().numpy()
        return out
