"""Cluster-partitioned mini-batch training (Cluster-GCN;
``multi_modal_gnn_tpu/training/minibatch.py``).

Every relation of the schema is patient-centric (patient -> lab / diagnosis
/ medication and their reverses), so a partition of the patients induces an
exact partition of the edges:

* the patients are cut into ``num_clusters`` contiguous, ``WINDOW``-aligned
  ranges, edge-balanced by default (:func:`_cluster_bases`); every
  cluster's edge arrays are padded to the largest cluster's, so one set of
  shapes serves every cluster;
* each cluster's subgraph keeps the whole lab / diagnosis / medication node
  sets and only its own patients, renumbered from 0; it carries
  ``HeteroGraph.patient_id_base``, through which the model reads the
  cluster's window of the one global patient table (``models/layers.py``
  ``patient_rows``), so one table and one optimizer state serve every
  cluster;
* an epoch visits the clusters in a permutation drawn from (seed,
  ``"cluster_order"``, epoch); each cluster draws its own supervision mask
  and dropout stream, the epoch's folded with the cluster index, and the
  epoch's loss is the valid-row-weighted mean of the clusters' losses,
  summed on the device;
* evaluation runs cluster by cluster and puts the predictions back in the
  split's order.

Cluster graphs carry no span plan and no attention plan (as in JAX), and
their batches are row-major, so the RGCN aggregates with K1's paired tier
and K2f / K2b, runs its heads unfused with K1 as the gathers' backward, and
the HGT takes its segment tier.

``host_resident``: the cluster subgraphs live in page-locked host memory;
while cluster k computes, cluster k+1 is copied to the card on a side
stream.  The card then holds at most three clusters' edge sets: the one
computing, the one being copied and the previous one, whose memory returns
to the allocator once the step that read it has run (the host waits for
that step before it starts the next copy).  The batches stay on
the card, as in JAX.  The trainer keeps the full graph on the card as
well: ``predict_pairs``, the serving state and the pipeline's evaluation
read it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.graph.build import GraphBundle, GraphMeta, host_edges_of
from multi_modal_gnn_tpu_torch.graph.hetero import (
    WINDOW,
    HeteroGraph,
    _round_up,
    build_value_plan,
    pad_edge_set,
)
from multi_modal_gnn_tpu_torch.graph.schema import (
    LAB,
    PATIENT,
    PATIENT_LAB,
    mirror_edge_type,
    reverse_edge_type,
)
from multi_modal_gnn_tpu_torch.models.losses import masked_mean_loss
from multi_modal_gnn_tpu_torch.training.masker import EdgeMasker, SplitBatch, _pad_batch
from multi_modal_gnn_tpu_torch.training.trainer import Trainer
from multi_modal_gnn_tpu_torch.utils.rng import fold_in, stream_seed

logger = logging.getLogger(__name__)

BALANCES = ("edges", "patients")


@dataclasses.dataclass
class ClusterData:
    """The partition: K subgraphs and, per split, each cluster's batch (None
    when the cluster has no row of the split) with its rows' positions in
    the split."""

    subgraphs: List[HeteroGraph]
    bases: List[int]
    local_size: int
    batches: Dict[str, List[Tuple[Optional[SplitBatch], Optional[np.ndarray]]]]

    def cluster_of(self, patient_idx: np.ndarray) -> np.ndarray:
        """The cluster of each global patient index."""
        return (np.searchsorted(np.asarray(self.bases), patient_idx, side="right") - 1).astype(np.int64)


def max_clusters(num_patients: int) -> int:
    """The number of ``WINDOW``-aligned patient ranges."""
    return -(-num_patients // WINDOW)


def _cluster_bases(num_p: int, num_clusters: int, edge_weight: Optional[np.ndarray]) -> List[int]:
    """``WINDOW``-aligned first patients of the clusters.  With
    ``edge_weight`` (each patient's forward-edge count) the ranges carry
    about equal edge loads: under degree-sorted patient numbering equal
    patient ranges put most edges in the last cluster, and every cluster
    is padded to the largest.  ``None``: equal patient ranges."""
    limit = max_clusters(num_p)
    if num_clusters > limit:
        raise ValueError(
            f"num_clusters={num_clusters} exceeds ceil(num_patients/WINDOW)={limit} "
            f"({num_p} patients, window {WINDOW}); use at most {limit} clusters"
        )
    if edge_weight is None:
        size = _round_up(-(-num_p // num_clusters), WINDOW)
        return [k * size for k in range(num_clusters)]
    cum = np.concatenate([[0.0], np.cumsum(edge_weight, dtype=np.float64)])
    targets = np.arange(1, num_clusters) * (cum[-1] / num_clusters)
    cuts = np.searchsorted(cum, targets, side="left")
    cuts = np.round(cuts / WINDOW).astype(np.int64) * WINDOW
    bases = [0]
    for c in cuts:
        c = int(min(max(c, bases[-1] + WINDOW), num_p))
        if c <= bases[-1]:
            c = bases[-1] + WINDOW  # degenerate weights: keep the ranges non-empty
        bases.append(min(c, num_p))
    return bases[:num_clusters]


def build_patient_clusters(
    bundle: GraphBundle,
    masker: EdgeMasker,
    config: Config,
    num_clusters: int,
    lab_weights: Optional[np.ndarray] = None,
    value_context: bool = False,
    balance: str = "edges",
) -> ClusterData:
    """Partition ``bundle`` into ``num_clusters`` patient-range subgraphs,
    on the host (CPU tensors), from its host edges.

    Each relation's cluster edge lists are padded to the largest cluster's,
    a multiple of 1024; patients past a cluster's own range, up to the
    shared ``local_size``, have no edge.  With ``value_context`` each
    cluster's patient -> lab edge set carries its visibility template
    (its train edges) and a ``ValuePlan``, and each train batch its rows'
    local edge positions.  Split batches are row-major, padded to a
    multiple of 256, with their gather plans, degrees and (with
    ``lab_weights``) loss weights taken from host arrays."""
    graph = bundle.graph
    counts = graph.node_count_map
    num_p = counts[PATIENT]
    if not bundle.host_edges:
        raise ValueError("bundle.host_edges required for cluster partitioning")
    if balance not in BALANCES:
        raise ValueError(f"balance must be 'edges' or 'patients', got {balance!r}")

    edge_weight = None
    if balance == "edges":
        edge_weight = np.zeros(num_p, dtype=np.int64)
        for et, (src, _dst, _val) in bundle.host_edges.items():
            if et[0] == PATIENT:
                edge_weight += np.bincount(np.asarray(src), minlength=num_p)
    bases = _cluster_bases(num_p, num_clusters, edge_weight)
    bases_arr = np.asarray(bases)
    range_ends = np.concatenate([bases_arr[1:], [num_p]])
    size = _round_up(int((range_ends - bases_arr).max()), WINDOW)

    # per relation (the patient is the source of every forward relation):
    # each cluster's rows of the host arrays and the shared padded length
    per_rel: Dict = {}
    for et, (src, dst, val) in bundle.host_edges.items():
        if et[0] != PATIENT:
            # a graph's host edges hold the reverse relations too: rebuilt
            # from the forward ones below
            if mirror_edge_type(et) in bundle.host_edges:
                continue
            raise ValueError(f"non-patient-centric relation {et} cannot be clustered")
        cid = np.searchsorted(bases_arr, np.asarray(src), side="right") - 1
        rows = [np.nonzero(cid == k)[0] for k in range(num_clusters)]
        pad_to = _round_up(max((len(r) for r in rows), default=0), 1024)
        per_rel[et] = (src, dst, val, rows, pad_to)

    # the train edges' positions in the full graph's (destination-sorted)
    # edge arrays: the key of the cluster-local visibility templates
    train_pos_global = masker.split_edge_positions("train") if value_context else None

    dense_budget = config.graph.dense_adjacency_max_bytes
    subgraphs: List[HeteroGraph] = []
    host_degrees: List[np.ndarray] = []
    for k in range(num_clusters):
        base = bases[k]
        edges = {}
        for et, (src, dst, val, rows, pad_to) in per_rel.items():
            r = rows[k]
            s_loc = (np.asarray(src)[r] - base).astype(np.int32)
            d = np.asarray(dst)[r].astype(np.int32)
            v = None if val is None else np.asarray(val)[r]
            d_count = counts[et[2]]
            edges[et] = pad_edge_set(
                s_loc, d, num_src=size, num_dst=d_count, val=v, pad_multiple=pad_to,
                dense_max_bytes=dense_budget,
            )
            if value_context and et == PATIENT_LAB:
                # r is in global edge order (destination-sorted), and the
                # local stable re-sort of that subsequence keeps it: the local
                # position of r[i] is i
                vis = np.zeros(edges[et].mask.shape[0], np.float32)
                vis[: len(r)] = np.isin(r, train_pos_global, assume_unique=True)
                es = dataclasses.replace(edges[et], val_vis=torch.from_numpy(vis))
                edges[et] = dataclasses.replace(es, value_plan=build_value_plan(es))
            edges[reverse_edge_type(et)] = pad_edge_set(
                d, s_loc, num_src=d_count, num_dst=size, val=None, pad_multiple=pad_to,
                dense_max_bytes=dense_budget,
            )
        pl_rows = per_rel[PATIENT_LAB][3][k]
        pl_src_loc = np.asarray(per_rel[PATIENT_LAB][0])[pl_rows] - base
        degree = np.bincount(pl_src_loc, minlength=size).astype(np.int32)
        host_degrees.append(degree)
        node_counts = dict(counts)
        node_counts[PATIENT] = size
        subgraphs.append(
            HeteroGraph(
                edges=edges,
                patient_lab_degree=torch.from_numpy(degree),
                node_counts=tuple(sorted(node_counts.items())),
                patient_id_base=int(base),
            )
        )

    # per split, per cluster: the supervised batch
    pl_rows_all = per_rel[PATIENT_LAB][3]
    batches: Dict[str, List[Tuple[Optional[SplitBatch], Optional[np.ndarray]]]] = {}
    for split in masker.split_sizes():  # train / val / test (+ "cal")
        p, l, v = masker.split_arrays(split)
        split_pos_global = (
            masker.split_edge_positions(split) if value_context and split == "train" else None
        )
        cid = np.searchsorted(bases_arr, np.asarray(p), side="right") - 1
        pad_to = _round_up(max((int((cid == k).sum()) for k in range(num_clusters)), default=0), 256)
        split_list = []
        for k in range(num_clusters):
            pos = np.nonzero(cid == k)[0]
            if len(pos) == 0:
                split_list.append((None, None))
                continue
            p_loc = (p[pos] - bases[k]).astype(np.int32)
            batch, _ = _pad_batch(
                p_loc, l[pos].astype(np.int32), v[pos].astype(np.float32), pad_multiple=pad_to,
                num_patients=size, num_labs=counts[LAB],
            )
            pad_len = batch.valid.shape[0]
            p_host = np.zeros(pad_len, np.int32)
            p_host[: len(pos)] = p_loc
            l_host = np.zeros(pad_len, np.int32)
            l_host[: len(pos)] = l[pos]
            batch.degrees = torch.from_numpy(host_degrees[k][p_host])
            if lab_weights is not None:
                batch.sample_weights = torch.from_numpy(np.asarray(lab_weights)[l_host].astype(np.float32))
            if split_pos_global is not None:
                # the local edge position of each supervised row: the rank of
                # its global position among the cluster's rows
                vp = np.zeros(pad_len, np.int32)
                vp[: len(pos)] = np.searchsorted(pl_rows_all[k], split_pos_global[pos])
                batch.vis_positions = torch.from_numpy(vp)
            split_list.append((batch, pos))
        batches[split] = split_list

    return ClusterData(subgraphs=subgraphs, bases=bases, local_size=size, batches=batches)


class MiniBatchTrainer(Trainer):
    """A :class:`Trainer` that steps one patient cluster at a time (see the
    module docstring).  ``bundle`` is a :class:`GraphBundle` (its host edges
    build the partition) or a graph (its edges are read back once).
    ``balance`` (default ``train.extras.cluster_balance``, else ``edges``)
    picks edge-balanced or equal-patient ranges.  ``clusters``: a partition
    :func:`build_patient_clusters` made for the same graph, masker and
    settings (host tensors), shared by several trainers instead of built
    again.  ``fit``, ``train_epochs``, checkpoints and resume are the base
    class's."""

    def __init__(
        self,
        model,
        bundle,
        masker: EdgeMasker,
        config: Config,
        num_clusters: int,
        host_resident: bool = False,
        balance: Optional[str] = None,
        device=None,
        clusters: Optional[ClusterData] = None,
    ):
        if num_clusters < 1:
            raise ValueError("num_clusters must be >= 1")
        if num_clusters > 1 and not getattr(model, "supports_patient_id_base", False):
            # a model that reads the whole patient table would read cluster
            # 0's rows for every cluster
            raise NotImplementedError(
                f"mini-batch cluster training requires patient_id_base support; "
                f"{type(model).__name__} reads the global patient table"
            )
        if not isinstance(bundle, GraphBundle):
            bundle = GraphBundle(graph=bundle, meta=GraphMeta(), host_edges=host_edges_of(bundle))
        # a batch_size routed from the config may ask for more clusters than
        # there are windows of patients
        limit = max_clusters(bundle.graph.num_nodes(PATIENT))
        if num_clusters > limit:
            logger.warning(
                "Requested %d clusters but only %d WINDOW-aligned patient ranges exist; clamping",
                num_clusters, limit,
            )
            num_clusters = limit
        self.num_clusters = num_clusters
        self.host_resident = bool(host_resident)
        self.cluster_balance = str(balance or config.train.extras.get("cluster_balance") or "edges")
        if self.cluster_balance not in BALANCES:
            raise ValueError(f"balance must be 'edges' or 'patients', got {self.cluster_balance!r}")
        self._bundle = bundle
        self._cluster_data: Optional[ClusterData] = None
        self._prebuilt = clusters
        if clusters is not None and len(clusters.subgraphs) != num_clusters:
            raise ValueError(f"clusters holds {len(clusters.subgraphs)} clusters, not {num_clusters}")
        super().__init__(model, bundle.graph, masker, config, device=device)
        # the side stream host-resident clusters are copied on
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self.host_resident and self.device.type == "cuda" else None
        )

    def _ensure_clusters(self) -> ClusterData:
        """The partition (built on first use): subgraphs on the card, or
        pinned on the host when ``host_resident``; batches on the card."""
        if self._cluster_data is None:
            cd = self._prebuilt or build_patient_clusters(
                self._bundle, self.masker, self.config, self.num_clusters,
                lab_weights=self.host_lab_weights, value_context=self._value_context,
                balance=self.cluster_balance,
            )
            cd = dataclasses.replace(cd)
            if self._copy_stream is not None:
                cd.subgraphs = [g.pin_memory() for g in cd.subgraphs]
            elif not self.host_resident:
                cd.subgraphs = [g.to(self.device) for g in cd.subgraphs]
            cd.batches = {
                split: [(None if b is None else b.to(self.device), pos) for b, pos in entries]
                for split, entries in cd.batches.items()
            }
            self._cluster_data = cd
        return self._cluster_data

    def _fetch(self, host_graph: HeteroGraph):
        """Start copying a pinned cluster graph to the card on the side
        stream: (its device copy, the copy's event)."""
        with torch.cuda.stream(self._copy_stream):
            graph = host_graph.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return graph, done

    def _clusters(self, split: str, order: Sequence[int]) -> Iterator[Tuple[int, HeteroGraph, SplitBatch]]:
        """``(k, graph, batch)`` on the trainer's device for each cluster of
        ``order`` with rows in ``split``.  Host-resident clusters arrive by
        the side stream, the next one copying while the caller computes on
        this one: the compute stream waits on the copy's event, every
        copied tensor is recorded on the compute stream, so the allocator
        reuses its memory only after the work queued on it has run, and the
        host waits for the step before the caller's last before it starts a
        copy, so at most three clusters are on the card."""
        cd = self._ensure_clusters()
        ks = [int(k) for k in order if cd.batches[split][int(k)][0] is not None]
        if self._copy_stream is None:
            for k in ks:
                yield k, cd.subgraphs[k].to(self.device), cd.batches[split][k][0]
            return
        compute = torch.cuda.current_stream(self.device)
        pending = self._fetch(cd.subgraphs[ks[0]]) if ks else None
        steps = []  # an event after each step the caller ran
        for i, k in enumerate(ks):
            graph, copied = pending
            compute.wait_event(copied)
            for t in graph.tensors():
                t.record_stream(compute)
            if len(steps) >= 2:
                steps[-2].synchronize()
            pending = self._fetch(cd.subgraphs[ks[i + 1]]) if i + 1 < len(ks) else None
            yield k, graph, cd.batches[split][k][0]
            steps.append(torch.cuda.Event())
            steps[-1].record(compute)

    # -- training ------------------------------------------------------------

    def _epoch_step(self, epoch: int) -> torch.Tensor:
        """One epoch over the clusters in the epoch's permutation; the
        valid-row-weighted mean loss, summed on the device."""
        seed = self.config.train.seed
        order = np.random.default_rng(stream_seed(seed, "cluster_order", epoch)).permutation(self.num_clusters)
        drop_seed = stream_seed(seed, "dropout", epoch)
        total, n = None, 0
        for k, graph, batch in self._clusters("train", order):
            sup = self.masker.supervision_mask(epoch, batch, cluster=k)
            loss = self._seeded_step(batch, sup, fold_in(drop_seed, k), graph)
            contrib = loss * batch.num_valid
            total = contrib if total is None else total + contrib
            n += batch.num_valid
        if total is None:
            return torch.zeros((), device=self.device)
        return total / max(n, 1)

    # -- evaluation ----------------------------------------------------------

    def _eval_loss(self, split: str, state: Optional[dict] = None) -> torch.Tensor:
        """The split's masked loss: the clusters' losses weighted by their
        valid rows."""
        model = self.eval_model(state)
        total, n = None, 0
        for _, graph, batch in self._clusters(split, range(self.num_clusters)):
            preds = self._forward_eval(model, graph, batch)
            contrib = masked_mean_loss(preds, batch.values, batch.valid, self._loss_type, self.axis) * batch.num_valid
            total = contrib if total is None else total + contrib
            n += batch.num_valid
        if total is None:
            return torch.zeros((), device=self.device)
        return total / max(n, 1)

    def predict(self, split: str, state: Optional[dict] = None) -> np.ndarray:
        """Predictions in split order, put back from each cluster's rows."""
        model = self.eval_model(state)
        cd = self._ensure_clusters()
        parts = [
            (k, self._forward_eval(model, graph, batch)[: batch.num_valid])
            for k, graph, batch in self._clusters(split, range(self.num_clusters))
        ]
        out = np.zeros(len(self.masker.split_indices(split)), dtype=np.float32)
        for k, preds in parts:
            out[cd.batches[split][k][1]] = preds.float().cpu().numpy()
        return out
