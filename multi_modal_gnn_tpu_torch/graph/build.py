"""Graph construction (``multi_modal_gnn_tpu/graph/build.py``), in numpy.

:func:`build_heterogeneous_graph` builds the graph and its host metadata
(:class:`GraphMeta`: node indexers, lab names, raw-value lab stats) from the
preprocess stage's tables, given as dicts of numpy columns;
:func:`build_graph_from_preprocessed` reads those tables from the interim
directory, builds, validates and saves the graph.  Both number the nodes as
the JAX build does.  :func:`number_nodes` does the same numbering on
generator-indexed COO arrays; :func:`assemble_graph` pads, sorts and plans
every enabled relation, then mirrors each two-way one by its reverse;
``patient_lab_degree`` counts each patient's lab edges."""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.graph.hetero import EdgeSet, HeteroGraph, pad_edge_set
from multi_modal_gnn_tpu_torch.graph.indexer import NodeIndexer
from multi_modal_gnn_tpu_torch.graph.schema import (
    CONFIG_EDGE_NAMES,
    DIAGNOSIS,
    LAB,
    MEDICATION,
    PATIENT,
    PATIENT_DIAGNOSIS,
    PATIENT_LAB,
    PATIENT_MEDICATION,
    EdgeTypeKey,
    reverse_edge_type,
)

logger = logging.getLogger(__name__)

# a table: column name -> numpy array, all columns of one length
Table = Dict[str, np.ndarray]


def _first_seen(ids: np.ndarray) -> np.ndarray:
    """The distinct values of ``ids`` in the order they first appear."""
    values, first = np.unique(ids, return_index=True)
    return values[np.argsort(first, kind="stable")]


def number_nodes(
    edge_arrays: Dict[EdgeTypeKey, tuple],
    node_counts: Dict[str, int],
    by_degree: bool = True,
    by_frequency: bool = True,
) -> Tuple[Dict[EdgeTypeKey, tuple], Dict[str, int]]:
    """Renumber the nodes of generator-ordered COO arrays as the JAX graph
    build does (``build_heterogeneous_graph``, ``graph/build.py:140-170``),
    keeping every relation's row order:

    * patients: the whole cohort, by ascending lab degree when
      ``by_degree`` (a stable sort: ties keep the cohort's order), else in
      cohort order;
    * labs: only labs that occur, by descending frequency when
      ``by_frequency`` (pandas' stable ``value_counts``: ties keep first-seen
      order), else in first-seen order;
    * diagnoses and medications: those that occur, in first-seen order.

    Node counts shrink to the entities that occur, as the JAX indexers'; a
    type whose relation is absent from ``edge_arrays`` has no count."""
    p_idx, l_idx, val = edge_arrays[PATIENT_LAB]
    num_p = node_counts[PATIENT]
    p_order = (
        np.argsort(np.bincount(p_idx, minlength=num_p), kind="stable")
        if by_degree else np.arange(num_p)
    )
    l_order = _first_seen(l_idx)
    if by_frequency:
        freq = np.bincount(l_idx, minlength=node_counts[LAB])[l_order]
        l_order = l_order[np.argsort(-freq, kind="stable")]
    orders = {PATIENT: p_order, LAB: l_order}
    for et, nt in ((PATIENT_DIAGNOSIS, DIAGNOSIS), (PATIENT_MEDICATION, MEDICATION)):
        if et in edge_arrays:
            orders[nt] = _first_seen(edge_arrays[et][1])
    new_ids = {}
    for nt, order in orders.items():
        new_ids[nt] = np.full(node_counts[nt], -1, np.int64)
        new_ids[nt][order] = np.arange(len(order))
    out = {
        et: (new_ids[et[0]][src], new_ids[et[2]][dst], v)
        for et, (src, dst, v) in edge_arrays.items()
    }
    return out, {nt: len(order) for nt, order in orders.items()}


def drop_disabled_relations(
    edge_arrays: Dict[EdgeTypeKey, tuple], node_counts: Dict[str, int], config: Config
) -> Tuple[Dict[EdgeTypeKey, tuple], Dict[str, int]]:
    """The relations and node counts the JAX graph build keeps
    (``build_heterogeneous_graph``, ``graph/build.py:199-228``): a relation
    whose ``graph.edge_types.<name>.enabled`` is false is never built
    (``patient_lab``, which carries the targets, raises), and a node type
    left with no nodes or no relation is dropped with its relations."""
    edge_arrays = dict(edge_arrays)
    for name, et in CONFIG_EDGE_NAMES.items():
        etc = config.graph.edge_types.get(name)
        if etc is not None and not etc.enabled:
            if et == PATIENT_LAB:
                raise ValueError(
                    "graph.edge_types.patient_lab.enabled=false: the patient-lab "
                    "relation carries the supervision targets and cannot be disabled"
                )
            logger.info("Relation %s disabled by config", name)
            edge_arrays.pop(et, None)
    connected = {t for et in edge_arrays for t in (et[0], et[2])}
    # a type with no nodes has no embedding table and no relations
    empty = {nt for nt, n in node_counts.items() if n == 0 or nt not in connected}
    if empty:
        logger.info("Dropping empty node types: %s", sorted(empty))
    counts = {nt: n for nt, n in node_counts.items() if nt not in empty}
    kept = {et: arrs for et, arrs in edge_arrays.items() if et[0] in counts and et[2] in counts}
    return kept, counts


def assemble_graph(
    edge_arrays: Dict[EdgeTypeKey, tuple],
    node_counts: Dict[str, int],
    config: Optional[Config] = None,
) -> HeteroGraph:
    """``edge_arrays[et] = (src, dst, val_or_None)`` per forward relation,
    node indices in ``[0, node_counts[type])``.  A relation whose
    ``graph.edge_types.<name>.enabled`` is false is skipped (its node count
    kept; ``patient_lab`` is always built), one with ``bidirectional:
    false`` gets no reverse (JAX ``assemble_graph``).  The graph lives on
    the CPU; move it with ``.to(device)``."""
    gc = (config or Config()).graph
    bidirectional, disabled = {}, set()
    for name, et in CONFIG_EDGE_NAMES.items():
        etc = gc.edge_types.get(name)
        if etc is not None:
            bidirectional[et] = etc.bidirectional
            if not etc.enabled and et != PATIENT_LAB:
                disabled.add(et)
    common = dict(
        pad_multiple=gc.edge_pad_multiple,
        dense_max_bytes=gc.dense_adjacency_max_bytes,
        src_span_rows=gc.src_span_rows,
    )
    edges: Dict[EdgeTypeKey, EdgeSet] = {}
    for et, (src, dst, val) in edge_arrays.items():
        if et in disabled:
            continue
        s_type, _, d_type = et
        edges[et] = pad_edge_set(
            src, dst, num_src=node_counts[s_type], num_dst=node_counts[d_type],
            val=val, **common,
        )
        if bidirectional.get(et, True):
            edges[reverse_edge_type(et)] = pad_edge_set(
                dst, src, num_src=node_counts[d_type], num_dst=node_counts[s_type],
                **common,
            )
    pl_src = np.asarray(edge_arrays[PATIENT_LAB][0], dtype=np.int64)
    degree = np.bincount(pl_src, minlength=node_counts[PATIENT]).astype(np.int32)
    return HeteroGraph(
        edges=edges,
        patient_lab_degree=torch.from_numpy(degree),
        node_counts=tuple(sorted(node_counts.items())),
    )


@dataclass
class GraphMeta:
    """Host metadata that travels with a graph artifact (JAX ``GraphMeta``)."""

    indexers: Dict[str, NodeIndexer] = field(default_factory=dict)
    lab_names: Dict[int, str] = field(default_factory=dict)
    # per-lab-index raw-value stats for denormalization: {idx: {"mean", "std"}}
    lab_stats: Dict[int, Dict[str, float]] = field(default_factory=dict)
    config: Optional[dict] = None
    config_hash: Optional[str] = None

    def to_dict(self) -> dict:
        return {
            "indexers": {k: v.to_dict() for k, v in self.indexers.items()},
            "lab_names": {str(k): v for k, v in self.lab_names.items()},
            "lab_stats": {str(k): v for k, v in self.lab_stats.items()},
            "config": self.config,
            "config_hash": self.config_hash,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "GraphMeta":
        return cls(
            indexers={k: NodeIndexer.from_dict(v) for k, v in d.get("indexers", {}).items()},
            lab_names={int(k): v for k, v in d.get("lab_names", {}).items()},
            lab_stats={int(k): v for k, v in d.get("lab_stats", {}).items()},
            config=d.get("config"),
            config_hash=d.get("config_hash"),
        )


@dataclass
class GraphBundle:
    """A graph, its host metadata and host copies of each relation's valid
    ``(src, dst, val)`` (dst-sorted), so host consumers never read the
    device back."""

    graph: HeteroGraph
    meta: GraphMeta
    host_edges: Optional[Dict[EdgeTypeKey, tuple]] = None

    def replace_graph(self, graph: HeteroGraph) -> "GraphBundle":
        return dataclasses.replace(self, graph=graph)

    def patient_lab_host(self):
        """(src, dst, val) numpy arrays of the valid patient->lab edges."""
        if self.host_edges and PATIENT_LAB in self.host_edges:
            return self.host_edges[PATIENT_LAB]
        return None


def host_edges_of(graph: HeteroGraph) -> Dict[EdgeTypeKey, tuple]:
    """Each relation's valid ``(src, dst, val_or_None)`` as numpy arrays."""
    out = {}
    for et, es in graph.edges.items():
        n = es.num_valid
        out[et] = (
            es.src[:n].cpu().numpy(),
            es.dst[:n].cpu().numpy(),
            None if es.val is None else es.val[:n].cpu().numpy(),
        )
    return out


def _map_edges(table: Table, src_col: str, dst_col: str, src_ix: NodeIndexer,
               dst_ix: NodeIndexer, val_col: Optional[str] = None):
    """ID -> index mapping of a table's rows; rows with an unknown ID are
    dropped."""
    src = src_ix.lookup_many(table[src_col])
    dst = dst_ix.lookup_many(table[dst_col])
    keep = (src >= 0) & (dst >= 0)
    vals = None if val_col is None else np.asarray(table[val_col], dtype=np.float32)[keep]
    if (~keep).any():
        logger.warning("Dropped %d edges with unmapped endpoints", int((~keep).sum()))
    return src[keep], dst[keep], vals


def _value_counts_order(values: np.ndarray) -> np.ndarray:
    """The distinct values by descending count, ties in first-seen order
    (pandas ``value_counts``)."""
    uniq, first, counts = np.unique(values, return_index=True, return_counts=True)
    seen = np.argsort(first, kind="stable")
    return uniq[seen][np.argsort(-counts[seen], kind="stable")]


def _lab_stats(lab_idx: np.ndarray, values: np.ndarray) -> Dict[int, Dict[str, float]]:
    """Per-lab mean and sample std (0 for a single value) of the raw values,
    summed in float64 and rounded to the values' dtype, as pandas' grouped
    ``agg(["mean", "std"])`` gives them."""
    stats = {}
    order = np.argsort(lab_idx, kind="stable")
    labs, starts = np.unique(lab_idx[order], return_index=True)
    for lab, group in zip(labs, np.split(values[order], starts[1:])):
        wide = group.astype(np.float64)
        std = wide.std(ddof=1) if len(group) > 1 else 0.0
        stats[int(lab)] = {
            "mean": float(values.dtype.type(wide.mean())), "std": float(values.dtype.type(std)),
        }
    return stats


def build_heterogeneous_graph(
    labs: Table,
    diagnoses: Optional[Table],
    medications: Optional[Table],
    cohort: Table,
    labitems: Optional[Table],
    config: Config,
) -> GraphBundle:
    """The 4-node-type / 6-relation graph from the preprocessed tables
    (JAX ``build_heterogeneous_graph``): patients of the cohort (by
    ascending lab degree under ``cluster_patients_by_degree``), labs by
    descending frequency under ``cluster_labs_by_frequency``, diagnoses and
    medications in first-seen order.  Relations disabled in
    ``graph.edge_types`` are not built (``patient_lab`` raises); node types
    left without nodes or relations are dropped with their relations.  The
    graph lives on the CPU."""
    diagnoses = diagnoses or {"SUBJECT_ID": np.zeros(0, np.int64), "ICD3_CODE": np.zeros(0, str)}
    medications = medications or {"SUBJECT_ID": np.zeros(0, np.int64), "DRUG": np.zeros(0, str)}
    indexers = {nt: NodeIndexer(nt) for nt in (PATIENT, LAB, DIAGNOSIS, MEDICATION)}
    cohort_ids = np.asarray(cohort["SUBJECT_ID"])
    lab_subjects = np.asarray(labs["SUBJECT_ID"])
    if config.graph.cluster_patients_by_degree and len(cohort_ids):
        # ascending lab degree, ties in cohort order: the gate's low-degree
        # patients share the leading windows (layout only)
        subjects, degree = np.unique(lab_subjects, return_counts=True)
        degree_of = dict(zip(subjects.tolist(), degree.tolist()))
        key = np.asarray([degree_of.get(s, 0) for s in cohort_ids.tolist()])
        cohort_ids = cohort_ids[np.argsort(key, kind="stable")]
    indexers[PATIENT].add_many(cohort_ids)
    if config.graph.cluster_labs_by_frequency and len(labs["ITEMID"]):
        indexers[LAB].add_many(_value_counts_order(np.asarray(labs["ITEMID"])))
    indexers[LAB].add_many(labs["ITEMID"])
    if len(diagnoses["ICD3_CODE"]):
        indexers[DIAGNOSIS].add_many(diagnoses["ICD3_CODE"])
    if len(medications["DRUG"]):
        indexers[MEDICATION].add_many(medications["DRUG"])
    counts = {nt: len(ix) for nt, ix in indexers.items()}
    logger.info("Node counts: %s", counts)

    edge_arrays: Dict[EdgeTypeKey, tuple] = {
        PATIENT_LAB: _map_edges(
            labs, "SUBJECT_ID", "ITEMID", indexers[PATIENT], indexers[LAB], "VALUE_NORMALIZED"
        ),
        PATIENT_DIAGNOSIS: _map_edges(
            diagnoses, "SUBJECT_ID", "ICD3_CODE", indexers[PATIENT], indexers[DIAGNOSIS]
        ),
        PATIENT_MEDICATION: _map_edges(
            medications, "SUBJECT_ID", "DRUG", indexers[PATIENT], indexers[MEDICATION]
        ),
    }
    edge_arrays, counts = drop_disabled_relations(edge_arrays, counts, config)
    graph = assemble_graph(edge_arrays, counts, config)

    label_by_item = {}
    if labitems is not None and len(labitems["ITEMID"]):
        label_by_item = dict(zip(np.asarray(labitems["ITEMID"]).tolist(),
                                 [str(x) for x in labitems["LABEL"]]))
    lab_names = {
        idx: str(label_by_item.get(item_id, f"Lab_{idx}"))
        for item_id, idx in indexers[LAB].id_to_index.items()
    }
    lab_stats = {}
    if "VALUE" in labs:
        lab_stats = _lab_stats(
            indexers[LAB].lookup_many(labs["ITEMID"]), np.asarray(labs["VALUE"])
        )
    graph.lab_names = lab_names
    meta = GraphMeta(
        indexers=indexers, lab_names=lab_names, lab_stats=lab_stats,
        config=config.to_dict(), config_hash=config.content_hash(),
    )
    return GraphBundle(graph=graph, meta=meta, host_edges=host_edges_of(graph))


def build_graph_from_preprocessed(interim_dir, config: Config, output_path=None) -> GraphBundle:
    """Read the preprocess stage's tables (``<interim_dir>/<name>.npz``),
    build, validate and, with ``output_path``, save the graph (JAX
    ``build_graph_from_preprocessed``)."""
    from multi_modal_gnn_tpu_torch.data.preprocess import load_table
    from multi_modal_gnn_tpu_torch.graph.serialize import save_graph
    from multi_modal_gnn_tpu_torch.graph.stats import compute_graph_statistics, validate_graph

    interim = Path(interim_dir)

    def optional(name):
        path = interim / f"{name}.npz"
        return load_table(path) if path.exists() else None

    bundle = build_heterogeneous_graph(
        load_table(interim / "labs_normalized.npz"), optional("diagnoses"),
        optional("medications"), load_table(interim / "cohort.npz"), optional("labitems"), config,
    )
    validate_graph(bundle.graph)
    logger.info("Graph statistics: %s", compute_graph_statistics(bundle.graph))
    if output_path is not None:
        save_graph(bundle, output_path)
        # graph.extras.num_shards > 1 also writes the sharded artifact next
        # to it, <output_path>_sharded.* (JAX build.py:401-418), with the
        # per-shard K1 plans under graph.extras.shard_kernel_plans (default
        # model.use_pallas)
        n_shards = int(config.graph.extras.get("num_shards", 0) or 0)
        if n_shards > 1:
            from multi_modal_gnn_tpu_torch.graph.distributed import save_graph_sharded

            base = Path(output_path)
            base = base.with_suffix("") if base.suffix == ".npz" else base
            save_graph_sharded(
                bundle, base.parent / f"{base.name}_sharded", num_shards=n_shards,
                kernel_plans=bool(config.graph.extras.get("shard_kernel_plans", config.model.use_pallas)),
            )
    return bundle
