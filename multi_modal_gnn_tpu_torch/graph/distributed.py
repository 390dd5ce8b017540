"""The sharded graph artifact (``multi_modal_gnn_tpu/graph/distributed.py``),
in the JAX package's on-disk format, written and read with numpy and json:

* ``<path>.common.npz`` — the replicated arrays every rank reads
  (each relation's ``dst_count`` and ``row_ptr``, ``patient_lab_degree``);
* ``<path>.shardKKK-of-NNN.npz`` — shard k's chunk of each relation's
  padded ``src`` / ``dst`` / ``mask`` / ``val``, and with ``kernel_plans``
  its per-shard windowed plan (``swin_src``, ``swin_local``, ``swin_tm``);
* ``<path>.meta.json`` — the ``graph.npz`` sidecar with the ``sharded``
  descriptor (and each relation's ``shard_win_*`` entries).

The chunks line up with the data-parallel layout (``parallel/sharding.py``):
:func:`load_graph_distributed` gives a rank its shard of the graph, reading
only the shard files its rows lie in (and every shard's patient->lab
columns, the masker's input, as JAX reads them).  A world size other than
the saved shard count loads elastically: each rank's rows come from the
file segments that cover them, and the saved kernel plans, a layout for
their shard count, are dropped with a warning
(:func:`~multi_modal_gnn_tpu_torch.parallel.sharding.attach_shard_plans`
rebuilds plans for the world size).
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.graph.build import GraphBundle, GraphMeta
from multi_modal_gnn_tpu_torch.graph.hetero import EdgeSet, HeteroGraph, build_sharded_window_plans
from multi_modal_gnn_tpu_torch.graph.schema import PATIENT_LAB, EdgeTypeKey
from multi_modal_gnn_tpu_torch.utils.io import load_json, save_json

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
_SEP = "||"
_PLAN = ("shard_win_src", "shard_win_local", "shard_win_tile_map")


def _base(path) -> Path:
    path = Path(path)
    return path.with_suffix("") if path.suffix == ".npz" else path


def shard_path(base: Path, k: int, n: int) -> Path:
    return base.parent / f"{base.name}.shard{k:03d}-of-{n:03d}.npz"


def attach_relation_plans(graph: HeteroGraph, num_shards: int) -> HeteroGraph:
    """``graph`` with each relation's ``build_sharded_window_plans`` of its
    own valid edges (its padded arrays are dst-sorted with padding last, so
    their first ``num_valid`` entries are the sorted valid edges): the plans
    the artifact stores (JAX ``save_graph_sharded(kernel_plans=True)``), so
    a loaded shard equals ``parallel.sharding.graph_shard`` of this graph."""
    edges = {}
    for et, es in graph.edges.items():
        n = es.num_valid
        sh_src, sh_local, sh_tm, sh_off, k_max = build_sharded_window_plans(
            es.src[:n].cpu().numpy().astype(np.int32), es.dst[:n].cpu().numpy().astype(np.int32),
            es.num_dst, num_shards,
        )
        edges[et] = dataclasses.replace(
            es, shard_win_src=torch.from_numpy(sh_src), shard_win_local=torch.from_numpy(sh_local),
            shard_win_tile_map=torch.from_numpy(sh_tm), shard_win_offset=torch.from_numpy(sh_off),
            shard_win_windows=int(k_max),
        )
    return dataclasses.replace(graph, edges=edges)


def save_graph_sharded(bundle: GraphBundle, path, num_shards: int, kernel_plans: bool = False) -> Path:
    """Write ``bundle`` as ``num_shards`` edge-chunk files and the common
    arrays (module docstring); ``num_shards`` must divide every relation's
    padded edge length."""
    base = _base(path)
    base.parent.mkdir(parents=True, exist_ok=True)
    graph = bundle.graph
    common: Dict[str, np.ndarray] = {"patient_lab_degree": graph.patient_lab_degree.cpu().numpy()}
    shards: List[Dict[str, np.ndarray]] = [dict() for _ in range(num_shards)]
    edge_index = []
    plans = attach_relation_plans(graph, num_shards).edges if kernel_plans else None
    for et, es in graph.edges.items():
        key = _SEP.join(et)
        e_pad = int(es.src.shape[0])
        if e_pad % num_shards:
            raise ValueError(
                f"Edge padding of {et} ({e_pad}) not divisible by num_shards={num_shards}; "
                "raise graph.edge_pad_multiple"
            )
        entry = {
            "edge_type": list(et), "num_valid": es.num_valid, "num_src": es.num_src,
            "num_dst": es.num_dst, "has_val": es.val is not None, "num_padded": e_pad,
        }
        common[f"{key}{_SEP}dst_count"] = es.dst_count.cpu().numpy()
        common[f"{key}{_SEP}row_ptr"] = es.row_ptr.cpu().numpy()
        chunk = e_pad // num_shards
        cols = {"src": es.src, "dst": es.dst, "mask": es.mask}
        if es.val is not None:
            cols["val"] = es.val
        cols = {name: t.cpu().numpy() for name, t in cols.items()}
        for k in range(num_shards):
            for col, arr in cols.items():
                shards[k][f"{key}{_SEP}{col}"] = arr[k * chunk : (k + 1) * chunk]
        if kernel_plans:
            planned = plans[et]
            sh_src, sh_local, sh_tm = (getattr(planned, name).numpy() for name in _PLAN)
            sh_off, k_max = planned.shard_win_offset.numpy(), planned.shard_win_windows
            slot_chunk, tile_chunk = len(sh_src) // num_shards, len(sh_tm) // num_shards
            for k in range(num_shards):
                shards[k][f"{key}{_SEP}swin_src"] = sh_src[k * slot_chunk : (k + 1) * slot_chunk]
                shards[k][f"{key}{_SEP}swin_local"] = sh_local[k * slot_chunk : (k + 1) * slot_chunk]
                shards[k][f"{key}{_SEP}swin_tm"] = sh_tm[k * tile_chunk : (k + 1) * tile_chunk]
            entry.update(
                shard_win_windows=int(k_max), shard_win_offsets=[int(o) for o in sh_off],
                shard_win_slot_len=int(slot_chunk), shard_win_tile_len=int(tile_chunk),
            )
        edge_index.append(entry)
    np.savez_compressed(base.parent / f"{base.name}.common.npz", **common)
    for k in range(num_shards):
        np.savez_compressed(shard_path(base, k, num_shards), **shards[k])
    save_json(
        {
            "format_version": 1,
            "sharded": {"num_shards": num_shards, "axis": DATA_AXIS},
            "node_counts": dict(graph.node_counts),
            "edges": edge_index,
            "meta": bundle.meta.to_dict(),
        },
        base.with_suffix(".meta.json"),
    )
    logger.info("Saved graph as %d shards under %s.*", num_shards, base)
    return base


class _ShardFiles:
    """The artifact's shard files, each opened once and only when read."""

    def __init__(self, base: Path, num_shards: int):
        self.base, self.num_shards = base, num_shards
        self._opened: Dict[int, Dict[str, np.ndarray]] = {}

    def column(self, k: int, name: str) -> np.ndarray:
        if k not in self._opened:
            with np.load(shard_path(self.base, k, self.num_shards)) as f:
                self._opened[k] = {n: f[n] for n in f.files}
        return self._opened[k][name]

    def rows(self, name: str, length: int, lo: int, hi: int, dtype) -> np.ndarray:
        """Rows ``[lo, hi)`` of a column of global ``length``, from the
        saved chunks that cover them."""
        saved = length // self.num_shards
        parts = []
        for k in range(lo // saved, -(-hi // saved)):
            seg = self.column(k, name)
            if seg.dtype != dtype:
                raise ValueError(
                    f"shard {k}: expected dtype {np.dtype(dtype)}, file holds {seg.dtype} "
                    "(artifact written by an incompatible version?)"
                )
            parts.append(seg[max(lo - k * saved, 0) : min(hi - k * saved, saved)])
        return parts[0] if len(parts) == 1 else np.concatenate(parts)


def load_graph_distributed(path, rank: int, world_size: int, load_host_patient_lab: bool = True) -> GraphBundle:
    """Rank ``rank``'s shard of the artifact at ``path`` for a world of
    ``world_size`` ranks, on the CPU: a bundle whose graph's edge sets are
    the rank's chunks, as :func:`~multi_modal_gnn_tpu_torch.parallel.sharding.graph_shard`
    cuts them (with the saved per-shard plans when the shard counts match),
    and, with ``load_host_patient_lab``, the valid patient->lab ``(src,
    dst, val)`` of every shard (the masker's input)."""
    base = _base(path)
    sidecar = load_json(base.with_suffix(".meta.json"))
    sh = sidecar.get("sharded")
    if not sh:
        raise ValueError(f"{base}.meta.json has no 'sharded' descriptor; use load_graph")
    num_shards = int(sh["num_shards"])
    elastic = num_shards != world_size
    with np.load(base.parent / f"{base.name}.common.npz") as f:
        common = {k: f[k] for k in f.files}
    files = _ShardFiles(base, num_shards)

    edges: Dict[EdgeTypeKey, EdgeSet] = {}
    host_edges: Optional[Dict] = {} if load_host_patient_lab else None
    for entry in sidecar["edges"]:
        et = tuple(entry["edge_type"])
        key = _SEP.join(et)
        e_pad = int(entry["num_padded"])
        if e_pad % world_size:
            raise ValueError(f"axis length {e_pad} not divisible by mesh axis '{DATA_AXIS}' ({world_size} devices)")
        chunk = e_pad // world_size
        lo, hi = rank * chunk, (rank + 1) * chunk

        def col(name, dtype, key=key, e_pad=e_pad, lo=lo, hi=hi):
            return torch.from_numpy(np.ascontiguousarray(files.rows(f"{key}{_SEP}{name}", e_pad, lo, hi, dtype)))

        num_valid = int(entry["num_valid"])
        n_valid = int(min(max(num_valid - lo, 0), chunk))
        row_ptr = np.clip(common[f"{key}{_SEP}row_ptr"].astype(np.int64) - lo, 0, n_valid).astype(np.int32)
        plan = {}
        if entry.get("shard_win_windows") and elastic:
            logger.warning(
                "dropping saved %d-shard kernel plans for %s (mesh axis is %d-way); "
                "attach_shard_plans can rebuild them", num_shards, et, world_size,
            )
        elif entry.get("shard_win_windows"):
            first = int(entry["shard_win_offsets"][rank])
            plan = dict(
                shard_win_src=torch.from_numpy(files.column(rank, f"{key}{_SEP}swin_src")),
                shard_win_local=torch.from_numpy(files.column(rank, f"{key}{_SEP}swin_local")),
                shard_win_tile_map=torch.from_numpy(files.column(rank, f"{key}{_SEP}swin_tm")),
                shard_win_offset=torch.tensor([first], dtype=torch.int32),
                shard_win_windows=int(entry["shard_win_windows"]),
                shard_win_first=first,
            )
        edges[et] = EdgeSet(
            src=col("src", np.int32),
            dst=col("dst", np.int32),
            mask=col("mask", np.float32),
            val=col("val", np.float32) if entry["has_val"] else None,
            dst_count=torch.from_numpy(common[f"{key}{_SEP}dst_count"]),
            row_ptr=torch.from_numpy(row_ptr),
            num_valid=n_valid,
            num_src=int(entry["num_src"]),
            num_dst=int(entry["num_dst"]),
            **plan,
        )
        if host_edges is not None and et == PATIENT_LAB:
            # only these columns of every file, read lazily
            srcs, dsts, vals = [], [], []
            for k in range(num_shards):
                with np.load(shard_path(base, k, num_shards)) as z:
                    m = z[f"{key}{_SEP}mask"] > 0
                    srcs.append(z[f"{key}{_SEP}src"][m])
                    dsts.append(z[f"{key}{_SEP}dst"][m])
                    if entry["has_val"]:
                        vals.append(z[f"{key}{_SEP}val"][m])
            host_edges[et] = (np.concatenate(srcs), np.concatenate(dsts), np.concatenate(vals) if vals else None)

    graph = HeteroGraph(
        edges=edges,
        patient_lab_degree=torch.from_numpy(common["patient_lab_degree"]),
        node_counts=tuple(sorted(sidecar["node_counts"].items())),
        lab_names={int(k): v for k, v in (sidecar.get("meta", {}).get("lab_names") or {}).items()},
    )
    logger.info("Loaded shard %d of %d from the %d-shard graph %s.*", rank, world_size, num_shards, base)
    return GraphBundle(graph=graph, meta=GraphMeta.from_dict(sidecar.get("meta", {})), host_edges=host_edges)
