"""Checkpoints with a true mid-training resume
(``multi_modal_gnn_tpu/training/checkpoint.py``).

A port checkpoint is two files.  ``<path>`` holds plain tensors, written
with ``torch.save`` and read with ``weights_only=True``::

    {"model": live state_dict, "best_model": best state_dict,
     "adam": {parameter name: {"step", "exp_avg", "exp_avg_sq"}}}

or, under ``train.optimizer.type: sgd``, ``"sgd": {parameter name: {"step",
"momentum_buffer"}}`` in place of ``"adam"`` (no buffer at momentum 0).

``<path>.json`` is the sidecar, with the JAX package's fields: ``epoch``,
``best_val_loss``, ``patience_counter``, ``scheduler``, ``history``,
``config_hash``, ``model_hash`` and ``config``.

:func:`load_checkpoint` also reads a checkpoint the JAX package wrote
(flax msgpack of its ``TrainState`` and best state, the same sidecar)
through :func:`load_flax_checkpoint`, with no ``flax`` or ``msgpack``
installed, and the sharded format of a JAX multi-controller run
(``<path>.procNNN.npz``, :func:`load_jax_sharded_checkpoint`).  Under 1-D
data parallelism the port's state is replicated, so rank 0 writes the
port's single-file format.  The 2-D trainer (``parallel/dp2d.py``), whose
patient table is cut over the ranks, writes JAX's sharded format
(:func:`save_sharded_checkpoint` over :func:`jax_state_leaves`), which JAX's
``load_checkpoint_sharded`` reads, and which restores into any other
partition: the reader assembles whole leaves and each trainer keeps its
rows.
"""

from __future__ import annotations

import logging
import zipfile
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.models.convert import flax_paths, state_dict_from_flax
from multi_modal_gnn_tpu_torch.models.layers import global_shapes
from multi_modal_gnn_tpu_torch.utils.io import load_json, save_json
from multi_modal_gnn_tpu_torch.utils.msgpack import flax_restore

logger = logging.getLogger(__name__)

# the per-parameter state each optimizer keeps, by train.optimizer.type;
# "step" counts the updates (JAX's inject_hyperparams count and
# TrainState.step; torch's SGD keeps none, the trainer's SGD adds it)
STATE_KEYS = {"adam": ("step", "exp_avg", "exp_avg_sq"), "sgd": ("step", "momentum_buffer")}
# JAX's optimizer state leaves after inject_hyperparams' count and learning
# rate, each a parameter tree but the counter: ScaleByAdamState; TraceState
JAX_LEAVES = {"adam": ("count", "mu", "nu"), "sgd": ("trace",)}
TORCH_NAMES = {"mu": "exp_avg", "nu": "exp_avg_sq", "trace": "momentum_buffer"}


def _sidecar(path: Path) -> Path:
    return path.with_suffix(path.suffix + ".json")


def _cpu(tree):
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def optimizer_kind(optimizer: torch.optim.Optimizer) -> str:
    """``"adam"`` or ``"sgd"``: the payload key of ``optimizer``'s state."""
    return "sgd" if isinstance(optimizer, torch.optim.SGD) else "adam"


def optimizer_state_by_name(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> Dict:
    """The optimizer's per-parameter state (:data:`STATE_KEYS`) keyed by
    parameter name."""
    keys = STATE_KEYS[optimizer_kind(optimizer)]
    return {
        name: {k: optimizer.state[param][k] for k in keys if k in optimizer.state[param]}
        for name, param in model.named_parameters()
        if param in optimizer.state
    }


def load_optimizer_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer, named: Dict) -> None:
    """Load :func:`optimizer_state_by_name`'s layout into ``optimizer``,
    whose parameters are ``model``'s; every parameter must have its state
    (an SGD buffer is dropped at momentum 0, where torch keeps none)."""
    kind = optimizer_kind(optimizer)
    missing = [name for name, _ in model.named_parameters() if name not in named]
    if missing:
        raise KeyError(f"no {kind} state for {missing}")
    keys = [k for k in STATE_KEYS[kind] if k != "momentum_buffer" or optimizer.defaults["momentum"]]
    index = {id(p): i for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"])}
    state = {
        index[id(param)]: {k: named[name][k] for k in keys}
        for name, param in model.named_parameters()
    }
    optimizer.load_state_dict({"state": state, "param_groups": optimizer.state_dict()["param_groups"]})


def save_checkpoint(path, payload: Dict, metadata: Dict) -> Path:
    """``payload`` (nested dicts of tensors, copied to the host) to
    ``<path>`` and ``metadata`` to ``<path>.json``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_cpu(payload), path)
    save_json(metadata, _sidecar(path))
    logger.info("Saved checkpoint to %s", path)
    return path


def proc_files(path: Path):
    """The ``<path>.procNNN.npz`` files of a sharded JAX checkpoint."""
    return sorted(path.parent.glob(f"{path.name}.proc*.npz"))


def load_checkpoint(path, model: Optional[torch.nn.Module] = None) -> Tuple[Dict, Dict]:
    """``(payload, metadata)`` of a port checkpoint, or of a JAX one
    (:func:`load_flax_checkpoint`; the sharded format when ``<path>`` is
    absent and its ``.procNNN.npz`` files are there, which needs the
    ``model`` it restores into: :func:`load_jax_sharded_checkpoint`);
    tensors on the CPU."""
    path = Path(path)
    if not path.exists() and proc_files(path):
        if model is None:
            raise ValueError(f"{path} is a sharded JAX checkpoint: pass the model it restores into")
        return load_jax_sharded_checkpoint(path, model)
    if not zipfile.is_zipfile(path):
        return load_flax_checkpoint(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta = load_json(_sidecar(path)) if _sidecar(path).exists() else {}
    logger.info("Loaded checkpoint from %s", path)
    return payload, meta


def _find_optimizer(tree) -> Tuple[Optional[str], Optional[Mapping]]:
    """``(kind, state)``: the ``ScaleByAdamState`` (``count``, ``mu``,
    ``nu``) or SGD's ``TraceState`` (``trace``) inside a flax state dict of
    the JAX optimizer chain, or ``(None, None)``."""
    if isinstance(tree, Mapping):
        for kind, fields in JAX_LEAVES.items():
            if set(fields) <= set(tree):
                return kind, tree
        for value in tree.values():
            found = _find_optimizer(value)
            if found[0] is not None:
                return found
    return None, None


def _named_state(kind: str, step, trees: Mapping[str, Mapping]) -> Dict:
    """JAX's per-parameter optimizer trees (``mu`` / ``nu`` or ``trace``,
    through the weight bridge's names and transposes) and the update count
    as :func:`optimizer_state_by_name`'s layout."""
    step = torch.tensor(float(np.asarray(step)), dtype=torch.float32)
    by_field = {f: state_dict_from_flax({"params": trees[f]}) for f in JAX_LEAVES[kind] if f != "count"}
    first = next(iter(by_field.values()))
    return {
        name: {"step": step.clone(), **{TORCH_NAMES[f]: by_field[f][name] for f in by_field}}
        for name in first
        if not name.endswith("num_batches_tracked")
    }


def _variables(state: Mapping) -> Dict[str, torch.Tensor]:
    return state_dict_from_flax({"params": state["params"], "batch_stats": state.get("batch_stats") or {}})


def load_flax_checkpoint(path) -> Tuple[Dict, Dict]:
    """A checkpoint of the JAX ``Trainer`` (``flax.serialization.to_bytes``
    of ``{"state", "best_state"}`` and its JSON sidecar) as the port's
    ``(payload, metadata)``.  Parameters and BatchNorm statistics go
    through the weight bridge (``models/convert.py``); Adam's ``mu`` /
    ``nu`` (SGD's ``trace``) take the same names and the same transposes,
    and the update count becomes each parameter's ``step`` (payload key
    ``"adam"`` or ``"sgd"``).  The sidecar is returned as JAX wrote
    it: the port's ``Config.model_hash`` equals JAX's for the same config,
    so ``Trainer.restore`` compares the recorded hash itself."""
    path = Path(path)
    tree = flax_restore(path.read_bytes())
    state = tree["state"]
    kind, opt = _find_optimizer(state.get("opt_state"))
    if kind is None or not isinstance(opt[JAX_LEAVES[kind][-1]], Mapping):
        raise ValueError(
            f"{path}: no per-parameter Adam or SGD state (a flattened optimizer, "
            "train.extras.flatten_optimizer) is not read by the port"
        )
    payload = {
        "model": _variables(state),
        "best_model": _variables(tree.get("best_state") or state),
        kind: _named_state(kind, opt["count"] if kind == "adam" else state["step"], opt),
    }
    meta = load_json(_sidecar(path)) if _sidecar(path).exists() else {}
    logger.info("Loaded JAX checkpoint from %s", path)
    return payload, meta


def _nested(paths: List[Tuple[str, ...]], arrays: List[np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, arr in zip(paths, arrays):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = arr
    return tree


def _sharded_leaves(path: Path) -> Tuple[List[np.ndarray], Dict]:
    """Every leaf of a JAX ``save_checkpoint_sharded`` file set, in its
    flatten order, each assembled from the chunks the processes own (keys
    ``"<leaf>||<lo:hi,...>"``, ``"<leaf>||"`` for a scalar, ``"<leaf>||host"``
    for a host value), and the sidecar."""
    files = proc_files(path)
    meta = load_json(_sidecar(path)) if _sidecar(path).exists() else {}
    sharded = meta.get("sharded_checkpoint") or {}
    saved = int(sharded.get("num_processes", 0))
    if saved and len(files) != saved:
        raise ValueError(
            f"sharded checkpoint {path} was written by {saved} processes but only "
            f"{len(files)} .proc*.npz file(s) are present (partial copy, or a host crashed mid-save?)"
        )
    chunks: Dict[int, List[Tuple[str, np.ndarray]]] = {}
    for f in files:
        with np.load(f) as z:
            for key in z.files:
                leaf, _, bounds = key.partition("||")
                chunks.setdefault(int(leaf), []).append((bounds, z[key]))
    n = int(sharded.get("num_leaves", 0)) or (max(chunks) + 1 if chunks else 0)
    leaves = []
    for i in range(n):
        if i not in chunks:
            raise ValueError(f"sharded checkpoint {path} has no chunks for leaf {i}")
        parts = chunks[i]
        if len(parts) == 1 and parts[0][0] in ("", "host"):
            leaves.append(np.asarray(parts[0][1]))
            continue
        spans = [[tuple(map(int, b.split(":"))) for b in bounds.split(",")] for bounds, _ in parts]
        shape = tuple(max(span[d][1] for span in spans) for d in range(len(spans[0])))
        full = np.zeros(shape, parts[0][1].dtype)
        for span, (_, value) in zip(spans, parts):
            full[tuple(slice(lo, hi) for lo, hi in span)] = value
        leaves.append(full)
    return leaves, meta


def load_jax_sharded_checkpoint(path, model: torch.nn.Module) -> Tuple[Dict, Dict]:
    """A checkpoint of a JAX multi-controller run (``save_checkpoint_sharded``
    of the ``Trainer``'s ``{"best_state", "state"}``) as the port's
    ``(payload, metadata)``, for ``model``.

    The files hold leaves by their position in JAX's flatten order, which
    the port rebuilds from ``model``'s flax paths
    (:func:`~multi_modal_gnn_tpu_torch.models.convert.flax_paths`): for
    ``best_state`` then ``state``, the parameters, the BatchNorm
    statistics, the optimizer state (``inject_hyperparams``' count and
    learning rate, then Adam's count, ``mu``, ``nu`` or SGD's ``trace``:
    :data:`JAX_LEAVES`) and the step.  The optimizer is the one whose
    layout has the file's leaf count; every shape (a row-sharded table's
    whole shape, :func:`~multi_modal_gnn_tpu_torch.models.layers.global_shapes`)
    is checked against that layout; the payload holds whole tables."""
    path = Path(path)
    leaves, meta = _sharded_leaves(path)
    params, stats = flax_paths(model)
    p_paths, s_paths = [p for p, _ in params], [p for p, _ in stats]

    def per_state(kind):  # params, stats, 2 counters, the optimizer's leaves, step
        return len(p_paths) + len(s_paths) + 3 + sum(1 if f == "count" else len(p_paths) for f in JAX_LEAVES[kind])

    kinds = [kind for kind in JAX_LEAVES if len(leaves) == 2 * per_state(kind)]
    if not kinds:
        raise ValueError(
            f"{path}: {len(leaves)} leaves, the JAX trainer state of this model has "
            + " or ".join(f"{2 * per_state(k)} ({k})" for k in JAX_LEAVES)
            + " (another model, or another optimizer chain)"
        )
    kind = kinds[0]
    shapes = global_shapes(model)

    def state(leaves):
        i = 0

        def take(paths):
            nonlocal i
            out = leaves[i : i + len(paths)]
            i += len(paths)
            return _nested(paths, out)

        p_tree = take(p_paths)
        s_tree = take(s_paths)
        i += 2  # inject_hyperparams' count and learning rate
        opt = {}
        for f in JAX_LEAVES[kind]:
            if f == "count":
                opt[f] = leaves[i]
                i += 1
            else:
                opt[f] = take(p_paths)
        return {"params": p_tree, "batch_stats": s_tree}, opt, leaves[i]

    n = per_state(kind)
    best, _, _ = state(leaves[:n])
    live, opt, step = state(leaves[n:])
    model_sd = state_dict_from_flax(live)
    for key, value in model_sd.items():
        if key in shapes and tuple(value.shape) != shapes[key]:
            raise ValueError(f"{path}: {key} has shape {tuple(value.shape)}, the model's is {shapes[key]}")
    payload = {
        "model": model_sd,
        "best_model": state_dict_from_flax(best),
        kind: _named_state(kind, opt["count"] if kind == "adam" else step, opt),
    }
    logger.info("Loaded sharded JAX checkpoint from %s (%d files)", path, len(proc_files(path)))
    return payload, meta


# -- writing the sharded format ------------------------------------------------


def _flax_leaf(path: Tuple[str, ...], t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return np.ascontiguousarray(a.T) if path[-1] == "kernel" else a


def jax_state_leaves(
    model: torch.nn.Module, state: Mapping[str, torch.Tensor], named: Mapping, lr: float, kind: str = "adam"
) -> List[Tuple[Optional[str], np.ndarray]]:
    """One JAX ``TrainState`` as ``(state_dict key or None, array)`` pairs
    in its flatten order (:func:`load_jax_sharded_checkpoint`'s layout):
    the parameters in flax's layout, the BatchNorm statistics,
    ``inject_hyperparams``' count and learning rate, the optimizer's leaves
    (``kind`` ``"adam"``: its count, ``mu``, ``nu``; ``"sgd"``: ``trace``)
    and the step.  The counters are the optimizer's step count (int32, as
    JAX keeps them; 0 and zero trees before the first step, after the warm
    start's fresh optimizer, or for SGD's trace at momentum 0); ``named``
    is :func:`optimizer_state_by_name`'s layout, ``state`` a ``state_dict``
    of ``model``'s layout (a row-sharded table holds this rank's rows)."""
    params, stats = flax_paths(model)
    steps = [float(entry["step"]) for entry in named.values() if "step" in entry]
    count = np.asarray(int(max(steps)) if steps else 0, np.int32)
    leaves = [(key, _flax_leaf(path, state[key])) for path, key in params]
    leaves += [(key, _flax_leaf(path, state[key])) for path, key in stats]
    leaves += [(None, count), (None, np.asarray(lr, np.float32))]
    for f in JAX_LEAVES[kind]:
        if f == "count":
            leaves.append((None, count.copy()))
            continue
        for path, key in params:
            value = named.get(key, {}).get(TORCH_NAMES[f])
            leaves.append((key, _flax_leaf(path, torch.zeros_like(state[key]) if value is None else value)))
    leaves.append((None, count.copy()))
    return leaves


def save_sharded_checkpoint(
    path,
    leaves: List[Tuple[Optional[str], np.ndarray]],
    metadata: Dict,
    rank: int,
    world: int,
    rows: Optional[Dict[str, Tuple[int, int]]] = None,
    owns_rows: bool = False,
) -> Path:
    """This rank's ``<path>.procNNN.npz`` of JAX's sharded format
    (``save_checkpoint_sharded``): ``leaves`` (both states'
    :func:`jax_state_leaves`) by position, each chunk written once, by the
    lowest rank that holds it.  A leaf whose key is in ``rows`` holds rows
    ``[lo, hi)`` of its whole array, written by this rank when
    ``owns_rows``; every other leaf is replicated and written by rank 0
    (keys ``"<leaf>||<lo>:<hi>,..."``, ``"<leaf>||"`` for a scalar).  Rank 0
    first removes a stale ``<path>`` and the files of ranks past ``world``,
    and writes the sidecar with ``sharded_checkpoint: {num_processes,
    num_leaves}``.  The caller waits for every rank before a file is read."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rows = rows or {}
    if rank == 0:
        # a single file at <path> would shadow this checkpoint at load
        path.unlink(missing_ok=True)
        for f in proc_files(path):
            if int(f.name[len(path.name) + len(".proc") :].split(".")[0]) >= world:
                f.unlink()
    chunks: Dict[str, np.ndarray] = {}
    for i, (key, value) in enumerate(leaves):
        rest = [f"0:{d}" for d in value.shape[1:]]
        if key in rows:
            if owns_rows:
                lo, hi = rows[key]
                chunks[f"{i}||" + ",".join([f"{lo}:{hi}", *rest])] = value
        elif rank == 0:
            chunks[f"{i}||" + ",".join(f"0:{d}" for d in value.shape)] = value
    np.savez(path.parent / f"{path.name}.proc{rank:03d}.npz", **chunks)
    if rank == 0:
        save_json(
            {**metadata, "sharded_checkpoint": {"num_processes": world, "num_leaves": len(leaves)}}, _sidecar(path)
        )
    logger.info("Saved sharded checkpoint %s (rank %d: %d chunks)", path, rank, len(chunks))
    return path
