"""Checkpoints with a true mid-training resume
(``multi_modal_gnn_tpu/training/checkpoint.py``).

A port checkpoint is two files.  ``<path>`` holds plain tensors, written
with ``torch.save`` and read with ``weights_only=True``::

    {"model": live state_dict, "best_model": best state_dict,
     "adam": {parameter name: {"step", "exp_avg", "exp_avg_sq"}}}

``<path>.json`` is the sidecar, with the JAX package's fields: ``epoch``,
``best_val_loss``, ``patience_counter``, ``scheduler``, ``history``,
``config_hash``, ``model_hash`` and ``config``.

:func:`load_checkpoint` also reads a checkpoint the JAX package wrote
(flax msgpack of its ``TrainState`` and best state, the same sidecar)
through :func:`load_flax_checkpoint`, with no ``flax`` or ``msgpack``
installed.  The sharded multi-controller format is not read.
"""

from __future__ import annotations

import logging
import zipfile
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.models.convert import state_dict_from_flax
from multi_modal_gnn_tpu_torch.utils.io import load_json, save_json
from multi_modal_gnn_tpu_torch.utils.msgpack import flax_restore

logger = logging.getLogger(__name__)

ADAM_KEYS = ("step", "exp_avg", "exp_avg_sq")


def _sidecar(path: Path) -> Path:
    return path.with_suffix(path.suffix + ".json")


def _cpu(tree):
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def adam_state_by_name(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> Dict:
    """The optimizer's per-parameter Adam state keyed by parameter name."""
    return {
        name: {k: optimizer.state[param][k] for k in ADAM_KEYS}
        for name, param in model.named_parameters()
        if param in optimizer.state
    }


def load_adam_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer, named: Dict) -> None:
    """Load :func:`adam_state_by_name`'s layout into ``optimizer``, whose
    parameters are ``model``'s; every parameter must have its state."""
    missing = [name for name, _ in model.named_parameters() if name not in named]
    if missing:
        raise KeyError(f"no Adam state for {missing}")
    index = {id(p): i for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"])}
    state = {
        index[id(param)]: {k: named[name][k] for k in ADAM_KEYS}
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


def load_checkpoint(path) -> Tuple[Dict, Dict]:
    """``(payload, metadata)`` of a port checkpoint, or of a JAX one
    (:func:`load_flax_checkpoint`); tensors on the CPU."""
    path = Path(path)
    if not zipfile.is_zipfile(path):
        return load_flax_checkpoint(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta = load_json(_sidecar(path)) if _sidecar(path).exists() else {}
    logger.info("Loaded checkpoint from %s", path)
    return payload, meta


def _find_adam(tree) -> Mapping:
    """The ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside a flax
    state dict of the JAX optimizer chain."""
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        for value in tree.values():
            found = _find_adam(value)
            if found is not None:
                return found
    return None


def _variables(state: Mapping) -> Dict[str, torch.Tensor]:
    return state_dict_from_flax({"params": state["params"], "batch_stats": state.get("batch_stats") or {}})


def load_flax_checkpoint(path) -> Tuple[Dict, Dict]:
    """A checkpoint of the JAX ``Trainer`` (``flax.serialization.to_bytes``
    of ``{"state", "best_state"}`` and its JSON sidecar) as the port's
    ``(payload, metadata)``.  Parameters and BatchNorm statistics go
    through the weight bridge (``models/convert.py``); Adam's ``mu`` /
    ``nu`` take the same names and the same transposes, and its ``count``
    becomes each parameter's ``step``.  The sidecar is returned as JAX wrote
    it: the port's ``Config.model_hash`` equals JAX's for the same config,
    so ``Trainer.restore`` compares the recorded hash itself."""
    path = Path(path)
    tree = flax_restore(path.read_bytes())
    state = tree["state"]
    adam = _find_adam(state.get("opt_state"))
    if adam is None or not isinstance(adam["mu"], Mapping):
        raise ValueError(
            f"{path}: no per-parameter Adam state (a flattened optimizer, "
            "train.extras.flatten_optimizer, or not adam) is not read by the port"
        )
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    moments = {k: state_dict_from_flax({"params": adam[k]}) for k in ("mu", "nu")}
    payload = {
        "model": _variables(state),
        "best_model": _variables(tree.get("best_state") or state),
        "adam": {
            name: {"step": step.clone(), "exp_avg": mu, "exp_avg_sq": moments["nu"][name]}
            for name, mu in moments["mu"].items()
            if not name.endswith("num_batches_tracked")
        },
    }
    meta = load_json(_sidecar(path)) if _sidecar(path).exists() else {}
    logger.info("Loaded JAX checkpoint from %s", path)
    return payload, meta
