"""Weight bridge: a flax variable tree of the JAX ``HeteroRGCN`` or
``HeteroGT`` -> this port's ``state_dict``.

The port's submodules carry the flax module names, so a flax path
``a/b/leaf`` becomes ``a.b.<torch leaf>``:

=============================  ===========================================
flax leaf                      torch leaf
=============================  ===========================================
``params .../kernel [in,out]``  ``weight [out,in]`` (transposed)
``params .../bias``             ``bias``
``params .../embedding``        ``weight``
``params .../scale`` (BN)       ``weight``, plus ``num_batches_tracked = 0``
``params .../bilinear_u``       ``bilinear_u [hidden, rank]`` (as it is)
``params .../bilinear_l``       ``bilinear_l [hidden, rank]`` (as it is)
``batch_stats .../mean``        ``running_mean``
``batch_stats .../var``         ``running_var``
=============================  ===========================================

The bilinear factors are raw parameters, at the model's root (the
``embedding`` / ``context`` sources) or inside either head (``head``); the
value-context projections ``vctx_patient`` / ``vctx_lab`` are Dense layers.

The per-relation ``conv_<i>/neigh_<key>`` and ``root_<key>`` stay per
relation; the layer folds them at call time, as the JAX layer does.  An HGT
tree (``embed_<type>``, ``hgt_<i>/q_<type>``, ``k_<src__rel__dst>``,
``v_<...>``, ``out_<type>``, ``edge_predictor/dense_<i>``) has no
``batch_stats``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

_PARAM_LEAVES = {
    "kernel": "weight", "bias": "bias", "embedding": "weight", "scale": "weight",
    "bilinear_u": "bilinear_u", "bilinear_l": "bilinear_l",
}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, np.asarray(tree)


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``variables = {"params": ..., "batch_stats": ...}`` as nested mappings
    of arrays (flax ``FrozenDict`` / dicts of numpy or jax arrays)."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(variables["params"]):
        *mods, leaf = path
        if leaf not in _PARAM_LEAVES:
            raise KeyError(f"no torch counterpart for flax param {'/'.join(path)}")
        if leaf == "kernel":
            arr = arr.T
        key = ".".join([*mods, _PARAM_LEAVES[leaf]])
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
        if leaf == "scale":
            out[f"{'.'.join(mods)}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    for path, arr in _leaves(variables.get("batch_stats", {})):
        *mods, leaf = path
        if leaf not in _STAT_LEAVES:
            raise KeyError(f"no torch counterpart for flax batch stat {'/'.join(path)}")
        out[f"{'.'.join(mods)}.{_STAT_LEAVES[leaf]}"] = torch.from_numpy(
            np.array(arr, dtype=np.float32)
        )
    return out


def flax_paths(model: torch.nn.Module) -> Tuple[List[Tuple[Tuple[str, ...], str]], List[Tuple[Tuple[str, ...], str]]]:
    """The flax paths of the JAX twin of ``model``, the bridge run backward:
    ``(params, batch_stats)``, each a list of ``(flax path, state_dict
    key)`` in the order ``jax.tree_util`` flattens the tree (keys sorted at
    every level)."""
    leaf_names = {}
    for name, module in model.named_modules():
        if isinstance(module, torch.nn.Embedding):
            leaf_names[name] = {"weight": "embedding"}
        elif isinstance(module, torch.nn.Linear):
            leaf_names[name] = {"weight": "kernel", "bias": "bias"}
        elif isinstance(module, torch.nn.BatchNorm1d):
            leaf_names[name] = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
        else:  # the bilinear factors, raw parameters of the model or a head
            leaf_names[name] = {"bilinear_u": "bilinear_u", "bilinear_l": "bilinear_l"}
    params, stats = [], []
    for key in model.state_dict():
        mod, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        path = tuple(filter(None, mod.split("."))) + (leaf_names[mod][leaf],)
        (stats if leaf.startswith("running_") else params).append((path, key))
    return sorted(params), sorted(stats)
