"""ALS and side-information warm starts
(``multi_modal_gnn_tpu/training/warmstart.py``): fit the closed-form
baseline on the train split, then plant it into the model's
``bilinear_source="embedding"`` channel,

    embed_patient[:, :r] = U,   embed_patient[:, r] = 1,   embed_patient[:, r+1:n] = G
    embed_lab[:, :r]     = C,   embed_lab[:, r]     = b,   embed_lab[:, r+1:n]     = H
    bilinear_u = bilinear_l = [I_n; 0]

so that ``<A e_p, B e_l> = <U_p, C_l> + b_l (+ <G_p, H_l>)`` is the
baseline's prediction (``G`` / ``H`` only for :class:`SideInfoALSBaseline`,
whose membership factors come from the dx / rx structure, never from lab
values).  Both heads' output layers are zeroed, so the epoch-0 prediction
IS the baseline's and the heads learn corrections from zero.  The trainer
then gets a fresh optimizer state, ``best_val_loss`` from one validation and
``best_state`` a copy of the planted state, so best-validation selection can
only improve on the baseline.

The plants work on ``state_dict`` s (name -> tensor), as the JAX ones work
on flax parameter trees, and return a new one.  A 2-D trainer
(``parallel/dp2d.py``) hands the plant its whole tables and keeps its rows
(:func:`warm_start_trainer`; JAX ``_plant_preserving_sharding``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.evaluation.baselines import (
    ALSBaseline,
    SideInfoALSBaseline,
    graph_membership_matrix,
)
from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT

logger = logging.getLogger(__name__)

_HEADS = ("edge_predictor", "tabular_mlp")


def _plant(
    state: Dict[str, torch.Tensor],
    patient_cols: list,
    lab_cols: list,
    need: int,
    zero_heads: bool,
    what: str,
) -> Dict[str, torch.Tensor]:
    """A copy of ``state`` with the column blocks written into the first
    ``need`` columns of the ID tables, identity selectors over them, and
    (``zero_heads``) both heads' output layers zeroed."""
    if "bilinear_u" not in state:
        raise ValueError(
            f"{what} plants into the embedding-bilinear channel, which this model has no "
            f"parameters for: it requires edge_head.extras bilinear_rank >= {need} and "
            "bilinear_source='embedding'"
        )
    hidden, rank = state["bilinear_u"].shape
    if rank < need:
        raise ValueError(f"bilinear_rank={rank} < the {need} columns {what} plants; raise edge_head.extras.bilinear_rank")
    if hidden < need:
        raise ValueError(f"hidden_dim={hidden} < the {need} columns {what} plants")
    out = dict(state)
    for key, cols in (("embed_patient.weight", patient_cols), ("embed_lab.weight", lab_cols)):
        table = state[key].clone()
        start = 0
        for block in cols:
            block = torch.as_tensor(np.asarray(block), dtype=table.dtype).to(table.device)
            block = block.reshape(table.shape[0], -1)
            table[:, start : start + block.shape[1]] = block
            start += block.shape[1]
        out[key] = table
    sel = torch.zeros_like(state["bilinear_u"])
    sel[:need, :need] = torch.eye(need, dtype=sel.dtype, device=sel.device)
    out["bilinear_u"], out["bilinear_l"] = sel, sel.clone()
    if zero_heads:
        for key in state:
            if key.split(".")[0] in _HEADS and key.split(".")[1] == "dense_out":
                out[key] = torch.zeros_like(state[key])
    return out


def als_warm_start_params(
    state: Dict[str, torch.Tensor], als: ALSBaseline, scale: float = 1.0, zero_heads: bool = True
) -> Dict[str, torch.Tensor]:
    """``state`` with a fitted :class:`ALSBaseline` planted (``scale``
    multiplies the planted factors; 1 starts exactly at ALS).  Needs
    ``bilinear_rank >= als.rank + 1``: the extra column carries the lab bias."""
    r = als.rank
    ones = np.ones(als.U.shape[0])
    return _plant(
        state, [als.U * scale, ones], [als.C * scale, als.lab_bias * scale], r + 1, zero_heads,
        "the ALS warm start",
    )


def sideinfo_warm_start_params(
    state: Dict[str, torch.Tensor], sideinfo: SideInfoALSBaseline, zero_heads: bool = True
) -> Dict[str, torch.Tensor]:
    """``state`` with a fitted :class:`SideInfoALSBaseline` planted:
    ``[U | 1 | G]`` against ``[C | b | H]``.  Needs ``bilinear_rank >= rank
    + 1 + mem_rank``."""
    need = sideinfo.rank + 1 + sideinfo.mem_rank
    ones = np.ones(sideinfo.U.shape[0])
    return _plant(
        state, [sideinfo.U, ones, sideinfo.G], [sideinfo.C, sideinfo.lab_bias, sideinfo.H], need,
        zero_heads, "the side-information warm start",
    )


def bundle_membership_matrix(bundle) -> np.ndarray:
    """Binary ``[P, D_dx + D_rx]`` membership features of a graph bundle (or
    a graph): :func:`~multi_modal_gnn_tpu_torch.evaluation.graph_membership_matrix`."""
    return graph_membership_matrix(getattr(bundle, "graph", bundle))


def wire_warm_start(config: Config) -> Config:
    """``config`` with the channel ``train.extras.warm_start`` plants into:
    ``bilinear_rank = max(have, rank + 1 (+ mem_rank for sideinfo))`` and
    ``bilinear_source: embedding`` (JAX ``train_pipeline``; it changes
    parameter shapes, which is what opting in means).  Unchanged when the
    config has no warm start or already carries the channel."""
    tc = config.train
    if not tc.warm_start:
        return config
    need = tc.warm_start_rank + 1 + (tc.warm_start_mem_rank if tc.warm_start == "sideinfo" else 0)
    eh = config.model.edge_head
    have = int(eh.extras.get("bilinear_rank", 0))
    if have >= need and eh.extras.get("bilinear_source") == "embedding":
        return config
    logger.info(
        "warm_start=%s: wiring edge_head bilinear channel (bilinear_rank %d -> %d, "
        "bilinear_source=embedding)", tc.warm_start, have, max(have, need),
    )
    extras = {**eh.extras, "bilinear_rank": max(have, need), "bilinear_source": "embedding"}
    model = dataclasses.replace(config.model, edge_head=dataclasses.replace(eh, extras=extras))
    return config.replace(model=model)


def warm_start_trainer(
    trainer,
    rank: int = 8,
    reg: float = 12.0,
    iters: int = 30,
    memberships: Optional[np.ndarray] = None,
    mem_rank: Optional[int] = None,
    ridge_reg: float = 30.0,
    huber_delta: Optional[float] = None,
):
    """Fit ALS on the trainer's train split (with ``memberships``, the binary
    ``[P, D]`` dx / rx features of :func:`bundle_membership_matrix`, the
    stronger :class:`SideInfoALSBaseline`) and plant it into the live model;
    then a fresh optimizer state, ``best_val_loss = validate()`` and
    ``best_state`` a copy of the planted state, which ``fit`` keeps unless
    an epoch beats it.  Returns the fitted baseline.

    The plant is built on whole tables (``trainer.global_state``); each rank
    of a 2-D trainer keeps its rows of the patient factors and clears its
    own optimizer state (JAX ``_plant_preserving_sharding``); every rank fits
    the same ALS on the whole train split."""
    graph = trainer.graph
    tr_p, tr_l, tr_v = trainer.masker.split_arrays("train")
    counts = (graph.num_nodes(PATIENT), graph.num_nodes(LAB))
    # whole tables: the 2-D trainer's patient table is cut over its model axis
    state = trainer.global_state()
    if memberships is not None:
        baseline = SideInfoALSBaseline(
            *counts, rank=rank, mem_rank=mem_rank, reg=reg, ridge_reg=ridge_reg, iters=iters,
            huber_delta=huber_delta,
        ).fit(tr_v, tr_p, tr_l, memberships)
        planted = sideinfo_warm_start_params(state, baseline)
    else:
        baseline = ALSBaseline(*counts, rank=rank, reg=reg, iters=iters, huber_delta=huber_delta).fit(
            tr_v, tr_p, tr_l
        )
        planted = als_warm_start_params(state, baseline)
    trainer.load_global_state(planted)
    trainer.optimizer.state.clear()  # the optimizer's state starts again from the plant
    trainer.best_val_loss = trainer.validate()
    trainer.best_state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    logger.info(
        "Warm start planted (%s, rank=%d, reg=%.1f, val_loss=%.4f)",
        type(baseline).__name__, rank, reg, trainer.best_val_loss,
    )
    return baseline


def warm_start_from_config(trainer, config: Config):
    """Plant the baseline ``config.train.extras.warm_start`` names (``als`` or
    ``sideinfo``) into ``trainer`` with the config's ``warm_start_rank``,
    ``_mem_rank``, ``_reg`` (12), ``_ridge_reg`` (30) and ``_huber_delta``,
    as JAX ``train_pipeline`` reads them.  Returns the fitted baseline, or
    None when the config asks for no warm start."""
    tc = config.train
    if not tc.warm_start:
        return None
    huber = tc.extras.get("warm_start_huber_delta")
    return warm_start_trainer(
        trainer,
        rank=tc.warm_start_rank,
        reg=float(tc.extras.get("warm_start_reg", 12.0)),
        # a data-parallel trainer's graph is its edge shard: the whole one
        memberships=(
            bundle_membership_matrix(getattr(trainer, "full_graph", trainer.graph))
            if tc.warm_start == "sideinfo" else None
        ),
        mem_rank=tc.warm_start_mem_rank,
        ridge_reg=float(tc.extras.get("warm_start_ridge_reg", 30.0)),
        huber_delta=float(huber) if huber is not None else None,
    )
