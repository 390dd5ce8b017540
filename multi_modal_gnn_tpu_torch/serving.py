"""Serving with cached node state (``multi_modal_gnn_tpu/serving.py``).

For a frozen model and graph the node state is constant: it is computed
once by one eval-mode forward over the full graph, and each request runs
only the pair heads on its (patient, lab) batch.  The ``trainer`` entry
points serve the trainer's best validation state once ``fit`` has recorded
one, and its live parameters before that, as the JAX package does;
:func:`compute_node_state` and :func:`build_serving_fn` serve the model
they are given.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from multi_modal_gnn_tpu_torch.graph.hetero import HeteroGraph
from multi_modal_gnn_tpu_torch.models.hgt import HeteroGT
from multi_modal_gnn_tpu_torch.models.rgcn import HeteroRGCN

Model = Union[HeteroRGCN, HeteroGT]


def compute_node_state(model: Model, graph: HeteroGraph) -> Dict[str, torch.Tensor]:
    """Put ``model`` in eval mode and run the forward that fills the state
    (``final_p``, ``final_l``; the RGCN adds ``init_p``, ``init_l`` and
    ``degree``)."""
    model.eval()
    with torch.no_grad():
        return model.compute_node_state(graph)


def _as_index(idx, bound: int, name: str, device) -> torch.Tensor:
    t = torch.as_tensor(idx).to(device=device, dtype=torch.long)
    if t.dim() != 1:
        raise ValueError(f"{name}: expected a 1-D index batch, got shape {tuple(t.shape)}")
    if t.numel() and (int(t.min()) < 0 or int(t.max()) >= bound):
        raise IndexError(f"{name}: indices must lie in [0, {bound})")
    return t


def build_serving_fn(
    model: Model,
    graph: HeteroGraph,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[Callable, Dict[str, torch.Tensor]]:
    """``(fn, state)`` with ``fn(p_idx, l_idx) -> predictions`` computed on
    the state's device from the cached node state."""
    if state is None:
        state = compute_node_state(model, graph)
    device = state["final_p"].device
    num_p, num_l = state["final_p"].shape[0], state["final_l"].shape[0]

    def fn(p_idx, l_idx) -> torch.Tensor:
        p = _as_index(p_idx, num_p, "patient", device)
        l = _as_index(l_idx, num_l, "lab", device)
        if p.shape != l.shape:
            raise ValueError(f"patient/lab batches differ in length: {p.shape} vs {l.shape}")
        with torch.no_grad():
            return model.predict_pairs_cached(state, p, l)

    return fn, state


def serving_model(trainer) -> Model:
    """The model a trainer serves, in eval mode: its best validation state
    once ``fit`` has recorded one, else the live parameters (JAX
    ``serving._serving_variables``)."""
    return trainer.eval_model(trainer.best_state)


def compute_trainer_state(trainer) -> Dict[str, torch.Tensor]:
    """:func:`compute_node_state` of the model the trainer serves."""
    return compute_node_state(serving_model(trainer), trainer.graph)


def build_trainer_serving_fn(
    trainer, state: Optional[Dict[str, torch.Tensor]] = None
) -> Tuple[Callable, Dict[str, torch.Tensor]]:
    """:func:`build_serving_fn` over the model the trainer serves (its best
    state once ``fit`` has recorded one), as JAX ``build_serving_fn(trainer)``."""
    return build_serving_fn(serving_model(trainer), trainer.graph, state)


def predict_patient(fn: Callable, patient: int, num_labs: int) -> torch.Tensor:
    """Predictions of every lab for one patient."""
    labs = torch.arange(num_labs)
    return fn(torch.full_like(labs, int(patient)), labs)
