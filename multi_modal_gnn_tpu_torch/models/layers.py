"""Shared building blocks (``multi_modal_gnn_tpu/models/layers.py``):
the torch-Linear init with a fan-in override, flax-semantics BatchNorm, the
edge heads and the patient encoder.  Weights are ``[out, in]`` as in
``torch.nn.Linear``; the weight bridge (``models/convert.py``) transposes
flax ``[in, out]`` kernels.

As in the JAX package, every forward takes ``train`` explicitly: it turns
on dropout and batch statistics (which also update BatchNorm's running
averages).  Edge-head dropout on the fused path draws from the kernels'
counter-based generator with the caller's ``seed``; every other dropout
draws from torch's generator.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from multi_modal_gnn_tpu_torch.graph.hetero import GatherPlan
from multi_modal_gnn_tpu_torch.ops.pairhead import fused_pair_head
from multi_modal_gnn_tpu_torch.ops.pairhead_kernels import head_widths_supported
from multi_modal_gnn_tpu_torch.ops.segment import take_with_plan


def make_dense(
    out_features: int,
    in_features: int,
    bias: bool = True,
    fan_in_override: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> nn.Linear:
    """``nn.Linear`` with weight and bias drawn from
    ``U(-1/sqrt(fan), 1/sqrt(fan))``, ``fan = fan_in_override or in_features``
    (the torch-Linear default; the override keeps a split layer's scale)."""
    layer = nn.Linear(in_features, out_features, bias=bias)
    bound = 1.0 / math.sqrt(fan_in_override or in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if bias:
            layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


ACTIVATIONS: dict[str, Callable] = {
    "relu": F.relu,
    "elu": F.elu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
}


def get_activation(name: str) -> Callable:
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"Unknown activation: {name}") from None


class FlaxBatchNorm(nn.BatchNorm1d):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` over the rows of
    ``[N, C]``.  With ``train`` it normalises with the batch mean and the
    biased batch variance ``E[x^2] - E[x]^2`` (clipped at 0, flax's fast
    variance) and moves the running averages 0.1 of the way to them, the
    variance included: ``nn.BatchNorm1d`` would move it towards the unbiased
    one.  Without ``train`` it normalises with the running averages.
    Parameter and buffer names are ``nn.BatchNorm1d``'s."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps
            )
        mean = x.mean(dim=0)
        var = ((x * x).mean(dim=0) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class EdgeRegressionHead(nn.Module):
    """MLP over concatenated ``[h_patient; h_lab]``: per hidden layer
    Linear -> ReLU -> Dropout, then a final Linear.  Submodules keep the
    flax names (``dense_0`` ... ``dense_out``)."""

    def __init__(
        self,
        input_dim: int,
        hidden_dims: Sequence[int] = (64, 32),
        output_dim: int = 1,
        dropout: float = 0.2,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dims = [input_dim, *hidden_dims]
        self.hidden_names = [f"dense_{i}" for i in range(len(hidden_dims))]
        for i, name in enumerate(self.hidden_names):
            self.add_module(name, make_dense(dims[i + 1], dims[i], generator=generator))
        self.dense_out = make_dense(output_dim, dims[-1], generator=generator)
        self.dropout = float(dropout)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for name in self.hidden_names:
            x = F.dropout(F.relu(getattr(self, name)(x)), self.dropout, train)
        return self.dense_out(x)


class FactoredEdgeHead(nn.Module):
    """:class:`EdgeRegressionHead` on ``concat([x_p[p], x_l[l]])`` with its
    first layer split into per-node projections, gathered per pair.

    With a slot-major batch (an identity ``patient_plan``) and the widths the
    kernels take (:meth:`fused_widths`: the (64, 32) head with one output),
    the MLP after the projections runs in the fused pair-head kernels
    (``ops/pairhead.py``), tile-masked by ``tile_mask`` and with dropout drawn
    from ``seed``; other widths take the unfused head, where the JAX kernel
    takes any widths.  Otherwise the projections are gathered per pair
    (through :func:`take_with_plan` where plans are given) and the MLP runs
    as torch layers.  ``project_only`` hands the caller the node projections
    and the MLP's pieces instead (``HeteroRGCN``'s dual-head fusion), read
    from the same parameters."""

    def __init__(
        self,
        node_dim: int,
        hidden_dims: Sequence[int] = (64, 32),
        output_dim: int = 1,
        dropout: float = 0.2,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        h0 = hidden_dims[0]
        fan = 2 * node_dim  # the concat layer's fan-in
        self.proj_patient = make_dense(h0, node_dim, fan_in_override=fan, generator=generator)
        self.proj_lab = make_dense(
            h0, node_dim, bias=False, fan_in_override=fan, generator=generator
        )
        self.hidden_names = [f"dense_{i}" for i in range(1, len(hidden_dims))]
        for i, name in enumerate(self.hidden_names, start=1):
            self.add_module(
                name, make_dense(hidden_dims[i], hidden_dims[i - 1], generator=generator)
            )
        self.dense_out = make_dense(output_dim, hidden_dims[-1], generator=generator)
        self.dropout = float(dropout)

    def fused_widths(self) -> bool:
        """Whether the fused pair-head kernels take this head's widths."""
        return len(self.hidden_names) == 1 and head_widths_supported(
            (self.proj_patient.out_features, self.dense_1.out_features), self.dense_out.out_features
        )

    def forward(
        self,
        x_p_nodes: torch.Tensor,
        x_l_nodes: torch.Tensor,
        p_idx: torch.Tensor,
        l_idx: torch.Tensor,
        train: bool = False,
        patient_plan: Optional[GatherPlan] = None,
        lab_plan: Optional[GatherPlan] = None,
        tile_mask: Optional[torch.Tensor] = None,
        seed: Tuple[int, int] = (0, 0),
        project_only: bool = False,
    ):
        proj_p = self.proj_patient(x_p_nodes)
        proj_l = self.proj_lab(x_l_nodes)
        if project_only:
            # (proj_p, proj_l, w1 [H0, H1], b1, w2, b2, seed): the JAX
            # ``project_only`` tuple (``layers.py:181-186``), same parameters
            return (
                proj_p.contiguous(), proj_l.contiguous(), self.dense_1.weight.t().contiguous(),
                self.dense_1.bias, self.dense_out.weight[0], self.dense_out.bias, tuple(seed),
            )
        rate = self.dropout if train else 0.0
        if patient_plan is not None and patient_plan.identity and self.fused_widths():
            out = fused_pair_head(
                proj_p.contiguous(), proj_l.contiguous(),
                self.dense_1.weight.t().contiguous(), self.dense_1.bias,
                self.dense_out.weight[0], self.dense_out.bias,
                l_idx, patient_plan.win_local, patient_plan.win_tile_map, seed, tile_mask,
                patient_plan.lab_block_map, patient_plan.num_windows, rate,
                patient_plan.lab_block_rows, patient_plan.lab_span_mode,
            )
            return out[:, None]
        x = take_with_plan(proj_p, p_idx, patient_plan) + take_with_plan(proj_l, l_idx, lab_plan)
        x = F.dropout(F.relu(x), rate, train)
        for name in self.hidden_names:
            x = F.dropout(F.relu(getattr(self, name)(x)), rate, train)
        return self.dense_out(x)


class PatientEncoder(nn.Module):
    """2 x [Linear, BatchNorm, ReLU, Dropout], then Linear, then L2
    normalisation over the feature axis (flax names ``dense_i``, ``bn_i``)."""

    def __init__(
        self,
        hidden_dim: int = 128,
        dropout: float = 0.2,
        use_batch_norm: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.use_batch_norm = use_batch_norm
        for i in range(2):
            self.add_module(f"dense_{i}", make_dense(hidden_dim, hidden_dim, generator=generator))
            if use_batch_norm:
                self.add_module(f"bn_{i}", FlaxBatchNorm(hidden_dim))
        self.dense_out = make_dense(hidden_dim, hidden_dim, generator=generator)
        self.dropout = float(dropout)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(2):
            x = getattr(self, f"dense_{i}")(x)
            if self.use_batch_norm:
                x = getattr(self, f"bn_{i}")(x, train)
            x = F.dropout(F.relu(x), self.dropout, train)
        x = self.dense_out(x)
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / norm.clamp_min(1e-12)
