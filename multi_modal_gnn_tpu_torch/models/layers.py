"""Shared building blocks (``multi_modal_gnn_tpu/models/layers.py``):
the torch-Linear init with a fan-in override, the edge heads and the
patient encoder.  Weights are ``[out, in]`` as in ``torch.nn.Linear``; the
weight bridge (``models/convert.py``) transposes flax ``[in, out]`` kernels.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F


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


def batch_norm(dim: int) -> nn.BatchNorm1d:
    """BatchNorm matching flax ``BatchNorm(momentum=0.9, epsilon=1e-5)``
    in eval mode (flax's momentum 0.9 is torch's 0.1)."""
    return nn.BatchNorm1d(dim, eps=1e-5, momentum=0.1)


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
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.hidden_names:
            x = self.dropout(F.relu(getattr(self, name)(x)))
        return self.dense_out(x)


class FactoredEdgeHead(nn.Module):
    """:class:`EdgeRegressionHead` on ``concat([x_p[p], x_l[l]])`` with its
    first layer split into per-node projections, gathered per pair
    (the unfused path of the JAX head)."""

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
        self.dropout = nn.Dropout(dropout)

    def forward(self, x_p_nodes, x_l_nodes, p_idx, l_idx) -> torch.Tensor:
        proj_p = self.proj_patient(x_p_nodes)
        proj_l = self.proj_lab(x_l_nodes)
        x = self.dropout(F.relu(proj_p[p_idx] + proj_l[l_idx]))
        for name in self.hidden_names:
            x = self.dropout(F.relu(getattr(self, name)(x)))
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
                self.add_module(f"bn_{i}", batch_norm(hidden_dim))
        self.dense_out = make_dense(hidden_dim, hidden_dim, generator=generator)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            x = getattr(self, f"dense_{i}")(x)
            if self.use_batch_norm:
                x = getattr(self, f"bn_{i}")(x)
            x = self.dropout(F.relu(x))
        x = self.dense_out(x)
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / norm.clamp_min(1e-12)
