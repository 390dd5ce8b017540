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

``dtype`` (None or ``torch.bfloat16``, the model's compute dtype) is flax's
``Dense(dtype=...)``: parameters stay float32, and a layer with a compute
dtype casts its input, weight and bias to it (:class:`Dense`).  The modules
round where the JAX modules round and nowhere else: BatchNorm returns
float32 (flax promotes a bfloat16 input with its float32 scale), the fused
pair head takes ``w1`` in the compute dtype and ``b1``, ``w2``, ``b2`` in
float32, and a product of a bfloat16 table with a float32 bilinear factor
promotes to float32 (:func:`promoted_mm`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from multi_modal_gnn_tpu_torch.graph.hetero import GatherPlan
from multi_modal_gnn_tpu_torch.graph.schema import PATIENT, PATIENT_LAB
from multi_modal_gnn_tpu_torch.models.context import patient_value_context
from multi_modal_gnn_tpu_torch.ops.pairhead import fused_pair_head
from multi_modal_gnn_tpu_torch.ops.pairhead_kernels import head_widths_supported
from multi_modal_gnn_tpu_torch.ops.segment import take_with_plan


def linear_in(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """flax ``Dense`` with a compute ``dtype``: ``x @ weight.T`` of the
    operands cast to ``dtype`` (float32 sums, rounded to ``dtype``), then the
    bias cast to ``dtype`` added in ``dtype``."""
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``Dense``'s ``dtype``: None computes in the
    parameters' float32; a compute dtype runs :func:`linear_in`.  Parameter
    names and shapes are ``nn.Linear``'s."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        return linear_in(x, self.weight, self.bias, self.compute_dtype)


def promoted_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.matmul`` takes a
    bfloat16 table and a float32 factor (float32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def make_dense(
    out_features: int,
    in_features: int,
    bias: bool = True,
    fan_in_override: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    dtype=None,
) -> Dense:
    """:class:`Dense` (compute ``dtype``) with weight and bias drawn from
    ``U(-1/sqrt(fan), 1/sqrt(fan))``, ``fan = fan_in_override or in_features``
    (the torch-Linear default; the override keeps a split layer's scale)."""
    layer = Dense(in_features, out_features, bias=bias, dtype=dtype)
    bound = 1.0 / math.sqrt(fan_in_override or in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if bias:
            layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


def bilinear_factor(rows: int, rank: int, generator: Optional[torch.Generator] = None) -> nn.Parameter:
    """A ``[rows, rank]`` factor of the low-rank bilinear term, drawn from
    ``N(0, 1 / rows)`` (the flax init's scale); no transpose in the bridge."""
    return nn.Parameter(torch.randn(rows, rank, generator=generator) / math.sqrt(rows))


def patient_rows(table: torch.Tensor, graph) -> torch.Tensor:
    """The rows of the global patient table that ``graph``'s patients read:
    the whole table on a full graph; on a cluster graph
    (``graph.patient_id_base`` set) local row ``i`` reads global row
    ``min(base + i, N - 1)``, so padding patients past the global count
    read the last row (JAX ``rgcn.py:316-322``).  A slice, and the last
    row repeated, where JAX gathers: the same rows and gradients."""
    base = None if graph is None else graph.patient_id_base
    if base is None:
        return table
    end = base + graph.num_nodes(PATIENT)
    if end <= table.shape[0]:
        return table[base:end]
    return torch.cat([table[base:], table[-1:].expand(end - table.shape[0], -1)])


def refuse_cluster_graph(graph) -> None:
    """The serving state is one forward over the full graph (JAX
    ``rgcn.py:547-551``)."""
    if graph.patient_id_base is not None:
        raise ValueError(
            "serving state must be computed on the FULL graph, not a mini-batch cluster "
            "subgraph (patient_id_base is set)"
        )


def shared_bilinear_tables(model: nn.Module, graph) -> Tuple[torch.Tensor, torch.Tensor]:
    """The projected ``[N, rank]`` patient and lab tables of a model's
    shared bilinear term (``bilinear_source`` ``embedding`` or
    ``context``): the raw patient ID table, or each patient's value context
    over the raw lab table, against the raw lab table (JAX
    ``rgcn.py:488-531``, ``hgt.py:331-367``).  On a cluster graph the
    patient table is the cluster's window (:func:`patient_rows`), so the
    batch's local indices read their global rows (JAX offsets the indices
    by the base instead)."""
    lab = model.embed_lab.weight
    if model.bilinear_source == "embedding":
        u = patient_rows(model.embed_patient.weight, graph)
    else:
        u, _ = patient_value_context(lab, graph.edges[PATIENT_LAB])
    return u @ model.bilinear_u, lab @ model.bilinear_l


def take_rows(x: torch.Tensor, idx: torch.Tensor, plan: Optional[GatherPlan]) -> torch.Tensor:
    """:func:`take_with_plan` for tables whose rows K1 takes (whole 16-byte
    chunks: a multiple of 4 float32 or 8 bfloat16 wide); a plain gather for
    narrower or odd ranks."""
    return take_with_plan(x, idx, plan if x.shape[1] % (16 // x.element_size()) == 0 else None)


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
    one.  Without ``train`` it normalises with the running averages.  A
    bfloat16 input is taken as float32 and the output is float32, as flax
    promotes it with its float32 scale and bias.  Parameter and buffer names
    are ``nn.BatchNorm1d``'s."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
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
    flax names (``dense_0`` ... ``dense_out``).

    ``bilinear_rank > 0`` adds ``<h_patient A, h_lab B>`` with ``[D, rank]``
    factors ``bilinear_u`` / ``bilinear_l`` (the ``head`` bilinear source),
    in the promoted dtype and cast to the output's."""

    def __init__(
        self,
        input_dim: int,
        hidden_dims: Sequence[int] = (64, 32),
        output_dim: int = 1,
        dropout: float = 0.2,
        generator: Optional[torch.Generator] = None,
        bilinear_rank: int = 0,
        dtype=None,
    ):
        super().__init__()
        dims = [input_dim, *hidden_dims]
        self.hidden_names = [f"dense_{i}" for i in range(len(hidden_dims))]
        for i, name in enumerate(self.hidden_names):
            self.add_module(name, make_dense(dims[i + 1], dims[i], generator=generator, dtype=dtype))
        self.dense_out = make_dense(output_dim, dims[-1], generator=generator, dtype=dtype)
        self.dropout = float(dropout)
        self.bilinear_rank = int(bilinear_rank)
        if self.bilinear_rank > 0:
            self.bilinear_u = bilinear_factor(input_dim // 2, self.bilinear_rank, generator)
            self.bilinear_l = bilinear_factor(input_dim // 2, self.bilinear_rank, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        pair = x
        for name in self.hidden_names:
            x = F.dropout(F.relu(getattr(self, name)(x)), self.dropout, train)
        out = self.dense_out(x)
        if self.bilinear_rank > 0:
            u, c = pair.chunk(2, dim=-1)
            term = (promoted_mm(u, self.bilinear_u) * promoted_mm(c, self.bilinear_l)).sum(-1, keepdim=True)
            out = out + term.to(out.dtype)
        return out


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
    from the same parameters.

    ``bilinear_rank > 0`` adds ``<x_p[p] A, x_l[l] B>`` (the ``head``
    bilinear source): the node tables are projected to rank width first and
    the narrow rows gathered, through :func:`take_with_plan` where plans are
    given; on the fused path it is added after the kernel's output, as in
    JAX.  The dual-head call (``project_only``) does not carry it: the
    model runs single heads then.

    With a compute ``dtype`` the projections, the unfused MLP and the fused
    kernels' ``w1`` run in it (the fused output stays float32), as in JAX
    (``layers.py:244-292``)."""

    def __init__(
        self,
        node_dim: int,
        hidden_dims: Sequence[int] = (64, 32),
        output_dim: int = 1,
        dropout: float = 0.2,
        generator: Optional[torch.Generator] = None,
        bilinear_rank: int = 0,
        dtype=None,
    ):
        super().__init__()
        h0 = hidden_dims[0]
        fan = 2 * node_dim  # the concat layer's fan-in
        self.proj_patient = make_dense(
            h0, node_dim, fan_in_override=fan, generator=generator, dtype=dtype
        )
        self.proj_lab = make_dense(
            h0, node_dim, bias=False, fan_in_override=fan, generator=generator, dtype=dtype
        )
        self.hidden_names = [f"dense_{i}" for i in range(1, len(hidden_dims))]
        for i, name in enumerate(self.hidden_names, start=1):
            self.add_module(
                name,
                make_dense(hidden_dims[i], hidden_dims[i - 1], generator=generator, dtype=dtype),
            )
        self.dense_out = make_dense(output_dim, hidden_dims[-1], generator=generator, dtype=dtype)
        self.dropout = float(dropout)
        self.bilinear_rank = int(bilinear_rank)
        if self.bilinear_rank > 0:
            self.bilinear_u = bilinear_factor(node_dim, self.bilinear_rank, generator)
            self.bilinear_l = bilinear_factor(node_dim, self.bilinear_rank, generator)

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
        # the fused kernels' w1 [H0, H1], in the projections' dtype (JAX _mlp_pieces)
        w1 = self.dense_1.weight.t().to(proj_p.dtype).contiguous()
        if project_only:
            # (proj_p, proj_l, w1 [H0, H1], b1, w2, b2, seed): the JAX
            # ``project_only`` tuple (``layers.py:181-186``), same parameters
            return (
                proj_p.contiguous(), proj_l.contiguous(), w1,
                self.dense_1.bias, self.dense_out.weight[0], self.dense_out.bias, tuple(seed),
            )
        rate = self.dropout if train else 0.0
        if patient_plan is not None and patient_plan.identity and self.fused_widths():
            out = fused_pair_head(
                proj_p.contiguous(), proj_l.contiguous(), w1, self.dense_1.bias,
                self.dense_out.weight[0], self.dense_out.bias,
                l_idx, patient_plan.win_local, patient_plan.win_tile_map, seed, tile_mask,
                patient_plan.lab_block_map, patient_plan.num_windows, rate,
                patient_plan.lab_block_rows, patient_plan.lab_span_mode,
            )[:, None]
        else:
            x = take_with_plan(proj_p, p_idx, patient_plan) + take_with_plan(proj_l, l_idx, lab_plan)
            x = F.dropout(F.relu(x), rate, train)
            for name in self.hidden_names:
                x = F.dropout(F.relu(getattr(self, name)(x)), rate, train)
            out = self.dense_out(x)
        if self.bilinear_rank > 0:
            u = take_rows(promoted_mm(x_p_nodes, self.bilinear_u), p_idx, patient_plan)
            c = take_rows(promoted_mm(x_l_nodes, self.bilinear_l), l_idx, lab_plan)
            out = out + (u * c).sum(-1, keepdim=True).to(out.dtype)
        return out


class PatientEncoder(nn.Module):
    """2 x [Linear, BatchNorm, ReLU, Dropout], then Linear, then L2
    normalisation over the feature axis (flax names ``dense_i``, ``bn_i``),
    as ``jnp.linalg.norm`` computes it under XLA: squares and their sum in
    float32, the sum rounded to the output's dtype (the compute ``dtype``
    when set), its root and the quotient in that dtype."""

    def __init__(
        self,
        hidden_dim: int = 128,
        dropout: float = 0.2,
        use_batch_norm: bool = True,
        generator: Optional[torch.Generator] = None,
        dtype=None,
    ):
        super().__init__()
        self.use_batch_norm = use_batch_norm
        for i in range(2):
            self.add_module(
                f"dense_{i}", make_dense(hidden_dim, hidden_dim, generator=generator, dtype=dtype)
            )
            if use_batch_norm:
                self.add_module(f"bn_{i}", FlaxBatchNorm(hidden_dim))
        self.dense_out = make_dense(hidden_dim, hidden_dim, generator=generator, dtype=dtype)
        self.dropout = float(dropout)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(2):
            x = getattr(self, f"dense_{i}")(x)
            if self.use_batch_norm:
                x = getattr(self, f"bn_{i}")(x, train)
            x = F.dropout(F.relu(x), self.dropout, train)
        x = self.dense_out(x)
        norm = torch.sqrt(x.float().pow(2).sum(-1, keepdim=True).to(x.dtype))
        return x / norm.clamp_min(1e-12)
