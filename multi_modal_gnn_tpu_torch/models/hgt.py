"""Heterogeneous graph transformer (``multi_modal_gnn_tpu/models/hgt.py``).

Typed multi-head attention over the same ID-embedding tables as the RGCN:
per destination type, one softmax over the incoming edges of every relation
into it, of ``q_dst . k_rel / sqrt(dh)`` per head, weighting ``v_rel``; then
``gelu(out_dst(agg)) + x_dst``.  Submodules keep the flax names
(``embed_<type>``, ``hgt_<i>``, ``q_<type>``, ``k_<src__rel__dst>``,
``v_<...>``, ``out_<type>``, ``edge_predictor``), so the weight bridge maps
parameters one for one.

Three interchangeable tiers per destination group, as in the JAX layer:

* ``dense`` — every relation into the group has a dense adjacency and the
  joint logits fit ``dense_attn_max_bytes``: one masked softmax over the
  concatenated source spaces, with duplicate edges weighted by their
  multiplicity;
* ``flash`` — ``impl="pallas"``, the graph carries an attention plan for
  the group (``graph/attn_plan.py``) and the kernels take the layer's head
  widths (:func:`~multi_modal_gnn_tpu_torch.ops.attention_kernels.heads_supported`):
  the K6 / K7 / K8 kernels
  (``ops/attention.py``) over the relations' projections stacked in
  ``plan.rel_keys`` order;
* ``segment`` — per-edge gathers and :func:`segment_softmax`, plain PyTorch.

Under edge-sharded data parallelism (``axis``, as the RGCN's) every group
takes the segment tier, over the rank's edges: the softmax's maximum is
all-reduced (MAX), then its sums, then the aggregate (JAX ``hgt.py:59-91``,
``:200-208``); the dense and flash tiers do not shard, as in JAX.  The head
runs on the rank's batch shard, its dropout from the rank's own stream.

The RGCN's quality channels come with the same fields and meaning
(``value_context``, ``bilinear_rank``, ``bilinear_source``; see
``models/rgcn.py``): the value context is added to the ID embeddings before
layer 0, and the shared bilinear term reads the raw ID tables.  JAX's HGT
takes ``model.compute_dtype`` only in its value-context projections
(``hgt.py:285-291``), and so does this one (``dtype``): they compute in it,
and their bfloat16 output added to the float32 features gives float32, as
JAX promotes the sum; everything else is the float32 program.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from multi_modal_gnn_tpu_torch.config import BILINEAR_SOURCES
from multi_modal_gnn_tpu_torch.graph.hetero import HeteroGraph
from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT, EdgeTypeKey
from multi_modal_gnn_tpu_torch.models.context import inject_value_context
from multi_modal_gnn_tpu_torch.models.rgcn import edge_head_stream
from multi_modal_gnn_tpu_torch.models.layers import (
    EdgeRegressionHead,
    bilinear_factor,
    id_tables,
    make_dense,
    patient_rows,
    refuse_cluster_graph,
    shared_bilinear_tables,
)
from multi_modal_gnn_tpu_torch.ops.attention import flash_attention_group
from multi_modal_gnn_tpu_torch.ops.attention_kernels import heads_supported
from multi_modal_gnn_tpu_torch.ops.segment import segment_softmax, segment_sum
from multi_modal_gnn_tpu_torch.parallel.collectives import all_reduce_sum

# the node types whose final states the heads read
READ_TYPES = (PATIENT, LAB)


def _et_key(et: EdgeTypeKey) -> str:
    return "__".join(et)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation (torch's default is erf)."""
    return F.gelu(x, approximate="tanh")


class HGTLayer(nn.Module):
    """One layer of typed multi-head attention message passing."""

    def __init__(
        self,
        edge_types: Sequence[EdgeTypeKey],
        node_types: Sequence[str],
        hidden_dim: int,
        num_heads: int = 4,
        dense_attn_max_bytes: int = 134_217_728,
        impl: str = "xla",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.edge_types = tuple(edge_types)
        self.node_types = tuple(node_types)
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.dense_attn_max_bytes = dense_attn_max_bytes
        self.impl = impl
        dense = lambda: make_dense(hidden_dim, hidden_dim, generator=generator)  # noqa: E731
        # a type that receives no relation passes through unchanged and has
        # no q / out projection (flax creates none for a projection never called)
        receivers = [nt for nt in self.node_types if nt in self.groups()]
        for nt in receivers:
            self.add_module(f"q_{nt}", dense())
        for kind in ("k", "v"):
            for et in self.edge_types:
                self.add_module(f"{kind}_{_et_key(et)}", dense())
        for nt in receivers:
            self.add_module(f"out_{nt}", dense())

    def groups(self) -> Dict[str, list]:
        """The relations into each destination type, in edge-type order."""
        incoming: Dict[str, list] = {}
        for et in self.edge_types:
            incoming.setdefault(et[2], []).append(et)
        return incoming

    def tier(self, graph: HeteroGraph, dst_t: str, axis=None) -> str:
        """``dense``, ``flash`` or ``segment``: the tier of ``dst_t``'s group.
        Widths K6-K8 do not take (``hidden_dim`` above 128, or a head width
        that is not 4 * 2^n) take the segment tier, where the JAX package's
        flash kernels take any width.  Sharded edges (``axis``) take the
        segment tier."""
        if axis is not None:
            return "segment"
        ets = self.groups()[dst_t]
        if self.dense_attn_max_bytes > 0 and all(graph.edges[et].dense_adj is not None for et in ets):
            total_src = sum(graph.edges[et].dense_adj.shape[1] for et in ets)
            num_dst = graph.num_nodes(dst_t)
            if num_dst * total_src * self.num_heads * 4 <= self.dense_attn_max_bytes:
                return "dense"
        if (
            self.impl == "pallas"
            and graph.attn_plans is not None
            and dst_t in graph.attn_plans
            and heads_supported(self.hidden_dim, self.num_heads)
        ):
            return "flash"
        return "segment"

    def _proj(self, kind: str, key: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"{kind}_{key}")(x)

    def _dense(self, x_dict, graph, ets, q_nodes):
        """Joint masked softmax over the concatenated source spaces.
        ``dense_adj[d, s] = multiplicity / in-degree``; weighting the exp by
        the multiplicity reproduces the per-edge softmax exactly."""
        nh = self.num_heads
        dh = self.hidden_dim // nh
        logits, mult, values = [], [], []
        for et in ets:
            es = graph.edges[et]
            x_src = x_dict[et[0]]
            k = self._proj("k", _et_key(et), x_src).reshape(-1, nh, dh)
            values.append(self._proj("v", _et_key(et), x_src).reshape(-1, nh, dh))
            logits.append(torch.einsum("dhk,shk->dsh", q_nodes, k) / math.sqrt(float(dh)))
            mult.append(es.dense_adj * es.dst_count.clamp_min(1.0)[:, None])
        logits, mult = torch.cat(logits, dim=1), torch.cat(mult, dim=1)
        present = (mult > 0)[..., None]
        logits = torch.where(present, logits, torch.full_like(logits, float("-inf")))
        shift = torch.where(present, logits, torch.full_like(logits, -1e30)).amax(dim=1, keepdim=True)
        logits = logits - shift.detach()
        w = torch.where(present, torch.exp(logits) * mult[..., None], torch.zeros_like(logits))
        attn = w / w.sum(dim=1, keepdim=True).clamp_min(1e-20)
        return torch.einsum("dsh,shk->dhk", attn, torch.cat(values, dim=0))

    def _segment(self, x_dict, graph, ets, q_nodes, num_dst, axis=None):
        nh = self.num_heads
        dh = self.hidden_dim // nh
        logits, values, dsts = [], [], []
        for et in ets:
            es = graph.edges[et]
            x_src = x_dict[et[0]]
            src = es.src.long()
            k = self._proj("k", _et_key(et), x_src).index_select(0, src).reshape(-1, nh, dh)
            values.append(self._proj("v", _et_key(et), x_src).index_select(0, src).reshape(-1, nh, dh))
            # padding edges (dst == num_dst) gather a clamped row and get no mass
            dst = es.dst.clamp_max(es.num_dst - 1).long()
            logit = (q_nodes.index_select(0, dst) * k).sum(-1) / math.sqrt(float(dh))
            logits.append(torch.where(es.mask[:, None] > 0, logit, torch.full_like(logit, float("-inf"))))
            dsts.append(dst)
        logits, dsts = torch.cat(logits), torch.cat(dsts)
        attn = segment_softmax(logits, dsts, num_dst, axis)
        attn = torch.where(torch.isfinite(logits), attn, torch.zeros_like(attn))
        agg = segment_sum(torch.cat(values) * attn[..., None], dsts, num_dst)
        # the ranks' partial sums per destination
        return agg if axis is None else all_reduce_sum(agg, axis)

    def forward(
        self,
        x_dict: Dict[str, torch.Tensor],
        graph: HeteroGraph,
        dst_types: Optional[Sequence[str]] = None,
        axis=None,
    ) -> Dict[str, torch.Tensor]:
        """New states of the destination groups (only ``dst_types``, when
        given); the other node types pass through unchanged."""
        h, nh = self.hidden_dim, self.num_heads
        out: Dict[str, torch.Tensor] = {}
        for dst_t, ets in self.groups().items():
            if dst_types is not None and dst_t not in dst_types:
                continue
            x_dst = x_dict[dst_t]
            num_dst = x_dst.shape[0]
            q = getattr(self, f"q_{dst_t}")(x_dst)
            tier = self.tier(graph, dst_t, axis)
            if tier == "dense":
                agg = self._dense(x_dict, graph, ets, q.reshape(num_dst, nh, h // nh))
            elif tier == "flash":
                plan = graph.attn_plans[dst_t]
                ktab = torch.cat([self._proj("k", _et_key(et), x_dict[et[0]]) for et in plan.rel_keys])
                vtab = torch.cat([self._proj("v", _et_key(et), x_dict[et[0]]) for et in plan.rel_keys])
                agg = flash_attention_group(q, ktab, vtab, plan, nh)
            else:
                agg = self._segment(x_dict, graph, ets, q.reshape(num_dst, nh, h // nh), num_dst, axis)
            out[dst_t] = gelu(getattr(self, f"out_{dst_t}")(agg.reshape(num_dst, h))) + x_dst
        for nt in self.node_types:
            out.setdefault(nt, x_dict[nt])
        return out


class HeteroGT(nn.Module):
    """ID embeddings, ``num_layers`` x :class:`HGTLayer`, and one
    :class:`EdgeRegressionHead` on ``[h_patient; h_lab]``."""

    # cluster graphs' local patients read their window of the global table,
    # as in the RGCN
    supports_patient_id_base = True

    def __init__(
        self,
        node_counts: Tuple[Tuple[str, int], ...],
        edge_types: Sequence[EdgeTypeKey],
        hidden_dim: int = 128,
        num_layers: int = 2,
        num_heads: int = 4,
        dropout: float = 0.2,
        head_hidden_dims: Sequence[int] = (64, 32),
        dense_attn_max_bytes: int = 134_217_728,
        impl: str = "xla",
        bilinear_rank: int = 0,
        bilinear_source: str = "head",
        value_context: bool = False,
        generator: Optional[torch.Generator] = None,
        dtype=None,
        axis=None,
    ):
        super().__init__()
        if bilinear_source not in BILINEAR_SOURCES:
            raise ValueError(f"bilinear_source must be one of {BILINEAR_SOURCES}, got {bilinear_source!r}")
        self.axis = axis
        self.node_counts = tuple(node_counts)
        self.num_layers = num_layers
        self.impl = impl
        self.bilinear_rank = int(bilinear_rank)
        self.bilinear_source = bilinear_source
        self.value_context = bool(value_context)
        # JAX gives the compute dtype only to the value-context projections
        self.compute_dtype = dtype if self.value_context else None
        for nt, n in self.node_counts:
            emb = nn.Embedding(n, hidden_dim)
            bound = math.sqrt(6.0 / (n + hidden_dim))  # xavier-uniform
            with torch.no_grad():
                emb.weight.uniform_(-bound, bound, generator=generator)
            self.add_module(f"embed_{nt}", emb)
        for i in range(num_layers):
            self.add_module(
                f"hgt_{i}",
                HGTLayer(
                    edge_types, self.node_types, hidden_dim, num_heads, dense_attn_max_bytes,
                    impl, generator,
                ),
            )
        head_rank = self.bilinear_rank if bilinear_source == "head" else 0
        self.edge_predictor = EdgeRegressionHead(
            2 * hidden_dim, head_hidden_dims, 1, dropout, generator, head_rank
        )
        if self.shared_bilinear:
            self.bilinear_u = bilinear_factor(hidden_dim, self.bilinear_rank, generator)
            self.bilinear_l = bilinear_factor(hidden_dim, self.bilinear_rank, generator)
        if self.value_context:
            self.vctx_patient = make_dense(hidden_dim, hidden_dim + 1, generator=generator, dtype=dtype)
            self.vctx_lab = make_dense(hidden_dim, hidden_dim + 1, generator=generator, dtype=dtype)

    @property
    def node_types(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.node_counts)

    @property
    def shared_bilinear(self) -> bool:
        return self.bilinear_rank > 0 and self.bilinear_source in ("embedding", "context")

    def unsharded(self) -> "HeteroGT":
        """The model without its data axis, sharing every parameter (JAX
        ``Trainer.serving_model``): for the full graph."""
        twin = copy.copy(self)
        twin.axis = None
        return twin

    def encode_nodes(
        self, train: bool = False, graph: Optional[HeteroGraph] = None, tables: Optional[Dict] = None
    ) -> Dict[str, torch.Tensor]:
        """Every node's ID embedding (JAX ``HeteroGT.encode_nodes``).  On a
        cluster graph the patient rows are the cluster's window of the
        global table, local row ``i`` reading ``min(base + i, N - 1)``
        (:func:`~multi_modal_gnn_tpu_torch.models.layers.patient_rows`), as
        the RGCN's; ``train`` is accepted for the RGCN's signature.
        ``tables``: the ID tables the forward has read (default:
        :func:`~multi_modal_gnn_tpu_torch.models.layers.id_tables`)."""
        x_dict = dict(id_tables(self) if tables is None else tables)
        x_dict[PATIENT] = patient_rows(x_dict[PATIENT], graph)
        return x_dict

    def forward(
        self, graph: HeteroGraph, train: bool = False, tables: Optional[Dict] = None
    ) -> Dict[str, torch.Tensor]:
        """Final node states.  The last layer computes only the groups the
        heads read (:data:`READ_TYPES`): HGT has no BatchNorm, whose
        training statistics would make every group's output a result of the
        step, so under ``jit`` the JAX step drops the other groups as dead
        code too; the other types keep their previous states."""
        x_dict = self.encode_nodes(train, graph, tables)
        if self.value_context:
            x_dict = inject_value_context(x_dict, graph, self.vctx_patient, self.vctx_lab, self.axis)
        for i in range(self.num_layers):
            last = i == self.num_layers - 1
            x_dict = getattr(self, f"hgt_{i}")(x_dict, graph, READ_TYPES if last else None, self.axis)
        return x_dict

    def predict_lab_values(
        self,
        graph: HeteroGraph,
        p_idx: torch.Tensor,
        l_idx: torch.Tensor,
        train: bool = False,
        patient_plan=None,
        lab_plan=None,
        degrees=None,
        dropout_seed: int = 0,
    ) -> torch.Tensor:
        """The head on the final states of each (patient, lab) pair.  The
        gather plans, degrees and dropout seed of the RGCN's signature are
        accepted and not used: HGT has no degree gate, and the head's
        dropout draws from torch's generator."""
        tables = id_tables(self)
        x_dict = self(graph, train, tables)
        if self.axis is not None and train:
            edge_head_stream(dropout_seed, self.axis)
        pred = self._head(x_dict[PATIENT], x_dict[LAB], p_idx, l_idx, train)
        if self.shared_bilinear:
            u, c = shared_bilinear_tables(self, graph, tables[PATIENT])
            pred = pred + (u.index_select(0, p_idx.long()) * c.index_select(0, l_idx.long())).sum(-1)
        return pred

    def _head(self, final_p, final_l, p_idx, l_idx, train: bool = False) -> torch.Tensor:
        # index_select: its backward is an index_add_, where the backward of
        # x[idx] sorts the indices and walks each one's duplicates in turn
        # (3.5M pairs onto 500 lab rows: ~0.85 s a step on the H100)
        pair = torch.cat(
            [final_p.index_select(0, p_idx.long()), final_l.index_select(0, l_idx.long())], dim=-1
        )
        return self.edge_predictor(pair, train)[..., 0]

    def compute_node_state(self, graph: HeteroGraph) -> Dict[str, torch.Tensor]:
        """The final patient and lab states, from one eval-mode forward."""
        if self.training:
            raise RuntimeError("compute_node_state is an eval-mode forward: call model.eval() first")
        refuse_cluster_graph(graph)
        tables = id_tables(self)
        x_dict = self(graph, tables=tables)
        state = {"final_p": x_dict[PATIENT], "final_l": x_dict[LAB]}
        if self.shared_bilinear:
            state["bl_u"], state["bl_l"] = shared_bilinear_tables(self, graph, tables[PATIENT])
        return {k: v.detach() for k, v in state.items()}

    def predict_pairs_cached(self, state: Dict[str, torch.Tensor], p_idx, l_idx) -> torch.Tensor:
        pred = self._head(state["final_p"], state["final_l"], p_idx, l_idx)
        if "bl_u" in state:
            pred = pred + (state["bl_u"][p_idx] * state["bl_l"][l_idx]).sum(-1)
        return pred
