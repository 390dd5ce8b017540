"""Heterogeneous relational GNN (``multi_modal_gnn_tpu/models/rgcn.py``).

ID-embedding tables per node type, the patient table through an MLP + L2
norm, then ``num_layers`` x [per-relation SAGE summed per destination type ->
per-type BatchNorm -> activation -> dropout between layers], and
degree-gated dual edge heads.  Submodules keep the flax names
(``embed_<type>``, ``conv_<i>.neigh_<relation>``, ``bn_<i>_<type>``, ...), so
the weight bridge maps parameters one for one.

Two opt-in quality channels, as in JAX: ``value_context`` adds the
observed-value aggregation before layer 0 (``models/context.py``), and
``bilinear_rank > 0`` adds a low-rank bilinear term to the prediction, read
from each head's inputs (``bilinear_source="head"``), from the raw ID
tables (``"embedding"``, the channel the ALS warm start plants into) or
from the patient's value context over the raw lab table (``"context"``).

``dtype`` (None or ``torch.bfloat16``, ``model.compute_dtype``) is the JAX
model's compute dtype: parameters stay float32; the patient encoder, the
convolutions and the heads compute in it, BatchNorm returns float32, and
each layer rounds where its JAX module rounds (``models/layers.py``,
``ops/segment.py``).  Predictions come out float32 (fused heads) or in the
compute dtype (unfused heads), as JAX's do; callers read them as float32.

``axis`` (a ``parallel.mesh.DataAxis``; JAX's ``axis_name``) is set on the
model of an edge-sharded data-parallel trainer: the graph it runs on is the
rank's shard, every aggregation combines the ranks' partial sums
(``ops/segment.py``), the value context's sums are all-reduced, and the
pair heads run plain, without gather plans or the fused K4 / K5 kernels
(JAX ``rgcn.py:393``, ``:469``).  Its edge-head dropout draws from a
stream of its own per rank (JAX folds ``axis_index`` into the key), the
node dropout from the stream every rank shares.  :meth:`HeteroRGCN.unsharded`
is the twin for serving and export.

Training runs :meth:`HeteroRGCN.predict_lab_values` with ``train=True``,
the batch's gather plans and its per-slot degrees.  The serving section
(:meth:`HeteroRGCN.compute_node_state`, :meth:`HeteroRGCN.predict_pairs_cached`)
runs the eval-mode forward once and answers each request with the pair heads
alone.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from multi_modal_gnn_tpu_torch.config import BILINEAR_SOURCES
from multi_modal_gnn_tpu_torch.graph.hetero import TILE_E, GatherPlan, HeteroGraph
from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT, EdgeTypeKey, mirror_edge_type
from multi_modal_gnn_tpu_torch.models.context import inject_value_context
from multi_modal_gnn_tpu_torch.models.layers import (
    EdgeRegressionHead,
    FactoredEdgeHead,
    FlaxBatchNorm,
    PatientEncoder,
    bilinear_factor,
    get_activation,
    id_tables,
    linear_in,
    make_dense,
    patient_rows,
    refuse_cluster_graph,
    shared_bilinear_tables,
    take_rows,
)
from multi_modal_gnn_tpu_torch.ops.pairhead import fused_pair_head_dual
from multi_modal_gnn_tpu_torch.ops.segment import aggregate_neighbors, take_with_plan
from multi_modal_gnn_tpu_torch.utils.rng import stream_seed, stream_seed_pair


def _et_key(et: EdgeTypeKey) -> str:
    return "__".join(et)


def edge_head_stream(dropout_seed: int, axis) -> None:
    """Seed torch's generator for the edge heads' dropout with a stream of
    this rank's data shard (JAX ``fold_in(edge_key, axis_index(DATA_AXIS))``):
    the batch shards draw independent masks, and the model axis's ranks of
    one data shard (the 2-D layout) draw the same.  ``axis`` is the data
    axis, whose ``rank`` is the data index."""
    torch.manual_seed(stream_seed(dropout_seed, "edge_dropout", axis.rank))


class HeteroSAGELayer(nn.Module):
    """Per-relation SAGE convolutions summed per destination type:
    ``out_r[dst] = W_neigh_r agg_r(x_src)[dst] + W_root_r x[dst] + b_r``.

    Each destination type runs one matmul over the concatenated messages and
    its own features: the neighbor weights are stacked along K and the root
    weights summed.  Parameters stay per relation (``neigh_<key>``,
    ``root_<key>``).  With a compute ``dtype`` the source rows are cast to
    it before aggregation (half the gather bytes) and the destination rows,
    the stacked weights and the summed bias before the one matmul (JAX
    ``rgcn.py:107-108``, ``:136-142``)."""

    def __init__(
        self,
        edge_types: Sequence[EdgeTypeKey],
        node_types: Sequence[str],
        hidden_dim: int,
        aggregation: str = "mean",
        impl: str = "xla",
        generator: Optional[torch.Generator] = None,
        dtype=None,
    ):
        super().__init__()
        self.edge_types = tuple(edge_types)
        self.node_types = tuple(node_types)
        self.aggregation = aggregation
        self.impl = impl
        self.compute_dtype = dtype
        for et in self.edge_types:
            key = _et_key(et)
            self.add_module(f"neigh_{key}", make_dense(hidden_dim, hidden_dim, generator=generator))
            self.add_module(
                f"root_{key}", make_dense(hidden_dim, hidden_dim, bias=False, generator=generator)
            )

    def forward(self, x_dict: Dict[str, torch.Tensor], graph: HeteroGraph, axis=None) -> Dict[str, torch.Tensor]:
        by_dst: Dict[str, list] = {}
        for et in self.edge_types:
            by_dst.setdefault(et[2], []).append(et)
        dt = self.compute_dtype
        cast = (lambda x: x) if dt is None else (lambda x: x.to(dt))  # noqa: E731
        out: Dict[str, torch.Tensor] = {}
        for dst_t, ets in by_dst.items():
            parts, weights = [], []
            bias = root = None
            for et in ets:
                parts.append(
                    aggregate_neighbors(
                        cast(x_dict[et[0]]), graph.edges[et], self.aggregation, impl=self.impl,
                        edges_rev=graph.edges.get(mirror_edge_type(et)), axis=axis,
                    )
                )
                neigh = getattr(self, f"neigh_{_et_key(et)}")
                rw = getattr(self, f"root_{_et_key(et)}").weight
                weights.append(neigh.weight)
                bias = neigh.bias if bias is None else bias + neigh.bias
                root = rw if root is None else root + rw
            weights.append(root)
            parts.append(cast(x_dict[dst_t]))
            if dt is None:
                out[dst_t] = F.linear(torch.cat(parts, dim=-1), torch.cat(weights, dim=1), bias)
            else:
                out[dst_t] = linear_in(torch.cat(parts, dim=-1), torch.cat(weights, dim=1), bias, dt)
        # node types that receive no relation pass through unchanged
        for nt in self.node_types:
            if nt in x_dict:
                out.setdefault(nt, x_dict[nt])
        return out


class HeteroRGCN(nn.Module):
    # cluster graphs' local patients read their window of the global table
    # (HeteroGraph.patient_id_base; training/minibatch.py)
    supports_patient_id_base = True

    def __init__(
        self,
        node_counts: Tuple[Tuple[str, int], ...],
        edge_types: Sequence[EdgeTypeKey],
        hidden_dim: int = 128,
        num_layers: int = 2,
        dropout: float = 0.2,
        activation: str = "relu",
        use_batch_norm: bool = True,
        aggregation: str = "mean",
        head_hidden_dims: Sequence[int] = (64, 32),
        degree_threshold: int = 6,
        impl: str = "xla",
        head_style: str = "concat",
        dual_head_fusion: str = "auto",
        bilinear_rank: int = 0,
        bilinear_source: str = "head",
        value_context: bool = False,
        generator: Optional[torch.Generator] = None,
        dtype=None,
        axis=None,
    ):
        super().__init__()
        self.axis = axis
        if head_style not in ("concat", "factored"):
            raise ValueError(f"head_style must be concat|factored, got {head_style!r}")
        if bilinear_source not in BILINEAR_SOURCES:
            raise ValueError(f"bilinear_source must be one of {BILINEAR_SOURCES}, got {bilinear_source!r}")
        self.node_counts = tuple(node_counts)
        self.num_layers = num_layers
        self.use_batch_norm = use_batch_norm
        self.degree_threshold = degree_threshold
        self.head_style = head_style
        self.dual_head_fusion = dual_head_fusion
        self.impl = impl
        self.bilinear_rank = int(bilinear_rank)
        self.bilinear_source = bilinear_source
        self.value_context = bool(value_context)
        self.compute_dtype = dtype
        self.act = get_activation(activation)
        for nt, n in self.node_counts:
            emb = nn.Embedding(n, hidden_dim)
            bound = math.sqrt(6.0 / (n + hidden_dim))  # xavier-uniform
            with torch.no_grad():
                emb.weight.uniform_(-bound, bound, generator=generator)
            self.add_module(f"embed_{nt}", emb)
        self.patient_encoder = PatientEncoder(hidden_dim, dropout, use_batch_norm, generator, dtype)
        for i in range(num_layers):
            self.add_module(
                f"conv_{i}",
                HeteroSAGELayer(
                    edge_types, self.node_types, hidden_dim, aggregation, impl, generator, dtype
                ),
            )
            if use_batch_norm:
                for nt in self.node_types:
                    self.add_module(f"bn_{i}_{nt}", FlaxBatchNorm(hidden_dim))
        head_rank = self.head_rank
        for name in ("edge_predictor", "tabular_mlp"):
            if head_style == "factored":
                head = FactoredEdgeHead(
                    hidden_dim, head_hidden_dims, 1, dropout, generator, head_rank, dtype
                )
            else:
                head = EdgeRegressionHead(
                    2 * hidden_dim, head_hidden_dims, 1, dropout, generator, head_rank, dtype
                )
            self.add_module(name, head)
        if self.shared_bilinear:
            self.bilinear_u = bilinear_factor(hidden_dim, self.bilinear_rank, generator)
            self.bilinear_l = bilinear_factor(hidden_dim, self.bilinear_rank, generator)
        if self.value_context:
            # input: the value-weighted mean context (hidden) and the visible share (1)
            self.vctx_patient = make_dense(hidden_dim, hidden_dim + 1, generator=generator, dtype=dtype)
            self.vctx_lab = make_dense(hidden_dim, hidden_dim + 1, generator=generator, dtype=dtype)
        self.dropout = float(dropout)

    def unsharded(self) -> "HeteroRGCN":
        """The model without its data axis, sharing every parameter and
        buffer (JAX ``Trainer.serving_model``): for the full graph."""
        twin = copy.copy(self)
        twin.axis = None
        return twin

    @property
    def head_rank(self) -> int:
        """The rank of each head's own bilinear term (the ``head`` source)."""
        return self.bilinear_rank if self.bilinear_source == "head" else 0

    @property
    def shared_bilinear(self) -> bool:
        """One bilinear term over the raw tables (``embedding`` / ``context``)."""
        return self.bilinear_rank > 0 and self.bilinear_source in ("embedding", "context")

    @property
    def node_types(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.node_counts)

    def encode_nodes(
        self, train: bool = False, graph: Optional[HeteroGraph] = None, tables: Optional[Dict] = None
    ) -> Dict[str, torch.Tensor]:
        """Initial embeddings; the patient table goes through the encoder.
        On a cluster graph the patient rows are the cluster's window of the
        global table (:func:`~multi_modal_gnn_tpu_torch.models.layers.patient_rows`).
        ``tables``: the ID tables the forward has read (default:
        :func:`~multi_modal_gnn_tpu_torch.models.layers.id_tables`)."""
        x_dict = dict(id_tables(self) if tables is None else tables)
        if PATIENT in x_dict:
            x_dict[PATIENT] = self.patient_encoder(patient_rows(x_dict[PATIENT], graph), train)
        return x_dict

    def propagate(
        self, x_dict: Dict[str, torch.Tensor], graph: HeteroGraph, train: bool = False
    ) -> Dict[str, torch.Tensor]:
        if self.value_context:
            x_dict = inject_value_context(x_dict, graph, self.vctx_patient, self.vctx_lab, self.axis)
        for i in range(self.num_layers):
            x_dict = getattr(self, f"conv_{i}")(x_dict, graph, self.axis)
            if self.use_batch_norm:
                x_dict = {nt: getattr(self, f"bn_{i}_{nt}")(x, train) for nt, x in x_dict.items()}
            x_dict = {nt: self.act(x) for nt, x in x_dict.items()}
            if i < self.num_layers - 1:
                x_dict = {nt: F.dropout(x, self.dropout, train) for nt, x in x_dict.items()}
        return x_dict

    def forward(self, graph: HeteroGraph, train: bool = False) -> Dict[str, torch.Tensor]:
        return self.propagate(self.encode_nodes(train, graph), graph, train)

    def _use_dual(self, patient_plan: Optional[GatherPlan], tab_mask) -> bool:
        """JAX's rule (``rgcn.py:419-436``): ``on``, or ``auto`` without tile
        masks, on a slot-major batch with no lab tiles and two-layer heads;
        here also only at the (64, 32) widths K5 is compiled for (other
        widths take the unfused heads).
        JAX also asks for eval mode, dropout 0 or a TPU there, because its
        in-kernel dropout lowers only on the TPU; K5 draws its bits in the
        kernel as the TPU kernel does, and its plain version draws the same
        bits, so the port takes the dual path at any dropout.  Heads with
        their own bilinear term (the ``head`` source) run single, as in JAX."""
        want = self.dual_head_fusion == "on" or (self.dual_head_fusion == "auto" and tab_mask is None)
        return (
            want
            and self.head_rank == 0
            and patient_plan is not None
            and patient_plan.identity
            and not patient_plan.lab_block_rows
            and self.tabular_mlp.fused_widths()
            and self.edge_predictor.fused_widths()
        )

    def _heads(
        self, init_p, init_l, final_p, final_l, p_idx, l_idx, degrees, train: bool = False,
        patient_plan: Optional[GatherPlan] = None, lab_plan: Optional[GatherPlan] = None,
        dropout_seed: int = 0, mask_degrees: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if self.head_style == "factored":
            # degree-predicated head tiles: with a slot-major batch, a tile
            # whose real slots all lie at or above the threshold never uses
            # its tabular prediction (the gate below discards it), so the
            # fused kernel skips the tile; all-low tiles skip the GNN head.
            # As in JAX, only degrees the caller passed build masks.
            tab_mask = gnn_mask = None
            if (
                patient_plan is not None
                and patient_plan.identity
                and mask_degrees is not None
                and mask_degrees.shape[0] % TILE_E == 0
            ):
                low = (mask_degrees < self.degree_threshold).reshape(-1, TILE_E)
                tab_mask = low.any(dim=1).to(torch.int32)
                gnn_mask = (~low).any(dim=1).to(torch.int32)
            seed_t = stream_seed_pair(dropout_seed, "tabular_mlp")
            seed_g = stream_seed_pair(dropout_seed, "edge_predictor")
            if self._use_dual(patient_plan, tab_mask):
                *tab, seed_t = self.tabular_mlp(
                    init_p, init_l, p_idx, l_idx, seed=seed_t, project_only=True
                )
                *gnn, seed_g = self.edge_predictor(
                    final_p, final_l, p_idx, l_idx, seed=seed_g, project_only=True
                )
                tab, gnn = fused_pair_head_dual(
                    *tab, *gnn, l_idx, patient_plan.win_local, patient_plan.win_tile_map,
                    (*seed_t, *seed_g), tab_mask, gnn_mask, patient_plan.num_windows,
                    self.dropout if train else 0.0,
                )
            else:
                common = dict(train=train, patient_plan=patient_plan, lab_plan=lab_plan)
                tab = self.tabular_mlp(
                    init_p, init_l, p_idx, l_idx, tile_mask=tab_mask, seed=seed_t, **common,
                )[..., 0]
                gnn = self.edge_predictor(
                    final_p, final_l, p_idx, l_idx, tile_mask=gnn_mask, seed=seed_g, **common,
                )[..., 0]
        else:
            def take(x_p, x_l):
                return torch.cat(
                    [take_with_plan(x_p, p_idx, patient_plan), take_with_plan(x_l, l_idx, lab_plan)],
                    dim=-1,
                )

            tab = self.tabular_mlp(take(init_p, init_l), train)[..., 0]
            gnn = self.edge_predictor(take(final_p, final_l), train)[..., 0]
        return torch.where(degrees < self.degree_threshold, tab, gnn)

    def predict_lab_values(
        self,
        graph: HeteroGraph,
        p_idx: torch.Tensor,
        l_idx: torch.Tensor,
        train: bool = False,
        patient_plan: Optional[GatherPlan] = None,
        lab_plan: Optional[GatherPlan] = None,
        degrees: Optional[torch.Tensor] = None,
        dropout_seed: int = 0,
    ) -> torch.Tensor:
        """Degree-gated dual-head prediction for (patient, lab) pairs: the
        tabular head below the degree threshold, the GNN head above.

        With the kernel path (``impl="pallas"``) the batch's gather plans
        route the pair gathers' backward through K1, and an identity patient
        plan (a slot-major batch) runs the factored heads in the fused
        pair-head kernels: each head on its own (K4), skipping the tiles the
        gate discards, or both in one call (K5) under ``dual_head_fusion``.
        ``degrees`` is the per-pair patient lab-degree: given, it also builds
        the heads' tile masks; None, it is gathered here for the gate only.
        ``dropout_seed`` seeds the fused heads' dropout."""
        tables = id_tables(self)
        initial = self.encode_nodes(train, graph, tables)
        final = self.propagate(initial, graph, train)
        use_plans = self.impl == "pallas" and self.axis is None
        patient_plan = patient_plan if use_plans else None
        lab_plan = lab_plan if use_plans else None
        if self.axis is not None and train:
            edge_head_stream(dropout_seed, self.axis)
        gate = degrees if degrees is not None else graph.patient_lab_degree[p_idx.long()]
        pred = self._heads(
            initial[PATIENT], initial[LAB], final[PATIENT], final[LAB], p_idx, l_idx, gate,
            train, patient_plan, lab_plan, dropout_seed, mask_degrees=degrees,
        )
        if self.shared_bilinear:
            # tables projected to rank width first, then the narrow rows gathered
            u, c = shared_bilinear_tables(self, graph, tables[PATIENT])
            pred = pred + (take_rows(u, p_idx, patient_plan) * take_rows(c, l_idx, lab_plan)).sum(-1)
        return pred

    def compute_node_state(self, graph: HeteroGraph) -> Dict[str, torch.Tensor]:
        """Everything :meth:`predict_pairs_cached` needs, from one eval-mode
        forward over the full graph."""
        if self.training:
            raise RuntimeError("compute_node_state is an eval-mode forward: call model.eval() first")
        refuse_cluster_graph(graph)
        tables = id_tables(self)
        initial = self.encode_nodes(tables=tables)
        final = self.propagate(initial, graph)
        state = {
            "init_p": initial[PATIENT],
            "init_l": initial[LAB],
            "final_p": final[PATIENT],
            "final_l": final[LAB],
            "degree": graph.patient_lab_degree,
        }
        # the head source's factors live in the heads, which the request path runs
        if self.shared_bilinear:
            state["bl_u"], state["bl_l"] = shared_bilinear_tables(self, graph, tables[PATIENT])
        return {k: v.detach() for k, v in state.items()}

    def predict_pairs_cached(self, state: Dict[str, torch.Tensor], p_idx, l_idx) -> torch.Tensor:
        """``predict_lab_values`` in eval mode, from a node-state dict."""
        pred = self._heads(
            state["init_p"], state["init_l"], state["final_p"], state["final_l"], p_idx, l_idx,
            state["degree"][p_idx],
        )
        if "bl_u" in state:
            pred = pred + (state["bl_u"][p_idx] * state["bl_l"][l_idx]).sum(-1)
        return pred
