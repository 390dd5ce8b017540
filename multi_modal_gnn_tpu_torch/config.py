"""The ``model`` and ``graph`` config sections, as frozen dataclasses.

Field names and defaults follow ``multi_modal_gnn_tpu/config.py``.
:meth:`Config.from_dict` accepts the JAX ``Config.to_dict()`` output (where
``extras`` are flattened into their section), so both packages can be fed
the same settings.  There is no YAML loader: the card's machine has no
``yaml``.

Settings this port does not implement raise :class:`ConfigError` instead of
being ignored; settings that only steer TPU layout or TPU kernel choice,
with no effect on results, are accepted and dropped.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


class ConfigError(ValueError):
    """Raised for an invalid or unsupported setting."""


@dataclass(frozen=True)
class GraphConfig:
    edge_pad_multiple: int = 1024
    # per-relation byte budget of the dense mean-normalized adjacency; 0 off
    dense_adjacency_max_bytes: int = 268_435_456
    # span-plan block height for big-source relations; 0 builds no span plan
    src_span_rows: int = 256


@dataclass(frozen=True)
class EdgeHeadConfig:
    hidden_dims: Tuple[int, ...] = (64, 32)

    def __post_init__(self):
        object.__setattr__(self, "hidden_dims", tuple(int(h) for h in self.hidden_dims))


@dataclass(frozen=True)
class ModelConfig:
    hidden_dim: int = 128
    num_layers: int = 2
    dropout: float = 0.2
    activation: str = "relu"  # relu | elu | leaky_relu
    use_batch_norm: bool = True
    aggregation: str = "mean"  # mean | sum | max
    degree_threshold: int = 6
    edge_head: EdgeHeadConfig = field(default_factory=EdgeHeadConfig)
    compute_dtype: str = "float32"
    # run neighbor aggregation through the tiered kernels (ops/segment.py)
    use_pallas: bool = False
    # extras.head_style: auto | concat | factored
    extras: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.activation not in ("relu", "elu", "leaky_relu"):
            raise ConfigError(f"model.activation invalid: {self.activation!r}")
        if self.aggregation not in ("mean", "sum", "max"):
            raise ConfigError(f"model.aggregation invalid: {self.aggregation!r}")
        if self.compute_dtype != "float32":
            raise ConfigError(
                f"model.compute_dtype={self.compute_dtype!r} is not supported by the "
                "PyTorch port yet (float32 only)"
            )
        if self.head_style not in ("auto", "concat", "factored"):
            raise ConfigError(f"model.extras.head_style invalid: {self.head_style!r}")

    @property
    def head_style(self) -> str:
        return str(self.extras.get("head_style", "auto"))


@dataclass(frozen=True)
class Config:
    graph: GraphConfig = field(default_factory=GraphConfig)
    model: ModelConfig = field(default_factory=ModelConfig)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        """Build from a dict shaped like the JAX ``Config.to_dict()``; only
        its ``model`` and ``graph`` sections are read."""
        return Config(
            graph=_graph_from_dict(dict(d.get("graph") or {})),
            model=_model_from_dict(dict(d.get("model") or {})),
        )


# accepted and dropped: they change TPU layout or TPU kernel choice only
_GRAPH_IGNORED = {
    "node_types", "add_self_loops", "cluster_patients_by_degree",
    "cluster_labs_by_frequency", "num_shards", "shard_kernel_plans",
}
_MODEL_IGNORED = {"num_heads", "dual_head_fusion", "hgt_dense_attn_bytes"}


def _fields(cls) -> set:
    return {f.name for f in dataclasses.fields(cls)}


def _graph_from_dict(d: Dict[str, Any]) -> GraphConfig:
    for name, et in (d.pop("edge_types", None) or {}).items():
        et = et or {}
        if not et.get("enabled", True) or not et.get("bidirectional", True):
            raise ConfigError(
                f"graph.edge_types.{name}: disabled or one-way relations are not "
                "supported by the PyTorch port yet"
            )
    known = _fields(GraphConfig)
    unknown = set(d) - known - _GRAPH_IGNORED
    if unknown:
        raise ConfigError(f"unsupported graph setting(s): {sorted(unknown)}")
    return GraphConfig(**{k: v for k, v in d.items() if k in known})


def _model_from_dict(d: Dict[str, Any]) -> ModelConfig:
    arch = d.pop("architecture", "RGCN")
    if arch != "RGCN":
        raise ConfigError(f"model.architecture={arch!r}: the PyTorch port runs RGCN only")
    if d.pop("value_context", False):
        raise ConfigError("model.extras.value_context is not supported by the PyTorch port yet")
    head = dict(d.pop("edge_head", None) or {})
    if int(head.pop("bilinear_rank", 0) or 0) > 0:
        raise ConfigError(
            "model.edge_head.extras.bilinear_rank > 0 is not supported by the PyTorch port yet"
        )
    head.pop("bilinear_source", None)
    if head.pop("final_activation", None) is not None:
        raise ConfigError("model.edge_head.final_activation is not supported")
    unknown_head = set(head) - _fields(EdgeHeadConfig)
    if unknown_head:
        raise ConfigError(f"unsupported edge_head setting(s): {sorted(unknown_head)}")
    extras = dict(d.pop("extras", None) or {})
    if "head_style" in d:
        extras["head_style"] = d.pop("head_style")
    known = _fields(ModelConfig) - {"edge_head", "extras"}
    unknown = set(d) - known - _MODEL_IGNORED
    if unknown:
        raise ConfigError(f"unsupported model setting(s): {sorted(unknown)}")
    return ModelConfig(
        **{k: v for k, v in d.items() if k in known},
        edge_head=EdgeHeadConfig(**head),
        extras=extras,
    )
