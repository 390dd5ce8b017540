"""The ``model``, ``graph``, ``train``, ``evaluation`` and ``logging``
config sections, as frozen dataclasses.

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
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


class ConfigError(ValueError):
    """Raised for an invalid or unsupported setting."""


@dataclass(frozen=True)
class GraphConfig:
    edge_pad_multiple: int = 1024
    # per-relation byte budget of the dense mean-normalized adjacency; 0 off
    dense_adjacency_max_bytes: int = 268_435_456
    # span-plan block height for big-source relations; 0 builds no span plan
    src_span_rows: int = 256
    # node numbering of synthetic graphs (data/synthetic.py): patients by
    # ascending lab degree, labs by descending frequency, as the JAX graph
    # build numbers them; both off keeps the generator's own order
    cluster_patients_by_degree: bool = True
    cluster_labs_by_frequency: bool = True


@dataclass(frozen=True)
class EdgeHeadConfig:
    hidden_dims: Tuple[int, ...] = (64, 32)

    def __post_init__(self):
        object.__setattr__(self, "hidden_dims", tuple(int(h) for h in self.hidden_dims))


@dataclass(frozen=True)
class ModelConfig:
    architecture: str = "RGCN"  # RGCN | HGT
    hidden_dim: int = 128
    num_layers: int = 2
    dropout: float = 0.2
    activation: str = "relu"  # relu | elu | leaky_relu
    use_batch_norm: bool = True
    aggregation: str = "mean"  # mean | sum | max
    num_heads: int = 4  # HGT only
    degree_threshold: int = 6
    edge_head: EdgeHeadConfig = field(default_factory=EdgeHeadConfig)
    compute_dtype: str = "float32"
    # run neighbor aggregation through the tiered kernels (ops/segment.py)
    use_pallas: bool = False
    # extras.head_style: auto | concat | factored and extras.dual_head_fusion:
    # auto | on | off (RGCN); extras.hgt_flash: auto | off and
    # extras.hgt_dense_attn_bytes (HGT)
    extras: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.architecture not in ("RGCN", "HGT"):
            raise ConfigError(f"model.architecture must be RGCN|HGT, got {self.architecture!r}")
        if self.architecture == "HGT" and (self.num_heads <= 0 or self.hidden_dim % self.num_heads):
            raise ConfigError(
                f"model.num_heads={self.num_heads} must divide hidden_dim={self.hidden_dim}"
            )
        if self.hgt_flash not in ("auto", "off"):
            raise ConfigError(f"model.extras.hgt_flash invalid: {self.hgt_flash!r}")
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

    @property
    def dual_head_fusion(self) -> str:
        """Both factored heads in one fused call: "on", "auto" (when the batch
        carries no degree tile masks) or anything else for off, read as the
        JAX factory reads it (``models/factory.py:76``)."""
        return str(self.extras.get("dual_head_fusion", "auto"))

    @property
    def hgt_flash(self) -> str:
        value = str(self.extras.get("hgt_flash", "auto")).lower()
        return "off" if value in ("off", "0", "false") else value

    @property
    def hgt_dense_attn_bytes(self) -> int:
        return int(self.extras.get("hgt_dense_attn_bytes", 134_217_728))


@dataclass(frozen=True)
class OptimizerConfig:
    type: str = "adam"  # adam only: the port rejects sgd
    lr: float = 1e-3
    weight_decay: float = 1e-5
    momentum: float = 0.9  # sgd only; kept for the JAX field set
    # extra L2 decay on the ID-embedding tables (embed_*) only
    embedding_weight_decay: float = 0.0

    def __post_init__(self):
        if self.type.lower() != "adam":
            raise ConfigError(
                f"train.optimizer.type={self.type!r}: the PyTorch port runs adam only"
            )


@dataclass(frozen=True)
class LRSchedulerConfig:
    enabled: bool = True
    type: str = "reduce_on_plateau"  # reduce_on_plateau | step
    factor: float = 0.5
    patience: int = 10
    threshold: float = 1e-4  # relative improvement threshold (torch default)
    min_lr: float = 0.0
    step_size: int = 30  # step scheduler only
    gamma: float = 0.1  # step scheduler only

    def __post_init__(self):
        if self.type not in ("reduce_on_plateau", "step"):
            raise ConfigError(f"train.lr_scheduler.type invalid: {self.type!r}")


@dataclass(frozen=True)
class TrainConfig:
    task: str = "edge_regression"
    mask_fraction: float = 0.2
    train_split: float = 0.7
    val_split: float = 0.15
    test_split: float = 0.15
    loss: str = "mae"  # mae | mse | huber
    epochs: int = 100
    batch_size: Optional[int] = None  # None = full batch, the only mode ported
    early_stopping_patience: int = 15
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)
    seed: int = 42
    # epochs per Trainer.train_epochs call in fit(): 1 acts on every epoch;
    # k > 1 runs k epochs back to back and acts on chunk boundaries
    scan_chunk: int = 1
    # extras.lab_tile_rows (None/"auto" | int), extras.lab_tile_mode ("span"),
    # extras.lab_reweighting (bool)
    extras: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        total = self.train_split + self.val_split + self.test_split
        if abs(total - 1.0) > 1e-6:
            raise ConfigError(f"train/val/test splits must sum to 1.0, got {total}")
        if self.loss not in ("mae", "mse", "huber"):
            raise ConfigError(f"train.loss invalid: {self.loss!r}")
        if self.task != "edge_regression":
            raise ConfigError(f"train.task invalid: {self.task!r}")
        if self.scan_chunk < 1:
            raise ConfigError(f"train.scan_chunk must be >= 1, got {self.scan_chunk}")
        if self.batch_size is not None:
            raise ConfigError(
                "train.batch_size: the PyTorch port trains full-batch only (batch_size: null)"
            )
        unknown = set(self.extras) - _TRAIN_EXTRAS
        if unknown:
            raise ConfigError(
                f"unsupported train extras: {sorted(unknown)} (mini-batch, warm start, "
                "multi-device and optimizer layouts are not ported yet)"
            )
        if str(self.extras.get("lab_tile_mode", "span")) != "span":
            raise ConfigError(
                "train.extras.lab_tile_mode: the PyTorch port runs span-mode lab tiles only"
            )


@dataclass(frozen=True)
class EvaluationConfig:
    regression_metrics: Tuple[str, ...] = ("mae", "rmse", "r2", "mape")
    per_lab_metrics: bool = True
    baselines: Tuple[str, ...] = ("global_mean", "per_lab_mean", "nearest_neighbor")
    stratify_by: Tuple[str, ...] = ("num_labs", "lab_frequency")
    winsorize_sigma: float = 3.0  # post-hoc per-lab residual cap of the reported metrics
    # extras.conformal_alpha (0.1; falsy: no intervals),
    # extras.conformal_split_fraction (share of val carved into "cal"),
    # extras.huber_delta (robust ALS baselines)
    extras: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        for name in ("regression_metrics", "baselines", "stratify_by"):
            object.__setattr__(self, name, tuple(getattr(self, name)))
        unknown = set(self.baselines) - _BASELINES
        if unknown:
            raise ConfigError(f"evaluation.baselines: unknown {sorted(unknown)}")
        unknown = set(self.extras) - _EVALUATION_EXTRAS
        if unknown:
            raise ConfigError(f"unsupported evaluation extras: {sorted(unknown)}")


@dataclass(frozen=True)
class LoggingConfig:
    log_interval: int = 1
    save_checkpoints: bool = True
    checkpoint_interval: int = 10


@dataclass(frozen=True)
class Config:
    graph: GraphConfig = field(default_factory=GraphConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        """Build from a dict shaped like the JAX ``Config.to_dict()``; its
        ``model``, ``graph``, ``train``, ``evaluation`` and ``logging``
        sections are read."""
        return Config(
            graph=_graph_from_dict(dict(d.get("graph") or {})),
            model=_model_from_dict(dict(d.get("model") or {})),
            train=_train_from_dict(dict(d.get("train") or {})),
            evaluation=_evaluation_from_dict(dict(d.get("evaluation") or {})),
            logging=_logging_from_dict(dict(d.get("logging") or {})),
        )

    def to_dict(self) -> Dict[str, Any]:
        """Nested dicts and lists, each section's ``extras`` flattened into
        it, as the JAX ``Config.to_dict()`` writes them; ``from_dict`` reads
        it back."""

        def convert(obj):
            if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                out = {}
                for f in dataclasses.fields(obj):
                    value = convert(getattr(obj, f.name))
                    if f.name == "extras":
                        out.update(value)
                    else:
                        out[f.name] = value
                return out
            if isinstance(obj, dict):
                return {k: convert(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return [convert(v) for v in obj]
            return obj

        return convert(self)

    def content_hash(self) -> str:
        """Hash of the whole config, written into artifacts for provenance."""
        return _hash(self.to_dict())

    def model_hash(self) -> str:
        """Hash of the sections a checkpoint must agree on to be restored
        (``model``, ``graph``): run-length and optimizer settings may differ
        at resume, as JAX ``Config.model_hash`` allows."""
        d = self.to_dict()
        return _hash({k: d.get(k) for k in ("model", "graph", "feature_space")})


def _hash(d: Dict[str, Any]) -> str:
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


# accepted and dropped: they change TPU layout or TPU kernel choice only
_GRAPH_IGNORED = {"node_types", "add_self_loops", "num_shards", "shard_kernel_plans"}
# model keys that the JAX ``to_dict`` flattens out of ``extras``
_MODEL_EXTRAS = {"head_style", "dual_head_fusion", "hgt_flash", "hgt_dense_attn_bytes"}
# accepted and dropped: TPU device placement and dispatch
_TRAIN_IGNORED = {"device", "num_devices", "donate_state"}
_TRAIN_EXTRAS = {"lab_tile_rows", "lab_tile_mode", "lab_reweighting"}
_BASELINES = {"global_mean", "per_lab_mean", "nearest_neighbor", "als", "sideinfo_als"}
_EVALUATION_EXTRAS = {"conformal_alpha", "conformal_split_fraction", "huber_delta"}
# accepted and dropped: log files and experiment trackers
_LOGGING_IGNORED = {
    "level", "save_to_file", "log_file", "use_wandb", "wandb_project", "wandb_entity",
}


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
    extras.update({k: d.pop(k) for k in _MODEL_EXTRAS & set(d)})
    known = _fields(ModelConfig) - {"edge_head", "extras"}
    unknown = set(d) - known
    if unknown:
        raise ConfigError(f"unsupported model setting(s): {sorted(unknown)}")
    return ModelConfig(
        **{k: v for k, v in d.items() if k in known},
        edge_head=EdgeHeadConfig(**head),
        extras=extras,
    )


def _section(d: Dict[str, Any], cls, name: str):
    """``cls`` from a JAX-shaped section dict; keys that are not fields are
    the JAX ``extras``, which these sections do not take."""
    known = _fields(cls) - {"extras"}
    unknown = set(d) - known
    if unknown:
        raise ConfigError(f"unsupported {name} setting(s): {sorted(unknown)}")
    return cls(**d)


def _train_from_dict(d: Dict[str, Any]) -> TrainConfig:
    d["scan_chunk"] = int(d.get("scan_chunk", 1) or 1)
    for name in _TRAIN_IGNORED:
        d.pop(name, None)
    optimizer = _section(dict(d.pop("optimizer", None) or {}), OptimizerConfig, "train.optimizer")
    scheduler = _section(
        dict(d.pop("lr_scheduler", None) or {}), LRSchedulerConfig, "train.lr_scheduler"
    )
    # JAX to_dict flattens extras into the section
    extras = dict(d.pop("extras", None) or {})
    known = _fields(TrainConfig) - {"optimizer", "lr_scheduler", "extras"}
    extras.update({k: d.pop(k) for k in list(d) if k not in known})
    return TrainConfig(**d, optimizer=optimizer, lr_scheduler=scheduler, extras=extras)


def _evaluation_from_dict(d: Dict[str, Any]) -> EvaluationConfig:
    extras = dict(d.pop("extras", None) or {})
    known = _fields(EvaluationConfig) - {"extras"}
    extras.update({k: d.pop(k) for k in list(d) if k not in known})
    return EvaluationConfig(**d, extras=extras)


def _logging_from_dict(d: Dict[str, Any]) -> LoggingConfig:
    for name in _LOGGING_IGNORED:
        d.pop(name, None)
    return _section(d, LoggingConfig, "logging")
