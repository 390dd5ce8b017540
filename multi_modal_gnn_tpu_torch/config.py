"""The pipeline's configuration, as frozen dataclasses, read from the YAML
files in ``conf/`` (:func:`load_config`) or from a dict.

The sections and fields are those of ``multi_modal_gnn_tpu/config.py``:
``data``, ``cohort``, ``feature_space``, ``graph``, ``model``, ``train``,
``evaluation``, ``visualization``, ``logging`` and ``reproducibility``.
:meth:`Config.from_dict` accepts the JAX ``Config.to_dict()`` output (where
``extras`` are flattened into their section), and :meth:`Config.to_dict`
writes the same dict as the JAX package for the same file, so
:meth:`Config.content_hash` and :meth:`Config.model_hash` are the JAX
package's.  YAML is read by ``utils/yaml_subset.py``: the card's machine
has no ``yaml``.

Settings this port does not implement raise :class:`ConfigError` instead of
being ignored; settings that only steer TPU layout, TPU device placement or
logging services, with no effect on results, are accepted and dropped.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from multi_modal_gnn_tpu_torch.utils import yaml_subset


class ConfigError(ValueError):
    """Raised for an invalid or unsupported setting."""


@dataclass(frozen=True)
class DataConfig:
    # eicu and mimic3 read the raw tables under raw_dir (data/eicu.py,
    # data/mimic.py); synthetic is generated
    dataset: str = "eicu"  # eicu | mimic3 | synthetic
    raw_dir: str = "data/raw"
    interim_dir: str = "data/interim"
    output_dir: str = "outputs"
    labevents_chunksize: Optional[int] = None
    # extras.synthetic: {preset, seed, SyntheticSpec field overrides}
    extras: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.dataset not in ("eicu", "mimic3", "synthetic"):
            raise ConfigError(f"data.dataset must be eicu|mimic3|synthetic, got {self.dataset!r}")
        _only(self.extras, {"synthetic"}, "data")
        if not isinstance(self.extras.get("synthetic") or {}, dict):
            raise ConfigError("data.synthetic must be a mapping")


@dataclass(frozen=True)
class CohortConfig:
    # act on the raw eICU / MIMIC-III loaders only
    age_min: int = 18
    age_max: Optional[int] = None
    use_first_icu_only: bool = True
    subject_limit: Optional[int] = None
    min_los_hours: Optional[float] = None
    exclude_deaths: bool = False


@dataclass(frozen=True)
class LabsConfig:
    top_k: int = 50
    aggregate: str = "last"  # last | mean | median | min | max
    normalize: str = "zscore"  # zscore | minmax | robust | none
    outlier_std_threshold: Optional[float] = 5.0
    min_patient_count: int = 10

    def __post_init__(self):
        if self.aggregate not in ("last", "mean", "median", "min", "max"):
            raise ConfigError(f"labs.aggregate invalid: {self.aggregate!r}")
        if self.normalize not in ("zscore", "minmax", "robust", "none"):
            raise ConfigError(f"labs.normalize invalid: {self.normalize!r}")


@dataclass(frozen=True)
class DiagnosesConfig:
    collapse_to_3digit: bool = True
    top_k: int = 200
    min_patient_count: int = 5


@dataclass(frozen=True)
class MedicationsConfig:
    top_k: int = 100
    normalize_names: bool = True
    min_patient_count: int = 5


@dataclass(frozen=True)
class DemographicsConfig:
    include_age: bool = True
    include_gender: bool = True
    include_ethnicity: bool = False


@dataclass(frozen=True)
class FeatureSpaceConfig:
    """How the raw loaders engineer features.  The synthetic route ignores
    it, but :meth:`Config.model_hash` covers it, as in JAX: a checkpoint
    trained on other features does not restore unforced."""

    labs: LabsConfig = field(default_factory=LabsConfig)
    diagnoses: DiagnosesConfig = field(default_factory=DiagnosesConfig)
    medications: MedicationsConfig = field(default_factory=MedicationsConfig)
    demographics: DemographicsConfig = field(default_factory=DemographicsConfig)


@dataclass(frozen=True)
class EdgeTypeConfig:
    enabled: bool = True
    bidirectional: bool = True


@dataclass(frozen=True)
class GraphConfig:
    node_types: Tuple[str, ...] = ("patient", "lab", "diagnosis", "medication")
    edge_types: Dict[str, EdgeTypeConfig] = field(
        default_factory=lambda: {
            name: EdgeTypeConfig()
            for name in ("patient_lab", "patient_diagnosis", "patient_medication")
        }
    )
    add_self_loops: bool = True  # read by no layer, as in JAX
    edge_pad_multiple: int = 1024
    # per-relation byte budget of the dense mean-normalized adjacency; 0 off
    dense_adjacency_max_bytes: int = 268_435_456
    # node numbering: patients by ascending lab degree, labs by descending
    # frequency, as the JAX graph build numbers them; off keeps first-seen
    # order.  Layout only, never results
    cluster_patients_by_degree: bool = True
    cluster_labs_by_frequency: bool = True
    # span-plan block height for big-source relations; 0 builds no span plan
    src_span_rows: int = 256
    # extras.num_shards (> 1: the graph build also writes the sharded
    # artifact, graph/distributed.py), extras.shard_kernel_plans
    extras: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        # read by nothing, as in JAX: the graph build decides the node types
        object.__setattr__(self, "node_types", tuple(self.node_types))
        _only(self.extras, {"num_shards", "shard_kernel_plans"}, "graph")


BILINEAR_SOURCES = ("head", "embedding", "context")


@dataclass(frozen=True)
class EdgeHeadConfig:
    hidden_dims: Tuple[int, ...] = (64, 32)
    final_activation: Optional[str] = None
    # extras.bilinear_rank (>= 0) and extras.bilinear_source (head |
    # embedding | context), written directly under edge_head as the JAX
    # factory reads them; a literal ``extras:`` mapping stays nested, as the
    # JAX config keeps it, and must not set a rank (JAX would ignore it)
    extras: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "hidden_dims", tuple(int(h) for h in self.hidden_dims))
        if self.final_activation is not None:
            raise ConfigError("model.edge_head.final_activation is not supported")
        nested = self.extras.get("extras") or {}
        for extras in (self.extras, nested):
            _only(extras, {"bilinear_rank", "bilinear_source", "extras"}, "model.edge_head")
        if int(nested.get("bilinear_rank", 0) or 0) > 0:
            raise ConfigError(
                "model.edge_head.extras.extras.bilinear_rank: the JAX factory reads the rank "
                "directly under model.edge_head and would ignore this one; move it there"
            )
        if self.bilinear_rank < 0:
            raise ConfigError(f"model.edge_head.bilinear_rank must be >= 0, got {self.bilinear_rank}")
        if self.bilinear_source not in BILINEAR_SOURCES:
            raise ConfigError(
                f"model.edge_head.bilinear_source must be one of {BILINEAR_SOURCES}, "
                f"got {self.bilinear_source!r}"
            )

    @property
    def bilinear_rank(self) -> int:
        return int(self.extras.get("bilinear_rank", 0) or 0)

    @property
    def bilinear_source(self) -> str:
        return str(self.extras.get("bilinear_source", "head"))


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
    # float32 | bfloat16 | auto: the models' compute dtype (parameters stay
    # float32); "auto" probes the card's tensor cores at model build
    # (utils/mxu_probe.py) and picks bfloat16 only where it measures faster
    compute_dtype: str = "float32"
    # run neighbor aggregation through the tiered kernels (ops/segment.py)
    use_pallas: bool = False
    # extras.head_style: auto | concat | factored and extras.dual_head_fusion:
    # auto | on | off (RGCN); extras.hgt_flash: auto | off and
    # extras.hgt_dense_attn_bytes (HGT); extras.value_context (both)
    extras: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.architecture not in ("RGCN", "HGT"):
            raise ConfigError(f"model.architecture must be RGCN|HGT, got {self.architecture!r}")
        if self.architecture == "HGT" and (self.num_heads <= 0 or self.hidden_dim % self.num_heads):
            raise ConfigError(
                f"model.num_heads={self.num_heads} must divide hidden_dim={self.hidden_dim}"
            )
        _only(self.extras, _MODEL_EXTRAS, "model")
        if self.edge_head.bilinear_source == "context" and not self.value_context:
            raise ConfigError(
                "model.edge_head.bilinear_source='context' requires model.extras.value_context=true: "
                "without the trainer's value visibility the context channel would read val / test "
                "values (the JAX factory refuses it too)"
            )
        if self.hgt_flash not in ("auto", "off"):
            raise ConfigError(f"model.extras.hgt_flash invalid: {self.hgt_flash!r}")
        if self.activation not in ("relu", "elu", "leaky_relu"):
            raise ConfigError(f"model.activation invalid: {self.activation!r}")
        if self.aggregation not in ("mean", "sum", "max"):
            raise ConfigError(f"model.aggregation invalid: {self.aggregation!r}")
        if self.compute_dtype not in ("float32", "bfloat16", "auto"):
            raise ConfigError(
                f"model.compute_dtype must be float32|bfloat16|auto, got {self.compute_dtype!r}"
            )
        if self.head_style not in ("auto", "concat", "factored"):
            raise ConfigError(f"model.extras.head_style invalid: {self.head_style!r}")

    @property
    def head_style(self) -> str:
        return str(self.extras.get("head_style", "auto"))

    @property
    def value_context(self) -> bool:
        return bool(self.extras.get("value_context", False))

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
    type: str = "adam"  # adam | sgd
    lr: float = 1e-3
    weight_decay: float = 1e-5
    momentum: float = 0.9  # sgd only
    # extra L2 decay on the ID-embedding tables (embed_*) only
    embedding_weight_decay: float = 0.0

    def __post_init__(self):
        if self.type.lower() not in ("adam", "sgd"):
            raise ConfigError(f"train.optimizer.type={self.type!r}: adam or sgd")


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
    # None = full batch; n > 0 trains Cluster-GCN mini-batches of about n
    # train rows (training/minibatch.py; train_pipeline's cluster count)
    batch_size: Optional[int] = None
    early_stopping_patience: int = 15
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)
    seed: int = 42
    # TPU device placement, accepted and dropped: the port runs where its
    # entry point's ``device`` says (the pipeline's --device)
    device: str = "auto"
    num_devices: int = 0
    donate_state: bool = True
    # epochs per Trainer.train_epochs call in fit(): 1 acts on every epoch;
    # k > 1 runs k epochs back to back and acts on chunk boundaries
    scan_chunk: int = 1
    # extras.lab_tile_rows (None/"auto" | int), extras.lab_tile_mode ("span"),
    # extras.lab_reweighting (bool), extras.auto_resume (bool: the pipeline's
    # train step resumes from the newest periodic checkpoint),
    # extras.warm_start (als | sideinfo | none | off | "") with
    # warm_start_rank / _mem_rank / _reg / _ridge_reg / _huber_delta,
    # extras.num_clusters (int >= 1), extras.host_resident (bool),
    # extras.cluster_balance (edges | patients): mini-batch training;
    # extras.parallel (dp | data): 1-D data parallelism over the ranks of
    # the launch, num_devices of them (0: the world size); (2d | dp2d) with
    # extras.model_parallel (default 2): the 2-D layout, the patient table
    # cut over a model axis (parallel/dp2d.py)
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
        if self.batch_size is not None and (
            isinstance(self.batch_size, bool) or not isinstance(self.batch_size, int) or self.batch_size < 1
        ):
            raise ConfigError(f"train.batch_size must be a positive integer or null, got {self.batch_size!r}")
        unknown = set(self.extras) - _TRAIN_EXTRAS
        if unknown:
            raise ConfigError(f"unsupported train extras: {sorted(unknown)}")
        parallel = str(self.extras.get("parallel", "") or "").lower()
        if parallel == "gspmd":
            raise ConfigError(f"train.extras.parallel: gspmd: {_GSPMD}")
        if parallel not in PARALLEL_MODES:
            raise ConfigError(f"unknown train.extras.parallel={parallel!r} (expected dp | 2d | gspmd)")
        mp = self.extras.get("model_parallel")
        if mp is not None and (isinstance(mp, bool) or not isinstance(mp, int) or mp < 1):
            raise ConfigError(f"train.extras.model_parallel must be a positive integer, got {mp!r}")
        if isinstance(self.num_devices, bool) or not isinstance(self.num_devices, int) or self.num_devices < 0:
            raise ConfigError(f"train.num_devices must be an integer >= 0, got {self.num_devices!r}")
        nc = self.extras.get("num_clusters")
        if nc is not None and (isinstance(nc, bool) or not isinstance(nc, int) or nc < 1):
            raise ConfigError(f"train.extras.num_clusters must be a positive integer, got {nc!r}")
        if str(self.extras.get("cluster_balance") or "edges") not in ("edges", "patients"):
            raise ConfigError(
                f"train.extras.cluster_balance must be edges | patients, got {self.extras['cluster_balance']!r}"
            )
        ws = self.extras.get("warm_start")
        # JAX reads str(value or "").lower(): None and false are off, true is refused
        if not (ws is None or ws is False or (isinstance(ws, str) and ws.lower() in _WARM_STARTS)):
            raise ConfigError(
                f"train.extras.warm_start must be one of als | sideinfo | none | off | '', got {ws!r}"
            )
        if str(self.extras.get("lab_tile_mode", "span")) != "span":
            raise ConfigError(
                "train.extras.lab_tile_mode: the PyTorch port runs span-mode lab tiles only"
            )

    @property
    def warm_start(self) -> str:
        """"als", "sideinfo", or "" for none (JAX ``train_pipeline``'s reading)."""
        ws = str(self.extras.get("warm_start", "") or "").lower()
        return "" if ws in ("none", "off") else ws

    @property
    def warm_start_rank(self) -> int:
        return int(self.extras.get("warm_start_rank", 8) or 8)

    @property
    def warm_start_mem_rank(self) -> int:
        return int(self.extras.get("warm_start_mem_rank", self.warm_start_rank) or self.warm_start_rank)


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
        _only(self.extras, _EVALUATION_EXTRAS, "evaluation")


@dataclass(frozen=True)
class VisualizationConfig:
    """The visualize step's settings (JAX ``VisualizationConfig``), read by
    :mod:`~multi_modal_gnn_tpu_torch.viz`; ``embedding_color_by`` and
    ``plot_edge_weight_distribution`` are read by nothing, as in JAX, and
    any extras are kept as given."""

    generate_embeddings: bool = True
    dim_reduction: str = "pca"
    embedding_color_by: Tuple[str, ...] = ("node_type",)
    generate_parity_plots: bool = True
    top_labs_to_plot: int = 10
    generate_subgraphs: bool = True
    num_example_subgraphs: int = 5
    missingness_heatmap: bool = True
    plot_degree_distribution: bool = True
    plot_edge_weight_distribution: bool = True
    extras: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "embedding_color_by", tuple(self.embedding_color_by))


@dataclass(frozen=True)
class LoggingConfig:
    level: str = "INFO"
    save_to_file: bool = True
    log_file: str = "outputs/training.log"
    # accepted and dropped: the port logs to no tracking service
    use_wandb: bool = False
    wandb_project: str = "ehr-graph-impute"
    wandb_entity: Optional[str] = None
    log_interval: int = 1
    save_checkpoints: bool = True
    checkpoint_interval: int = 10


@dataclass(frozen=True)
class ReproducibilityConfig:
    """``set_seeds`` seeds Python's and numpy's global generators from
    ``random_seed`` / ``numpy_seed`` (every draw of the port is keyed by
    ``train.seed`` anyway); ``debug_nans`` runs training under autograd's
    anomaly mode with its NaN check; ``deterministic: true`` is refused
    (see :data:`ATOMIC_TIERS`)."""

    set_seeds: bool = True
    numpy_seed: int = 42
    torch_seed: int = 42  # accepted for config compatibility; unused, as in JAX
    random_seed: int = 42
    deterministic: bool = False
    debug_nans: bool = False

    def __post_init__(self):
        if self.deterministic:
            raise ConfigError(
                "reproducibility.deterministic: true is refused: the port has no "
                f"order-fixed route; these tiers sum with float atomics: {ATOMIC_TIERS}"
            )


# The tiers whose sums change order from run to run (float atomics), named
# by reproducibility.deterministic's refusal.
ATOMIC_TIERS = (
    "the xla tier's index_add_ segment sums and row-gather backwards on the card "
    "(model.use_pallas: false), kernels K1 (windowed segment sum), K2f (fused-table "
    "mean), K2b (its backward, split counts), K4b / K5b (pair-head backward: dPp, "
    "dPl), K7 / K8 (flash attention dq, dk / dv) and the plain versions' index_add_ "
    "on several CPU threads"
)


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    cohort: CohortConfig = field(default_factory=CohortConfig)
    feature_space: FeatureSpaceConfig = field(default_factory=FeatureSpaceConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    visualization: VisualizationConfig = field(default_factory=VisualizationConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    reproducibility: ReproducibilityConfig = field(default_factory=ReproducibilityConfig)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        """Build from a dict shaped like the JAX ``Config.to_dict()`` or a
        YAML file of ``conf/``; a missing section takes its defaults."""
        unknown = set(d) - set(_SECTIONS)
        if unknown:
            raise ConfigError(f"unknown config section(s): {sorted(unknown)}")
        return Config(**{name: build(dict(d.get(name) or {})) for name, build in _SECTIONS.items()})

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
        (``model``, ``graph``, ``feature_space``), equal to JAX
        ``Config.model_hash``: run-length and optimizer settings may differ
        at resume."""
        d = self.to_dict()
        return _hash({k: d.get(k) for k in ("model", "graph", "feature_space")})

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def _hash(d: Dict[str, Any]) -> str:
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _only(extras: Dict[str, Any], allowed: set, section: str) -> None:
    unknown = set(extras) - allowed
    if unknown:
        raise ConfigError(f"unsupported {section} setting(s): {sorted(unknown)}")


_MODEL_EXTRAS = {"head_style", "dual_head_fusion", "hgt_flash", "hgt_dense_attn_bytes", "value_context"}
_TRAIN_EXTRAS = {
    "lab_tile_rows", "lab_tile_mode", "lab_reweighting", "auto_resume", "warm_start",
    "warm_start_rank", "warm_start_mem_rank", "warm_start_reg", "warm_start_ridge_reg",
    "warm_start_huber_delta", "num_clusters", "host_resident", "cluster_balance", "parallel",
    "model_parallel",
}
_WARM_STARTS = ("als", "sideinfo", "none", "off", "")
_GSPMD = (
    "XLA's partitioner placing the collectives has no PyTorch counterpart in the port "
    "(ROADMAP.md queue 1 item 8c); the explicit 2-D layout is parallel: 2d"
)
# train.extras.parallel: "" / none / off (one process), dp / data (1-D data
# parallelism over the launch's ranks, parallel/dp.py) or 2d / dp2d (the
# patient table cut over a model axis too, parallel/dp2d.py)
PARALLEL_MODES = ("", "none", "off", "dp", "data", "2d", "dp2d")
_BASELINES = {"global_mean", "per_lab_mean", "nearest_neighbor", "als", "sideinfo_als"}
_EVALUATION_EXTRAS = {"conformal_alpha", "conformal_split_fraction", "huber_delta"}


def _fields(cls) -> set:
    return {f.name for f in dataclasses.fields(cls)}


def _take(d: Dict[str, Any], cls, name: str, merge_extras: bool = False, **built):
    """``cls`` from a section dict: keys that are fields set them (``built``
    replaces the nested sections), the rest become ``extras`` as the JAX
    config keeps them, or raise for a class without ``extras``.  With
    ``merge_extras`` a literal ``extras:`` mapping is merged into them (the
    port's sections that always read it so)."""
    names = _fields(cls) - {"extras"}
    kwargs = {k: v for k, v in d.items() if k in names}
    kwargs.update(built)
    extras = {k: v for k, v in d.items() if k not in names}
    if merge_extras and isinstance(extras.get("extras"), dict):
        extras = {**extras.pop("extras"), **extras}
    if "extras" in _fields(cls):
        return cls(**kwargs, extras=extras)
    if extras:
        raise ConfigError(f"unsupported {name} setting(s): {sorted(extras)}")
    return cls(**kwargs)


def _sub(d: Dict[str, Any], key: str) -> Dict[str, Any]:
    value = d.get(key) or {}
    if not isinstance(value, dict):
        raise ConfigError(f"{key} must be a mapping, got {value!r}")
    return dict(value)


def _feature_space(d):
    parts = {
        "labs": LabsConfig, "diagnoses": DiagnosesConfig,
        "medications": MedicationsConfig, "demographics": DemographicsConfig,
    }
    built = {k: _take(_sub(d, k), cls, f"feature_space.{k}") for k, cls in parts.items()}
    return _take(d, FeatureSpaceConfig, "feature_space", **built)


def _graph(d):
    built = {}
    if "edge_types" in d:
        built["edge_types"] = {
            name: _take(dict(et or {}), EdgeTypeConfig, f"graph.edge_types.{name}")
            for name, et in (d["edge_types"] or {}).items()
        }
    return _take(d, GraphConfig, "graph", **built)


def _model(d):
    head = _take(_sub(d, "edge_head"), EdgeHeadConfig, "model.edge_head")
    return _take(d, ModelConfig, "model", merge_extras=True, edge_head=head)


def _train(d):
    d["scan_chunk"] = int(d.get("scan_chunk", 1) or 1)
    return _take(
        d, TrainConfig, "train", merge_extras=True,
        optimizer=_take(_sub(d, "optimizer"), OptimizerConfig, "train.optimizer"),
        lr_scheduler=_take(_sub(d, "lr_scheduler"), LRSchedulerConfig, "train.lr_scheduler"),
    )


_SECTIONS = {
    "data": lambda d: _take(d, DataConfig, "data"),
    "cohort": lambda d: _take(d, CohortConfig, "cohort"),
    "feature_space": _feature_space,
    "graph": _graph,
    "model": _model,
    "train": _train,
    "evaluation": lambda d: _take(d, EvaluationConfig, "evaluation", merge_extras=True),
    "visualization": lambda d: _take(d, VisualizationConfig, "visualization"),
    "logging": lambda d: _take(d, LoggingConfig, "logging"),
    "reproducibility": lambda d: _take(d, ReproducibilityConfig, "reproducibility"),
}


def load_config(path="conf/config.yaml") -> Config:
    """Read and validate a YAML config file (JAX ``config.load_config``)."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Config file not found: {path}")
    return Config.from_dict(yaml_subset.load_file(path) or {})


def save_config(config: Config, path) -> Path:
    """Write ``config`` as block YAML that :func:`load_config` and
    ``yaml.safe_load`` read back (JAX ``config.save_config``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml_subset.dump(config.to_dict()))
    return path
