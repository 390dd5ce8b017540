"""Serving with cached node state (``multi_modal_gnn_tpu/serving.py``).

For a frozen model and graph the node state is constant: it is computed
once by one eval-mode forward over the full graph, and each request runs
only the pair heads on its (patient, lab) batch.  The ``trainer`` entry
points serve the trainer's best validation state once ``fit`` has recorded
one, and its live parameters before that, as the JAX package does;
:func:`compute_node_state` and :func:`build_serving_fn` serve the model
they are given.

Two surfaces:

``build_serving_fn`` / ``build_trainer_serving_fn``
    In-process: ``fn(p_idx, l_idx) -> predictions``, eager launches over the
    cached state.

``export_serving(trainer, bundle, path)`` / ``ServingModel.load(path)``
    Out-of-process: the pair heads over the cached state as one
    ``torch.export`` program per padding bucket (``pairs_b{b}.pt2``, a
    static ``(b,)`` int32 batch).  Every tensor the request path reads (the
    head parameters and the node state) is an input of the programs, stored
    once in ``weights.npz`` and listed in the manifest (``serving.json``)
    with its dtype (a bfloat16 leaf, whose dtype numpy lacks, is stored as
    its ``uint16`` bit pattern; a manifest without ``leaf_dtypes`` is
    float32 throughout), so
    a serving host needs this directory and torch, no model code, config or
    graph.  Requests of any size are chunked by the largest bucket and padded
    to the smallest that fits.  On the card :meth:`ServingModel.load`
    captures each bucket's program in a CUDA graph over static buffers, and a
    request is one host-to-device copy, one replay and one readback; on the
    CPU the programs run as exported.  An artifact exported on either device
    loads on the other.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.evaluation.baselines import ALSBaseline, SideInfoALSBaseline
from multi_modal_gnn_tpu_torch.evaluation.conformal import ConformalCalibrator
from multi_modal_gnn_tpu_torch.graph.hetero import HeteroGraph
from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT
from multi_modal_gnn_tpu_torch.models.hgt import HeteroGT
from multi_modal_gnn_tpu_torch.models.rgcn import HeteroRGCN
from multi_modal_gnn_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

Model = Union[HeteroRGCN, HeteroGT]

FORMAT = "multi_modal_gnn_tpu_torch.serving/v1"
_MANIFEST = "serving.json"
DEFAULT_BUCKETS = (256, 4096)
# the submodules predict_pairs_cached reads (HGT has only the edge predictor)
_HEAD_MODULES = ("tabular_mlp", "edge_predictor")
_STATE = "state."


def compute_node_state(model: Model, graph: HeteroGraph) -> Dict[str, torch.Tensor]:
    """Put ``model`` in eval mode and run the forward that fills the state
    (``final_p``, ``final_l``; the RGCN adds ``init_p``, ``init_l`` and
    ``degree``)."""
    model.eval()
    with torch.no_grad():
        return model.compute_node_state(graph)


def _as_index(idx, bound: int, name: str, device) -> torch.Tensor:
    """A 1-D index batch on ``device`` as int64, every index in ``[0,
    bound)``.  A batch on the host is checked there before its one copy; a
    batch already on the card costs one readback (its min and max)."""
    if isinstance(idx, torch.Tensor) and idx.device.type != "cpu":
        t = idx
        if t.dim() != 1:
            raise ValueError(f"{name}: expected a 1-D index batch, got shape {tuple(t.shape)}")
        if t.numel():
            lo, hi = torch.stack(torch.aminmax(t)).tolist()
    else:
        t = idx.numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
        if t.ndim != 1:
            raise ValueError(f"{name}: expected a 1-D index batch, got shape {tuple(t.shape)}")
        if t.size:
            lo, hi = t.min(), t.max()
    if t.shape[0] and (lo < 0 or hi >= bound):
        raise IndexError(f"{name}: indices must lie in [0, {bound})")
    return torch.as_tensor(t).to(device=device, dtype=torch.long)


def build_serving_fn(
    model: Model,
    graph: HeteroGraph,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[Callable, Dict[str, torch.Tensor]]:
    """``(fn, state)`` with ``fn(p_idx, l_idx) -> predictions`` (float32)
    computed on the state's device from the cached node state."""
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
            return model.predict_pairs_cached(state, p, l).float()

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


# -- the artifact ------------------------------------------------------------------


class _CachedPairs(torch.nn.Module):
    """``model.predict_pairs_cached`` as a forward, for ``functional_call``."""

    def __init__(self, model: Model):
        super().__init__()
        self.model = model

    def forward(self, state, p_idx, l_idx):
        out = self.model.predict_pairs_cached(state, p_idx, l_idx)
        # a bfloat16 model's unfused heads answer in bfloat16; answers leave as float32
        return out if out.dtype == torch.float32 else out.float()


class _PairsProgram(torch.nn.Module):
    """``forward(*leaves, p_idx, l_idx)``: the request path with every tensor
    it reads passed in, the head parameters by name and the node state as
    ``state.<key>``.  The model is held outside the module tree, so
    ``torch.export`` lifts none of its tensors into the program."""

    def __init__(self, model: Model, names: Sequence[str]):
        super().__init__()
        self.__dict__["_cached"] = _CachedPairs(model)
        self.names = list(names)

    def forward(self, *args):
        *leaves, p_idx, l_idx = args
        params, state = {}, {}
        for name, leaf in zip(self.names, leaves):
            if name.startswith(_STATE):
                state[name[len(_STATE):]] = leaf
            else:
                params[f"model.{name}"] = leaf
        return torch.func.functional_call(self._cached, params, (state, p_idx, l_idx))


def _leaves(model: Model, state: Dict[str, torch.Tensor]) -> Tuple[List[str], List[torch.Tensor]]:
    """The head parameters and the node state, as names and tensors."""
    named = [(name, t.detach()) for name, t in model.named_parameters() if name.split(".")[0] in _HEAD_MODULES]
    named += [(_STATE + key, state[key]) for key in sorted(state)]
    return [n for n, _ in named], [t for _, t in named]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf for ``weights.npz``: numpy has no bfloat16, so a bfloat16 leaf
    goes in as its ``uint16`` bit pattern."""
    t = t.detach().cpu()
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """:func:`_to_numpy` undone, by the manifest's name of the leaf's dtype."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(a)
    if _dtype_name(t) != dtype_name:
        raise ValueError(f"weights.npz holds {t.dtype} where the manifest names {dtype_name}")
    return t


def export_serving(
    trainer,
    bundle,
    path,
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
    cold_start=None,
    conformal=None,
    conformal_cold=None,
) -> Path:
    """Write the serving artifact: ``weights.npz``, one ``pairs_b{b}.pt2``
    per padding bucket and ``serving.json``.  ``bundle`` supplies the lab
    names and stats of the manifest (denormalization runs in
    :class:`ServingModel` on the host).

    ``cold_start`` (an :class:`ALSBaseline` or :class:`SideInfoALSBaseline`
    fitted on the train split) ships its lab factors in ``coldstart.npz``,
    so the served model can fold in patients outside the graph.
    ``conformal`` (``calibrate_from_trainer(trainer)``) ships per-lab
    interval radii in ``conformal.json`` for ``predict(...,
    return_interval=True)``; ``conformal_cold`` (``calibrate_cold_start``)
    the fold-in channel's own radii in ``conformal_cold.json``."""
    model = serving_model(trainer)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    state = compute_node_state(model, trainer.graph)
    names, leaves = _leaves(model, state)
    device = leaves[-1].device
    np.savez(path / "weights.npz", **{f"w{i}": _to_numpy(t) for i, t in enumerate(leaves)})
    program = _PairsProgram(model, names)
    buckets = tuple(sorted(set(int(b) for b in buckets)))
    for b in buckets:
        spec = (torch.zeros(b, dtype=torch.int32, device=device), torch.zeros(b, dtype=torch.int32, device=device))
        exported = torch.export.export(program, (*leaves, *spec), strict=False)
        lifted = [*exported.state_dict, *exported.constants]
        if lifted:
            raise RuntimeError(f"the bucket-{b} program holds tensors that are not inputs: {lifted}")
        # save() writes the example inputs, every leaf, into the program
        exported.example_inputs = None
        torch.export.save(exported, path / f"pairs_b{b}.pt2")

    if cold_start is not None:
        extra = {}
        mem_proj = getattr(cold_start, "mem_proj", None)
        if mem_proj is not None and getattr(cold_start, "H", None) is not None and np.size(mem_proj) > 0:
            # side-information factors: cold start then conditions on the
            # dx / rx memberships too, with no observed labs as well
            extra = {"H": cold_start.H, "mem_proj": mem_proj}
        np.savez(
            path / "coldstart.npz",
            C=cold_start.C,
            lab_bias=cold_start.lab_bias,
            reg=np.float64(cold_start.reg),
            **extra,
        )
    if conformal is not None:
        conformal.save(path / "conformal.json")
    if conformal_cold is not None:
        if cold_start is None:
            raise ValueError("conformal_cold requires cold_start factors")
        conformal_cold.save(path / "conformal_cold.json")

    meta = bundle.meta
    manifest = {
        "format": FORMAT,
        "buckets": list(buckets),
        "num_patients": int(trainer.graph.num_nodes(PATIENT)),
        "num_labs": int(trainer.graph.num_nodes(LAB)),
        "model_hash": trainer.config.model_hash(),
        "architecture": trainer.config.model.architecture,
        "lab_names": {int(k): v for k, v in meta.lab_names.items()},
        "lab_stats": {int(k): v for k, v in meta.lab_stats.items()},
        "normalize_method": trainer.config.feature_space.labs.normalize,
        "export_platform": device.type,
        "leaves": names,
        "leaf_dtypes": [_dtype_name(t) for t in leaves],
    }
    (path / _MANIFEST).write_text(json.dumps(manifest, indent=1))
    logger.info("Serving artifact exported to %s (buckets %s)", path, buckets)
    return path


class _Bucket:
    """One bucket's program over the loaded leaves: ``run(p, l)`` pads the
    int32 host batches to ``size`` and returns the first ``len(p)``
    predictions.  On the CPU the exported module runs as it is.  On the card
    the program is captured once in a CUDA graph over static buffers: a call
    writes the batch into a pinned buffer, copies it over once, replays the
    graph and reads the predictions back once."""

    def __init__(self, module: torch.nn.Module, leaves: List[torch.Tensor], size: int, pool=None):
        # a captured graph reads the leaves where they lie: the bucket holds them
        self.module, self.leaves = module, leaves
        device = leaves[0].device
        self.cuda = device.type == "cuda"
        self.host_in = torch.zeros((2, size), dtype=torch.int32, pin_memory=self.cuda)
        if not self.cuda:
            return
        self.dev_in = torch.zeros((2, size), dtype=torch.int32, device=device)
        p_idx, l_idx = self.dev_in[0], self.dev_in[1]
        # warm up on a side stream before the capture, as torch.cuda.graph asks
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.no_grad(), torch.cuda.stream(side):
            for _ in range(2):
                module(*leaves, p_idx, l_idx)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(self.graph, pool=pool):
            self.dev_out = module(*leaves, p_idx, l_idx)
        self.host_out = torch.empty(self.dev_out.shape, dtype=self.dev_out.dtype, pin_memory=True)
        self.stream = torch.cuda.current_stream(device)

    def run(self, p: np.ndarray, l: np.ndarray) -> np.ndarray:
        n = len(p)
        batch = self.host_in.numpy()
        batch[0, :n], batch[1, :n] = p, l
        batch[:, n:] = 0
        if not self.cuda:
            with torch.no_grad():
                return self.module(*self.leaves, self.host_in[0], self.host_in[1])[:n].numpy()
        self.dev_in.copy_(self.host_in, non_blocking=True)
        self.graph.replay()
        self.host_out.copy_(self.dev_out, non_blocking=True)
        self.stream.synchronize()
        return self.host_out[:n].numpy().copy()


@dataclasses.dataclass
class ServingModel:
    """Loads an :func:`export_serving` artifact and serves predictions.

    ``predict`` pads each request to the smallest bucket that fits (chunking
    by the largest bucket first), so every call runs a program loaded (and,
    on the card, captured) at :meth:`load`.  ``denormalize=True`` maps
    predictions back to lab units through the manifest's per-lab stats for
    ``zscore`` artifacts, and is the identity for the other normalizations
    (as ``inference.Denormalizer``)."""

    manifest: dict
    _buckets: Dict[int, _Bucket]
    _cold: Optional[dict] = None
    _denorm_mean: Optional[np.ndarray] = None
    _denorm_std: Optional[np.ndarray] = None
    _conformal: Optional[ConformalCalibrator] = None
    _conformal_cold: Optional[ConformalCalibrator] = None
    # each lab's name in index order, from the manifest ("Lab_<i>" without one)
    _lab_names: List[str] = dataclasses.field(default_factory=list)

    @classmethod
    def load(cls, path, device=None) -> "ServingModel":
        """The artifact at ``path`` on ``device`` (default: the card; raises
        without one).  On the card every bucket's program is captured in a
        CUDA graph here; a failed capture raises."""
        from torch.export.passes import move_to_device_pass

        device = resolve_device(device)
        path = Path(path)
        manifest = json.loads((path / _MANIFEST).read_text())
        if manifest.get("format") != FORMAT:
            raise ValueError(
                f"{path / _MANIFEST}: format {manifest.get('format')!r} is not {FORMAT!r}; an artifact "
                "of multi_modal_gnn_tpu holds StableHLO programs, which torch cannot run: export with "
                "multi_modal_gnn_tpu_torch.serving.export_serving"
            )
        n_leaves = len(manifest["leaves"])
        dtypes = manifest.get("leaf_dtypes")
        with np.load(path / "weights.npz") as z:
            leaves = [
                (torch.from_numpy(z[f"w{i}"]) if dtypes is None else _from_numpy(z[f"w{i}"], dtypes[i])).to(device)
                for i in range(n_leaves)
            ]
        pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        buckets = {}
        for b in manifest["buckets"]:
            program = move_to_device_pass(torch.export.load(path / f"pairs_b{b}.pt2"), str(device))
            buckets[int(b)] = _Bucket(program.module(), leaves, int(b), pool)
        cold = None
        if (path / "coldstart.npz").exists():
            with np.load(path / "coldstart.npz") as z:
                cold = {k: z[k] for k in z.files}
        conformal = conformal_cold = None
        if (path / "conformal.json").exists():
            conformal = ConformalCalibrator.load(path / "conformal.json")
        if (path / "conformal_cold.json").exists():
            conformal_cold = ConformalCalibrator.load(path / "conformal_cold.json")
        # denormalization tables: identity where stats are missing or the
        # normalization is not zscore
        n_lab = manifest["num_labs"]
        mean, std = np.zeros(n_lab), np.ones(n_lab)
        if manifest.get("normalize_method", "zscore") == "zscore":
            for k, s in manifest.get("lab_stats", {}).items():
                i = int(k)
                if 0 <= i < n_lab:
                    mean[i] = float(s.get("mean", 0.0))
                    std[i] = float(s.get("std", 1.0))
        names = manifest["lab_names"]
        return cls(
            manifest=manifest, _buckets=buckets, _cold=cold,
            _denorm_mean=mean, _denorm_std=std, _conformal=conformal, _conformal_cold=conformal_cold,
            _lab_names=[names.get(str(i), names.get(i, f"Lab_{i}")) for i in range(n_lab)],
        )

    @property
    def buckets(self):
        return sorted(self._buckets)

    def _call_padded(self, p: np.ndarray, l: np.ndarray) -> np.ndarray:
        n = len(p)
        bucket = next((b for b in self.buckets if b >= n), None)
        if bucket is None:
            raise ValueError(
                f"request of {n} pairs exceeds the largest bucket "
                f"{self.buckets[-1]} — use predict(), which chunks"
            )
        return self._buckets[bucket].run(p, l)

    def predict(self, patient_idx, lab_idx, denormalize: bool = False, return_interval: bool = False):
        """Point predictions; with ``return_interval=True`` also the
        conformal ``(lower, upper)`` bounds from the shipped calibration.
        Denormalization maps the bounds by the same per-lab affine map (std
        > 0, so they stay ordered and keep their coverage)."""
        p = np.asarray(patient_idx, dtype=np.int32).reshape(-1)
        l = np.asarray(lab_idx, dtype=np.int32).reshape(-1)
        if p.shape != l.shape:
            raise ValueError(f"patient/lab shape mismatch: {p.shape} vs {l.shape}")
        if return_interval and self._conformal is None:
            raise ValueError(
                "artifact has no conformal.json — re-export with "
                "export_serving(..., conformal=calibrate_from_trainer(trainer))"
            )
        if len(p) == 0:
            empty = np.zeros(0, np.float32)
            return (empty, empty, empty) if return_interval else empty
        n_pat, n_lab = self.manifest["num_patients"], self.manifest["num_labs"]
        if p.min() < 0 or p.max() >= n_pat:
            raise ValueError(f"patient index out of range [0, {n_pat})")
        if l.min() < 0 or l.max() >= n_lab:
            raise ValueError(f"lab index out of range [0, {n_lab})")

        big = self.buckets[-1]
        preds = np.concatenate(
            [self._call_padded(p[i : i + big], l[i : i + big]) for i in range(0, len(p), big)]
        )
        lo = hi = None
        if return_interval:
            lo, hi = self._conformal.intervals(preds, l)
        if denormalize:
            preds = preds * self._denorm_std[l] + self._denorm_mean[l]
            if return_interval:
                lo = lo * self._denorm_std[l] + self._denorm_mean[l]
                hi = hi * self._denorm_std[l] + self._denorm_mean[l]
        return (preds, lo, hi) if return_interval else preds

    def predict_patient(self, patient_idx: int, denormalize: bool = False) -> Dict[str, float]:
        """All labs for one patient -> ``{lab_name: prediction}``."""
        num_labs = self.manifest["num_labs"]
        labs = np.arange(num_labs, dtype=np.int32)
        preds = self.predict(np.full(num_labs, patient_idx, np.int32), labs, denormalize=denormalize)
        return dict(zip(self._lab_names, preds.tolist()))

    def predict_cold_start(
        self,
        observed: Dict[int, float],
        denormalize: bool = False,
        memberships: Optional[np.ndarray] = None,
        return_interval: bool = False,
    ) -> Dict[str, float]:
        """All-lab predictions for an unseen patient from their observed
        normalized lab values ``{lab index: value}``, by the shipped ALS
        fold-in factors (one ridge solve on the host).  ``memberships`` (the
        patient's binary dx / rx row, laid out as
        ``evaluation.graph_membership_matrix``'s rows) conditions on the
        diagnoses and medications too, when the artifact was exported from a
        :class:`SideInfoALSBaseline`.  ``return_interval=True`` gives
        ``{"predicted": v, "interval": [lo, hi]}`` values from the fold-in
        channel's own radii (``conformal_cold.json``)."""
        if self._cold is None:
            raise ValueError(
                "artifact has no coldstart.npz — re-export with "
                "export_serving(..., cold_start=fitted_ALSBaseline)"
            )
        if return_interval and self._conformal_cold is None:
            raise ValueError(
                "artifact has no conformal_cold.json — re-export with "
                "export_serving(..., conformal_cold=calibrate_cold_start(...))"
            )
        n_lab = self.manifest["num_labs"]
        obs_l = np.asarray(sorted(observed), dtype=np.int64)
        if len(obs_l) and (obs_l.min() < 0 or obs_l.max() >= n_lab):
            raise ValueError(f"observed lab index out of range [0, {n_lab})")
        obs_v = np.asarray([observed[int(i)] for i in obs_l], dtype=np.float64)
        # the shipped factors are a baseline's: rebuild it, so the fold-in
        # lives in one place
        rank = self._cold["C"].shape[1]
        queries = np.arange(n_lab)
        if memberships is not None:
            if "mem_proj" not in self._cold:
                raise ValueError(
                    "artifact has no side-information factors — re-export "
                    "with export_serving(..., cold_start=fitted_SideInfoALSBaseline)"
                )
            si = SideInfoALSBaseline(
                1, n_lab, rank=rank, mem_rank=self._cold["H"].shape[1], reg=float(self._cold["reg"])
            )
            si.C, si.lab_bias = self._cold["C"], self._cold["lab_bias"]
            si.H, si.mem_proj = self._cold["H"], self._cold["mem_proj"]
            preds = si.predict_cold_start(obs_l, obs_v, queries, memberships)
        else:
            als = ALSBaseline(1, n_lab, rank=rank, reg=float(self._cold["reg"]))
            als.C, als.lab_bias = self._cold["C"], self._cold["lab_bias"]
            preds = als.predict_cold_start(obs_l, obs_v, queries)
        lo = hi = None
        if return_interval:
            lo, hi = self._conformal_cold.intervals(preds, queries)
        if denormalize:
            preds = preds * self._denorm_std + self._denorm_mean
            if return_interval:
                lo = lo * self._denorm_std + self._denorm_mean
                hi = hi * self._denorm_std + self._denorm_mean
        if return_interval:
            return {
                name: {"predicted": v, "interval": [a, b]}
                for name, v, a, b in zip(self._lab_names, preds.tolist(), lo.tolist(), hi.tolist())
            }
        return dict(zip(self._lab_names, preds.tolist()))
