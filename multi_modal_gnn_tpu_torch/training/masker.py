"""Edge-level train/val/test splits and mask-and-recover supervision
(``multi_modal_gnn_tpu/training/masker.py``).

* The valid patient->lab edges are permuted once by
  ``np.random.default_rng(seed)`` and cut into train/val/test, exactly as
  the JAX masker does, so both packages split a graph identically.
* Message passing always sees the full graph; a split only selects which
  edges are supervised or evaluated.
* Each epoch supervises a fresh Bernoulli(mask_fraction) subset of the
  train rows, drawn by a ``torch.Generator`` keyed by (seed, epoch) on the
  batch's device.  The JAX masker draws with ``jax.random``: same
  distribution, other numbers.
* Slot-major train batches (:func:`_pad_batch`) are laid out in the patient
  gather plan's window-slot order, optionally regrouped into span-bounded lab
  tiles, so the fused pair head (``ops/pairhead.py``) reads each tile's
  patients from one 128-row window and its labs from one ``lab_block_rows``
  slice of the lab table.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.graph.hetero import (
    SPAN_BASE_ALIGN,
    WINDOW,
    GatherPlan,
    HeteroGraph,
    _tensor,
    build_gather_plan,
    regroup_slots_by_lab_span,
)
from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT, PATIENT_LAB
from multi_modal_gnn_tpu_torch.utils.rng import stream_seed

# below this many train rows the slot-major layout's window padding costs
# more than it saves (the JAX package's measured threshold)
SLOT_MAJOR_MIN_ROWS = 262_144


def auto_lab_tile_rows(num_labs: Optional[int]) -> int:
    """256-row span lab tiles once the padded lab table has >= 512 rows,
    else 0 (off): the JAX package's measured default."""
    if not num_labs:
        return 0
    labs_pad = ((int(num_labs) + 127) // 128) * 128
    return 256 if labs_pad >= 512 else 0


def resolve_lab_tile_rows(raw, num_labs, use_pallas: bool) -> int:
    """Config knob -> lab_block_rows: explicit values (incl. 0) win; unset
    (None or "auto") takes :func:`auto_lab_tile_rows` on the kernel path."""
    if raw is not None and str(raw) != "auto":
        return int(raw)
    if not use_pallas:
        return 0
    return auto_lab_tile_rows(num_labs)


@dataclass
class SplitBatch:
    """A padded batch of supervised patient-lab edges.

    ``patient_plan`` / ``lab_plan`` let the backward of the batch's row
    gathers run the windowed segment kernel; a slot-major batch carries an
    identity patient plan and no lab plan.  ``degrees`` and
    ``sample_weights`` are per-slot precomputes the trainer attaches once."""

    patient_idx: torch.Tensor  # int32 [B_pad]
    lab_idx: torch.Tensor  # int32 [B_pad]
    values: torch.Tensor  # float32 [B_pad] normalised lab values (targets)
    valid: torch.Tensor  # float32 [B_pad] 1 = real edge, 0 = padding
    patient_plan: Optional[GatherPlan] = None
    lab_plan: Optional[GatherPlan] = None
    degrees: Optional[torch.Tensor] = None  # int32 [B_pad] patient lab-degree
    sample_weights: Optional[torch.Tensor] = None  # float32 [B_pad] lab weight
    num_valid: int = 0

    def to(self, device) -> "SplitBatch":
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, GatherPlan)):
                moved[f.name] = v.to(device)
        return dataclasses.replace(self, **moved)


def _pad_batch(
    p: np.ndarray,
    l: np.ndarray,
    v: np.ndarray,
    pad_multiple: int,
    num_patients: Optional[int] = None,
    num_labs: Optional[int] = None,
    slot_major: bool = False,
    lab_block_rows: int = 0,
) -> Tuple[SplitBatch, Optional[np.ndarray]]:
    """Pad (and optionally slot-reorder) a supervised batch.

    ``slot_major``: lay the batch out in the patient gather plan's window-slot
    order (the batch grows to the plan's slot count); with
    ``lab_block_rows`` each window's slots are regrouped into span-bounded
    lab tiles.  Returns ``(batch, row_slots)``: ``row_slots[i]`` is the slot
    holding original row ``i`` (None unless slot-major)."""
    n = len(p)
    n_pad = max(pad_multiple, ((n + pad_multiple - 1) // pad_multiple) * pad_multiple)
    pad = n_pad - n
    p_pad = np.concatenate([p, np.zeros(pad, np.int32)]).astype(np.int32)
    l_pad = np.concatenate([l, np.zeros(pad, np.int32)]).astype(np.int32)
    v_pad = np.concatenate([v, np.zeros(pad, np.float32)]).astype(np.float32)
    valid_pad = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    patient_plan = lab_plan = None
    row_slots = None
    if num_patients is not None and num_labs is not None:
        # padding rows point at row 0; their cotangents are exactly zero
        patient_plan = build_gather_plan(p_pad, num_patients)
        if slot_major:
            win_src = patient_plan.win_src.numpy()
            win_local = patient_plan.win_local.numpy()
            real_slot = win_local < WINDOW
            p_pad = np.where(real_slot, p_pad[win_src], 0).astype(np.int32)
            l_pad = np.where(real_slot, l_pad[win_src], 0).astype(np.int32)
            v_pad = np.where(real_slot, v_pad[win_src], 0.0).astype(np.float32)
            valid_pad = np.where(real_slot, valid_pad[win_src], 0.0).astype(np.float32)
            row_slots = np.zeros(n_pad, dtype=np.int32)
            row_slots[win_src[real_slot]] = np.nonzero(real_slot)[0]
            tile_map = patient_plan.win_tile_map.numpy()
            lab_block_map = None
            if lab_block_rows:
                moves, e2, win_local, tile_map, lab_block_map = regroup_slots_by_lab_span(
                    win_local, tile_map, l_pad, num_labs, lab_block_rows
                )

                def relay(a, fill, dtype):
                    out = np.full(e2, fill, dtype=dtype)
                    m = moves >= 0
                    out[moves[m]] = a[m]
                    return out

                p_pad = relay(p_pad, 0, np.int32)
                l_pad = relay(l_pad, 0, np.int32)
                v_pad = relay(v_pad, 0.0, np.float32)
                valid_pad = relay(valid_pad, 0.0, np.float32)
                row_slots = moves[row_slots].astype(np.int32)
            patient_plan = GatherPlan(
                win_src=torch.zeros(len(win_local), dtype=torch.int32),  # unused under identity
                win_local=_tensor(np.asarray(win_local, np.int32)),
                win_tile_map=_tensor(np.asarray(tile_map, np.int32)),
                num_windows=patient_plan.num_windows,
                num_rows=patient_plan.num_rows,
                identity=True,
                lab_block_map=_tensor(lab_block_map),
                lab_block_rows=int(lab_block_rows),
                lab_span_mode=bool(lab_block_rows),
            )
        else:
            lab_plan = build_gather_plan(l_pad, num_labs)
    return SplitBatch(
        patient_idx=_tensor(p_pad),
        lab_idx=_tensor(l_pad),
        values=_tensor(v_pad),
        valid=_tensor(valid_pad.astype(np.float32)),
        patient_plan=patient_plan,
        lab_plan=lab_plan,
        num_valid=n,
    ), row_slots


class EdgeMasker:
    """Seeded edge-level splits over the patient->lab relation."""

    def __init__(
        self,
        graph: HeteroGraph,
        train_split: float = 0.7,
        val_split: float = 0.15,
        test_split: float = 0.15,
        mask_fraction: float = 0.2,
        seed: int = 42,
        pad_multiple: int = 256,
        slot_major_train: bool = False,
        slot_major_min_rows: int = SLOT_MAJOR_MIN_ROWS,
        lab_block_rows: int = 0,
        calibration_split: float = 0.0,
    ):
        """``slot_major_train``: lay the train batch out slot-major (see
        :func:`_pad_batch`) when it has at least ``slot_major_min_rows``
        rows.  ``lab_block_rows`` (0 = off, else a multiple of 16):
        span-bounded lab tiles for the slot-major layout.
        ``calibration_split``: the share of the val edges carved into a
        "cal" split for strict conformal calibration, drawn from the same
        generator after the permutation, so train and test are those of
        ``calibration_split=0`` (the JAX masker's draw)."""
        total = train_split + val_split + test_split
        if abs(total - 1.0) > 1e-6:
            raise ValueError(f"Splits must sum to 1.0, got {total}")
        self.mask_fraction = float(mask_fraction)
        self.seed = int(seed)
        self.pad_multiple = int(pad_multiple)
        self.slot_major_train = bool(slot_major_train)
        self.slot_major_min_rows = int(slot_major_min_rows)
        self.lab_block_rows = int(lab_block_rows)
        if self.lab_block_rows % SPAN_BASE_ALIGN:
            raise ValueError(
                f"span-mode lab_block_rows must be a multiple of {SPAN_BASE_ALIGN}, "
                f"got {self.lab_block_rows}"
            )
        self._num_patients = graph.num_nodes(PATIENT)
        self._num_labs = graph.num_nodes(LAB)

        es = graph.edges[PATIENT_LAB]
        if es.val is None:
            raise ValueError("patient->lab edges carry no values to supervise")
        mask = es.mask.cpu().numpy() > 0
        self._p = es.src.cpu().numpy()[mask].astype(np.int32)
        self._l = es.dst.cpu().numpy()[mask].astype(np.int32)
        self._v = es.val.cpu().numpy()[mask].astype(np.float32)
        self.num_edges = int(len(self._p))

        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(self.num_edges)
        n_train = int(train_split * self.num_edges)
        n_val = int(val_split * self.num_edges)
        self._split_indices: Dict[str, np.ndarray] = {
            "train": np.sort(perm[:n_train]),
            "val": np.sort(perm[n_train : n_train + n_val]),
            "test": np.sort(perm[n_train + n_val :]),
        }
        self.calibration_split = float(calibration_split)
        if not 0.0 <= self.calibration_split < 1.0:
            raise ValueError(f"calibration_split must be in [0, 1), got {calibration_split}")
        if self.calibration_split > 0:
            val_idx = self._split_indices["val"]
            n_cal = int(round(self.calibration_split * len(val_idx)))
            pick = rng.permutation(len(val_idx))[:n_cal]
            cal_mask = np.zeros(len(val_idx), dtype=bool)
            cal_mask[pick] = True
            self._split_indices["cal"] = val_idx[cal_mask]
            self._split_indices["val"] = val_idx[~cal_mask]
        self._batches: Dict[str, SplitBatch] = {}
        self._row_slots: Dict[str, Optional[np.ndarray]] = {}

    def split_sizes(self) -> Dict[str, int]:
        return {k: len(v) for k, v in self._split_indices.items()}

    @property
    def has_calibration_split(self) -> bool:
        return "cal" in self._split_indices

    def split_indices(self, split: str) -> np.ndarray:
        """Positions (into the valid patient-lab edge list) of this split."""
        return self._split_indices[split]

    def get_split(self, split: str) -> SplitBatch:
        """Padded CPU batch for a split (cached)."""
        if split not in self._batches:
            idx = self._split_indices[split]
            self._batches[split], self._row_slots[split] = _pad_batch(
                self._p[idx], self._l[idx], self._v[idx], self.pad_multiple,
                num_patients=self._num_patients, num_labs=self._num_labs,
                slot_major=(
                    self.slot_major_train
                    and split == "train"
                    and len(idx) >= self.slot_major_min_rows
                ),
                lab_block_rows=self.lab_block_rows,
            )
        return self._batches[split]

    def slot_map(self, split: str) -> Optional[np.ndarray]:
        """int32[B_pad] slot holding each original row (None for row-major
        batches): inverts slot-major predictions back to split order."""
        self.get_split(split)
        return self._row_slots.get(split)

    def split_arrays(self, split: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host (patient_idx, lab_idx, values) without padding."""
        idx = self._split_indices[split]
        return self._p[idx], self._l[idx], self._v[idx]

    def train_positions(self) -> np.ndarray:
        """int32[B_pad] edge-list position of each train-batch slot (padding
        slots point at 0)."""
        batch = self.get_split("train")
        idx = self._split_indices["train"]
        out = np.zeros(batch.valid.shape[0], dtype=np.int32)
        slots = self._row_slots.get("train")
        if slots is None:
            out[: len(idx)] = idx
        else:
            out[slots[: len(idx)]] = idx
        return out

    def supervision_mask(self, epoch: int, batch: Optional[SplitBatch] = None) -> torch.Tensor:
        """The epoch's Bernoulli(mask_fraction) supervision mask over the
        train batch, times its validity, on the batch's device."""
        batch = batch if batch is not None else self.get_split("train")
        if self.mask_fraction <= 0:
            return batch.valid
        device = batch.valid.device
        gen = torch.Generator(device=device).manual_seed(stream_seed(self.seed, "supervision", epoch))
        draw = torch.rand(batch.valid.shape, generator=gen, device=device) < self.mask_fraction
        return draw.float() * batch.valid


def masker_from_config(config, graph: HeteroGraph) -> EdgeMasker:
    """The config -> masker factory: slot-major train batches on the kernel
    path (``model.use_pallas``) from :data:`SLOT_MAJOR_MIN_ROWS` rows (read
    at the call), lab tiles from ``train.extras``, the strict
    conformal "cal" split from ``evaluation.extras.conformal_split_fraction``.
    Every entry point that must agree on the splits builds its masker here."""
    tc = config.train
    return EdgeMasker(
        graph,
        train_split=tc.train_split,
        val_split=tc.val_split,
        test_split=tc.test_split,
        mask_fraction=tc.mask_fraction,
        seed=tc.seed,
        slot_major_train=config.model.use_pallas,
        slot_major_min_rows=SLOT_MAJOR_MIN_ROWS,
        lab_block_rows=resolve_lab_tile_rows(
            tc.extras.get("lab_tile_rows"), graph.num_nodes(LAB), config.model.use_pallas
        ),
        calibration_split=float(config.evaluation.extras.get("conformal_split_fraction", 0) or 0),
    )
