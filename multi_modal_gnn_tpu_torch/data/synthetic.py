"""The ``flat`` synthetic cohort (``multi_modal_gnn_tpu/data/synthetic.py``)
as COO arrays, in numpy only.

The random draws are made in the JAX generator's order from
``np.random.default_rng(spec.seed)``, so the topology and the normalized
lab values are the same numbers.  :func:`generate_synthetic_edges` returns
them in the generator's own indices; :func:`make_synthetic_graph` numbers
the nodes as the JAX package's graph build does (``graph.number_nodes``:
patients by lab degree, labs by frequency, diagnoses and medications in
first-seen order) unless both ``graph.cluster_*`` flags are off, so it
builds the JAX package's ``make_synthetic_bundle(spec, config).graph``.  The
numbering changes layout only, never results.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.graph.build import assemble_graph, number_nodes
from multi_modal_gnn_tpu_torch.graph.hetero import HeteroGraph
from multi_modal_gnn_tpu_torch.graph.schema import (
    DIAGNOSIS,
    LAB,
    MEDICATION,
    PATIENT,
    PATIENT_DIAGNOSIS,
    PATIENT_LAB,
    PATIENT_MEDICATION,
    EdgeTypeKey,
)
from multi_modal_gnn_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class SyntheticSpec:
    num_patients: int = 1834
    num_labs: int = 50
    num_diagnoses: int = 114
    num_medications: int = 100
    mean_labs_per_patient: float = 33.5
    mean_diagnoses_per_patient: float = 3.0
    mean_medications_per_patient: float = 8.7
    latent_dim: int = 8
    signal_strength: float = 0.6
    seed: int = 0

    @staticmethod
    def eicu_demo() -> "SyntheticSpec":
        """Sized as the eICU demo cohort: 1,834 patients, 50 labs, ~61k
        patient-lab edges (the defaults)."""
        return SyntheticSpec()

    @staticmethod
    def scale_100k(seed: int = 0) -> "SyntheticSpec":
        """100k patients / 500 labs / about 5M patient-lab edges."""
        return SyntheticSpec(
            num_patients=100_000,
            num_labs=500,
            num_diagnoses=500,
            num_medications=300,
            mean_labs_per_patient=50.0,
            mean_diagnoses_per_patient=4.0,
            mean_medications_per_patient=10.0,
            seed=seed,
        )

    @staticmethod
    def mimic_scale() -> "SyntheticSpec":
        """MIMIC-III-shaped: 46k patients, 720 labs, ~5.5M patient-lab edges."""
        return SyntheticSpec(
            num_patients=46_000,
            num_labs=720,
            num_diagnoses=800,
            num_medications=400,
            mean_labs_per_patient=120.0,
            mean_diagnoses_per_patient=6.0,
            mean_medications_per_patient=15.0,
        )

    @staticmethod
    def tiny(seed: int = 0) -> "SyntheticSpec":
        """Small cohort for fast unit tests."""
        return SyntheticSpec(
            num_patients=120,
            num_labs=12,
            num_diagnoses=10,
            num_medications=8,
            mean_labs_per_patient=7.0,
            mean_diagnoses_per_patient=2.0,
            mean_medications_per_patient=2.0,
            latent_dim=4,
            seed=seed,
        )


def _sample_memberships(
    rng: np.random.Generator,
    num_patients: int,
    num_items: int,
    mean_per_patient: float,
    item_popularity: np.ndarray,
    affinity: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(patient, item) pairs: gamma-Poisson counts per patient (at least 1,
    at most ``num_items``), items drawn without replacement by Gumbel top-k
    on log-popularity plus an optional per-patient affinity."""
    rate = rng.gamma(shape=2.5, scale=mean_per_patient / 2.5, size=num_patients)
    counts = np.minimum(np.maximum(rng.poisson(rate), 1), num_items)
    total = int(counts.sum())
    patient_idx = np.repeat(np.arange(num_patients, dtype=np.int64), counts)

    logp = np.log(item_popularity + 1e-12)
    item_idx = np.empty(total, dtype=np.int64)
    offset = 0
    # chunk patients to bound the [chunk, num_items] score matrix
    chunk = max(1, min(num_patients, int(2e7 // max(num_items, 1)) or 1))
    for start in range(0, num_patients, chunk):
        stop = min(start + chunk, num_patients)
        n = stop - start
        scores = logp[None, :] + rng.gumbel(size=(n, num_items))
        if affinity is not None:
            scores = scores + affinity[start:stop]
        order = np.argsort(-scores, axis=1)
        cc = counts[start:stop]
        m = int(cc.sum())
        rows = np.repeat(np.arange(n, dtype=np.int64), cc)
        cols = np.arange(m, dtype=np.int64) - np.repeat(np.cumsum(cc) - cc, cc)
        item_idx[offset : offset + m] = order[rows, cols]
        offset += m
    return patient_idx, item_idx


def generate_synthetic_edges(
    spec: SyntheticSpec,
) -> Tuple[Dict[EdgeTypeKey, tuple], Dict[str, int]]:
    """``(edge_arrays, node_counts)`` for :func:`assemble_graph`:
    ``edge_arrays[et] = (src, dst, val_or_None)`` per forward relation, with
    the patient-lab ``val`` the normalized lab value (float32)."""
    rng = np.random.default_rng(spec.seed)
    n, k = spec.num_patients, spec.latent_dim

    z = rng.standard_normal((n, k))
    w_lab = rng.standard_normal((spec.num_labs, k))
    w_lab /= np.linalg.norm(w_lab, axis=1, keepdims=True) + 1e-12
    # demographics: unused here, drawn to keep the generator's stream
    rng.normal(63, 16, n)
    rng.choice(["M", "F"], size=n)

    lab_popularity = (1.0 / (np.arange(spec.num_labs) + 1.0)) ** 0.6
    lab_popularity /= lab_popularity.sum()
    p_idx, l_idx = _sample_memberships(
        rng, n, spec.num_labs, spec.mean_labs_per_patient, lab_popularity
    )
    latent_part = np.einsum("ek,ek->e", z[p_idx], w_lab[l_idx])
    noise = rng.standard_normal(len(p_idx))
    s = spec.signal_strength
    value_norm = s * latent_part + np.sqrt(max(1.0 - s * s, 0.0)) * noise
    # raw-value affine per lab: unused here, drawn to keep the stream
    rng.uniform(0.5, 150.0, spec.num_labs)
    rng.uniform(0.05, 30.0, spec.num_labs)

    def _membership(num_items: int, mean_per: float):
        w = rng.standard_normal((num_items, k))
        pop = (1.0 / (np.arange(num_items) + 1.0)) ** 0.8
        pop /= pop.sum()
        return _sample_memberships(rng, n, num_items, mean_per, pop, affinity=z @ w.T * 0.5)

    dxp_idx, dx_idx = _membership(spec.num_diagnoses, spec.mean_diagnoses_per_patient)
    rxp_idx, rx_idx = _membership(spec.num_medications, spec.mean_medications_per_patient)

    edge_arrays = {
        PATIENT_LAB: (p_idx, l_idx, value_norm.astype(np.float32)),
        PATIENT_DIAGNOSIS: (dxp_idx, dx_idx, None),
        PATIENT_MEDICATION: (rxp_idx, rx_idx, None),
    }
    node_counts = {
        PATIENT: n,
        LAB: spec.num_labs,
        DIAGNOSIS: spec.num_diagnoses,
        MEDICATION: spec.num_medications,
    }
    return edge_arrays, node_counts


def make_synthetic_graph(
    spec: Optional[SyntheticSpec] = None, config: Optional[Config] = None, device=None
) -> HeteroGraph:
    """Generate the cohort and assemble its graph on ``device`` (default:
    the card; raises without one).  The nodes are numbered as the JAX
    package numbers them, or in the generator's order when both
    ``graph.cluster_patients_by_degree`` and ``cluster_labs_by_frequency``
    are off."""
    device = resolve_device(device)
    config = config or Config()
    edge_arrays, node_counts = generate_synthetic_edges(spec or SyntheticSpec.tiny())
    gc = config.graph
    if gc.cluster_patients_by_degree or gc.cluster_labs_by_frequency:
        edge_arrays, node_counts = number_nodes(
            edge_arrays, node_counts, gc.cluster_patients_by_degree, gc.cluster_labs_by_frequency
        )
    return assemble_graph(edge_arrays, node_counts, config).to(device)
