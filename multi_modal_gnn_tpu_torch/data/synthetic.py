"""The synthetic cohorts of ``multi_modal_gnn_tpu/data/synthetic.py``, in
numpy only: the ``flat`` rank-k generator and the calibrated ``eicu``
phenomenology (``SyntheticSpec.eicu_real``), with :func:`spec_from_config`
to pick one from ``data.synthetic``.

The random draws are made in the JAX generator's order from
``np.random.default_rng(spec.seed)`` (and its throwaway calibration
streams), so every number is the same.  :func:`generate_synthetic_tables`
returns the preprocess contract's tables as dicts of numpy columns (the JAX
package's DataFrames, column for column);
:func:`generate_synthetic_edges` returns the flat cohort's COO arrays in
the generator's own indices, and :func:`make_synthetic_graph` numbers the
nodes as the JAX graph build does (``graph.number_nodes``: patients by lab
degree, labs by frequency, diagnoses and medications in first-seen order)
unless both ``graph.cluster_*`` flags are off, so it builds the JAX
package's ``make_synthetic_bundle(spec, config).graph``.  The numbering
changes layout only, never results.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from multi_modal_gnn_tpu_torch.config import Config, ConfigError
from multi_modal_gnn_tpu_torch.graph.build import Table, assemble_graph, drop_disabled_relations, number_nodes
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
    """The JAX ``SyntheticSpec``'s fields and defaults.  ``phenomenology``
    "flat" uses the first block only; "eicu" (see the JAX docstring) adds a
    skewed severity factor, per-lab signal shares, severity-coupled lab
    ordering and noise, twin-paired and spike labs, contamination, a
    reference-matched count profile and per-lab value quantization."""

    num_patients: int = 1834
    num_labs: int = 50
    num_diagnoses: int = 114
    num_medications: int = 100
    mean_labs_per_patient: float = 33.5
    mean_diagnoses_per_patient: float = 3.0
    mean_medications_per_patient: float = 8.7
    latent_dim: int = 8
    signal_strength: float = 0.6  # flat only
    seed: int = 0
    phenomenology: str = "flat"  # flat | eicu
    sev_shape: float = 2.0
    sev_share_common: float = 0.035
    sev_share_rare: float = 0.26
    sev_share_power: float = 1.5
    sev_share_conc: float = 8.0
    minor_share_lo: float = 0.05
    minor_share_hi: float = 0.22
    noise_df_min: float = 4.5
    noise_df_max: float = 30.0
    hetero_noise: float = 0.38
    degree_sev_coupling: float = 0.55
    rare_sev_affinity: float = 1.0
    contamination_frac: float = 0.012
    contamination_scale: float = 2.8
    special_lab_frac: float = 0.08
    special_share: float = 0.93
    heavy_lab_frac: float = 0.08
    heavy_signal_scale: float = 0.15
    heavy_bulk: float = 0.16
    heavy_spike_prob: float = 0.015
    heavy_spike_scale: float = 4.5
    count_profile: str = "zipf"  # zipf | ref
    degree_shape: float = 2.5
    brief_frac: float = 0.0
    brief_mean: float = 5.0
    rank_noise_rare: float = 0.0
    degree_cap_frac: float = 1.0
    quant_step: float = 0.0

    @staticmethod
    def eicu_demo() -> "SyntheticSpec":
        """Sized as the eICU demo cohort: 1,834 patients, 50 labs, ~61k
        patient-lab edges (the defaults)."""
        return SyntheticSpec()

    @staticmethod
    def eicu_real(seed: int = 0) -> "SyntheticSpec":
        """The eICU-demo-sized cohort with the calibrated real-data
        phenomenology (``conf/eicu_real.yaml``'s ``preset: eicu_real``)."""
        return SyntheticSpec(
            phenomenology="eicu",
            seed=seed,
            count_profile="ref",
            degree_shape=12.0,
            brief_frac=0.012,
            brief_mean=4.0,
            rank_noise_rare=2.0,
            degree_cap_frac=0.88,
            quant_step=0.25,
            special_lab_frac=0.12,
            special_share=0.95,
            heavy_lab_frac=0.10,
            sev_share_rare=0.29,
            contamination_frac=0.024,
            minor_share_lo=0.04,
            minor_share_hi=0.18,
        )

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


_SPEC_PRESETS = {
    "eicu_demo": SyntheticSpec.eicu_demo,
    "eicu_real": SyntheticSpec.eicu_real,
    "scale_100k": SyntheticSpec.scale_100k,
    "mimic_scale": SyntheticSpec.mimic_scale,
    "tiny": SyntheticSpec.tiny,
}


def spec_from_config(config: Config) -> SyntheticSpec:
    """The spec of ``data.synthetic`` (JAX ``spec_from_config``): ``preset``
    (default ``eicu_demo``) plus any :class:`SyntheticSpec` field as an
    override, coerced to the field's type."""
    raw = dict(config.data.extras.get("synthetic") or {})
    preset = str(raw.pop("preset", "eicu_demo"))
    if preset not in _SPEC_PRESETS:
        raise ConfigError(
            f"data.synthetic.preset must be one of {sorted(_SPEC_PRESETS)}, got {preset!r}"
        )
    spec = _SPEC_PRESETS[preset]()
    fields = {f.name: f for f in dataclasses.fields(SyntheticSpec)}
    unknown = set(raw) - set(fields)
    if unknown:
        raise ConfigError(
            f"unknown data.synthetic key(s) {sorted(unknown)}; valid: preset + {sorted(fields)}"
        )
    casts = {"int": int, "float": float}
    overrides = {k: casts.get(fields[k].type, lambda v: v)(v) for k, v in raw.items()}
    return dataclasses.replace(spec, **overrides) if overrides else spec


def _sample_memberships(
    rng: np.random.Generator,
    num_patients: int,
    num_items: int,
    mean_per_patient: float,
    item_popularity: np.ndarray,
    affinity: Optional[np.ndarray] = None,
    rate_tilt: Optional[np.ndarray] = None,
    rate: Optional[np.ndarray] = None,
    noise_scale: Optional[np.ndarray] = None,
    max_count: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(patient, item) pairs: Poisson counts per patient around ``rate``
    (default: a gamma(2.5) draw around ``mean_per_patient``; times
    ``rate_tilt`` normalized to mean 1), at least 1, at most ``max_count``
    (default ``num_items``); items drawn without replacement by Gumbel
    top-k on log-popularity, the Gumbel noise scaled per item by
    ``noise_scale``, plus an optional per-patient ``affinity``."""
    if rate is None:
        rate = rng.gamma(shape=2.5, scale=mean_per_patient / 2.5, size=num_patients)
    if rate_tilt is not None:
        rate = rate * (rate_tilt / rate_tilt.mean())
    counts = np.maximum(rng.poisson(rate), 1)
    counts = np.minimum(counts, num_items if max_count is None else max_count)
    total = int(counts.sum())

    logp = np.log(item_popularity + 1e-12)
    item_idx = np.empty(total, dtype=np.int64)
    offset = 0
    # chunk patients to bound the [chunk, num_items] score matrix
    chunk = max(1, min(num_patients, int(2e7 // max(num_items, 1)) or 1))
    for start in range(0, num_patients, chunk):
        stop = min(start + chunk, num_patients)
        n = stop - start
        g = rng.gumbel(size=(n, num_items))
        if noise_scale is not None:
            g = g * noise_scale[None, :]
        scores = logp[None, :] + g
        if affinity is not None:
            scores = scores + affinity[start:stop]
        order = np.argsort(-scores, axis=1)
        cc = counts[start:stop]
        m = int(cc.sum())
        rows = np.repeat(np.arange(n, dtype=np.int64), cc)
        cols = np.arange(m, dtype=np.int64) - np.repeat(np.cumsum(cc) - cc, cc)
        item_idx[offset : offset + m] = order[rows, cols]
        offset += m
    return np.repeat(np.arange(num_patients, dtype=np.int64), counts), item_idx


# The reference's per-lab test-split sample counts (50 labs), the target of
# ``count_profile="ref"`` (JAX ``_REF_LAB_TEST_COUNTS``).
_REF_LAB_TEST_COUNTS = np.array([
    197, 219, 207, 203, 182, 213, 227, 267, 94, 88, 58, 124, 108, 278, 251,
    246, 260, 239, 178, 88, 173, 173, 112, 251, 231, 71, 255, 208, 202, 196,
    157, 250, 240, 265, 265, 268, 88, 206, 139, 107, 109, 106, 255, 232, 267,
    194, 212, 53, 100, 112,
], dtype=np.float64)


def _ref_count_shares(num_labs: int) -> np.ndarray:
    """Per-lab count shares, descending, quantile-interpolated from the
    reference histogram to ``num_labs`` rows."""
    prof = np.sort(_REF_LAB_TEST_COUNTS)[::-1]
    if num_labs != len(prof):
        prof = np.interp(
            np.linspace(0.0, 1.0, num_labs), np.linspace(0.0, 1.0, len(prof)), prof
        )
    return prof / prof.sum()


@dataclass(frozen=True)
class SyntheticLatents:
    """The generator's ground-truth latent structure (JAX
    ``SyntheticLatents``), for the performance ceilings of
    :mod:`~multi_modal_gnn_tpu_torch.evaluation.ceiling`.

    Flat mode: ``value_norm = signal * <w_lab[l], z[p]> + sqrt(1 - signal^2)
    * eps``, and the exact Bayes ceiling takes ``w_lab`` / ``signal``
    (``gaussian_conditional_ceiling``).  eicu mode: after the per-lab
    standardization ``value_norm ~= <w_eff[l], z[p]> - mean_shift[l] +
    noise`` with per-lab noise variance ``noise_var[l]``, for
    ``lmmse_conditional_ceiling`` (the noise is a severity-coupled scale
    mixture, so that ceiling is LMMSE, not exact Bayes); ``z[:, 0]`` is the
    severity factor."""

    z: np.ndarray  # [num_patients, latent_dim]
    w_lab: np.ndarray  # [num_labs, latent_dim], unit rows
    signal: float
    w_eff: Optional[np.ndarray] = None  # [num_labs, latent_dim] effective loadings
    noise_var: Optional[np.ndarray] = None  # [num_labs] effective noise variance
    mean_shift: Optional[np.ndarray] = None  # [num_labs] standardization offset
    sev_share: Optional[np.ndarray] = None  # [num_labs] pre-selection share
    special_labs: Optional[np.ndarray] = None  # twin-paired lab rows (eicu mode)
    heavy_labs: Optional[np.ndarray] = None  # spike lab rows (eicu mode)


def _standardized_gamma(rng: np.random.Generator, shape_k: float, size: int) -> np.ndarray:
    """Gamma(k, 1) standardized to mean 0 / var 1 (skew 2/sqrt(k))."""
    g = rng.gamma(shape_k, 1.0, size)
    return (g - shape_k) / np.sqrt(shape_k)


def _standardized_t(rng: np.random.Generator, df: np.ndarray) -> np.ndarray:
    """Student-t with per-element dof, standardized to unit variance (df > 2)."""
    t = rng.standard_t(df)
    return t * np.sqrt((df - 2.0) / df)


def _flat_draws(spec: SyntheticSpec) -> Dict[str, np.ndarray]:
    """The flat generator's draws, in the JAX ``generate_synthetic_tables``
    order: the patient-lab pairs with their normalized and raw values, the
    demographics, and the diagnosis and medication pairs, in generator
    indices."""
    rng = np.random.default_rng(spec.seed)
    n, k = spec.num_patients, spec.latent_dim

    z = rng.standard_normal((n, k))
    w_lab = rng.standard_normal((spec.num_labs, k))
    w_lab /= np.linalg.norm(w_lab, axis=1, keepdims=True) + 1e-12
    age = np.clip(rng.normal(63, 16, n), 18, 90).round(1)
    gender = rng.choice(["M", "F"], size=n)

    lab_popularity = (1.0 / (np.arange(spec.num_labs) + 1.0)) ** 0.6
    lab_popularity /= lab_popularity.sum()
    p_idx, l_idx = _sample_memberships(
        rng, n, spec.num_labs, spec.mean_labs_per_patient, lab_popularity
    )
    latent_part = np.einsum("ek,ek->e", z[p_idx], w_lab[l_idx])
    noise = rng.standard_normal(len(p_idx))
    s = spec.signal_strength
    value_norm = s * latent_part + np.sqrt(max(1.0 - s * s, 0.0)) * noise
    # raw values: a per-lab affine of the normalized ones
    lab_mean = rng.uniform(0.5, 150.0, spec.num_labs)
    lab_std = rng.uniform(0.05, 30.0, spec.num_labs)
    value_raw = value_norm * lab_std[l_idx] + lab_mean[l_idx]

    def _membership(num_items: int, mean_per: float):
        w = rng.standard_normal((num_items, k))
        pop = (1.0 / (np.arange(num_items) + 1.0)) ** 0.8
        pop /= pop.sum()
        return _sample_memberships(rng, n, num_items, mean_per, pop, affinity=z @ w.T * 0.5)

    dxp_idx, dx_idx = _membership(spec.num_diagnoses, spec.mean_diagnoses_per_patient)
    rxp_idx, rx_idx = _membership(spec.num_medications, spec.mean_medications_per_patient)
    return dict(
        p_idx=p_idx, l_idx=l_idx, value_norm=value_norm, value_raw=value_raw,
        age=age, gender=gender, dxp_idx=dxp_idx, dx_idx=dx_idx, rxp_idx=rxp_idx, rx_idx=rx_idx,
        z=z, w_lab=w_lab,
    )


def _flat_latents(spec: SyntheticSpec, draws: Dict[str, np.ndarray]) -> SyntheticLatents:
    return SyntheticLatents(z=draws["z"], w_lab=draws["w_lab"], signal=float(spec.signal_strength))


def generate_synthetic_edges(spec: SyntheticSpec, return_latents: bool = False):
    """``(edge_arrays, node_counts)`` of a flat cohort for
    :func:`assemble_graph`: ``edge_arrays[et] = (src, dst, val_or_None)``
    per forward relation, with the patient-lab ``val`` the normalized lab
    value (float32); with ``return_latents`` the cohort's
    :class:`SyntheticLatents` third.  The eicu phenomenology goes through
    :func:`generate_synthetic_tables` and the graph build from tables."""
    if spec.phenomenology != "flat":
        raise ValueError(
            f"generate_synthetic_edges takes the flat generator; {spec.phenomenology!r} cohorts "
            "come from generate_synthetic_tables + graph.build.build_heterogeneous_graph"
        )
    d = _flat_draws(spec)
    edge_arrays = {
        PATIENT_LAB: (d["p_idx"], d["l_idx"], d["value_norm"].astype(np.float32)),
        PATIENT_DIAGNOSIS: (d["dxp_idx"], d["dx_idx"], None),
        PATIENT_MEDICATION: (d["rxp_idx"], d["rx_idx"], None),
    }
    node_counts = {
        PATIENT: spec.num_patients,
        LAB: spec.num_labs,
        DIAGNOSIS: spec.num_diagnoses,
        MEDICATION: spec.num_medications,
    }
    if return_latents:
        return edge_arrays, node_counts, _flat_latents(spec, d)
    return edge_arrays, node_counts


def _tables(
    subject_ids, age, gender, p_idx, l_idx, value_raw, value_norm, num_labs,
    dx_pairs, rx_pairs, num_diagnoses, num_medications,
) -> Dict[str, Table]:
    """The preprocess contract's six tables from generator indices."""
    lab_item_ids = 51000 + np.arange(num_labs)
    icd3 = np.array([f"{250 + i:03d}" for i in range(num_diagnoses)])
    drugs = np.array([f"drug_{i:03d}" for i in range(num_medications)])
    cohort = {"SUBJECT_ID": subject_ids, "AGE": age, "GENDER": gender}
    return {
        "cohort": cohort,
        "labs_normalized": {
            "SUBJECT_ID": subject_ids[p_idx],
            "ITEMID": lab_item_ids[l_idx],
            "VALUE": value_raw.astype(np.float32),
            "VALUE_NORMALIZED": value_norm.astype(np.float32),
        },
        "diagnoses": {"SUBJECT_ID": subject_ids[dx_pairs[0]], "ICD3_CODE": icd3[dx_pairs[1]]},
        "medications": {"SUBJECT_ID": subject_ids[rx_pairs[0]], "DRUG": drugs[rx_pairs[1]]},
        "labitems": {
            "ITEMID": lab_item_ids,
            "LABEL": np.array([f"synthetic lab {i}" for i in range(num_labs)]),
        },
        "demographics": {k: v.copy() for k, v in cohort.items()},
    }


def _generate_eicu_tables(spec: SyntheticSpec, return_latents: bool = False):
    """The ``phenomenology="eicu"`` generator (JAX
    ``_generate_eicu_tables``, whose comments give each mechanism's
    calibration target), draw for draw; with ``return_latents`` also its
    :class:`SyntheticLatents`."""
    rng = np.random.default_rng(spec.seed)
    n, L, k = spec.num_patients, spec.num_labs, spec.latent_dim

    # latents: a skewed severity factor and isotropic minor factors
    s = _standardized_gamma(rng, spec.sev_shape, n)
    u = rng.standard_normal((n, k - 1))
    z = np.concatenate([s[:, None], u], axis=1)

    # per-lab signal geometry; lab 0 is the most common
    r = np.arange(L) / max(L - 1, 1)
    mean_sev = spec.sev_share_common + (
        spec.sev_share_rare - spec.sev_share_common
    ) * r**spec.sev_share_power
    c = spec.sev_share_conc
    sev_share = rng.beta(c * mean_sev, c * (1.0 - mean_sev))
    minor_share = rng.uniform(spec.minor_share_lo, spec.minor_share_hi, L)
    tot = sev_share + minor_share
    over = tot > 0.9
    sev_share = np.where(over, sev_share * 0.9 / tot, sev_share)
    minor_share = np.where(over, minor_share * 0.9 / tot, minor_share)
    # routine panels are the worst explained: the minor share ramps down
    # toward the common end
    minor_share = minor_share * (0.45 + 0.55 * r**1.2)
    # twin-paired labs share one dedicated minor-factor direction
    n_pairs = int(round(spec.special_lab_frac * L)) // 2
    pair_bases = (
        np.linspace(0.08 * L, 0.7 * L, n_pairs).round().astype(int)
        if n_pairs
        else np.empty(0, dtype=int)
    )
    special = (
        np.unique(np.concatenate([pair_bases, pair_bases + 1])) if n_pairs else np.empty(0, dtype=int)
    )
    if n_pairs:
        sev_share[special] = spec.special_share * 0.15
        minor_share[special] = spec.special_share * 0.85
    w_minor = rng.standard_normal((L, k - 1))
    w_minor /= np.linalg.norm(w_minor, axis=1, keepdims=True) + 1e-12
    for j, b in enumerate(pair_bases):
        e = np.zeros(k - 1)
        e[j % (k - 1)] = 1.0
        w_minor[b] = e
        w_minor[b + 1] = e
    df_lab = np.exp(rng.uniform(np.log(spec.noise_df_min), np.log(spec.noise_df_max), L))
    # routine-panel noise is near-Gaussian
    df_lab = np.where(r < 0.12, spec.noise_df_max, df_lab)
    # spike labs (tight bulk + rare condition spikes) in the rarer half
    n_heavy = int(round(spec.heavy_lab_frac * L))
    heavy = np.empty(0, dtype=int)
    if n_heavy:
        candidates = np.setdiff1d(np.arange(int(0.5 * L), L), special)
        heavy = rng.choice(candidates, min(n_heavy, len(candidates)), replace=False)
        sev_share[heavy] = sev_share[heavy] * spec.heavy_signal_scale
        minor_share[heavy] = minor_share[heavy] * spec.heavy_signal_scale
    noise_share = 1.0 - sev_share - minor_share

    # cohort: severity nudges age upward
    subject_ids = 100000 + np.arange(n)
    age = np.clip(rng.normal(63, 16, n) + 3.0 * s, 18, 90).round(1)
    gender = rng.choice(["M", "F"], size=n)

    # lab ordering: severity-coupled counts and a rare-lab MNAR tilt
    if spec.count_profile == "ref":
        lab_popularity = _ref_count_shares(L)
    else:
        lab_popularity = (1.0 / (np.arange(L) + 1.0)) ** 1.0
        lab_popularity /= lab_popularity.sum()
    affinity = np.outer(s, spec.rare_sev_affinity * r**1.5).astype(np.float32)
    tilt = np.exp(spec.degree_sev_coupling * np.clip(s, -0.6, 1.6))
    tilt_n = tilt / tilt.mean()
    rank_noise = None
    if spec.rank_noise_rare > 0:
        # twin-paired labs are exempt: their ordering is clinically coupled
        rank_noise = 1.0 + spec.rank_noise_rare * r**1.5
        rank_noise[special] = 1.0
    shape = spec.degree_shape
    bf = spec.brief_frac
    main_mean = (spec.mean_labs_per_patient - bf * spec.brief_mean) / max(1.0 - bf, 1e-9)
    cap = L if spec.degree_cap_frac >= 1.0 else max(int(round(spec.degree_cap_frac * L)), 1)
    # the inflation that keeps the capped mean degree on spec, solved on a
    # throwaway stream
    probe = np.random.default_rng(spec.seed ^ 0xC0FFEE)
    g_probe = probe.gamma(shape, 1.0 / shape, size=n)
    lo_c, hi_c = 1.0, 6.0
    for _ in range(40):
        mid = 0.5 * (lo_c + hi_c)
        realized = np.minimum(mid * main_mean * g_probe * tilt_n, cap).mean()
        lo_c, hi_c = (mid, hi_c) if realized < main_mean else (lo_c, mid)
    c_inflate = 0.5 * (lo_c + hi_c)
    rate = rng.gamma(shape, 1.0 / shape, size=n) * c_inflate * main_mean * tilt_n
    if bf > 0:
        # brief stays: healthy quick discharges, a few panels each
        is_brief = (rng.random(n) < 2.0 * bf) & (s < np.median(s))
        brief_rate = spec.brief_mean * rng.gamma(2.0, 0.5, size=n)
        rate = np.where(is_brief, brief_rate, rate)
    if spec.count_profile == "ref":
        # fixed-point calibration of the popularity weights on a throwaway
        # stream, until the realized profile matches the reference's
        target = _ref_count_shares(L)
        logp = np.log(target)
        cal = np.random.default_rng(spec.seed ^ 0xFACADE)
        for _ in range(12):
            w = np.exp(logp)
            _, li_c = _sample_memberships(
                cal, n, L, main_mean, w / w.sum(), affinity=affinity,
                rate=rate, noise_scale=rank_noise, max_count=cap,
            )
            realized = np.bincount(li_c, minlength=L) + 1.0
            logp += 1.5 * (np.log(target) - np.log(realized / realized.sum()))
        lab_popularity = np.exp(logp)
        lab_popularity /= lab_popularity.sum()
    p_idx, l_idx = _sample_memberships(
        rng, n, L, main_mean, lab_popularity, affinity=affinity,
        rate=rate, noise_scale=rank_noise, max_count=cap,
    )

    # values: severity signal plus a scale mixture of minor factors and noise
    m = np.exp(spec.hetero_noise * s)
    m = m / np.sqrt(np.mean(m**2))
    minor_part = np.einsum("ek,ek->e", u[p_idx], w_minor[l_idx])
    eps = _standardized_t(rng, df_lab[l_idx])
    m_e = m[p_idx]
    if len(heavy):
        # spike labs: a bulk + spike mixture in place of the t noise, exempt
        # from the severity noise scale
        b_l = spec.heavy_bulk * np.exp(rng.uniform(-0.4, 0.4, len(heavy)))
        p_l = spec.heavy_spike_prob * np.exp(rng.uniform(-0.6, 0.6, len(heavy)))
        s_l = spec.heavy_spike_scale * np.exp(rng.uniform(-0.3, 0.3, len(heavy)))
        lab_to_h = np.full(L, -1)
        lab_to_h[heavy] = np.arange(len(heavy))
        hm = lab_to_h[l_idx] >= 0
        hidx = lab_to_h[l_idx[hm]]
        nh = int(hm.sum())
        bulk = rng.standard_normal(nh) * b_l[hidx]
        is_spike = rng.random(nh) < p_l[hidx]
        mag = s_l[hidx] * (0.5 + np.abs(rng.standard_normal(nh)))
        sgn = np.where(rng.random(nh) < 0.8, 1.0, -1.0)
        eps[hm] = np.where(is_spike, sgn * mag, bulk)
        m_e = np.where(hm, 1.0, m_e)
    core = (
        np.sqrt(sev_share[l_idx]) * s[p_idx]
        + m_e * (np.sqrt(minor_share[l_idx]) * minor_part + np.sqrt(noise_share[l_idx]) * eps)
    )
    if spec.contamination_frac > 0:
        # wild values (entry errors), not on the spike labs
        bad = rng.random(len(core)) < spec.contamination_frac
        if len(heavy):
            bad &= ~np.isin(l_idx, heavy)
        wild = rng.standard_normal(len(core))
        core = np.where(
            bad, core + spec.contamination_scale * np.sign(wild) * (0.5 + np.abs(wild)), core
        )

    if spec.quant_step > 0:
        # per-lab measurement grid (quant_step of the lab's SD, log-jittered,
        # at a random phase); a lab whose grid puts a point within 0.04 SD
        # of its mean gets its phase bumped, at most 4 times
        cnt_q = np.maximum(np.bincount(l_idx, minlength=L), 1).astype(np.float64)
        mean_q = np.bincount(l_idx, weights=core, minlength=L) / cnt_q
        var_q = np.bincount(l_idx, weights=core**2, minlength=L) / cnt_q - mean_q**2
        step = spec.quant_step * np.sqrt(np.maximum(var_q, 1e-12)) * np.exp(rng.uniform(-0.5, 0.5, L))
        phase = rng.uniform(0.0, 1.0, L)
        raw = core.copy()
        for _ in range(4):
            core = step[l_idx] * (np.round(raw / step[l_idx] - phase[l_idx]) + phase[l_idx])
            cq = np.maximum(np.bincount(l_idx, minlength=L), 1).astype(np.float64)
            mq = np.bincount(l_idx, weights=core, minlength=L) / cq
            vq = np.bincount(l_idx, weights=core**2, minlength=L) / cq - mq**2
            sq = np.sqrt(np.maximum(vq, 1e-12))
            zq = np.abs(core - mq[l_idx]) / sq[l_idx]
            min_z = np.full(L, np.inf)
            np.minimum.at(min_z, l_idx, zq)
            bad = min_z < 0.04
            if not bad.any():
                break
            phase = np.where(bad, (phase + 0.23) % 1.0, phase)

    # per-lab standardization over the observed entries
    cnt = np.bincount(l_idx, minlength=L).astype(np.float64)
    safe = np.maximum(cnt, 1.0)
    obs_mean = np.bincount(l_idx, weights=core, minlength=L) / safe
    obs_var = np.bincount(l_idx, weights=core**2, minlength=L) / safe - obs_mean**2
    obs_std = np.sqrt(np.maximum(obs_var, 1e-12))
    value_norm = (core - obs_mean[l_idx]) / obs_std[l_idx]
    lab_mean = rng.uniform(0.5, 150.0, L)
    lab_std = rng.uniform(0.05, 30.0, L)
    value_raw = value_norm * lab_std[l_idx] + lab_mean[l_idx]

    # diagnoses / medications: severity-loaded membership
    def _membership(num_items, mean_per):
        w = rng.standard_normal((num_items, k))
        w[:, 0] *= 2.0
        pop = (1.0 / (np.arange(num_items) + 1.0)) ** 0.8
        pop /= pop.sum()
        rr = np.arange(num_items) / max(num_items - 1, 1)
        aff = (z @ w.T * 0.5 + np.outer(s, 0.6 * rr)).astype(np.float32)
        return _sample_memberships(
            rng, n, num_items, mean_per, pop, affinity=aff, rate_tilt=np.exp(0.4 * s),
        )

    dx = _membership(spec.num_diagnoses, spec.mean_diagnoses_per_patient)
    rx = _membership(spec.num_medications, spec.mean_medications_per_patient)
    tables = _tables(
        subject_ids, age, gender, p_idx, l_idx, value_raw, value_norm, L,
        dx, rx, spec.num_diagnoses, spec.num_medications,
    )
    if not return_latents:
        return tables

    # the effective (post-standardization) linear model of the LMMSE ceiling
    mbar = float(m.mean())
    w_eff = np.concatenate(
        [np.sqrt(sev_share)[:, None], np.sqrt(minor_share)[:, None] * w_minor * mbar], axis=1
    ) / obs_std[:, None]
    explained = np.einsum("ek,ek->e", w_eff[l_idx] * obs_std[l_idx, None], z[p_idx])
    resid = core - explained
    resid_mean = np.bincount(l_idx, weights=resid, minlength=L) / safe
    noise_var = (
        np.bincount(l_idx, weights=resid**2, minlength=L) / safe - resid_mean**2
    ) / np.maximum(obs_var, 1e-12)
    return tables, SyntheticLatents(
        z=z,
        w_lab=w_eff / (np.linalg.norm(w_eff, axis=1, keepdims=True) + 1e-12),
        signal=float(np.sqrt(np.clip(1.0 - noise_var.mean(), 0.0, 1.0))),
        w_eff=w_eff,
        noise_var=noise_var,
        mean_shift=obs_mean / obs_std,
        sev_share=sev_share,
        special_labs=np.asarray(special, dtype=np.int64),
        heavy_labs=np.asarray(heavy, dtype=np.int64),
    )


def generate_synthetic_tables(spec: SyntheticSpec, return_latents: bool = False):
    """The preprocess contract's tables (JAX ``generate_synthetic_tables``)
    as dicts of numpy columns: ``cohort`` (SUBJECT_ID, AGE, GENDER),
    ``labs_normalized`` (SUBJECT_ID, ITEMID, VALUE, VALUE_NORMALIZED),
    ``diagnoses`` (SUBJECT_ID, ICD3_CODE), ``medications`` (SUBJECT_ID,
    DRUG), ``labitems`` (ITEMID, LABEL) and ``demographics`` (a copy of
    ``cohort``).  With ``return_latents``, ``(tables, SyntheticLatents)``
    from the same draws (the tables unchanged)."""
    if spec.phenomenology == "eicu":
        return _generate_eicu_tables(spec, return_latents)
    if spec.phenomenology != "flat":
        raise ValueError(f"unknown phenomenology: {spec.phenomenology!r}")
    d = _flat_draws(spec)
    tables = _tables(
        100000 + np.arange(spec.num_patients), d["age"], d["gender"], d["p_idx"], d["l_idx"],
        d["value_raw"], d["value_norm"], spec.num_labs, (d["dxp_idx"], d["dx_idx"]),
        (d["rxp_idx"], d["rx_idx"]), spec.num_diagnoses, spec.num_medications,
    )
    if return_latents:
        return tables, _flat_latents(spec, d)
    return tables


def make_synthetic_graph(
    spec: Optional[SyntheticSpec] = None, config: Optional[Config] = None, device=None
) -> HeteroGraph:
    """Generate the cohort and assemble its graph on ``device`` (default:
    the card; raises without one).  The nodes are numbered as the JAX
    package numbers them, or in the generator's order when both
    ``graph.cluster_patients_by_degree`` and ``cluster_labs_by_frequency``
    are off; disabled relations and the types they leave unconnected are
    dropped as the graph build drops them."""
    device = resolve_device(device)
    config = config or Config()
    edge_arrays, node_counts = drop_disabled_relations(
        *generate_synthetic_edges(spec or SyntheticSpec.tiny()), config
    )
    gc = config.graph
    if gc.cluster_patients_by_degree or gc.cluster_labs_by_frequency:
        edge_arrays, node_counts = number_nodes(
            edge_arrays, node_counts, gc.cluster_patients_by_degree, gc.cluster_labs_by_frequency
        )
    return assemble_graph(edge_arrays, node_counts, config).to(device)
