"""Baseline predictors (``multi_modal_gnn_tpu/evaluation/baselines.py``),
in numpy, fitted on the train split: global mean, per-lab mean, nearest
neighbour, ALS matrix factorization and ALS with dx / rx side information.
Both ALS classes fold in an unseen patient from their observed labs (and
memberships) for the served cold-start channel.

:class:`NearestNeighborBaseline` scores its queries in row blocks of at most
:data:`NN_BLOCK_BYTES` of similarities, where the JAX package forms one
``[Q, P]`` matrix (about 600 GB at ``scale_100k``); the answers are the
same.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from multi_modal_gnn_tpu_torch.evaluation.metrics import compute_regression_metrics
from multi_modal_gnn_tpu_torch.graph.schema import (
    DIAGNOSIS,
    MEDICATION,
    PATIENT,
    PATIENT_DIAGNOSIS,
    PATIENT_MEDICATION,
)

# the [rows, P] float64 similarity block of one nearest-neighbour query block
NN_BLOCK_BYTES = 1 << 28


class GlobalMeanBaseline:
    """Predict the global mean of train-split values."""

    def __init__(self):
        self.mean = 0.0

    def fit(self, values: np.ndarray) -> "GlobalMeanBaseline":
        self.mean = float(np.mean(values))
        return self

    def predict(self, n: int) -> np.ndarray:
        return np.full(n, self.mean)


class PerLabMeanBaseline:
    """Predict each lab's train-split mean (vectorized via bincount)."""

    def __init__(self, num_labs: int):
        self.num_labs = num_labs
        self.lab_means = np.zeros(num_labs)

    def fit(self, values: np.ndarray, lab_indices: np.ndarray) -> "PerLabMeanBaseline":
        sums = np.bincount(lab_indices, weights=values, minlength=self.num_labs)
        counts = np.bincount(lab_indices, minlength=self.num_labs)
        self.lab_means = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
        return self

    def predict(self, lab_indices: np.ndarray) -> np.ndarray:
        return self.lab_means[np.asarray(lab_indices)]


class NearestNeighborBaseline:
    """Predict from the most-similar patient who has the target lab observed.

    Similarity = cosine over the patients' observed-lab value vectors
    (missing entries zero).  The reference lists this baseline in its config
    (conf/config.yaml:286) but never implements it; here it is real.
    Vectorized: a block of queries' similarities to every patient as one
    matmul, then per-query argmax over patients observing the lab.
    """

    def __init__(self, num_patients: int, num_labs: int):
        self.num_patients = num_patients
        self.num_labs = num_labs
        self.matrix = np.zeros((num_patients, num_labs), dtype=np.float64)
        self.observed = np.zeros((num_patients, num_labs), dtype=bool)

    def fit(
        self,
        values: np.ndarray,
        patient_indices: np.ndarray,
        lab_indices: np.ndarray,
    ) -> "NearestNeighborBaseline":
        self.matrix[patient_indices, lab_indices] = values
        self.observed[patient_indices, lab_indices] = True
        norms = np.linalg.norm(self.matrix, axis=1, keepdims=True)
        self._unit = self.matrix / np.maximum(norms, 1e-12)
        return self

    def predict(self, patient_indices: np.ndarray, lab_indices: np.ndarray) -> np.ndarray:
        patient_indices = np.asarray(patient_indices)
        lab_indices = np.asarray(lab_indices)
        rows = max(1, NN_BLOCK_BYTES // (8 * max(self.num_patients, 1)))
        out = np.empty(len(patient_indices), dtype=np.float64)
        for start in range(0, len(patient_indices), rows):
            end = start + rows
            out[start:end] = self._predict_block(patient_indices[start:end], lab_indices[start:end])
        return out

    def _predict_block(self, patient_indices: np.ndarray, lab_indices: np.ndarray) -> np.ndarray:
        sims = self._unit[patient_indices] @ self._unit.T  # [Q, P]
        q = np.arange(len(patient_indices))
        sims[q, patient_indices] = -np.inf  # never yourself
        # mask to donors who observed the target lab
        donor_ok = self.observed[:, lab_indices].T  # [Q, P]
        sims = np.where(donor_ok, sims, -np.inf)
        best = np.argmax(sims, axis=1)
        preds = self.matrix[best, lab_indices]
        # no donor at all -> fall back to 0 (the global normalized mean)
        has_donor = np.isfinite(sims[q, best])
        return np.where(has_donor, preds, 0.0)


class ALSBaseline:
    """Low-rank matrix completion via alternating ridge regression.

    Fits ``v(p, l) ~ b_l + <u_p, c_l>`` on the train edges by alternating
    closed-form ridge solves for the patient factors U and lab factors C.
    This is the strongest *learnable* classical baseline for the
    mask-and-recover task — on the synthetic cohort (whose generator is
    exactly low-rank Gaussian, data/synthetic.py) it approaches the Bayes
    conditional ceiling (evaluation/ceiling.py), so the gap between it and
    the GNN measures architecture/optimization loss, not task difficulty.

    Beyond-reference: the reference configures only mean/knn baselines
    (conf/config.yaml evaluation.baselines; src/evaluate.py:147-230).
    Everything is vectorized: per-entity normal equations are accumulated
    with ``np.add.at`` over [N, k, k] blocks and solved batched.
    """

    def __init__(
        self,
        num_patients: int,
        num_labs: int,
        rank: int = 8,
        reg: float = 3.0,
        iters: int = 30,
        seed: int = 0,
        huber_delta: float | None = None,
    ):
        self.num_patients = num_patients
        self.num_labs = num_labs
        self.rank = rank
        self.reg = reg
        self.iters = iters
        self.seed = seed
        # Huber-IRLS robustification: on heavy-tailed cohorts
        # (data/synthetic.py eicu phenomenology; real EHR values) plain
        # least-squares ALS chases the outlier tail — measured guarded R^2
        # 0.163 vs the faithful MAE-trained recipe's 0.223 on the validated
        # cohort.  With huber_delta set, each sweep reweights edges by
        # min(1, delta / |residual|) (the Huber psi), which caps any
        # edge's leverage.  None = exact least squares (bit-identical to
        # the flat-cohort numbers of record).
        self.huber_delta = huber_delta
        self.U = np.zeros((num_patients, rank))
        self.C = np.zeros((num_labs, rank))
        self.lab_bias = np.zeros(num_labs)

    @staticmethod
    def _ridge_solve(
        factors_other: np.ndarray,  # [E, k] the fixed side's factor per edge
        idx_own: np.ndarray,  # [E] which own-entity each edge belongs to
        resid: np.ndarray,  # [E] target minus bias
        num_own: int,
        reg: float,
        weights: np.ndarray | None = None,  # [E] IRLS edge weights
    ) -> np.ndarray:
        k = factors_other.shape[1]
        f_w = factors_other if weights is None else factors_other * weights[:, None]
        r_w = resid if weights is None else resid * weights
        gram = np.tile(reg * np.eye(k), (num_own, 1, 1))
        np.add.at(gram, idx_own, f_w[:, :, None] * factors_other[:, None, :])
        rhs = np.zeros((num_own, k))
        np.add.at(rhs, idx_own, factors_other * r_w[:, None])
        return np.linalg.solve(gram, rhs[..., None])[..., 0]

    def fit(
        self,
        values: np.ndarray,
        patient_indices: np.ndarray,
        lab_indices: np.ndarray,
    ) -> "ALSBaseline":
        values = np.asarray(values, dtype=np.float64)
        p = np.asarray(patient_indices)
        l = np.asarray(lab_indices)
        sums = np.bincount(l, weights=values, minlength=self.num_labs)
        counts = np.bincount(l, minlength=self.num_labs)
        self.lab_bias = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
        rng = np.random.default_rng(self.seed)
        self.C = rng.normal(scale=0.1, size=(self.num_labs, self.rank))
        resid = values - self.lab_bias[l]
        w = None  # IRLS weights; None on the first sweep (= least squares)
        for _ in range(self.iters):
            self.U = self._ridge_solve(
                self.C[l], p, resid, self.num_patients, self.reg, weights=w
            )
            self.C = self._ridge_solve(
                self.U[p], l, resid, self.num_labs, self.reg, weights=w
            )
            fitted = np.einsum("ek,ek->e", self.U[p], self.C[l])
            bias_resid = values - fitted
            if w is None:
                sums = np.bincount(l, weights=bias_resid, minlength=self.num_labs)
                cnt_w = np.maximum(counts, 1)
            else:
                sums = np.bincount(l, weights=bias_resid * w, minlength=self.num_labs)
                cnt_w = np.maximum(
                    np.bincount(l, weights=w, minlength=self.num_labs), 1e-9
                )
            self.lab_bias = np.where(counts > 0, sums / cnt_w, 0.0)
            resid = values - self.lab_bias[l]
            if self.huber_delta is not None:
                r_full = resid - fitted
                w = np.minimum(
                    1.0, self.huber_delta / np.maximum(np.abs(r_full), 1e-9)
                )
        return self

    def predict(self, patient_indices: np.ndarray, lab_indices: np.ndarray) -> np.ndarray:
        p = np.asarray(patient_indices)
        l = np.asarray(lab_indices)
        return self.lab_bias[l] + np.einsum("ek,ek->e", self.U[p], self.C[l])

    def fold_in(self, obs_lab_indices: np.ndarray, obs_values: np.ndarray) -> np.ndarray:
        """Latent factor of an unseen patient from their observed labs: one
        closed-form ridge solve against the trained lab factors, the U
        half-step of :meth:`fit` (exact least squares: ``huber_delta`` plays
        no part, as in JAX).  The cold-start path: the transductive graph
        model cannot predict for patients outside its graph."""
        l = np.asarray(obs_lab_indices)
        v = np.asarray(obs_values, dtype=np.float64)
        if len(l) == 0:
            return np.zeros(self.rank)
        c = self.C[l]  # [n_obs, k]
        gram = self.reg * np.eye(self.rank) + c.T @ c
        rhs = c.T @ (v - self.lab_bias[l])
        return np.linalg.solve(gram, rhs)

    def predict_cold_start(
        self, obs_lab_indices: np.ndarray, obs_values: np.ndarray, query_lab_indices: np.ndarray
    ) -> np.ndarray:
        """Predict ``query_lab_indices`` for a new patient given their
        observed (lab, value) pairs."""
        u = self.fold_in(obs_lab_indices, obs_values)
        q = np.asarray(query_lab_indices)
        return self.lab_bias[q] + self.C[q] @ u


def membership_matrix(
    num_patients: int,
    edge_sets: "list[tuple[np.ndarray, np.ndarray, int]]",
    dtype=np.float32,
) -> np.ndarray:
    """Binary membership features [P, sum(num_items)] from relation edge
    lists.  Each entry of ``edge_sets`` is ``(patient_idx, item_idx,
    num_items)`` — e.g. the host arrays of the patient-diagnosis and
    patient-medication relations.  Duplicate (patient, item) pairs collapse
    to 1 (real-data loaders can emit repeats; the synthetic generator
    samples without replacement)."""
    width = sum(int(n) for _, _, n in edge_sets)
    m = np.zeros((num_patients, width), dtype=dtype)
    base = 0
    for p_idx, i_idx, n in edge_sets:
        m[np.asarray(p_idx), base + np.asarray(i_idx)] = 1.0
        base += int(n)
    return m


def graph_membership_matrix(graph) -> np.ndarray:
    """Binary [P, D_dx + D_rx] membership features from a graph's valid
    patient-diagnosis and patient-medication edges (JAX
    ``training/warmstart.py bundle_membership_matrix``)."""
    sets = []
    for key, node_t in ((PATIENT_DIAGNOSIS, DIAGNOSIS), (PATIENT_MEDICATION, MEDICATION)):
        es = graph.edges.get(key)
        if es is not None:
            valid = es.mask.cpu().numpy() > 0
            sets.append((es.src.cpu().numpy()[valid], es.dst.cpu().numpy()[valid], graph.num_nodes(node_t)))
    if not sets:
        raise ValueError("the graph has no patient-diagnosis or patient-medication relation")
    return membership_matrix(graph.num_nodes(PATIENT), sets)


class SideInfoALSBaseline:
    """ALS factorization + membership side information (dx/rx relations).

    The plain ALS baseline conditions only on a patient's observed lab
    VALUES; this one also conditions on which diagnoses/medications the
    patient has — fully-observed graph structure that the GNN's relational
    trunk receives but gradient training demonstrably fails to exploit
    (README "Results": on the synthetic cohort, membership carries signal
    beyond the labs-only Bayes ceiling because dx/rx sampling is tilted by
    the same latent state, data/synthetic.py).

    Fit (train split only; closed form throughout):
      1. ALS on train values -> patient factors U            [P, k]
      2. per-lab ridge of values on [U_p, M_p, 1]            (M = memberships)
      3. SVD-truncate the membership coefficient block to ``mem_rank`` ->
         patient side G = M @ V_r, lab side H = U_r S_r — the truncation is
         itself a regularizer (measured BETTER than the full-rank block:
         the generator's membership signal has rank <= latent_dim)
      4. per-lab ridge refit of the [U_p, 1] block on the residual after
         the G.H term, so the lab factors adapt to the truncation.

    Prediction: ``v(p, l) = <U_p, C_l> + b_l + <G_p, H_l>`` — exactly the
    low-rank bilinear form of the model's embedding-bilinear channel, so
    ``training/warmstart.py`` can plant it as an epoch-0 initialization
    (sideinfo_warm_start_params).

    No reference analogue (its baselines never condition on dx/rx,
    src/evaluate.py:147-230).
    """

    def __init__(
        self,
        num_patients: int,
        num_labs: int,
        rank: int = 8,
        mem_rank: int | None = None,
        reg: float = 12.0,
        ridge_reg: float = 30.0,
        iters: int = 30,
        seed: int = 0,
        min_lab_edges: int = 3,
        mem_pca: int | None = None,
        huber_delta: float | None = None,
    ):
        self.num_patients = num_patients
        self.num_labs = num_labs
        self.rank = rank
        self.mem_rank = rank if mem_rank is None else mem_rank
        self.reg = reg
        self.ridge_reg = ridge_reg
        self.iters = iters
        self.seed = seed
        self.min_lab_edges = min_lab_edges
        self.huber_delta = huber_delta  # robust ALS factor step (see ALSBaseline)
        # the per-lab ridge costs O(sum_l n_l * d^2) with d = rank + D + 1;
        # above ~256 membership columns the fit projects M onto its top
        # principal components first (lossless in the useful directions —
        # the SVD truncation below keeps only mem_rank of them anyway).
        # None = auto: full fit for D <= 256, 128-dim PCA beyond.
        self.mem_pca = mem_pca
        self.U = np.zeros((num_patients, rank))
        self.C = np.zeros((num_labs, rank))
        self.lab_bias = np.zeros(num_labs)
        self.G = np.zeros((num_patients, self.mem_rank))
        self.H = np.zeros((num_labs, self.mem_rank))
        self.mem_proj = np.zeros((0, self.mem_rank))

    def _per_lab_ridge(
        self,
        feats: np.ndarray,  # [P, d] per-patient features (includes constant)
        values: np.ndarray,
        p: np.ndarray,
        l: np.ndarray,
        reg: float,
    ) -> np.ndarray:
        d = feats.shape[1]
        theta = np.zeros((self.num_labs, d))
        eye = reg * np.eye(d)
        order = np.argsort(l, kind="stable")
        bounds = np.searchsorted(l[order], np.arange(self.num_labs + 1))
        for lab in range(self.num_labs):
            rows = order[bounds[lab] : bounds[lab + 1]]
            if len(rows) < self.min_lab_edges:
                continue
            x = feats[p[rows]]
            theta[lab] = np.linalg.solve(x.T @ x + eye, x.T @ values[rows])
        return theta

    def fit(
        self,
        values: np.ndarray,
        patient_indices: np.ndarray,
        lab_indices: np.ndarray,
        memberships: np.ndarray,  # [P, D] binary side features
    ) -> "SideInfoALSBaseline":
        values = np.asarray(values, dtype=np.float64)
        p = np.asarray(patient_indices)
        l = np.asarray(lab_indices)
        m = np.asarray(memberships, dtype=np.float64)
        if m.shape[0] != self.num_patients:
            raise ValueError(
                f"memberships rows {m.shape[0]} != num_patients {self.num_patients}"
            )

        als = ALSBaseline(
            self.num_patients, self.num_labs, rank=self.rank, reg=self.reg,
            iters=self.iters, seed=self.seed, huber_delta=self.huber_delta,
        ).fit(values, p, l)
        self.U = als.U

        # optional PCA pre-compression of the membership block (see __init__)
        d_mem = m.shape[1]
        q = self.mem_pca
        if q is None:
            q = d_mem if d_mem <= 256 else 128
        q = min(q, d_mem, self.num_patients)
        if q < d_mem:
            mc = m - m.mean(axis=0, keepdims=True)
            # eigendecomposition of the [D, D] gram — cheap even at D ~ 1e3
            _, vecs = np.linalg.eigh(mc.T @ mc)
            basis = vecs[:, ::-1][:, :q]  # top-q principal directions [D, q]
            m_feats = m @ basis
        else:
            basis = np.eye(d_mem)
            m_feats = m

        k = self.rank
        feats = np.hstack([self.U, m_feats, np.ones((self.num_patients, 1))])
        theta = self._per_lab_ridge(feats, values, p, l, self.ridge_reg)

        # SVD-truncate the membership block (denoises: its true rank is the
        # generator's latent_dim, while the ridge fit spreads noise over all
        # D membership columns)
        theta_mem = theta[:, k:-1]  # [L, q] — in the (possibly PCA'd) basis
        uu, ss, vt = np.linalg.svd(theta_mem, full_matrices=False)
        r = min(self.mem_rank, len(ss))
        self.H = np.zeros((self.num_labs, self.mem_rank))
        self.H[:, :r] = uu[:, :r] * ss[:r]
        # the membership projection: a patient's side factors are
        # m @ mem_proj (the PCA basis composes in)
        self.mem_proj = np.zeros((d_mem, self.mem_rank))
        self.mem_proj[:, :r] = basis @ vt[:r].T
        self.G = m @ self.mem_proj

        # refit the lab-side factors + bias against the truncated term
        resid = values - np.einsum(
            "er,er->e", self.G[p], self.H[l]
        )
        feats_u = np.hstack([self.U, np.ones((self.num_patients, 1))])
        theta_u = self._per_lab_ridge(feats_u, resid, p, l, self.ridge_reg)
        self.C = theta_u[:, :k]
        self.lab_bias = theta_u[:, k]
        return self

    def predict(self, patient_indices: np.ndarray, lab_indices: np.ndarray) -> np.ndarray:
        p = np.asarray(patient_indices)
        l = np.asarray(lab_indices)
        return (
            self.lab_bias[l]
            + np.einsum("ek,ek->e", self.U[p], self.C[l])
            + np.einsum("er,er->e", self.G[p], self.H[l])
        )

    def fold_in(
        self, obs_lab_indices: np.ndarray, obs_values: np.ndarray, memberships_row: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """``(u, g)`` of an unseen patient: ``g`` from the membership
        projection, ``u`` from one ridge solve against the lab factors on the
        membership-adjusted residuals.  With no observed labs ``u`` is 0 and
        the prediction rests on the dx / rx memberships alone."""
        m = np.asarray(memberships_row, dtype=np.float64).reshape(-1)
        if m.shape[0] != self.mem_proj.shape[0]:
            raise ValueError(
                f"membership width {m.shape[0]} != fitted {self.mem_proj.shape[0]}"
            )
        g = m @ self.mem_proj
        l = np.asarray(obs_lab_indices)
        if len(l) == 0:
            return np.zeros(self.rank), g
        v = np.asarray(obs_values, dtype=np.float64)
        c = self.C[l]
        resid = v - self.lab_bias[l] - self.H[l] @ g
        gram = self.reg * np.eye(self.rank) + c.T @ c
        return np.linalg.solve(gram, c.T @ resid), g

    def predict_cold_start(
        self,
        obs_lab_indices: np.ndarray,
        obs_values: np.ndarray,
        query_lab_indices: np.ndarray,
        memberships_row: np.ndarray,
    ) -> np.ndarray:
        """Predict ``query_lab_indices`` for a new patient given observed
        (lab, value) pairs and their dx / rx membership row."""
        u, g = self.fold_in(obs_lab_indices, obs_values, memberships_row)
        q = np.asarray(query_lab_indices)
        return self.lab_bias[q] + self.C[q] @ u + self.H[q] @ g


def evaluate_baselines(
    train_values: np.ndarray,
    train_lab_indices: np.ndarray,
    test_values: np.ndarray,
    test_lab_indices: np.ndarray,
    num_labs: int,
    train_patient_indices: np.ndarray | None = None,
    test_patient_indices: np.ndarray | None = None,
    num_patients: int | None = None,
    include_nn: bool = True,
    include_als: bool = False,
    als_rank: int = 8,
    memberships: np.ndarray | None = None,
    huber_delta: float | None = None,
) -> Dict[str, Dict[str, float]]:
    """Fit-and-score the configured baselines on the train/test split arrays.
    ``memberships`` (binary [P, D] dx/rx features — e.g.
    graph_membership_matrix) additionally scores the
    side-information baseline as ``sideinfo_als``."""
    results = {}
    gm = GlobalMeanBaseline().fit(train_values)
    results["global_mean"] = compute_regression_metrics(
        gm.predict(len(test_values)), test_values
    )
    plm = PerLabMeanBaseline(num_labs).fit(train_values, train_lab_indices)
    results["per_lab_mean"] = compute_regression_metrics(
        plm.predict(test_lab_indices), test_values
    )
    if train_patient_indices is not None and num_patients is not None:
        if include_nn:
            nn = NearestNeighborBaseline(num_patients, num_labs).fit(
                train_values, train_patient_indices, train_lab_indices
            )
            results["nearest_neighbor"] = compute_regression_metrics(
                nn.predict(test_patient_indices, test_lab_indices), test_values
            )
        if include_als:
            als = ALSBaseline(
                num_patients, num_labs, rank=als_rank, huber_delta=huber_delta
            ).fit(train_values, train_patient_indices, train_lab_indices)
            results["als_matrix_factorization"] = compute_regression_metrics(
                als.predict(test_patient_indices, test_lab_indices), test_values
            )
        if memberships is not None:
            si = SideInfoALSBaseline(
                num_patients, num_labs, rank=als_rank, huber_delta=huber_delta
            ).fit(train_values, train_patient_indices, train_lab_indices, memberships)
            results["sideinfo_als"] = compute_regression_metrics(
                si.predict(test_patient_indices, test_lab_indices), test_values
            )
    return results
