"""Advanced post-training analyses (``multi_modal_gnn_tpu/viz/advanced.py``),
under ``<output>/advanced_visualizations/``:

* parity_by_frequency — parity panels per lab-frequency quantile bin;
* error_vs_degree — MAE per patient-degree bucket with the hybrid-head
  threshold line;
* per_lab_calibration.csv + per_lab_calibration — per-lab linear fit
  ``pred = a true + b`` and the MAE a linear recalibration would save;
* lab_embeddings_tsne — lab embeddings colored by clinical panel (sklearn);
* patient_embeddings_tsne — patient embeddings colored by lab-degree
  (sklearn).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from multi_modal_gnn_tpu_torch.evaluation.metrics import compute_regression_metrics
from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT, PATIENT_LAB
from multi_modal_gnn_tpu_torch.utils.io import save_csv
from multi_modal_gnn_tpu_torch.viz import Figures, TrainerOutputs

# clinical panel keyword buckets (JAX ``advanced.py _PANELS``)
_PANELS = {
    "CBC": ["wbc", "rbc", "hgb", "hemoglobin", "hct", "hematocrit", "platelet", "mch", "mpv",
            "monos", "lymphs", "eos", "polys", "basos"],
    "CMP": ["sodium", "potassium", "chloride", "bicarbonate", "bun", "creatinine", "glucose",
            "calcium", "anion"],
    "LFT": ["alt", "ast", "alkaline", "bilirubin", "albumin", "protein"],
    "Coag": ["pt", "ptt", "inr", "fibrinogen"],
    "ABG": ["pao2", "paco2", "ph", "hco3", "base", "o2", "fio2"],
}

# the columns of JAX's calibration frame, in its order
CALIBRATION_COLUMNS = (
    "lab_index", "lab_name", "slope", "intercept", "mae", "mae_recalibrated", "mae_delta",
    "num_samples",
)


def quantile_bins(x: np.ndarray, q: int) -> np.ndarray:
    """``pd.qcut(x, q, labels=False, duplicates="drop")``: bin codes over
    the ``q``-quantile edges (linear interpolation), repeated edges dropped,
    intervals closed on the right and the first on both sides; ValueError
    when fewer than two edges are left."""
    x = np.asarray(x, dtype=np.float64)
    edges = np.unique(np.quantile(x, np.linspace(0.0, 1.0, q + 1)))
    if len(edges) < 2:
        raise ValueError("Bin edges must be unique")
    return np.clip(np.searchsorted(edges, x, side="left") - 1, 0, len(edges) - 2)


def create_parity_plots_by_frequency(
    preds: np.ndarray, targets: np.ndarray, lab_idx: np.ndarray, lab_counts: np.ndarray, out: Path,
    figures: Figures, n_bins: int = 4,
) -> None:
    freq = lab_counts[lab_idx]
    try:
        bins = quantile_bins(freq, n_bins)
    except ValueError:
        bins = np.zeros(len(freq), dtype=int)
    n_actual = int(np.max(bins)) + 1

    def plot(plt):
        fig, axes = plt.subplots(1, n_actual, figsize=(4 * n_actual, 4), squeeze=False)
        for b in range(n_actual):
            m = bins == b
            ax = axes[0, b]
            if m.sum() < 2:
                ax.set_visible(False)
                continue
            met = compute_regression_metrics(preds[m], targets[m])
            ax.scatter(targets[m], preds[m], s=5, alpha=0.3, color="#4878a8")
            lim = [targets[m].min(), targets[m].max()]
            ax.plot(lim, lim, "k--", lw=1)
            ax.set_title(f"freq bin {b + 1}/{n_actual}\nR2 {met['r2']:.3f} MAE {met['mae']:.3f}",
                         fontsize=9)
        return fig

    figures.draw(out / "parity_by_frequency.png", plot)


def create_error_vs_degree_plot(
    preds: np.ndarray, targets: np.ndarray, patient_idx: np.ndarray, degree: np.ndarray,
    threshold: int, out: Path, figures: Figures,
) -> None:
    deg = degree[patient_idx]
    edges = [1, 3, 6, 10, 16, 25, 40, np.inf]
    labels, maes, counts = [], [], []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (deg >= lo) & (deg < hi)
        if m.sum() > 0:
            labels.append(f"{lo}-{'' if np.isinf(hi) else int(hi) - 1}+" if np.isinf(hi) else f"{lo}-{int(hi)-1}")
            maes.append(np.abs(preds[m] - targets[m]).mean())
            counts.append(int(m.sum()))

    def plot(plt):
        fig, ax = plt.subplots(figsize=(7, 4.5))
        bars = ax.bar(labels, maes, color="#4878a8")
        for bar, c in zip(bars, counts):
            ax.annotate(f"n={c}", (bar.get_x() + bar.get_width() / 2, bar.get_height()),
                        ha="center", va="bottom", fontsize=8)
        ax.axvline(1.5, color="#d1615d", ls="--", label=f"hybrid threshold ({threshold})")
        ax.set_xlabel("patient lab-degree bucket")
        ax.set_ylabel("MAE")
        ax.set_title("Error vs patient connectivity")
        ax.legend()
        return fig

    figures.draw(out / "error_vs_degree.png", plot)


def per_lab_calibration(
    preds: np.ndarray, targets: np.ndarray, lab_idx: np.ndarray, lab_names: Dict[int, str]
) -> List[Dict]:
    """Per-lab linear fit ``pred = a true + b`` (labs with at least 5 rows)
    and the MAE of the recalibrated ``(pred - b) / a``; rows keyed by
    :data:`CALIBRATION_COLUMNS`, by descending ``mae_delta`` in pandas'
    order (``sort_values(ascending=False)``)."""
    rows = []
    for lab in np.unique(lab_idx):
        m = lab_idx == lab
        if m.sum() < 5:
            continue
        t, p = targets[m], preds[m]
        a, b = np.polyfit(t, p, deg=1)
        mae = np.abs(p - t).mean()
        if abs(a) > 1e-6:
            mae_recal = np.abs((p - b) / a - t).mean()
        else:
            mae_recal = mae
        rows.append({
            "lab_index": int(lab),
            "lab_name": lab_names.get(int(lab), f"Lab_{lab}"),
            "slope": float(a),
            "intercept": float(b),
            "mae": float(mae),
            "mae_recalibrated": float(mae_recal),
            "mae_delta": float(mae - mae_recal),
            "num_samples": int(m.sum()),
        })
    # pandas' descending sort: reverse, quicksort ascending, reverse again
    delta = np.array([r["mae_delta"] for r in rows])[::-1]
    order = np.arange(len(rows))[::-1][delta.argsort(kind="quicksort")][::-1]
    return [rows[i] for i in order]


def create_per_lab_calibration_table(
    preds: np.ndarray, targets: np.ndarray, lab_idx: np.ndarray, lab_names: Dict[int, str],
    out: Path, figures: Figures,
) -> List[Dict]:
    """:func:`per_lab_calibration`, written to ``per_lab_calibration.csv``
    and drawn."""
    rows = per_lab_calibration(preds, targets, lab_idx, lab_names)
    if not rows:
        return rows
    path = out / "per_lab_calibration.csv"
    save_csv(rows, path, CALIBRATION_COLUMNS)
    figures.written.append(str(path))
    top = rows[:10]

    def plot(plt):
        fig, axes = plt.subplots(1, 3, figsize=(13, 4))
        axes[0].hist([r["slope"] for r in rows], bins=20, color="#4878a8")
        axes[0].axvline(1.0, color="k", ls="--")
        axes[0].set_title("calibration slopes (1.0 = perfect)")
        axes[1].hist([r["intercept"] for r in rows], bins=20, color="#6aa56e")
        axes[1].axvline(0.0, color="k", ls="--")
        axes[1].set_title("calibration intercepts")
        axes[2].barh([r["lab_name"] for r in top], [r["mae_delta"] for r in top], color="#e49444")
        axes[2].invert_yaxis()
        axes[2].set_title("top recalibration gains (MAE delta)")
        return fig

    figures.draw(out / "per_lab_calibration.png", plot)
    return rows


def _panel_of(name: str) -> str:
    low = name.lower()
    for panel, keywords in _PANELS.items():
        if any(k in low for k in keywords):
            return panel
    return "Other"


def create_embedding_visualizations(
    lab_emb: np.ndarray,
    patient_emb: np.ndarray,
    lab_names: Dict[int, str],
    degree: np.ndarray,
    out: Path,
    figures: Figures,
) -> None:
    """t-SNE of the lab and the patient embeddings (sklearn)."""
    if len(lab_emb) >= 5:
        def plot_labs(plt):
            from sklearn.manifold import TSNE

            proj = TSNE(
                n_components=2, random_state=0, init="pca",
                perplexity=min(30, max(2, len(lab_emb) // 3)),
            ).fit_transform(lab_emb)
            panels = [_panel_of(lab_names.get(i, "")) for i in range(len(lab_emb))]
            fig, ax = plt.subplots(figsize=(7, 6))
            for panel in sorted(set(panels)):
                m = np.array([p == panel for p in panels])
                ax.scatter(proj[m, 0], proj[m, 1], s=40, label=panel, alpha=0.8)
            for i in range(len(lab_emb)):
                ax.annotate(str(lab_names.get(i, i))[:10], proj[i], fontsize=5, alpha=0.6)
            ax.legend()
            ax.set_title("Lab embeddings (t-SNE) by clinical panel")
            return fig

        figures.draw(out / "lab_embeddings_tsne.png", plot_labs, needs=("sklearn",))

    if len(patient_emb) >= 10:
        sample = np.random.default_rng(0).choice(
            len(patient_emb), size=min(1500, len(patient_emb)), replace=False
        )

        def plot_patients(plt):
            from sklearn.manifold import TSNE

            proj = TSNE(n_components=2, random_state=0, init="pca").fit_transform(patient_emb[sample])
            fig, ax = plt.subplots(figsize=(7, 6))
            sc = ax.scatter(proj[:, 0], proj[:, 1], c=degree[sample], s=8, cmap="viridis")
            fig.colorbar(sc, label="lab-degree")
            ax.set_title("Patient embeddings (t-SNE) by connectivity")
            return fig

        figures.draw(out / "patient_embeddings_tsne.png", plot_patients, needs=("sklearn",))


def run_advanced_visualizations(
    config, bundle, trainer, output_dir="outputs", figures: Optional[Figures] = None,
    outputs: Optional[TrainerOutputs] = None,
) -> Path:
    """The advanced family (JAX ``run_advanced_visualizations``)."""
    out = Path(output_dir) / "advanced_visualizations"
    figures = figures if figures is not None else Figures()
    outputs = outputs if outputs is not None else TrainerOutputs(trainer)
    test_p, test_l, targets = trainer.masker.split_arrays("test")
    test_pred = outputs("test")
    graph = bundle.graph
    degree = graph.patient_lab_degree.cpu().numpy()
    lab_counts = graph.edges[PATIENT_LAB].dst_count.cpu().numpy()

    create_parity_plots_by_frequency(test_pred, targets, test_l, lab_counts, out, figures)
    create_error_vs_degree_plot(
        test_pred, targets, test_p, degree, config.model.degree_threshold, out, figures
    )
    create_per_lab_calibration_table(test_pred, targets, test_l, bundle.meta.lab_names, out, figures)
    emb = outputs.embeddings()
    create_embedding_visualizations(
        emb[LAB].float().cpu().numpy(), emb[PATIENT].float().cpu().numpy(), bundle.meta.lab_names,
        degree, out, figures,
    )
    return out
