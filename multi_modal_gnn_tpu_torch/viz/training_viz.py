"""Standard visualizations (``multi_modal_gnn_tpu/viz/training_viz.py``),
one PNG each under ``<output>/visualizations/``:

* degree_distribution — patient lab-degree histogram + box;
* missingness_heatmap — patient x lab observed / missing matrix;
* training_curves — train / val loss + LR schedule with the best epoch;
* parity_plot — predictions vs targets with MAE / RMSE / R^2;
* error_distribution — residual histogram + normal Q-Q;
* per_lab_performance — best / worst lab MAE bars;
* embeddings — 2-D projection of the node embeddings (PCA on the device;
  t-SNE and umap when their libraries import).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.evaluation.metrics import compute_per_lab_metrics, compute_regression_metrics
from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT, PATIENT_LAB
from multi_modal_gnn_tpu_torch.viz import Figures, TrainerOutputs, library_available, pca_2d

logger = logging.getLogger(__name__)

_EMBED_COLORS = {"patient": "#4878a8", "lab": "#d1615d", "diagnosis": "#6aa56e", "medication": "#e49444"}


def plot_degree_distribution(degree: np.ndarray, out: Path, figures: Figures) -> None:
    degree = degree[degree > 0]

    def plot(plt):
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        axes[0].hist(degree, bins=30, color="#4878a8", edgecolor="white")
        axes[0].set_xlabel("labs per patient")
        axes[0].set_ylabel("patients")
        axes[0].set_title("Patient lab-degree distribution")
        axes[1].boxplot(degree, orientation="vertical")
        axes[1].set_title(f"median={np.median(degree):.0f}, mean={degree.mean():.1f}")
        return fig

    figures.draw(out / "degree_distribution.png", plot)


def missingness_matrix(
    patient_idx: np.ndarray, lab_idx: np.ndarray, num_patients: int, num_labs: int, max_patients: int = 400
) -> np.ndarray:
    """The observed-lab matrix of the ``max_patients`` best-covered patients,
    in JAX's order (descending coverage)."""
    mat = np.zeros((num_patients, num_labs), dtype=bool)
    mat[patient_idx, lab_idx] = True
    order = np.argsort(-mat.sum(axis=1))
    return mat[order][:max_patients]


def plot_missingness_heatmap(mat: np.ndarray, out: Path, figures: Figures) -> None:
    def plot(plt):
        fig, ax = plt.subplots(figsize=(8, 6))
        ax.imshow(mat, aspect="auto", cmap="Blues", interpolation="nearest")
        ax.set_xlabel("lab index")
        ax.set_ylabel(f"patients (top {len(mat)} by coverage)")
        ax.set_title(f"Observed-lab matrix (density {mat.mean():.1%})")
        return fig

    figures.draw(out / "missingness_heatmap.png", plot)


def plot_training_curves(history: Dict, out: Path, figures: Figures) -> None:
    train, val = history.get("train_loss", []), history.get("val_loss", [])
    lrs = history.get("learning_rates", [])
    if not train:
        return
    best = int(np.argmin(val)) if val else None

    def plot(plt):
        fig, axes = plt.subplots(1, 2, figsize=(11, 4))
        epochs = np.arange(1, len(train) + 1)
        axes[0].plot(epochs, train, label="train", color="#4878a8")
        if val:
            axes[0].plot(epochs, val, label="val", color="#d1615d")
            axes[0].axvline(best + 1, ls="--", color="gray", label=f"best epoch {best + 1}")
        axes[0].set_xlabel("epoch")
        axes[0].set_ylabel("loss")
        axes[0].legend()
        axes[0].set_title("Training curves")
        if lrs:
            axes[1].plot(epochs, lrs, color="#6aa56e")
            axes[1].set_yscale("log")
            axes[1].set_xlabel("epoch")
            axes[1].set_ylabel("learning rate")
            axes[1].set_title("LR schedule")
        return fig

    figures.draw(out / "training_curves.png", plot)


def plot_parity(predictions: np.ndarray, targets: np.ndarray, out: Path, figures: Figures) -> None:
    m = compute_regression_metrics(predictions, targets)

    def plot(plt):
        fig, ax = plt.subplots(figsize=(5.5, 5.5))
        ax.scatter(targets, predictions, s=6, alpha=0.3, color="#4878a8")
        lim = [min(targets.min(), predictions.min()), max(targets.max(), predictions.max())]
        ax.plot(lim, lim, "k--", lw=1)
        ax.set_xlabel("actual (normalized)")
        ax.set_ylabel("predicted (normalized)")
        ax.set_title("Parity plot")
        ax.text(
            0.03, 0.97,
            f"MAE {m['mae']:.3f}\nRMSE {m['rmse']:.3f}\nR2 {m['r2']:.3f}",
            transform=ax.transAxes, va="top",
            bbox=dict(facecolor="white", alpha=0.8, edgecolor="gray"),
        )
        return fig

    figures.draw(out / "parity_plot.png", plot)


def plot_error_distribution(predictions: np.ndarray, targets: np.ndarray, out: Path, figures: Figures) -> None:
    residuals = predictions - targets

    def plot(plt):
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        axes[0].hist(residuals, bins=50, color="#4878a8", edgecolor="white")
        axes[0].axvline(0, color="k", lw=1)
        axes[0].set_title(f"Residuals (mean {residuals.mean():.3f}, std {residuals.std():.3f})")
        try:
            from scipy import stats

            stats.probplot(residuals, dist="norm", plot=axes[1])
            axes[1].set_title("Normal Q-Q")
        except ImportError:  # pragma: no cover - scipy is on every machine here
            axes[1].set_visible(False)
        return fig

    figures.draw(out / "error_distribution.png", plot)


def plot_per_lab_performance(
    predictions: np.ndarray,
    targets: np.ndarray,
    lab_idx: np.ndarray,
    lab_names: Dict[int, str],
    out: Path,
    figures: Figures,
    top_n: int = 10,
) -> None:
    rows = compute_per_lab_metrics(predictions, targets, lab_idx, lab_names)
    if not rows:
        return
    best, worst = rows[:top_n], rows[-top_n:]

    def plot(plt):
        fig, axes = plt.subplots(1, 2, figsize=(12, max(4, 0.35 * top_n)))
        axes[0].barh([r["lab_name"] for r in best], [r["mae"] for r in best], color="#6aa56e")
        axes[0].invert_yaxis()
        axes[0].set_title(f"Best {len(best)} labs (MAE)")
        axes[1].barh([r["lab_name"] for r in worst], [r["mae"] for r in worst], color="#d1615d")
        axes[1].invert_yaxis()
        axes[1].set_title(f"Worst {len(worst)} labs (MAE)")
        for ax in axes:
            ax.set_xlabel("MAE")
        return fig

    figures.draw(out / "per_lab_performance.png", plot)


def plot_embeddings(
    embeddings_by_type: Dict[str, torch.Tensor], out: Path, figures: Figures, method: str = "pca"
) -> Optional[np.ndarray]:
    """2-D projection of the node embeddings colored by node type, as JAX
    projects them: umap, t-SNE (up to 5,000 rows) or PCA, which runs here
    on the embeddings' device.  Returns the projection, or None when
    ``method``'s library does not import (the figure is left out)."""
    all_emb = torch.cat(list(embeddings_by_type.values()), dim=0)
    use_tsne = method == "tsne" and len(all_emb) <= 5000
    lib = "umap" if method == "umap" else "sklearn" if use_tsne else None
    if lib is not None and not library_available(lib):
        figures.left_out[str(out / "embeddings.png")] = lib
        return None
    if method == "umap":
        from umap import UMAP

        proj = UMAP(n_components=2, random_state=0).fit_transform(all_emb.cpu().numpy())
    elif use_tsne:
        from sklearn.manifold import TSNE

        proj = TSNE(n_components=2, random_state=0, init="pca").fit_transform(all_emb.cpu().numpy())
    else:
        proj = pca_2d(all_emb).cpu().numpy()
    sizes = {ntype: len(emb) for ntype, emb in embeddings_by_type.items()}

    def plot(plt):
        fig, ax = plt.subplots(figsize=(6.5, 6))
        offset = 0
        for ntype, n in sizes.items():
            ax.scatter(
                proj[offset : offset + n, 0], proj[offset : offset + n, 1],
                s=8, alpha=0.5, label=f"{ntype} ({n})", color=_EMBED_COLORS.get(ntype),
            )
            offset += n
        ax.legend()
        ax.set_title(f"Node embeddings ({method.upper()})")
        return fig

    figures.draw(out / "embeddings.png", plot)
    return proj


def patient_lab_arrays(bundle):
    """The valid patient -> lab ``(src, dst)`` pairs, from the bundle's host
    copy when it holds them, else from the graph."""
    host = bundle.patient_lab_host()
    if host is not None:
        return host[0], host[1]
    es = bundle.graph.edges[PATIENT_LAB]
    mask = es.mask.cpu().numpy() > 0
    return es.src.cpu().numpy()[mask], es.dst.cpu().numpy()[mask]


def create_all_visualizations(
    config,
    bundle,
    trainer=None,
    history: Optional[Dict] = None,
    output_dir="outputs",
    figures: Optional[Figures] = None,
    outputs: Optional[TrainerOutputs] = None,
) -> Path:
    """The standard family (JAX ``create_all_visualizations``)."""
    out = Path(output_dir) / "visualizations"
    figures = figures if figures is not None else Figures()
    graph = bundle.graph
    vc = config.visualization
    degree = graph.patient_lab_degree.cpu().numpy()

    if vc.plot_degree_distribution:
        plot_degree_distribution(degree, out, figures)
    if vc.missingness_heatmap:
        p_idx, l_idx = patient_lab_arrays(bundle)
        mat = missingness_matrix(p_idx, l_idx, graph.num_nodes(PATIENT), graph.num_nodes(LAB))
        plot_missingness_heatmap(mat, out, figures)
    if history:
        plot_training_curves(history, out, figures)

    if trainer is not None:
        outputs = outputs if outputs is not None else TrainerOutputs(trainer)
        _, test_l, targets = trainer.masker.split_arrays("test")
        test_pred = outputs("test")
        if vc.generate_parity_plots:
            plot_parity(test_pred, targets, out, figures)
        plot_error_distribution(test_pred, targets, out, figures)
        plot_per_lab_performance(
            test_pred, targets, test_l, bundle.meta.lab_names, out, figures, top_n=vc.top_labs_to_plot
        )
        if vc.generate_embeddings:
            method = vc.dim_reduction
            if method == "umap" and not library_available("umap"):
                # JAX's own substitution: umap-learn is an optional extra
                logger.warning(
                    "visualization.dim_reduction=umap requested but "
                    "umap-learn is not installed; substituting PCA"
                )
                method = "pca"
            plot_embeddings(outputs.embeddings(), out, figures, method=method)
    return out
