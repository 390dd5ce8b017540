"""Visualization (``multi_modal_gnn_tpu/viz``): training curves, graph
structure, advanced analyses and uncertainty, the four plot families of the
pipeline's visualize step, under JAX's file names and directories.

Each family computes on the trainer's device (its predictions through the
model's kernels, ``encode_nodes``, the conformal calibration, the
embeddings' PCA as a torch SVD) and then draws.  Drawing imports matplotlib
(Agg backend) only in :class:`Figures`, and sklearn (t-SNE), networkx or
umap only in the figures that need them; a figure whose library is missing
is left out and named (:meth:`Figures.warn`, :meth:`Figures.summary`),
where JAX's package raises ``ImportError``.  The one artifact that is not a
figure, ``per_lab_calibration.csv``, is written either way.
"""

from __future__ import annotations

import importlib
import logging
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)


def library_available(name: str) -> bool:
    """Whether ``name`` imports here (the card's machine has no matplotlib,
    sklearn, networkx or umap)."""
    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend (headless)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class Figures:
    """The figures of a visualize run: ``drawn`` (paths) and ``left_out``
    (path -> the missing library), and the other files it ``written``.
    With ``keep`` the drawn figures stay open in ``figures`` (path ->
    matplotlib figure) for inspection."""

    def __init__(self, keep: bool = False):
        self.keep = keep
        self.written: List[str] = []
        self.drawn: List[str] = []
        self.left_out: Dict[str, str] = {}
        self.figures: Dict[str, object] = {}

    def draw(self, path: Path, plot: Callable, needs: Sequence[str] = ()) -> bool:
        """``plot(plt)`` returns a figure, saved to ``path`` as JAX saves
        its figures; not called when matplotlib or one of ``needs`` does
        not import, and then ``path`` is left out."""
        for lib in ("matplotlib", *needs):
            if not library_available(lib):
                self.left_out[str(path)] = lib
                return False
        plt = pyplot()
        fig = plot(plt)
        path.parent.mkdir(parents=True, exist_ok=True)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        if self.keep:
            self.figures[str(path)] = fig
        else:
            plt.close(fig)
        self.drawn.append(str(path))
        logger.info("Wrote %s", path)
        return True

    def warn(self) -> None:
        """One warning per missing library, naming every figure it cost."""
        by_lib: Dict[str, List[str]] = {}
        for path, lib in self.left_out.items():
            by_lib.setdefault(lib, []).append(Path(path).name)
        for lib, names in by_lib.items():
            logger.warning(
                "%s is not installed: left out %d figure(s): %s", lib, len(names), ", ".join(names)
            )

    def summary(self) -> Dict:
        return {
            "written": list(self.written),
            "drawn": list(self.drawn),
            "left_out": {p: f"{lib} is not installed" for p, lib in self.left_out.items()},
        }


def node_embeddings(trainer) -> Dict[str, torch.Tensor]:
    """``encode_nodes`` of the best state (else the live model), eval mode,
    on the trainer's device."""
    with torch.no_grad():
        x_dict = trainer.eval_model(trainer.best_state).encode_nodes(train=False)
    return {nt: x.detach() for nt, x in x_dict.items()}


class TrainerOutputs:
    """What the families read from the trainer, computed once and shared
    (each of JAX's families computes it again): ``outputs(split)`` is
    ``trainer.predict(split, state=trainer.best_state)``,
    ``outputs.embeddings()`` is :func:`node_embeddings`."""

    def __init__(self, trainer):
        self.trainer = trainer
        self._preds: Dict[str, np.ndarray] = {}
        self._embeddings: Optional[Dict[str, torch.Tensor]] = None

    def __call__(self, split: str) -> np.ndarray:
        if split not in self._preds:
            self._preds[split] = self.trainer.predict(split, state=self.trainer.best_state)
        return self._preds[split]

    def embeddings(self) -> Dict[str, torch.Tensor]:
        if self._embeddings is None:
            self._embeddings = node_embeddings(self.trainer)
        return self._embeddings


def pca_2d(x: torch.Tensor) -> torch.Tensor:
    """The rows of ``x`` projected onto their first two principal axes
    (centered, float64, SVD on ``x``'s device; each axis's sign is the
    SVD's)."""
    x = x.detach().to(torch.float64)
    x = x - x.mean(0)
    _, _, vh = torch.linalg.svd(x, full_matrices=False)
    return x @ vh[:2].T


from multi_modal_gnn_tpu_torch.viz.advanced import run_advanced_visualizations  # noqa: E402
from multi_modal_gnn_tpu_torch.viz.graph_viz import visualize_graph_structure  # noqa: E402
from multi_modal_gnn_tpu_torch.viz.training_viz import create_all_visualizations  # noqa: E402
from multi_modal_gnn_tpu_torch.viz.uncertainty import run_uncertainty_visualizations  # noqa: E402


def visualize(config, bundle, trainer, history: Optional[Dict] = None, output_dir="outputs",
              figures: Optional[Figures] = None) -> Dict:
    """The four families in the pipeline step's order (``run_pipeline.py``
    step 6); returns :meth:`Figures.summary`."""
    figures = figures or Figures()
    outputs = TrainerOutputs(trainer)
    visualize_graph_structure(config, bundle, output_dir, figures=figures)
    create_all_visualizations(
        config, bundle, trainer, history=history, output_dir=output_dir, figures=figures, outputs=outputs
    )
    run_advanced_visualizations(config, bundle, trainer, output_dir, figures=figures, outputs=outputs)
    run_uncertainty_visualizations(config, bundle, trainer, output_dir, figures=figures, outputs=outputs)
    figures.warn()
    return figures.summary()


__all__ = [
    "Figures", "TrainerOutputs", "create_all_visualizations", "library_available",
    "node_embeddings", "pca_2d", "pyplot", "run_advanced_visualizations",
    "run_uncertainty_visualizations", "visualize", "visualize_graph_structure",
]
