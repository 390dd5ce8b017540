"""PyTorch port: the visualize step's four plot families and the models'
``encode_nodes``, held to the JAX package on the CPU.

* ``encode_nodes`` of the RGCN and the HGT (the full tables, and a cluster
  window whose rows run past the global count) against JAX's on weights
  carried across by ``models/convert.py``, within ``1e-6``.
* One 400-patient eicu cohort built by both packages (the same graph and
  splits), with the same injected predictions per split and the same node
  embeddings handed to each family through a stand-in trainer: every
  figure JAX draws is drawn under the same file name, with equal artist
  data (scatter offsets, line data, bar and histogram rectangles, images,
  titles, labels, tick labels, legends); the embeddings' PCA plane
  (a torch SVD here, sklearn's PCA in JAX) within ``1e-4`` up to the sign of
  each component; t-SNE (sklearn, fed the same embeddings) equal;
  ``per_lab_calibration.csv`` against JAX's frame within ``1e-9``.
* ``quantile_bins`` against ``pd.qcut(labels=False, duplicates="drop")``.
* Missing libraries: a figure whose library does not import is left out
  and named, the others are drawn, the CSV is written.
"""

import csv
import dataclasses
import logging
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from threadpoolctl import threadpool_limits

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import generate_synthetic_tables as jax_tables
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.graph.build import build_heterogeneous_graph as jax_build
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.models.factory import init_model_variables
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxEdgeMasker
from multi_modal_gnn_tpu.viz import advanced as jax_advanced
from multi_modal_gnn_tpu.viz import graph_viz as jax_graph_viz
from multi_modal_gnn_tpu.viz import training_viz as jax_training_viz
from multi_modal_gnn_tpu.viz import uncertainty as jax_uncertainty
from multi_modal_gnn_tpu_torch import viz
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_tables, make_synthetic_graph
from multi_modal_gnn_tpu_torch.graph import build_heterogeneous_graph
from multi_modal_gnn_tpu_torch.models import build_model, state_dict_from_flax
from multi_modal_gnn_tpu_torch.training import EdgeMasker
from multi_modal_gnn_tpu_torch.viz import advanced

SPEC = dataclasses.replace(SyntheticSpec.eicu_real(0), num_patients=400)
EMBED_DIM = 16
HISTORY = {"train_loss": [0.9, 0.8, 0.75], "val_loss": [0.85, 0.8, 0.81], "learning_rates": [1e-3, 1e-3, 5e-4]}
FAMILIES = {
    "graph": "graph_visualizations",
    "training": "visualizations",
    "advanced": "advanced_visualizations",
    "uncertainty": "uncertainty_visualizations",
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread for torch and for sklearn's OpenMP (t-SNE): the suite runs
    several workers at once, and t-SNE's threads spinning against them
    slowed one test fifteenfold there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


# -- encode_nodes ----------------------------------------------------------------------

SMALL = SyntheticSpec(
    num_patients=200, num_labs=20, num_diagnoses=15, num_medications=10,
    mean_labs_per_patient=6.0, mean_diagnoses_per_patient=2.0,
    mean_medications_per_patient=2.0, latent_dim=4, seed=2,
)


@pytest.mark.parametrize("arch", ["RGCN", "HGT"])
def test_encode_nodes_match_jax(arch):
    jcfg = JaxConfig()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, architecture=arch, hidden_dim=16, num_heads=4))
    bundle = make_synthetic_bundle(JaxSpec(**dataclasses.asdict(SMALL)), jcfg)
    jax_model = jax_build_model(jcfg, bundle.graph)
    variables = init_model_variables(jax_model, bundle.graph, jax.random.PRNGKey(1))
    cfg = Config.from_dict(jcfg.to_dict())
    graph = make_synthetic_graph(SMALL, cfg, device="cpu")
    model = build_model(cfg, graph, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    model.eval()
    n = graph.num_nodes("patient")
    # the full tables, then a cluster window of 64 rows whose last 24 run past the count
    windows = [(None, None), (n - 40, 64)]
    for base, local in windows:
        jgraph = bundle.graph
        pgraph = graph
        if base is not None:
            counts = tuple((t, local if t == "patient" else c) for t, c in bundle.graph.node_counts)
            jgraph = bundle.graph.replace(patient_id_base=jax.numpy.int32(base), node_counts=counts)
            pgraph = dataclasses.replace(graph, patient_id_base=base, node_counts=counts)
        want = jax.jit(
            lambda v, g: jax_model.apply(v, train=False, graph=g, method=jax_model.encode_nodes)
        )(variables, jgraph)
        with torch.no_grad():
            got = model.encode_nodes(train=False, graph=pgraph)
        assert list(got) == list(want)
        for nt in want:
            np.testing.assert_allclose(got[nt].detach().numpy(), np.asarray(want[nt]), rtol=1e-6, atol=1e-6, err_msg=nt)
        if base is not None:
            assert got["patient"].shape[0] == local


# -- the plot families -----------------------------------------------------------------


@pytest.fixture(scope="module")
def cohort():
    tables = generate_synthetic_tables(SPEC)
    jt = jax_tables(JaxSpec(**dataclasses.asdict(SPEC)))
    cfg, jcfg = Config(), JaxConfig()
    bundle = build_heterogeneous_graph(
        labs=tables["labs_normalized"], diagnoses=tables["diagnoses"], medications=tables["medications"],
        cohort=tables["cohort"], labitems=tables["labitems"], config=cfg,
    )
    jbundle = jax_build(
        labs=jt["labs_normalized"], diagnoses=jt["diagnoses"], medications=jt["medications"],
        cohort=jt["cohort"], labitems=jt["labitems"], config=jcfg,
    )
    masker = EdgeMasker(bundle.graph, seed=42)
    jmasker = JaxEdgeMasker(jbundle.graph, seed=42, host_edges=jbundle.patient_lab_host())
    rng = np.random.default_rng(0)
    preds = {}
    for split in ("train", "val", "test"):
        p, l, v = masker.split_arrays(split)
        jp, jl, jv = jmasker.split_arrays(split)
        assert np.array_equal(p, jp) and np.array_equal(l, jl) and np.array_equal(v, jv)
        preds[split] = (0.6 * v + 0.3 * rng.standard_normal(len(v)) + 0.05 * (l % 3)).astype(np.float32)
    emb = {nt: rng.standard_normal((n, EMBED_DIM)).astype(np.float32) for nt, n in bundle.graph.node_counts}
    emb["lab"][:, :2] *= 4.0  # two leading principal axes well apart from the rest
    return dict(cfg=cfg, jcfg=jcfg, bundle=bundle, jbundle=jbundle, masker=masker, jmasker=jmasker,
                preds=preds, emb=emb)


def _port_trainer(c):
    model = SimpleNamespace(encode_nodes=lambda train=False: {k: torch.from_numpy(v) for k, v in c["emb"].items()})
    return SimpleNamespace(
        masker=c["masker"], graph=c["bundle"].graph, best_state={"state": 0},
        predict=lambda split, state=None: c["preds"][split], eval_model=lambda state=None: model,
    )


def _jax_trainer(c):
    state = SimpleNamespace(params={}, batch_stats={})
    model = SimpleNamespace(encode_nodes=None, apply=lambda v, train=False, method=None: dict(c["emb"]))
    return SimpleNamespace(
        masker=c["jmasker"], graph=c["jbundle"].graph, best_state=state, state=state, model=model,
        predict=lambda split, state=None: c["preds"][split],
    )


def _jax_family(c, family, out, monkeypatch, config=None):
    """JAX's driver of ``family`` with its figures captured (drawn, not
    written)."""
    figs = {}

    def capture(fig, path):
        fig.tight_layout()
        fig.canvas.draw()
        figs[str(Path(path).relative_to(out))] = fig

    for mod in (jax_training_viz, jax_graph_viz, jax_advanced, jax_uncertainty):
        monkeypatch.setattr(mod, "_save", capture)
    cfg, trainer, bundle = config or c["jcfg"], _jax_trainer(c), c["jbundle"]
    history = HISTORY
    if family == "graph":
        jax_graph_viz.visualize_graph_structure(cfg, bundle, out)
    elif family == "training":
        jax_training_viz.create_all_visualizations(cfg, bundle, trainer, history=history, output_dir=out)
    elif family == "advanced":
        jax_advanced.run_advanced_visualizations(cfg, bundle, trainer, output_dir=out)
    else:
        jax_uncertainty.run_uncertainty_visualizations(cfg, bundle, trainer, output_dir=out)
    return figs


def _port_family(c, family, out, config=None, figures=None):
    figures = figures or viz.Figures(keep=True)
    cfg, trainer, bundle = config or c["cfg"], _port_trainer(c), c["bundle"]
    history = HISTORY
    if family == "graph":
        viz.visualize_graph_structure(cfg, bundle, out, figures=figures)
    elif family == "training":
        viz.create_all_visualizations(cfg, bundle, trainer, history=history, output_dir=out, figures=figures)
    elif family == "advanced":
        viz.run_advanced_visualizations(cfg, bundle, trainer, output_dir=out, figures=figures)
    else:
        viz.run_uncertainty_visualizations(cfg, bundle, trainer, output_dir=out, figures=figures)
    return {str(Path(p).relative_to(out)): fig for p, fig in figures.figures.items()}, figures


def _artists(fig):
    from matplotlib.patches import Rectangle

    axes = []
    for ax in fig.axes:
        legend = ax.get_legend()
        axes.append(dict(
            visible=ax.get_visible(), title=ax.get_title(), xlabel=ax.get_xlabel(), ylabel=ax.get_ylabel(),
            scales=(ax.get_xscale(), ax.get_yscale()),
            lines=[np.asarray(line.get_xydata(), np.float64) for line in ax.get_lines()],
            offsets=[np.asarray(col.get_offsets(), np.float64) for col in ax.collections],
            paths=[[np.asarray(p.vertices, np.float64) for p in col.get_paths()] for col in ax.collections],
            rects=[np.array([p.get_x(), p.get_y(), p.get_width(), p.get_height()], np.float64)
                   for p in ax.patches if isinstance(p, Rectangle)],
            texts=[(t.get_text(), np.asarray(t.get_position(), np.float64)) for t in ax.texts],
            images=[np.asarray(im.get_array()) for im in ax.images],
            xticks=[t.get_text() for t in ax.get_xticklabels()],
            yticks=[t.get_text() for t in ax.get_yticklabels()],
            legend=None if legend is None else [t.get_text() for t in legend.get_texts()],
        ))
    return axes


def _assert_same(got, want, path):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape, path
        if want.dtype.kind in "fc":
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12, err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


def _assert_pca_plane(got_fig, want_fig):
    """The scatter offsets of each node type within 1e-4, each component up
    to its sign; everything else equal."""
    got, want = _artists(got_fig), _artists(want_fig)
    g_off, w_off = got[0].pop("offsets"), want[0].pop("offsets")
    got[0].pop("paths"), want[0].pop("paths")
    _assert_same(got, want, "embeddings.png")
    g_all, w_all = np.concatenate(g_off), np.concatenate(w_off)
    for comp in range(2):
        sign = np.sign(np.dot(g_all[:, comp], w_all[:, comp]))
        np.testing.assert_allclose(sign * g_all[:, comp], w_all[:, comp], rtol=0, atol=1e-4)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_draws_jax_figures(cohort, family, tmp_path, monkeypatch):
    want = _jax_family(cohort, family, tmp_path / "jax", monkeypatch)
    got, figures = _port_family(cohort, family, tmp_path / "port")
    assert sorted(got) == sorted(want) and want, family
    assert all(name.startswith(FAMILIES[family] + "/") for name in got)
    assert not figures.left_out
    for name in want:
        if name.endswith("embeddings.png"):
            _assert_pca_plane(got[name], want[name])
        else:
            _assert_same(_artists(got[name]), _artists(want[name]), name)
        assert (tmp_path / "port" / name).exists()
    plt = viz.pyplot()
    for fig in list(got.values()) + list(want.values()):
        plt.close(fig)


def test_per_lab_calibration_csv_matches_jax_frame(cohort, tmp_path):
    c = cohort
    _, test_l, targets = c["masker"].split_arrays("test")
    preds = c["preds"]["test"]
    names = c["bundle"].meta.lab_names
    rows = advanced.create_per_lab_calibration_table(preds, targets, test_l, names, tmp_path, viz.Figures())
    want = jax_advanced.create_per_lab_calibration_table(preds, targets, test_l, c["jbundle"].meta.lab_names,
                                                        tmp_path / "jax")
    with open(tmp_path / "per_lab_calibration.csv") as f:
        got = list(csv.DictReader(f))
    assert list(got[0]) == list(want.columns) == list(advanced.CALIBRATION_COLUMNS)
    assert len(got) == len(want) == len(rows) and len(got) > 10
    for row, (_, ref) in zip(got, want.iterrows()):
        for col in want.columns:
            if col in ("lab_index", "num_samples"):
                assert int(row[col]) == int(ref[col])
            elif col == "lab_name":
                assert row[col] == ref[col]
            else:
                assert float(row[col]) == pytest.approx(float(ref[col]), rel=1e-9, abs=1e-12), col


@pytest.mark.parametrize(
    "values",
    [[1, 2, 2, 2, 3, 9], [3, 3, 3, 7], list(range(40)), [5, 1, 1, 1, 1, 1, 8, 8, 2, 30, 30, 30]],
)
def test_quantile_bins_match_pandas_qcut(values):
    x = np.asarray(values)
    np.testing.assert_array_equal(
        advanced.quantile_bins(x, 4), pd.qcut(x, q=4, labels=False, duplicates="drop").astype(int)
    )


def test_quantile_bins_of_one_value_is_one_bin(cohort, tmp_path, monkeypatch):
    """Where every test row's lab has one count, pandas gives NaN codes (and
    JAX's ``int(np.max(bins))`` fails); the port draws one bin."""
    with pytest.raises(ValueError):
        advanced.quantile_bins(np.full(7, 5), 4)
    figures = viz.Figures(keep=True)
    c = cohort
    _, test_l, targets = c["masker"].split_arrays("test")
    counts = np.full(c["bundle"].graph.num_nodes("lab"), 9.0)
    advanced.create_parity_plots_by_frequency(c["preds"]["test"], targets, test_l, counts, tmp_path, figures)
    (fig,) = figures.figures.values()
    assert len(fig.axes) == 1 and fig.axes[0].get_title().startswith("freq bin 1/1")
    viz.pyplot().close(fig)


@pytest.mark.parametrize("method", ["tsne", "umap"])
def test_embedding_methods_match_jax(cohort, method, tmp_path, monkeypatch, caplog):
    """t-SNE of the stacked embeddings (sklearn, the same inputs) draws
    JAX's figure; umap, absent here, falls back to PCA in both."""
    c = cohort
    if method == "umap":
        assert not viz.library_available("umap")
    jcfg = c["jcfg"].replace(visualization=dataclasses.replace(c["jcfg"].visualization, dim_reduction=method))
    cfg = c["cfg"].replace(visualization=dataclasses.replace(c["cfg"].visualization, dim_reduction=method))
    want = _jax_family(c, "training", tmp_path / "jax", monkeypatch, config=jcfg)["visualizations/embeddings.png"]
    with caplog.at_level(logging.WARNING):
        got, _ = _port_family(c, "training", tmp_path / "port", config=cfg)
    got = got["visualizations/embeddings.png"]
    if method == "umap":
        assert "substituting PCA" in caplog.text
        _assert_pca_plane(got, want)
    else:
        _assert_same(_artists(got), _artists(want), "embeddings.png")
    viz.pyplot().close("all")


def test_pca_2d_spans_sklearn_plane():
    from sklearn.decomposition import PCA

    x = np.random.default_rng(4).standard_normal((300, 8)) * [5.0, 3.0, 1.0, 1.0, 0.5, 0.5, 0.2, 0.1]
    got = viz.pca_2d(torch.from_numpy(x.astype(np.float32))).numpy()
    want = PCA(n_components=2, random_state=0).fit_transform(x.astype(np.float32))
    for comp in range(2):
        sign = np.sign(np.dot(got[:, comp], want[:, comp]))
        np.testing.assert_allclose(sign * got[:, comp], want[:, comp], rtol=0, atol=1e-4)


@pytest.mark.parametrize(
    "blocked, family, lost",
    [
        ("matplotlib", None, None),
        ("sklearn", "advanced", {"lab_embeddings_tsne.png", "patient_embeddings_tsne.png"}),
        ("networkx", "graph", {"network_sample.png"}),
    ],
)
def test_missing_library_leaves_its_figures_out(cohort, blocked, family, lost, tmp_path, monkeypatch, caplog):
    """Without matplotlib the whole step draws nothing and still writes the
    calibration table; without sklearn or networkx their family leaves out
    only the figures that need them."""
    monkeypatch.setitem(sys.modules, blocked, None)
    with caplog.at_level(logging.WARNING):
        if family is None:
            summary = viz.visualize(cohort["cfg"], cohort["bundle"], _port_trainer(cohort), history=HISTORY,
                                    output_dir=tmp_path)
        else:
            _, figures = _port_family(cohort, family, tmp_path, figures=viz.Figures())
            figures.warn()
            summary = figures.summary()
    left_out = {Path(p).name for p in summary["left_out"]}
    assert set(summary["left_out"].values()) == {f"{blocked} is not installed"}
    drawn = {p.name for p in tmp_path.rglob("*.png")}
    if lost is None:
        assert not summary["drawn"] and not drawn and len(left_out) == 22
    else:
        assert left_out == lost and drawn == {Path(p).name for p in summary["drawn"]} and drawn
        assert drawn.isdisjoint(lost)
    if family in (None, "advanced"):
        assert [Path(p).name for p in summary["written"]] == ["per_lab_calibration.csv"]
        assert (tmp_path / "advanced_visualizations" / "per_lab_calibration.csv").exists()
    warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len([w for w in warnings if w.startswith(f"{blocked} is not installed")]) == 1
    assert all(name in " ".join(warnings) for name in left_out)
