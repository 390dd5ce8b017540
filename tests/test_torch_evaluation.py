"""PyTorch port: the evaluation stage against the JAX package, on the CPU.

The same graph (written by JAX ``save_graph``, read by the port's
``load_graph``, lab names and all), the same split arrays (each package's
``masker_from_config``) and the same predictions (a duck-typed trainer on
each side: the split's targets plus seeded heavy-tailed noise) go through
JAX ``evaluate_model`` and the port's.  ``evaluation_results.json``,
``per_lab_metrics.csv`` and ``conformal.json`` must hold the same keys and
layout and the same numbers within ``1e-12`` (relative, or absolute near
0): metrics, winsorization, both strata, every baseline including ``als``
and ``sideinfo_als``, and the conformal intervals, with and without the
strict "cal" split.  The nearest-neighbour baseline, scored in query blocks
by the port, equals JAX's one-matrix answer exactly.
"""

import csv
import dataclasses
import json
import math

import numpy as np
import pytest

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.evaluation import baselines as jax_baselines
from multi_modal_gnn_tpu.evaluation.evaluate import evaluate_model as jax_evaluate_model
from multi_modal_gnn_tpu.graph.serialize import save_graph
from multi_modal_gnn_tpu.training.masker import masker_from_config as jax_masker_from_config
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.evaluation import baselines
from multi_modal_gnn_tpu_torch.evaluation.evaluate import evaluate_model
from multi_modal_gnn_tpu_torch.graph import load_graph
from multi_modal_gnn_tpu_torch.training import masker_from_config

TOL = 1e-12
SPEC = dict(
    num_patients=600, num_labs=12, num_diagnoses=10, num_medications=8,
    mean_labs_per_patient=9.0, mean_diagnoses_per_patient=2.0,
    mean_medications_per_patient=2.0, latent_dim=4, seed=3,
)
SPLIT_SEEDS = {"train": 0, "val": 1, "test": 2, "cal": 3}


class DuckTrainer:
    """What ``evaluate_model`` reads of a trainer; predictions are the
    split's targets plus seeded student-t noise, whatever the state."""

    def __init__(self, masker, graph):
        self.masker = masker
        self.graph = graph
        self.best_state = {"best": True}

    def predict(self, split, state=None):
        assert state is self.best_state
        _, _, targets = self.masker.split_arrays(split)
        rng = np.random.default_rng(SPLIT_SEEDS[split])
        return (targets + 0.4 * rng.standard_t(3, len(targets))).astype(np.float32)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    bundle = make_synthetic_bundle(JaxSpec(**SPEC), JaxConfig())
    path = save_graph(bundle, tmp_path_factory.mktemp("graph") / "graph")
    graph = load_graph(path, device="cpu")
    assert graph.lab_names == bundle.meta.lab_names
    return bundle, graph


def _close(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), where
        if math.isnan(want):
            assert math.isnan(got), where
        else:
            assert math.isclose(got, want, rel_tol=TOL, abs_tol=TOL), (where, got, want)
    else:
        assert got == want and type(got) is type(want), (where, got, want)


def _csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


@pytest.mark.parametrize("cal_fraction", [0.0, 0.3])
@pytest.mark.parametrize("huber_delta", [None, 1.0])
def test_evaluation_artifacts_equal_jax(cohort, tmp_path, cal_fraction, huber_delta):
    bundle, graph = cohort
    extras = {"conformal_alpha": 0.1, "conformal_split_fraction": cal_fraction}
    if huber_delta is not None:
        extras["huber_delta"] = huber_delta
    jcfg = JaxConfig()
    jcfg = jcfg.replace(
        evaluation=dataclasses.replace(
            jcfg.evaluation,
            baselines=("global_mean", "per_lab_mean", "nearest_neighbor", "als", "sideinfo_als"),
            extras=extras,
        )
    )
    cfg = Config.from_dict(jcfg.to_dict())
    theirs = DuckTrainer(jax_masker_from_config(jcfg, bundle), bundle.graph)
    ours = DuckTrainer(masker_from_config(cfg, graph), graph)
    assert ours.masker.split_sizes() == theirs.masker.split_sizes()
    want = jax_evaluate_model(theirs, bundle, jcfg, output_dir=tmp_path / "jax")
    got = evaluate_model(ours, graph, cfg, output_dir=tmp_path / "port")

    assert set(got) == set(want) and "conformal" in got
    _close(got, want, "results")
    for name in ("evaluation_results.json", "conformal.json"):
        _close(
            json.loads((tmp_path / "port" / name).read_text()),
            json.loads((tmp_path / "jax" / name).read_text()),
            name,
        )
    header, rows = _csv(tmp_path / "port" / "per_lab_metrics.csv")
    want_header, want_rows = _csv(tmp_path / "jax" / "per_lab_metrics.csv")
    assert header == want_header and len(rows) == len(want_rows) > 0
    for row, want_row in zip(rows, want_rows):
        for col, g, w in zip(header, row, want_row):
            if col in ("mae", "rmse", "r2", "mape"):
                assert math.isclose(float(g), float(w), rel_tol=TOL, abs_tol=TOL), (col, g, w)
            else:
                assert g == w, (col, g, w)


def test_nearest_neighbor_blocks_give_the_one_matrix_answer(cohort, monkeypatch):
    bundle, graph = cohort
    cfg = Config()
    masker = masker_from_config(cfg, graph)
    tr_p, tr_l, tr_v = masker.split_arrays("train")
    te_p, te_l, _ = masker.split_arrays("test")
    num_p, num_l = graph.num_nodes("patient"), graph.num_nodes("lab")
    want = jax_baselines.NearestNeighborBaseline(num_p, num_l).fit(tr_v, tr_p, tr_l).predict(te_p, te_l)
    nn = baselines.NearestNeighborBaseline(num_p, num_l).fit(tr_v, tr_p, tr_l)
    np.testing.assert_array_equal(nn.predict(te_p, te_l), want)
    monkeypatch.setattr(baselines, "NN_BLOCK_BYTES", 8 * num_p * 7)  # 7 queries a block
    np.testing.assert_array_equal(nn.predict(te_p, te_l), want)
    assert len(te_p) > 7 * 10


def test_membership_matrix_equals_the_bundles(cohort):
    from multi_modal_gnn_tpu.training.warmstart import bundle_membership_matrix

    bundle, graph = cohort
    np.testing.assert_array_equal(baselines.graph_membership_matrix(graph), bundle_membership_matrix(bundle))
