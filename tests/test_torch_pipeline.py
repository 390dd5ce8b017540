"""PyTorch port: the pipeline command line and the modules on its path,
held to the JAX package on the CPU.

* Config: ``to_dict`` and ``model_hash`` equal JAX's on both conf files; a
  checkpoint trained with another ``feature_space`` is refused at restore
  unless forced, a JAX checkpoint's recorded hash is compared as written;
  ``reproducibility.deterministic: true`` is refused naming the atomic
  tiers, ``debug_nans`` trains under anomaly mode with its NaN check.
* Data: the eicu-phenomenology and flat tables equal JAX's column for
  column, exactly (``eicu_real(0)`` at full size, at 400 patients, and
  ``tiny``); the quantization guard keeps min |z| >= 0.03 per lab on the
  data seed used; ``spec_from_config`` equals JAX's.
* Graph: ``NodeIndexer`` equals JAX's; the graph built from the tables and
  saved by the port equals the JAX ``save_graph`` arrays, and each package
  reads the other's file; validation and statistics equal JAX's.
* Audit and inference: JAX trains the CI-sized cohort of
  ``tests/test_round4.py`` (400 patients, hidden 32, 8 epochs); the port
  restores that checkpoint and writes ``audit_report.json`` and
  ``inference_examples.json`` equal to JAX's (ints, names and picks exact,
  floats within ``1e-5 + 1e-5 |ref|``: f32 sums in another order).
* Serving (step 8): ``--step 8`` on JAX's checkpoint writes the artifact;
  ``ServingModel`` answers the test pairs like the trainer and like JAX's
  own step-8 artifact, and its cold-start factors and radii equal JAX's;
  without a checkpoint the step raises ``FileNotFoundError``, as JAX's does.
* Visualize (step 6): ``--step 6`` on JAX's checkpoint writes the files
  JAX's own step 6 writes on its run, and ``per_lab_calibration.csv``
  within ``1e-4`` of JAX's (the predictions agree to ~1e-5).
* The command line, ``--device cpu``: steps 1-8 end to end on the same
  config; each ``--step`` range runs exactly its steps; ``--list``.
"""

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from threadpoolctl import threadpool_limits

import run_pipeline
from multi_modal_gnn_tpu import audit as jax_audit
from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.config import load_config as jax_load_config
from multi_modal_gnn_tpu.data.preprocess import preprocess_pipeline as jax_preprocess
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import generate_synthetic_tables as jax_tables
from multi_modal_gnn_tpu.data.synthetic import spec_from_config as jax_spec_from_config
from multi_modal_gnn_tpu.graph.build import build_graph_from_preprocessed as jax_build_from_preprocessed
from multi_modal_gnn_tpu.graph.build import build_heterogeneous_graph as jax_build
from multi_modal_gnn_tpu.graph.indexer import NodeIndexer as JaxIndexer
from multi_modal_gnn_tpu.graph.serialize import load_graph as jax_load_graph
from multi_modal_gnn_tpu.graph.serialize import save_graph as jax_save_graph
from multi_modal_gnn_tpu.graph.stats import compute_graph_statistics as jax_stats
from multi_modal_gnn_tpu.inference import Denormalizer as JaxDenormalizer
from multi_modal_gnn_tpu.training.trainer import train_pipeline as jax_train_pipeline
from multi_modal_gnn_tpu_torch import pipeline
from multi_modal_gnn_tpu_torch.audit import PatientHoldoutSplitter, compute_robust_metrics, run_full_audit
from multi_modal_gnn_tpu_torch.config import ATOMIC_TIERS, Config, ConfigError, load_config, save_config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_tables, make_synthetic_graph, spec_from_config
from multi_modal_gnn_tpu_torch.data.preprocess import load_table, preprocess_pipeline, save_table
from multi_modal_gnn_tpu_torch.graph import GraphMeta, build_graph_from_preprocessed, build_heterogeneous_graph, load_bundle, save_graph
from multi_modal_gnn_tpu_torch.graph.indexer import NodeIndexer
from multi_modal_gnn_tpu_torch.graph.stats import GraphValidationError, compute_graph_statistics, validate_graph
from multi_modal_gnn_tpu_torch.inference import Denormalizer, run_inference
from multi_modal_gnn_tpu_torch.models import build_model
from multi_modal_gnn_tpu_torch.training import Trainer, masker_from_config, train_pipeline

REPO = Path(__file__).resolve().parent.parent
CONF_FILES = ["conf/config.yaml", "conf/eicu_real.yaml"]
CPU = torch.device("cpu")
# one CPU thread in this process and in the command line's: the suite runs
# several workers at once, and small models gain nothing from more threads
ONE_THREAD = {name: "1" for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ci_config(load, replace_data, out):
    """``conf/eicu_real.yaml`` cut as ``tests/test_round4.py`` cuts it."""
    cfg = load(REPO / "conf/eicu_real.yaml")
    return cfg.replace(
        data=replace_data(cfg.data, out),
        model=dataclasses.replace(cfg.model, hidden_dim=32),
        train=dataclasses.replace(cfg.train, epochs=8),
        evaluation=dataclasses.replace(cfg.evaluation, baselines=("global_mean", "per_lab_mean")),
        logging=dataclasses.replace(cfg.logging, log_file=str(out / "out" / "training.log")),
    )


def _data(data, out):
    return dataclasses.replace(
        data, interim_dir=str(out / "interim"), output_dir=str(out / "out"),
        extras={"synthetic": {"preset": "eicu_real", "seed": 0, "num_patients": 400}},
    )


def _assert_close_json(want, got, path="$"):
    """Same keys in the same order, ints / strings / bools / None equal,
    floats within ``1e-5 + 1e-5 |ref|``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(want) == list(got), path
        for k in want:
            _assert_close_json(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_close_json(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), path
        assert abs(want - got) <= 1e-5 + 1e-5 * abs(want), (path, want, got)
    else:
        assert type(want) is type(got) and want == got, (path, want, got)


# -- config --------------------------------------------------------------------


@pytest.mark.parametrize("name", CONF_FILES)
def test_config_dict_and_hashes_equal_jax(name):
    ours, theirs = load_config(REPO / name), jax_load_config(REPO / name)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.model_hash() == theirs.model_hash()
    assert ours.content_hash() == theirs.content_hash()
    assert Config.from_dict(theirs.to_dict()) == ours
    changed = dataclasses.replace(
        ours, feature_space=dataclasses.replace(
            ours.feature_space,
            labs=dataclasses.replace(ours.feature_space.labs, aggregate="mean"),
        ),
    )
    jax_changed = dataclasses.replace(
        theirs, feature_space=dataclasses.replace(
            theirs.feature_space,
            labs=dataclasses.replace(theirs.feature_space.labs, aggregate="mean"),
        ),
    )
    assert changed.model_hash() == jax_changed.model_hash() != ours.model_hash()


@pytest.mark.parametrize(
    "section",
    [
        {"data": {"dataset": "parquet"}},
        {"data": {"loader": "x"}},
        {"cohort": {"min_age": 18}},
        {"feature_space": {"labs": {"aggregate": "first"}}},
        {"feature_space": {"vitals": {}}},
        {"graph": {"edge_types": {"patient_lab": {"weighted": True}}}},  # node_types is taken since one-way relations run
        {"graph": {"shard_layout": 2}},
        {"reproducibility": {"strict": True}},
        {"model": {"edge_head": {"final_activation": "relu"}}},
        {"training": {}},
    ],
)
def test_config_refuses_settings_it_does_not_run(section):
    with pytest.raises(ConfigError):
        Config.from_dict(section)


def _tiny_trainer(cfg, seed=0):
    graph = make_synthetic_graph(SyntheticSpec.tiny(), cfg, device=CPU)
    model = build_model(cfg, graph, device=CPU, generator=torch.Generator().manual_seed(seed))
    return Trainer(model, graph, masker_from_config(cfg, graph), cfg, device=CPU)


def test_restore_refuses_another_feature_space_unless_forced(tmp_path):
    cfg = Config.from_dict({"model": {"hidden_dim": 16}, "train": {"epochs": 1}})
    _tiny_trainer(cfg).fit(output_dir=tmp_path)
    other = Config.from_dict({
        "model": {"hidden_dim": 16}, "train": {"epochs": 1},
        "feature_space": {"labs": {"aggregate": "mean"}},
    })
    twin = _tiny_trainer(other, seed=1)
    with pytest.raises(ValueError, match="incompatible config"):
        twin.restore(tmp_path / "best_model.ckpt")
    twin.restore(tmp_path / "best_model.ckpt", force=True)
    assert twin.epoch == 1


def test_deterministic_is_refused_naming_the_atomic_tiers():
    with pytest.raises(ConfigError, match="deterministic") as err:
        Config.from_dict({"reproducibility": {"deterministic": True}})
    assert ATOMIC_TIERS in str(err.value) and "index_add_" in ATOMIC_TIERS and "K2b" in ATOMIC_TIERS


@pytest.mark.parametrize("debug_nans", [False, True])
def test_debug_nans_trains_under_the_nan_check(debug_nans, tmp_path, monkeypatch):
    cfg = Config.from_dict({
        "model": {"hidden_dim": 16}, "train": {"epochs": 1},
        "reproducibility": {"debug_nans": debug_nans, "numpy_seed": 7, "random_seed": 8},
    })
    seen = {}
    fit = Trainer.fit

    def recording_fit(self, *args, **kwargs):
        seen["modes"] = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
        seen["numpy"] = np.random.random()
        return fit(self, *args, **kwargs)

    monkeypatch.setattr(Trainer, "fit", recording_fit)
    graph = make_synthetic_graph(SyntheticSpec.tiny(), cfg, device=CPU)
    train_pipeline(cfg, graph, tmp_path, device=CPU)
    assert seen["modes"][0] == debug_nans and (seen["modes"][1] or not debug_nans)
    assert seen["numpy"] == np.random.RandomState(7).random_sample()
    assert not torch.is_anomaly_enabled()


# -- data ------------------------------------------------------------------------


def _assert_tables_equal(frames, tables):
    assert list(frames) == list(tables)
    for name, df in frames.items():
        assert list(df.columns) == list(tables[name]), name
        for col in df.columns:
            want, got = df[col].to_numpy(), tables[name][col]
            if want.dtype == object or got.dtype.kind == "U":
                assert [str(v) for v in want] == got.tolist(), (name, col)
            else:
                assert want.dtype == got.dtype, (name, col)
                np.testing.assert_array_equal(want, got, err_msg=f"{name}.{col}")


@pytest.mark.parametrize(
    "make",
    [
        lambda cls: cls.eicu_real(0),
        lambda cls: dataclasses.replace(cls.eicu_real(0), num_patients=400),
        lambda cls: cls.tiny(0),
    ],
    ids=["eicu_real", "eicu_real_400", "tiny"],
)
def test_tables_equal_jax(make):
    tables = generate_synthetic_tables(make(SyntheticSpec))
    _assert_tables_equal(jax_tables(make(JaxSpec)), tables)
    if make(SyntheticSpec).phenomenology == "eicu":
        labs = tables["labs_normalized"]
        z, item = np.abs(labs["VALUE_NORMALIZED"]), labs["ITEMID"]
        assert min(z[item == i].min() for i in np.unique(item)) >= 0.03


@pytest.mark.parametrize("name", CONF_FILES)
def test_spec_from_config_equals_jax(name):
    for synthetic in (None, {"preset": "tiny", "seed": 3, "num_patients": 50.0, "signal_strength": 1}):
        ours, theirs = load_config(REPO / name), jax_load_config(REPO / name)
        if synthetic is not None:
            ours = ours.replace(data=dataclasses.replace(ours.data, extras={"synthetic": synthetic}))
            theirs = theirs.replace(data=dataclasses.replace(theirs.data, extras={"synthetic": synthetic}))
        assert dataclasses.asdict(spec_from_config(ours)) == dataclasses.asdict(jax_spec_from_config(theirs))
    bad = ours.replace(data=dataclasses.replace(ours.data, extras={"synthetic": {"preset": "x"}}))
    with pytest.raises(ConfigError):
        spec_from_config(bad)


@pytest.mark.parametrize("dataset", ["eicu", "mimic3"])
def test_preprocess_refuses_the_raw_datasets(dataset, tmp_path):
    # the raw loaders are ported (tests/test_torch_ingest.py); without a raw
    # directory the stage raises before it writes anything, as JAX's does
    cfg = Config.from_dict({"data": {"dataset": dataset, "raw_dir": str(tmp_path / "no_raw")}})
    with pytest.raises(FileNotFoundError, match="no_raw"):
        preprocess_pipeline(cfg, interim_dir=tmp_path / "interim")
    assert not any(tmp_path.iterdir())


def test_tables_round_trip_through_npz(tmp_path):
    tables = generate_synthetic_tables(SyntheticSpec.tiny(1))
    for name, table in tables.items():
        back = load_table(save_table(table, tmp_path / f"{name}.npz"))
        assert list(back) == list(table)
        for col in table:
            np.testing.assert_array_equal(back[col], table[col])


# -- graph -------------------------------------------------------------------------


@pytest.mark.parametrize(
    "ids",
    [
        [5, 3, 5, 1.0, "3", " 7 ", "2.0", 2.5, "x", " x", "nan", float("nan"), float("nan"), "inf"],
        np.array(["250", "301", "250", "drug_001", "041.9"]),
        np.array([3.0, 1.0, 3.0, 2.0]),
        np.arange(10, 0, -1),
    ],
)
def test_node_indexer_equals_jax(ids):
    ours, theirs = NodeIndexer("lab"), JaxIndexer("lab")
    arr = np.asarray(ids, dtype=object) if isinstance(ids, list) else ids
    np.testing.assert_array_equal(ours.add_many(arr), theirs.add_many(arr))
    assert json.dumps(ours.to_dict()) == json.dumps(theirs.to_dict())
    probe = np.asarray([3, "5", 99, "x", 2.5, 1], dtype=object) if isinstance(ids, list) else arr[::-1]
    np.testing.assert_array_equal(ours.lookup_many(probe), theirs.lookup_many(probe))
    back = NodeIndexer.from_dict(json.loads(json.dumps(ours.to_dict())))
    assert json.dumps(back.to_dict()) == json.dumps(JaxIndexer.from_dict(theirs.to_dict()).to_dict())


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The 400-patient eicu_real tables built and saved by both packages."""
    out = tmp_path_factory.mktemp("built")
    spec = dataclasses.replace(SyntheticSpec.eicu_real(0), num_patients=400)
    tables = generate_synthetic_tables(spec)
    frames = jax_tables(dataclasses.replace(JaxSpec.eicu_real(0), num_patients=400))
    cfg, jcfg = load_config(REPO / "conf/eicu_real.yaml"), jax_load_config(REPO / "conf/eicu_real.yaml")
    ours = build_heterogeneous_graph(
        tables["labs_normalized"], tables["diagnoses"], tables["medications"],
        tables["cohort"], tables["labitems"], cfg,
    )
    theirs = jax_build(
        frames["labs_normalized"], frames["diagnoses"], frames["medications"],
        frames["cohort"], frames["labitems"], jcfg,
    )
    save_graph(ours, out / "port" / "graph")
    jax_save_graph(theirs, out / "jax" / "graph")
    return out, ours, theirs


def test_saved_graph_equals_jax(built):
    out, _, _ = built
    with np.load(out / "port" / "graph.npz") as ours, np.load(out / "jax" / "graph.npz") as theirs:
        assert ours.files == theirs.files
        for key in theirs.files:
            assert ours[key].dtype == theirs[key].dtype, key
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    ours = json.loads((out / "port" / "graph.meta.json").read_text())
    theirs = json.loads((out / "jax" / "graph.meta.json").read_text())
    stats_ours, stats_theirs = ours["meta"].pop("lab_stats"), theirs["meta"].pop("lab_stats")
    assert ours == theirs
    assert list(stats_ours) == list(stats_theirs)
    for lab, want in stats_theirs.items():
        for key in ("mean", "std"):  # pandas sums float32 in another order: within an ulp
            assert stats_ours[lab][key] == pytest.approx(want[key], rel=2e-7), (lab, key)


def test_each_package_reads_the_others_graph(built):
    out, ours, theirs = built
    jax_reads = jax_load_graph(out / "port" / "graph.npz")
    assert jax_reads.graph.node_counts == theirs.graph.node_counts
    assert jax_reads.meta.lab_names == theirs.meta.lab_names
    for et, (src, dst, val) in theirs.host_edges.items():
        np.testing.assert_array_equal(jax_reads.host_edges[et][0], src)
        np.testing.assert_array_equal(jax_reads.host_edges[et][1], dst)
    port_reads = load_bundle(out / "jax" / "graph", device=CPU)
    assert port_reads.graph.node_counts == ours.graph.node_counts
    assert port_reads.graph.lab_names == ours.graph.lab_names == ours.meta.lab_names
    assert port_reads.meta.to_dict()["indexers"] == ours.meta.to_dict()["indexers"]
    for et, (src, dst, val) in ours.host_edges.items():
        got = port_reads.host_edges[et]
        np.testing.assert_array_equal(got[0], src)
        np.testing.assert_array_equal(got[1], dst)
        if val is not None:
            np.testing.assert_array_equal(got[2], val)


def test_graph_statistics_and_validation_equal_jax(built):
    _, ours, theirs = built
    validate_graph(ours.graph)
    assert compute_graph_statistics(ours.graph) == jax_stats(theirs.graph)
    es = next(iter(ours.graph.edges.values()))
    keep = int(es.dst[0])
    es.dst[0] = es.num_dst + 1
    try:
        with pytest.raises(GraphValidationError, match="out of bounds"):
            validate_graph(ours.graph)
    finally:
        es.dst[0] = keep


def test_sharded_output_is_refused(tmp_path):
    """``graph.extras.num_shards`` writes the sharded artifact at the graph
    build (``graph/distributed.py``); a count that does not divide the edge
    padding is refused, with JAX's error, before any shard file is written."""
    cfg = Config.from_dict({"graph": {"num_shards": 3}})
    tables = generate_synthetic_tables(SyntheticSpec.tiny())
    for name in ("labs_normalized", "diagnoses", "medications", "cohort", "labitems"):
        save_table(tables[name], tmp_path / "interim" / f"{name}.npz")
    with pytest.raises(ValueError, match="not divisible by num_shards=3"):
        build_graph_from_preprocessed(tmp_path / "interim", cfg, output_path=tmp_path / "out" / "graph")
    assert not list((tmp_path / "out").glob("graph_sharded*"))


# -- audit and inference on one JAX checkpoint ----------------------------------------


@pytest.fixture(scope="module")
def jax_ci_run(tmp_path_factory):
    """JAX's steps 1-3, 5 and 7 on the CI-sized eicu_real cohort."""
    out = tmp_path_factory.mktemp("jax_ci")
    cfg = _ci_config(jax_load_config, _data, out)
    jax_preprocess(cfg, interim_dir=cfg.data.interim_dir)
    bundle = jax_build_from_preprocessed(cfg.data.interim_dir, cfg, output_path=out / "out" / "graph")
    jax_train_pipeline(cfg, bundle, cfg.data.output_dir)
    run_pipeline.step_audit(cfg)
    run_pipeline.step_inference(cfg)
    return out, cfg


def test_audit_and_inference_equal_jax_on_its_checkpoint(jax_ci_run, tmp_path):
    out, jcfg = jax_ci_run
    cfg = Config.from_dict(jcfg.to_dict())
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, interim_dir=str(tmp_path / "interim")))
    tables = preprocess_pipeline(cfg, interim_dir=cfg.data.interim_dir)
    _assert_tables_equal(
        {name: pd.read_parquet(out / "interim" / f"{name}.parquet") for name in tables}, tables
    )
    opts = pipeline.RunOptions(device=CPU)
    bundle = pipeline._load_bundle(cfg, opts)
    trainer = pipeline._load_trainer(cfg, bundle, opts)
    sidecar = json.loads((out / "out" / "best_model.ckpt.json").read_text())
    assert trainer.epoch == sidecar["epoch"] and sidecar["model_hash"] == cfg.model_hash()

    run_full_audit(cfg, bundle, trainer, output_dir=tmp_path / "port")
    run_inference(cfg, bundle, trainer, tmp_path / "port", cohort=tables["cohort"])
    for name in ("audit_report.json", "inference_examples.json"):
        want = json.loads((out / "out" / name).read_text())
        _assert_close_json(want, json.loads((tmp_path / "port" / name).read_text()))
    report = json.loads((tmp_path / "port" / "audit_report.json").read_text())
    assert not report["masked_value_visibility"]["supervision_leak"]

    # a JAX checkpoint of another feature space is refused as written
    other = dataclasses.replace(cfg, feature_space=dataclasses.replace(
        cfg.feature_space, labs=dataclasses.replace(cfg.feature_space.labs, aggregate="median")))
    with pytest.raises(ValueError, match="incompatible config"):
        pipeline._load_trainer(other, bundle, opts)


def test_patient_holdout_and_robust_metrics_equal_jax(jax_ci_run, tmp_path):
    out, jcfg = jax_ci_run
    cfg = Config.from_dict(jcfg.to_dict())
    bundle = load_bundle(out / "out" / "graph", device=CPU)
    jbundle = jax_load_graph(out / "out" / "graph")
    ours = PatientHoldoutSplitter(bundle.graph, seed=5, host_edges=bundle.patient_lab_host())
    theirs = jax_audit.PatientHoldoutSplitter(jbundle.graph, seed=5, host_edges=jbundle.patient_lab_host())
    assert ours.split_sizes() == theirs.split_sizes()
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(ours.split_indices(split), theirs.split_indices(split))
    rng = np.random.default_rng(0)
    y, p = rng.standard_normal(500), rng.standard_normal(500)
    assert compute_robust_metrics(y, p) == jax_audit.compute_robust_metrics(y, p)

    tiny = Config.from_dict({"model": {"hidden_dim": 16}, "train": {"epochs": 2}})
    trainer = _tiny_trainer(tiny)
    trainer.fit()
    tiny_bundle = dataclasses.replace(bundle, graph=trainer.graph, host_edges=None)
    report = run_full_audit(tiny, tiny_bundle, trainer, compare_holdout=True)
    holdout = report["split_strategy_comparison"]["patient_holdout"]
    assert math.isfinite(holdout["mae"]) and holdout["num_outliers_capped"] >= 0


def test_denormalizer_equals_jax_with_a_fitted_normalizer(built):
    _, _, theirs = built
    meta = GraphMeta.from_dict(json.loads(json.dumps(theirs.meta.to_dict())))
    frame = pd.DataFrame({
        "lab_id": [51000, 51001, 51002, 99999], "center": [1.5, -2.0, 4.0, 0.0],
        "scale": [2.0, 0.0, 0.5, 1.0], "method": ["minmax"] * 4,
    })
    table = {k: frame[k].to_numpy() for k in frame.columns}
    for method in ("minmax", "zscore", "none"):
        frame["method"] = table["method"] = np.asarray([method] * 4)
        d_ours, d_theirs = Denormalizer(meta, table), JaxDenormalizer(theirs.meta, frame)
        for lab in range(theirs.graph.num_nodes("lab")):
            assert d_ours(lab, 0.75) == d_theirs(lab, 0.75)
    assert Denormalizer(meta)(3, 0.5) == JaxDenormalizer(theirs.meta)(3, 0.5)


# -- step 8: the serving artifact on JAX's checkpoint ------------------------------------

SERVING_FILES = {
    "weights.npz", "pairs_b256.pt2", "pairs_b4096.pt2", "serving.json", "coldstart.npz",
    "conformal.json", "conformal_cold.json",
}


def _copy_run(jax_ci_run, tmp_path, names):
    """The JAX run's config pointed at ``tmp_path`` with ``names`` of its
    output directory copied there."""
    out, jcfg = jax_ci_run
    cfg = Config.from_dict(jcfg.to_dict())
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, interim_dir=str(tmp_path / "interim"), output_dir=str(tmp_path / "out")),
        logging=dataclasses.replace(cfg.logging, log_file=str(tmp_path / "out" / "training.log")),
    )
    (tmp_path / "out").mkdir()
    for name in names:
        shutil.copy(out / "out" / name, tmp_path / "out" / name)
    return cfg


def test_step_8_serves_the_trained_checkpoint_as_jax(jax_ci_run, tmp_path):
    from multi_modal_gnn_tpu.serving import ServingModel as JaxServingModel
    from multi_modal_gnn_tpu_torch.serving import ServingModel

    out, jcfg = jax_ci_run
    cfg = _copy_run(jax_ci_run, tmp_path, ("graph.npz", "graph.meta.json", "best_model.ckpt", "best_model.ckpt.json"))
    path = save_config(cfg, tmp_path / "config.yaml")
    assert pipeline.main(["--config", str(path), "--no-confirm", "--device", "cpu", "--step", "8"]) == 0
    served_dir = tmp_path / "out" / "serving"
    assert {p.name for p in served_dir.iterdir()} == SERVING_FILES
    served = ServingModel.load(served_dir, device="cpu")

    opts = pipeline.RunOptions(device=CPU)
    trainer = pipeline._load_trainer(cfg, pipeline._load_bundle(cfg, opts), opts)
    test_p, test_l, _ = trainer.masker.split_arrays("test")
    want = trainer.predict_pairs(test_p, test_l)
    np.testing.assert_allclose(served.predict(test_p, test_l), want, rtol=1e-5, atol=1e-5)

    run_pipeline.step_export_serving(jcfg)  # JAX's step 8 on its own run
    theirs = JaxServingModel.load(out / "out" / "serving")
    np.testing.assert_allclose(served.predict(test_p, test_l), theirs.predict(test_p, test_l), rtol=1e-5, atol=1e-5)
    report = served.predict_patient(3, denormalize=True)
    want_report = theirs.predict_patient(3, denormalize=True)
    assert list(report) == list(want_report)
    np.testing.assert_allclose(list(report.values()), list(want_report.values()), rtol=1e-5, atol=1e-5)
    with np.load(served_dir / "coldstart.npz") as ours, np.load(out / "out" / "serving" / "coldstart.npz") as jax_z:
        assert ours.files == jax_z.files
        for key in jax_z.files:
            np.testing.assert_allclose(ours[key], jax_z[key], rtol=1e-10, atol=1e-10, err_msg=key)
    cold_ours = json.loads((served_dir / "conformal_cold.json").read_text())
    cold_theirs = json.loads((out / "out" / "serving" / "conformal_cold.json").read_text())
    assert cold_ours.pop("coverage_bounds") == cold_theirs.pop("coverage_bounds")
    assert cold_ours == pytest.approx(cold_theirs, rel=1e-10)
    # the graph model's radii: quantiles of its residuals, f32 predictions
    graph_ours = json.loads((served_dir / "conformal.json").read_text())
    graph_theirs = json.loads((out / "out" / "serving" / "conformal.json").read_text())
    assert graph_ours["cal_counts"] == graph_theirs["cal_counts"]
    np.testing.assert_allclose(graph_ours["q_lab"], graph_theirs["q_lab"], rtol=1e-5, atol=1e-5)
    lo_hi = served.predict(test_p, test_l, return_interval=True)
    np.testing.assert_allclose(lo_hi[1:], theirs.predict(test_p, test_l, return_interval=True)[1:], rtol=1e-5,
                               atol=1e-5)
    observed = {0: 0.4, 5: -1.2}
    cold, cold_jax = (m.predict_cold_start(observed, return_interval=True) for m in (served, theirs))
    assert list(cold) == list(cold_jax)
    for lab, want_lab in cold_jax.items():
        assert cold[lab]["predicted"] == pytest.approx(want_lab["predicted"], rel=1e-10)
        assert cold[lab]["interval"] == pytest.approx(want_lab["interval"], rel=1e-10)


def test_step_8_without_a_checkpoint_raises_as_jax(jax_ci_run, tmp_path):
    cfg = _copy_run(jax_ci_run, tmp_path, ("graph.npz", "graph.meta.json"))
    with pytest.raises(FileNotFoundError, match="No trained checkpoint at"):
        pipeline.step_export_serving(cfg, pipeline.RunOptions(device=CPU))
    jcfg = jax_ci_run[1]
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, output_dir=str(tmp_path / "out")))
    with pytest.raises(FileNotFoundError, match="No trained checkpoint at"):
        run_pipeline.step_export_serving(jcfg)


# -- the command line ------------------------------------------------------------------


def test_cli_runs_the_ported_steps_on_the_cpu(tmp_path):
    cfg = _ci_config(load_config, _data, tmp_path)
    path = save_config(cfg, tmp_path / "config.yaml")
    proc = subprocess.run(
        [sys.executable, "-m", "multi_modal_gnn_tpu_torch.pipeline", "--config", str(path),
         "--no-confirm", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env={**os.environ, **ONE_THREAD},
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    seconds = json.loads(proc.stdout.strip().splitlines()[-1])["step_seconds"]
    assert list(seconds) == [
        "preprocess", "build-graph", "train", "evaluate", "audit", "visualize", "inference", "export-serving",
    ]
    names = {p.name for p in (tmp_path / "out").iterdir()}
    assert {
        "graph.npz", "graph.meta.json", "best_model.ckpt", "training_history.json",
        "test_results.json", "evaluation_results.json", "per_lab_metrics.csv", "conformal.json",
        "audit_report.json", "inference_examples.json", "training.log", "serving",
        "graph_visualizations", "visualizations", "advanced_visualizations", "uncertainty_visualizations",
    } <= names
    assert (tmp_path / "out" / "advanced_visualizations" / "per_lab_calibration.csv").exists()
    assert SERVING_FILES <= {p.name for p in (tmp_path / "out" / "serving").iterdir()}
    results = json.loads((tmp_path / "out" / "evaluation_results.json").read_text())
    assert math.isfinite(results["overall_metrics"]["r2"])
    assert len(json.loads((tmp_path / "out" / "inference_examples.json").read_text())["examples"]) == 5
    assert not json.loads((tmp_path / "out" / "audit_report.json").read_text())[
        "masked_value_visibility"]["supervision_leak"]
    assert (tmp_path / "interim" / "cohort.npz").exists()


@pytest.mark.parametrize(
    "steps, names",
    [
        ("6", ["visualize"]),
        ("6-8", ["visualize", "inference", "export-serving"]),
        ("5-6", ["audit", "visualize"]),
        ("4-6", ["evaluate", "audit", "visualize"]),
        ("1-8", [step[0] for step in run_pipeline.STEPS]),
        ("6-7", ["visualize", "inference"]),
    ],
)
def test_cli_step_ranges_run_their_steps(steps, names, tmp_path, monkeypatch, capsys):
    """Each range runs exactly its steps, in order, step 6 among them."""
    ran = []
    monkeypatch.setattr(pipeline, "STEPS", [
        (name, desc, lambda config, opts, name=name: ran.append(name)) for name, desc, _ in pipeline.STEPS
    ])
    cfg = _ci_config(load_config, _data, tmp_path)
    path = save_config(cfg, tmp_path / "config.yaml")
    code = pipeline.main(["--config", str(path), "--no-confirm", "--device", "cpu", "--step", steps])
    assert code == 0 and ran == names
    assert list(json.loads(capsys.readouterr().out.strip().splitlines()[-1])["step_seconds"]) == names


def test_step_6_writes_the_files_of_jax_step_6(jax_ci_run, tmp_path):
    out, jcfg = jax_ci_run
    cfg = _copy_run(
        jax_ci_run, tmp_path,
        ("graph.npz", "graph.meta.json", "best_model.ckpt", "best_model.ckpt.json", "training_history.json"),
    )
    path = save_config(cfg, tmp_path / "config.yaml")
    with threadpool_limits(limits=1):  # t-SNE's OpenMP threads, as the module's torch threads
        assert pipeline.main(["--config", str(path), "--no-confirm", "--device", "cpu", "--step", "6"]) == 0
        run_pipeline.step_visualize(jcfg)  # JAX's step 6 on its own run
    families = ("graph_visualizations", "visualizations", "advanced_visualizations", "uncertainty_visualizations")
    for family in families:
        want = sorted(p.name for p in (out / "out" / family).iterdir())
        got = sorted(p.name for p in (tmp_path / "out" / family).iterdir())
        assert got == want and want, family
    assert (tmp_path / "out" / "visualizations" / "training_curves.png").exists()
    name = "advanced_visualizations/per_lab_calibration.csv"
    want = pd.read_csv(out / "out" / name)
    got = pd.read_csv(tmp_path / "out" / name)
    assert list(got.columns) == list(want.columns) and len(got) == len(want) > 0
    # rows by descending mae_delta: labs within the predictions' drift may swap
    assert got["mae_delta"].is_monotonic_decreasing
    got, want = got.sort_values("lab_index"), want.sort_values("lab_index")
    for col in ("lab_index", "lab_name", "num_samples"):
        assert got[col].tolist() == want[col].tolist(), col
    for col in ("slope", "intercept", "mae"):
        np.testing.assert_allclose(got[col], want[col], rtol=1e-4, atol=1e-4, err_msg=col)
    # the recalibration divides the predictions by the slope, so their drift
    # grows by 1 / |slope| on a lab whose predictions barely follow its targets
    scale = 1e-4 * (1.0 + want["mae_recalibrated"].abs()) / np.minimum(1.0, want["slope"].abs())
    for col in ("mae_recalibrated", "mae_delta"):
        assert ((got[col] - want[col]).abs() <= scale).all(), col


def test_cli_lists_the_steps(capsys):
    assert pipeline.main(["--list"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split()[1] for line in lines] == [step[0] for step in run_pipeline.STEPS]
    assert not any("not ported" in line for line in lines)


def test_cli_fails_when_a_step_fails(tmp_path):
    cfg = _ci_config(load_config, _data, tmp_path)
    path = save_config(cfg, tmp_path / "config.yaml")
    # build-graph without the preprocess step's tables
    assert pipeline.main(["--config", str(path), "--no-confirm", "--device", "cpu", "--step", "2"]) == 1


def test_cli_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.main(["--config", str(REPO / "conf/eicu_real.yaml"), "--no-confirm", "--step", "1"])


def test_flagship_seed_config_merges_extras(tmp_path):
    from multi_modal_gnn_tpu_torch.tools.flagship_band import seed_config

    cfg = seed_config(
        REPO / "conf/eicu_real.yaml", 43, tmp_path,
        model={"use_pallas": True, "extras": {"head_style": "factored"}}, train={"extras": {"auto_resume": True}},
    )
    flagship = load_config(REPO / "conf/eicu_real.yaml")
    assert cfg.train.seed == 43 and cfg.model.use_pallas
    assert cfg.train.extras == {**flagship.train.extras, "auto_resume": True}
    assert cfg.model.extras == {**flagship.model.extras, "head_style": "factored"}
    assert Path(cfg.data.output_dir).parent == tmp_path and Path(cfg.data.interim_dir).parent == tmp_path
    assert load_config(tmp_path / "config.yaml").to_dict() == cfg.to_dict()
    assert jax_load_config(tmp_path / "config.yaml").to_dict() == cfg.to_dict()


def test_masker_reads_the_slot_major_threshold_at_the_call(monkeypatch):
    import multi_modal_gnn_tpu_torch.training.masker as masker_mod

    cfg = Config.from_dict({"model": {"hidden_dim": 16, "use_pallas": True}})
    graph = make_synthetic_graph(SyntheticSpec.tiny(), cfg, device=CPU)
    before = masker_from_config(cfg, graph)
    assert before.slot_major_min_rows == masker_mod.SLOT_MAJOR_MIN_ROWS == 262_144
    assert not getattr(before.get_split("train").patient_plan, "identity", False)
    monkeypatch.setattr(masker_mod, "SLOT_MAJOR_MIN_ROWS", 0)
    assert masker_from_config(cfg, graph).get_split("train").patient_plan.identity
