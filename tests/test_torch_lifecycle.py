"""PyTorch port: the trainer's lifecycle against the JAX package, on the CPU.

* ``SyntheticSpec``'s presets equal the JAX ones field for field.
* The config reads the JAX ``evaluation`` and ``logging`` sections,
  ``Config.to_dict`` round-trips, and ``model_hash`` follows the model and
  graph sections only.
* The strict conformal "cal" split equals JAX ``masker_from_config``'s bit
  for bit.
* ``Trainer.train_epochs(k)`` equals k calls of ``train_epoch`` bit for bit
  (losses and parameters), and ``fit(scan_chunk=2)`` equals ``fit()``.
* A fit of 4 epochs equals a fit of 2, a checkpoint and a resume to 4, bit
  for bit: losses, history, parameters, Adam state.  ``restore`` refuses a
  differing ``model_hash`` unless ``force``.
* ``predict_pairs`` equals ``predict`` on the same pairs, and
  ``evaluation_pipeline`` evaluates the restored best state as
  ``evaluate_model`` does the trainer's.

The module runs torch on one CPU thread: with several, the CPU
``index_add_`` of the plain kernel versions sums in an order that changes
from call to call, and two unbroken runs already differ in the last bits.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.training.masker import masker_from_config as jax_masker_from_config
from multi_modal_gnn_tpu_torch.config import Config, ConfigError
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
from multi_modal_gnn_tpu_torch.models import build_model
from multi_modal_gnn_tpu_torch.training import EdgeMasker, Trainer, masker_from_config

SMALL = {"model": {"hidden_dim": 16, "use_pallas": True, "dropout": 0.2}}


def _config(**sections) -> Config:
    d = json.loads(json.dumps(SMALL))
    for name, values in sections.items():
        d.setdefault(name, {}).update(values)
    return Config.from_dict(d)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def graph():
    return make_synthetic_graph(SyntheticSpec.tiny(), _config(), device="cpu")


def _trainer(graph, config, masker=None, seed=0) -> Trainer:
    model = build_model(config, graph, device="cpu", generator=torch.Generator().manual_seed(seed))
    return Trainer(model, graph, masker or masker_from_config(config, graph), config, device="cpu")


def _assert_same_state(a: Trainer, b: Trainer):
    for (name, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), name
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], sb[key]), key


# -- specs and config ---------------------------------------------------------


@pytest.mark.parametrize("name", ["eicu_demo", "mimic_scale", "scale_100k", "tiny"])
def test_synthetic_presets_equal_jax(name):
    ours, theirs = getattr(SyntheticSpec, name)(), getattr(JaxSpec, name)()
    assert theirs.phenomenology == "flat"  # the only generator the port has
    for f in dataclasses.fields(SyntheticSpec):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


def test_config_reads_the_jax_evaluation_and_logging_sections():
    jcfg = JaxConfig()
    jcfg = jcfg.replace(
        evaluation=dataclasses.replace(
            jcfg.evaluation, baselines=("global_mean", "als"), winsorize_sigma=2.5,
            extras={"conformal_alpha": 0.2, "conformal_split_fraction": 0.3, "huber_delta": 1.5},
        ),
        logging=dataclasses.replace(jcfg.logging, checkpoint_interval=3, use_wandb=True),
        train=dataclasses.replace(jcfg.train, scan_chunk=4),
    )
    cfg = Config.from_dict(jcfg.to_dict())
    assert cfg.evaluation.baselines == ("global_mean", "als")
    assert cfg.evaluation.winsorize_sigma == 2.5
    assert cfg.evaluation.extras == {
        "conformal_alpha": 0.2, "conformal_split_fraction": 0.3, "huber_delta": 1.5,
    }
    assert (cfg.logging.checkpoint_interval, cfg.logging.save_checkpoints) == (3, True)
    assert cfg.train.scan_chunk == 4
    assert Config.from_dict(JaxConfig().to_dict()) == Config()


@pytest.mark.parametrize(
    "section",
    [
        {"evaluation": {"baselines": ["ceiling"]}},
        {"evaluation": {"extras": {"conformal_beta": 0.1}}},
        {"logging": {"flush_interval": 5}},
        {"train": {"scan_chunk": -1}},
    ],
)
def test_config_rejects_unknown_evaluation_and_logging_settings(section):
    with pytest.raises(ConfigError):
        Config.from_dict(section)


def test_config_round_trips_and_hashes():
    cfg = _config(
        train={"epochs": 7, "scan_chunk": 3, "extras": {"lab_tile_rows": 32}},
        evaluation={"baselines": ["global_mean"], "extras": {"conformal_alpha": 0.05}},
        logging={"checkpoint_interval": 2},
        model={"extras": {"head_style": "factored"}},
    )
    assert Config.from_dict(cfg.to_dict()) == cfg
    assert Config.from_dict(json.loads(json.dumps(cfg.to_dict()))) == cfg
    longer = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, epochs=70))
    wider = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, hidden_dim=32))
    assert longer.model_hash() == cfg.model_hash() and longer.content_hash() != cfg.content_hash()
    assert wider.model_hash() != cfg.model_hash()


# -- calibration split --------------------------------------------------------


@pytest.mark.parametrize("fraction", [0.0, 0.25, 0.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_calibration_split_equals_jax(fraction, seed):
    jcfg = JaxConfig()
    jcfg = jcfg.replace(
        train=dataclasses.replace(jcfg.train, seed=seed + 40),
        evaluation=dataclasses.replace(jcfg.evaluation, extras={"conformal_split_fraction": fraction}),
    )
    cfg = Config.from_dict(jcfg.to_dict())
    bundle = make_synthetic_bundle(JaxSpec.tiny(seed), jcfg)
    ours = masker_from_config(cfg, make_synthetic_graph(SyntheticSpec.tiny(seed), cfg, device="cpu"))
    theirs = jax_masker_from_config(jcfg, bundle)
    assert ours.has_calibration_split == theirs.has_calibration_split == (fraction > 0)
    assert ours.split_sizes() == theirs.split_sizes()
    for split in theirs.split_sizes():
        np.testing.assert_array_equal(ours.split_indices(split), theirs.split_indices(split))
        for a, b in zip(ours.split_arrays(split), theirs.split_arrays(split)):
            np.testing.assert_array_equal(a, b)


# -- back-to-back epochs ------------------------------------------------------


@pytest.mark.parametrize("layout", ["row_major", "slot_major"])
def test_train_epochs_equal_train_epoch_calls(graph, layout):
    cfg = _config(model={"extras": {"head_style": "factored"}})
    kw = dict(slot_major_train=True, slot_major_min_rows=0) if layout == "slot_major" else {}
    a = _trainer(graph, cfg, EdgeMasker(graph, seed=3, **kw))
    b = _trainer(graph, cfg, EdgeMasker(graph, seed=3, **kw))
    a.epoch = b.epoch = 5  # the streams are keyed by the epoch
    want, want_val = [], []
    for _ in range(3):
        want.append(a.train_epoch())
        want_val.append(a.validate("val"))
        a.epoch += 1
    got, got_val = b.train_epochs(3, with_val=True)
    assert b.epoch == a.epoch == 8
    assert got.dtype == np.float32 and got.tolist() == want and got_val.tolist() == want_val
    _assert_same_state(a, b)
    tl, vl = b.train_epochs(2, as_numpy=False)
    assert isinstance(tl, torch.Tensor) and tl.shape == (2,) and vl is None


def test_fit_in_chunks_equals_fit_by_epochs(graph, tmp_path):
    cfg = _config(train={"epochs": 5})
    a, b = _trainer(graph, cfg), _trainer(graph, cfg)
    ha = a.fit(output_dir=tmp_path / "a")
    hb = b.fit(output_dir=tmp_path / "b", scan_chunk=2)
    for key in ("train_loss", "val_loss", "learning_rates"):
        assert ha[key] == hb[key], key
    _assert_same_state(a, b)
    lines = (tmp_path / "b" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(ln)["step"] for ln in lines] == [1, 2, 3, 4, 5]


# -- checkpoints and resume ----------------------------------------------------


def test_resume_equals_the_unbroken_run(graph, tmp_path):
    log = {"checkpoint_interval": 2}
    full = _trainer(graph, _config(train={"epochs": 4}, logging=log))
    full.fit(output_dir=tmp_path / "full")
    first = _trainer(graph, _config(train={"epochs": 2}, logging=log))
    first.fit(output_dir=tmp_path / "broken")
    assert Trainer.latest_checkpoint(tmp_path / "broken").name == "checkpoint_epoch_2.ckpt"
    resumed = _trainer(graph, _config(train={"epochs": 4}, logging=log), seed=9)
    resumed.fit(output_dir=tmp_path / "broken", resume_from="auto")

    assert resumed.epoch == full.epoch == 4
    for key in ("train_loss", "val_loss", "learning_rates"):
        assert resumed.history[key] == full.history[key], key
    assert (resumed.best_val_loss, resumed.patience_counter) == (full.best_val_loss, full.patience_counter)
    assert resumed.scheduler.__dict__ == full.scheduler.__dict__
    _assert_same_state(resumed, full)
    for name, value in full.best_state.items():
        assert torch.equal(resumed.best_state[name], value), name
    for name in ("training_history.json", "best_model.ckpt", "checkpoint_epoch_4.ckpt"):
        assert (tmp_path / "broken" / name).read_bytes() != b""
    history = json.loads((tmp_path / "broken" / "training_history.json").read_text())
    assert history["train_loss"] == full.history["train_loss"]
    sidecar = json.loads((tmp_path / "full" / "checkpoint_epoch_4.ckpt.json").read_text())
    assert {
        "epoch", "best_val_loss", "patience_counter", "scheduler", "history",
        "config_hash", "model_hash", "config",
    } == set(sidecar)
    assert Config.from_dict(sidecar["config"]) == full.config


def test_restore_refuses_another_model_unless_forced(graph, tmp_path):
    cfg = _config(train={"epochs": 2})
    trainer = _trainer(graph, cfg)
    trainer.fit(output_dir=tmp_path)
    other = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, degree_threshold=3))
    assert other.model_hash() != cfg.model_hash()
    twin = _trainer(graph, other, seed=5)
    with pytest.raises(ValueError, match="incompatible config"):
        twin.restore(tmp_path / "best_model.ckpt")
    twin.restore(tmp_path / "best_model.ckpt", force=True)
    _assert_same_state(twin, trainer)
    fresh = _trainer(graph, cfg, seed=5)
    fresh.load_best_model(tmp_path)
    assert fresh.validate("test", fresh.best_state) == trainer.validate("test", trainer.best_state)


def test_predict_pairs_equals_predict(graph):
    trainer = _trainer(graph, _config(train={"epochs": 1}))
    trainer.fit()
    p, l, _ = trainer.masker.split_arrays("test")
    np.testing.assert_allclose(trainer.predict_pairs(p, l, pad_multiple=64), trainer.predict("test"), atol=1e-6)
    best = trainer.predict_pairs(p[:5], l[:5], state=trainer.best_state)
    np.testing.assert_allclose(best, trainer.predict("test", trainer.best_state)[:5], atol=1e-6)


def test_evaluation_pipeline_restores_and_evaluates_the_best_state(graph, tmp_path):
    from multi_modal_gnn_tpu_torch.evaluation import evaluate_model, evaluation_pipeline

    cfg = _config(train={"epochs": 3}, evaluation={"baselines": ["global_mean", "per_lab_mean"]})
    trainer = _trainer(graph, cfg)
    trainer.fit(output_dir=tmp_path / "run")
    want = evaluate_model(trainer, graph, cfg)
    got = evaluation_pipeline(cfg, graph, tmp_path / "run" / "best_model.ckpt", tmp_path / "eval", device="cpu")
    assert got["overall_metrics"] == want["overall_metrics"]
    assert json.dumps(got["conformal"], sort_keys=True) == json.dumps(want["conformal"], sort_keys=True)
    assert {p.name for p in (tmp_path / "eval").iterdir()} == {
        "evaluation_results.json", "per_lab_metrics.csv", "conformal.json",
    }
