"""PyTorch port: the 2-D layout (``parallel/dp2d.py``, ``parallel: 2d``)
against the JAX package's ``TwoDTrainer``, on the CPU.

The port runs 4 gloo ranks as a ``2 x 2`` mesh (data x model), spawned once
for the file (``torch_dp_ranks.two_d_checks``); JAX runs its ``TwoDTrainer``
on ``make_2d_mesh(4, 2)`` over 4 of the suite's virtual CPU devices, its
per-shard segment kernel in interpret mode.  Both start from the same
parameters (bridged by ``models/convert.py``) and take the same injected
supervision masks, with dropout 0, on ``SyntheticSpec.tiny(seed=5)`` at
hidden 32:

* 3 steps of the RGCN on K1's per-shard plans, of the RGCN with the value
  context and of the HGT: losses, validation and test predictions against
  JAX within its own 2-D bound (``rtol 2e-4, atol 1e-5``,
  ``tests/test_parallel.py``), and against the port's one process within
  the 1-D DP tests' bounds; after the first step each rank's table rows and Adam
  moments are that rank's rows of the one process's (a reduce-scatter of
  the table's gradient over the model axis would double them); every
  replicated parameter, buffer and moment bit-equal across the model axis
  after steps with dropout 0.2;
* the sharded checkpoint both ways: the port's ``2 x 2`` files through
  JAX's ``load_checkpoint_sharded`` into a one-device JAX ``Trainer``; a
  JAX ``TwoDTrainer`` checkpoint into the port's ``2 x 2``, a ``1 x 2``
  sub-mesh and one process (JAX's elastic test); each validation within
  ``rtol 1e-5`` of the source's;
* the warm start's ``best_val_loss`` against one process's plant (JAX's
  ``test_warm_start_composes_with_table_sharding`` bound);
* serving straight from a DP trainer (4 ranks) and a 2-D trainer after 3
  epochs against the single trainer (JAX ``test_serving.py``'s bound), and
  the DP trainer's exported artifact;
* ``train_pipeline`` routing ``parallel: 2d``; the refusals with JAX's
  texts.
"""

import dataclasses
import tempfile
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks
from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.parallel import dp2d as jax_dp2d
from multi_modal_gnn_tpu.parallel.mesh import make_2d_mesh
from multi_modal_gnn_tpu.training.checkpoint import load_checkpoint_sharded, save_checkpoint_sharded
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxMasker
from multi_modal_gnn_tpu.training.trainer import Trainer as JaxTrainer
from multi_modal_gnn_tpu_torch.config import Config, ConfigError
from multi_modal_gnn_tpu_torch.parallel.dp2d import TwoDTrainer
from multi_modal_gnn_tpu_torch.parallel.launch import Ranks
from multi_modal_gnn_tpu_torch.parallel.mesh import DataAxis, Mesh2D, init_2d_axes
from multi_modal_gnn_tpu_torch.serving import ServingModel, build_trainer_serving_fn
from multi_modal_gnn_tpu_torch.training import EdgeMasker, Trainer
from multi_modal_gnn_tpu_torch.training.warmstart import warm_start_trainer
from test_torch_value_context import flax_variables

SPEC = dataclasses.asdict(JaxSpec.tiny(seed=5))
CASES = {  # name: (model settings, per-shard K1 plans)
    "rgcn_plans": ({"use_pallas": True}, True),
    "vctx": ({"value_context": True}, False),
    "hgt": ({"architecture": "HGT"}, False),
    "rgcn_sgd_plans": ({"use_pallas": True}, True),  # SGD: the momentum buffer's rows cut as the table's
}
SECTIONS = {"rgcn_sgd_plans": {"optimizer": {"type": "sgd", "lr": 0.05, "momentum": 0.9}}}  # train section
SEED = 42
STEPS = 3
JAX_RTOL, JAX_ATOL = 2e-4, 1e-5  # tests/test_parallel.py, TestTwoDShardMap
DP_RTOL, DP_PLANS_RTOL = 2e-4, 1e-3  # tests/test_torch_parallel.py
STATE_RTOL, STATE_ATOL = 5e-4, 4e-4
CKPT_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config_dict(**model):
    d = JaxConfig().to_dict()
    d["model"].update(hidden_dim=32, dropout=0.0, **model)
    d["train"].update(donate_state=False)
    return d


def _case_dict(name):
    d = _config_dict(**CASES[name][0])
    for key, fields in SECTIONS.get(name, {}).items():
        d["train"][key].update(fields)
    return d


def _warm_dict():
    d = _config_dict()
    d["model"]["edge_head"].update(bilinear_rank=5, bilinear_source="embedding")
    return d


def _single(d, state):
    cfg = Config.from_dict(d)
    bundle = torch_dp_ranks.port_bundle(SPEC, d)
    model = torch_dp_ranks.model_with(cfg, bundle.graph, state)
    return Trainer(model, bundle.graph, EdgeMasker(bundle.graph, seed=SEED), cfg, device="cpu"), bundle


def _jax_parts(d):
    jcfg = JaxConfig.from_dict(d)
    jbundle = make_synthetic_bundle(JaxSpec(**SPEC), jcfg)
    return jcfg, jbundle, JaxMasker(jbundle.graph, seed=SEED, host_edges=jbundle.patient_lab_host())


def _jax_two_d(d, plans, variables):
    """JAX's TwoDTrainer on a (2 data x 2 model) mesh from ``variables``."""
    jcfg, jbundle, masker = _jax_parts(d)
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), variables)
    with mock.patch.object(jax_dp2d, "init_model_variables", lambda *a: variables):
        return jax_dp2d.TwoDTrainer(
            jbundle.graph, masker, jcfg, mesh=make_2d_mesh(4, 2), host_edges=jbundle.host_edges if plans else None
        )


@pytest.fixture(scope="module")
def runs():
    """The port's 4 ranks, started first; meanwhile JAX's 2-D checkpoint
    (which the ranks wait for), JAX's injected steps and the port's one
    process in this process."""
    tmp = tempfile.TemporaryDirectory(prefix="torch_dp2d_")
    root = Path(tmp.name)
    rng = np.random.default_rng(0)
    states, masks_of = {}, {}
    job = {
        "spec": SPEC, "seed": SEED, "cases": {}, "checkpoint_case": "rgcn_plans",
        "port_ckpt": str(root / "port2d.ckpt"), "jax_ckpt": str(root / "jax2d.ckpt"),
        "jax_ckpt_done": str(root / "jax2d.done"), "export_dir": str(root / "serve_dp"),
    }
    for name, (model, plans) in CASES.items():
        d = _case_dict(name)
        bundle = torch_dp_ranks.port_bundle(SPEC, d)
        init = torch_dp_ranks.build_model(
            Config.from_dict(d), bundle.graph, device="cpu", generator=torch.Generator().manual_seed(1)
        )
        states[name] = torch_dp_ranks.numpy_state(init)
        valid = EdgeMasker(bundle.graph, seed=SEED).get_split("train").valid.numpy()
        masks_of[name] = [((rng.random(valid.shape[0]) < 0.3) * valid).astype(np.float32) for _ in range(STEPS)]
        job["cases"][name] = dict(config=d, state=states[name], masks=masks_of[name], plans=plans)
    drop = _config_dict(use_pallas=True)
    drop["model"]["dropout"] = 0.2
    job["dropout"] = dict(config=drop, state=states["rgcn_plans"], masks=masks_of["rgcn_plans"], plans=True)
    job["restore"] = dict(config=_config_dict())
    bundle = torch_dp_ranks.port_bundle(SPEC, _config_dict())
    warm_state = torch_dp_ranks.numpy_state(torch_dp_ranks.build_model(
        Config.from_dict(_warm_dict()), bundle.graph, device="cpu", generator=torch.Generator().manual_seed(3)))
    job["warm"] = dict(config=_warm_dict(), state=warm_state)
    p_idx = rng.integers(0, bundle.graph.num_nodes("patient"), 64)
    l_idx = rng.integers(0, bundle.graph.num_nodes("lab"), 64)
    job["serving"] = dict(config=_config_dict(), state=states["rgcn_plans"], pairs=(p_idx, l_idx))
    pipe = _config_dict(use_pallas=True)
    pipe["train"].update(epochs=2, extras={"parallel": "2d", "model_parallel": 2})
    job["pipeline"] = dict(config=pipe, out=str(root / "pipeline"))
    ranks = Ranks(torch_dp_ranks.two_d_checks, 4, (job,))

    # JAX's (4 data x 2 model) checkpoint after one epoch, for the ranks
    jcfg, jbundle, masker = _jax_parts(_config_dict())
    big = jax_dp2d.TwoDTrainer(jbundle.graph, masker, jcfg, mesh=make_2d_mesh(4, 2))
    big.train_epoch()
    big.epoch += 1
    jax_ckpt_val = big.validate("val")
    save_checkpoint_sharded(job["jax_ckpt"], big._checkpoint_payload(), big._host_metadata())
    Path(job["jax_ckpt_done"]).touch()

    jax_out, single = {}, {}
    for name, (model, plans) in CASES.items():
        d = _case_dict(name)
        trainer, _ = _single(d, states[name])
        jt = _jax_two_d(d, plans, flax_variables(trainer.model))
        batch = jt._get_batch("train")
        losses = []
        for mask in masks_of[name]:
            jt.state, loss = jt._train_step(jt.state, jt.graph, batch, jt.lab_weights, jnp.asarray(mask), jax.random.key(0))
            losses.append(float(loss))
        jax_out[name] = {"losses": losses, "val": jt.validate("val"), "test_preds": np.asarray(jt.predict("test"))}
        tb = trainer.get_batch("train")
        losses = []
        for i, mask in enumerate(masks_of[name]):
            losses.append(trainer.train_step(tb, torch.from_numpy(mask), 0))
            if i == 0:
                first = torch_dp_ranks.table_state(trainer)
        single[name] = {"losses": losses, "val": trainer.validate("val"), "test_preds": trainer.predict("test"),
                        "state": torch_dp_ranks.numpy_state(trainer.model), "first": first}

    # the warm start's one-process plant; serving's single trainer
    trainer, _ = _single(_warm_dict(), warm_state)
    warm_start_trainer(trainer, rank=4, reg=3.0)
    warm_val = trainer.best_val_loss
    trainer, _ = _single(_config_dict(), states["rgcn_plans"])
    for _ in range(3):
        trainer.train_epoch()
        trainer.epoch += 1
    fn, _ = build_trainer_serving_fn(trainer)
    served = fn(p_idx, l_idx).numpy()

    outs = ranks.join(600)
    yield dict(ranks=outs, jax=jax_out, single=single, job=job, jax_ckpt_val=jax_ckpt_val, warm_val=warm_val,
               served=served, root=root)
    tmp.cleanup()


# -- steps -------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_2d_steps_match_jax(runs, name):
    want = runs["jax"][name]
    for rank in runs["ranks"]:
        port = rank["cases"][name]
        assert port["shard_plans"] == CASES[name][1]
        np.testing.assert_allclose(port["losses"], want["losses"], rtol=JAX_RTOL, atol=JAX_ATOL)
        np.testing.assert_allclose(port["val"], want["val"], rtol=JAX_RTOL, atol=JAX_ATOL)
        np.testing.assert_allclose(port["test_preds"], want["test_preds"], rtol=JAX_RTOL, atol=JAX_ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_2d_steps_match_one_process(runs, name):
    rtol = DP_PLANS_RTOL if CASES[name][1] else DP_RTOL
    want = runs["single"][name]
    for rank in runs["ranks"]:
        port = rank["cases"][name]
        np.testing.assert_allclose(port["losses"], want["losses"], rtol=rtol)
        np.testing.assert_allclose(port["val"], want["val"], rtol=rtol)
        lo, hi = port["first"]["rows"]
        for key, value in want["state"].items():
            got = port["state"][key]
            if key == "embed_patient.weight":
                value = value[lo:hi]
            if not key.endswith("num_batches_tracked"):
                np.testing.assert_allclose(got, value, rtol=STATE_RTOL, atol=STATE_ATOL, err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_table_rows_and_moments_after_one_step(runs, name):
    """Each rank's rows of the table and of its optimizer state (both Adam
    moments, SGD's momentum buffer) after the first step are its rows of
    the one process's: the table gather's backward is a slice (a
    reduce-scatter over the model axis would double the gradient, and so
    the first moment)."""
    want = runs["single"][name]["first"]
    rows = set()
    for rank in runs["ranks"]:
        got = rank["cases"][name]["first"]
        lo, hi = got["rows"]
        assert (lo, hi) == (rank["model"] * (hi - lo), (rank["model"] + 1) * (hi - lo))
        rows.add((lo, hi))
        assert got.keys() - {"rows"} == want.keys() - {"rows"}
        for key in want.keys() - {"rows"}:
            assert got[key].shape[0] == want[key].shape[0] // 2
            np.testing.assert_allclose(got[key], want[key][lo:hi], rtol=STATE_RTOL, atol=STATE_ATOL, err_msg=key)
    assert len(rows) == 2


def test_collectives_of_a_step(runs):
    """One table gather a forward over the model axis, no reduce-scatter."""
    for rank in runs["ranks"]:
        stats = rank["cases"]["rgcn_plans"]["stats"]
        assert stats["table_gather"]["calls"] == 1, stats
        assert not any("scatter" in k for k in stats)


def test_model_axis_replicas_are_bit_equal(runs):
    """After 3 steps with dropout 0.2 every replicated parameter, buffer and
    Adam moment is bit-equal across the model axis (and across the data
    axis: every rank takes one Adam step); the table rows differ by rank."""
    by_rank = {(r["data"], r["model"]): r["dropout"] for r in runs["ranks"]}
    for d in (0, 1):
        a, b = by_rank[(d, 0)], by_rank[(d, 1)]
        for key, value in a["state"].items():
            if key != "embed_patient.weight":
                np.testing.assert_array_equal(value, b["state"][key], err_msg=key)
                np.testing.assert_array_equal(value, by_rank[(1 - d, 0)]["state"][key], err_msg=key)
        for name, moments in a["adam"].items():
            if name != "embed_patient.weight":
                for k, v in moments.items():
                    np.testing.assert_array_equal(v, b["adam"][name][k], err_msg=f"{name} {k}")
    # the same data shard's model ranks drew the same dropout: their table
    # rows together are one update of one table
    np.testing.assert_array_equal(by_rank[(0, 0)]["state"]["embed_patient.weight"],
                                  by_rank[(1, 0)]["state"]["embed_patient.weight"])


# -- checkpoints -------------------------------------------------------------


def test_port_checkpoint_loads_in_jax(runs):
    """The port's 2 x 2 file set through JAX's ``load_checkpoint_sharded``
    into a one-device JAX ``Trainer``: its validation is the port's."""
    path = Path(runs["job"]["port_ckpt"])
    files = sorted(p.name for p in path.parent.glob(f"{path.name}.proc*.npz"))
    assert files == [f"port2d.ckpt.proc{r:03d}.npz" for r in range(4)] and not path.exists()
    # ranks (0, k) hold their table rows, rank 0 every replicated leaf
    with np.load(path.parent / files[3]) as z:
        assert not z.files
    with np.load(path.parent / files[1]) as z:
        assert z.files and all(k.split("||")[1].startswith("60:120") for k in z.files)
    # the one-device JAX twin (its plain tier: the parameters are the same)
    jcfg, jbundle, masker = _jax_parts(_config_dict())
    jt = JaxTrainer(jax_build_model(jcfg, jbundle.graph), jbundle.graph, masker, jcfg)
    restored, meta = load_checkpoint_sharded(path, jt._checkpoint_payload())
    assert meta["sharded_checkpoint"]["num_processes"] == 4 and meta["epoch"] == STEPS
    jt.state, jt.best_state = restored["state"], restored["best_state"]
    assert int(jt.state.step) == STEPS
    np.testing.assert_allclose(jt.validate("val"), runs["ranks"][0]["ckpt_val"], rtol=CKPT_RTOL)
    # and into one port process
    trainer, _ = _single(_config_dict(use_pallas=True), runs["job"]["cases"]["rgcn_plans"]["state"])
    trainer.restore(path)
    assert trainer.epoch == STEPS
    np.testing.assert_allclose(trainer.validate("val"), runs["ranks"][0]["ckpt_val"], rtol=CKPT_RTOL)


@pytest.mark.parametrize("target", ["2x2", "1x2", "one_process"])
def test_jax_2d_checkpoint_restores_elastically(runs, target):
    """A JAX TwoDTrainer checkpoint of a (4 data x 2 model) mesh restores
    into the port's 2 x 2, a 1 x 2 and one process (JAX's elastic test)."""
    want = runs["jax_ckpt_val"]
    if target == "one_process":
        trainer, _ = _single(_config_dict(), runs["job"]["cases"]["rgcn_plans"]["state"])
        trainer.restore(runs["job"]["jax_ckpt"])
        np.testing.assert_allclose(trainer.validate("val"), want, rtol=CKPT_RTOL)
        return
    for rank in runs["ranks"]:
        got = rank["restored"][target]
        assert got["epoch"] == 1 and got["rows"] == (rank["model"] * 60, rank["model"] * 60 + 60)
        np.testing.assert_allclose(got["val"], want, rtol=CKPT_RTOL)


# -- the warm start, serving, the route -----------------------------------------


def test_2d_warm_start_matches_one_process(runs):
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["warm_val"], runs["warm_val"], rtol=2e-5, atol=2e-5)
        assert rank["warm_step"] == 0  # a fresh Adam state


@pytest.mark.parametrize("label", ["dp", "2d"])
def test_serving_from_parallel_trainers(runs, label):
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["served"][label], runs["served"], rtol=1e-3, atol=1e-4)


def test_dp_export_round_trips(runs):
    served = ServingModel.load(runs["job"]["export_dir"], device="cpu")
    p_idx, l_idx = runs["job"]["serving"]["pairs"]
    np.testing.assert_allclose(served.predict(p_idx, l_idx), runs["served"], rtol=1e-3, atol=1e-4)


def test_train_pipeline_routes_2d(runs):
    out = Path(runs["job"]["pipeline"]["out"])
    for rank in runs["ranks"]:
        got = rank["pipeline"]
        assert got["type"] == "TwoDTrainer" and got["shard_plans"] and np.isfinite(got["test_loss"])
        assert got["table_rows"] == got["moments"] == 60
    assert (out / "test_results.json").exists() and (out / "best_model.ckpt.json").exists()
    assert len(list(out.glob("best_model.ckpt.proc*.npz"))) == 4


# -- refusals, with JAX's texts ------------------------------------------------


def test_indivisible_patient_count_is_refused():
    d = _config_dict()
    bundle = torch_dp_ranks.port_bundle(SPEC, d)
    mesh = Mesh2D(DataAxis(), DataAxis(0, 7), DataAxis())
    with pytest.raises(ValueError, match="patient count 120 not divisible by model axis 7"):
        TwoDTrainer(bundle.graph, EdgeMasker(bundle.graph, seed=SEED), Config.from_dict(d), mesh=mesh, device="cpu")


def test_indivisible_rank_count_is_refused(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="3 devices not divisible by model_parallel=2"):
        init_2d_axes(torch.device("cpu"), 0, 2)


def test_clusters_with_2d_are_refused(tmp_path):
    from multi_modal_gnn_tpu_torch.training.trainer import train_pipeline

    d = _config_dict()
    d["train"].update(epochs=1, extras={"parallel": "2d", "num_clusters": 2})
    with pytest.raises(ValueError, match="composes with train.extras.parallel: dp only"):
        train_pipeline(Config.from_dict(d), torch_dp_ranks.port_bundle(SPEC, d), tmp_path, device="cpu")


def test_gspmd_names_item_8c():
    with pytest.raises(ConfigError, match="item 8c"):
        Config.from_dict({"train": {"extras": {"parallel": "gspmd", "model_parallel": 2}}})


def test_2d_on_one_rank(tmp_path):
    """``parallel: 2d`` with ``model_parallel: 1`` and ``WORLD_SIZE`` unset
    trains on one rank (JAX's one-device mesh) and writes the sharded
    format's one file."""
    from multi_modal_gnn_tpu_torch.training.trainer import train_pipeline

    d = _config_dict(use_pallas=True)
    d["train"].update(epochs=2, extras={"parallel": "2d", "model_parallel": 1})
    trainer, results = train_pipeline(Config.from_dict(d), torch_dp_ranks.port_bundle(SPEC, d), tmp_path, device="cpu")
    assert type(trainer).__name__ == "TwoDTrainer" and trainer.world.size == 1 and np.isfinite(results["test_loss"])
    assert (tmp_path / "best_model.ckpt.proc000.npz").exists() and not (tmp_path / "best_model.ckpt").exists()


def test_dryrun_2d_over_four_ranks(capsys):
    import json

    from multi_modal_gnn_tpu_torch.tools import dryrun_dp

    assert dryrun_dp.main(["--ranks", "4", "--parallel", "2d", "--device", "cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(lines) == 2 and [line["use_pallas"] for line in lines] == [False, True]
    for line in lines:
        assert (line["parallel"], line["ranks"], line["model_parallel"]) == ("2d", 4, 2)
        assert line["collectives_per_step"]["table_gather"]["calls"] == 1
        assert len(line["step_ms_per_rank"]) == 4 and all(ms > 0 for ms in line["step_ms_per_rank"])
