"""PyTorch port: ``train.optimizer.type: sgd`` against the JAX package, on
the CPU, and one pipeline run of a one-way, diagnosis-disabled SGD config.

JAX's chain is ``add_decayed_weights -> masked embedding decay -> sgd(lr,
momentum)`` under ``inject_hyperparams``; the port's is ``torch.optim.SGD``
with the same two parameter groups (coupled decay, then ``trace``, which is
torch's momentum buffer with no dampening).  On a 300-patient cohort
(hidden 32, dropout 0, ``use_pallas: true``, weights carried across from
JAX), both packages take the same injected supervision masks:

* 3 steps with momentum 0.9 and momentum 0 (where optax keeps a ``trace``
  and torch keeps no buffer), weight decay and ``embedding_weight_decay``:
  losses ``rtol 1e-6``, parameters ``atol 1e-6`` (SGD is linear in the
  gradients, so f32 sums in another order stay at their own size, 1.2e-7
  measured);
* a JAX checkpoint after those steps, plain (flax msgpack) and sharded
  (``.procNNN.npz``), resumed by the port: the momentum buffers equal JAX's
  ``trace`` and one more step matches JAX's at the same bounds; the port's
  own checkpoint keeps its buffers and update counts; the port's sharded
  file restores into JAX;
* ``python -m multi_modal_gnn_tpu_torch.pipeline`` steps 1-8 (2 epochs) on
  a one-way, diagnosis-disabled SGD config; step 6 leaves the absent
  modality out of the graph figures (JAX's raises ``KeyError`` there).
"""

import dataclasses
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.graph.build import assemble_graph as jax_assemble
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.models.factory import init_model_variables
from multi_modal_gnn_tpu.training.checkpoint import load_checkpoint_sharded, save_checkpoint_sharded
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxEdgeMasker
from multi_modal_gnn_tpu.training.trainer import Trainer as JaxTrainer
from multi_modal_gnn_tpu_torch import pipeline
from multi_modal_gnn_tpu_torch.config import Config, load_config, save_config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_edges
from multi_modal_gnn_tpu_torch.graph.build import assemble_graph
from multi_modal_gnn_tpu_torch.graph.schema import PATIENT_LAB, PATIENT_MEDICATION
from multi_modal_gnn_tpu_torch.graph.serialize import load_bundle
from multi_modal_gnn_tpu_torch.models import build_model, state_dict_from_flax
from multi_modal_gnn_tpu_torch.training import EdgeMasker, Trainer
from multi_modal_gnn_tpu_torch.training.checkpoint import (
    jax_state_leaves,
    optimizer_state_by_name,
    save_sharded_checkpoint,
)

REPO = Path(__file__).resolve().parent.parent
SPEC = SyntheticSpec(
    num_patients=300, num_labs=30, num_diagnoses=20, num_medications=15,
    mean_labs_per_patient=8.0, latent_dim=4, seed=1,
)
STEPS = 3
TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config_dict(momentum):
    d = JaxConfig().to_dict()
    d["graph"]["dense_adjacency_max_bytes"] = 0
    d["model"].update(hidden_dim=32, dropout=0.0, use_pallas=True, head_style="factored")
    d["train"]["optimizer"].update(type="sgd", lr=0.05, momentum=momentum, weight_decay=1e-3,
                                   embedding_weight_decay=1e-2)
    d["train"].update(donate_state=False)
    return d


def _masks(batch, seed):
    rng = np.random.default_rng(seed)
    return [(rng.random(batch.valid.shape[0]) < 0.4).astype(np.float32) * batch.valid.numpy() for _ in range(STEPS + 1)]


def _pair(d, variables):
    """The JAX and the port trainers on one cohort and one set of weights."""
    edge_arrays, node_counts = generate_synthetic_edges(SPEC)
    jcfg, cfg = JaxConfig.from_dict(d), Config.from_dict(d)
    jgraph, graph = jax_assemble(edge_arrays, node_counts, config=jcfg), assemble_graph(edge_arrays, node_counts, cfg)
    if variables is None:
        variables = init_model_variables(jax_build_model(jcfg, jgraph), jgraph, jax.random.PRNGKey(0))
    jt = JaxTrainer(jax_build_model(jcfg, jgraph), jgraph, JaxEdgeMasker(jgraph, seed=4), jcfg, variables=variables)
    model = build_model(cfg, graph, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jt, Trainer(model, graph, EdgeMasker(graph, seed=4), cfg, device="cpu"), variables


def _jax_step(jt, mask):
    state, loss = jt._train_step(
        jax.tree_util.tree_map(jnp.array, jt.state), jt.graph, jt._get_batch("train"), jt.lab_weights,
        jnp.asarray(mask), jax.random.key(7),
    )
    jt.state = jax.block_until_ready(state)
    return float(loss)


def _assert_params_close(model, jstate, atol=TOL):
    want = state_dict_from_flax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    got = model.state_dict()
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), atol=atol, err_msg=key)


def _trace(jstate):
    """JAX's SGD ``trace`` as the port's per-name momentum buffers."""
    trace = jstate.opt_state.inner_state[-1][0].trace
    return {k: v for k, v in state_dict_from_flax({"params": trace}).items() if not k.endswith("num_batches_tracked")}


@pytest.fixture(scope="module", params=[0.9, 0.0], ids=["momentum", "no_momentum"])
def stepped(request):
    """Both trainers after ``STEPS`` SGD steps on the same masks."""
    d = _config_dict(request.param)
    jt, trainer, variables = _pair(d, None)
    assert type(trainer.optimizer).__name__ == "SGD" and trainer.optimizer.defaults["momentum"] == request.param
    masks = _masks(trainer.get_batch("train"), 0)
    losses = []
    for mask in masks[:STEPS]:
        jloss = _jax_step(jt, mask)
        losses.append((trainer.train_step(trainer.get_batch("train"), torch.from_numpy(mask), 0), jloss))
    return dict(d=d, jt=jt, trainer=trainer, variables=variables, masks=masks, losses=losses)


def test_sgd_steps_match_jax(stepped):
    for loss, jloss in stepped["losses"]:
        np.testing.assert_allclose(loss, jloss, rtol=TOL)
    _assert_params_close(stepped["trainer"].model, stepped["jt"].state)
    named = optimizer_state_by_name(stepped["trainer"].model, stepped["trainer"].optimizer)
    assert {float(v["step"]) for v in named.values()} == {STEPS} == {int(stepped["jt"].state.step)}
    if stepped["d"]["train"]["optimizer"]["momentum"]:
        for key, value in _trace(stepped["jt"].state).items():
            np.testing.assert_allclose(named[key]["momentum_buffer"].numpy(), value.numpy(), atol=TOL, err_msg=key)
    else:  # optax keeps a trace at momentum 0 (the last update), torch keeps no buffer
        assert not any("momentum_buffer" in v for v in named.values())


@pytest.mark.parametrize("layout", ["plain", "sharded"])
def test_jax_sgd_checkpoint_resumes_in_the_port(stepped, tmp_path, layout):
    jt = stepped["jt"]
    path = tmp_path / "jax.ckpt"
    if layout == "plain":
        jt._save(path)
    else:
        save_checkpoint_sharded(path, jt._checkpoint_payload(), jt._host_metadata())
        assert not path.exists()
    _, trainer, _ = _pair(stepped["d"], stepped["variables"])
    trainer.restore(path)
    _assert_params_close(trainer.model, jt.state, atol=0.0)
    named = optimizer_state_by_name(trainer.model, trainer.optimizer)
    assert {float(v["step"]) for v in named.values()} == {STEPS}
    if stepped["d"]["train"]["optimizer"]["momentum"]:
        for key, value in _trace(jt.state).items():
            assert torch.equal(named[key]["momentum_buffer"], value), key
    # one more step on both, from the restored state
    twin, _, _ = _pair(stepped["d"], stepped["variables"])
    twin.state = jt.state
    mask = stepped["masks"][STEPS]
    jloss = _jax_step(twin, mask)
    np.testing.assert_allclose(trainer.train_step(trainer.get_batch("train"), torch.from_numpy(mask), 0), jloss, rtol=TOL)
    _assert_params_close(trainer.model, twin.state)


def test_port_sgd_checkpoints_keep_the_buffers(stepped, tmp_path):
    """The port's own checkpoint, and its sharded file read by JAX."""
    trainer = stepped["trainer"]
    trainer._save(tmp_path / "port.ckpt")
    _, twin, _ = _pair(stepped["d"], stepped["variables"])
    twin.restore(tmp_path / "port.ckpt")
    want = optimizer_state_by_name(trainer.model, trainer.optimizer)
    got = optimizer_state_by_name(twin.model, twin.optimizer)
    assert got.keys() == want.keys()
    for key, entry in want.items():
        assert got[key].keys() == entry.keys()
        for k, v in entry.items():
            assert torch.equal(got[key][k], v), (key, k)

    state = trainer.model.state_dict()
    leaves = jax_state_leaves(trainer.model, state, want, trainer.optimizer.param_groups[0]["lr"], "sgd") * 2
    save_sharded_checkpoint(tmp_path / "sharded.ckpt", leaves, trainer._host_metadata(), 0, 1)
    restored, meta = load_checkpoint_sharded(tmp_path / "sharded.ckpt", stepped["jt"]._checkpoint_payload())
    assert int(restored["state"].step) == STEPS and meta["epoch"] == trainer.epoch
    _assert_params_close(trainer.model, restored["state"], atol=0.0)
    momentum = stepped["d"]["train"]["optimizer"]["momentum"]
    for key, value in _trace(restored["state"]).items():  # zeros where torch keeps no buffer
        expect = want[key]["momentum_buffer"] if momentum else torch.zeros_like(value)
        assert torch.equal(value, expect), key


def test_pipeline_runs_a_one_way_sgd_config(tmp_path):
    """Steps 1-8 on the CI cohort (400 patients), one-way, diagnosis off,
    SGD, 2 epochs, on the CPU; step 6 draws the graph family without the
    diagnosis modality."""
    cfg = load_config(REPO / "conf/eicu_real.yaml")
    edge_types = {n: dataclasses.replace(e, bidirectional=False) for n, e in cfg.graph.edge_types.items()}
    edge_types["patient_diagnosis"] = dataclasses.replace(edge_types["patient_diagnosis"], enabled=False)
    viz = dataclasses.replace(
        cfg.visualization, generate_embeddings=False, generate_parity_plots=False, num_example_subgraphs=1,
        missingness_heatmap=False, plot_degree_distribution=False,
    )
    cfg = cfg.replace(
        data=dataclasses.replace(
            cfg.data, interim_dir=str(tmp_path / "interim"), output_dir=str(tmp_path / "out"),
            extras={"synthetic": {"preset": "eicu_real", "seed": 0, "num_patients": 400}},
        ),
        graph=dataclasses.replace(cfg.graph, edge_types=edge_types),
        model=dataclasses.replace(cfg.model, hidden_dim=32),
        train=dataclasses.replace(
            cfg.train, epochs=2, optimizer=dataclasses.replace(cfg.train.optimizer, type="sgd", lr=0.01),
        ),
        evaluation=dataclasses.replace(cfg.evaluation, baselines=("global_mean", "per_lab_mean")),
        visualization=viz,
        logging=dataclasses.replace(cfg.logging, log_file=str(tmp_path / "out" / "training.log")),
    )
    path = save_config(cfg, tmp_path / "config.yaml")
    assert load_config(path).to_dict() == cfg.to_dict()
    assert pipeline.main(["--config", str(path), "--no-confirm", "--device", "cpu"]) == 0
    out = tmp_path / "out"
    graph = load_bundle(out / "graph", device="cpu").graph
    assert set(graph.edge_types) == {PATIENT_LAB, PATIENT_MEDICATION}
    assert "diagnosis" not in graph.node_count_map
    results = json.loads((out / "evaluation_results.json").read_text())
    assert math.isfinite(results["overall_metrics"]["r2"])
    assert len(json.loads((out / "training_history.json").read_text())["train_loss"]) == 2
    assert (out / "graph_visualizations" / "graph_overview.png").exists() or not _has_matplotlib()
    examples = json.loads((out / "inference_examples.json").read_text())["examples"]
    assert examples and all(not e["context"]["diagnoses"] for e in examples)
    assert any(e["context"]["medications"] for e in examples)
    assert (out / "serving" / "serving.json").exists()


def _has_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True
