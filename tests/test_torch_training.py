"""PyTorch port: the training slice against the JAX package.

* The config's ``train`` section, the losses, the lab weights and the plateau
  scheduler equal their JAX counterparts.
* The masker's batches equal the JAX ``EdgeMasker``'s element for element:
  row-major, slot-major, and slot-major with span lab tiles.
* One train step, the slice as a whole: JAX ``Trainer._train_step`` (Pallas
  kernels in interpret mode) against the port's ``Trainer.train_step``
  (plain kernel versions on the CPU), from the same bridged weights, the
  same batch and the same numpy supervision mask, with dropout 0.  The loss
  agrees to ``rtol=1e-5``; the parameters after the Adam step to
  ``atol=4e-4``, the JAX package's own bound for f32 sums reassociated
  across layouts (``tests/test_slot_major.py``), since Adam's first step
  moves each parameter by about ``lr * sign(grad)`` and a reassociated
  near-zero gradient may flip its sign; the BatchNorm running statistics to
  ``atol=1e-5``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.graph.build import assemble_graph as jax_assemble
from multi_modal_gnn_tpu.models import losses as jax_losses
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.models.factory import init_model_variables
from multi_modal_gnn_tpu.training import schedulers as jax_schedulers
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxEdgeMasker
from multi_modal_gnn_tpu.training.trainer import Trainer as JaxTrainer
from multi_modal_gnn_tpu_torch.config import Config, ConfigError
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_edges
from multi_modal_gnn_tpu_torch.graph.build import assemble_graph
from multi_modal_gnn_tpu_torch.models import build_model, state_dict_from_flax
from multi_modal_gnn_tpu_torch.models import losses
from multi_modal_gnn_tpu_torch.ops import pairhead_kernels, segment_kernels
from multi_modal_gnn_tpu_torch.training import EdgeMasker, Trainer, masker_from_config, schedulers
from multi_modal_gnn_tpu_torch.training.masker import auto_lab_tile_rows, resolve_lab_tile_rows

LAYOUTS = {
    "row_major": dict(),
    "slot_major": dict(slot_major_train=True, slot_major_min_rows=0),
    "slot_major_span": dict(slot_major_train=True, slot_major_min_rows=0, lab_block_rows=32),
    "slot_major_span128": dict(slot_major_train=True, slot_major_min_rows=0, lab_block_rows=128),
}


def _jax_config():
    cfg = JaxConfig()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, hidden_dim=32, dropout=0.0, use_pallas=True,
            extras={"head_style": "factored"},
        ),
        graph=dataclasses.replace(cfg.graph, dense_adjacency_max_bytes=0),
    )


@pytest.fixture(scope="module")
def cohort():
    spec = SyntheticSpec(
        num_patients=600, num_labs=40, num_diagnoses=30, num_medications=20,
        mean_labs_per_patient=8.0, mean_diagnoses_per_patient=2.0,
        mean_medications_per_patient=2.0, latent_dim=4, seed=1,
    )
    edge_arrays, node_counts = generate_synthetic_edges(spec)
    jcfg = _jax_config()
    cfg = Config.from_dict(jcfg.to_dict())
    jax_graph = jax_assemble(edge_arrays, node_counts, config=jcfg)
    graph = assemble_graph(edge_arrays, node_counts, cfg)
    return dict(jcfg=jcfg, cfg=cfg, jax_graph=jax_graph, graph=graph)


def _maskers(cohort, layout):
    kw = LAYOUTS[layout]
    jkw = dict(kw, lab_tile_mode="span") if "lab_block_rows" in kw else kw
    return (
        EdgeMasker(cohort["graph"], seed=4, **kw),
        JaxEdgeMasker(cohort["jax_graph"], seed=4, **jkw),
    )


# -- config, losses, scheduler ----------------------------------------------


def test_train_config_reads_the_jax_section():
    jcfg = JaxConfig()
    jcfg = jcfg.replace(
        train=dataclasses.replace(
            jcfg.train, epochs=7, loss="huber", mask_fraction=0.3,
            optimizer=dataclasses.replace(jcfg.train.optimizer, lr=5e-4, embedding_weight_decay=1e-4),
            extras={"lab_tile_rows": 128, "lab_reweighting": False},
        )
    )
    tc = Config.from_dict(jcfg.to_dict()).train
    assert (tc.epochs, tc.loss, tc.mask_fraction) == (7, "huber", 0.3)
    assert (tc.optimizer.lr, tc.optimizer.embedding_weight_decay) == (5e-4, 1e-4)
    assert tc.extras == {"lab_tile_rows": 128, "lab_reweighting": False}
    assert tc.lr_scheduler == Config().train.lr_scheduler


@pytest.mark.parametrize(
    "train",
    [
        {"batch_size": 1024},
        {"optimizer": {"type": "sgd"}},
        {"scan_chunk": 4},
        {"num_clusters": 8},
        {"warm_start": True},
        {"lab_tile_mode": "block"},
        {"loss": "l1"},
        {"train_split": 0.9},
    ],
)
def test_train_config_rejects_what_the_port_does_not_run(train):
    with pytest.raises(ConfigError):
        Config.from_dict({"train": train})


def test_losses_and_lab_weights_match_jax():
    rng = np.random.default_rng(0)
    n, num_labs = 5000, 30
    pred, target = rng.standard_normal(n).astype(np.float32), rng.standard_normal(n).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, n).astype(np.float32)
    sup = (rng.random(n) < 0.3).astype(np.float32)
    t = torch.from_numpy
    for loss_type in ("mae", "mse", "huber"):
        got = losses.weighted_regression_loss(t(pred), t(target), t(weights), t(sup), loss_type)
        want = jax_losses.weighted_regression_loss(pred, target, weights, sup, loss_type=loss_type)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        got = losses.masked_mean_loss(t(pred), t(target), t(sup), loss_type)
        want = jax_losses.masked_mean_loss(pred, target, sup, loss_type=loss_type)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    labs = rng.integers(0, num_labs - 2, n)  # the last two labs have no samples
    labs[:1] = num_labs - 2  # one lab with a single sample
    values = rng.standard_normal(n) * rng.uniform(0.2, 3.0, num_labs)[labs]
    np.testing.assert_array_equal(
        losses.compute_lab_weights(values, labs, num_labs),
        jax_losses.compute_lab_weights(values, labs, num_labs),
    )


def test_plateau_scheduler_follows_jax_decisions():
    metrics = [1.0, 0.9, 0.9, 0.91, 0.9, 0.95, 0.89999, 0.9, 0.9, 0.5, 0.6, 0.6, 0.6, 0.6]
    ours = schedulers.ReduceLROnPlateau(1e-3, factor=0.5, patience=2, min_lr=2e-4)
    theirs = jax_schedulers.ReduceLROnPlateau(1e-3, factor=0.5, patience=2, min_lr=2e-4)
    assert [ours.step(m) for m in metrics] == [theirs.step(m) for m in metrics]
    step_ours, step_theirs = schedulers.StepLR(1e-2, 3, 0.5), jax_schedulers.StepLR(1e-2, 3, 0.5)
    assert [step_ours.step() for _ in range(8)] == [step_theirs.step() for _ in range(8)]


def test_lab_tile_defaults_match_jax():
    from multi_modal_gnn_tpu.training import masker as jm

    for num_labs in (None, 12, 384, 500, 720):
        assert auto_lab_tile_rows(num_labs) == jm.auto_lab_tile_rows(num_labs)
        for raw in (None, "auto", 0, 128):
            for use_pallas in (False, True):
                assert resolve_lab_tile_rows(raw, num_labs, use_pallas) == jm.resolve_lab_tile_rows(
                    raw, num_labs, use_pallas
                )


# -- masker -------------------------------------------------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_masker_batches_equal_jax(cohort, layout):
    ours, theirs = _maskers(cohort, layout)
    assert ours.split_sizes() == theirs.split_sizes()
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(ours.split_indices(split), theirs.split_indices(split))
        b, jb = ours.get_split(split), theirs.get_split(split)
        assert b.num_valid == jb.num_valid
        for name in ("patient_idx", "lab_idx", "values", "valid"):
            np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
        for plan, jplan in ((b.patient_plan, jb.patient_plan), (b.lab_plan, jb.lab_plan)):
            assert (plan is None) == (jplan is None)
            if plan is None:
                continue
            assert (plan.num_windows, plan.num_rows, plan.identity) == (
                jplan.num_windows, jplan.num_rows, jplan.identity,
            )
            assert (plan.lab_block_rows, plan.lab_span_mode) == (
                jplan.lab_block_rows or 0, jplan.lab_span_mode,
            )
            names = ["win_local", "win_tile_map", "lab_block_map"] + ([] if plan.identity else ["win_src"])
            for name in names:
                got, want = getattr(plan, name), getattr(jplan, name)
                assert (got is None) == (want is None), name
                if got is not None:
                    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
        slots, jslots = ours.slot_map(split), theirs.slot_map(split)
        assert (slots is None) == (jslots is None)
        if slots is not None:
            np.testing.assert_array_equal(slots, jslots)
    np.testing.assert_array_equal(ours.train_positions(), theirs.train_positions())
    if layout != "row_major":
        assert ours.get_split("train").patient_plan.identity


def test_supervision_mask_is_seeded_by_epoch(cohort):
    masker = EdgeMasker(cohort["graph"], seed=4, mask_fraction=0.2)
    batch = masker.get_split("train")
    a, b = masker.supervision_mask(3, batch), masker.supervision_mask(3, batch)
    assert torch.equal(a, b) and not torch.equal(a, masker.supervision_mask(4, batch))
    assert float((a * (1 - batch.valid)).sum()) == 0.0
    frac = float(a.sum() / batch.valid.sum())
    assert abs(frac - 0.2) < 0.05


def test_masker_from_config_routes_the_kernel_path(cohort):
    masker = masker_from_config(cohort["cfg"], cohort["graph"])
    assert masker.slot_major_train and masker.lab_block_rows == 0  # 40 labs: no lab tiles
    cfg = dataclasses.replace(
        cohort["cfg"], train=dataclasses.replace(cohort["cfg"].train, extras={"lab_tile_rows": 32})
    )
    assert masker_from_config(cfg, cohort["graph"]).lab_block_rows == 32


# -- one train step against JAX -----------------------------------------------


@pytest.fixture(scope="module")
def jax_variables(cohort):
    model = jax_build_model(cohort["jcfg"], cohort["jax_graph"])
    return init_model_variables(model, cohort["jax_graph"], jax.random.PRNGKey(0))


@pytest.mark.parametrize("layout", ["slot_major_span", "slot_major_span128", "row_major"])
def test_train_step_matches_jax(cohort, jax_variables, layout):
    masker, jmasker = _maskers(cohort, layout)
    jcfg, cfg = cohort["jcfg"], cohort["cfg"]
    jtrainer = JaxTrainer(
        jax_build_model(jcfg, cohort["jax_graph"]), cohort["jax_graph"], jmasker, jcfg,
        variables=jax_variables,
    )
    model = build_model(cfg, cohort["graph"], device="cpu")
    model.load_state_dict(state_dict_from_flax(jax_variables), strict=True)
    trainer = Trainer(model, cohort["graph"], masker, cfg, device="cpu")

    jbatch, batch = jtrainer._get_batch("train"), trainer.get_batch("train")
    rng = np.random.default_rng(0)
    sup = (rng.random(batch.valid.shape[0]) < 0.4).astype(np.float32) * batch.valid.numpy()
    copy = lambda s: jax.tree_util.tree_map(jnp.array, s)  # noqa: E731 (donation)
    jstate, jloss = jtrainer._train_step(
        copy(jtrainer.state), cohort["jax_graph"], jbatch, jtrainer.lab_weights,
        jnp.asarray(sup), jax.random.key(7),
    )
    segment_kernels.reset_launch_counts()
    pairhead_kernels.reset_launch_counts()
    loss = trainer.train_step(batch, torch.from_numpy(sup), 0)
    assert not any(segment_kernels.launch_counts.values())  # the CPU took the plain versions
    assert not any(pairhead_kernels.launch_counts.values())

    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    want = state_dict_from_flax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    got = model.state_dict()
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        atol = 1e-5 if key.endswith(("running_mean", "running_var")) else 4e-4
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), atol=atol, err_msg=key)
    # the port's slot-major step and its row-major step agree too
    if layout.startswith("slot_major_span"):
        row, _ = _maskers(cohort, "row_major")
        twin = build_model(cfg, cohort["graph"], device="cpu")
        twin.load_state_dict(state_dict_from_flax(jax_variables), strict=True)
        t_row = Trainer(twin, cohort["graph"], row, cfg, device="cpu")
        b_row = t_row.get_batch("train")
        slots = masker.slot_map("train")
        n = b_row.num_valid
        sup_row = np.zeros(b_row.valid.shape[0], np.float32)
        sup_row[:n] = sup[slots[:n]]
        np.testing.assert_allclose(t_row.train_step(b_row, torch.from_numpy(sup_row), 0), loss, rtol=1e-5)
        for key, value in twin.state_dict().items():
            np.testing.assert_allclose(value.numpy(), got[key].numpy(), atol=4e-4, err_msg=key)


def test_fit_predict_and_the_slot_map(cohort):
    cfg = dataclasses.replace(
        cohort["cfg"],
        model=dataclasses.replace(cohort["cfg"].model, dropout=0.2),
        train=dataclasses.replace(cohort["cfg"].train, epochs=3),
    )
    masker, _ = _maskers(cohort, "slot_major_span")
    model = build_model(cfg, cohort["graph"], device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, cohort["graph"], masker, cfg, device="cpu")
    history = trainer.fit()
    assert len(history["train_loss"]) == 3 and np.isfinite(history["train_loss"]).all()
    assert np.isfinite(history["val_loss"]).all() and history["train_edges_per_sec"] > 0
    # predictions come back in split order, as the row-major layout gives them
    row, _ = _maskers(cohort, "row_major")
    twin = Trainer(model, cohort["graph"], row, cfg, device="cpu")
    np.testing.assert_allclose(trainer.predict("train"), twin.predict("train"), atol=1e-5)


def test_entry_points_default_to_the_card(cohort):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from multi_modal_gnn_tpu_torch.data import make_synthetic_graph

    with pytest.raises(RuntimeError):
        build_model(cohort["cfg"], cohort["graph"])
    with pytest.raises(RuntimeError):
        make_synthetic_graph(SyntheticSpec.tiny(), cohort["cfg"])
    masker, _ = _maskers(cohort, "row_major")
    model = build_model(cohort["cfg"], cohort["graph"], device="cpu")
    with pytest.raises(RuntimeError):
        Trainer(model, cohort["graph"], masker, cohort["cfg"])
