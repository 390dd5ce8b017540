"""PyTorch port: the ALS and side-information warm starts against the JAX
package, on the CPU (after JAX ``tests/test_warmstart.py``).

One cohort (300 patients, 20 labs, 15 diagnoses, 10 medications), built
from the same tables by both packages; hidden 16, heads (16, 8), dropout 0,
bilinear rank 8 from the ``embedding`` source; ALS rank 4 (reg 3), the side
information's membership rank 3.

* The planted ``state_dict`` equals JAX's plant of the port's baseline
  factors into the same weights (as a flax tree) exactly, RGCN and HGT.
* After ``warm_start_trainer`` the test predictions equal
  ``ALSBaseline.predict`` / ``SideInfoALSBaseline.predict`` within
  ``1e-5``: the heads' output layers are zero, the bilinear channel is the
  baseline.
* ``best_state`` / ``best_val_loss`` are seeded from the plant and ``fit``
  keeps them when no epoch beats them; a rank too small, with and without
  side information, and a model without the channel are refused.
* ``bundle_membership_matrix``: offsets per relation, duplicates collapse,
  equal to JAX's on the cohort.
* ``train_pipeline`` with ``train.extras.warm_start`` wires the channel as
  JAX's does: the same model hash.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.training import trainer as jax_trainer_module
from multi_modal_gnn_tpu.training import warmstart as jax_warmstart
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_tables
from multi_modal_gnn_tpu_torch.evaluation import ALSBaseline, SideInfoALSBaseline
from multi_modal_gnn_tpu_torch.graph import build_heterogeneous_graph
from multi_modal_gnn_tpu_torch.graph.build import assemble_graph
from multi_modal_gnn_tpu_torch.models import build_model, state_dict_from_flax
from multi_modal_gnn_tpu_torch.training import warmstart as port_warmstart
from multi_modal_gnn_tpu_torch.training import (
    Trainer,
    als_warm_start_params,
    bundle_membership_matrix,
    masker_from_config,
    sideinfo_warm_start_params,
    train_pipeline,
    warm_start_from_config,
    warm_start_trainer,
)
from test_torch_value_context import flax_variables

RANK, MEM_RANK = 4, 3
SPEC = dict(
    num_patients=300, num_labs=20, num_diagnoses=15, num_medications=10,
    mean_labs_per_patient=8.0, mean_diagnoses_per_patient=2.0,
    mean_medications_per_patient=2.0, latent_dim=4, seed=3,
)


def _config_dict(arch="RGCN", bilinear_rank=RANK + 1 + MEM_RANK, **train):
    d = JaxConfig().to_dict()
    d["model"].update(architecture=arch, hidden_dim=16, dropout=0.0, num_heads=4)
    d["model"]["edge_head"].update(hidden_dims=[16, 8])
    if bilinear_rank:
        d["model"]["edge_head"].update(bilinear_rank=bilinear_rank, bilinear_source="embedding")
    d["train"].update(train)
    return d


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread: the suite's workers share the cores, and a
    worker's torch on every core slows all of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cohort():
    d = _config_dict()
    t = generate_synthetic_tables(SyntheticSpec(**SPEC))
    bundle = build_heterogeneous_graph(
        t["labs_normalized"], t["diagnoses"], t["medications"], t["cohort"], t["labitems"],
        Config.from_dict(d),
    )
    return dict(bundle=bundle, jbundle=make_synthetic_bundle(JaxSpec(**SPEC), JaxConfig.from_dict(d)))


def _trainer(cohort, d, seed=0):
    cfg = Config.from_dict(d)
    graph = cohort["bundle"].graph
    model = build_model(cfg, graph, device="cpu", generator=torch.Generator().manual_seed(seed))
    return Trainer(model, graph, masker_from_config(cfg, graph), cfg, device="cpu")


def _fit_baseline(trainer, kind):
    graph = trainer.graph
    tr_p, tr_l, tr_v = trainer.masker.split_arrays("train")
    counts = (graph.num_nodes("patient"), graph.num_nodes("lab"))
    if kind == "als":
        return ALSBaseline(*counts, rank=RANK, reg=3.0).fit(tr_v, tr_p, tr_l)
    return SideInfoALSBaseline(*counts, rank=RANK, mem_rank=MEM_RANK, reg=3.0).fit(
        tr_v, tr_p, tr_l, bundle_membership_matrix(graph)
    )


CASES = [(arch, kind) for arch in ("RGCN", "HGT") for kind in ("als", "sideinfo")]


@pytest.mark.parametrize("arch,kind", CASES, ids=["-".join(c) for c in CASES])
def test_plant_equals_jax(cohort, arch, kind):
    trainer = _trainer(cohort, _config_dict(arch))
    baseline = _fit_baseline(trainer, kind)
    state = trainer.model.state_dict()
    params = jax.tree_util.tree_map(jnp.asarray, flax_variables(trainer.model)["params"])
    if kind == "als":
        got = als_warm_start_params(state, baseline, scale=0.5)
        want = jax_warmstart.als_warm_start_params(params, baseline, scale=0.5)
    else:
        got = sideinfo_warm_start_params(state, baseline)
        want = jax_warmstart.sideinfo_warm_start_params(params, baseline)
    want = state_dict_from_flax({"params": want})
    changed = [k for k in want if not torch.equal(want[k], state[k])]
    assert {"embed_patient.weight", "embed_lab.weight", "bilinear_u", "edge_predictor.dense_out.weight"} <= set(changed)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    assert all(torch.equal(state[k], v) for k, v in trainer.model.state_dict().items())  # a copy


@pytest.mark.parametrize("arch,kind", CASES, ids=["-".join(c) for c in CASES])
def test_epoch0_predictions_are_the_baseline(cohort, arch, kind):
    trainer = _trainer(cohort, _config_dict(arch))
    graph = trainer.graph
    memberships = bundle_membership_matrix(graph) if kind == "sideinfo" else None
    baseline = warm_start_trainer(
        trainer, rank=RANK, reg=3.0, memberships=memberships, mem_rank=MEM_RANK
    )
    assert isinstance(baseline, SideInfoALSBaseline if kind == "sideinfo" else ALSBaseline)
    p, l, _ = trainer.masker.split_arrays("test")
    np.testing.assert_allclose(trainer.predict("test"), baseline.predict(p, l), atol=1e-5)
    assert not trainer.optimizer.state  # a fresh Adam state


def test_warm_start_seeds_the_best_state_and_fit_keeps_it(cohort):
    """With the learning rate 0 no epoch beats the plant: ``fit`` keeps the
    seeded best state and loss (the heads are zero, so BatchNorm's moving
    statistics do not move the prediction either)."""
    d = _config_dict(epochs=2)
    d["train"]["optimizer"]["lr"] = 0.0
    d["train"]["optimizer"]["weight_decay"] = 0.0
    trainer = _trainer(cohort, d)
    warm_start_trainer(trainer, rank=RANK, reg=3.0)
    seeded_loss = trainer.best_val_loss
    seeded = {k: v.clone() for k, v in trainer.best_state.items()}
    assert np.isfinite(seeded_loss) and seeded_loss == trainer.validate()
    history = trainer.fit()
    assert len(history["val_loss"]) == 2 and min(history["val_loss"]) >= seeded_loss
    assert trainer.best_val_loss == seeded_loss
    assert all(torch.equal(trainer.best_state[k], v) for k, v in seeded.items())


@pytest.mark.parametrize("kind,bilinear_rank", [("als", RANK), ("sideinfo", RANK + MEM_RANK), ("als", 0)])
def test_a_rank_too_small_is_refused(cohort, kind, bilinear_rank):
    trainer = _trainer(cohort, _config_dict(bilinear_rank=bilinear_rank))
    baseline = _fit_baseline(trainer, kind)
    plant = als_warm_start_params if kind == "als" else sideinfo_warm_start_params
    with pytest.raises(ValueError, match="bilinear_rank"):
        plant(trainer.model.state_dict(), baseline)


def test_bundle_membership_matrix(cohort):
    # offsets per relation (diagnoses, then medications) and duplicates
    # collapsing to 1, on a hand-made graph
    cfg = Config.from_dict(_config_dict())
    edges = {
        ("patient", "has_lab", "lab"): (np.array([0, 1, 2]), np.array([0, 0, 1]), np.ones(3, np.float32)),
        ("patient", "has_diagnosis", "diagnosis"): (np.array([0, 0, 2, 2]), np.array([1, 1, 0, 1]), None),
        ("patient", "has_medication", "medication"): (np.array([1]), np.array([0]), None),
    }
    graph = assemble_graph(edges, {"patient": 3, "lab": 2, "diagnosis": 2, "medication": 3}, cfg)
    want = np.zeros((3, 5), np.float32)
    want[0, 1] = want[2, 0] = want[2, 1] = 1.0
    want[1, 2] = 1.0  # the medication block starts at column 2
    np.testing.assert_array_equal(bundle_membership_matrix(graph), want)
    np.testing.assert_array_equal(
        bundle_membership_matrix(cohort["bundle"]), jax_warmstart.bundle_membership_matrix(cohort["jbundle"])
    )


class _Wired(Exception):
    pass


def test_train_pipeline_wires_the_channel_as_jax(cohort, tmp_path, monkeypatch):
    """``warm_start: als`` on a config without the channel: the port's
    ``train_pipeline`` wires rank 5 from the embedding source, plants and
    trains; its checkpoint's model hash is that of the config JAX
    ``train_pipeline`` builds its model from (caught at ``build_model``)."""
    d = _config_dict(bilinear_rank=0, epochs=2, warm_start="als", warm_start_rank=RANK, warm_start_reg=3.0)
    seen = {}

    def capture(config, graph, *args, **kwargs):
        seen["config"] = config
        raise _Wired

    monkeypatch.setattr(jax_trainer_module, "build_model", capture)
    with pytest.raises(_Wired):
        jax_trainer_module.train_pipeline(JaxConfig.from_dict(d), cohort["jbundle"], tmp_path / "jax")
    trainer, results = train_pipeline(Config.from_dict(d), cohort["bundle"].graph, tmp_path / "port", device="cpu")
    eh = trainer.config.model.edge_head
    assert (eh.bilinear_rank, eh.bilinear_source) == (RANK + 1, "embedding")
    assert tuple(trainer.model.bilinear_u.shape) == (16, RANK + 1)
    assert trainer.config.model_hash() == seen["config"].model_hash()
    sidecar = json.loads((tmp_path / "port" / "best_model.ckpt.json").read_text())
    assert sidecar["model_hash"] == seen["config"].model_hash()
    assert results["best_val_loss"] <= min(trainer.history["val_loss"])
    assert trainer.config.train == Config.from_dict(d).train


@pytest.mark.parametrize("kind", ["als", "sideinfo", "off"])
def test_warm_start_from_config_reads_every_key(cohort, monkeypatch, kind):
    """The one reading of ``train.extras.warm_start*`` that ``train_pipeline``
    and ``chip_smoke.py`` share passes each key on as JAX ``train_pipeline``
    does (its defaults: reg 12, ridge 30, no Huber delta, the membership
    matrix only for ``sideinfo``); ``off`` plants nothing."""
    seen = {}
    monkeypatch.setattr(port_warmstart, "warm_start_trainer", lambda trainer, **kw: seen.update(kw) or kind)
    trainer = _trainer(cohort, _config_dict())
    keys = dict(warm_start_rank=3, warm_start_mem_rank=2, warm_start_ridge_reg=7.0, warm_start_huber_delta=1.5)
    cfg = Config.from_dict(_config_dict(warm_start=kind, **keys))
    assert warm_start_from_config(trainer, cfg) == (kind if kind != "off" else None)
    if kind == "off":
        assert not seen
        return
    memberships = seen.pop("memberships")
    assert seen == dict(rank=3, reg=12.0, mem_rank=2, ridge_reg=7.0, huber_delta=1.5)
    if kind == "als":
        assert memberships is None
    else:
        np.testing.assert_array_equal(memberships, bundle_membership_matrix(cohort["bundle"].graph))

