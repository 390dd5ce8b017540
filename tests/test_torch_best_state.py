"""PyTorch port: once ``fit`` has recorded a best validation state, the port
serves and reports it, as the JAX package does.

JAX ``serving._serving_variables`` serves ``trainer.best_state`` when it
exists and the live state otherwise, and JAX ``train_pipeline`` reports the
test loss of that state (``trainer.validate("test", state=best)``).  Here a
small RGCN trains with a learning rate large enough that its best epoch is
not its last, and on the CPU:

* ``Trainer.validate(split, state)`` and ``predict(split, state)`` equal
  those of a second model loaded with ``best_state``, differ from the live
  (last-epoch) model's, and leave the live parameters as they are;
* ``serving.compute_trainer_state`` / ``build_trainer_serving_fn`` serve the
  best state, and fall back to the live parameters before ``fit``.
"""

import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.serving import _serving_variables as jax_serving_variables
from multi_modal_gnn_tpu_torch.config import Config, GraphConfig, ModelConfig
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
from multi_modal_gnn_tpu_torch.models import build_model
from multi_modal_gnn_tpu_torch.serving import (
    build_serving_fn,
    build_trainer_serving_fn,
    compute_node_state,
    compute_trainer_state,
)
from multi_modal_gnn_tpu_torch.training import Trainer, masker_from_config

SPEC = SyntheticSpec(
    num_patients=300, num_labs=20, num_diagnoses=15, num_medications=10,
    mean_labs_per_patient=8.0, mean_diagnoses_per_patient=2.0,
    mean_medications_per_patient=2.0, latent_dim=4, seed=5,
)
EPOCHS = 3


@pytest.fixture(scope="module")
def trained():
    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0),
        model=ModelConfig(hidden_dim=16, dropout=0.0, use_pallas=True),
    )
    train = dataclasses.replace(config.train, epochs=EPOCHS, early_stopping_patience=EPOCHS)
    config = dataclasses.replace(
        config, train=dataclasses.replace(train, optimizer=dataclasses.replace(train.optimizer, lr=0.3)),
    )
    graph = make_synthetic_graph(SPEC, config, device="cpu")
    model = build_model(config, graph, device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, graph, masker_from_config(config, graph), config, device="cpu")
    fresh = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    history = trainer.fit()
    best_epoch = int(np.argmin(history["val_loss"]))
    # the learning rate overshoots: the best state is not the last one
    assert best_epoch < len(history["val_loss"]) - 1, history["val_loss"]
    best_model = copy.deepcopy(trainer.model)
    best_model.load_state_dict(trainer.best_state)
    return SimpleNamespace(trainer=trainer, graph=graph, config=config, best_model=best_model.eval(),
                           fresh=fresh, history=history, best_epoch=best_epoch)


def test_validate_and_predict_take_a_state(trained):
    trainer = trained.trainer
    live = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    best = trainer.best_state
    assert trainer.validate("val", state=best) == pytest.approx(trained.history["val_loss"][trained.best_epoch], rel=1e-6)
    assert trainer.validate("val") == pytest.approx(trained.history["val_loss"][-1], rel=1e-6)
    twin = Trainer(trained.best_model, trained.graph, trainer.masker, trained.config, device="cpu")
    assert trainer.validate("test", state=best) == twin.validate("test")
    assert trainer.validate("test", state=best) != trainer.validate("test")
    np.testing.assert_array_equal(trainer.predict("test", state=best), twin.predict("test"))
    assert not np.array_equal(trainer.predict("test", state=best), trainer.predict("test"))
    for key, value in trainer.model.state_dict().items():  # the live model is untouched
        assert torch.equal(value, live[key]), key


def test_serving_entry_points_serve_the_best_state(trained):
    trainer = trained.trainer
    want = compute_node_state(trained.best_model, trained.graph)
    got = compute_trainer_state(trainer)
    last = compute_node_state(copy.deepcopy(trainer.model), trained.graph)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert not torch.equal(got["final_p"], last["final_p"])
    fn, _ = build_trainer_serving_fn(trainer)
    fn_best, _ = build_serving_fn(trained.best_model, trained.graph)
    p, l = np.arange(0, 300, 7), np.arange(0, 300, 7) % 20
    assert torch.equal(fn(p, l), fn_best(p, l))


def test_before_fit_the_live_parameters_are_served(trained):
    model = build_model(trained.config, trained.graph, device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, trained.graph, masker_from_config(trained.config, trained.graph), trained.config,
                      device="cpu")
    assert trainer.best_state is None
    got = compute_trainer_state(trainer)
    want = compute_node_state(copy.deepcopy(model), trained.graph)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    for key, value in model.state_dict().items():
        assert torch.equal(value, trained.fresh[key]), key


def test_jax_serves_the_best_state_the_same_way():
    # the reference's rule, on a stand-in trainer: best_state when fit
    # recorded one, the live state otherwise
    best = SimpleNamespace(params={"w": 1}, batch_stats={})
    live = SimpleNamespace(params={"w": 2}, batch_stats={})
    assert jax_serving_variables(SimpleNamespace(best_state=best, state=live)) == {"params": {"w": 1}}
    assert jax_serving_variables(SimpleNamespace(best_state=None, state=live)) == {"params": {"w": 2}}
