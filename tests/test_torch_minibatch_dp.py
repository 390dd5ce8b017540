"""PyTorch port: Cluster-GCN composed with 1-D data parallelism
(``parallel/minibatch_dp.py``) against the port's ``MiniBatchTrainer``, on
the CPU.

On ``tests/test_minibatch_dp.py``'s 4-window cohort (520 patients, hidden
32, dropout 0) and 3 clusters, 2 gloo ranks (spawned once for the file,
``torch_dp_ranks``) each take half of every cluster's edges and batch; the
single process takes the same clusters whole, from the same weights:

* device-resident clusters on the segment path, host-resident clusters on
  per-shard K1 plans, and the value context: 2 epochs' losses at ``rtol
  2e-5`` (JAX's ``test_minibatch_dp.py`` tolerance; ``1e-3`` with shard
  plans, whose single-process twin runs other tiers), parameters, the
  validation loss and the test predictions in split order;
* the ranks end bit-equal; every cluster carries its shard plans when
  asked; ``predict_pairs`` runs the unsharded twin on the whole graph.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_dp_ranks
from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.parallel.launch import Ranks
from multi_modal_gnn_tpu_torch.parallel.mesh import DataAxis
from multi_modal_gnn_tpu_torch.parallel.minibatch_dp import MiniBatchDPTrainer
from multi_modal_gnn_tpu_torch.training import EdgeMasker, MiniBatchTrainer

SPEC = dataclasses.asdict(dataclasses.replace(JaxSpec.tiny(seed=1), num_patients=520, mean_labs_per_patient=6.0))
CLUSTERS = 3
EPOCHS = 2
CASES = {  # name: (model settings, host-resident, shard plans)
    "device": ({}, False, False),
    "host_plans": ({"use_pallas": True}, True, True),
    "vctx": ({"value_context": True}, False, False),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread in this process (the ranks pin theirs): the
    suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config_dict(**model):
    d = JaxConfig().to_dict()
    d["model"].update(hidden_dim=32, dropout=0.0, **model)
    return d


@pytest.fixture(scope="module")
def runs():
    jobs, single = {}, {}
    for name, (model, host, _) in CASES.items():
        d = _config_dict(**model)
        bundle = torch_dp_ranks.port_bundle(SPEC, d)
        init = torch_dp_ranks.build_model(
            Config.from_dict(d), bundle.graph, device="cpu", generator=torch.Generator().manual_seed(2)
        )
        jobs[name] = dict(
            spec=SPEC, config=d, state=torch_dp_ranks.numpy_state(init), clusters=CLUSTERS,
            host_resident=host, epochs=EPOCHS,
        )
    ranks = Ranks(torch_dp_ranks.minibatch_checks, 2, (jobs,))
    for name, job in jobs.items():
        cfg = Config.from_dict(job["config"])
        bundle = torch_dp_ranks.port_bundle(SPEC, job["config"])
        trainer = MiniBatchTrainer(
            torch_dp_ranks.model_with(cfg, bundle.graph, job["state"]), bundle, EdgeMasker(bundle.graph, seed=0),
            cfg, num_clusters=CLUSTERS, device="cpu",
        )
        losses = [trainer.train_epoch()]
        for _ in range(EPOCHS - 1):
            trainer.epoch += 1
            losses.append(trainer.train_epoch())
        single[name] = {
            "losses": losses, "state": torch_dp_ranks.numpy_state(trainer.model),
            "val": trainer.validate("val"), "test_preds": trainer.predict("test"),
        }
    return dict(ranks=ranks.join(600), single=single)


@pytest.mark.parametrize("name", list(CASES))
def test_minibatch_dp_matches_one_process(runs, name):
    rtol = 1e-3 if CASES[name][2] else 2e-5
    port, want = runs["ranks"][0][name], runs["single"][name]
    np.testing.assert_allclose(port["losses"], want["losses"], rtol=rtol)
    np.testing.assert_allclose(port["val"], want["val"], rtol=rtol)
    for key, value in want["state"].items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(port["state"][key], value, rtol=5e-4, atol=4e-4, err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_minibatch_dp_predictions_in_split_order(runs, name):
    port, want = runs["ranks"][0][name]["test_preds"], runs["single"][name]["test_preds"]
    assert port.shape == want.shape
    np.testing.assert_allclose(port, want, rtol=2e-3, atol=2e-4)


def test_ranks_agree_and_clusters_carry_plans(runs):
    a, b = runs["ranks"]
    for name, (_, host, plans) in CASES.items():
        assert a[name]["losses"] == b[name]["losses"]
        for key, value in a[name]["state"].items():
            np.testing.assert_array_equal(value, b[name]["state"][key], err_msg=f"{name} {key}")
        assert a[name]["shard_plans"] == [plans] * CLUSTERS
        assert set(a[name]["pinned"]) == {"cpu"}


def test_predict_pairs_runs_the_unsharded_twin():
    """On one rank of one (no collectives run), ``predict_pairs`` on the
    whole graph equals the single-process trainer's."""
    d = _config_dict(use_pallas=True)
    cfg = Config.from_dict(d)
    bundle = torch_dp_ranks.port_bundle(SPEC, d)
    state = torch_dp_ranks.numpy_state(
        torch_dp_ranks.build_model(cfg, bundle.graph, device="cpu", generator=torch.Generator().manual_seed(3))
    )
    dp = MiniBatchDPTrainer(
        bundle, EdgeMasker(bundle.graph, seed=0), cfg, num_clusters=CLUSTERS,
        model=torch_dp_ranks.model_with(cfg, bundle.graph, state), axis=DataAxis(), device="cpu",
    )
    one = MiniBatchTrainer(
        torch_dp_ranks.model_with(cfg, bundle.graph, state), bundle, EdgeMasker(bundle.graph, seed=0), cfg,
        num_clusters=CLUSTERS, device="cpu",
    )
    assert dp.model.axis is not None and dp.model.unsharded().axis is None
    p, lab = np.arange(0, 500, 7), np.arange(0, 500, 7) % bundle.graph.num_nodes("lab")
    np.testing.assert_allclose(dp.predict_pairs(p, lab), one.predict_pairs(p, lab), rtol=1e-5, atol=1e-6)
