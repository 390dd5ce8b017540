"""PyTorch port: the sharded graph artifact (``graph/distributed.py``) and
the JAX package's sharded checkpoints (``training/checkpoint.py``), on the
CPU, against the JAX package.

On ``SyntheticSpec.tiny(seed=5)`` (each package builds the graph from the
same tables):

* files JAX's ``save_graph_sharded`` writes (2 shards, kernel plans) load
  into the port bit for bit: each rank's edge chunks, plans and offsets as
  JAX's ``load_graph_distributed`` places them on its device, the chunk's
  CSR, the patient->lab host columns;
* the port's files equal JAX's array for array, and its sidecar's sharding
  entries equal JAX's;
* a loaded shard equals the in-memory shard (``parallel/sharding.py``) of
  the graph with the same plans; a rank reads its own shard files only;
* the elastic load: 4 saved shards over 2 ranks, the saved plans dropped;
  shard counts that do not divide the padding are refused with JAX's
  errors; ``graph.extras.num_shards`` writes the artifact at the graph
  build;
* a JAX ``save_checkpoint_sharded`` checkpoint (``<path>.procNNN.npz``)
  restores into the port's trainer: parameters, BatchNorm statistics, Adam's
  moments and step, the epoch, and the validation loss of the restored
  state; ``latest_checkpoint`` finds it; a missing process file is refused.
"""

import dataclasses
import json
import logging

import jax
import numpy as np
import pytest
import torch

import torch_dp_ranks
from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.graph.distributed import load_graph_distributed as jax_load
from multi_modal_gnn_tpu.graph.distributed import save_graph_sharded as jax_save
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.parallel import make_mesh
from multi_modal_gnn_tpu.training.checkpoint import save_checkpoint_sharded as jax_save_sharded
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxMasker
from multi_modal_gnn_tpu.training.trainer import Trainer as JaxTrainer
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data.preprocess import save_table
from multi_modal_gnn_tpu_torch.data.synthetic import generate_synthetic_tables
from multi_modal_gnn_tpu_torch.data import SyntheticSpec
from multi_modal_gnn_tpu_torch.graph.build import build_graph_from_preprocessed
from multi_modal_gnn_tpu_torch.graph.distributed import (
    attach_relation_plans,
    load_graph_distributed,
    save_graph_sharded,
    shard_path,
)
from multi_modal_gnn_tpu_torch.graph.schema import PATIENT_LAB
from multi_modal_gnn_tpu_torch.models import state_dict_from_flax
from multi_modal_gnn_tpu_torch.parallel.sharding import graph_shard
from multi_modal_gnn_tpu_torch.training import EdgeMasker, Trainer

SPEC = dataclasses.asdict(JaxSpec.tiny(seed=5))
PLAN = ("shard_win_src", "shard_win_local", "shard_win_tile_map")


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
    d["train"].update(donate_state=False)
    return d


@pytest.fixture(scope="module")
def bundles():
    d = _config_dict()
    return make_synthetic_bundle(JaxSpec(**SPEC), JaxConfig.from_dict(d)), torch_dp_ranks.port_bundle(SPEC, d)


@pytest.fixture(scope="module")
def jax_files(bundles, tmp_path_factory):
    return jax_save(bundles[0], tmp_path_factory.mktemp("jax") / "graph", num_shards=2, kernel_plans=True)


def _assert_edge_sets_equal(got, want, context=""):
    for name in ("src", "dst", "mask", "val", "dst_count", "row_ptr", *PLAN, "shard_win_offset"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), f"{context} {name}"
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f"{context} {name}")
    for name in ("num_valid", "num_src", "num_dst", "shard_win_windows", "shard_win_first"):
        assert getattr(got, name) == getattr(want, name), f"{context} {name}"


@pytest.mark.parametrize("rank", [0, 1])
def test_jax_files_load_into_the_port(bundles, jax_files, rank):
    jloaded = jax_load(jax_files, make_mesh(2))
    loaded = load_graph_distributed(jax_files, rank, 2)
    assert loaded.graph.node_counts == tuple(sorted(dict(bundles[0].graph.node_counts).items()))
    for et, jes in jloaded.graph.edges.items():
        es = loaded.graph.edges[et]

        def device_chunk(arr):
            shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start or 0)
            return np.asarray(shards[rank].data)

        for name in ("src", "dst", "mask", "val", *PLAN, "shard_win_offset"):
            if getattr(jes, name) is not None:
                np.testing.assert_array_equal(getattr(es, name).numpy(), device_chunk(getattr(jes, name)), err_msg=f"{et} {name}")
        np.testing.assert_array_equal(es.dst_count.numpy(), np.asarray(jes.dst_count))
        chunk = int(jes.src.shape[0]) // 2
        assert es.num_valid == int(min(max(jes.num_valid - rank * chunk, 0), chunk))
        want_ptr = np.clip(np.asarray(jes.row_ptr).astype(np.int64) - rank * chunk, 0, es.num_valid)
        np.testing.assert_array_equal(es.row_ptr.numpy(), want_ptr)
        assert es.shard_win_windows == jes.shard_win_windows and es.shard_win_first == int(device_chunk(jes.shard_win_offset)[0])
    for g, w in zip(loaded.host_edges[PATIENT_LAB], jloaded.host_edges[PATIENT_LAB]):
        np.testing.assert_array_equal(g, w)


def test_port_files_equal_jax_files(bundles, jax_files, tmp_path):
    base = save_graph_sharded(bundles[1], tmp_path / "graph", num_shards=2, kernel_plans=True)
    names = ["common"] + [f"shard{k:03d}-of-002" for k in range(2)]
    for name in names:
        with np.load(f"{base}.{name}.npz") as got, np.load(f"{jax_files}.{name}.npz") as want:
            assert sorted(got.files) == sorted(want.files), name
            for key in want.files:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
    got, want = (json.loads(p.with_suffix(".meta.json").read_text()) for p in (base, jax_files))
    assert got["sharded"] == want["sharded"] and got["edges"] == want["edges"]
    assert got["node_counts"] == want["node_counts"]


def test_loaded_shard_equals_the_in_memory_shard(bundles, tmp_path):
    graph = bundles[1].graph
    base = save_graph_sharded(bundles[1], tmp_path / "graph", num_shards=2, kernel_plans=True)
    planned = attach_relation_plans(graph, 2)
    for rank in range(2):
        loaded = load_graph_distributed(base, rank, 2)
        want = graph_shard(planned, rank, 2)
        np.testing.assert_array_equal(loaded.graph.patient_lab_degree.numpy(), graph.patient_lab_degree.numpy())
        for et in graph.edges:
            _assert_edge_sets_equal(loaded.graph.edges[et], want.edges[et], f"rank {rank} {et}")
    # a rank reads its own shard files: rank 0 loads without shard 1
    shard_path(base, 1, 2).unlink()
    alone = load_graph_distributed(base, 0, 2, load_host_patient_lab=False)
    _assert_edge_sets_equal(alone.graph.edges[PATIENT_LAB], graph_shard(planned, 0, 2).edges[PATIENT_LAB])


def test_elastic_load_drops_the_saved_plans(bundles, tmp_path, caplog):
    base = jax_save(bundles[0], tmp_path / "graph", num_shards=4, kernel_plans=True)
    with caplog.at_level(logging.WARNING):
        parts = [load_graph_distributed(base, r, 2) for r in range(2)]
    assert "dropping saved 4-shard kernel plans" in caplog.text
    for rank, loaded in enumerate(parts):
        want = graph_shard(bundles[1].graph, rank, 2)
        for et, es in loaded.graph.edges.items():
            assert es.shard_win_src is None
            _assert_edge_sets_equal(es, want.edges[et], f"rank {rank} {et}")


def test_indivisible_shard_counts_are_refused(bundles, jax_files, tmp_path):
    with pytest.raises(ValueError, match="not divisible by num_shards=3"):
        save_graph_sharded(bundles[1], tmp_path / "g", num_shards=3)
    with pytest.raises(ValueError, match="not divisible by mesh axis 'data' \\(3 devices\\)"):
        load_graph_distributed(jax_files, 0, 3)


def test_graph_build_writes_the_sharded_artifact(bundles, tmp_path):
    d = _config_dict(use_pallas=True)
    d["graph"]["num_shards"] = 2
    tables = generate_synthetic_tables(SyntheticSpec(**SPEC))
    for name in ("labs_normalized", "diagnoses", "medications", "cohort", "labitems"):
        save_table(tables[name], tmp_path / "interim" / f"{name}.npz")
    built = build_graph_from_preprocessed(tmp_path / "interim", Config.from_dict(d), output_path=tmp_path / "out" / "graph")
    assert (tmp_path / "out" / "graph.npz").exists() and (tmp_path / "out" / "graph_sharded.common.npz").exists()
    for rank in range(2):  # the plans follow model.use_pallas (graph.extras.shard_kernel_plans unset)
        loaded = load_graph_distributed(tmp_path / "out" / "graph_sharded", rank, 2)
        want = graph_shard(attach_relation_plans(built.graph, 2), rank, 2)
        for et in built.graph.edges:
            _assert_edge_sets_equal(loaded.graph.edges[et], want.edges[et], f"rank {rank} {et}")


# -- JAX's sharded checkpoints ------------------------------------------------------


def test_jax_sharded_checkpoint_restores_into_the_port(bundles, tmp_path):
    d = _config_dict()
    jcfg = JaxConfig.from_dict(d)
    jbundle, bundle = bundles
    jtrainer = JaxTrainer(
        jax_build_model(jcfg, jbundle.graph), jbundle.graph,
        JaxMasker(jbundle.graph, seed=7, host_edges=jbundle.patient_lab_host()), jcfg,
    )
    for _ in range(2):
        jtrainer.train_epoch()
        jtrainer.epoch += 1
    want_val = jtrainer.validate("val")
    path = tmp_path / "checkpoint_epoch_2.ckpt"
    jax_save_sharded(path, jtrainer._checkpoint_payload(), jtrainer._host_metadata())
    assert not path.exists() and (tmp_path / "checkpoint_epoch_2.ckpt.proc000.npz").exists()
    assert Trainer.latest_checkpoint(tmp_path) == path

    cfg = Config.from_dict(d)
    trainer = Trainer(
        torch_dp_ranks.build_model(cfg, bundle.graph, device="cpu", generator=torch.Generator().manual_seed(0)),
        bundle.graph, EdgeMasker(bundle.graph, seed=7), cfg, device="cpu",
    )
    trainer.restore(path)
    assert trainer.epoch == 2
    want = state_dict_from_flax({"params": jtrainer.state.params, "batch_stats": jtrainer.state.batch_stats})
    got = trainer.model.state_dict()
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)
    mu = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, _adam(jtrainer.state.opt_state).mu)})
    for name, param in trainer.model.named_parameters():
        state = trainer.optimizer.state[param]
        np.testing.assert_array_equal(state["exp_avg"].numpy(), mu[name].numpy(), err_msg=name)
        assert float(state["step"]) == 2.0
    np.testing.assert_allclose(trainer.validate("val"), want_val, rtol=1e-5)

    # a process file lost on the way is refused
    meta = json.loads(path.with_suffix(".ckpt.json").read_text())
    meta["sharded_checkpoint"]["num_processes"] = 2
    path.with_suffix(".ckpt.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="only 1 .proc"):
        trainer.restore(path)


def _adam(opt_state):
    """Adam's ``ScaleByAdamState`` inside JAX's optimizer chain."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu")):
        if hasattr(leaf, "mu"):
            return leaf
    raise AssertionError("no Adam state")
