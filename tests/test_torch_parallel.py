"""PyTorch port: 1-D data parallelism (``parallel/``) against the JAX
package's, on the CPU.

The port runs 2 gloo ranks, spawned once for the file (``torch_dp_ranks``);
JAX runs its ``DataParallelTrainer`` on a 2-device mesh of the suite's
virtual CPU devices, where its per-shard segment kernel runs in interpret
mode.  Both start from the same parameters (bridged by ``models/convert.py``)
and take the same injected supervision masks, with dropout 0, on
``SyntheticSpec.tiny(seed=5)`` at hidden 32:

* ``build_sharded_window_plans`` and ``attach_shard_plans`` equal JAX's
  field for field, empty shards included;
* the per-shard total and its mirror-plan backward against JAX
  ``_sharded_windowed_aggregate`` under ``shard_map``, at ``2e-4`` (JAX's
  ``test_sharded_windowed_aggregate_matches_xla``); ``max`` over shards
  against one process;
* 2 DP steps of the RGCN on the segment path, of the RGCN with the value
  context on per-shard K1 plans and of the HGT (its sharded segment tier),
  each against JAX DP and against the port's single process: losses at
  ``rtol 2e-4`` (``1e-3`` with shard plans, as JAX's cross-tier test),
  parameters after both Adam steps at ``rtol 5e-4, atol 4e-4`` (JAX's
  ``test_dp_matches_single_device`` rtol; the atol of the port's step
  tests), the validation loss and the test predictions, in split order,
  against the single process; the ranks' states identical;
* the routes and refusals: ``train_pipeline`` on one rank, ``2d`` /
  ``dp2d`` accepted with ``model_parallel`` (``tests/test_torch_dp2d.py``
  trains them) and ``gspmd`` refused naming ROADMAP item 8c, an
  indivisible batch padding and a ``num_devices`` that is not the world
  size with JAX's errors;
* the dry-run tool over 2 ranks.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_dp_ranks
from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.graph.hetero import build_sharded_window_plans as jax_plans
from multi_modal_gnn_tpu.ops.segment import aggregate_neighbors as jax_aggregate
from multi_modal_gnn_tpu.parallel import DataParallelTrainer as JaxDP
from multi_modal_gnn_tpu.parallel import dp as jax_dp_module
from multi_modal_gnn_tpu.parallel import make_mesh
from multi_modal_gnn_tpu.parallel import shard_graph as jax_shard_graph
from multi_modal_gnn_tpu.parallel.sharding import attach_shard_plans as jax_attach, graph_pspecs
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxMasker
from multi_modal_gnn_tpu_torch.config import Config, ConfigError
from multi_modal_gnn_tpu_torch.graph.hetero import build_sharded_window_plans
from multi_modal_gnn_tpu_torch.graph.schema import PATIENT_LAB, mirror_edge_type
from multi_modal_gnn_tpu_torch.models import state_dict_from_flax
from multi_modal_gnn_tpu_torch.parallel.launch import Ranks
from multi_modal_gnn_tpu_torch.parallel.mesh import DataAxis, init_axis
from multi_modal_gnn_tpu_torch.parallel.sharding import attach_shard_plans, graph_shard, shard_batch
from multi_modal_gnn_tpu_torch.training import EdgeMasker, Trainer
from test_torch_value_context import flax_variables

SPEC = dataclasses.asdict(JaxSpec.tiny(seed=5))
CASES = {  # name: (model settings, shard plans, against JAX DP)
    "rgcn": ({}, False, True),
    "vctx_plans": ({"value_context": True, "use_pallas": True}, True, True),
    "hgt": ({"architecture": "HGT"}, False, True),
    # every relation one-way (no mirror: K1's slot rows scattered back, JAX's
    # XLA-transposed backward of _sharded_total) and SGD with momentum
    "one_way_sgd_plans": ({"use_pallas": True}, True, True),
}
SECTIONS = {  # a case's other config sections
    "one_way_sgd_plans": {
        "graph": {"edge_types": {n: {"bidirectional": False} for n in ("patient_lab", "patient_diagnosis", "patient_medication")}},
        "train": {"optimizer": {"type": "sgd", "lr": 0.05, "momentum": 0.9}},
    },
}
SEED = 42
STEPS = 2


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


def _case_dict(name):
    def merge(into, fields):
        for key, value in fields.items():
            if isinstance(value, dict):
                merge(into[key], value)
            else:
                into[key] = value

    d = _config_dict(**CASES[name][0])
    merge(d, SECTIONS.get(name, {}))
    return d


def _jax_dp(d, plans, variables):
    """JAX's DP trainer from ``variables`` (the port's initial weights, in
    place of its own init), its state replicated on the mesh as its step
    returns it, so both steps run one compiled program."""
    jcfg = JaxConfig.from_dict(d)
    jbundle = make_synthetic_bundle(JaxSpec(**SPEC), jcfg)
    masker = JaxMasker(jbundle.graph, seed=SEED, host_edges=jbundle.patient_lab_host())
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), variables)
    with mock.patch.object(jax_dp_module, "init_model_variables", lambda *a: variables):
        jdp = JaxDP(jbundle.graph, masker, jcfg, mesh=make_mesh(2), host_edges=jbundle.host_edges if plans else None)
    jdp.state = jax.device_put(jdp.state, NamedSharding(jdp.mesh, P()))
    return jdp


@pytest.fixture(scope="module")
def runs():
    """The port's DP on 2 ranks, started first; meanwhile JAX DP and the
    port's single process in this process, then JAX's per-shard totals:
    each case's 2 injected steps from one set of initial weights."""
    jobs, states, masks_of = {"cases": {}}, {}, {}
    rng = np.random.default_rng(0)
    for name, (model, plans, _) in CASES.items():
        d = _case_dict(name)
        bundle = torch_dp_ranks.port_bundle(SPEC, d)
        init = torch_dp_ranks.build_model(
            Config.from_dict(d), bundle.graph, device="cpu", generator=torch.Generator().manual_seed(1)
        )
        states[name] = torch_dp_ranks.numpy_state(init)
        valid = EdgeMasker(bundle.graph, seed=SEED).get_split("train").valid.numpy()
        masks_of[name] = [((rng.random(valid.shape[0]) < 0.3) * valid).astype(np.float32) for _ in range(STEPS)]
        jobs["cases"][name] = dict(spec=SPEC, config=d, seed=SEED, state=states[name], masks=masks_of[name], plans=plans)
    d = _config_dict(use_pallas=True)
    jbundle = make_synthetic_bundle(JaxSpec(**SPEC), JaxConfig.from_dict(d))
    es = jbundle.graph.edges[PATIENT_LAB]
    x = rng.normal(size=(es.num_src, 32)).astype(np.float32)
    w = rng.normal(size=(es.num_dst, 32)).astype(np.float32)
    jobs["aggregate"] = dict(spec=SPEC, config=d, edge_type=list(PATIENT_LAB), x=x, w=w)
    ranks = Ranks(torch_dp_ranks.parallel_checks, 2, (jobs,))

    jax_out, single = {}, {}
    for name, (model, plans, against_jax) in CASES.items():
        d = _case_dict(name)
        cfg = Config.from_dict(d)
        bundle = torch_dp_ranks.port_bundle(SPEC, d)
        trainer = Trainer(
            torch_dp_ranks.model_with(cfg, bundle.graph, states[name]), bundle.graph,
            EdgeMasker(bundle.graph, seed=SEED), cfg, device="cpu",
        )
        if against_jax:
            jdp = _jax_dp(d, plans, flax_variables(trainer.model))
            batch = jdp._get_batch("train")
            losses = []
            for mask in masks_of[name]:
                jdp.state, loss = jdp._train_step(
                    jdp.state, jdp.graph, batch, jdp.lab_weights, jnp.asarray(mask), jax.random.key(0)
                )
                losses.append(float(loss))
            jax_out[name] = {
                "losses": losses,
                "state": state_dict_from_flax({"params": jdp.state.params, "batch_stats": jdp.state.batch_stats}),
            }
        tb = trainer.get_batch("train")
        single[name] = {
            "losses": [trainer.train_step(tb, torch.from_numpy(m), 0) for m in masks_of[name]],
            "val": trainer.validate("val"), "test_preds": trainer.predict("test"),
            "state": torch_dp_ranks.numpy_state(trainer.model),
        }
    totals = _jax_totals(jbundle, x, w)
    return dict(ranks=ranks.join(600), jax=jax_out, single=single, jbundle=jbundle, x=x, w=w, totals=totals)


# -- the plans -----------------------------------------------------------------


@pytest.mark.parametrize(
    "edges, num_dst, shards",
    [(5000, 700, 2), (5000, 700, 3), (20000, 3000, 4), (3, 300, 8), (1, 50, 4), (0, 40, 2)],
    ids=["2", "3", "4", "empty_shards", "one_edge", "no_edge"],
)
def test_sharded_window_plans_match_jax(edges, num_dst, shards):
    rng = np.random.default_rng(edges + shards)
    dst = np.sort(rng.integers(0, num_dst, edges)).astype(np.int32)
    src = rng.integers(0, 999, edges).astype(np.int32)
    want = jax_plans(src, dst, num_dst, shards)
    got = build_sharded_window_plans(src, dst, num_dst, shards)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[4] == want[4]
    per_shard = len(got[0]) // shards
    assert len(got[0]) == per_shard * shards and len(got[2]) * 1024 == len(got[0])
    if edges < shards:  # an empty shard: all padding, at offset 0
        assert (got[1][-per_shard:] == 128).all() and got[3][-1] == 0


def test_attach_shard_plans_match_jax():
    d = _config_dict()
    jbundle = make_synthetic_bundle(JaxSpec(**SPEC), JaxConfig.from_dict(d))
    bundle = torch_dp_ranks.port_bundle(SPEC, d)
    want = jax_attach(jbundle.graph, jbundle.host_edges, 2)
    got = attach_shard_plans(bundle.graph, bundle.host_edges, 2)
    for et, jes in want.edges.items():
        es = got.edges[et]
        assert es.shard_win_windows == jes.shard_win_windows > 0, et
        for name in ("shard_win_src", "shard_win_local", "shard_win_tile_map", "shard_win_offset"):
            np.testing.assert_array_equal(getattr(es, name).numpy(), np.asarray(getattr(jes, name)), err_msg=f"{et} {name}")


def test_graph_shard_cuts_every_relation():
    bundle = torch_dp_ranks.port_bundle(SPEC, _config_dict())
    graph = attach_shard_plans(bundle.graph, bundle.host_edges, 2)
    for et, es in graph.edges.items():
        chunk = es.src.shape[0] // 2
        parts = [graph_shard(graph, r, 2).edges[et] for r in range(2)]
        for r, part in enumerate(parts):
            for name in ("src", "dst", "mask"):
                np.testing.assert_array_equal(getattr(part, name).numpy(), getattr(es, name)[r * chunk : (r + 1) * chunk].numpy())
            np.testing.assert_array_equal(part.dst_count.numpy(), es.dst_count.numpy())
            # the chunk's own CSR: each destination's edges of this chunk
            counts = np.bincount(part.dst[: part.num_valid].numpy(), minlength=es.num_dst)
            np.testing.assert_array_equal(np.diff(part.row_ptr.numpy()), counts)
            assert part.win_src is None and part.dense_adj is None and part.shard_win_first == int(es.shard_win_offset[r])
        assert sum(p.num_valid for p in parts) == es.num_valid


# -- the per-shard total -----------------------------------------------------


def _jax_totals(jbundle, x, w):
    """JAX's per-shard total (K1 in interpret mode) and its mirror-plan
    gradient on a 2-device mesh, for ``mean`` and ``sum``."""
    mesh = make_mesh(2)
    g = jax_shard_graph(jbundle.graph, mesh, host_edges=jbundle.host_edges)
    rev = mirror_edge_type(PATIENT_LAB)

    def body(graph, xr):
        es = graph.edges[PATIENT_LAB]
        both = [jax_aggregate(xr, es, agg, impl="pallas", axis_name="data", edges_rev=graph.edges[rev])
                for agg in ("mean", "sum")]
        grads = [jax.grad(lambda xv, a=agg: jnp.sum(
            jax_aggregate(xv, es, a, impl="pallas", axis_name="data", edges_rev=graph.edges[rev]) * w))(xr)
            for agg in ("mean", "sum")]
        return both, grads

    totals, grads = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(graph_pspecs(g), P()), out_specs=P()))(g, x)
    return {agg: (np.asarray(t), np.asarray(d)) for agg, t, d in zip(("mean", "sum"), totals, grads)}


@pytest.mark.parametrize("agg", ["mean", "sum"])
def test_sharded_total_matches_jax(runs, agg):
    want_total, want_grad = runs["totals"][agg]
    for rank in runs["ranks"]:
        total, grad = rank["aggregate"][agg]
        np.testing.assert_allclose(total, want_total, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(grad, want_grad, rtol=2e-4, atol=2e-4)
    # and the plain segment sum of one process
    jes = runs["jbundle"].graph.edges[PATIENT_LAB]
    np.testing.assert_allclose(want_total, np.asarray(jax_aggregate(runs["x"], jes, agg, impl="xla")), rtol=2e-4, atol=2e-4)


def test_sharded_max_matches_one_process(runs):
    """``max`` over edge shards (the segment path, an all-reduce MAX)
    against the port's one-process ``max`` aggregation, and its gradient
    summed over the ranks against one process's."""
    from multi_modal_gnn_tpu_torch.ops.segment import aggregate_neighbors

    es = torch_dp_ranks.port_bundle(SPEC, _config_dict()).graph.edges[PATIENT_LAB]
    x = torch.from_numpy(runs["x"]).requires_grad_(True)
    want = aggregate_neighbors(x, es, "max")
    want.backward(torch.from_numpy(runs["w"]))
    for rank in runs["ranks"]:
        total, grad = rank["aggregate"]["max"]
        np.testing.assert_allclose(total, want.detach().numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(grad, x.grad.numpy(), rtol=1e-6, atol=1e-6)


def test_rank_plans_are_jax_chunks(runs):
    g = jax_attach(runs["jbundle"].graph, runs["jbundle"].host_edges, 2).edges[PATIENT_LAB]
    for r, rank in enumerate(runs["ranks"]):
        plan = rank["aggregate"]["plan"]
        assert rank["rank"] == r and plan["first"] == int(g.shard_win_offset[r])
        for name in ("shard_win_src", "shard_win_local", "shard_win_tile_map"):
            whole = np.asarray(getattr(g, name))
            np.testing.assert_array_equal(plan[name], np.split(whole, 2)[r], err_msg=name)


# -- training --------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_dp_steps_match_jax_and_one_process(runs, name):
    rtol = 1e-3 if CASES[name][1] else 2e-4
    port = runs["ranks"][0]["cases"][name]
    assert port["shard_plans"] == CASES[name][1]
    np.testing.assert_allclose(port["losses"], runs["single"][name]["losses"], rtol=rtol)
    np.testing.assert_allclose(port["val"], runs["single"][name]["val"], rtol=rtol)
    wants = [runs["single"][name]["state"]]
    if CASES[name][2]:
        np.testing.assert_allclose(port["losses"], runs["jax"][name]["losses"], rtol=rtol)
        wants.append({k: v.numpy() for k, v in runs["jax"][name]["state"].items()})
    for want in wants:
        for key, value in want.items():
            if not key.endswith("num_batches_tracked"):
                np.testing.assert_allclose(port["state"][key], value, rtol=5e-4, atol=4e-4, err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_predictions_in_split_order(runs, name):
    port = runs["ranks"][0]["cases"][name]["test_preds"]
    np.testing.assert_allclose(port, runs["single"][name]["test_preds"], rtol=2e-3, atol=2e-4)


def test_ranks_hold_one_state(runs):
    """Replicated parameters: both ranks end every case bit-equal, having
    each held half of every relation's edges."""
    a, b = (r["cases"] for r in runs["ranks"])
    for name in CASES:
        assert a[name]["losses"] == b[name]["losses"]
        for key, value in a[name]["state"].items():
            np.testing.assert_array_equal(value, b[name]["state"][key], err_msg=f"{name} {key}")
        np.testing.assert_array_equal(a[name]["test_preds"], b[name]["test_preds"])
        assert not any(a[name]["launches"].values())  # the CPU runs the plain versions


# -- routes and refusals ------------------------------------------------------


@pytest.mark.parametrize("mode", ["2d", "dp2d", "gspmd"])
def test_2d_modes_name_item_8b(mode):
    """The 2-D modes of ROADMAP item 8b: ``2d`` and ``dp2d`` are accepted
    with ``model_parallel``; ``gspmd`` is refused, naming item 8c."""
    from multi_modal_gnn_tpu_torch.training.trainer import parallel_mode

    if mode == "gspmd":
        with pytest.raises(ConfigError, match="item 8c"):
            Config.from_dict({"train": {"extras": {"parallel": mode, "model_parallel": 2}}})
        return
    cfg = Config.from_dict({"train": {"extras": {"parallel": mode, "model_parallel": 2}}})
    assert parallel_mode(cfg) == mode and cfg.train.extras["model_parallel"] == 2
    with pytest.raises(ConfigError, match="model_parallel must be a positive integer"):
        Config.from_dict({"train": {"extras": {"parallel": mode, "model_parallel": 0}}})


def test_indivisible_batch_and_rank_count_are_refused():
    bundle = torch_dp_ranks.port_bundle(SPEC, _config_dict())
    batch = EdgeMasker(bundle.graph, seed=SEED).get_split("train")
    n = batch.valid.shape[0]
    size = next(k for k in (3, 5, 7, 11) if n % k)
    with pytest.raises(ValueError, match=f"Batch padding {n} not divisible by mesh size {size}"):
        shard_batch(batch, DataAxis(rank=0, size=size))
    with pytest.raises(ValueError, match="Requested 2 devices, have 1"):
        init_axis(torch.device("cpu"), num_devices=2)


@pytest.mark.parametrize("clusters", [1, 2], ids=["full_batch", "clusters"])
def test_train_pipeline_routes_dp_on_one_rank(tmp_path, clusters):
    """``parallel: dp`` with ``WORLD_SIZE`` unset trains on one rank (JAX's
    one-device mesh), through the DP trainers, as the single process does."""
    from multi_modal_gnn_tpu_torch.training.trainer import train_pipeline

    d = _config_dict(use_pallas=True)
    d["train"].update(epochs=2, extras={"parallel": "dp", "num_clusters": clusters})
    bundle = torch_dp_ranks.port_bundle(SPEC, d)
    trainer, results = train_pipeline(Config.from_dict(d), bundle, tmp_path, device="cpu")
    assert type(trainer).__name__ == ("DataParallelTrainer" if clusters == 1 else "MiniBatchDPTrainer")
    assert trainer.axis.size == 1 and np.isfinite(results["test_loss"])
    assert (tmp_path / "best_model.ckpt").exists() and (tmp_path / "test_results.json").exists()
    d["train"]["extras"] = {"num_clusters": clusters}
    _, plain = train_pipeline(Config.from_dict(d), bundle, tmp_path / "one", device="cpu")
    np.testing.assert_allclose(results["test_loss"], plain["test_loss"], rtol=1e-3)


def test_dryrun_dp_over_two_ranks(capsys):
    from multi_modal_gnn_tpu_torch.tools import dryrun_dp

    assert dryrun_dp.main(["--ranks", "2", "--device", "cpu"]) == 0
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(lines) == 2 and all('"dryrun_dp": "ok"' in line and '"ranks": 2' in line for line in lines)
