"""What each gloo rank of the port's data-parallel CPU tests runs
(``tests/test_torch_parallel.py``, ``tests/test_torch_minibatch_dp.py``).

The ranks are spawned processes: this module imports the port only, so they
start without the JAX stack.  Each job takes plain inputs (config dicts,
numpy state dicts and masks) and returns numpy results, so the test process
compares them with JAX's and with the port's single process.
"""

from __future__ import annotations

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.models import build_model


def port_bundle(spec: dict, config_dict: dict):
    """The port's bundle of ``SyntheticSpec(**spec)``'s tables, as the
    tests' JAX side builds its own from the same tables."""
    from multi_modal_gnn_tpu_torch.config import Config
    from multi_modal_gnn_tpu_torch.data import SyntheticSpec
    from multi_modal_gnn_tpu_torch.data.synthetic import generate_synthetic_tables
    from multi_modal_gnn_tpu_torch.graph.build import build_heterogeneous_graph

    t = generate_synthetic_tables(SyntheticSpec(**spec))
    return build_heterogeneous_graph(
        t["labs_normalized"], t["diagnoses"], t["medications"], t["cohort"], t["labitems"],
        Config.from_dict(config_dict),
    )


def model_with(cfg, graph, state: dict):
    model = build_model(cfg, graph, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return model


def numpy_state(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _aggregate(job, axis) -> dict:
    """The per-shard total and its mirror-plan backward on one relation."""
    from multi_modal_gnn_tpu_torch.graph.schema import mirror_edge_type
    from multi_modal_gnn_tpu_torch.ops.segment import aggregate_neighbors
    from multi_modal_gnn_tpu_torch.parallel.collectives import all_reduce_
    from multi_modal_gnn_tpu_torch.parallel.sharding import shard_graph

    bundle = port_bundle(job["spec"], job["config"])
    graph = shard_graph(bundle.graph, axis, host_edges=bundle.host_edges)
    et = tuple(job["edge_type"])
    es, rev = graph.edges[et], graph.edges[mirror_edge_type(et)]
    out = {}
    for agg in ("mean", "sum"):
        x = torch.from_numpy(job["x"]).requires_grad_(True)
        total = aggregate_neighbors(x, es, agg, impl="pallas", edges_rev=rev, axis=axis)
        # the rank's share of the gradient of sum(total * w), then all shares
        total.backward(torch.from_numpy(job["w"]) / axis.size)
        out[agg] = (total.detach().numpy(), all_reduce_(x.grad.clone(), axis).numpy())
    # max has no kernel tier: the segment path on the rank's edges, an
    # all-reduce MAX, and the gradient to the rank that holds each maximum
    x = torch.from_numpy(job["x"]).requires_grad_(True)
    total = aggregate_neighbors(x, es, "max", impl="pallas", axis=axis)
    total.backward(torch.from_numpy(job["w"]) / axis.size)
    out["max"] = (total.detach().numpy(), all_reduce_(x.grad.clone(), axis).numpy())
    out["plan"] = {
        name: getattr(es, name).numpy() for name in ("shard_win_src", "shard_win_local", "shard_win_tile_map")
    }
    out["plan"]["first"] = es.shard_win_first
    return out


def _dp_case(case, axis) -> dict:
    """2 injected steps of the data-parallel trainer, from ``case["state"]``."""
    from multi_modal_gnn_tpu_torch.config import Config
    from multi_modal_gnn_tpu_torch.ops import segment_kernels
    from multi_modal_gnn_tpu_torch.parallel.dp import DataParallelTrainer
    from multi_modal_gnn_tpu_torch.parallel.sharding import shard_rows
    from multi_modal_gnn_tpu_torch.training import EdgeMasker

    cfg = Config.from_dict(case["config"])
    bundle = port_bundle(case["spec"], case["config"])
    graph = bundle.graph
    trainer = DataParallelTrainer(
        graph, EdgeMasker(graph, seed=case["seed"]), cfg, model=model_with(cfg, graph, case["state"]),
        axis=axis, device="cpu", host_edges=bundle.host_edges if case["plans"] else None,
    )
    batch = trainer.get_batch("train")
    losses = []
    for mask in case["masks"]:
        losses.append(trainer.train_step(batch, shard_rows(torch.from_numpy(mask), axis), 0))
    es = next(iter(trainer.graph.edges.values()))
    return {
        "losses": losses,
        "state": numpy_state(trainer.model),
        "val": trainer.validate("val"),
        "test_preds": trainer.predict("test"),
        "shard_plans": es.shard_win_src is not None,
        "edge_chunk": int(es.src.shape[0]),
        "launches": dict(segment_kernels.launch_counts),
    }


def parallel_checks(jobs: dict) -> dict:
    """Every check of ``tests/test_torch_parallel.py`` on this rank."""
    from multi_modal_gnn_tpu_torch.parallel.mesh import init_axis

    torch.set_num_threads(1)
    axis = init_axis(torch.device("cpu"))
    out = {"rank": axis.rank, "aggregate": _aggregate(jobs["aggregate"], axis)}
    out["cases"] = {name: _dp_case(case, axis) for name, case in jobs["cases"].items()}
    return out


def minibatch_checks(jobs: dict) -> dict:
    """Every check of ``tests/test_torch_minibatch_dp.py`` on this rank:
    ``epochs`` epochs of :class:`MiniBatchDPTrainer` per case, then its
    validation loss and test predictions."""
    from multi_modal_gnn_tpu_torch.config import Config
    from multi_modal_gnn_tpu_torch.parallel.mesh import init_axis
    from multi_modal_gnn_tpu_torch.parallel.minibatch_dp import MiniBatchDPTrainer
    from multi_modal_gnn_tpu_torch.training import EdgeMasker

    torch.set_num_threads(1)
    axis = init_axis(torch.device("cpu"))
    out = {}
    for name, case in jobs.items():
        cfg = Config.from_dict(case["config"])
        bundle = port_bundle(case["spec"], case["config"])
        trainer = MiniBatchDPTrainer(
            bundle, EdgeMasker(bundle.graph, seed=0), cfg, num_clusters=case["clusters"],
            model=model_with(cfg, bundle.graph, case["state"]), axis=axis,
            host_resident=case["host_resident"], device="cpu",
        )
        losses = [trainer.train_epoch() for _ in range(1)]
        for _ in range(case["epochs"] - 1):
            trainer.epoch += 1
            losses.append(trainer.train_epoch())
        cd = trainer._ensure_clusters()
        out[name] = {
            "losses": losses,
            "state": numpy_state(trainer.model),
            "val": trainer.validate("val"),
            "test_preds": trainer.predict("test"),
            "shard_plans": [g.edges[next(iter(g.edges))].shard_win_src is not None for g in cd.subgraphs],
            "pinned": [g.patient_lab_degree.device.type for g in cd.subgraphs],
        }
    return out


# -- the 2-D layout (tests/test_torch_dp2d.py) -------------------------------


def _wait_for(path: str, timeout: float = 300.0) -> None:
    import os
    import time

    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.1)


def table_state(trainer) -> dict:
    """This rank's rows of the patient table and of its optimizer state
    (Adam's moments, SGD's momentum buffer; one process: all rows)."""
    param = trainer.model.embed_patient.weight
    state = trainer.optimizer.state[param]
    out = {k: v.numpy().copy() for k, v in state.items() if k != "step"}
    out["weight"] = param.detach().numpy().copy()
    out["rows"] = getattr(trainer.model.embed_patient, "row_range", (0, param.shape[0]))
    return out


def _two_d(job, case, mesh, host_edges=True):
    from multi_modal_gnn_tpu_torch.config import Config
    from multi_modal_gnn_tpu_torch.parallel.dp2d import TwoDTrainer
    from multi_modal_gnn_tpu_torch.training import EdgeMasker

    cfg = Config.from_dict(case["config"])
    bundle = port_bundle(job["spec"], case["config"])
    model = model_with(cfg, bundle.graph, case["state"]) if "state" in case else None
    return TwoDTrainer(
        bundle.graph, EdgeMasker(bundle.graph, seed=job["seed"]), cfg, model=model, mesh=mesh, device="cpu",
        host_edges=bundle.host_edges if case.get("plans") else None,
    ), bundle


def two_d_checks(job: dict) -> dict:
    """Every check of ``tests/test_torch_dp2d.py`` on this rank of a
    ``2 x 2`` mesh: the cases' injected steps, a step with dropout, the
    sharded checkpoint written and JAX's restored (on the mesh and on a
    ``1 x 2`` sub-mesh), the warm start, serving from the DP and 2-D
    trainers, and ``train_pipeline`` with ``parallel: 2d``."""
    import torch.distributed as dist

    from multi_modal_gnn_tpu_torch.config import Config
    from multi_modal_gnn_tpu_torch.ops import segment_kernels
    from multi_modal_gnn_tpu_torch.parallel import collectives
    from multi_modal_gnn_tpu_torch.parallel.dp import DataParallelTrainer
    from multi_modal_gnn_tpu_torch.parallel.mesh import DataAxis, Mesh2D, init_2d_axes
    from multi_modal_gnn_tpu_torch.parallel.sharding import shard_rows
    from multi_modal_gnn_tpu_torch.serving import build_trainer_serving_fn, export_serving
    from multi_modal_gnn_tpu_torch.training import EdgeMasker
    from multi_modal_gnn_tpu_torch.training.trainer import train_pipeline
    from multi_modal_gnn_tpu_torch.training.warmstart import warm_start_trainer

    torch.set_num_threads(1)
    mesh = init_2d_axes(torch.device("cpu"), 0, 2)
    # every rank creates both 1 x 2 sub-meshes' groups, in one order
    r = mesh.world.rank
    halves = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    half = DataAxis(r % 2, 2, mesh.world.backend, halves[r // 2])
    sub = Mesh2D(data=DataAxis(), model=half, world=half)
    out = {"rank": r, "data": mesh.data.rank, "model": mesh.model.rank, "cases": {}}

    # the cases' injected steps, dropout 0
    for name, case in job["cases"].items():
        trainer, _ = _two_d(job, case, mesh)
        batch = trainer.get_batch("train")
        segment_kernels.reset_launch_counts()
        collectives.reset_stats()
        losses = []
        for i, mask in enumerate(case["masks"]):
            losses.append(trainer.train_step(batch, shard_rows(torch.from_numpy(mask), trainer.axis), 0))
            if i == 0:
                first = table_state(trainer)
                stats = {k: dict(v) for k, v in collectives.stats.items()}
        es = next(iter(trainer.graph.edges.values()))
        out["cases"][name] = {
            "losses": losses, "val": trainer.validate("val"), "test_preds": trainer.predict("test"),
            "state": numpy_state(trainer.model), "first": first, "stats": stats,
            "shard_plans": es.shard_win_src is not None, "launches": dict(segment_kernels.launch_counts),
        }
        if name == job["checkpoint_case"]:
            trainer.epoch = len(losses)
            trainer._save(job["port_ckpt"])
            out["ckpt_val"] = trainer.validate("val")

    # replicas across the model axis after steps with dropout
    case = job["dropout"]
    trainer, _ = _two_d(job, case, mesh)
    batch = trainer.get_batch("train")
    for i, mask in enumerate(case["masks"]):
        trainer._seeded_step(batch, shard_rows(torch.from_numpy(mask), trainer.axis), 100 + i)
    out["dropout"] = {
        "state": numpy_state(trainer.model),
        "adam": {n: {k: v.numpy().copy() for k, v in trainer.optimizer.state[p].items()}
                 for n, p in trainer.model.named_parameters()},
    }

    # JAX's 4 x 2 checkpoint into this 2 x 2 mesh and into a 1 x 2 sub-mesh
    _wait_for(job["jax_ckpt_done"])
    restored = {}
    for label, m in (("2x2", mesh), ("1x2", sub)):
        trainer, _ = _two_d(job, job["restore"], m)
        trainer.restore(job["jax_ckpt"])
        restored[label] = {"val": trainer.validate("val"), "rows": trainer.model.embed_patient.row_range,
                           "epoch": trainer.epoch}
    out["restored"] = restored

    # the warm start plants each rank's rows
    trainer, _ = _two_d(job, job["warm"], mesh)
    warm_start_trainer(trainer, rank=4, reg=3.0)
    out["warm_val"] = trainer.best_val_loss
    out["warm_step"] = len(trainer.optimizer.state)

    # serving straight from the DP (4 ranks) and 2-D trainers after 3 epochs
    case = job["serving"]
    cfg = Config.from_dict(case["config"])
    bundle = port_bundle(job["spec"], case["config"])
    p_idx, l_idx = case["pairs"]
    dp = DataParallelTrainer(
        bundle.graph, EdgeMasker(bundle.graph, seed=job["seed"]), cfg, model=model_with(cfg, bundle.graph, case["state"]),
        axis=mesh.world, device="cpu",
    )
    two_d, _ = _two_d(job, case, mesh)
    served = {}
    for label, t in (("dp", dp), ("2d", two_d)):
        for _ in range(3):
            t.train_epoch()
            t.epoch += 1
        fn, _ = build_trainer_serving_fn(t)
        served[label] = fn(p_idx, l_idx).numpy()
    export_serving(dp, bundle, job["export_dir"])
    out["served"] = served

    # train_pipeline routes parallel: 2d
    case = job["pipeline"]
    trainer, results = train_pipeline(
        Config.from_dict(case["config"]), port_bundle(job["spec"], case["config"]), case["out"], device="cpu"
    )
    es = next(iter(trainer.graph.edges.values()))
    out["pipeline"] = {
        "type": type(trainer).__name__, "shard_plans": es.shard_win_src is not None, "test_loss": results["test_loss"],
        "table_rows": trainer.model.embed_patient.weight.shape[0], "moments": trainer.optimizer.state[
            trainer.model.embed_patient.weight]["exp_avg"].shape[0],
    }
    return out
