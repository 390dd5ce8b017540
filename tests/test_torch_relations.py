"""PyTorch port: one-way and disabled relations (``graph.edge_types.<name>.
bidirectional: false`` / ``enabled: false``) against the JAX package, on the
CPU.

Both packages build the graph from the same generated tables (numpy seed in
the spec); hidden 32, dropout 0, ``use_pallas: true``:

* the configs (one-way, diagnosis disabled, other ``node_types``, SGD with
  and without momentum): ``to_dict`` and both hashes equal JAX's;
* graph builds, everything one-way, diagnosis disabled, medication
  disabled: relation sets, node counts, every edge set's arrays and plans
  and the host metadata equal JAX's field for field (the bundle build and
  ``assemble_graph``), so do the statistics, ``graph.npz`` in both
  directions and the sharded artifact (2 shards, kernel plans); a disabled
  ``patient_lab`` raises as JAX does;
* the tiers: with 2,500 patients (past the fused-table tier's 2,048 rows) a
  one-way patient-source relation takes the ``windowed`` tier (K1 forward,
  its slot rows scattered back) where its mirror is gone;
* one train step on weights carried across from JAX (the RGCN one-way and
  diagnosis-disabled, the HGT one-way on its flash plans): loss ``rtol
  1e-5``, parameters ``atol 4e-4``, BatchNorm statistics ``1e-5`` (f32 sums
  in another order, ``tests/test_torch_training.py``); a type that receives
  no relation leaves a layer as it came in;
* Cluster-GCN subgraphs of a one-way graph equal JAX's (JAX builds each
  cluster's reverse relations whatever the config says);
* the value context, which reads only the forward ``patient_lab``, on a
  graph where that relation is one-way: forward ``1e-5`` of JAX;
* the side-information memberships with one side relation disabled equal
  JAX's; with both disabled both packages raise;
* a JAX checkpoint of the diagnosis-disabled model restores into the port,
  and the port's sharded file into JAX; the serving artifact answers within
  ``1e-5`` of eager, its manifest's keys as JAX's artifact of the same
  weights has them.
"""

import copy
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.graph import build as jax_build
from multi_modal_gnn_tpu.graph.attn_plan import build_attn_plans as jax_build_attn_plans
from multi_modal_gnn_tpu.graph.distributed import save_graph_sharded as jax_save_sharded
from multi_modal_gnn_tpu.graph.serialize import load_graph as jax_load_graph
from multi_modal_gnn_tpu.graph.serialize import save_graph as jax_save_graph
from multi_modal_gnn_tpu.graph.stats import compute_graph_statistics as jax_stats
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.models.factory import init_model_variables
from multi_modal_gnn_tpu.serving import export_serving as jax_export_serving
from multi_modal_gnn_tpu.training import minibatch as jax_minibatch
from multi_modal_gnn_tpu.training import warmstart as jax_warmstart
from multi_modal_gnn_tpu.training.checkpoint import load_checkpoint_sharded
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxEdgeMasker
from multi_modal_gnn_tpu.training.trainer import Trainer as JaxTrainer
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import (
    SyntheticSpec,
    generate_synthetic_edges,
    generate_synthetic_tables,
    make_synthetic_graph,
)
from multi_modal_gnn_tpu_torch.graph import build_heterogeneous_graph
from multi_modal_gnn_tpu_torch.graph.attn_plan import build_attn_plans, ensure_attn_plans
from multi_modal_gnn_tpu_torch.graph.build import assemble_graph
from multi_modal_gnn_tpu_torch.graph.distributed import attach_relation_plans, load_graph_distributed, save_graph_sharded
from multi_modal_gnn_tpu_torch.graph.schema import (
    DIAGNOSIS,
    PATIENT,
    PATIENT_DIAGNOSIS,
    PATIENT_LAB,
    PATIENT_MEDICATION,
    mirror_edge_type,
)
from multi_modal_gnn_tpu_torch.graph.serialize import load_bundle, save_graph
from multi_modal_gnn_tpu_torch.graph.stats import compute_graph_statistics, validate_graph
from multi_modal_gnn_tpu_torch.models import build_model, state_dict_from_flax
from multi_modal_gnn_tpu_torch.ops.segment import aggregation_tier
from multi_modal_gnn_tpu_torch.parallel.sharding import graph_shard
from multi_modal_gnn_tpu_torch.serving import ServingModel, build_trainer_serving_fn, export_serving
from multi_modal_gnn_tpu_torch.training import EdgeMasker, Trainer, minibatch
from multi_modal_gnn_tpu_torch.training.checkpoint import (
    _find_optimizer,
    jax_state_leaves,
    optimizer_kind,
    optimizer_state_by_name,
    save_sharded_checkpoint,
)
from multi_modal_gnn_tpu_torch.training.warmstart import bundle_membership_matrix
from test_torch_attention import assert_plans_equal
from test_torch_minibatch import _assert_clusters_equal
from test_torch_plans import assert_graphs_equal
from test_torch_value_context import flax_variables

# 2,500 patients: the patient table passes the fused-table tier's 2,048 rows
SPEC = dict(
    num_patients=2500, num_labs=30, num_diagnoses=20, num_medications=15,
    mean_labs_per_patient=6.0, mean_diagnoses_per_patient=2.0,
    mean_medications_per_patient=2.0, latent_dim=4, seed=11,
)
SMALL = dict(SPEC, num_patients=300)
VARIANTS = {  # name: graph.edge_types overrides
    "one_way": {n: {"bidirectional": False} for n in ("patient_lab", "patient_diagnosis", "patient_medication")},
    "dx_off": {"patient_diagnosis": {"enabled": False}},
    "rx_off": {"patient_medication": {"enabled": False}},
}
STEP_TOL = 4e-4  # parameters after one Adam step (tests/test_torch_training.py)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config_dict(variant, **model):
    d = JaxConfig().to_dict()
    for name, fields in VARIANTS[variant].items():
        d["graph"]["edge_types"][name].update(fields)
    d["graph"]["dense_adjacency_max_bytes"] = 0
    d["model"].update(hidden_dim=32, dropout=0.0, use_pallas=True, **model)
    d["train"].update(donate_state=False)
    return d


def _bundles(d, spec=SPEC):
    """JAX's and the port's bundles of the same tables."""
    t = generate_synthetic_tables(SyntheticSpec(**spec))
    port = build_heterogeneous_graph(
        t["labs_normalized"], t["diagnoses"], t["medications"], t["cohort"], t["labitems"], Config.from_dict(d)
    )
    return make_synthetic_bundle(JaxSpec(**spec), JaxConfig.from_dict(d)), port


@pytest.fixture(scope="module")
def rgcn():
    """Per variant: both bundles, the port's trainer on random weights and a
    JAX trainer on the same weights, both before any step."""
    out = {}
    for variant in ("one_way", "dx_off"):
        d = _config_dict(variant, head_style="factored")
        jbundle, bundle = _bundles(d)
        cfg, jcfg = Config.from_dict(d), JaxConfig.from_dict(d)
        jmodel = jax_build_model(jcfg, jbundle.graph)
        variables = init_model_variables(jmodel, jbundle.graph, jax.random.PRNGKey(0))
        model = build_model(cfg, bundle.graph, device="cpu")
        model.load_state_dict(state_dict_from_flax(variables), strict=True)
        jtrainer = JaxTrainer(jmodel, jbundle.graph, JaxEdgeMasker(jbundle.graph, seed=4), jcfg, variables=variables)
        trainer = Trainer(model, bundle.graph, EdgeMasker(bundle.graph, seed=4), cfg, device="cpu")
        out[variant] = dict(d=d, jbundle=jbundle, bundle=bundle, trainer=trainer, jtrainer=jtrainer)
    return out


# -- the config ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["one_way", "dx_off", "node_types", "sgd", "sgd_no_momentum"])
def test_config_dict_and_hashes_equal_jax(case):
    if case in VARIANTS:
        d = _config_dict(case)
    else:
        d = JaxConfig().to_dict()
        if case == "node_types":
            d["graph"]["node_types"] = ["patient", "lab"]  # read by nothing, in either package
        else:
            d["train"]["optimizer"].update(type="sgd", momentum=0.0 if case == "sgd_no_momentum" else 0.5)
    jcfg, cfg = JaxConfig.from_dict(d), Config.from_dict(d)
    assert cfg.to_dict() == jcfg.to_dict()
    assert (cfg.content_hash(), cfg.model_hash()) == (jcfg.content_hash(), jcfg.model_hash())
    assert Config.from_dict(cfg.to_dict()) == cfg


# -- the graph build -------------------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_graph_builds_equal_jax(variant):
    d = _config_dict(variant)
    jbundle, bundle = _bundles(d, SMALL)
    assert_graphs_equal(bundle.graph, jbundle.graph)
    assert bundle.meta.to_dict()["indexers"] == json.loads(json.dumps(jbundle.meta.to_dict()["indexers"]))
    assert set(bundle.host_edges) == set(bundle.graph.edges)
    for et, (src, dst, val) in jbundle.host_edges.items():
        np.testing.assert_array_equal(bundle.host_edges[et][0], src)
        np.testing.assert_array_equal(bundle.host_edges[et][1], dst)
    validate_graph(bundle.graph)
    assert compute_graph_statistics(bundle.graph) == jax_stats(jbundle.graph)
    # make_synthetic_graph drops as the bundle build does
    assert_graphs_equal(make_synthetic_graph(SyntheticSpec(**SMALL), Config.from_dict(d), device="cpu"), jbundle.graph)
    # assemble_graph skips a disabled relation and keeps its node count
    edge_arrays, node_counts = generate_synthetic_edges(SyntheticSpec(**SMALL))
    jcfg = JaxConfig.from_dict(d)
    assert_graphs_equal(
        assemble_graph(edge_arrays, node_counts, Config.from_dict(d)),
        jax_build.assemble_graph(edge_arrays, node_counts, config=jcfg),
    )
    forward = {"one_way": 3, "dx_off": 2, "rx_off": 2}[variant]
    assert sum(not et[1].startswith("rev_") for et in bundle.graph.edge_types) == forward
    if variant == "one_way":
        assert all(mirror_edge_type(et) not in bundle.graph.edges for et in bundle.graph.edge_types)
    else:
        dropped = DIAGNOSIS if variant == "dx_off" else "medication"
        assert dropped not in bundle.graph.node_count_map
        assert dropped in bundle.meta.indexers  # JAX keeps the indexer


def test_disabled_patient_lab_raises_as_jax():
    d = JaxConfig().to_dict()
    d["graph"]["edge_types"]["patient_lab"]["enabled"] = False
    with pytest.raises(ValueError) as want:
        make_synthetic_bundle(JaxSpec(**dict(SMALL, num_patients=50)), JaxConfig.from_dict(d))
    t = generate_synthetic_tables(SyntheticSpec(**dict(SMALL, num_patients=50)))
    with pytest.raises(ValueError) as got:
        build_heterogeneous_graph(
            t["labs_normalized"], t["diagnoses"], t["medications"], t["cohort"], t["labitems"], Config.from_dict(d)
        )
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("variant", ["one_way", "dx_off"])
def test_graph_npz_reads_across_packages(tmp_path, variant):
    d = _config_dict(variant)
    jbundle, bundle = _bundles(d, SMALL)
    save_graph(bundle, tmp_path / "port" / "graph")
    jax_save_graph(jbundle, tmp_path / "jax" / "graph")
    with np.load(tmp_path / "port" / "graph.npz") as ours, np.load(tmp_path / "jax" / "graph.npz") as theirs:
        assert ours.files == theirs.files
        for key in theirs.files:
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    assert_graphs_equal(load_bundle(tmp_path / "jax" / "graph", device="cpu").graph, jbundle.graph)
    jax_reads = jax_load_graph(tmp_path / "port" / "graph.npz")
    assert jax_reads.graph.edge_types == jbundle.graph.edge_types
    assert jax_reads.graph.node_counts == jbundle.graph.node_counts


@pytest.mark.parametrize("variant", ["one_way", "dx_off"])
def test_sharded_artifact_with_fewer_relations(tmp_path, variant):
    jbundle, bundle = _bundles(_config_dict(variant), SMALL)
    jbase = jax_save_sharded(jbundle, tmp_path / "jax" / "graph", num_shards=2, kernel_plans=True)
    base = save_graph_sharded(bundle, tmp_path / "port" / "graph", num_shards=2, kernel_plans=True)
    for name in ["common"] + [f"shard{k:03d}-of-002" for k in range(2)]:
        with np.load(f"{base}.{name}.npz") as got, np.load(f"{jbase}.{name}.npz") as want:
            assert sorted(got.files) == sorted(want.files), name
            for key in want.files:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
    planned = attach_relation_plans(bundle.graph, 2)
    for rank in range(2):
        loaded = load_graph_distributed(jbase, rank, 2).graph
        assert set(loaded.edges) == set(bundle.graph.edges)
        for et, es in graph_shard(planned, rank, 2).edges.items():
            for name in ("src", "dst", "shard_win_src", "shard_win_local", "shard_win_tile_map"):
                np.testing.assert_array_equal(getattr(loaded.edges[et], name).numpy(), getattr(es, name).numpy())


def test_one_way_relations_take_the_windowed_tier(rgcn):
    graph = rgcn["one_way"]["bundle"].graph
    tiers = {et: aggregation_tier(es, graph.edges.get(mirror_edge_type(et)), 32) for et, es in graph.edges.items()}
    # the 2,500-row patient table is past the fused-table gates and no mirror plan remains
    assert tiers == {PATIENT_LAB: "windowed", PATIENT_DIAGNOSIS: "windowed", PATIENT_MEDICATION: "windowed"}
    graph = rgcn["dx_off"]["bundle"].graph
    assert aggregation_tier(graph.edges[PATIENT_LAB], graph.edges[mirror_edge_type(PATIENT_LAB)], 32) != "windowed"


# -- the models ------------------------------------------------------------------


def _sup(batch, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random(batch.valid.shape[0]) < 0.4).astype(np.float32) * batch.valid.numpy()


def _away_from_kinks(trainer, batch, sup, margin=1e-5):
    """``sup`` without the slots whose head pre-activations lie within
    ``margin`` of a ReLU's kink: the two packages sum in other orders, so
    such a unit may take the other side in each and its slot's gradient
    then differs by a whole term (as ``pairhead_kernels.relu_margin_plain``
    keeps such slots out of the kernels' backward checks).  A copy of the
    model runs the forward, so the BatchNorm statistics stay as they are."""
    model, seen = copy.deepcopy(trainer.model).train(), []
    relu = torch.nn.functional.relu

    def spy(x, *args, **kwargs):
        if x.dim() == 2 and x.shape[0] == sup.shape[0]:
            seen.append(x.detach().abs().amin(dim=1))
        return relu(x, *args, **kwargs)

    with torch.no_grad(), mock.patch.object(torch.nn.functional, "relu", spy):
        model.predict_lab_values(
            trainer.graph, batch.patient_idx, batch.lab_idx, train=True, patient_plan=batch.patient_plan,
            lab_plan=batch.lab_plan, degrees=batch.degrees, dropout_seed=0,
        )
    assert seen  # the heads' per-slot layers
    keep = torch.stack(seen).amin(dim=0).numpy() > margin
    assert keep[sup > 0].mean() > 0.95
    return sup * keep


def _step_both(trainer, jtrainer, jgraph, sup):
    jbatch, batch = jtrainer._get_batch("train"), trainer.get_batch("train")
    copy = lambda s: jax.tree_util.tree_map(jnp.array, s)  # noqa: E731 (donation)
    jstate, jloss = jtrainer._train_step(
        copy(jtrainer.state), jgraph, jbatch, jtrainer.lab_weights, jnp.asarray(sup), jax.random.key(7)
    )
    jstate = jax.block_until_ready(jstate)
    loss = trainer.train_step(batch, torch.from_numpy(sup), 0)
    return loss, float(jloss), jstate


def _assert_state_close(trainer, jstate):
    """The step's gradients (Adam's first moment over ``1 - beta1``, both
    sides) within ``rtol 1e-4`` and a floor of ``1e-5`` of the largest, then
    the parameters within ``STEP_TOL``.  Under the floor lie the gradients
    that are 0 in exact arithmetic (biases feeding a BatchNorm): Adam's
    first step normalizes their rounding noise to steps of up to ``lr``,
    so those elements are held to ``2 lr`` (``PERF.md`` §2, phase 8)."""
    model, lr = trainer.model, trainer.optimizer.param_groups[0]["lr"]
    _, adam = _find_optimizer(serialization.to_state_dict(jstate.opt_state))
    jgrad = {
        k: v.numpy() / 0.1 for k, v in state_dict_from_flax({"params": adam["mu"]}).items()
        if not k.endswith("num_batches_tracked")
    }
    grad = {k: v["exp_avg"].numpy() / 0.1 for k, v in optimizer_state_by_name(model, trainer.optimizer).items()}
    floor = 1e-5 * max(np.abs(g).max() for g in jgrad.values())
    assert set(grad) == set(jgrad)
    for key, value in jgrad.items():
        np.testing.assert_allclose(grad[key], value, rtol=1e-4, atol=floor, err_msg=key)
    want = state_dict_from_flax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    got = model.state_dict()
    assert set(want) == set(got)
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), atol=1e-5, err_msg=key)
            continue
        noise = np.abs(jgrad[key]) <= floor
        g, w = got[key].numpy(), value.numpy()
        np.testing.assert_allclose(g[~noise], w[~noise], atol=STEP_TOL, err_msg=key)
        np.testing.assert_allclose(g[noise], w[noise], atol=2 * lr, err_msg=key)


@pytest.mark.parametrize("variant", ["one_way", "dx_off"])
def test_rgcn_step_matches_jax(rgcn, variant):
    r = rgcn[variant]
    trainer, jtrainer = r["trainer"], r["jtrainer"]
    model = trainer.model
    if variant == "one_way":
        # the patient type receives nothing: each layer hands it on as it came
        x = {nt: torch.randn(n, 32) for nt, n in trainer.graph.node_counts}
        assert model.conv_0(x, trainer.graph)[PATIENT] is x[PATIENT]
    else:
        assert not any(name.startswith(f"embed_{DIAGNOSIS}") for name, _ in model.named_parameters())
    batch = trainer.get_batch("train")
    sup = _away_from_kinks(trainer, batch, _sup(batch))
    loss, jloss, jstate = _step_both(trainer, jtrainer, r["jbundle"].graph, sup)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_state_close(trainer, jstate)


def test_hgt_step_matches_jax_one_way():
    d = _config_dict("one_way", architecture="HGT", num_heads=4)
    d["model"]["edge_head"]["hidden_dims"] = [16, 8]
    jbundle, bundle = _bundles(d, SMALL)
    cfg, jcfg = Config.from_dict(d), JaxConfig.from_dict(d)
    jgraph = jbundle.graph.replace(attn_plans=jax_build_attn_plans(jbundle.graph, jbundle.host_edges))
    plans = build_attn_plans(bundle.graph)
    assert set(plans) == set(jgraph.attn_plans) == {"lab", DIAGNOSIS, "medication"}  # no patient group
    for dst_t, group in jgraph.attn_plans.items():
        assert_plans_equal(plans[dst_t], group)
    graph = ensure_attn_plans(bundle.graph, cfg)
    model = build_model(cfg, graph, device="cpu", generator=torch.Generator().manual_seed(0))
    assert not hasattr(model.hgt_0, "q_patient") and not hasattr(model.hgt_0, "out_patient")
    x = {nt: torch.randn(n, 32) for nt, n in graph.node_counts}
    assert model.hgt_0(x, graph)[PATIENT] is x[PATIENT]
    jtrainer = JaxTrainer(
        jax_build_model(jcfg, jgraph), jgraph, JaxEdgeMasker(jgraph, seed=4), jcfg,
        variables=jax.tree_util.tree_map(jnp.asarray, flax_variables(model)),
    )
    trainer = Trainer(model, graph, EdgeMasker(graph, seed=4), cfg, device="cpu")
    assert {model.hgt_0.tier(trainer.graph, nt) for nt in model.hgt_0.groups()} == {"flash"}
    loss, jloss, jstate = _step_both(trainer, jtrainer, jgraph, _sup(trainer.get_batch("train")))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_state_close(trainer, jstate)


def test_value_context_on_a_one_way_patient_lab():
    d = _config_dict("one_way", value_context=True)
    jbundle, bundle = _bundles(d, SMALL)
    cfg, jcfg = Config.from_dict(d), JaxConfig.from_dict(d)
    model = build_model(cfg, bundle.graph, device="cpu", generator=torch.Generator().manual_seed(0))
    jtrainer = JaxTrainer(
        jax_build_model(jcfg, jbundle.graph), jbundle.graph,
        JaxEdgeMasker(jbundle.graph, seed=4, host_edges=jbundle.patient_lab_host()), jcfg,
        variables=jax.tree_util.tree_map(jnp.asarray, flax_variables(model)), eval_only=True,
    )
    trainer = Trainer(model, bundle.graph, EdgeMasker(bundle.graph, seed=4), cfg, device="cpu")
    np.testing.assert_allclose(trainer.predict("val"), np.asarray(jtrainer.predict("val")), rtol=1e-5, atol=1e-5)


# -- clusters, memberships, checkpoints, serving -----------------------------------


def test_clusters_of_a_one_way_graph_equal_jax():
    d = _config_dict("one_way")
    jbundle, bundle = _bundles(d, SMALL)
    kw = dict(num_clusters=3, lab_weights=np.ones(SMALL["num_labs"], np.float32))
    jcd = jax_minibatch.build_patient_clusters(
        jbundle, JaxEdgeMasker(jbundle.graph, seed=0, host_edges=jbundle.patient_lab_host()),
        JaxConfig.from_dict(d), **kw,
    )
    cd = minibatch.build_patient_clusters(bundle, EdgeMasker(bundle.graph, seed=0), Config.from_dict(d), **kw)
    _assert_clusters_equal(cd, jcd)
    # JAX's rule: every cluster carries the reverse relations
    assert len(cd.subgraphs[0].edge_types) == 6


@pytest.mark.parametrize("off", [("patient_diagnosis",), ("patient_medication",), ("patient_diagnosis", "patient_medication")])
def test_side_memberships_with_a_relation_disabled(off):
    d = JaxConfig().to_dict()
    for name in off:
        d["graph"]["edge_types"][name]["enabled"] = False
    jbundle, bundle = _bundles(d, dict(SMALL, num_patients=120))
    if len(off) == 2:
        with pytest.raises(ValueError):
            jax_warmstart.bundle_membership_matrix(jbundle)
        with pytest.raises(ValueError):
            bundle_membership_matrix(bundle)
        return
    np.testing.assert_array_equal(bundle_membership_matrix(bundle), jax_warmstart.bundle_membership_matrix(jbundle))


def test_checkpoints_cross_packages_with_a_relation_disabled(rgcn, tmp_path):
    """After the step test: JAX's checkpoint of the diagnosis-disabled model
    into the port, and the port's sharded file into JAX."""
    r = rgcn["dx_off"]
    trainer, jtrainer = r["trainer"], r["jtrainer"]
    jtrainer._save(tmp_path / "jax.ckpt")
    twin = Trainer(
        build_model(trainer.config, trainer.graph, device="cpu"), trainer.graph,
        EdgeMasker(trainer.graph, seed=4), trainer.config, device="cpu",
    )
    twin.restore(tmp_path / "jax.ckpt")
    want = state_dict_from_flax({"params": jtrainer.state.params, "batch_stats": jtrainer.state.batch_stats})
    for key, value in want.items():
        assert torch.equal(twin.model.state_dict()[key], value), key
    np.testing.assert_allclose(twin.validate("val"), float(jtrainer.validate("val")), rtol=1e-5)

    named = optimizer_state_by_name(trainer.model, trainer.optimizer)
    lr, kind = trainer.optimizer.param_groups[0]["lr"], optimizer_kind(trainer.optimizer)
    state = trainer.model.state_dict()
    leaves = jax_state_leaves(trainer.model, state, named, lr, kind) * 2
    save_sharded_checkpoint(tmp_path / "port.ckpt", leaves, trainer._host_metadata(), 0, 1)
    restored, meta = load_checkpoint_sharded(tmp_path / "port.ckpt", jtrainer._checkpoint_payload())
    got = state_dict_from_flax({"params": restored["state"].params, "batch_stats": restored["state"].batch_stats})
    for key, value in got.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(value.numpy(), state[key].numpy(), err_msg=key)
    assert meta["model_hash"] == JaxConfig.from_dict(r["d"]).model_hash()


def test_serving_artifact_with_fewer_relations(rgcn, tmp_path):
    r = rgcn["one_way"]
    trainer = r["trainer"]
    export_serving(trainer, r["bundle"], tmp_path / "port", buckets=(256,))
    served = ServingModel.load(tmp_path / "port", device="cpu")
    rng = np.random.default_rng(3)
    p = rng.integers(0, SPEC["num_patients"], 300).astype(np.int32)
    l = rng.integers(0, SPEC["num_labs"], 300).astype(np.int32)
    fn, _ = build_trainer_serving_fn(trainer)
    np.testing.assert_allclose(served.predict(p, l), fn(p, l).numpy(), rtol=1e-5, atol=1e-5)
    # JAX's artifact of the same config and weights names the same things
    jax_export_serving(r["jtrainer"], r["jbundle"], tmp_path / "jax", buckets=(256,))
    theirs = json.loads((tmp_path / "jax" / "serving.json").read_text())
    for key in ("buckets", "num_patients", "num_labs", "model_hash", "architecture", "lab_names"):
        assert served.manifest[key] == theirs[key], key
