"""PyTorch port: Cluster-GCN mini-batch training (``training/minibatch.py``)
against the JAX package, on the CPU.

Cohorts as JAX ``tests/test_minibatch.py``'s ``_setup`` (128-600 patients,
12 labs, hidden 32), graphs built by each package from the same tables:

* ``_cluster_bases`` equals JAX's for edge-balanced and equal-patient
  ranges, errors included;
* ``build_patient_clusters`` equals JAX's field for field, exactly (integer
  plans; the values and weights are copies): bases, ``local_size``, every
  edge set and window plan, degrees, ``patient_id_base``, ``val_vis``, and
  each split's batches with their gather plans, ``degrees``,
  ``sample_weights``, ``vis_positions`` and positions; for K 1, 3, 4, both
  balances, value context off and on, and a bundle loaded from
  ``graph.npz``;
* one cluster train step equals JAX ``Trainer._train_step`` on the same
  cluster, weights and supervision mask (dropout 0): loss ``rtol 1e-5``,
  parameters ``atol 4e-4`` and BatchNorm statistics ``1e-5`` (f32 sums in
  another order), for the RGCN, the RGCN with the ``embedding`` bilinear
  source on a cluster whose base is not 0, and the HGT;
* port only: K = 1 equals the full-batch trainer over 3 epochs to JAX's
  ``rtol 1e-5`` (plain and with value context); host-resident equals
  device-resident; ``fit`` 4 epochs equals ``fit`` 2 and a resume to 4; the
  ALS plant predicts ALS for every cluster; ``train_pipeline`` routes
  ``batch_size``; the bench runs ``clusters=2``; ``compute_node_state``
  refuses a cluster graph.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.graph.serialize import load_graph as jax_load_graph
from multi_modal_gnn_tpu.graph.serialize import save_graph as jax_save_graph
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.training import minibatch as jax_minibatch
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxEdgeMasker
from multi_modal_gnn_tpu_torch.config import Config, ConfigError
from multi_modal_gnn_tpu_torch.data import SyntheticSpec
from multi_modal_gnn_tpu_torch.data.synthetic import generate_synthetic_tables
from multi_modal_gnn_tpu_torch.graph.build import build_heterogeneous_graph
from multi_modal_gnn_tpu_torch.graph.schema import PATIENT, PATIENT_LAB
from multi_modal_gnn_tpu_torch.graph.serialize import load_bundle
from multi_modal_gnn_tpu_torch.models import build_model, state_dict_from_flax
from multi_modal_gnn_tpu_torch.training import EdgeMasker, MiniBatchTrainer, Trainer, minibatch
from multi_modal_gnn_tpu_torch.training.trainer import cluster_count, train_pipeline
from test_torch_plans import assert_edge_sets_equal
from test_torch_value_context import flax_variables

SPEC = dict(num_patients=600, num_labs=12, num_diagnoses=8, num_medications=6, mean_labs_per_patient=8.0, seed=7)


def _config_dict(mask_fraction=0.2, dropout=0.2, architecture="RGCN", source=None, value_context=False):
    d = JaxConfig().to_dict()
    d["model"].update(hidden_dim=32, dropout=dropout, architecture=architecture)
    if value_context:
        d["model"]["value_context"] = True
    if source is not None:
        d["model"]["edge_head"].update(bilinear_rank=5, bilinear_source=source)
    d["train"].update(mask_fraction=mask_fraction, donate_state=False)
    return d


def _bundles(num_patients, d):
    """The JAX bundle (``make_synthetic_bundle``) and the port's, built
    from the same tables."""
    spec = {**SPEC, "num_patients": num_patients}
    jbundle = make_synthetic_bundle(JaxSpec(**spec), JaxConfig.from_dict(d))
    t = generate_synthetic_tables(SyntheticSpec(**spec))
    bundle = build_heterogeneous_graph(
        t["labs_normalized"], t["diagnoses"], t["medications"], t["cohort"], t["labitems"], Config.from_dict(d)
    )
    return jbundle, bundle


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread: multithreaded CPU ``index_add_`` is not
    bit-reproducible, and the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cohort600():
    d = _config_dict()
    jbundle, bundle = _bundles(600, d)
    return dict(d=d, jbundle=jbundle, bundle=bundle)


# -- the partition -------------------------------------------------------------


@pytest.mark.parametrize(
    "num_p, k, balance",
    [(600, 1, "edges"), (600, 3, "edges"), (600, 5, "edges"), (600, 4, "patients"),
     (1000, 7, "edges"), (1000, 8, "patients"), (300, 4, "edges"), (300, 4, "patients")],
)
def test_cluster_bases_match_jax(num_p, k, balance):
    rng = np.random.default_rng(num_p + k)
    # ascending degrees, as cluster_patients_by_degree numbers them
    weight = np.sort(rng.integers(0, 40, num_p)) if balance == "edges" else None
    try:
        want = jax_minibatch._cluster_bases(num_p, k, weight)
    except ValueError as err:
        with pytest.raises(ValueError, match="exceeds"):
            minibatch._cluster_bases(num_p, k, weight)
        assert "exceeds" in str(err)
        return
    assert minibatch._cluster_bases(num_p, k, weight) == want


def _assert_batches_equal(got, want):
    for name in ("patient_idx", "lab_idx", "values", "valid", "degrees", "sample_weights", "vis_positions"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got.num_valid == want.num_valid
    for plan, jplan in ((got.patient_plan, want.patient_plan), (got.lab_plan, want.lab_plan)):
        assert (plan.num_windows, plan.num_rows, plan.identity) == (jplan.num_windows, jplan.num_rows, jplan.identity)
        for name in ("win_src", "win_local", "win_tile_map"):
            np.testing.assert_array_equal(getattr(plan, name).numpy(), np.asarray(getattr(jplan, name)), err_msg=name)


def _assert_clusters_equal(cd, jcd):
    assert cd.bases == list(jcd.bases) and cd.local_size == jcd.local_size
    assert len(cd.subgraphs) == len(jcd.subgraphs)
    for g, jg in zip(cd.subgraphs, jcd.subgraphs):
        assert g.node_counts == jg.node_counts and g.edge_types == jg.edge_types
        assert g.patient_id_base == int(jg.patient_id_base)
        np.testing.assert_array_equal(g.patient_lab_degree.numpy(), np.asarray(jg.patient_lab_degree))
        for et in jg.edge_types:
            assert_edge_sets_equal(g.edges[et], jg.edges[et])
            vis, jvis = g.edges[et].val_vis, jg.edges[et].val_vis
            assert (vis is None) == (jvis is None), et
            if vis is not None:
                np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
                assert g.edges[et].value_plan is not None
    assert cd.batches.keys() == jcd.batches.keys()
    for split, entries in jcd.batches.items():
        for (b, pos), (jb, jpos) in zip(cd.batches[split], entries):
            assert (b is None) == (jb is None), split
            if b is not None:
                np.testing.assert_array_equal(pos, jpos)
                _assert_batches_equal(b, jb)


@pytest.mark.parametrize("value_context", [False, True], ids=["plain", "vctx"])
@pytest.mark.parametrize("balance", ["edges", "patients"])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_build_patient_clusters_matches_jax(cohort600, k, balance, value_context):
    jbundle, bundle = cohort600["jbundle"], cohort600["bundle"]
    jmasker = JaxEdgeMasker(jbundle.graph, seed=0, host_edges=jbundle.patient_lab_host())
    masker = EdgeMasker(bundle.graph, seed=0)
    lab_weights = np.random.default_rng(k).uniform(0.5, 2.0, 12).astype(np.float32)
    kw = dict(num_clusters=k, lab_weights=lab_weights, value_context=value_context, balance=balance)
    jcd = jax_minibatch.build_patient_clusters(jbundle, jmasker, JaxConfig.from_dict(cohort600["d"]), **kw)
    cd = minibatch.build_patient_clusters(bundle, masker, Config.from_dict(cohort600["d"]), **kw)
    _assert_clusters_equal(cd, jcd)


def test_build_patient_clusters_from_a_loaded_bundle_matches_jax(cohort600, tmp_path):
    """A loaded bundle holds host arrays of the reverse relations too: both
    partitioners skip those mirrors."""
    path = jax_save_graph(cohort600["jbundle"], tmp_path / "graph")
    jbundle, bundle = jax_load_graph(path), load_bundle(path, device="cpu")
    cfg = cohort600["d"]
    jcd = jax_minibatch.build_patient_clusters(
        jbundle, JaxEdgeMasker(jbundle.graph, seed=0, host_edges=jbundle.patient_lab_host()),
        JaxConfig.from_dict(cfg), num_clusters=3,
    )
    cd = minibatch.build_patient_clusters(bundle, EdgeMasker(bundle.graph, seed=0), Config.from_dict(cfg), 3)
    _assert_clusters_equal(cd, jcd)


def test_partition_is_exact(cohort600):
    bundle = cohort600["bundle"]
    masker = EdgeMasker(bundle.graph, seed=0)
    cd = minibatch.build_patient_clusters(bundle, masker, Config.from_dict(cohort600["d"]), 4)
    assert cd.local_size % 128 == 0
    src, dst, val = bundle.host_edges[PATIENT_LAB]
    seen = []
    for k, g in enumerate(cd.subgraphs):
        es = g.edges[PATIENT_LAB]
        n = es.num_valid
        assert (es.src[:n] >= 0).all() and (es.src[:n] < cd.local_size).all()
        seen.append(np.stack([es.src[:n].numpy() + cd.bases[k], es.dst[:n].numpy(), es.val[:n].numpy()], 1))
        # local degrees are the global ones of the cluster's range, 0 past it
        end = (cd.bases + [bundle.graph.num_nodes(PATIENT)])[k + 1]
        glob = bundle.graph.patient_lab_degree.numpy()[cd.bases[k] : end]
        np.testing.assert_array_equal(g.patient_lab_degree[: len(glob)].numpy(), glob)
        assert not g.patient_lab_degree[len(glob) :].any()
    # every valid edge lies in exactly one cluster
    got = np.concatenate(seen)
    want = np.stack([src, dst, val], 1)
    np.testing.assert_array_equal(got[np.lexsort(got.T[::-1])], want[np.lexsort(want.T[::-1])])
    np.testing.assert_array_equal(cd.cluster_of(np.asarray(cd.bases)), np.arange(4))
    for split, (p, _, _) in ((s, masker.split_arrays(s)) for s in ("train", "val", "test")):
        assert sum(b.num_valid for b, _ in cd.batches[split] if b is not None) == len(p)


# -- one cluster step against JAX -----------------------------------------------


@pytest.mark.parametrize(
    "architecture, source, k",
    [("RGCN", None, 1), ("RGCN", "embedding", 2), ("HGT", None, 2)],
    ids=["rgcn", "rgcn_embedding", "hgt"],
)
def test_cluster_step_matches_jax(cohort600, architecture, source, k):
    d = _config_dict(dropout=0.0, architecture=architecture, source=source)
    jcfg, cfg = JaxConfig.from_dict(d), Config.from_dict(d)
    jbundle, bundle = cohort600["jbundle"], cohort600["bundle"]
    model = build_model(cfg, bundle.graph, device="cpu", generator=torch.Generator().manual_seed(3))
    # copies: a numpy view of a torch parameter could alias JAX's input buffer
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), flax_variables(model))
    jtrainer = jax_minibatch.MiniBatchTrainer(
        jax_build_model(jcfg, jbundle.graph), jbundle,
        JaxEdgeMasker(jbundle.graph, seed=0, host_edges=jbundle.patient_lab_host()), jcfg,
        num_clusters=3, variables=variables,
    )
    trainer = MiniBatchTrainer(model, bundle, EdgeMasker(bundle.graph, seed=0), cfg, num_clusters=3, device="cpu")
    jcd, cd = jtrainer._ensure_clusters(), trainer._ensure_clusters()
    assert cd.bases[k] > 0 or k == 0
    batch, graph = cd.batches["train"][k][0], cd.subgraphs[k]
    sup = (np.random.default_rng(k).random(batch.valid.shape[0]) < 0.4).astype(np.float32) * batch.valid.numpy()
    jstate, jloss = jtrainer._train_step(
        jtrainer.state, jcd.subgraphs[k], jcd.batches["train"][k][0], jtrainer.lab_weights,
        jnp.asarray(sup), jax.random.key(7),
    )
    jax.block_until_ready(jstate)  # before the port's step writes the parameters in place
    loss = trainer.train_step(batch, torch.from_numpy(sup), 0, graph=graph)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    want = state_dict_from_flax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    got = model.state_dict()
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        atol = 1e-5 if key.endswith(("running_mean", "running_var")) else 4e-4
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), atol=atol, err_msg=key)


# -- the trainer (port only) ------------------------------------------------------


def _small(num_patients, d):
    _, bundle = _bundles(num_patients, d)
    return Config.from_dict(d), bundle


def _model(cfg, bundle, seed=0):
    return build_model(cfg, bundle.graph, device="cpu", generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("value_context", [False, True], ids=["plain", "vctx"])
def test_k1_matches_full_batch(value_context):
    """K = 1 on a window-aligned cohort is the full-batch trainer (mask
    fraction 0 and dropout 0 remove the per-cluster draws)."""
    cfg, bundle = _small(128, _config_dict(mask_fraction=0.0, dropout=0.0, value_context=value_context))
    full = Trainer(_model(cfg, bundle), bundle.graph, EdgeMasker(bundle.graph, seed=3, mask_fraction=0.0), cfg, device="cpu")
    mini = MiniBatchTrainer(
        _model(cfg, bundle), bundle, EdgeMasker(bundle.graph, seed=3, mask_fraction=0.0), cfg, num_clusters=1,
        device="cpu",
    )
    for _ in range(3):
        lf, lm = full.train_epoch(), mini.train_epoch()
        full.epoch += 1
        mini.epoch += 1
        np.testing.assert_allclose(lm, lf, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mini.validate("val"), full.validate("val"), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mini.predict("test"), full.predict("test"), rtol=1e-4, atol=1e-5)


def test_host_resident_matches_device_resident():
    cfg, bundle = _small(300, _config_dict(mask_fraction=0.3, dropout=0.2))

    def run(host):
        mini = MiniBatchTrainer(
            _model(cfg, bundle), bundle, EdgeMasker(bundle.graph, seed=1, mask_fraction=0.3), cfg,
            num_clusters=3, host_resident=host, device="cpu",
        )
        losses, vals = mini.train_epochs(2, with_val=True)
        return losses, vals, mini.predict("test")

    for got, want in zip(run(True), run(False)):
        np.testing.assert_array_equal(got, want)


def test_fit_resumes_across_the_cluster_order(tmp_path):
    """The cluster order, masks and dropout are keyed by epoch: 2 epochs,
    a checkpoint and a resume to 4 equal 4 epochs at once."""
    d = _config_dict(mask_fraction=0.3, dropout=0.2)
    d["train"].update(epochs=4)
    d["logging"].update(checkpoint_interval=2)
    cfg, bundle = _small(300, d)

    def trainer():
        return MiniBatchTrainer(
            _model(cfg, bundle), bundle, EdgeMasker(bundle.graph, seed=1, mask_fraction=0.3), cfg,
            num_clusters=3, device="cpu",
        )

    whole = trainer().fit(output_dir=tmp_path / "whole")
    resumed = trainer()
    resumed.restore(tmp_path / "whole" / "checkpoint_epoch_2.ckpt")
    history = resumed.fit()
    np.testing.assert_allclose(history["train_loss"], whole["train_loss"], rtol=1e-6)
    np.testing.assert_allclose(history["val_loss"], whole["val_loss"], rtol=1e-6)
    # the order is a permutation drawn per epoch
    orders = [np.random.default_rng(minibatch.stream_seed(cfg.train.seed, "cluster_order", e)).permutation(3) for e in range(4)]
    assert len({tuple(o) for o in orders}) > 1


def test_als_plant_predicts_als_for_every_cluster():
    """The embedding source reads each cluster's global rows (JAX
    ``test_bilinear_embedding_uses_global_rows_across_clusters``)."""
    from multi_modal_gnn_tpu_torch.training import warm_start_trainer

    cfg, bundle = _small(600, _config_dict(source="embedding"))
    mini = MiniBatchTrainer(_model(cfg, bundle), bundle, EdgeMasker(bundle.graph, seed=0), cfg, num_clusters=3, device="cpu")
    als = warm_start_trainer(mini, rank=4, reg=3.0)
    tp, tl, _ = mini.masker.split_arrays("test")
    got = mini.predict("test").astype(np.float64)
    want = als.predict(tp, tl)
    cd = mini._ensure_clusters()
    for k in range(3):
        rows = cd.cluster_of(tp) == k
        assert rows.any()
        np.testing.assert_allclose(got[rows], want[rows], atol=1e-4, err_msg=f"cluster {k}")


def test_train_pipeline_routes_batch_size(tmp_path):
    d = _config_dict()
    d["train"].update(epochs=4, batch_size=400)
    cfg, bundle = _small(300, d)
    assert cluster_count(cfg, EdgeMasker(bundle.graph, seed=cfg.train.seed).split_sizes()["train"]) >= 2
    trainer, results = train_pipeline(cfg, bundle, tmp_path, device="cpu")
    assert isinstance(trainer, MiniBatchTrainer) and trainer.num_clusters >= 2
    assert np.isfinite(results["test_loss"]) and len(trainer.history["train_loss"]) == 4
    assert (tmp_path / "training_history.json").exists()
    # the full graph stays with the trainer: pairs and the serving state read it
    assert trainer.graph.patient_id_base is None
    assert np.isfinite(trainer.predict_pairs(np.arange(4), np.zeros(4, np.int32))).all()


def test_cluster_count_and_clamp_follow_jax(caplog):
    d = _config_dict()
    d["train"].update(batch_size=100, num_clusters=2, host_resident=True, cluster_balance="patients")
    cfg = Config.from_dict(d)
    jcfg = JaxConfig.from_dict(d)
    assert cfg.to_dict() == jcfg.to_dict() and cfg.model_hash() == jcfg.model_hash()
    assert cluster_count(cfg, 1000) == 10 and cluster_count(cfg, 150) == 2
    cfg, bundle = _small(300, _config_dict())
    mini = MiniBatchTrainer(_model(cfg, bundle), bundle, EdgeMasker(bundle.graph, seed=0), cfg, num_clusters=9, device="cpu")
    assert mini.num_clusters == 3 and "clamping" in caplog.text
    assert mini.cluster_balance == "edges"


@pytest.mark.parametrize(
    "train, match",
    [({"batch_size": -3}, "batch_size"), ({"batch_size": 2.5}, "batch_size"), ({"num_clusters": 0}, "num_clusters"),
     ({"cluster_balance": "window"}, "cluster_balance"), ({"num_clusters": 4, "parallel": "gspmd"}, "item 8")],
)
def test_minibatch_config_refusals(train, match):
    d = _config_dict()
    d["train"].update(train)
    with pytest.raises(ConfigError, match=match):
        Config.from_dict(d)


def test_compute_node_state_refuses_a_cluster_graph(cohort600):
    for architecture in ("RGCN", "HGT"):
        cfg = Config.from_dict(_config_dict(architecture=architecture))
        bundle = cohort600["bundle"]
        model = _model(cfg, bundle).eval()
        cd = minibatch.build_patient_clusters(bundle, EdgeMasker(bundle.graph, seed=0), cfg, 2)
        with pytest.raises(ValueError, match="FULL graph"):
            model.compute_node_state(cd.subgraphs[1])
        assert model.supports_patient_id_base


def test_model_without_patient_id_base_is_refused(cohort600):
    class NoBase(torch.nn.Module):
        pass

    bundle = cohort600["bundle"]
    with pytest.raises(NotImplementedError, match="patient_id_base"):
        MiniBatchTrainer(NoBase(), bundle, EdgeMasker(bundle.graph, seed=0), Config.from_dict(cohort600["d"]), 2, device="cpu")


def test_bench_runs_clusters_on_the_cpu():
    from multi_modal_gnn_tpu_torch.tools import bench

    result = bench.run_bench(epochs=2, device="cpu", clusters=2, dense=False)
    assert result["clusters"] == 2 and result["value"] > 0 and np.isfinite(result["final_train_loss"])
    # cluster graphs carry no span plan
    assert set(result["aggregation_impl"].split("+")) <= {"fused_table", "paired"}
    assert result["kernel_launches"] == {}  # CPU tensors take the plain versions
