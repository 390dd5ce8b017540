"""PyTorch port: the value-context channel and the bilinear channel against
the JAX package, on the CPU.

One cohort (300 patients, 20 labs), graphs assembled from the same edge
arrays by both packages, row-major batches, split seed 4, hidden 16, heads
(16, 8), bilinear rank 4, dropout 0, TF32 off (a CPU run).  For the RGCN
with concat and factored heads and for the HGT, each with value context off
and on and each bilinear source (``head``, ``embedding``, ``context``; the
last needs value context), the port's seeded weights go to JAX as a flax
tree (the inverse of ``state_dict_from_flax``, held to it), and JAX gets the
port's numpy supervision mask:

* the train step's visibility equals JAX ``Trainer._visible_graph``'s
  exactly; its train-mode predictions agree to ``1e-5 + 1e-5 |ref|``, the
  loss to ``rtol 1e-5`` and every gradient to ``rtol 1e-4`` plus ``1e-5`` of
  the largest (f32 sums in another order; a bias feeding a BatchNorm has a
  gradient of exactly 0, which both sides give as rounding noise);
* ``compute_node_state`` under the eval template (``bl_u`` / ``bl_l``
  included) and ``predict_pairs_cached`` agree with JAX's to ``1e-5 + 1e-5
  |ref|``.

Port only, exact: perturbing val and test values changes no eval
prediction, perturbing the supervised edges' values changes nothing in that
train step, and the knockout hides a supervised edge 0 that padding slots
also point at.  The kernel path (``use_pallas``, slot-major, the plain
versions on the CPU) equals the row-major path for each source (the
``head`` source with ``dual_head_fusion: on`` runs single heads, as in
JAX).  The card's route for the context sums (sparse products over the
edge set's ``ValuePlan``) equals the plain ``index_add_`` route, forced
onto the CPU.  A JAX checkpoint of a value-context model restores through
``load_flax_checkpoint``.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.graph.build import assemble_graph as jax_assemble
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.models.losses import weighted_regression_loss as jax_loss
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxEdgeMasker
from multi_modal_gnn_tpu.training.trainer import Trainer as JaxTrainer
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_edges
from multi_modal_gnn_tpu_torch.graph.build import assemble_graph
from multi_modal_gnn_tpu_torch.graph.hetero import build_value_plan
from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT, PATIENT_LAB
from multi_modal_gnn_tpu_torch.models import build_model, context, state_dict_from_flax
from multi_modal_gnn_tpu_torch.models.losses import weighted_regression_loss
from multi_modal_gnn_tpu_torch.ops import pairhead_kernels
from multi_modal_gnn_tpu_torch.serving import compute_trainer_state
from multi_modal_gnn_tpu_torch.training import EdgeMasker, Trainer

H, RANK = 16, 4
TOL = dict(rtol=1e-5, atol=1e-5)
SPEC = SyntheticSpec(
    num_patients=300, num_labs=20, num_diagnoses=15, num_medications=10,
    mean_labs_per_patient=8.0, mean_diagnoses_per_patient=2.0,
    mean_medications_per_patient=2.0, latent_dim=4, seed=2,
)
# (architecture and head style, value context, bilinear source): each
# source with and without value context where it allows it, per model
CASES = [
    ("rgcn_concat", False, "head"), ("rgcn_concat", True, "embedding"), ("rgcn_concat", True, "context"),
    ("rgcn_factored", False, "embedding"), ("rgcn_factored", True, "head"),
    ("rgcn_factored", True, "context"),
    ("hgt", False, "embedding"), ("hgt", True, "head"), ("hgt", True, "context"),
]
MODELS = {
    "rgcn_concat": dict(architecture="RGCN", head_style="concat"),
    "rgcn_factored": dict(architecture="RGCN", head_style="factored"),
    "hgt": dict(architecture="HGT", num_heads=4),
}


def _config_dict(model, value_context, source, use_pallas=False, head_dims=(16, 8), **extras):
    d = JaxConfig().to_dict()
    fields = dict(MODELS[model])
    d["model"].update(
        architecture=fields.pop("architecture"), hidden_dim=H, dropout=0.0, use_pallas=use_pallas,
        num_heads=fields.pop("num_heads", 4), value_context=value_context, **fields, **extras,
    )
    d["model"]["edge_head"].update(hidden_dims=list(head_dims), bilinear_rank=RANK, bilinear_source=source)
    d["graph"]["dense_adjacency_max_bytes"] = 0
    return d


@pytest.fixture(scope="module")
def cohort():
    edge_arrays, node_counts = generate_synthetic_edges(SPEC)
    d = _config_dict("rgcn_concat", False, "head")
    jgraph = jax_assemble(edge_arrays, node_counts, config=JaxConfig.from_dict(d))
    graph = assemble_graph(edge_arrays, node_counts, Config.from_dict(d))
    masker = EdgeMasker(graph, seed=4)
    batch = masker.get_split("train")
    rng = np.random.default_rng(0)
    sup = (rng.random(batch.valid.shape[0]) < 0.4).astype(np.float32) * batch.valid.numpy()
    return dict(
        edge_arrays=edge_arrays, node_counts=node_counts, jgraph=jgraph, graph=graph, masker=masker,
        jmasker=JaxEdgeMasker(jgraph, seed=4), sup=sup,
    )


def flax_variables(model) -> dict:
    """The port model's weights as the JAX model's flax tree (the port's
    module names are the flax names), held to be the inverse of
    ``state_dict_from_flax``: JAX's jitted init costs seconds a model."""
    leaf_names = {}
    for name, module in model.named_modules():
        if isinstance(module, torch.nn.Embedding):
            leaf_names[name] = {"weight": "embedding"}
        elif isinstance(module, torch.nn.Linear):
            leaf_names[name] = {"weight": "kernel", "bias": "bias"}
        elif isinstance(module, torch.nn.BatchNorm1d):
            leaf_names[name] = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
        else:  # the bilinear factors, raw parameters of the model or a head
            leaf_names[name] = {"bilinear_u": "bilinear_u", "bilinear_l": "bilinear_l"}
    variables = {"params": {}}
    for key, value in model.state_dict().items():
        mod, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        node = variables.setdefault("batch_stats" if leaf.startswith("running_") else "params", {})
        for part in filter(None, mod.split(".")):
            node = node.setdefault(part, {})
        flax_leaf = leaf_names[mod][leaf]
        node[flax_leaf] = value.numpy().T if flax_leaf == "kernel" else value.numpy()
    back = state_dict_from_flax(variables)
    assert back.keys() == model.state_dict().keys()
    for key, value in back.items():
        assert key.endswith("num_batches_tracked") or torch.equal(value, model.state_dict()[key]), key
    return variables


def _pair(cohort, d, masker=None):
    """A port trainer on seeded weights and a JAX trainer on the same ones."""
    jcfg, cfg = JaxConfig.from_dict(d), Config.from_dict(d)
    model = build_model(cfg, cohort["graph"], device="cpu", generator=torch.Generator().manual_seed(0))
    variables = flax_variables(model)
    jmodel = jax_build_model(jcfg, cohort["jgraph"])
    jtrainer = JaxTrainer(jmodel, cohort["jgraph"], cohort["jmasker"], jcfg, variables=variables)
    trainer = Trainer(model, cohort["graph"], masker or cohort["masker"], cfg, device="cpu")
    return jtrainer, trainer, variables


def _train_forward(trainer, sup: torch.Tensor, graph=None):
    """The train step's predictions and loss, without the optimizer step."""
    batch = trainer.get_batch("train")
    trainer.model.train()
    preds = trainer.model.predict_lab_values(
        graph if graph is not None else trainer._visible_graph(sup), batch.patient_idx, batch.lab_idx,
        train=True, patient_plan=batch.patient_plan, lab_plan=batch.lab_plan, degrees=batch.degrees,
    )
    return preds, weighted_regression_loss(preds, batch.values, batch.sample_weights, sup, "mae")


@pytest.mark.parametrize("model,value_context,source", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_channels_match_jax(cohort, model, value_context, source):
    jtrainer, trainer, variables = _pair(cohort, _config_dict(model, value_context, source))
    jmodel = jtrainer.model
    # the eval template: node state and cached requests, before any train forward
    jgraph_eval = jtrainer._visible_graph(jtrainer.graph, None)
    want_state = jax.jit(lambda v, g: jmodel.apply(v, g, method=jmodel.compute_node_state))(variables, jgraph_eval)
    state = compute_trainer_state(trainer)
    assert set(state) == set(want_state)
    assert ("bl_u" in state) == (source != "head")
    for key, value in want_state.items():
        np.testing.assert_allclose(state[key].numpy(), np.asarray(value), err_msg=key, **TOL)
    rng = np.random.default_rng(1)
    p = rng.integers(0, SPEC.num_patients, 200).astype(np.int32)
    l = rng.integers(0, SPEC.num_labs, 200).astype(np.int32)
    want = jmodel.apply(variables, want_state, jnp.asarray(p), jnp.asarray(l), method=jmodel.predict_pairs_cached)
    with torch.no_grad():
        got = trainer.model.predict_pairs_cached(state, torch.from_numpy(p).long(), torch.from_numpy(l).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # one train step's visibility, predictions, loss and gradients
    sup = cohort["sup"]
    jgraph = jtrainer._visible_graph(jtrainer.graph, jnp.asarray(sup))
    graph = trainer._visible_graph(torch.from_numpy(sup))
    if value_context:
        np.testing.assert_array_equal(
            graph.edges[PATIENT_LAB].val_vis.numpy(), np.asarray(jgraph.edges[PATIENT_LAB].val_vis)
        )
    jbatch = jtrainer._get_batch("train")

    def loss_fn(params):
        preds, _ = jtrainer._apply_train(params, jtrainer.state.batch_stats, jgraph, jbatch, jax.random.key(7))
        weights = jtrainer.lab_weights[jbatch.lab_idx]
        return jax_loss(preds, jbatch.values, weights, jnp.asarray(sup), loss_type="mae"), preds

    (jloss, jpreds), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jtrainer.state.params)
    preds, loss = _train_forward(trainer, torch.from_numpy(sup), graph)
    loss.backward()
    np.testing.assert_allclose(preds.detach().numpy(), np.asarray(jpreds), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want_grads = {k: v for k, v in state_dict_from_flax({"params": jgrads}).items() if "num_batches" not in k}
    floor = 1e-5 * max(float(np.abs(g.numpy()).max()) for g in want_grads.values())
    assert {n for n, _ in trainer.model.named_parameters()} == set(want_grads)
    for name, param in trainer.model.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), want_grads[name].numpy(), rtol=1e-4, atol=floor, err_msg=name)


def _perturbed_graph(graph, positions, seed):
    """``graph`` with the patient->lab values at ``positions`` replaced."""
    es = graph.edges[PATIENT_LAB]
    val = es.val.clone()
    val[torch.from_numpy(positions).long()] = torch.from_numpy(
        np.random.default_rng(seed).normal(5.0, 3.0, len(positions)).astype(np.float32)
    )
    return dataclasses.replace(graph, edges={**graph.edges, PATIENT_LAB: dataclasses.replace(es, val=val)})


@contextlib.contextmanager
def one_thread():
    """Multithreaded CPU ``index_add_`` is not bit-reproducible."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("model", ["rgcn_factored", "hgt"])
def test_no_value_leaks(cohort, model):
    """Exact on the CPU (one thread): val / test values reach no eval
    prediction, and a supervised edge's value reaches nothing in its train
    step."""
    masker = cohort["masker"]
    d = _config_dict(model, True, "context")
    cfg = Config.from_dict(d)
    sd = build_model(cfg, cohort["graph"], device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()

    def trainer_on(graph):
        model_ = build_model(cfg, graph, device="cpu")
        model_.load_state_dict(sd)
        return Trainer(model_, graph, masker, cfg, device="cpu")

    with one_thread():
        _check_no_leaks(cohort, masker, trainer_on)


def _check_no_leaks(cohort, masker, trainer_on):
    base = trainer_on(cohort["graph"])
    held = np.concatenate([masker.split_edge_positions("val"), masker.split_edge_positions("test")])
    other = trainer_on(_perturbed_graph(cohort["graph"], held, 1))
    for split in ("val", "test"):
        np.testing.assert_array_equal(base.predict(split), other.predict(split))
    # the same with the train values perturbed moves them: the channel is live
    moved = trainer_on(_perturbed_graph(cohort["graph"], masker.split_edge_positions("train"), 2))
    assert np.abs(moved.predict("val") - base.predict("val")).max() > 1e-3

    sup = torch.from_numpy(cohort["sup"])
    supervised = masker.train_positions()[cohort["sup"] > 0]
    other = trainer_on(_perturbed_graph(cohort["graph"], supervised, 3))
    (p0, l0), (p1, l1) = _train_forward(base, sup), _train_forward(other, sup)
    assert torch.equal(p0, p1) and torch.equal(l0, l1)


def test_knockout_hides_a_supervised_edge_zero(cohort):
    """Padding slots point at edge position 0; when edge 0 is a supervised
    train edge, every slot's factor multiplies in, so it stays hidden."""
    graph = cohort["graph"]
    seed = next(s for s in range(100) if 0 in EdgeMasker(graph, seed=s).split_edge_positions("train"))
    masker = EdgeMasker(graph, seed=seed)
    cfg = Config.from_dict(_config_dict("rgcn_concat", True, "embedding"))
    trainer = Trainer(build_model(cfg, graph, device="cpu"), graph, masker, cfg, device="cpu")
    pos = masker.train_positions()
    batch = trainer.get_batch("train")
    pad = batch.valid.numpy() == 0
    assert pad.any() and (pos[pad] == 0).all()
    sup = np.zeros(len(pos), np.float32)
    sup[np.flatnonzero(pos == 0)[0]] = 1.0  # the row of edge 0 (the first slot pointing at 0)
    assert batch.valid.numpy()[np.flatnonzero(pos == 0)[0]] == 1.0
    vis = trainer._visible_graph(torch.from_numpy(sup)).edges[PATIENT_LAB].val_vis
    assert vis[0] == 0.0
    base = trainer.graph.edges[PATIENT_LAB].val_vis
    assert base[0] == 1.0 and torch.equal(vis[1:], base[1:])


@pytest.mark.parametrize("source", ["head", "embedding", "context"])
def test_kernel_path_equals_row_major(cohort, source):
    """One train step on the kernel path (slot-major, K1-K4's plain versions
    on the CPU) against the row-major path from the same weights and the
    same supervision: the loss to ``rtol 1e-5``, every gradient to ``rtol
    1e-4`` plus ``1e-5`` of the largest (the parity test's bounds)."""
    d = _config_dict(
        "rgcn_factored", True, source, use_pallas=True, head_dims=(64, 32), dual_head_fusion="on"
    )
    cfg = Config.from_dict(d)
    graph = cohort["graph"]
    slot = EdgeMasker(graph, seed=4, slot_major_train=True, slot_major_min_rows=0)
    row = cohort["masker"]
    sd = build_model(cfg, graph, device="cpu", generator=torch.Generator().manual_seed(1)).state_dict()
    trainers = []
    for masker in (slot, row):
        model = build_model(cfg, graph, device="cpu")
        model.load_state_dict(sd)
        trainers.append(Trainer(model, graph, masker, cfg, device="cpu"))
    sup_row = cohort["sup"]
    n = trainers[1].get_batch("train").num_valid
    sup_slot = np.zeros(trainers[0].get_batch("train").valid.shape[0], np.float32)
    sup_slot[slot.slot_map("train")[:n]] = sup_row[:n]
    pairhead_kernels.reset_launch_counts()
    losses = [t.train_step(t.get_batch("train"), torch.from_numpy(s), 0) for t, s in zip(trainers, (sup_slot, sup_row))]
    counts = dict(pairhead_kernels.launch_counts)
    assert not any(counts.values())  # the CPU took the plain versions
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    grads = [dict(t.model.named_parameters()) for t in trainers]
    floor = 1e-5 * max(float(p.grad.abs().max()) for p in grads[1].values())
    for name, p in grads[1].items():
        np.testing.assert_allclose(grads[0][name].grad.numpy(), p.grad.numpy(), rtol=1e-4, atol=floor, err_msg=name)
    # the (64, 32) heads run fused (K4 / K5); the head source keeps its own
    # term in each head, so it runs them single (K4), the others dual (K5)
    model, plan = trainers[0].model, trainers[0].get_batch("train").patient_plan
    assert model.tabular_mlp.fused_widths() and plan.identity
    assert model._use_dual(plan, None) == (source != "head")


def test_sparse_route_equals_the_plain_route(cohort, monkeypatch):
    """The card's route (one sparse product per side over the edge set's
    ValuePlan, the transposed product as its backward) against the plain
    ``index_add_`` route, forced onto the CPU: both sides' contexts and
    their gradients within ``1e-5 + 1e-5 |ref|`` (f32 sums in another
    order), the visible counts exactly."""
    graph = cohort["graph"]
    es = graph.edges[PATIENT_LAB]
    vis = torch.from_numpy(cohort["masker"].visibility_base(es.src.shape[0]))
    es = dataclasses.replace(es, val_vis=vis, value_plan=build_value_plan(es))
    graph = dataclasses.replace(graph, edges={**graph.edges, PATIENT_LAB: es})
    cfg = Config.from_dict(_config_dict("rgcn_concat", True, "context"))
    model = build_model(cfg, graph, device="cpu", generator=torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    x = {PATIENT: torch.randn(SPEC.num_patients, H, generator=gen), LAB: torch.randn(SPEC.num_labs, H, generator=gen)}
    g = {k: torch.randn(v.shape, generator=gen) for k, v in x.items()}
    out = {}
    for sparse in (True, False):
        monkeypatch.setattr(context, "csr_route", lambda es, device, sparse=sparse: sparse)
        leaves = {k: v.clone().requires_grad_() for k, v in x.items()}
        y = context.inject_value_context(leaves, graph, model.vctx_patient, model.vctx_lab)
        ctx, cnt = context.patient_value_context(leaves[LAB], es)
        torch.autograd.backward([y[PATIENT], y[LAB], ctx], [g[PATIENT], g[LAB], g[PATIENT]])
        out[sparse] = [y[PATIENT], y[LAB], ctx, leaves[PATIENT].grad, leaves[LAB].grad], cnt
    (got, cnt), (want, cnt_ref) = out[True], out[False]
    assert torch.equal(cnt, cnt_ref)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), **TOL)


def test_sparse_route_counts_past_float32_range():
    """The sparse route's visible counts are differences of one running sum
    over every valid edge; past 2^24 edges a float32 sum no longer adds 1,
    so rows there would count 0.  Exact here, at 2^24 + 5 edges."""
    n = 2**24
    ptr = torch.tensor([0, n, n + 2, n + 5], dtype=torch.int32)
    got = context._segment_totals(torch.ones(n + 5), ptr)
    assert got.dtype == torch.float32
    assert got.tolist() == [float(n), 2.0, 3.0]


def test_flax_checkpoint_restores(cohort, tmp_path):
    jtrainer, trainer, _ = _pair(cohort, _config_dict("rgcn_factored", True, "context"))
    jtrainer._save(tmp_path / "best_model.ckpt")
    trainer.model.load_state_dict(  # other weights, which the restore replaces
        build_model(trainer.config, cohort["graph"], device="cpu").state_dict()
    )
    trainer.restore(tmp_path / "best_model.ckpt")
    want = state_dict_from_flax({"params": jtrainer.state.params, "batch_stats": jtrainer.state.batch_stats})
    got = trainer.model.state_dict()
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], value), key
    assert {"bilinear_u", "bilinear_l", "vctx_patient.weight", "vctx_lab.bias"} <= set(got)
    np.testing.assert_allclose(trainer.predict("val"), jtrainer.predict("val"), **TOL)
