"""PyTorch port: the dual-head fusion (K5f / K5b) against the JAX package.

* ``fused_pair_head_dual``: the port's autograd Function (whose wrappers take
  the plain versions on the CPU) against JAX ``fused_pair_head_dual`` in
  interpret mode at ``rate=0``, on ``tests/test_pairhead_kernel.py``'s
  problem (300 patients, 37 labs, 2,000 pairs): outputs to ``atol=1e-5``,
  the twelve gradients (sums over up to 4,096 slots in another order) to
  ``rtol=atol=1e-4``, and each head's tile mask exactly.
* The dual dropout stream: keep rate and independence of the two heads'
  columns.
* ``HeteroRGCN`` with ``dual_head_fusion`` on, off and auto, from flax
  weights bridged by ``convert.py``: the port's on against its off and
  against JAX's on (predictions and gradients ``1e-4``, as
  ``tests/test_model.py``'s dual parity test), and the path each package
  takes.
* One train step with ``on`` against JAX ``Trainer._train_step``, with the
  bounds of ``tests/test_torch_training.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.graph import hetero as jax_hetero
from multi_modal_gnn_tpu.graph.build import assemble_graph as jax_assemble
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.models.factory import init_model_variables
from multi_modal_gnn_tpu.ops import pallas_pairhead as jax_pairhead
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxEdgeMasker
from multi_modal_gnn_tpu.training.trainer import Trainer as JaxTrainer
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_edges
from multi_modal_gnn_tpu_torch.graph import hetero
from multi_modal_gnn_tpu_torch.graph.build import assemble_graph
from multi_modal_gnn_tpu_torch.models import build_model, layers, rgcn, state_dict_from_flax
from multi_modal_gnn_tpu_torch.ops import pairhead_kernels as pk
from multi_modal_gnn_tpu_torch.ops.pairhead import fused_pair_head_dual
from multi_modal_gnn_tpu_torch.training import EdgeMasker, Trainer

NAMES = ("proj_p", "proj_l", "w1", "b1", "w2", "b2")


# -- the fused dual head ------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread: the suite's workers share the cores, and a
    worker's torch on every core slows all of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    num_p, num_l, batch = 300, 37, 2000
    p_idx = rng.integers(0, num_p, batch).astype(np.int32)
    l_idx = rng.integers(0, num_l, batch).astype(np.int32)
    plan = jax_hetero.build_gather_plan(p_idx, num_p)
    win_src, win_local = np.asarray(plan.win_src), np.asarray(plan.win_local)
    l_s = np.where(win_local < hetero.WINDOW, l_idx[win_src], 0).astype(np.int32)

    def head(r, b2):
        return dict(
            proj_p=r.standard_normal((num_p, 64)).astype(np.float32),
            proj_l=r.standard_normal((num_l, 64)).astype(np.float32),
            w1=(r.standard_normal((64, 32)) * 0.1).astype(np.float32),
            b1=(r.standard_normal(32) * 0.1).astype(np.float32),
            w2=(r.standard_normal(32) * 0.1).astype(np.float32),
            b2=np.float32(b2),
        )

    num_tiles = len(win_local) // hetero.TILE_E
    masks = np.random.default_rng(9).integers(0, 2, (2, num_tiles)).astype(np.int32)
    g = np.random.default_rng(5).standard_normal((2, len(win_local))).astype(np.float32)
    return dict(
        plan=plan, l_s=l_s, win_local=win_local.astype(np.int32),
        tile_map=np.asarray(plan.win_tile_map, np.int32), tab=head(rng, 0.3),
        gnn=head(np.random.default_rng(11), -0.2), masks=masks, g=g,
    )


def _jax_dual(prob, masks, *params):
    m = (None, None) if masks is None else tuple(map(jnp.asarray, masks))
    return jax_pairhead.fused_pair_head_dual(
        *params, jnp.asarray(prob["l_s"]), jnp.asarray(prob["win_local"]),
        jnp.asarray(prob["tile_map"]), jnp.zeros(4, jnp.uint32), *m,
        prob["plan"].num_windows, 0.0, True,
    )


def _port_dual(prob, masks, *params, rate=0.0, seed4=(0, 0, 0, 0)):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    p = list(params)
    p[5], p[11] = p[5].reshape(1), p[11].reshape(1)
    m = (None, None) if masks is None else (t(masks[0]), t(masks[1]))
    return fused_pair_head_dual(
        *p, t(prob["l_s"]), t(prob["win_local"]), t(prob["tile_map"]), seed4, *m,
        prob["plan"].num_windows, rate,
    )


@pytest.mark.parametrize("masked", [False, True], ids=["all_tiles", "head_masks"])
def test_dual_head_matches_jax(problem, masked):
    masks = problem["masks"] if masked else None
    values = [*problem["tab"].values(), *problem["gnn"].values()]
    jargs = [jnp.asarray(v) for v in values]
    targs = [torch.from_numpy(np.asarray(v)).requires_grad_() for v in values]
    want = _jax_dual(problem, masks, *jargs)
    got = _port_dual(problem, masks, *targs)
    for head, a, b in zip(("tab", "gnn"), got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, err_msg=head)
    if masked:  # a head's output is exactly 0 on its own masked tiles, and only there
        full = _port_dual(problem, None, *[x.detach() for x in targs])
        for h in range(2):
            keep = torch.from_numpy(np.repeat(masks[h], hetero.TILE_E)) != 0
            assert not got[h].detach()[~keep].any()
            np.testing.assert_allclose(got[h].detach()[keep].numpy(), full[h][keep].numpy(), atol=1e-6)

    g_t, g_g = problem["g"]
    jgrads = jax.grad(
        lambda *a: sum(jnp.sum(o * g) for o, g in zip(_jax_dual(problem, masks, *a), (g_t, g_g))),
        argnums=tuple(range(12)),
    )(*jargs)
    ((got[0] * torch.from_numpy(g_t)).sum() + (got[1] * torch.from_numpy(g_g)).sum()).backward()
    for name, t, jg in zip([f"{h}.{n}" for h in ("tab", "gnn") for n in NAMES], targs, jgrads):
        np.testing.assert_allclose(
            t.grad.numpy().reshape(np.shape(jg)), np.asarray(jg), rtol=1e-4, atol=1e-4,
            err_msg=f"grad({name})",
        )


def test_dual_dropout_stream_keep_rate_and_independent_heads():
    """One stream over 128 columns of layer 0 and 64 of layer 1, seeded by
    the XOR of both heads' seeds: every column keeps 80 % of its draws, and
    no column's keep pattern follows another's (the tabular columns against
    the GNN columns, layer 0 against layer 1)."""
    seed = pk.dual_seed((0xDEADBEEF, 7, 12345, 99))
    assert seed == ((0xDEADBEEF ^ 12345), 7 ^ 99)
    threshold, _ = pk.dropout_params(0.2)
    slots = torch.arange(4096, dtype=torch.int64) * 7 + 3
    keep = torch.cat(
        [pk.dropout_bits(seed, slots, layer, width, pk.DUAL_LAYER_STRIDE) >= threshold
         for layer, width in ((0, 128), (1, 64))],
        dim=1,
    ).double()
    n = keep.numel()
    assert n >= 100_000
    assert abs(keep.mean().item() - 0.8) < 0.01 * 0.8
    corr = torch.corrcoef(keep.t())
    off_diag = corr - torch.eye(corr.shape[0], dtype=corr.dtype)
    # 4,096 draws per column: independent columns correlate by ~1/64
    assert float(off_diag.abs().max()) < 0.1


def test_dual_dropout_draws_one_stream_for_both_heads(problem):
    """With dropout on, the dual head drops a unit of the tabular head where
    the stream's column c says so, and of the GNN head where column 64 + c
    does: the plain forward repeats bit for bit and differs under another
    seed, and its backward (autograd through the same draws) equals a
    finite-difference derivative."""
    values = [
        torch.from_numpy(np.asarray(v)).double()
        for v in (*problem["tab"].values(), *problem["gnn"].values())
    ]
    kw = dict(rate=0.2, seed4=(11, 22, 33, 44))
    out1 = _port_dual(problem, problem["masks"], *values, **kw)
    out2 = _port_dual(problem, problem["masks"], *values, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out1, out2))
    other = _port_dual(problem, problem["masks"], *values, rate=0.2, seed4=(11, 22, 33, 45))
    assert not torch.equal(out1[0], other[0]) and not torch.equal(out1[1], other[1])

    leaves = [v.clone().requires_grad_() for v in values]
    g = [torch.from_numpy(x).double() for x in problem["g"]]
    outs = _port_dual(problem, problem["masks"], *leaves, **kw)
    sum((o * gg).sum() for o, gg in zip(outs, g)).backward()
    gen = torch.Generator().manual_seed(0)
    direction = [torch.randn(v.shape, generator=gen, dtype=v.dtype) for v in values]
    eps = 1e-8  # float64; larger steps cross ReLU kinks at this many units

    def loss(xs):
        outs = _port_dual(problem, problem["masks"], *xs, **kw)
        return float(sum((o * gg).sum() for o, gg in zip(outs, g)))

    numeric = (loss([v + eps * d for v, d in zip(values, direction)])
               - loss([v - eps * d for v, d in zip(values, direction)])) / (2 * eps)
    analytic = float(sum((leaf.grad * d).sum() for leaf, d in zip(leaves, direction)))
    assert numeric == pytest.approx(analytic, rel=1e-6, abs=1e-6)


# -- the model and one train step ----------------------------------------------


def _jax_config(mode, dropout=0.0):
    cfg = JaxConfig()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, hidden_dim=32, dropout=dropout, use_pallas=True,
            extras={"head_style": "factored", "dual_head_fusion": mode},
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
    jcfg = _jax_config("on")
    jax_graph = jax_assemble(edge_arrays, node_counts, config=jcfg)
    graph = assemble_graph(edge_arrays, node_counts, Config.from_dict(jcfg.to_dict()))
    jmodel = jax_build_model(jcfg, jax_graph)
    variables = init_model_variables(jmodel, jax_graph, jax.random.PRNGKey(0))
    return dict(
        jax_graph=jax_graph, graph=graph, variables=variables,
        masker=EdgeMasker(graph, seed=4, slot_major_train=True, slot_major_min_rows=0),
        jmasker=JaxEdgeMasker(jax_graph, seed=4, slot_major_train=True, slot_major_min_rows=0),
    )


def _port_model(cohort, mode):
    cfg = Config.from_dict(_jax_config(mode).to_dict())
    model = build_model(cfg, cohort["graph"], device="cpu")
    model.load_state_dict(state_dict_from_flax(cohort["variables"]), strict=True)
    return model


def test_config_carries_dual_head_fusion():
    for mode in ("on", "off", "auto"):
        assert Config.from_dict(_jax_config(mode).to_dict()).model.dual_head_fusion == mode
    assert Config().model.dual_head_fusion == "auto"
    assert Config.from_dict({"model": {"extras": {"dual_head_fusion": "on"}}}).model.dual_head_fusion == "on"


def test_rgcn_dual_on_matches_off_and_jax(cohort):
    """Bridged flax weights, eval mode, a slot-major batch with the degree
    masks: the port's ``on`` (K5's plain versions) against its ``off`` (K4
    twice) and against JAX's ``on`` (K5 in interpret mode) — predictions,
    loss and every gradient."""
    batch = cohort["masker"].get_split("train")
    jbatch = cohort["jmasker"].get_split("train")
    assert batch.patient_plan.identity and not batch.patient_plan.lab_block_rows
    degrees = cohort["graph"].patient_lab_degree[batch.patient_idx.long()]

    results = {}
    for mode in ("on", "off"):
        model = _port_model(cohort, mode)
        pk.reset_launch_counts()
        preds = model.predict_lab_values(
            cohort["graph"], batch.patient_idx, batch.lab_idx, train=False,
            patient_plan=batch.patient_plan, lab_plan=batch.lab_plan, degrees=degrees,
        )
        assert not any(pk.launch_counts.values())  # the CPU took the plain versions
        loss = (((preds - batch.values) ** 2) * batch.valid).sum()
        loss.backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in model.named_parameters()}
        results[mode] = (preds.detach(), float(loss.detach()), grads)
    on, off = results["on"], results["off"]
    np.testing.assert_allclose(on[0].numpy(), off[0].numpy(), atol=1e-5)
    for name, grad in on[2].items():
        np.testing.assert_allclose(grad.numpy(), off[2][name].numpy(), atol=1e-4, err_msg=name)

    jmodel = jax_build_model(_jax_config("on"), cohort["jax_graph"])
    jdeg = jnp.take(cohort["jax_graph"].patient_lab_degree, jbatch.patient_idx)

    def jloss(variables):
        preds = jmodel.apply(
            variables, cohort["jax_graph"], jbatch.patient_idx, jbatch.lab_idx, train=False,
            method=jmodel.predict_lab_values, patient_plan=jbatch.patient_plan,
            lab_plan=jbatch.lab_plan, degrees=jdeg,
        )
        return jnp.sum((preds - jbatch.values) ** 2 * jbatch.valid), preds

    (jl, jpreds), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(cohort["variables"])
    np.testing.assert_allclose(on[0].numpy(), np.asarray(jpreds), atol=1e-4)
    np.testing.assert_allclose(on[1], float(jl), rtol=1e-4)
    want = state_dict_from_flax({"params": jgrads["params"]})
    for name, grad in on[2].items():
        np.testing.assert_allclose(grad.numpy(), want[name].numpy(), atol=1e-4, err_msg=name)


class _Took(Exception):
    pass


@pytest.mark.parametrize(
    "mode,pass_degrees,lab_rows,dual",
    [
        ("auto", True, 0, False),
        ("auto", False, 0, True),
        ("on", True, 0, True),
        ("off", False, 0, False),
        ("on", True, 16, False),
    ],
    ids=["auto_masked", "auto_unmasked", "on", "off", "on_span_tiles"],
)
def test_dual_path_is_chosen_as_jax_chooses(cohort, monkeypatch, mode, pass_degrees, lab_rows, dual):
    """Which head path each package takes, stopped at the head kernels:
    ``auto`` goes dual exactly when the caller passed no degrees (no tile
    masks); span-bounded lab tiles keep the single heads."""

    def took(path):
        def stub(*args, **kwargs):
            raise _Took(path)
        return stub

    monkeypatch.setattr(jax_pairhead, "fused_pair_head_dual", took("dual"))
    monkeypatch.setattr(jax_pairhead, "fused_pair_head", took("single"))
    monkeypatch.setattr(rgcn, "fused_pair_head_dual", took("dual"))
    monkeypatch.setattr(layers, "fused_pair_head", took("single"))

    kw = dict(lab_block_rows=lab_rows) if lab_rows else {}
    masker = EdgeMasker(cohort["graph"], seed=4, slot_major_train=True, slot_major_min_rows=0, **kw)
    jmasker = JaxEdgeMasker(
        cohort["jax_graph"], seed=4, slot_major_train=True, slot_major_min_rows=0,
        **(dict(kw, lab_tile_mode="span") if lab_rows else {}),
    )
    batch, jbatch = masker.get_split("train"), jmasker.get_split("train")
    with pytest.raises(_Took) as port_path:
        _port_model(cohort, mode).predict_lab_values(
            cohort["graph"], batch.patient_idx, batch.lab_idx, train=False,
            patient_plan=batch.patient_plan, lab_plan=batch.lab_plan,
            degrees=cohort["graph"].patient_lab_degree[batch.patient_idx.long()] if pass_degrees else None,
        )
    jmodel = jax_build_model(_jax_config(mode), cohort["jax_graph"])
    jdeg = jnp.take(cohort["jax_graph"].patient_lab_degree, jbatch.patient_idx) if pass_degrees else None
    with pytest.raises(_Took) as jax_path:  # traced only: the stubs stop it at the heads
        jax.jit(lambda v: jmodel.apply(
            v, cohort["jax_graph"], jbatch.patient_idx, jbatch.lab_idx, train=False,
            method=jmodel.predict_lab_values, patient_plan=jbatch.patient_plan,
            lab_plan=jbatch.lab_plan, degrees=jdeg,
        ))(cohort["variables"])
    assert str(port_path.value) == str(jax_path.value) == ("dual" if dual else "single")


def test_train_step_with_dual_heads_matches_jax(cohort):
    jcfg = _jax_config("on")
    cfg = Config.from_dict(jcfg.to_dict())
    jtrainer = JaxTrainer(
        jax_build_model(jcfg, cohort["jax_graph"]), cohort["jax_graph"], cohort["jmasker"], jcfg,
        variables=cohort["variables"],
    )
    model = _port_model(cohort, "on")
    trainer = Trainer(model, cohort["graph"], cohort["masker"], cfg, device="cpu")
    jbatch, batch = jtrainer._get_batch("train"), trainer.get_batch("train")
    rng = np.random.default_rng(0)
    sup = (rng.random(batch.valid.shape[0]) < 0.4).astype(np.float32) * batch.valid.numpy()
    copy = lambda s: jax.tree_util.tree_map(jnp.array, s)  # noqa: E731 (donation)
    jstate, jloss = jtrainer._train_step(
        copy(jtrainer.state), cohort["jax_graph"], jbatch, jtrainer.lab_weights,
        jnp.asarray(sup), jax.random.key(7),
    )
    loss = trainer.train_step(batch, torch.from_numpy(sup), 0)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    want = state_dict_from_flax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    got = model.state_dict()
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        atol = 1e-5 if key.endswith(("running_mean", "running_var")) else 4e-4
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), atol=atol, err_msg=key)
