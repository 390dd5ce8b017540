"""PyTorch port: the CUDA kernels against their plain versions.

Tests marked ``cuda`` need a GPU and skip without one.  This file imports
neither JAX nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Kernels sum with f32 atomics in an order that changes from run to run.  An
f32 sum of n terms taken in another order differs by about sqrt(n) * 6e-8
of its largest partial sums, which can be far above an entry that cancels
to near 0.  So means (sums over up to ~400 terms, divided by their count)
are compared within ``rtol=atol=1e-5``; gradient sums are held per tensor
to ``max |d| <= rel * max |ref|`` with rel 1e-5 for sums of up to ~400
terms and 1e-4 for sums over up to 40k slots; whole forwards within 1e-4
and a train step's parameters within 4e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu_torch.config import Config, GraphConfig, ModelConfig
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
from multi_modal_gnn_tpu_torch.graph import hetero
from multi_modal_gnn_tpu_torch.graph.schema import mirror_edge_type
from multi_modal_gnn_tpu_torch.models import build_model
from multi_modal_gnn_tpu_torch.ops import aggregate_neighbors, aggregation_tier
from multi_modal_gnn_tpu_torch.ops import pairhead_kernels as pk
from multi_modal_gnn_tpu_torch.ops import segment_kernels as sk
from multi_modal_gnn_tpu_torch.ops.pairhead import fused_pair_head
from multi_modal_gnn_tpu_torch.serving import compute_node_state
from multi_modal_gnn_tpu_torch.training import EdgeMasker, Trainer

TOL = dict(rtol=1e-5, atol=1e-5)
NUM_SRC, D = 4096 + 900, 128


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(params=["random", "duplicates"])
def plans(request):
    rng = np.random.default_rng(0)
    if request.param == "duplicates":
        src = np.repeat(rng.integers(0, NUM_SRC, 3_000), 8)
        dst = np.repeat(rng.integers(0, 64, 3_000), 8)
        num_dst = 64
    else:
        src = rng.integers(0, NUM_SRC, 80_000)
        dst = rng.integers(0, 300, 80_000)
        num_dst = 300
    fwd = hetero.pad_edge_set(src, dst, NUM_SRC, num_dst, src_span_rows=256)
    rev = hetero.pad_edge_set(dst, src, num_dst, NUM_SRC)
    assert fwd.span_rows == 256
    return fwd, rev


def _means(total, es):
    return (total[: es.num_dst] / es.dst_count.clamp_min(1.0)[:, None]).cpu().numpy()


def _assert_close_scaled(got, want, rel, name=""):
    """``max |got - want| <= rel * max |want|`` over the whole tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, f"{name}: max |d| {err:.3e} > {rel:g} * {scale:.3e}"


@pytest.mark.cuda
def test_windowed_kernel_matches_plain(gpu, plans):
    es = plans[0].to(gpu)
    x = torch.randn(NUM_SRC, D, generator=torch.Generator().manual_seed(1)).to(gpu)
    args = (es.win_local, es.win_tile_map, es.num_windows)
    before = sk.launch_counts["segment_sum_windowed"]
    got = sk.segment_sum_windowed(x, es.win_src, *args)
    want = sk.segment_sum_windowed_plain(x, es.win_src, *args)
    np.testing.assert_allclose(_means(got, es), _means(want, es), **TOL)
    gathered = x.index_select(0, es.win_src.long())
    got = sk.segment_sum_windowed(gathered, None, *args)
    np.testing.assert_allclose(_means(got, es), _means(want, es), **TOL)
    assert sk.launch_counts["segment_sum_windowed"] == before + 2


@pytest.mark.cuda
def test_fused_table_kernel_matches_plain(gpu, plans):
    es = plans[1].to(gpu)  # the small-source mirror relation
    x = torch.randn(es.num_src, D, generator=torch.Generator().manual_seed(2)).to(gpu)
    args = (es.win_src, es.win_local, es.win_tile_map, es.num_windows)
    got = sk.fused_table_segment_sum(x, *args)
    want = sk.fused_table_segment_sum_plain(x, *args)
    np.testing.assert_allclose(_means(got, es), _means(want, es), **TOL)


@pytest.mark.cuda
def test_span_kernel_matches_plain_and_skips_rows_past_the_table(gpu, plans):
    es = plans[0].to(gpu)
    x = torch.randn(NUM_SRC, D, generator=torch.Generator().manual_seed(3)).to(gpu)
    args = (es.span_src, es.span_local, es.span_tile_map, es.span_base, es.num_windows, es.span_rows)
    want = _means(sk.span_segment_sum_plain(x, *args), es)
    np.testing.assert_allclose(_means(sk.span_segment_sum(x, *args), es), want, **TOL)
    rows_pad = -(-NUM_SRC // 128) * 128
    x_nan = torch.full((rows_pad, D), float("nan"), device=gpu)
    x_nan[:NUM_SRC] = x
    got = _means(sk.span_segment_sum(x_nan, *args), es)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 36, 256])
def test_kernels_at_other_widths(gpu, plans, width):
    # the column loop: lanes past D idle (36), several 128-column passes (256)
    fwd, rev = plans[0].to(gpu), plans[1].to(gpu)
    gen = torch.Generator().manual_seed(width)
    x = torch.randn(NUM_SRC, width, generator=gen).to(gpu)
    xr = torch.randn(rev.num_src, width, generator=gen).to(gpu)
    win = (fwd.win_src, fwd.win_local, fwd.win_tile_map, fwd.num_windows)
    np.testing.assert_allclose(
        _means(sk.segment_sum_windowed(x, *win), fwd),
        _means(sk.segment_sum_windowed_plain(x, *win), fwd), **TOL,
    )
    table = (rev.win_src, rev.win_local, rev.win_tile_map, rev.num_windows)
    np.testing.assert_allclose(
        _means(sk.fused_table_segment_sum(xr, *table), rev),
        _means(sk.fused_table_segment_sum_plain(xr, *table), rev), **TOL,
    )
    span = (fwd.span_src, fwd.span_local, fwd.span_tile_map, fwd.span_base, fwd.num_windows,
            fwd.span_rows)
    if width > 128:  # accumulator + span block exceed a block's shared memory
        with pytest.raises(ValueError):
            sk.span_segment_sum(x, *span)
        return
    np.testing.assert_allclose(
        _means(sk.span_segment_sum(x, *span), fwd),
        _means(sk.span_segment_sum_plain(x, *span), fwd), **TOL,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("width", [36, 128, 256])
def test_fused_table_backward_kernel_matches_plain(gpu, plans, width):
    es = plans[1].to(gpu)  # the small-source relation: dT [num_src, width]
    g = torch.randn(es.num_dst, width, generator=torch.Generator().manual_seed(width)).to(gpu)
    args = (es.win_src, es.win_local, es.win_tile_map, es.num_src)
    before = sk.launch_counts["fused_table_segment_sum_bwd"]
    got = sk.fused_table_segment_sum_bwd(g, *args)
    want = sk.fused_table_segment_sum_bwd_plain(g, *args)
    assert sk.launch_counts["fused_table_segment_sum_bwd"] == before + 1
    # per-source means, as the forward kernels are compared
    real = es.win_local < hetero.WINDOW
    count = torch.bincount(es.win_src[real].long(), minlength=es.num_src).clamp_min(1)[:, None]
    np.testing.assert_allclose((got / count).cpu().numpy(), (want / count).cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["fused_table", "span", "paired", "windowed"])
def test_tier_gradients_match_plain(gpu, plans, tier):
    fwd, rev = plans
    if tier == "fused_table":
        es, mirror = rev, fwd
    elif tier == "paired":
        es, mirror = dataclasses.replace(fwd, span_rows=0), rev
    else:
        es, mirror = fwd, (rev if tier == "span" else None)
    assert aggregation_tier(es, mirror, D) == tier
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(es.num_src, D, generator=gen)
    g = torch.randn(es.num_dst, D, generator=gen)
    grads = []
    for dev in (gpu, torch.device("cpu")):
        xd = x.to(dev).requires_grad_()
        out = aggregate_neighbors(
            xd, es.to(dev), "mean", impl="pallas", edges_rev=None if mirror is None else mirror.to(dev)
        )
        (out * g.to(dev)).sum().backward()
        grads.append(xd.grad.cpu().numpy())
    _assert_close_scaled(grads[0], grads[1], 1e-5, tier)


def _head_problem(num_l, lab_rows, seed=0, batch=40_000, num_p=3000):
    rng = np.random.default_rng(seed)
    p_idx = rng.integers(0, num_p, batch).astype(np.int32)
    l_idx = rng.integers(0, num_l, batch).astype(np.int32)
    plan = hetero.build_gather_plan(p_idx, num_p)
    win_src, win_local = plan.win_src.numpy(), plan.win_local.numpy()
    tile_map = plan.win_tile_map.numpy()
    real = win_local < hetero.WINDOW
    l_s = np.where(real, l_idx[win_src], 0).astype(np.int32)
    bases = None
    if lab_rows:
        moves, e2, win_local, tile_map, bases = hetero.regroup_slots_by_lab_span(
            win_local, tile_map, l_s, num_l, lab_rows
        )
        l2 = np.zeros(e2, np.int32)
        l2[moves[moves >= 0]] = l_s[moves >= 0]
        l_s, bases = l2, torch.from_numpy(bases)
    num_tiles = len(win_local) // hetero.TILE_E
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    gen = torch.Generator().manual_seed(seed)
    params = [
        torch.randn(num_p, 64, generator=gen), torch.randn(num_l, 64, generator=gen),
        torch.randn(64, 32, generator=gen) * 0.1, torch.randn(32, generator=gen) * 0.1,
        torch.randn(32, generator=gen) * 0.1, torch.tensor([0.3]),
    ]
    plan_args = dict(
        lab_idx=t(l_s), win_local=t(np.asarray(win_local, np.int32)),
        win_tile_map=t(np.asarray(tile_map, np.int32)), lab_block_map=bases,
        tile_mask=t(rng.integers(0, 2, num_tiles).astype(np.int32)),
    )
    g = torch.randn(len(win_local), generator=gen) * t(np.asarray(win_local) < 128)
    return params, plan_args, plan.num_windows, lab_rows, g


def _to(args, dev):
    return {k: None if v is None else v.to(dev) for k, v in args.items()}


def _head_call(fn, params, plan_args, lab_rows, seed, rate, masked, *extra):
    a = plan_args
    return fn(
        *params, a["lab_idx"], a["win_local"], a["win_tile_map"], seed,
        a["tile_mask"] if masked else None, a["lab_block_map"], rate, lab_rows, *extra,
    )


# kernel and plain version sum h0 @ W1 in other orders: slots with a layer-1
# unit within the rounding of that sum (< 1e-4 at these magnitudes) of the
# ReLU's kink get no upstream gradient in backward checks
KINK_MARGIN = 1e-3


def _away_from_kinks(g, params, plan_args, lab_rows, seed, rate, masked):
    margin = _head_call(pk.relu_margin_plain, params[:4], plan_args, lab_rows, seed, rate, masked)
    return torch.where(margin > KINK_MARGIN, g, torch.zeros_like(g))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("num_l,lab_rows", [(37, 0), (500, 256)], ids=["full_table", "span256"])
def test_pair_head_kernels_match_plain(gpu, num_l, lab_rows, masked, rate):
    params, plan_args, num_windows, lab_rows, g = _head_problem(num_l, lab_rows)
    seed = (123, 456)
    pg, ag = [p.to(gpu) for p in params], _to(plan_args, gpu)
    before = dict(pk.launch_counts)
    got = _head_call(pk.pair_head_fwd, pg, ag, lab_rows, seed, rate, masked)
    want = _head_call(pk.pair_head_fwd_plain, pg, ag, lab_rows, seed, rate, masked)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)
    g = _away_from_kinks(g.to(gpu), pg, ag, lab_rows, seed, rate, masked)
    got_g = _head_call(pk.pair_head_bwd, pg, ag, lab_rows, seed, rate, masked, num_windows, g)
    want_g = _head_call(pk.pair_head_bwd_plain, pg, ag, lab_rows, seed, rate, masked, g)
    for name, a, b in zip(("proj_p", "proj_l", "w1", "b1", "w2", "b2"), got_g, want_g):
        _assert_close_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-4, name)
    assert pk.launch_counts["pair_head_fwd"] == before["pair_head_fwd"] + 1
    assert pk.launch_counts["pair_head_bwd"] == before["pair_head_bwd"] + 1


@pytest.mark.cuda
def test_pair_head_dropout_keep_rate(gpu):
    """W1 = 0, b1 = 1, w2 = 1: every slot outputs 1.25 x (its kept layer-1
    units of 32), so the kernel's own draws give the keep rate."""
    params, plan_args, _, _, _ = _head_problem(37, 0)
    params[2] = torch.zeros(64, 32)
    params[3] = torch.ones(32)
    params[4] = torch.ones(32)
    params[5] = torch.zeros(1)
    out = _head_call(
        pk.pair_head_fwd, [p.to(gpu) for p in params], _to(plan_args, gpu), 0, (9, 10), 0.2, False
    )
    real = plan_args["win_local"].to(gpu) < 128
    kept = (out[real] / 1.25).round()
    n = int(real.sum()) * 32
    assert n >= 1_000_000
    keep = float(kept.sum()) / n
    assert abs(keep - 0.8) < 5 * (0.8 * 0.2 / n) ** 0.5


@pytest.mark.cuda
def test_pair_head_never_reads_rows_past_the_patients(gpu):
    params, plan_args, num_windows, lab_rows, g = _head_problem(500, 256)
    num_p = params[0].shape[0]
    padded = torch.full((num_windows * 128 + 128, 64), float("nan"))
    padded[:num_p] = params[0]
    pg, ag = [p.to(gpu) for p in params], _to(plan_args, gpu)
    nan_params = [padded.to(gpu)] + pg[1:]
    want = _head_call(pk.pair_head_fwd_plain, pg, ag, lab_rows, (1, 2), 0.2, True)
    got = _head_call(pk.pair_head_fwd, nan_params, ag, lab_rows, (1, 2), 0.2, True)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)
    grads = _head_call(pk.pair_head_bwd, nan_params, ag, lab_rows, (1, 2), 0.2, True, num_windows, g.to(gpu))
    assert all(bool(torch.isfinite(x).all()) for x in grads)
    assert float(grads[0][num_p:].abs().sum()) == 0.0


@pytest.mark.cuda
def test_fused_pair_head_autograd_on_gpu(gpu):
    params, plan_args, num_windows, lab_rows, g = _head_problem(500, 256)
    g = _away_from_kinks(g, params, plan_args, lab_rows, (5, 6), 0.2, True)
    grads = []
    for dev in (gpu, torch.device("cpu")):
        leaves = [p.to(dev).requires_grad_() for p in params]
        a = _to(plan_args, dev)
        out = fused_pair_head(
            *leaves, a["lab_idx"], a["win_local"], a["win_tile_map"], (5, 6), a["tile_mask"],
            a["lab_block_map"], num_windows, 0.2, lab_rows, True,
        )
        (out * g.to(dev)).sum().backward()
        grads.append([leaf.grad.cpu().numpy() for leaf in leaves])
    for name, a, b in zip(("proj_p", "proj_l", "w1", "b1", "w2", "b2"), *grads):
        _assert_close_scaled(a, b, 1e-4, name)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(gpu, plans):
    es = plans[1].to(gpu)
    args = (es.win_src, es.win_local, es.win_tile_map, es.num_windows)
    with pytest.raises(TypeError):
        sk.fused_table_segment_sum(torch.zeros(es.num_src, D, device=gpu, dtype=torch.float64), *args)
    with pytest.raises(ValueError):
        sk.fused_table_segment_sum(torch.zeros(D, es.num_src, device=gpu).t(), *args)
    with pytest.raises(ValueError):
        sk.fused_table_segment_sum(torch.zeros(es.num_src, D, device=gpu), es.win_src.long(), *args[1:])
    with pytest.raises(ValueError):
        sk.fused_table_segment_sum(torch.zeros(es.num_src, D), *args)  # rows on the CPU


@pytest.mark.cuda
def test_slice_on_gpu_matches_plain_on_cpu(gpu):
    spec = SyntheticSpec(
        num_patients=4500, num_labs=50, num_diagnoses=100, num_medications=80,
        mean_labs_per_patient=30.0, mean_diagnoses_per_patient=2.0,
        mean_medications_per_patient=3.0, latent_dim=4, seed=3,
    )
    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0),
        model=ModelConfig(hidden_dim=128, use_pallas=True),
    )
    graph = make_synthetic_graph(spec, config, device="cpu")
    tiers = {
        aggregation_tier(es, graph.edges.get(mirror_edge_type(et)), 128)
        for et, es in graph.edges.items()
    }
    assert tiers == {"fused_table", "span", "paired"}
    model = build_model(config, graph, device="cpu", generator=torch.Generator().manual_seed(0))
    want = compute_node_state(model, graph)
    sk.reset_launch_counts()
    got = compute_node_state(model.to(gpu), graph.to(gpu))
    forward_kernels = ("segment_sum_windowed", "fused_table_segment_sum", "span_segment_sum")
    assert all(sk.launch_counts[k] for k in forward_kernels), sk.launch_counts
    for key in want:
        np.testing.assert_allclose(got[key].cpu().numpy(), want[key].numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_train_step_on_gpu_matches_plain_on_cpu(gpu):
    spec = SyntheticSpec(
        num_patients=4500, num_labs=300, num_diagnoses=100, num_medications=80,
        mean_labs_per_patient=30.0, mean_diagnoses_per_patient=2.0,
        mean_medications_per_patient=3.0, latent_dim=4, seed=3,
    )
    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0),
        model=ModelConfig(use_pallas=True, dropout=0.0, extras={"head_style": "factored"}),
    )
    graph = make_synthetic_graph(spec, config, device="cpu")
    results = []
    for dev in (gpu, torch.device("cpu")):
        model = build_model(config, graph, device="cpu", generator=torch.Generator().manual_seed(0))
        masker = EdgeMasker(graph, slot_major_train=True, slot_major_min_rows=0, lab_block_rows=256)
        trainer = Trainer(model, graph, masker, config, device=dev)
        batch = trainer.get_batch("train")
        sup = masker.supervision_mask(0, masker.get_split("train")).to(dev)
        sk.reset_launch_counts()
        pk.reset_launch_counts()
        loss = trainer.train_step(batch, sup, 0)
        if dev == gpu:
            assert all(sk.launch_counts.values()) and all(pk.launch_counts.values()), (
                sk.launch_counts, pk.launch_counts,
            )
        results.append((loss, {k: v.cpu() for k, v in model.state_dict().items()}))
    assert results[0][0] == pytest.approx(results[1][0], rel=1e-5)
    for key, value in results[1][1].items():
        np.testing.assert_allclose(results[0][1][key].numpy(), value.numpy(), atol=4e-4, err_msg=key)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing(plans):
    es = plans[1]
    x = torch.randn(es.num_src, D)
    sk.reset_launch_counts()
    got = sk.fused_table_segment_sum(x, es.win_src, es.win_local, es.win_tile_map, es.num_windows)
    want = sk.fused_table_segment_sum_plain(x, es.win_src, es.win_local, es.win_tile_map, es.num_windows)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not any(sk.launch_counts.values())


def test_wrappers_reject_other_devices(plans):
    es = plans[1]
    x = torch.empty(es.num_src, D, device="meta")
    with pytest.raises(ValueError):
        sk.fused_table_segment_sum(x, es.win_src, es.win_local, es.win_tile_map, es.num_windows)
