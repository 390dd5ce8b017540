"""PyTorch port: the CUDA kernels against their plain versions.

Tests marked ``cuda`` need a GPU and skip without one.  This file imports
neither JAX nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The K1-K5 cases run in float32 and in bfloat16 (rows, node projections and
W1 in bfloat16, every sum float32): both sides sum the same bfloat16 values,
so the float32 bounds below hold for the segment sums and the float32
gradients.  A pair-head gradient that leaves in bfloat16 is rounded from a
float32 sum in another order, and a slot gradient summed into it may round
to bfloat16 the other way (:func:`_assert_close_bf16`).

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
from multi_modal_gnn_tpu_torch.graph.attn_plan import AttnGroupPlan, _build_side, ensure_attn_plans
from multi_modal_gnn_tpu_torch.graph.schema import mirror_edge_type
from multi_modal_gnn_tpu_torch.models import build_model
from multi_modal_gnn_tpu_torch.ops import aggregate_neighbors, aggregation_tier, gather_rows, segment_sum
from multi_modal_gnn_tpu_torch.ops import attention_kernels as ak
from multi_modal_gnn_tpu_torch.ops import gather_probe as gp
from multi_modal_gnn_tpu_torch.ops.attention import flash_attention_group
from multi_modal_gnn_tpu_torch.ops import pairhead_kernels as pk
from multi_modal_gnn_tpu_torch.ops import segment_kernels as sk
from multi_modal_gnn_tpu_torch.ops.pairhead import fused_pair_head, fused_pair_head_dual
from multi_modal_gnn_tpu_torch.serving import compute_node_state
from multi_modal_gnn_tpu_torch.training import EdgeMasker, Trainer

TOL = dict(rtol=1e-5, atol=1e-5)
NUM_SRC, D = 4096 + 900, 128
DTYPES = [torch.float32, torch.bfloat16]
BF16_ULP = 2.0 ** -7  # the largest bf16 spacing relative to a value (8 significant bits)


def _key(name, dtype):
    """The launch counter a wrapper adds to for rows of ``dtype``."""
    return name + ("_bf16" if dtype == torch.bfloat16 else "")


def _randn(*shape, seed, dtype=torch.float32):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).to(dtype)


def _assert_close_bf16(got, want, name="", share=1e-3):
    """A gradient that leaves in bfloat16: within ``1e-4 * max |want|``
    except where a bfloat16 rounding went the other way (of a slot gradient
    summed into it, or of the result itself, after float32 sums in another
    order): at most ``share`` of the elements, each within one bfloat16
    spacing at the tensor's scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), name
    err, scale = np.abs(got - want), float(np.abs(want).max())
    assert float(err.max()) <= BF16_ULP * scale, f"{name}: max |d| {err.max():.3e} > 2^-7 * {scale:.3e}"
    off = float((err > 1e-4 * scale).mean())
    assert off <= share, f"{name}: {off:.2e} of the elements beyond 1e-4 * {scale:.3e}"


def _assert_grad_close(got, want, name, rel=1e-4):
    """Per gradient, by the dtype it leaves in."""
    if got.dtype == torch.bfloat16:
        _assert_close_bf16(got.float().cpu().numpy(), want.float().cpu().numpy(), name)
    else:
        _assert_close_scaled(got.cpu().numpy(), want.cpu().numpy(), rel, name)


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
@pytest.mark.parametrize("dtype", DTYPES)
def test_windowed_kernel_matches_plain(gpu, plans, dtype):
    es = plans[0].to(gpu)
    x = _randn(NUM_SRC, D, seed=1, dtype=dtype).to(gpu)
    args = (es.win_local, es.win_tile_map, es.num_windows)
    before = sk.launch_counts[_key("segment_sum_windowed", dtype)]
    got = sk.segment_sum_windowed(x, es.win_src, *args)
    want = sk.segment_sum_windowed_plain(x, es.win_src, *args)
    np.testing.assert_allclose(_means(got, es), _means(want, es), **TOL)
    gathered = x.index_select(0, es.win_src.long())
    got = sk.segment_sum_windowed(gathered, None, *args)
    np.testing.assert_allclose(_means(got, es), _means(want, es), **TOL)
    assert sk.launch_counts[_key("segment_sum_windowed", dtype)] == before + 2


def _cut_run_plan(tiles, seed):
    """A windowed plan (``local``, ``tile_map``, ``num_windows``) whose tiles
    hold unsorted runs over six rows of their window, as a span-mode train
    batch does (each window's slots ordered by lab, so a patient's runs are
    cut at chunk boundaries that other runs of it follow): runs of 1-8 or
    1-149 slots, padding at each tile's end, four tiles a window."""
    rng = np.random.default_rng(seed)
    local = np.full((tiles, hetero.TILE_E), hetero.WINDOW, np.int32)
    for t in range(tiles):
        vals = []
        while len(vals) < hetero.TILE_E:
            vals += [int(rng.integers(0, 6))] * int(rng.integers(1, 9) if rng.random() < 0.5 else rng.integers(1, 150))
        real = hetero.TILE_E - int(rng.integers(0, 100))
        local[t, :real] = vals[:real]
    tile_map = np.arange(tiles, dtype=np.int32) // 4
    return torch.from_numpy(local.reshape(-1)), torch.from_numpy(tile_map), -(-tiles // 4)


@pytest.mark.cuda
@pytest.mark.parametrize("width,dtype", [(4, torch.float32), (8, torch.float32), (12, torch.float32),
                                         (32, torch.float32), (128, torch.float32), (8, torch.bfloat16),
                                         (128, torch.bfloat16)])
def test_windowed_kernel_on_unsorted_tiles_with_cut_runs(gpu, width, dtype):
    # K1's device-memory routes merge a run cut at a chunk boundary through
    # shared memory: a later chunk that only starts with the same row is
    # another run (its edge entry unwritten, or added by its own start too)
    local, tile_map, num_windows = _cut_run_plan(256, seed=width)
    local, tile_map = local.to(gpu), tile_map.to(gpu)
    gen = torch.Generator().manual_seed(width)
    rows = torch.randn(local.shape[0], width, generator=gen).to(dtype).to(gpu)
    args = (local, tile_map, num_windows)
    _assert_close_scaled(sk.segment_sum_windowed(rows, None, *args).cpu().numpy(),
                         sk.segment_sum_windowed_plain(rows, None, *args).cpu().numpy(), 1e-4, "gathered")
    table = torch.randn(NUM_SRC, width, generator=gen).to(dtype).to(gpu)  # past the shared route's 2048 rows
    idx = torch.randint(0, NUM_SRC, (local.shape[0],), generator=gen, dtype=torch.int32).to(gpu)
    assert sk.windowed_route(NUM_SRC, width, itemsize=table.element_size()) == "global"
    _assert_close_scaled(sk.segment_sum_windowed(table, idx, *args).cpu().numpy(),
                         sk.segment_sum_windowed_plain(table, idx, *args).cpu().numpy(), 1e-4, "global")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_table_kernel_matches_plain(gpu, plans, dtype):
    es = plans[1].to(gpu)  # the small-source mirror relation
    x = _randn(es.num_src, D, seed=2, dtype=dtype).to(gpu)
    args = (es.win_src, es.win_local, es.win_tile_map, es.num_windows)
    got = sk.fused_table_segment_sum(x, *args)
    want = sk.fused_table_segment_sum_plain(x, *args)
    np.testing.assert_allclose(_means(got, es), _means(want, es), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_span_kernel_matches_plain_and_skips_rows_past_the_table(gpu, plans, dtype):
    es = plans[0].to(gpu)
    x = _randn(NUM_SRC, D, seed=3, dtype=dtype).to(gpu)
    args = (es.span_src, es.span_local, es.span_tile_map, es.span_base, es.num_windows, es.span_rows)
    want = _means(sk.span_segment_sum_plain(x, *args), es)
    np.testing.assert_allclose(_means(sk.span_segment_sum(x, *args), es), want, **TOL)
    rows_pad = -(-NUM_SRC // 128) * 128
    x_nan = torch.full((rows_pad, D), float("nan"), device=gpu, dtype=dtype)
    x_nan[:NUM_SRC] = x
    got = _means(sk.span_segment_sum(x_nan, *args), es)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


# widths a multiple of 4 (float32) or 8 (bfloat16: rows of whole 16-byte chunks)
OTHER_WIDTHS = [(4, torch.float32), (36, torch.float32), (256, torch.float32),
                (8, torch.bfloat16), (40, torch.bfloat16), (256, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("width,dtype", OTHER_WIDTHS)
def test_kernels_at_other_widths(gpu, plans, width, dtype):
    # K1 / K2f: lanes past D idle (36, 40), several 128-column passes (256); K3:
    # a column tail zero in shared memory (4, 36, 8, 40), two column blocks (256)
    fwd, rev = plans[0].to(gpu), plans[1].to(gpu)
    gen = torch.Generator().manual_seed(width)
    x = torch.randn(NUM_SRC, width, generator=gen).to(dtype).to(gpu)
    xr = torch.randn(rev.num_src, width, generator=gen).to(dtype).to(gpu)
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
    np.testing.assert_allclose(
        _means(sk.span_segment_sum(x, *span), fwd),
        _means(sk.span_segment_sum_plain(x, *span), fwd), **TOL,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("width,dtype", OTHER_WIDTHS[:2] + [(128, torch.float32)] + OTHER_WIDTHS[2:])
@pytest.mark.parametrize("num_src", [37, 2048])
def test_fused_table_kernel_on_any_table_the_tier_admits(gpu, num_src, width, dtype):
    # K2f keeps a column slice of every row in shared memory: 37 rows fit
    # whole, 2048 rows at 128 columns take eight 16-column slices (four
    # 32-column slices of bfloat16); rows of NaN past the table are staged
    # but never read
    rng = np.random.default_rng(num_src + width)
    src, dst = rng.integers(0, num_src, 60_000), rng.integers(0, 700, 60_000)
    es = hetero.pad_edge_set(src, dst, num_src, 700).to(gpu)
    x = _randn(num_src, width, seed=width, dtype=dtype).to(gpu)
    args = (es.win_src, es.win_local, es.win_tile_map, es.num_windows)
    itemsize = x.element_size()
    launch = sk.fused_table_launch(es.win_local.shape[0] // hetero.TILE_E, num_src + 5, width, 132, itemsize)
    assert launch.shared_bytes <= sk._MAX_SHARED_BYTES and launch.slices * launch.slice >= width
    x_nan = torch.full((num_src + 5, width), float("nan"), device=gpu, dtype=dtype)
    x_nan[:num_src] = x
    before = sk.launch_counts[_key("fused_table_segment_sum", dtype)]
    got = _means(sk.fused_table_segment_sum(x_nan, *args), es)
    assert sk.launch_counts[_key("fused_table_segment_sum", dtype)] == before + 1
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _means(sk.fused_table_segment_sum_plain(x, *args), es), **TOL)


BWD_WIDTHS = [(36, torch.float32), (128, torch.float32), (256, torch.float32),
              (40, torch.bfloat16), (128, torch.bfloat16), (256, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("width,dtype", BWD_WIDTHS)
def test_fused_table_backward_kernel_matches_plain(gpu, plans, width, dtype):
    es = plans[1].to(gpu)  # the small-source relation: dT [num_src, width]
    g = _randn(es.num_dst, width, seed=width, dtype=dtype).to(gpu)
    args = (es.win_src, es.win_local, es.win_tile_map, es.num_src)
    before = sk.launch_counts[_key("fused_table_segment_sum_bwd", dtype)]
    got = sk.fused_table_segment_sum_bwd(g, *args)
    want = sk.fused_table_segment_sum_bwd_plain(g, *args)
    assert sk.launch_counts[_key("fused_table_segment_sum_bwd", dtype)] == before + 1
    # per-source means, as the forward kernels are compared
    real = es.win_local < hetero.WINDOW
    count = torch.bincount(es.win_src[real].long(), minlength=es.num_src).clamp_min(1)[:, None]
    np.testing.assert_allclose((got / count).cpu().numpy(), (want / count).cpu().numpy(), **TOL)


def _incidence_case(case):
    """An edge set whose plans reach a corner of K2b (a small source table)
    or K3 (a span plan over NUM_SRC sources)."""
    rng = np.random.default_rng(7)
    if case == "partial_chunk":  # 500 sources: chunks of 128, 128, 128, 116
        num_src, num_dst = 500, 700
        src, dst = rng.integers(0, num_src, 30_000), rng.integers(0, num_dst, 30_000)
    elif case == "empty_windows_and_chunks":  # windows 1, 3 and chunks 1, 3 hold no slot
        num_src, num_dst = 500, 512
        src = np.concatenate([rng.integers(0, 128, 6_000), rng.integers(256, 384, 6_000)])
        dst = np.concatenate([rng.integers(0, 128, 6_000), rng.integers(256, 384, 6_000)])
    elif case == "counts_above_2048":  # one edge 3,000 times in one window
        num_src, num_dst = 300, 300
        src = np.concatenate([np.full(3_000, 257), rng.integers(0, num_src, 20_000)])
        dst = np.concatenate([np.full(3_000, 5), rng.integers(0, num_dst, 20_000)])
    else:  # "wide_spans": ~8 slots per source row and window, each edge twice,
        # so span tiles read up to all 256 rows of their span
        src, dst = rng.integers(0, NUM_SRC, 40_000), rng.integers(0, 200, 40_000)
        src, dst = np.repeat(src, 2), np.repeat(dst, 2)
        return hetero.pad_edge_set(src, dst, NUM_SRC, 200, src_span_rows=256)
    return hetero.pad_edge_set(src, dst, num_src, num_dst)


@pytest.mark.cuda
@pytest.mark.parametrize("width,dtype", BWD_WIDTHS)
@pytest.mark.parametrize("case", ["partial_chunk", "empty_windows_and_chunks", "counts_above_2048"])
def test_fused_table_backward_kernel_on_chunks_windows_and_counts(gpu, case, width, dtype):
    # held to the sum in float64: the plain version's own f32 sum of one
    # value added 3,000 times drifts by ~1e-4 of it
    es = _incidence_case(case).to(gpu)
    g = _randn(es.num_dst, width, seed=width, dtype=dtype).to(gpu)
    args = (es.win_src, es.win_local, es.win_tile_map, es.num_src)
    got = sk.fused_table_segment_sum_bwd(g, *args)
    real = es.win_local < hetero.WINDOW
    rows = (torch.repeat_interleave(es.win_tile_map.long(), hetero.TILE_E) * hetero.WINDOW + es.win_local)[real]
    want = torch.zeros(es.num_src, width, dtype=torch.float64, device=gpu)
    want.index_add_(0, es.win_src[real].long(), g.double()[rows])
    count = torch.bincount(es.win_src[real].long(), minlength=es.num_src).clamp_min(1)[:, None]
    np.testing.assert_allclose((got / count).cpu().numpy(), (want / count).cpu().numpy(), **TOL)
    if case == "empty_windows_and_chunks":
        assert not got[128:256].any() and not got[384:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_incidence_kernels_count_a_601_fold_edge(gpu, dtype):
    # K2b and K3 take the edge counts in TF32 (exact to 2048), never in the
    # rows' dtype: 601 copies of one edge, which bfloat16 would count as 600
    rng = np.random.default_rng(601)
    src = np.concatenate([np.full(601, 77), rng.integers(0, NUM_SRC, 80_000)])
    dst = np.concatenate([np.full(601, 9), rng.integers(0, 300, 80_000)])
    fwd = hetero.pad_edge_set(src, dst, NUM_SRC, 300, src_span_rows=256).to(gpu)
    rev = hetero.pad_edge_set(dst, src, 300, NUM_SRC).to(gpu)
    assert fwd.span_rows == 256
    x = _randn(NUM_SRC, D, seed=60, dtype=dtype).to(gpu)
    span = (fwd.span_src, fwd.span_local, fwd.span_tile_map, fwd.span_base, fwd.num_windows, fwd.span_rows)
    want = torch.zeros(fwd.num_dst, D, dtype=torch.float64, device=gpu)
    want.index_add_(0, torch.from_numpy(dst).to(gpu), x.double()[torch.from_numpy(src).to(gpu)])
    got = sk.span_segment_sum(x, *span)[: fwd.num_dst]
    count = fwd.dst_count.clamp_min(1.0)[:, None]
    np.testing.assert_allclose((got / count).cpu().numpy(), (want / count).cpu().numpy(), **TOL)
    g = _randn(rev.num_dst, D, seed=61, dtype=dtype).to(gpu)  # K2b: the mirror's small table
    got = sk.fused_table_segment_sum_bwd(g, rev.win_src, rev.win_local, rev.win_tile_map, rev.num_src)
    want = torch.zeros(rev.num_src, D, dtype=torch.float64, device=gpu)
    want.index_add_(0, torch.from_numpy(dst).to(gpu), g.double()[torch.from_numpy(src).to(gpu)])
    per = torch.bincount(torch.from_numpy(dst).to(gpu), minlength=rev.num_src).clamp_min(1)[:, None]
    np.testing.assert_allclose((got / per).cpu().numpy(), (want / per).cpu().numpy(), **TOL)
    assert abs(float(got[9, 0]) - float(want[9, 0])) <= 1e-5 * abs(float(want[9, 0])) + 1e-5


@pytest.mark.cuda
def test_bf16_autograd_step_through_the_kernels(gpu, plans):
    """A bfloat16 step on the card through _KernelAggregate (span forward,
    K1 backward) and fused_pair_head (K4f / K4b) against the same step's
    plain versions on the CPU: the bfloat16 kernels launch, and the
    gradients agree as bfloat16 gradients do."""
    fwd, rev = plans
    params, plan_args, num_windows, lab_rows, g = _head_problem(500, 256, seed=21)
    x = _randn(NUM_SRC, D, seed=22, dtype=torch.bfloat16)
    w = _randn(D, 64, seed=23) * 0.1
    before = dict(sk.launch_counts, **pk.launch_counts)
    grads = []
    for dev in (gpu, torch.device("cpu")):
        xd = x.to(dev).requires_grad_()
        leaves = [p.to(dev).requires_grad_() for p in _as(params, torch.bfloat16)]
        agg = aggregate_neighbors(xd, fwd.to(dev), "mean", impl="pallas", edges_rev=rev.to(dev))
        assert agg.dtype == torch.bfloat16
        mixed = (agg.float() @ w.to(dev)).to(torch.bfloat16)  # the first num_dst patients' rows
        pad = torch.zeros(leaves[0].shape[0] - mixed.shape[0], 64, dtype=torch.bfloat16, device=dev)
        pp = leaves[0] + torch.cat([mixed, pad])
        a = _to(plan_args, dev)
        out = fused_pair_head(
            pp.contiguous(), *leaves[1:], a["lab_idx"], a["win_local"], a["win_tile_map"], (5, 6),
            a["tile_mask"], a["lab_block_map"], num_windows, 0.2, lab_rows, True,
        )
        assert out.dtype == torch.float32
        (out * g.to(dev)).sum().backward()
        grads.append([xd.grad] + [leaf.grad for leaf in leaves])
    for key in ("span_segment_sum_bf16", "segment_sum_windowed_bf16", "pair_head_fwd_bf16",
                "pair_head_bwd_bf16"):
        assert dict(sk.launch_counts, **pk.launch_counts)[key] > before[key], key
    for name, a, b in zip(("x", "proj_p", "proj_l", "w1", "b1", "w2", "b2"), *grads):
        assert a.dtype == b.dtype, name
        _assert_close_bf16(a.float().cpu().numpy(), b.float().cpu().numpy(), name, share=1e-2)


@pytest.mark.cuda
def test_bf16_row_scatters_sum_in_float32_on_the_card(gpu):
    """On the card, gather_rows' backward and segment_sum on bfloat16 rows
    (40,000 rows into 50, as a pair head's lab gradients are summed) give
    the float32 sum rounded once, within one bfloat16 spacing and the float32
    atomics' reordering (1e-5 of the largest total); bfloat16 atomics, which
    round at every add, miss it by percents.  segment_sum sums in float64
    there, so its totals are bit-equal from call to call."""
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 50, 40_000))
    g = _randn(40_000, 64, seed=31, dtype=torch.bfloat16)
    exact = torch.zeros(50, 64, dtype=torch.float64).index_add_(0, idx, g.double())
    spacing = exact.abs() * BF16_ULP + 1e-5 * exact.abs().max()
    x = torch.zeros(50, 64, dtype=torch.bfloat16, device=gpu, requires_grad=True)
    gather_rows(x, idx.to(gpu)).backward(g.to(gpu))
    for name, got in (("gather_rows backward", x.grad), ("segment_sum", segment_sum(g.to(gpu), idx.to(gpu), 50))):
        assert got.dtype == torch.bfloat16, name
        assert ((got.double().cpu() - exact).abs() <= spacing).all(), name
    first = segment_sum(g.to(gpu), idx.to(gpu), 50)
    assert all(torch.equal(segment_sum(g.to(gpu), idx.to(gpu), 50), first) for _ in range(5))


@pytest.mark.cuda
@pytest.mark.parametrize("width,dtype", OTHER_WIDTHS[:2] + [(128, torch.float32)] + OTHER_WIDTHS[2:])
def test_span_kernel_on_tiles_wider_than_a_slice(gpu, width, dtype):
    es = _incidence_case("wide_spans").to(gpu)
    assert es.span_rows == 256
    real = es.span_local < hetero.WINDOW
    rel = (es.span_src - torch.repeat_interleave(es.span_base, hetero.TILE_E))[real]
    assert int(rel.max()) >= 192  # a tile reads past its sixth 32-row slice
    x = _randn(NUM_SRC, width, seed=width, dtype=dtype).to(gpu)
    args = (es.span_src, es.span_local, es.span_tile_map, es.span_base, es.num_windows, es.span_rows)
    want = _means(sk.span_segment_sum_plain(x, *args), es)
    np.testing.assert_allclose(_means(sk.span_segment_sum(x, *args), es), want, **TOL)
    x_nan = torch.full((NUM_SRC + 300, width), float("nan"), device=gpu, dtype=dtype)
    x_nan[:NUM_SRC] = x
    np.testing.assert_allclose(_means(sk.span_segment_sum(x_nan, *args), es), want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tier", ["fused_table", "span", "paired", "windowed"])
def test_tier_gradients_match_plain(gpu, plans, tier, dtype):
    # bfloat16: the gradient leaves in bfloat16, rounded from float32 sums
    # taken in another order (one spacing at most, and rarely)
    fwd, rev = plans
    if tier == "fused_table":
        es, mirror = rev, fwd
    elif tier == "paired":
        es, mirror = dataclasses.replace(fwd, span_rows=0), rev
    else:
        es, mirror = fwd, (rev if tier == "span" else None)
    assert aggregation_tier(es, mirror, D, itemsize=torch.finfo(dtype).bits // 8) == tier
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(es.num_src, D, generator=gen).to(dtype)
    g = torch.randn(es.num_dst, D, generator=gen).to(dtype)
    grads = []
    for dev in (gpu, torch.device("cpu")):
        xd = x.to(dev).requires_grad_()
        out = aggregate_neighbors(
            xd, es.to(dev), "mean", impl="pallas", edges_rev=None if mirror is None else mirror.to(dev)
        )
        assert out.dtype == dtype
        (out * g.to(dev)).sum().backward()
        grads.append(xd.grad)
    _assert_grad_close(grads[0], grads[1], tier, 1e-5)


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


def _as(params, dtype):
    """A head's (proj_p, proj_l, w1, b1, w2, b2) with the first three in
    ``dtype`` (the kernels' operand dtype; b1, w2, b2 stay float32)."""
    return [p.to(dtype) if i % 6 < 3 else p for i, p in enumerate(params)]


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
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("num_l,lab_rows", [(37, 0), (500, 256)], ids=["full_table", "span256"])
def test_pair_head_kernels_match_plain(gpu, num_l, lab_rows, masked, rate, dtype):
    params, plan_args, num_windows, lab_rows, g = _head_problem(num_l, lab_rows)
    seed = (123, 456)
    pg, ag = [p.to(gpu) for p in _as(params, dtype)], _to(plan_args, gpu)
    before = dict(pk.launch_counts)
    got = _head_call(pk.pair_head_fwd, pg, ag, lab_rows, seed, rate, masked)
    want = _head_call(pk.pair_head_fwd_plain, pg, ag, lab_rows, seed, rate, masked)
    assert got.dtype == want.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)
    g = _away_from_kinks(g.to(gpu), pg, ag, lab_rows, seed, rate, masked)
    got_g = _head_call(pk.pair_head_bwd, pg, ag, lab_rows, seed, rate, masked, num_windows, g)
    want_g = _head_call(pk.pair_head_bwd_plain, pg, ag, lab_rows, seed, rate, masked, g)
    for name, a, b, x in zip(("proj_p", "proj_l", "w1", "b1", "w2", "b2"), got_g, want_g, pg):
        assert a.dtype == b.dtype == x.dtype, name
        _assert_grad_close(a, b, name)
    assert pk.launch_counts[_key("pair_head_fwd", dtype)] == before[_key("pair_head_fwd", dtype)] + 1
    assert pk.launch_counts[_key("pair_head_bwd", dtype)] == before[_key("pair_head_bwd", dtype)] + 1


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
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lab_rows", [0, 256])
@pytest.mark.parametrize("num_l", [37, 500, 720, 2048])
def test_pair_head_backward_at_any_lab_count(gpu, num_l, lab_rows, dtype):
    # K4b keeps no lab table in shared memory: any lab count, span tiles or
    # the full table, with dropout and both kinds of masked tile
    params, plan_args, num_windows, lab_rows, g = _head_problem(num_l, lab_rows, seed=num_l)
    seed = (31, 41)
    pg, ag = [p.to(gpu) for p in _as(params, dtype)], _to(plan_args, gpu)
    g = _away_from_kinks(g.to(gpu), pg, ag, lab_rows, seed, 0.2, True)
    before = pk.launch_counts[_key("pair_head_bwd", dtype)]
    got = _head_call(pk.pair_head_bwd, pg, ag, lab_rows, seed, 0.2, True, num_windows, g)
    want = _head_call(pk.pair_head_bwd_plain, pg, ag, lab_rows, seed, 0.2, True, g)
    assert pk.launch_counts[_key("pair_head_bwd", dtype)] == before + 1
    for name, a, b in zip(("proj_p", "proj_l", "w1", "b1", "w2", "b2"), got, want):
        _assert_grad_close(a, b, name)


# -- the dual pair head (K5f, K5b) --------------------------------------------


def _dual_problem(num_l, seed=0):
    """Two heads' random weights on one slot-major batch (full lab table),
    and an upstream gradient per head."""
    params_t, plan_args, num_windows, _, g_t = _head_problem(num_l, 0, seed)
    gen = torch.Generator().manual_seed(seed + 100)
    params_g = [
        torch.randn(params_t[0].shape, generator=gen), torch.randn(num_l, 64, generator=gen),
        torch.randn(64, 32, generator=gen) * 0.1, torch.randn(32, generator=gen) * 0.1,
        torch.randn(32, generator=gen) * 0.1, torch.tensor([-0.2]),
    ]
    num_tiles = plan_args["win_local"].shape[0] // hetero.TILE_E
    plan_args["gnn_mask"] = torch.from_numpy(
        np.random.default_rng(seed + 7).integers(0, 2, num_tiles).astype(np.int32)
    )
    g_g = torch.randn(g_t.shape, generator=gen) * (plan_args["win_local"] < 128)
    return params_t + params_g, plan_args, num_windows, (g_t, g_g)


def _dual_call(fn, params, a, seed4, rate, masked, *extra):
    masks = (a["tile_mask"], a["gnn_mask"]) if masked else (None, None)
    return fn(*params, a["lab_idx"], a["win_local"], a["win_tile_map"], seed4, *masks, rate, *extra)


def _dual_away_from_kinks(g, params, a, seed4, rate, masked):
    margins = _dual_call(pk.relu_margin_dual_plain, params[0:4] + params[6:10], a, seed4, rate, masked)
    return [torch.where(m > KINK_MARGIN, x, torch.zeros_like(x)) for m, x in zip(margins, g)]


DUAL_NAMES = [f"{h}.{n}" for h in ("tab", "gnn") for n in ("proj_p", "proj_l", "w1", "b1", "w2", "b2")]


# -- K4f and K5f, the tensor-core forwards: lab counts, the span slice and
# the full table, units past the first wave (taken from the counter), small
# batches, a head masked on every tile, rows past num_p / num_l ------------


def _short_tables(params, plan_args, cut_p=200, cut_l=3):
    """The head's tables ``cut_p`` patients and ``cut_l`` labs short, and
    every 7th slot's lab id past the table: those slots read zero rows."""
    params = list(params)
    params[0], params[1] = params[0][:-cut_p].contiguous(), params[1][:-cut_l].contiguous()
    lab = plan_args["lab_idx"].clone()
    lab[::7] = params[1].shape[0] + 5
    return params, {**plan_args, "lab_idx": lab}


def _fwd_close(got, want):
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lab_rows", [0, 256], ids=["full_table", "span256"])
@pytest.mark.parametrize("num_l", [37, 500, 720, 2048])
def test_pair_head_fwd_matches_plain_at_any_lab_count(gpu, num_l, lab_rows, masked, rate, dtype):
    params, plan_args, _, lab_rows, _ = _head_problem(num_l, lab_rows, seed=num_l + 1)
    pg, ag = [p.to(gpu) for p in _as(params, dtype)], _to(plan_args, gpu)
    before = dict(pk.launch_counts)
    got = _head_call(pk.pair_head_fwd, pg, ag, lab_rows, (27, 18), rate, masked)
    assert pk.launch_counts[_key("pair_head_fwd", dtype)] == before[_key("pair_head_fwd", dtype)] + 1
    assert pk.launch_counts["pair_head_dual_fwd"] == before["pair_head_dual_fwd"]
    _fwd_close([got], [_head_call(pk.pair_head_fwd_plain, pg, ag, lab_rows, (27, 18), rate, masked)])


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lab_rows", [0, 256], ids=["full_table", "span256"])
def test_pair_head_fwd_takes_units_from_the_counter(gpu, lab_rows, masked):
    # ~7,000 units: more than the 2 x 132 blocks' 2,112 warps take by index
    params, plan_args, _, lab_rows, _ = _head_problem(500, lab_rows, seed=3, batch=700_000, num_p=20_000)
    units = plan_args["win_local"].shape[0] // pk.FWD_UNIT
    assert units > pk.fwd_launch(units // 8, 132).blocks * pk.FWD_WARPS
    pg, ag = [p.to(gpu) for p in params], _to(plan_args, gpu)
    got = _head_call(pk.pair_head_fwd, pg, ag, lab_rows, (4, 5), 0.2, masked)
    _fwd_close([got], [_head_call(pk.pair_head_fwd_plain, pg, ag, lab_rows, (4, 5), 0.2, masked)])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 300, 5_000])
def test_pair_head_fwd_on_small_batches(gpu, batch):
    # one tile (mostly padding slots) to a few: fewer units than one block's warps
    params, plan_args, _, lab_rows, _ = _head_problem(500, 256, seed=batch, batch=batch, num_p=400)
    pg, ag = [p.to(gpu) for p in params], _to(plan_args, gpu)
    for masked in (False, True):
        got = _head_call(pk.pair_head_fwd, pg, ag, lab_rows, (8, 9), 0.2, masked)
        _fwd_close([got], [_head_call(pk.pair_head_fwd_plain, pg, ag, lab_rows, (8, 9), 0.2, masked)])
        assert float(got[ag["win_local"] >= 128].abs().sum()) == 0.0  # padding slots output 0


@pytest.mark.cuda
def test_pair_head_fwd_masked_on_every_tile_outputs_zeros(gpu):
    params, plan_args, _, lab_rows, _ = _head_problem(500, 256, seed=11)
    plan_args["tile_mask"] = torch.zeros_like(plan_args["tile_mask"])
    out = _head_call(pk.pair_head_fwd, [p.to(gpu) for p in params], _to(plan_args, gpu), lab_rows, (1, 1),
                     0.2, True)
    assert out.shape == plan_args["win_local"].shape and float(out.abs().sum()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("lab_rows", [0, 256], ids=["full_table", "span256"])
def test_pair_head_fwd_reads_zero_rows_past_num_p_and_num_l(gpu, lab_rows):
    params, plan_args, _, lab_rows, _ = _head_problem(500, lab_rows, seed=12)
    params, plan_args = _short_tables(params, plan_args)
    pg, ag = [p.to(gpu) for p in params], _to(plan_args, gpu)
    for rate in (0.0, 0.2):
        got = _head_call(pk.pair_head_fwd, pg, ag, lab_rows, (2, 3), rate, True)
        _fwd_close([got], [_head_call(pk.pair_head_fwd_plain, pg, ag, lab_rows, (2, 3), rate, True)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("num_l", [37, 500, 720, 2048])
def test_dual_fwd_matches_plain_at_any_lab_count(gpu, num_l, masked, rate, dtype):
    params, plan_args, _, _ = _dual_problem(num_l, seed=num_l + 2)
    pg, ag = [p.to(gpu) for p in _as(params, dtype)], _to(plan_args, gpu)
    before = dict(pk.launch_counts)
    got = _dual_call(pk.pair_head_dual_fwd, pg, ag, (6, 7, 8, 9), rate, masked)
    assert pk.launch_counts[_key("pair_head_dual_fwd", dtype)] == before[_key("pair_head_dual_fwd", dtype)] + 1
    assert pk.launch_counts["pair_head_fwd"] == before["pair_head_fwd"]
    _fwd_close(got, _dual_call(pk.pair_head_dual_fwd_plain, pg, ag, (6, 7, 8, 9), rate, masked))


@pytest.mark.cuda
def test_dual_fwd_takes_units_from_both_counters(gpu):
    params, plan_args, _, _ = _dual_problem(500, seed=5)
    big, big_args, _, _, _ = _head_problem(500, 0, seed=5, batch=700_000, num_p=20_000)
    gen = torch.Generator().manual_seed(5)
    params = big + [torch.randn(big[0].shape, generator=gen), torch.randn(big[1].shape, generator=gen)] + params[8:]
    num_tiles = big_args["win_local"].shape[0] // 1024
    big_args["gnn_mask"] = torch.from_numpy(np.random.default_rng(5).integers(0, 2, num_tiles).astype(np.int32))
    pg, ag = [p.to(gpu) for p in params], _to(big_args, gpu)
    for masked in (False, True):
        got = _dual_call(pk.pair_head_dual_fwd, pg, ag, (1, 2, 3, 4), 0.2, masked)
        _fwd_close(got, _dual_call(pk.pair_head_dual_fwd_plain, pg, ag, (1, 2, 3, 4), 0.2, masked))


@pytest.mark.cuda
def test_dual_fwd_with_a_head_masked_on_every_tile(gpu):
    params, plan_args, _, _ = _dual_problem(500, seed=13)
    plan_args["tile_mask"] = torch.zeros_like(plan_args["tile_mask"])  # the tabular head's
    pg, ag = [p.to(gpu) for p in params], _to(plan_args, gpu)
    got = _dual_call(pk.pair_head_dual_fwd, pg, ag, (1, 2, 3, 4), 0.2, True)
    assert float(got[0].abs().sum()) == 0.0
    _fwd_close(got, _dual_call(pk.pair_head_dual_fwd_plain, pg, ag, (1, 2, 3, 4), 0.2, True))


@pytest.mark.cuda
def test_dual_fwd_reads_zero_rows_past_num_p_and_num_l(gpu):
    params, plan_args, _, _ = _dual_problem(500, seed=14)
    tab, plan_args = _short_tables(params[:6], plan_args)
    gnn, _ = _short_tables(params[6:], plan_args)
    pg, ag = [p.to(gpu) for p in tab + gnn], _to(plan_args, gpu)
    for rate in (0.0, 0.2):
        got = _dual_call(pk.pair_head_dual_fwd, pg, ag, (5, 6, 7, 8), rate, True)
        _fwd_close(got, _dual_call(pk.pair_head_dual_fwd_plain, pg, ag, (5, 6, 7, 8), rate, True))


@pytest.mark.cuda
def test_forward_launches_leave_their_counters_zero(gpu):
    # K4f and K5f share one counter buffer a stream, which each launch's last
    # block zeroes: launches in a row, on two streams, each match the plain version
    params, plan_args, _, lab_rows, _ = _head_problem(500, 256, seed=15, batch=200_000, num_p=8_000)
    dual, dual_args, _, _ = _dual_problem(500, seed=16)
    pg, ag = [p.to(gpu) for p in params], _to(plan_args, gpu)
    dg, dag = [p.to(gpu) for p in dual], _to(dual_args, gpu)
    want = _head_call(pk.pair_head_fwd_plain, pg, ag, lab_rows, (3, 4), 0.2, True)
    want_dual = _dual_call(pk.pair_head_dual_fwd_plain, dg, dag, (1, 2, 3, 4), 0.2, True)
    side = torch.cuda.Stream(gpu)
    side.wait_stream(torch.cuda.current_stream(gpu))  # the inputs are ready
    for stream in (torch.cuda.current_stream(gpu), side):
        with torch.cuda.stream(stream):
            for _ in range(3):
                _fwd_close([_head_call(pk.pair_head_fwd, pg, ag, lab_rows, (3, 4), 0.2, True)], [want])
                _fwd_close(_dual_call(pk.pair_head_dual_fwd, dg, dag, (1, 2, 3, 4), 0.2, True), want_dual)
            work = pk._fwd_counters(torch.device(gpu), stream)
            assert work.tolist() == [0, 0, 0]
    torch.cuda.synchronize(gpu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("num_l", [37, 500])
def test_dual_pair_head_kernels_match_plain(gpu, num_l, masked, rate, dtype):
    params, plan_args, num_windows, g = _dual_problem(num_l)
    seed4 = (123, 456, 789, 1011)
    pg, ag = [p.to(gpu) for p in _as(params, dtype)], _to(plan_args, gpu)
    before = dict(pk.launch_counts)
    got = _dual_call(pk.pair_head_dual_fwd, pg, ag, seed4, rate, masked)
    want = _dual_call(pk.pair_head_dual_fwd_plain, pg, ag, seed4, rate, masked)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5, atol=1e-5)
    g = _dual_away_from_kinks([x.to(gpu) for x in g], pg, ag, seed4, rate, masked)
    got_g = _dual_call(pk.pair_head_dual_bwd, pg, ag, seed4, rate, masked, num_windows, *g)
    want_g = _dual_call(pk.pair_head_dual_bwd_plain, pg, ag, seed4, rate, masked, *g)
    for name, a, b in zip(DUAL_NAMES, got_g, want_g):
        _assert_grad_close(a, b, name)
    for name, n in (("pair_head_dual_fwd", 1), ("pair_head_dual_bwd", 1), ("pair_head_fwd", 0)):
        assert pk.launch_counts[_key(name, dtype)] == before[_key(name, dtype)] + n


@pytest.mark.cuda
@pytest.mark.parametrize("num_l", [720, 2048])
def test_dual_pair_head_backward_at_any_lab_count(gpu, num_l):
    params, plan_args, num_windows, g = _dual_problem(num_l, seed=num_l)
    seed4 = (3, 1, 4, 1)
    pg, ag = [p.to(gpu) for p in params], _to(plan_args, gpu)
    g = _dual_away_from_kinks([x.to(gpu) for x in g], pg, ag, seed4, 0.2, True)
    got = _dual_call(pk.pair_head_dual_bwd, pg, ag, seed4, 0.2, True, num_windows, *g)
    want = _dual_call(pk.pair_head_dual_bwd_plain, pg, ag, seed4, 0.2, True, *g)
    for name, a, b in zip(DUAL_NAMES, got, want):
        _assert_close_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-4, name)


@pytest.mark.cuda
def test_dual_pair_head_never_reads_rows_past_the_tables(gpu):
    params, plan_args, num_windows, g = _dual_problem(500)
    num_p, num_l = params[0].shape[0], params[1].shape[0]
    padded = []
    for i, p in enumerate(params):
        if i % 6 in (0, 1):  # proj_p past the window-padded rows, proj_l past its labs
            rows = num_windows * 128 + 128 if i % 6 == 0 else num_l + 12
            x = torch.full((rows, 64), float("nan"))
            x[: p.shape[0]] = p
            p = x
        padded.append(p.to(gpu))
    pg, ag = [p.to(gpu) for p in params], _to(plan_args, gpu)
    seed4 = (1, 2, 3, 4)
    want = _dual_call(pk.pair_head_dual_fwd_plain, pg, ag, seed4, 0.2, True)
    got = _dual_call(pk.pair_head_dual_fwd, padded, ag, seed4, 0.2, True)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5, atol=1e-5)
    grads = _dual_call(pk.pair_head_dual_bwd, padded, ag, seed4, 0.2, True, num_windows,
                       *[x.to(gpu) for x in g])
    assert all(bool(torch.isfinite(x).all()) for x in grads)
    for h in (0, 6):
        assert float(grads[h][num_p:].abs().sum()) == 0.0
        assert float(grads[h + 1][num_l:].abs().sum()) == 0.0


@pytest.mark.cuda
def test_dual_pair_head_dropout_keep_rate(gpu):
    """W1 = 0, b1 = 1, w2 = 1 in both heads: a slot outputs 1.25 x its kept
    layer-1 units of 32 per head, so the kernel's draws give each head's
    keep rate; the two heads draw different columns of one stream."""
    params, plan_args, _, _ = _dual_problem(37)
    for h in (0, 6):
        params[h + 2], params[h + 3] = torch.zeros(64, 32), torch.ones(32)
        params[h + 4], params[h + 5] = torch.ones(32), torch.zeros(1)
    out_t, out_g = _dual_call(
        pk.pair_head_dual_fwd, [p.to(gpu) for p in params], _to(plan_args, gpu), (9, 10, 11, 12), 0.2,
        False,
    )
    real = plan_args["win_local"].to(gpu) < 128
    n = int(real.sum()) * 32
    assert n >= 1_000_000
    kept = [(out[real] / 1.25).round() for out in (out_t, out_g)]
    for k in kept:
        assert abs(float(k.sum()) / n - 0.8) < 5 * (0.8 * 0.2 / n) ** 0.5
    assert not torch.equal(kept[0], kept[1])


@pytest.mark.cuda
def test_fused_pair_head_dual_autograd_on_gpu(gpu):
    params, plan_args, num_windows, g = _dual_problem(500)
    seed4 = (5, 6, 7, 8)
    g = _dual_away_from_kinks(g, params, plan_args, seed4, 0.2, True)
    grads = []
    for dev in (gpu, torch.device("cpu")):
        leaves = [p.to(dev).requires_grad_() for p in params]
        a = _to(plan_args, dev)
        outs = fused_pair_head_dual(
            *leaves, a["lab_idx"], a["win_local"], a["win_tile_map"], seed4, a["tile_mask"],
            a["gnn_mask"], num_windows, 0.2,
        )
        sum((o * x.to(dev)).sum() for o, x in zip(outs, g)).backward()
        grads.append([leaf.grad.cpu().numpy() for leaf in leaves])
    for name, a, b in zip(DUAL_NAMES, *grads):
        _assert_close_scaled(a, b, 1e-4, name)


# The dual step's gradients, card against CPU, per tensor in the 2-norm: the
# largest drift measured on an NVIDIA H100 80GB HBM3 (700.00 W) was 3.31e-3
# of a norm (conv_0.root_patient__has_diagnosis__diagnosis.weight; ``-s``
# prints each tensor's).  Held to three times that, plus 1e-6 of the largest
# norm for gradients that are exactly 0.
DUAL_STEP_GRAD_REL = 1e-2
# Elements whose gradient the two sides do not know to within its own size
# may be exempt from the parameter check, at most this share of the model's
# 1,121,410: three times the 686 measured on the same card, of which 170
# ended more than 4e-4 apart with gradients of opposite sign, each below
# 2.1e-6 in size.
DUAL_STEP_NOISY_SHARE = 2e-3


@pytest.mark.cuda
def test_dual_train_step_on_gpu_matches_plain_on_cpu(gpu):
    """``dual_head_fusion: on`` with the full lab table: one step on the card
    runs K5f and K5b and no K4, and matches the plain versions on the CPU.

    Loss within 1e-5; each gradient tensor within ``DUAL_STEP_GRAD_REL`` of
    its norm; parameters and BatchNorm statistics within 4e-4, as in the
    single-head step, except where the two sides' effective gradients
    (with Adam's coupled decay) g0, g1 differ by more than the smaller of
    them.  There the gradient is rounding noise near 0, and Adam's first
    step, ``lr * g / (|g| + eps)``, turns it into a step of up to ``lr``
    either way: such an element's parameters must differ by what that
    step gives from the two gradients, within 4e-4.  ``-s`` prints the
    elements that take the other sign."""
    spec = SyntheticSpec(
        num_patients=4500, num_labs=300, num_diagnoses=100, num_medications=80,
        mean_labs_per_patient=30.0, mean_diagnoses_per_patient=2.0,
        mean_medications_per_patient=3.0, latent_dim=4, seed=3,
    )
    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0),
        model=ModelConfig(
            use_pallas=True, dropout=0.0, extras={"head_style": "factored", "dual_head_fusion": "on"},
        ),
    )
    graph = make_synthetic_graph(spec, config, device="cpu")
    results = []
    for dev in (gpu, torch.device("cpu")):
        model = build_model(config, graph, device="cpu", generator=torch.Generator().manual_seed(0))
        before = {n: p.detach().clone().double() for n, p in model.named_parameters()}
        masker = EdgeMasker(graph, slot_major_train=True, slot_major_min_rows=0)
        trainer = Trainer(model, graph, masker, config, device=dev)
        groups = trainer.optimizer.param_groups
        decay = {id(p): group["weight_decay"] for group in groups for p in group["params"]}
        lr, eps = groups[0]["lr"], groups[0]["eps"]
        batch = trainer.get_batch("train")
        sup = masker.supervision_mask(0, masker.get_split("train")).to(dev)
        pk.reset_launch_counts()
        loss = trainer.train_step(batch, sup, 0)
        if dev == gpu:
            assert pk.launch_counts == {
                "pair_head_fwd": 0, "pair_head_bwd": 0, "pair_head_dual_fwd": 1, "pair_head_dual_bwd": 1,
                "pair_head_fwd_bf16": 0, "pair_head_bwd_bf16": 0, "pair_head_dual_fwd_bf16": 0,
                "pair_head_dual_bwd_bf16": 0,
            }
        grads = {n: p.grad.cpu().double() + decay[id(p)] * before[n] for n, p in model.named_parameters()}
        results.append((loss, grads, {k: v.cpu().double() for k, v in model.state_dict().items()}))
    (loss_gpu, grads_gpu, state_gpu), (loss_cpu, grads_cpu, state_cpu) = results
    floor = 1e-6 * max(float(g.norm()) for g in grads_cpu.values())
    drift, bad, noisy = {}, [], 0
    for name, want in grads_cpu.items():
        err = float((grads_gpu[name] - want).norm())
        drift[name] = err / max(float(want.norm()), 1e-30)
        if err > DUAL_STEP_GRAD_REL * float(want.norm()) + floor:
            bad.append(f"gradient {name}: ||d|| {err:.3e}, ||ref|| {float(want.norm()):.3e}")
    print("gradient drift per tensor, ||d|| / ||ref||:", {k: f"{v:.2e}" for k, v in drift.items()})
    adam_step = lambda g: -lr * g / (g.abs() + eps)  # noqa: E731  Adam's first step
    for key, want in state_cpu.items():
        diff = state_gpu[key] - want
        off = diff.abs() > 4e-4
        if key in grads_cpu:
            g0, g1 = grads_gpu[key], grads_cpu[key]
            rounding = (g0 - g1).abs() > torch.minimum(g0.abs(), g1.abs())
            noisy += int(rounding.sum())
            for i in map(tuple, torch.nonzero(off & (torch.sign(g0) != torch.sign(g1))).tolist()):
                print(f"{key}{list(i)}: gradient card {float(g0[i]):+.3e}, cpu {float(g1[i]):+.3e}; "
                      f"parameter card {float(state_gpu[key][i]):+.6f}, cpu {float(want[i]):+.6f}")
            explained = (diff - (adam_step(g0) - adam_step(g1))).abs() <= 4e-4
            off = off & ~(rounding & explained)
        if bool(off.any()):
            bad.append(f"parameter {key}: {int(off.sum())} elements off by up to {float(diff.abs()[off].max()):.3e}")
    total = sum(g.numel() for g in grads_cpu.values())
    print(f"elements whose gradient is rounding noise: {noisy} of {total}")
    assert loss_gpu == pytest.approx(loss_cpu, rel=1e-5)
    if bad:
        pytest.fail("\n".join(bad))
    assert noisy <= DUAL_STEP_NOISY_SHARE * total


# chip_smoke.py phase 8's tolerances for a whole step, card against CPU
STEP_GRAD_NORM_REL, STEP_GRAD_ZERO_FLOOR, STEP_PARAM_ATOL = 3e-2, 1e-6, 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dual", ["off", "on"])
def test_train_step_with_720_labs_on_gpu_matches_plain_on_cpu(gpu, dual):
    """``mimic_scale``'s 720 labs: one step launches K4b over span@256 lab
    tiles (dual off) or K5b over the full lab table (dual on) and matches
    the plain versions on the CPU at phase 8's tolerances."""
    spec = SyntheticSpec(
        num_patients=4500, num_labs=720, num_diagnoses=100, num_medications=80,
        mean_labs_per_patient=30.0, mean_diagnoses_per_patient=2.0,
        mean_medications_per_patient=3.0, latent_dim=4, seed=3,
    )
    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0),
        model=ModelConfig(
            use_pallas=True, dropout=0.0, extras={"head_style": "factored", "dual_head_fusion": dual},
        ),
    )
    graph = make_synthetic_graph(spec, config, device="cpu")
    lab_rows = 0 if dual == "on" else 256
    results = []
    for dev in (gpu, torch.device("cpu")):
        model = build_model(config, graph, device="cpu", generator=torch.Generator().manual_seed(0))
        masker = EdgeMasker(graph, slot_major_train=True, slot_major_min_rows=0, lab_block_rows=lab_rows)
        trainer = Trainer(model, graph, masker, config, device=dev)
        batch = trainer.get_batch("train")
        sup = masker.supervision_mask(0, masker.get_split("train")).to(dev)
        pk.reset_launch_counts()
        loss = trainer.train_step(batch, sup, 0)
        if dev == gpu:
            # one K5b for both heads, or one K4b a head
            bwd, launches = ("pair_head_dual_bwd", 1) if dual == "on" else ("pair_head_bwd", 2)
            assert pk.launch_counts[bwd] == launches, pk.launch_counts
        grads = {n: p.grad.cpu().double() for n, p in model.named_parameters()}
        results.append((loss, grads, {n: p.detach().cpu().double() for n, p in model.named_parameters()}))
    (loss_gpu, grads_gpu, params_gpu), (loss_cpu, grads_cpu, params_cpu) = results
    assert loss_gpu == pytest.approx(loss_cpu, rel=1e-5)
    floor = STEP_GRAD_ZERO_FLOOR * max(float(g.norm()) for g in grads_cpu.values())
    for name, want in grads_cpu.items():
        err = float((grads_gpu[name] - want).norm())
        assert err <= STEP_GRAD_NORM_REL * float(want.norm()) + floor, name
        assert float((params_gpu[name] - params_cpu[name]).abs().max()) <= STEP_PARAM_ATOL, name


# -- the gather probe (P1) -----------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", [64, 128])
def test_gather_probe_kernels_match_plain(gpu, h, dtype):
    """A, B and C on float32 or bfloat16 tables: float32 row sums within
    ``1e-5 max |ref|`` (sums of h float32 values in another order)."""
    from multi_modal_gnn_tpu_torch.tools import bench_gather

    args = bench_gather.parse_args(["--tiles", "40", "--rows", "512", "--h", str(h)])
    idx, table, padded = (torch.from_numpy(a).to(gpu) for a in bench_gather.make_inputs(args))
    table, padded = table.to(dtype), padded.to(dtype)
    idx[:7] = torch.tensor([-1, 512, 10_000, 0, 511, -5, 3], dtype=torch.int32)  # outside: zero rows
    before = dict(gp.launch_counts)
    for name, kernel, plain in (
        ("gather_probe_indicator", lambda: gp.gather_probe_indicator(idx, table),
         lambda: gp.gather_rowsum_plain(idx, table, table.shape[1])),
        ("gather_probe_padded", lambda: gp.gather_probe_padded(idx, padded, h),
         lambda: gp.gather_rowsum_plain(idx, padded, h)),
        ("gather_probe_direct", lambda: gp.gather_probe_direct(idx, table),
         lambda: gp.gather_rowsum_plain(idx, table, table.shape[1])),
    ):
        got, want = kernel(), plain()
        assert got.dtype == want.dtype == torch.float32, name
        got, want = got.cpu().numpy(), want.cpu().numpy()
        _assert_close_scaled(got, want, 1e-5, name)
        assert got[0] == got[1] == got[2] == got[5] == 0.0
        assert gp.launch_counts[_key(name, dtype)] == before[_key(name, dtype)] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows,h", [(8, 8), (50, 48), (700, 128), (3, 16)])
def test_gather_probe_bf16_indicator_at_other_shapes(gpu, rows, h):
    """A in bfloat16 on tables whose rows are not a multiple of 16 (the
    staged rows past the table are zero) and widths that leave a pass of
    fewer than four n8 tiles; indices inside, past and before the table."""
    gen = torch.Generator().manual_seed(rows + h)
    table = torch.randn(rows, h, generator=gen).to(torch.bfloat16).to(gpu)
    idx = torch.randint(-3, rows + 20, (5 * 1024,), generator=gen, dtype=torch.int32).to(gpu)
    got = gp.gather_probe_indicator(idx, table).cpu().numpy()
    _assert_close_scaled(got, gp.gather_rowsum_plain(idx, table, h).cpu().numpy(), 1e-5, f"[{rows}, {h}]")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_probe_tool_runs_the_three_kernels(gpu, dtype):
    from multi_modal_gnn_tpu_torch.tools import bench_gather

    gp.reset_launch_counts()
    results = bench_gather.main(["--tiles", "64", "--dtype", dtype])
    suffix = "_bf16" if dtype == "bfloat16" else ""
    assert set(results) == {"A", "B", "C"} and all(gp.launch_counts[n + suffix] for n in gp.WRAPPERS)
    assert results["A"]["sum"] == pytest.approx(results["C"]["sum"], rel=1e-4, abs=1e-2)


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
    fwd = plans[0].to(gpu)
    span = (fwd.span_src, fwd.span_local, fwd.span_tile_map, fwd.span_base, fwd.num_windows)
    with pytest.raises(ValueError):  # more span rows than the kernel's k8-step mask covers
        sk.span_segment_sum(torch.zeros(NUM_SRC, D, device=gpu), *span, 1024)


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
    # the generator's node order, in which no gradient of this step lies
    # within the two sides' rounding of 0 (Adam would move it by 2 * lr)
    config = Config(
        graph=GraphConfig(
            dense_adjacency_max_bytes=0, cluster_patients_by_degree=False,
            cluster_labs_by_frequency=False,
        ),
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
            single_heads = (pk.launch_counts["pair_head_fwd"], pk.launch_counts["pair_head_bwd"])
            assert all(sk.launch_counts[n] for n in sk.WRAPPERS) and all(single_heads), (
                sk.launch_counts, pk.launch_counts,
            )
        results.append((loss, {k: v.cpu() for k, v in model.state_dict().items()}))
    assert results[0][0] == pytest.approx(results[1][0], rel=1e-5)
    for key, value in results[1][1].items():
        np.testing.assert_allclose(results[0][1][key].numpy(), value.numpy(), atol=4e-4, err_msg=key)


def test_dual_and_probe_cpu_tensors_take_the_plain_version():
    params, plan_args, num_windows, g = _dual_problem(37)
    pk.reset_launch_counts()
    gp.reset_launch_counts()
    got = _dual_call(pk.pair_head_dual_fwd, params, plan_args, (1, 2, 3, 4), 0.2, True)
    want = _dual_call(pk.pair_head_dual_fwd_plain, params, plan_args, (1, 2, 3, 4), 0.2, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    table, idx = torch.randn(64, 16), torch.randint(0, 64, (2048,), dtype=torch.int32)
    assert torch.equal(gp.gather_probe_direct(idx, table), gp.gather_rowsum_plain(idx, table, table.shape[1]))
    assert not any(pk.launch_counts.values()) and not any(gp.launch_counts.values())


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


# -- flash attention (K6, K7, K8) --------------------------------------------
#
# Forward outputs are softmax-weighted means and LSE values, compared within
# rtol=atol=1e-5; the backward's sums (up to a few hundred terms per row
# here) are held per tensor to 1e-4 of their largest magnitude.


def _k1_plan(num_src, seed=5):
    """A windowed plan over 1,000 destinations (8 windows) with windows 2
    and 5 empty (a tile of padding only) and destination 3 taking 300 extra
    edges (a run across several 64-slot units and the warps of a tile); its
    ~200 tiles outnumber the warps' first units, so warps take units of
    other windows from the counter."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, 1000, 200_000)
    dst = dst[(dst // 128 != 2) & (dst // 128 != 5)]
    dst = np.concatenate([dst, np.full(300, 3)])
    src = rng.integers(0, num_src, dst.shape[0])
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    win_src, win_local, win_tile_map, num_windows = hetero.build_window_plan(src, dst, 1000)
    count = np.bincount(dst, minlength=1000).astype(np.float32)
    return win_src, win_local, win_tile_map, num_windows, count


@pytest.mark.cuda
@pytest.mark.parametrize("width,dtype", BWD_WIDTHS)
@pytest.mark.parametrize("route,num_src", [("shared", 700), ("global", 5000), ("gathered", 5000)])
def test_k1_routes_match_plain(gpu, route, num_src, width, dtype):
    win_src, win_local, win_tile_map, num_windows, count = _k1_plan(num_src)
    plan = [torch.from_numpy(a).to(gpu) for a in (win_src, win_local, win_tile_map)]
    x = _randn(num_src, width, seed=width, dtype=dtype).to(gpu)
    if route == "gathered":
        x = x.index_select(0, plan[0].long()).contiguous()
        idx = None
    else:  # the table has NaN rows right past it: never read
        x_nan = torch.full((num_src + 37, width), float("nan"), device=gpu, dtype=dtype)
        x_nan[:num_src] = x
        x, idx = x_nan, plan[0]
    assert sk.windowed_route(x.shape[0], width, idx is None, x.element_size()) == route
    args = (idx, plan[1], plan[2], num_windows)
    key = _key("segment_sum_windowed", dtype)
    before = sk.launch_counts[key]
    got = sk.segment_sum_windowed(x, *args)[:1000]
    want = sk.segment_sum_windowed_plain(x[:num_src] if idx is not None else x, *args)[:1000]
    assert sk.launch_counts[key] == before + 1
    per = torch.from_numpy(count).clamp_min(1.0)[:, None].to(gpu)
    got, want = (got / per).cpu().numpy(), (want / per).cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    empty = (count == 0)
    assert float(np.abs(got[empty]).max()) == 0.0  # zero rows for empty destinations


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route,num_src", [("shared", 700), ("global", 5000)])
def test_k1_per_shard_total_matches_plain(gpu, route, num_src, dtype):
    """K1 as the per-shard total of data parallelism (``ops/segment.py``
    ``sharded_block_sum``): each of 3 shards' blocks, added at its window
    offset into a zeroed global buffer (``out=``), against its plain
    version, and the shards' sum against the unsharded plain total."""
    from types import SimpleNamespace

    from multi_modal_gnn_tpu_torch.ops.segment import sharded_block_sum

    rng = np.random.default_rng(num_src)
    dst = np.sort(rng.integers(0, 1000, 120_000))
    src = rng.integers(0, num_src, dst.shape[0])
    sh_src, sh_local, sh_tm, sh_off, k_max = hetero.build_sharded_window_plans(src, dst, 1000, 3)
    x = _randn(num_src, D, seed=7, dtype=dtype).to(gpu)
    count = torch.from_numpy(np.bincount(dst, minlength=1000).astype(np.float32)).clamp_min(1.0)[:, None].to(gpu)
    total = torch.zeros(1000, D, device=gpu)
    key = _key("segment_sum_windowed", dtype)
    for r in range(3):
        es = SimpleNamespace(
            **{name: torch.from_numpy(np.split(a, 3)[r]).to(gpu) for name, a in (
                ("shard_win_src", sh_src), ("shard_win_local", sh_local), ("shard_win_tile_map", sh_tm))},
            shard_win_windows=k_max, shard_win_first=int(sh_off[r]),
        )
        before = sk.launch_counts[key]
        got = sharded_block_sum(x, es, 1000)
        assert sk.launch_counts[key] == before + 1
        full = torch.zeros((8 + k_max) * 128, D, device=gpu)
        full[es.shard_win_first * 128 : (es.shard_win_first + k_max) * 128] = sk.segment_sum_windowed_plain(
            x, es.shard_win_src, es.shard_win_local, es.shard_win_tile_map, k_max
        )
        np.testing.assert_allclose((got / count).cpu().numpy(), (full[:1000] / count).cpu().numpy(), **TOL)
        total += got
    want = torch.zeros(1000, D, device=gpu).index_add_(0, torch.from_numpy(dst).to(gpu), x.float()[torch.from_numpy(src).to(gpu)])
    np.testing.assert_allclose((total / count).cpu().numpy(), (want / count).cpu().numpy(), **TOL)


K8_WIDTHS = [(h, nh) for h in (32, 64, 128) for nh in (1, 2, 4, 8, 16, 32) if ak.heads_supported(h, nh)]


def _k8_group(num_dst):
    """An attention group over 512 virtual sources (4 reverse windows, the
    third empty) whose source 5 takes 2,500 extra edges (a run across several
    reverse tiles); its ~150 reverse tiles outnumber the blocks, so a block
    changes window.  With more than 512 destinations the reverse side takes
    the span layout (the sort route), else the resident one (the table
    route)."""
    rng = np.random.default_rng(7)
    src = rng.integers(0, 512, 150_000)
    src = src[src // 128 != 2]
    src = np.concatenate([src, np.full(2_500, 5)])
    dst = rng.integers(0, num_dst, src.shape[0])
    fwd = _build_side(src, dst, num_dst, 512, 128, 512)
    rev = _build_side(dst, src, 512, num_dst, 128, 512)
    return AttnGroupPlan(fwd=fwd, rev=rev, src_offsets=(0,), num_src_total=512, num_dst=num_dst,
                         num_edges=len(src))


@pytest.mark.cuda
@pytest.mark.parametrize("h,num_heads", K8_WIDTHS)
@pytest.mark.parametrize("route,num_dst", [("table", 300), ("sort", 3000)])
def test_k8_routes_match_plain(gpu, route, num_dst, h, num_heads):
    plan = _k8_group(num_dst).to(gpu)
    assert plan.rev.use_span == (route == "sort")
    gen = torch.Generator().manual_seed(h + num_heads)
    q = (torch.randn(num_dst, h, generator=gen) / (h // num_heads) ** 0.5).to(gpu)
    k, v = (torch.randn(512, h, generator=gen).to(gpu) for _ in range(2))
    dout = torch.randn(num_dst, h, generator=gen).to(gpu)
    out, lse = ak.flash_attention_fwd_plain(q, k, v, *plan.fwd.arrays(), plan.fwd.num_windows, num_heads)
    lse = lse[:num_dst].contiguous()
    delta = (dout * out[:num_dst]).reshape(num_dst, num_heads, -1).sum(-1).contiguous()
    rev = (*plan.rev.arrays(), plan.rev.num_windows, num_heads)
    tiles = plan.rev.arrays()[1].shape[0] // 1024
    launch = ak.dkv_launch(tiles, num_dst, h, num_heads, torch.cuda.get_device_properties(gpu).multi_processor_count)
    # a single head of 128 columns of a 300-row table does not fit a block: the sort route takes it
    assert launch.route == (route if (route, h // num_heads) != ("table", 128) else "sort")
    want = ak.flash_attention_dkv_plain(q, k, v, dout, lse, delta, *rev)

    def nan_rows(x, extra=300):
        out = torch.full((x.shape[0] + extra, x.shape[1]), float("nan"), device=gpu)
        out[: x.shape[0]] = x
        return out

    # q and dO are views whose storage holds NaN rows right past them
    got = ak.flash_attention_dkv(nan_rows(q)[:num_dst], nan_rows(k), nan_rows(v), nan_rows(dout)[:num_dst],
                                 lse, delta, *rev)
    torch.cuda.synchronize()
    for name, a, b in zip(("dk", "dv"), got, want):
        assert bool(torch.isfinite(a).all()), name
        _assert_close_scaled(a[:512].cpu().numpy(), b[:512].cpu().numpy(), 1e-4, name)
        assert float(a[256:384].abs().max()) == 0.0  # the empty window

ATTN_H, ATTN_HEADS = 128, 4


def _attn_group(kind):
    rng = np.random.default_rng(11)
    resident_max, span_rows = 512, 128
    if kind == "resident":
        num_dst, num_src, e = 300, 150, 20_000
    elif kind == "span":  # both sides span (the patient group's reverse side)
        num_dst, num_src, e, resident_max = 300, 260, 20_000, 0
    elif kind == "high_rung":  # a low-dst group over a wide source table
        num_dst, num_src, e = 256, 6000, 20_000
    elif kind == "duplicates":
        num_dst, num_src, e = 64, 40, 2_000
    else:  # "empty_rows": destinations 100.. receive no edge
        num_dst, num_src, e = 400, 50, 3_000
    src = rng.integers(0, num_src, e)
    dst = rng.integers(0, 100 if kind == "empty_rows" else num_dst, e)
    if kind == "duplicates":
        src, dst = np.repeat(src, 4), np.repeat(dst, 4)
    fwd = _build_side(src, dst, num_dst, num_src, span_rows, resident_max)
    rev = _build_side(dst, src, num_src, num_dst, span_rows, resident_max)
    if kind == "span":
        assert fwd.use_span and rev.use_span
    if kind == "high_rung":
        assert fwd.use_span and fwd.span_rows >= 512
    return AttnGroupPlan(
        fwd=fwd, rev=rev, src_offsets=(0,), num_src_total=num_src, num_dst=num_dst,
        num_edges=len(src),
    )


def _attn_inputs(plan, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(plan.num_dst, ATTN_H, generator=gen) / (ATTN_H // ATTN_HEADS) ** 0.5
    k = torch.randn(plan.num_src_total, ATTN_H, generator=gen)
    v = torch.randn(plan.num_src_total, ATTN_H, generator=gen)
    dout = torch.randn(plan.num_dst, ATTN_H, generator=gen)
    return q, k, v, dout


def _attn_all(plan, q, k, v, dout, fwd, dq, dkv):
    """Outputs of K6, then K7 and K8 on the forward's LSE and delta."""
    side, rev = plan.fwd, plan.rev
    out, lse = fwd(q, k, v, *side.arrays(), side.num_windows, ATTN_HEADS)
    n = plan.num_dst
    o, lse_d = out[:n], lse[:n].contiguous()
    delta = (dout * o).reshape(n, ATTN_HEADS, -1).sum(-1).contiguous()
    stats = (q, k, v, dout, lse_d, delta)
    g_q = dq(*stats, *side.arrays(), side.num_windows, ATTN_HEADS)
    g_k, g_v = dkv(*stats, *rev.arrays(), rev.num_windows, ATTN_HEADS)
    return out, lse, g_q, g_k, g_v


def _attn_compare(got, want):
    names = ("out", "lse", "dq", "dk", "dv")
    for name, a, b in zip(names[:2], got[:2], want[:2]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
    for name, a, b in zip(names[2:], got[2:], want[2:]):
        _assert_close_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-4, name)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["resident", "span", "high_rung", "duplicates", "empty_rows"])
def test_flash_attention_kernels_match_plain(gpu, kind):
    plan = _attn_group(kind).to(gpu)
    inputs = [t.to(gpu) for t in _attn_inputs(plan)]
    before = dict(ak.launch_counts)
    got = _attn_all(plan, *inputs, ak.flash_attention_fwd, ak.flash_attention_dq, ak.flash_attention_dkv)
    want = _attn_all(
        plan, *inputs, ak.flash_attention_fwd_plain, ak.flash_attention_dq_plain,
        ak.flash_attention_dkv_plain,
    )
    torch.cuda.synchronize()
    _attn_compare(got, want)
    assert all(ak.launch_counts[k] == before[k] + 1 for k in before), ak.launch_counts
    if kind == "empty_rows":
        assert float(got[0][100:].abs().max()) == 0.0
        assert bool((got[1][100:plan.num_dst] == ak.EMPTY_LSE).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["resident", "span"])
def test_flash_attention_kernels_never_read_rows_past_the_tables(gpu, kind):
    plan = _attn_group(kind).to(gpu)
    q, k, v, dout = [t.to(gpu) for t in _attn_inputs(plan, seed=1)]

    def nan_rows(x, extra=256):
        out = torch.full((x.shape[0] + extra, x.shape[1]), float("nan"), device=gpu)
        out[: x.shape[0]] = x
        return out

    want = _attn_all(
        plan, q, k, v, dout, ak.flash_attention_fwd_plain, ak.flash_attention_dq_plain,
        ak.flash_attention_dkv_plain,
    )
    # q and dO are views whose storage holds NaN rows right past them
    got = _attn_all(
        plan, nan_rows(q)[: plan.num_dst], nan_rows(k), nan_rows(v), nan_rows(dout)[: plan.num_dst],
        ak.flash_attention_fwd, ak.flash_attention_dq, ak.flash_attention_dkv,
    )
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _attn_compare(got, want)


@pytest.mark.cuda
def test_flash_attention_autograd_on_gpu(gpu):
    plan = _attn_group("span")
    q, k, v, dout = _attn_inputs(plan, seed=2)
    grads = []
    for dev, p in ((gpu, plan.to(gpu)), (torch.device("cpu"), plan)):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        (flash_attention_group(*leaves, p, ATTN_HEADS) * dout.to(dev)).sum().backward()
        grads.append([t.grad.cpu().numpy() for t in leaves])
    for name, a, b in zip(("dq", "dk", "dv"), *grads):
        _assert_close_scaled(a, b, 1e-4, name)


def _hgt_setup():
    spec = SyntheticSpec(
        num_patients=4500, num_labs=300, num_diagnoses=100, num_medications=80,
        mean_labs_per_patient=30.0, mean_diagnoses_per_patient=2.0,
        mean_medications_per_patient=3.0, latent_dim=4, seed=3,
    )
    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0),
        model=ModelConfig(architecture="HGT", use_pallas=True, dropout=0.0),
    )
    graph = ensure_attn_plans(make_synthetic_graph(spec, config, device="cpu"), config)
    return config, graph


@pytest.mark.cuda
def test_hgt_train_step_on_gpu_matches_plain_on_cpu(gpu):
    config, graph = _hgt_setup()
    assert {p.rev.use_span for p in graph.attn_plans.values()} == {False, True}
    results = []
    for dev in (gpu, torch.device("cpu")):
        model = build_model(config, graph, device="cpu", generator=torch.Generator().manual_seed(0))
        masker = EdgeMasker(graph, slot_major_train=True, slot_major_min_rows=0)
        trainer = Trainer(model, graph, masker, config, device=dev)
        sup = masker.supervision_mask(0, masker.get_split("train")).to(dev)
        ak.reset_launch_counts()
        loss = trainer.train_step(trainer.get_batch("train"), sup, 0)
        if dev == gpu:
            assert all(ak.launch_counts.values()), ak.launch_counts
        else:
            assert not any(ak.launch_counts.values())
        results.append((loss, {k: v.cpu() for k, v in model.state_dict().items()}))
    assert results[0][0] == pytest.approx(results[1][0], rel=1e-5)
    for key, value in results[1][1].items():
        np.testing.assert_allclose(results[0][1][key].numpy(), value.numpy(), atol=4e-4, err_msg=key)


def test_attention_cpu_tensors_take_the_plain_version_and_launch_nothing(monkeypatch):
    # The route is checked with a spy on each plain version: the wrapper
    # passes its own arguments and returns the plain version's tensors.  Two
    # calls of a plain version are then held to the kernel tests' tolerance,
    # not to bit equality, which PyTorch does not promise for the CPU
    # index_add_ / scatter_reduce these sums run on.
    plan = _attn_group("resident")
    q, k, v, dout = _attn_inputs(plan)
    names = ("flash_attention_fwd_plain", "flash_attention_dq_plain", "flash_attention_dkv_plain")
    calls = []
    for name in names:
        def spy(*args, _plain=getattr(ak, name), _name=name):
            out = _plain(*args)
            calls.append((_name, args, out))
            return out

        monkeypatch.setattr(ak, name, spy)
    ak.reset_launch_counts()
    got = _attn_all(plan, q, k, v, dout, ak.flash_attention_fwd, ak.flash_attention_dq, ak.flash_attention_dkv)
    assert not any(ak.launch_counts.values())
    assert [c[0] for c in calls] == list(names)
    (_, fwd_args, fwd_out), (_, dq_args, dq_out), (_, dkv_args, dkv_out) = calls
    assert all(a is b for a, b in zip(fwd_args, (q, k, v, *plan.fwd.arrays())))
    assert all(a is b for a, b in zip(dq_args, (q, k, v, dout)))
    assert all(a is b for a, b in zip(dkv_args, (q, k, v, dout)))
    assert all(a is b for a, b in zip(got, (*fwd_out, dq_out, *dkv_out)))
    monkeypatch.undo()
    _attn_compare(got, _attn_all(
        plan, q, k, v, dout, ak.flash_attention_fwd_plain, ak.flash_attention_dq_plain,
        ak.flash_attention_dkv_plain,
    ))


@pytest.mark.cuda
def test_attention_wrappers_reject_what_the_kernels_do_not_take(gpu):
    plan = _attn_group("resident").to(gpu)
    q, k, v, _ = [t.to(gpu) for t in _attn_inputs(plan)]
    args = (*plan.fwd.arrays(), plan.fwd.num_windows)
    with pytest.raises(TypeError):
        ak.flash_attention_fwd(q.double(), k, v, *args, ATTN_HEADS)
    with pytest.raises(ValueError):  # a head of 24 columns: 6 lanes do not reduce by xor shuffles
        ak.flash_attention_fwd(q[:, :96].contiguous(), k[:, :96].contiguous(), v[:, :96].contiguous(), *args, 4)
    with pytest.raises(ValueError):
        ak.flash_attention_fwd(q, k[:, :64].contiguous(), v, *args, ATTN_HEADS)
    with pytest.raises(ValueError):
        ak.flash_attention_fwd(q, k, v, plan.fwd.arrays()[0].long(), *args[1:], ATTN_HEADS)


def test_attention_wrappers_reject_other_devices():
    plan = _attn_group("resident")
    q = torch.empty(plan.num_dst, ATTN_H, device="meta")
    with pytest.raises(ValueError):
        ak.flash_attention_fwd(q, q, q, *plan.fwd.arrays(), plan.fwd.num_windows, ATTN_HEADS)


# K6 and K7 at every slice width of their launch plan (ops/attention_kernels.py
# rows_launch_at), h: heads of 4, 8, 16 and 32 columns; one head of 4 (a
# 4-column slice, the narrowest)
K67_WIDTHS = [(4, 1), (16, 4), (32, 4), (64, 4), (128, 4)]


def _k67_group(layout):
    """A group of 600 destinations (5 forward windows) whose window 0 takes
    60,000 edges (its tiles spread over many blocks), whose row 200 alone
    fills window 1 with 2,100 edges from 100 sources (whole tiles of one
    row), whose window 2 has no edge (an all-padding tile, empty rows), and
    whose last windows gather from the table's last rows.  ``"resident"``:
    300 sources, the resident layout; ``"span"``: 5,000 sources in 128-row
    spans (the last span, based at row 4,992, runs past the table's end)."""
    rng = np.random.default_rng(23)
    num_dst, num_src = 600, 300 if layout == "resident" else 5000
    src = [rng.integers(0, num_src, 60_000), rng.integers(0, 100, 2_100), rng.integers(0, num_src, 8_000),
           np.full(50, num_src - 1), np.arange(num_src - 40, num_src)]
    dst = [rng.integers(0, 128, 60_000), np.full(2_100, 200), rng.integers(384, 600, 8_000),
           rng.integers(384, 600, 50), rng.integers(384, 600, 40)]
    src, dst = np.concatenate(src), np.concatenate(dst)
    fwd = _build_side(src, dst, num_dst, num_src, 128, 512)
    rev = _build_side(dst, src, num_src, num_dst, 128, 512)
    assert fwd.use_span == (layout == "span") and fwd.num_windows == 5
    return AttnGroupPlan(fwd=fwd, rev=rev, src_offsets=(0,), num_src_total=num_src, num_dst=num_dst,
                         num_edges=len(src))


@pytest.mark.cuda
@pytest.mark.parametrize("h,num_heads", K67_WIDTHS)
@pytest.mark.parametrize("layout", ["resident", "span"])
def test_k6_k7_slices_match_plain(gpu, layout, h, num_heads):
    # every slice width that fits, on the plan's slot order (each tile sorted
    # in the kernel), NaN rows past every table
    plan = _k67_group(layout).to(gpu)
    side, n, ns = plan.fwd, plan.num_dst, plan.num_src_total
    gen = torch.Generator().manual_seed(h)
    q = (torch.randn(n, h, generator=gen) / (h // num_heads) ** 0.5).to(gpu)
    k, v = (torch.randn(ns, h, generator=gen).to(gpu) for _ in range(2))
    dout = torch.randn(n, h, generator=gen).to(gpu)
    args = (*side.arrays(), side.num_windows, num_heads)
    tiles = side.arrays()[1].shape[0] // 1024
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    out_p, lse_p = ak.flash_attention_fwd_plain(q, k, v, *args)
    lse_d = lse_p[:n].contiguous()
    delta = (dout * out_p[:n]).reshape(n, num_heads, -1).sum(-1).contiguous()
    dq_p = ak.flash_attention_dq_plain(q, k, v, dout, lse_d, delta, *args)

    def nan_rows(x, extra=300):
        out = torch.full((x.shape[0] + extra, x.shape[1]), float("nan"), device=gpu)
        out[: x.shape[0]] = x
        return out[: x.shape[0]]  # a view whose storage holds NaN rows right past it

    qx, kx, vx, dx = (nan_rows(t) for t in (q, k, v, dout))
    widths = [w for w in ak._head_slices(h, num_heads) if ak.rows_launch_at("fwd", tiles, h, sms, w)]
    assert widths[0] == ak.fwd_launch(tiles, h, num_heads, sms).slice
    for width in widths:
        fwd_launch, dq_launch = (ak.rows_launch_at(kind, tiles, h, sms, width) for kind in ("fwd", "dq"))
        before = dict(ak.launch_counts)
        out, lse = ak._fwd_on(fwd_launch, qx, kx, vx, *args)
        dq = ak._dq_on(dq_launch, qx, kx, vx, dx, lse_d, delta, *args)
        torch.cuda.synchronize()
        assert ak.launch_counts["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
        assert ak.launch_counts["flash_attention_dq"] == before["flash_attention_dq"] + 1
        for got in (out, lse, dq):
            assert bool(torch.isfinite(got).all())
        tag = f" at slice {width}"
        np.testing.assert_allclose(out.cpu().numpy(), out_p.cpu().numpy(), rtol=1e-5, atol=1e-5, err_msg="out" + tag)
        np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(), rtol=1e-5, atol=1e-5, err_msg="lse" + tag)
        _assert_close_scaled(dq[:n].cpu().numpy(), dq_p[:n].cpu().numpy(), 1e-4, "dq" + tag)
        empty = slice(256, 384)  # window 2 and rows past the destinations: out 0, LSE 1e30, dq 0
        for rows in (empty, slice(n, side.num_windows * 128)):
            assert float(out[rows].abs().max()) == 0.0 and float(dq[rows].abs().max()) == 0.0
            assert bool((lse[rows] == ak.EMPTY_LSE).all())


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["plan_order", "row_ordered"])
@pytest.mark.parametrize("layout", ["resident", "span"])
def test_k6_k7_layouts_match_plain(gpu, layout, order):
    # the plan's slot order (each tile sorted in the kernel) and the model's
    # (each tile's slots in row order, ensure_attn_plans), through the wrappers
    plan = _k67_group(layout)
    side = (plan.fwd.row_ordered() if order == "row_ordered" else plan.fwd).to(gpu)
    n = plan.num_dst
    q, k, v, dout = [t.to(gpu) for t in _attn_inputs(plan, seed=4)]
    args = (*side.arrays(), side.num_windows, ATTN_HEADS)
    out_p, lse_p = ak.flash_attention_fwd_plain(q, k, v, *args)
    lse, delta = lse_p[:n].contiguous(), (dout * out_p[:n]).reshape(n, ATTN_HEADS, -1).sum(-1).contiguous()
    want = ak.flash_attention_dq_plain(q, k, v, dout, lse, delta, *args)
    out, lse_k = ak.flash_attention_fwd(q, k, v, *args)
    got = ak.flash_attention_dq(q, k, v, dout, lse, delta, *args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), out_p.cpu().numpy(), rtol=1e-5, atol=1e-5, err_msg="out")
    np.testing.assert_allclose(lse_k.cpu().numpy(), lse_p.cpu().numpy(), rtol=1e-5, atol=1e-5, err_msg="lse")
    _assert_close_scaled(got[:n].cpu().numpy(), want[:n].cpu().numpy(), 1e-4, "dq")


@pytest.mark.cuda
@pytest.mark.parametrize("h", [16, 128])
@pytest.mark.parametrize("layout", ["resident", "span"])
def test_k6_k7_autograd_step_matches_plain(gpu, layout, h):
    plan = _k67_group(layout)
    plan = dataclasses.replace(plan, fwd=plan.fwd.row_ordered())  # as ensure_attn_plans holds it
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(plan.num_dst, h, generator=gen)
    k, v = (torch.randn(plan.num_src_total, h, generator=gen) for _ in range(2))
    dout = torch.randn(plan.num_dst, h, generator=gen)
    results = []
    for dev, p in ((gpu, plan.to(gpu)), (torch.device("cpu"), plan)):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        ak.reset_launch_counts()
        out = flash_attention_group(*leaves, p, 4)
        (out * dout.to(dev)).sum().backward()
        assert all(ak.launch_counts.values()) == (dev == gpu), ak.launch_counts
        results.append([out.detach().cpu().numpy()] + [t.grad.cpu().numpy() for t in leaves])
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-5, atol=1e-5, err_msg="out")
    for name, a, b in zip(("dq", "dk", "dv"), results[0][1:], results[1][1:]):
        _assert_close_scaled(a, b, 1e-4, name)


# -- back-to-back epochs and checkpoints on the card ---------------------------

# train_epochs' losses, card against CPU from the same weights and masks:
# the first epoch's loss as one step's (1e-5); later ones after Adam steps
# whose parameters differ by up to 2 * lr where a near-zero gradient's sign
# flips (see the dual step above): 3e-6 apart at the third epoch on an
# NVIDIA H100 80GB HBM3, 700.00 W, held to 1e-4
EPOCHS_LOSS_RTOL = (1e-5, 1e-4)
LIFECYCLE_SPEC = SyntheticSpec(
    num_patients=4500, num_labs=300, num_diagnoses=100, num_medications=80,
    mean_labs_per_patient=30.0, mean_diagnoses_per_patient=2.0,
    mean_medications_per_patient=3.0, latent_dim=4, seed=3,
)


def _lifecycle_trainer(config, graph, device, dual=False, mask_fraction=0.2):
    model = build_model(config, graph, device="cpu", generator=torch.Generator().manual_seed(0))
    masker = EdgeMasker(
        graph, mask_fraction=mask_fraction, slot_major_train=True, slot_major_min_rows=0,
        lab_block_rows=0 if dual else 32,
    )
    return Trainer(model, graph, masker, config, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dual", [False, True], ids=["single_heads", "dual_heads"])
def test_train_epochs_on_the_card_match_the_plain_versions(gpu, dual):
    """``train_epochs(3, with_val=True)`` runs the path's kernels with no
    readback and its losses follow the plain versions' on the CPU (dropout 0
    and every train row supervised: torch's CPU and CUDA generators draw
    other numbers from one seed)."""
    extras = {"head_style": "factored", "dual_head_fusion": "on" if dual else "off"}
    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0),
        model=ModelConfig(use_pallas=True, dropout=0.0, extras=extras),
    )
    graph = make_synthetic_graph(LIFECYCLE_SPEC, config, device="cpu")
    losses = {}
    for dev in (gpu, torch.device("cpu")):
        trainer = _lifecycle_trainer(config, graph, dev, dual, mask_fraction=0.0)
        sk.reset_launch_counts()
        pk.reset_launch_counts()
        tl, vl = trainer.train_epochs(3, with_val=True, as_numpy=False)
        if dev == gpu:
            assert tl.device == vl.device == gpu
            heads = ("pair_head_dual_fwd", "pair_head_dual_bwd") if dual else ("pair_head_fwd", "pair_head_bwd")
            assert all(pk.launch_counts[name] >= 3 for name in heads), pk.launch_counts
            assert all(sk.launch_counts[n] >= 3 for n in sk.WRAPPERS), sk.launch_counts
        losses[dev.type] = (tl.cpu().numpy(), vl.cpu().numpy())
    print({k: (v[0].tolist(), v[1].tolist()) for k, v in losses.items()})
    for got, want in zip(losses["cuda"], losses["cpu"]):
        np.testing.assert_allclose(got[:1], want[:1], rtol=EPOCHS_LOSS_RTOL[0])
        np.testing.assert_allclose(got, want, rtol=EPOCHS_LOSS_RTOL[1])


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(gpu, tmp_path):
    """A fit on the card saves checkpoints that restore exactly, into a
    trainer on the card and into one on the CPU."""
    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0),
        model=ModelConfig(use_pallas=True, extras={"head_style": "factored"}),
    )
    config = dataclasses.replace(
        config, train=dataclasses.replace(config.train, epochs=3),
        logging=dataclasses.replace(config.logging, checkpoint_interval=1),
    )
    graph = make_synthetic_graph(LIFECYCLE_SPEC, config, device="cpu")
    trainer = _lifecycle_trainer(config, graph, gpu)
    trainer.fit(output_dir=tmp_path)
    assert Trainer.latest_checkpoint(tmp_path).name == "checkpoint_epoch_3.ckpt"
    for dev in (gpu, torch.device("cpu")):
        twin = _lifecycle_trainer(config, graph, dev)
        twin.model.load_state_dict({k: torch.zeros_like(v) for k, v in twin.model.state_dict().items()})
        twin.restore(tmp_path / "checkpoint_epoch_3.ckpt")
        assert (twin.epoch, twin.best_val_loss, twin.history) == (3, trainer.best_val_loss, {
            k: v for k, v in trainer.history.items() if isinstance(v, list)
        })
        for (name, x), (_, y) in zip(twin.model.state_dict().items(), trainer.model.state_dict().items()):
            assert x.device.type == dev.type and torch.equal(x.cpu(), y.cpu()), name
        for name, value in trainer.best_state.items():
            assert torch.equal(twin.best_state[name].cpu(), value.cpu()), name
        for pa, pb in zip(twin.model.parameters(), trainer.model.parameters()):
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(twin.optimizer.state[pa][key].cpu(), trainer.optimizer.state[pb][key].cpu()), key
        assert np.isfinite(twin.train_epoch())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["RGCN", "HGT"])
def test_serving_artifact_on_the_card(gpu, arch, dtype, tmp_path):
    """An artifact exported on the card answers through its CUDA graphs like
    the eager serving path, request after request, and on the CPU; one
    exported on the CPU answers on the card.  A bfloat16 model's artifact
    (its bfloat16 leaves stored as bit patterns, value context on) answers
    in float32 alike, within one bfloat16 spacing of the answers' scale on
    the other device."""
    from multi_modal_gnn_tpu_torch.graph.build import GraphBundle, GraphMeta
    from multi_modal_gnn_tpu_torch.serving import ServingModel, build_trainer_serving_fn, export_serving

    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0),
        model=ModelConfig(architecture=arch, use_pallas=True, compute_dtype=dtype,
                          extras={"hgt_dense_attn_bytes": 0, "value_context": dtype == "bfloat16"}),
    )
    graph_cpu = ensure_attn_plans(make_synthetic_graph(LIFECYCLE_SPEC, config, device="cpu"), config)
    rng = np.random.default_rng(0)
    requests = [
        (rng.integers(0, graph_cpu.num_nodes("patient"), n), rng.integers(0, graph_cpu.num_nodes("lab"), n))
        for n in (1, 64, 256, 700)
    ]
    models = {}
    for dev in (gpu, torch.device("cpu")):
        graph = graph_cpu.to(dev)
        model = build_model(config, graph_cpu, device="cpu", generator=torch.Generator().manual_seed(0)).to(dev)
        trainer = Trainer(model, graph, EdgeMasker(graph, seed=0), config, device=dev)
        export_serving(trainer, GraphBundle(graph=graph, meta=GraphMeta()), tmp_path / dev.type, buckets=(64, 256))
        models[dev.type] = build_trainer_serving_fn(trainer)[0]  # the trainer's eval visibility, as exported
    for exported_on in ("cuda", "cpu"):
        for dev in (gpu, torch.device("cpu")):
            served = ServingModel.load(tmp_path / exported_on, device=dev)
            assert served.manifest["export_platform"] == exported_on
            # NaN blocks of the leaves' sizes: were a captured graph reading
            # memory the artifact had let go, the allocator would hand it here
            with np.load(tmp_path / exported_on / "weights.npz") as z:
                junk = [torch.full(z[k].shape, float("nan"), device=gpu) for k in z.files]  # noqa: F841
            for p, l in requests:  # the 700 pairs run as 256, 256 and 188
                want = models[exported_on](p, l).cpu().numpy()  # the exported state's answers
                got = served.predict(p, l)
                assert got.dtype == np.float32
                if dtype == "bfloat16" and dev.type != exported_on:
                    # the other device's bf16 products and sums round otherwise:
                    # within one bf16 spacing at the answers' scale
                    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ULP * float(np.abs(want).max()))
                else:
                    np.testing.assert_allclose(got, want, **TOL)


VC_CASES = [("RGCN", "context", 8), ("RGCN", "head", 8), ("RGCN", "embedding", 9), ("HGT", "embedding", 9),
            ("HGT", "context", 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,source,rank", VC_CASES, ids=["-".join(map(str, c)) for c in VC_CASES])
def test_value_context_step_on_the_card_matches_the_plain_versions(gpu, arch, source, rank):
    """One train step with value context and a bilinear source (dropout 0,
    the same numpy supervision mask): the knockout equals the CPU's exactly,
    the loss follows the plain versions' within ``rtol 1e-5`` and every
    gradient within ``1e-2`` of its norm plus ``1e-5`` of the largest norm
    (a bias feeding a BatchNorm has a gradient of exactly 0, which both
    sides give as rounding noise: 1.8e-8 against a largest norm of 1.6e-2
    on an H100); the path's kernels launch."""
    head = {"bilinear_rank": rank, "bilinear_source": source}
    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0),
        model=ModelConfig(
            architecture=arch, use_pallas=True, dropout=0.0,
            extras={"head_style": "factored", "value_context": True, "hgt_dense_attn_bytes": 0},
            edge_head=dataclasses.replace(ModelConfig().edge_head, extras=head),
        ),
    )
    graph = make_synthetic_graph(LIFECYCLE_SPEC, config, device="cpu")
    out = {}
    for dev in (gpu, torch.device("cpu")):
        trainer = _lifecycle_trainer(config, graph, dev)
        batch = trainer.get_batch("train")
        sup = (np.random.default_rng(0).random(batch.valid.shape[0]) < 0.3) * batch.valid.cpu().numpy()
        sup = torch.from_numpy(sup.astype(np.float32)).to(dev)
        for counts in (sk, pk, ak):
            counts.reset_launch_counts()
        vis = trainer._visible_graph(sup).edges[("patient", "has_lab", "lab")].val_vis.cpu()
        loss = trainer.train_step(batch, sup, 0)
        launched = {**sk.launch_counts, **pk.launch_counts, **ak.launch_counts}
        out[dev.type] = (vis, loss, {n: p.grad.cpu() for n, p in trainer.model.named_parameters()}, launched)
    (vis, loss, grads, launched), (vis_ref, loss_ref, grads_ref, _) = out["cuda"], out["cpu"]
    assert torch.equal(vis, vis_ref)
    if arch == "RGCN":
        path = ("segment_sum_windowed", "fused_table_segment_sum", "fused_table_segment_sum_bwd",
                "pair_head_fwd", "pair_head_bwd")
    else:
        path = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
    assert all(launched[name] for name in path), launched
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)
    floor = 1e-5 * max(float(g.norm()) for g in grads_ref.values())
    for name, g in grads_ref.items():
        err = float((grads[name] - g).norm())
        assert err <= 1e-2 * float(g.norm()) + floor, f"{name}: ||d|| {err:.3e}, ||ref|| {float(g.norm()):.3e}"


BF16_STEP_LOSS_RTOL = 2.0 ** -8  # chip_smoke.py phase 27 (c)
BF16_STEP_GRAD_REL = 0.6  # chip_smoke.py phase 27 (c): bf16 ReLU / BatchNorm flips


def _zero_in_exact_arithmetic(name):
    """A bias right before a BatchNorm, or a value-context bias (it shifts
    every patient or lab row alike, and those rows reach the loss only
    through mean aggregations into BatchNorm): each side holds only its
    rounding noise (chip_smoke.py _feeds_batch_norm, _vctx_rgcn_zero)."""
    bn_fed = name.endswith(".bias") and (
        name.startswith("conv_") or name in ("patient_encoder.dense_0.bias", "patient_encoder.dense_1.bias"))
    return bn_fed or name in ("vctx_patient.bias", "vctx_lab.bias")


def _bf16_step_close(out, path):
    """Card against CPU plain for a bfloat16 RGCN step, at phase 27's
    bounds; a gradient that is 0 in exact arithmetic held, as there, to
    twice the CPU's noise."""
    (loss, grads, launched), (loss_ref, grads_ref, _) = out["cuda"], out["cpu"]
    assert all(launched[name] for name in path), launched
    np.testing.assert_allclose(loss, loss_ref, rtol=BF16_STEP_LOSS_RTOL)
    floor = 1e-5 * max(float(g.norm()) for g in grads_ref.values())
    for name, g in grads_ref.items():
        assert grads[name].dtype == torch.float32, name
        if _zero_in_exact_arithmetic(name):
            assert float(grads[name].norm()) <= 2 * float(g.norm()) + floor, name
            continue
        err = float((grads[name] - g).norm())
        assert err <= BF16_STEP_GRAD_REL * float(g.norm()) + floor, f"{name}: ||d|| {err:.3e}, ||ref|| {float(g.norm()):.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("arch,source,rank", [("RGCN", "context", 8), ("HGT", "embedding", 9)])
def test_bf16_value_context_step_on_the_card(gpu, arch, source, rank):
    """One bfloat16 train step with value context (dropout 0, one numpy
    supervision mask), card against the CPU plain versions: the RGCN's
    bfloat16 kernels launch (K2b in float32, as JAX hands it), the HGT's
    flash kernels in float32; loss and gradients at phase 27's bounds."""
    head = {"bilinear_rank": rank, "bilinear_source": source}
    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0),
        model=ModelConfig(
            architecture=arch, use_pallas=True, dropout=0.0, compute_dtype="bfloat16",
            extras={"head_style": "factored", "value_context": True, "hgt_dense_attn_bytes": 0},
            edge_head=dataclasses.replace(ModelConfig().edge_head, extras=head),
        ),
    )
    graph = make_synthetic_graph(LIFECYCLE_SPEC, config, device="cpu")
    out = {}
    for dev in (gpu, torch.device("cpu")):
        trainer = _lifecycle_trainer(config, graph, dev)
        assert trainer.model.compute_dtype == torch.bfloat16
        batch = trainer.get_batch("train")
        sup = (np.random.default_rng(0).random(batch.valid.shape[0]) < 0.3) * batch.valid.cpu().numpy()
        sup = torch.from_numpy(sup.astype(np.float32)).to(dev)
        for counts in (sk, pk, ak):
            counts.reset_launch_counts()
        loss = trainer.train_step(batch, sup, 0)
        launched = {**sk.launch_counts, **pk.launch_counts, **ak.launch_counts}
        out[dev.type] = (loss, {n: p.grad.cpu() for n, p in trainer.model.named_parameters()}, launched)
    if arch == "RGCN":
        path = ("segment_sum_windowed_bf16", "fused_table_segment_sum_bf16", "fused_table_segment_sum_bwd",
                "pair_head_fwd_bf16", "pair_head_bwd_bf16")
    else:
        path = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
    _bf16_step_close(out, path)


@pytest.mark.cuda
def test_side_information_warm_start_on_the_card(gpu):
    """Right after the plant the card's predictions are the baseline's."""
    from multi_modal_gnn_tpu_torch.training import bundle_membership_matrix, warm_start_trainer

    head = {"bilinear_rank": 17, "bilinear_source": "embedding"}
    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0),
        model=ModelConfig(use_pallas=True, extras={"head_style": "factored"},
                          edge_head=dataclasses.replace(ModelConfig().edge_head, extras=head)),
    )
    graph = make_synthetic_graph(LIFECYCLE_SPEC, config, device="cpu")
    trainer = _lifecycle_trainer(config, graph, gpu)
    baseline = warm_start_trainer(trainer, memberships=bundle_membership_matrix(graph))
    p, l, _ = trainer.masker.split_arrays("val")
    np.testing.assert_allclose(trainer.predict("val"), baseline.predict(p, l), atol=1e-4)
    assert trainer.best_val_loss == trainer.validate()
    assert np.isfinite(trainer.train_epoch())


# -- Cluster-GCN mini-batch training -------------------------------------------

CLUSTER_CONFIG = Config(graph=GraphConfig(dense_adjacency_max_bytes=0), model=ModelConfig(use_pallas=True))


def _cluster_trainer(graph, device, host_resident, seed=0):
    from multi_modal_gnn_tpu_torch.training import MiniBatchTrainer

    model = build_model(CLUSTER_CONFIG, graph, device="cpu", generator=torch.Generator().manual_seed(seed))
    return MiniBatchTrainer(model, graph, EdgeMasker(graph), CLUSTER_CONFIG, 4, host_resident=host_resident,
                            device=device)


@pytest.mark.cuda
def test_host_resident_clusters_on_the_card(gpu):
    """Host-resident clusters lie pinned on the host and train like
    device-resident ones: within twice the drift of six device-resident
    runs (the kernels' atomics), as chip_smoke.py phase 25 (e) holds them
    (host- and device-resident runs drift from one population:
    tools/cluster_drift.py)."""
    graph = make_synthetic_graph(LIFECYCLE_SPEC, CLUSTER_CONFIG, device="cpu")

    def run(host):
        trainer = _cluster_trainer(graph, gpu, host)
        losses, vals = trainer.train_epochs(2, with_val=True)
        return trainer, np.concatenate([losses, vals])

    runs = [run(False)[1] for _ in range(6)]
    host, c = run(True)
    drift = max(float(np.abs(a - b).max() / np.abs(a).min()) for i, a in enumerate(runs) for b in runs[i + 1:])
    assert float(np.abs(c - runs[0]).max() / np.abs(runs[0]).min()) <= 2 * drift
    cd = host._ensure_clusters()
    assert all(t.is_pinned() for g in cd.subgraphs for t in g.tensors())
    assert cd.batches["train"][0][0].patient_idx.is_cuda
    preds = host.predict("test")
    assert np.isfinite(preds).all() and preds.shape == (len(host.masker.split_indices("test")),)


@pytest.mark.cuda
@pytest.mark.parametrize("host_resident", [False, True], ids=["device", "host"])
def test_bf16_cluster_step_on_the_card(gpu, host_resident):
    """One bfloat16 cluster step (base > 0, dropout 0), card against the CPU
    plain versions at phase 27's bounds: K1 and K2f launch in bfloat16, K2b
    in float32 (JAX hands the fused-table backward float32), K3 not."""
    from multi_modal_gnn_tpu_torch.training import MiniBatchTrainer

    config = dataclasses.replace(
        CLUSTER_CONFIG, model=dataclasses.replace(CLUSTER_CONFIG.model, compute_dtype="bfloat16", dropout=0.0))
    graph = make_synthetic_graph(LIFECYCLE_SPEC, config, device="cpu")
    out = {}
    for dev in (gpu, torch.device("cpu")):
        model = build_model(config, graph, device="cpu", generator=torch.Generator().manual_seed(0))
        trainer = MiniBatchTrainer(model, graph, EdgeMasker(graph), config, 4,
                                   host_resident=host_resident and dev.type == "cuda", device=dev)
        cd = trainer._ensure_clusters()
        assert cd.bases[1] > 0
        batch = cd.batches["train"][1][0]
        sup = (np.random.default_rng(1).random(batch.valid.shape[0]) < 0.4) * batch.valid.cpu().numpy()
        sk.reset_launch_counts()
        pk.reset_launch_counts()
        loss = trainer.train_step(batch, torch.from_numpy(sup.astype(np.float32)).to(dev), 0,
                                  graph=cd.subgraphs[1].to(dev))
        launched = {**sk.launch_counts, **pk.launch_counts}
        out[dev.type] = (loss, {n: p.grad.cpu() for n, p in trainer.model.named_parameters()}, launched)
    assert not out["cuda"][2]["span_segment_sum_bf16"] and not out["cuda"][2]["fused_table_segment_sum_bwd_bf16"]
    _bf16_step_close(out, ("segment_sum_windowed_bf16", "fused_table_segment_sum_bf16", "fused_table_segment_sum_bwd"))


@pytest.mark.cuda
def test_cluster_step_launches_the_segment_kernels(gpu):
    graph = make_synthetic_graph(LIFECYCLE_SPEC, CLUSTER_CONFIG, device="cpu")
    trainer = _cluster_trainer(graph, gpu, False)
    cd = trainer._ensure_clusters()
    batch, sub = cd.batches["train"][1][0], cd.subgraphs[1]
    sk.reset_launch_counts()
    loss = trainer.train_step(batch, batch.valid, 0, graph=sub)
    assert np.isfinite(loss)
    counts = dict(sk.launch_counts)
    assert counts["segment_sum_windowed"] > 0 and counts["fused_table_segment_sum"] > 0, counts
    assert counts["fused_table_segment_sum_bwd"] > 0 and counts["span_segment_sum"] == 0, counts


@pytest.mark.cuda
def test_bench_clusters_prints_its_line(gpu):
    import json
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run(
        [sys.executable, "-m", "multi_modal_gnn_tpu_torch.tools.bench", "--epochs", "2", "--no-dense", "--clusters", "2"],
        cwd=Path(__file__).resolve().parent.parent, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["clusters"] == 2 and line["value"] > 0 and line["kernel_launches"]
