"""PyTorch port: the CUDA segment kernels against their plain versions.

Tests marked ``cuda`` need a GPU and skip without one.  This file imports
neither JAX nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Kernels sum with f32 atomics in an order that changes from run to run, so
means are compared within ``rtol=atol=1e-5`` and the slice within 1e-4.
"""

import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu_torch.config import Config, GraphConfig, ModelConfig
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
from multi_modal_gnn_tpu_torch.graph import hetero
from multi_modal_gnn_tpu_torch.graph.schema import mirror_edge_type
from multi_modal_gnn_tpu_torch.models import build_model
from multi_modal_gnn_tpu_torch.ops import aggregation_tier
from multi_modal_gnn_tpu_torch.ops import segment_kernels as sk
from multi_modal_gnn_tpu_torch.serving import compute_node_state

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
def test_kernels_are_forward_only(gpu, plans):
    es = plans[1].to(gpu)
    x = torch.randn(es.num_src, D, device=gpu, requires_grad=True)
    with pytest.raises(NotImplementedError):
        sk.fused_table_segment_sum(x, es.win_src, es.win_local, es.win_tile_map, es.num_windows)
    with torch.no_grad():
        sk.fused_table_segment_sum(x, es.win_src, es.win_local, es.win_tile_map, es.num_windows)


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
    graph = make_synthetic_graph(spec, config)
    tiers = {
        aggregation_tier(es, graph.edges.get(mirror_edge_type(et)), 128)
        for et, es in graph.edges.items()
    }
    assert tiers == {"fused_table", "span", "paired"}
    model = build_model(config, graph, generator=torch.Generator().manual_seed(0))
    want = compute_node_state(model, graph)
    sk.reset_launch_counts()
    got = compute_node_state(model.to(gpu), graph.to(gpu))
    assert all(sk.launch_counts.values()), sk.launch_counts
    for key in want:
        np.testing.assert_allclose(got[key].cpu().numpy(), want[key].numpy(), rtol=1e-4, atol=1e-4)


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
