"""PyTorch port: each segment kernel's plain version against the JAX Pallas
function it replaces, and the aggregation tier gates against the JAX ones.

The case is ``tests/test_span_dma.py``'s: 80k edges from 4,996 sources into
300 destinations, plus its duplicate-edge case.  The JAX functions run in
interpret mode, as the JAX package's tests run them on the CPU; the port's
wrappers take their plain versions because the tensors lie on the CPU.  The
two sum in different orders, so each is held to a float64 host reference
(``rtol=atol=1e-5`` on means; on sums of up to ~600 N(0, 1) rows, whose
magnitudes reach ~50, f32 rounding reaches ~3e-5, so ``atol=1e-4``).
The kernels themselves are compared with these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.graph import hetero as jax_hetero
from multi_modal_gnn_tpu.ops import pallas_segment as jps
from multi_modal_gnn_tpu_torch.graph import hetero as port_hetero
from multi_modal_gnn_tpu_torch.ops import segment as port_segment
from multi_modal_gnn_tpu_torch.ops import segment_kernels as sk

NUM_SRC, NUM_DST, D = 4096 + 900, 300, 32
RTOL = 1e-5
ATOL = {"mean": 1e-5, "sum": 1e-4}


def _edges(duplicates: bool):
    if duplicates:
        rng = np.random.default_rng(5)
        src = np.repeat(rng.integers(0, NUM_SRC, size=3_000), 8).astype(np.int32)
        dst = np.repeat(rng.integers(0, 64, size=3_000), 8).astype(np.int32)
        num_dst = 64
    else:
        rng = np.random.default_rng(0)
        src = rng.integers(0, NUM_SRC, size=80_000).astype(np.int32)
        dst = rng.integers(0, NUM_DST, size=80_000).astype(np.int32)
        num_dst = NUM_DST
    return src, dst, num_dst


@pytest.fixture(scope="module", params=[False, True], ids=["random", "duplicates"])
def case(request):
    src, dst, num_dst = _edges(request.param)
    x = np.random.default_rng(1).standard_normal((NUM_SRC, D)).astype(np.float32)
    xr = np.random.default_rng(2).standard_normal((num_dst, D)).astype(np.float32)
    kw = dict(src_span_rows=256)
    return dict(
        src=src, dst=dst, num_dst=num_dst, x=x, xr=xr,
        jax_fwd=jax_hetero.pad_edge_set(src, dst, NUM_SRC, num_dst, **kw),
        jax_rev=jax_hetero.pad_edge_set(dst, src, num_dst, NUM_SRC, **kw),
        fwd=port_hetero.pad_edge_set(src, dst, NUM_SRC, num_dst, **kw),
        rev=port_hetero.pad_edge_set(dst, src, num_dst, NUM_SRC, **kw),
    )


def _reference(x, src, dst, num_dst, aggregation):
    """float64 host segment sum / mean."""
    out = np.zeros((num_dst, x.shape[1]), np.float64)
    np.add.at(out, dst, x[src].astype(np.float64))
    if aggregation == "mean":
        out /= np.maximum(np.bincount(dst, minlength=num_dst), 1)[:, None]
    return out


def _finish(total, es, aggregation):
    out = total[: es.num_dst]
    if aggregation == "mean":
        out = out / es.dst_count.clamp_min(1.0)[:, None]
    return out.numpy()


def _check(port_out, jax_out, ref, aggregation):
    np.testing.assert_allclose(port_out, ref, rtol=RTOL, atol=ATOL[aggregation])
    np.testing.assert_allclose(np.asarray(jax_out), ref, rtol=RTOL, atol=ATOL[aggregation])


@pytest.mark.parametrize("pregathered", [False, True])
def test_windowed_segment_sum_matches_jax(case, pregathered):
    es, jes = case["fwd"], case["jax_fwd"]
    x = torch.from_numpy(case["x"])
    gathered = np.array(jnp.take(jnp.asarray(case["x"]), jes.win_src, axis=0))
    want = jps.windowed_segment_sum(
        jnp.asarray(gathered), jes.win_local, jes.win_tile_map, jes.num_windows, True
    )[: jes.num_dst]
    if pregathered:
        total = sk.segment_sum_windowed(
            torch.from_numpy(gathered), None, es.win_local, es.win_tile_map, es.num_windows
        )
    else:
        total = sk.segment_sum_windowed(x, es.win_src, es.win_local, es.win_tile_map, es.num_windows)
    ref = _reference(case["x"], case["src"], case["dst"], case["num_dst"], "sum")
    _check(_finish(total, es, "sum"), want, ref, "sum")


@pytest.mark.parametrize("aggregation", ["mean", "sum"])
def test_fused_table_matches_jax(case, aggregation):
    # the reverse relation: num_dst (<= 300) sources, a small table
    es, jes = case["rev"], case["jax_rev"]
    assert port_segment.fused_table_applicable(es, D) and jps.fused_table_applicable(jes, D)
    want = jps.fused_table_aggregate(jnp.asarray(case["xr"]), jes, aggregation, interpret=True)
    total = sk.fused_table_segment_sum(
        torch.from_numpy(case["xr"]), es.win_src, es.win_local, es.win_tile_map, es.num_windows
    )
    ref = _reference(case["xr"], case["dst"], case["src"], NUM_SRC, aggregation)
    _check(_finish(total, es, aggregation), want, ref, aggregation)


@pytest.mark.parametrize("aggregation", ["mean", "sum"])
def test_span_matches_jax(case, aggregation):
    es, jes = case["fwd"], case["jax_fwd"]
    if jes.span_src is None:
        pytest.fail("the span plan was refused for this case")
    want = jps.span_dma_aggregate(
        jnp.asarray(case["x"]), jes, case["jax_rev"], aggregation, interpret=True
    )
    total = sk.span_segment_sum(
        torch.from_numpy(case["x"]), es.span_src, es.span_local, es.span_tile_map,
        es.span_base, es.num_windows, es.span_rows,
    )
    ref = _reference(case["x"], case["src"], case["dst"], case["num_dst"], aggregation)
    _check(_finish(total, es, aggregation), want, ref, aggregation)


def test_tier_gates_match_jax(case):
    for es, jes, rev, jrev in (
        (case["fwd"], case["jax_fwd"], case["rev"], case["jax_rev"]),
        (case["rev"], case["jax_rev"], case["fwd"], case["jax_fwd"]),
    ):
        for d in (32, 128, 4096):
            assert port_segment.fused_table_applicable(es, d) == jps.fused_table_applicable(jes, d)
        assert port_segment.span_dma_applicable(es, rev) == jps.span_dma_applicable(jes, jrev)
        assert port_segment.span_dma_applicable(es, None) == jps.span_dma_applicable(jes, None)
    assert port_segment.aggregation_tier(case["fwd"], case["rev"], D) == "span"
    assert port_segment.aggregation_tier(case["rev"], case["fwd"], D) == "fused_table"


@pytest.mark.parametrize("aggregation", ["mean", "sum", "max"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_aggregate_neighbors_matches_jax(case, aggregation, impl):
    from multi_modal_gnn_tpu.ops.segment import aggregate_neighbors as jax_aggregate

    got = port_segment.aggregate_neighbors(
        torch.from_numpy(case["x"]), case["fwd"], aggregation, impl=impl, edges_rev=case["rev"]
    )
    want = jax_aggregate(
        jnp.asarray(case["x"]), case["jax_fwd"], aggregation, impl=impl,
        edges_rev=case["jax_rev"],
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_paired_tier_when_no_span_plan():
    src, dst, num_dst = _edges(False)
    fwd = port_hetero.pad_edge_set(src, dst, NUM_SRC, num_dst)  # no span rows: no plan
    rev = port_hetero.pad_edge_set(dst, src, num_dst, NUM_SRC)
    assert port_segment.aggregation_tier(fwd, rev, D) == "paired"
    assert port_segment.aggregation_tier(fwd, None, D) == "windowed"
    assert port_segment.aggregation_tier(fwd, rev, D, impl="xla") == "xla"
    x = np.random.default_rng(1).standard_normal((NUM_SRC, D)).astype(np.float32)
    got = port_segment.aggregate_neighbors(torch.from_numpy(x), fwd, "mean", "pallas", rev)
    np.testing.assert_allclose(
        got.numpy(), _reference(x, src, dst, num_dst, "mean"), rtol=RTOL, atol=ATOL["mean"]
    )


def test_dense_tier():
    rng = np.random.default_rng(4)
    src = rng.integers(0, 50, 2000).astype(np.int32)
    dst = rng.integers(0, 300, 2000).astype(np.int32)
    es = port_hetero.pad_edge_set(src, dst, 50, 300, dense_max_bytes=1 << 20)
    assert port_segment.aggregation_tier(es, None, D) == "dense"
    x = rng.standard_normal((50, D)).astype(np.float32)
    for aggregation in ("mean", "sum"):
        got = port_segment.aggregate_neighbors(torch.from_numpy(x), es, aggregation, "pallas")
        np.testing.assert_allclose(
            got.numpy(), _reference(x, src, dst, 300, aggregation), rtol=RTOL,
            atol=ATOL[aggregation],
        )


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean"])
@pytest.mark.parametrize("width", [None, D])
def test_segment_ops_match_jax(op, width):
    from multi_modal_gnn_tpu.ops import segment as jax_segment

    rng = np.random.default_rng(6)
    shape = (5_000,) if width is None else (5_000, width)
    data = rng.standard_normal(shape).astype(np.float32)
    ids = rng.integers(0, 700, 5_000).astype(np.int32)  # some segments stay empty
    got = getattr(port_segment, op)(torch.from_numpy(data), torch.from_numpy(ids), 700)
    want = getattr(jax_segment, op)(jnp.asarray(data), jnp.asarray(ids), 700)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL["mean"])
