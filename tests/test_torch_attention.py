"""PyTorch port: the HGT attention plans and the flash-attention group
against the JAX package.

* Plans are integer layouts: the port's ``build_attn_plans`` / ``_build_side``
  must give the JAX package's arrays exactly, on the tiny bundle and at the
  shapes of ``tests/test_attention_kernel.py`` (the span layout forced on
  both sides, the ladder's high rung).
* The port's ``flash_attention_group`` (on the CPU: the K6 / K7 / K8 plain
  versions) is held against the JAX oracle ``flash_attention_ref`` and its
  ``jax.grad`` at ``test_attention_kernel.py``'s tolerances: 2e-5 forward,
  ``rtol=5e-4, atol=5e-5`` for ``dq``, ``dk``, ``dv``.  One case runs the
  JAX kernel itself in Pallas interpret mode.
* ``segment_softmax`` against the JAX one, values and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.graph import attn_plan as jax_plan
from multi_modal_gnn_tpu.ops import pallas_attention as jax_attn
from multi_modal_gnn_tpu.ops.segment import segment_softmax as jax_segment_softmax
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
from multi_modal_gnn_tpu_torch.graph import attn_plan
from multi_modal_gnn_tpu_torch.ops import attention_kernels
from multi_modal_gnn_tpu_torch.ops.attention import flash_attention_group, flash_attention_ref
from multi_modal_gnn_tpu_torch.ops.segment import segment_softmax

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
_SIDE_ARRAYS = ("win_src", "win_local", "win_tile_map", "span_src", "span_local", "span_tile_map", "span_base")


def assert_sides_equal(port, jax_side):
    assert (port.num_windows, port.span_rows) == (jax_side.num_windows, jax_side.span_rows)
    for name in _SIDE_ARRAYS:
        got, want = getattr(port, name), getattr(jax_side, name)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


def assert_plans_equal(port, jax_group):
    for name in ("rel_keys", "src_offsets", "num_src_total", "num_dst", "num_edges"):
        assert getattr(port, name) == getattr(jax_group, name), name
    assert_sides_equal(port.fwd, jax_group.fwd)
    assert_sides_equal(port.rev, jax_group.rev)


# -- plans --------------------------------------------------------------------


@pytest.mark.parametrize("resident_max", [512, 0], ids=["resident", "forced_span"])
@pytest.mark.parametrize("seed", [0, 1])
def test_build_attn_plans_equals_jax(seed, resident_max):
    bundle = make_synthetic_bundle(JaxSpec.tiny(seed), JaxConfig())
    graph = make_synthetic_graph(SyntheticSpec.tiny(seed), Config(), device="cpu")
    want = jax_plan.build_attn_plans(bundle.graph, bundle.host_edges, resident_max=resident_max)
    got = attn_plan.build_attn_plans(graph, resident_max=resident_max)
    assert set(got) == set(want) == {et[2] for et in graph.edge_types}
    for dst_t in want:
        assert_plans_equal(got[dst_t], want[dst_t])
        if resident_max == 0:
            assert got[dst_t].fwd.use_span and got[dst_t].rev.use_span


# (num_dst, num_src, num_edges, span_rows, resident_max, seed): the groups of
# tests/test_attention_kernel.py
SIDE_CASES = {
    "resident": (300, 150, 4000, 64, 2048, 0),
    "gradients": (200, 120, 3000, 64, 2048, 0),
    "span_both_sides": (300, 260, 20000, 128, 0, 0),
    "high_rung": (256, 6000, 20000, 128, 512, 3),
    "empty_destinations": (400, 50, 1000, 64, 2048, 3),
}


def _side_case(name):
    num_dst, num_src, e, span_rows, resident_max, seed = SIDE_CASES[name]
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_src, e).astype(np.int32)
    dst = rng.integers(0, 100 if name == "empty_destinations" else num_dst, e).astype(np.int32)
    return src, dst, num_dst, num_src, span_rows, resident_max


@pytest.mark.parametrize("name", list(SIDE_CASES))
def test_build_side_equals_jax(name):
    src, dst, num_dst, num_src, span_rows, resident_max = _side_case(name)
    sides = []
    for args in ((src, dst, num_dst, num_src), (dst, src, num_src, num_dst)):
        got = attn_plan._build_side(*args, span_rows, resident_max)
        want = jax_plan._build_side(*args, span_rows, resident_max)
        assert got is not None and want is not None
        assert_sides_equal(got, want)
        sides.append(got)
    if name == "high_rung":  # the forward side climbed past the base span
        assert sides[0].use_span and sides[0].span_rows >= 512
    if name == "span_both_sides":
        assert sides[0].use_span and sides[1].use_span


def test_ensure_attn_plans_follows_the_config():
    graph = make_synthetic_graph(SyntheticSpec.tiny(), Config(), device="cpu")
    model = dict(architecture="HGT", use_pallas=True)
    assert attn_plan.ensure_attn_plans(graph, Config.from_dict({"model": model})).attn_plans
    for off in ({"architecture": "RGCN"}, {"use_pallas": False}, {"extras": {"hgt_flash": "off"}}):
        cfg = Config.from_dict({"model": {**model, **off}})
        assert attn_plan.ensure_attn_plans(graph, cfg).attn_plans is None


# -- attention ------------------------------------------------------------------


def _groups(name):
    src, dst, num_dst, num_src, span_rows, resident_max = _side_case(name)
    port = attn_plan.AttnGroupPlan(
        fwd=attn_plan._build_side(src, dst, num_dst, num_src, span_rows, resident_max),
        rev=attn_plan._build_side(dst, src, num_src, num_dst, span_rows, resident_max),
        src_offsets=(0,), num_src_total=num_src, num_dst=num_dst, num_edges=len(src),
    )
    jax_group = jax_plan.AttnGroupPlan(
        fwd=jax_plan._build_side(src, dst, num_dst, num_src, span_rows, resident_max),
        rev=jax_plan._build_side(dst, src, num_src, num_dst, span_rows, resident_max),
        src_offsets=(0,), num_src_total=num_src, num_dst=num_dst, num_edges=len(src),
    )
    return port, jax_group


def _duplicate_groups():
    src = np.array([0, 0, 1], dtype=np.int32)
    dst = np.array([0, 0, 0], dtype=np.int32)
    sides = lambda mod: (mod._build_side(src, dst, 2, 2, 64, 2048), mod._build_side(dst, src, 2, 2, 64, 2048))  # noqa: E731
    port = attn_plan.AttnGroupPlan(*sides(attn_plan), num_src_total=2, num_dst=2, num_edges=3)
    jax_group = jax_plan.AttnGroupPlan(*sides(jax_plan), num_src_total=2, num_dst=2, num_edges=3)
    return port, jax_group


def _qkv(plan, h, seed=1):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(n, h)).astype(np.float32)
        for n in (plan.num_dst, plan.num_src_total, plan.num_src_total)
    ]


def _port_value_and_grads(plan, arrays, w, nh):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = flash_attention_group(*leaves, plan, nh)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax_value_and_grads(fn, plan, arrays, w, nh):
    def loss(q, k, v):
        out = fn(q, k, v, plan, nh)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(*arrays)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize(
    "name, nh, h",
    [
        ("resident", 1, 64),
        ("resident", 4, 64),
        ("gradients", 4, 64),
        ("span_both_sides", 4, 64),
        ("high_rung", 4, 64),
        ("empty_destinations", 4, 64),
        ("duplicates", 2, 8),
    ],
)
def test_flash_attention_matches_jax_reference(name, nh, h):
    plan, jax_group = _duplicate_groups() if name == "duplicates" else _groups(name)
    arrays = _qkv(plan, h)
    if name == "duplicates":
        arrays[0] = np.ones_like(arrays[0])
    w = np.random.default_rng(7).normal(size=(plan.num_dst, h)).astype(np.float32)
    attention_kernels.reset_launch_counts()
    out, grads = _port_value_and_grads(plan, arrays, w, nh)
    assert not any(attention_kernels.launch_counts.values())  # the CPU takes the plain versions
    want, want_grads = _jax_value_and_grads(jax_attn.flash_attention_ref, jax_group, arrays, w, nh)
    np.testing.assert_allclose(out, want, **FWD_TOL)
    for got_g, want_g, gname in zip(grads, want_grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got_g, want_g, **GRAD_TOL, err_msg=gname)
    if name == "empty_destinations":
        assert np.all(out[100:] == 0.0)
    # the port's own oracle agrees too
    ref = flash_attention_ref(*[torch.from_numpy(a) for a in arrays], plan, nh).numpy()
    np.testing.assert_allclose(out, ref, **FWD_TOL)


def test_flash_attention_matches_the_jax_kernel_in_interpret_mode():
    plan, jax_group = _groups("span_both_sides")
    arrays = _qkv(plan, 64, seed=3)
    w = np.random.default_rng(8).normal(size=(plan.num_dst, 64)).astype(np.float32)

    def kernel(q, k, v, p, nh):
        return jax_attn.flash_attention_group(q, k, v, p, nh, interpret=True)

    out, grads = _port_value_and_grads(plan, arrays, w, 4)
    want, want_grads = _jax_value_and_grads(kernel, jax_group, arrays, w, 4)
    np.testing.assert_allclose(out, want, **FWD_TOL)
    for got_g, want_g, gname in zip(grads, want_grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got_g, want_g, **GRAD_TOL, err_msg=gname)


def test_forward_lse_is_the_log_sum_exp_of_each_row():
    """K6's LSE per row and head (the TPU kernel's stats columns [0, nh)):
    log sum exp of the row's logits, 1e30 for a row without edges; and the
    backward's exp clamp is the JAX package's."""
    plan, _ = _groups("empty_destinations")
    q, k, v = _qkv(plan, 64)
    _, lse = attention_kernels.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), *plan.fwd.arrays(),
        plan.fwd.num_windows, 4,
    )
    src, dst, *_ = _side_case("empty_destinations")
    logits = np.einsum("ehd,ehd->eh", q.reshape(-1, 4, 16)[dst].astype(np.float64), k.reshape(-1, 4, 16)[src])
    want = np.full((lse.shape[0], 4), 1e30)
    for d in np.unique(dst):
        want[d] = np.log(np.exp(logits[dst == d]).sum(axis=0))
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    assert attention_kernels.EXP_CLAMP == jax_attn._EXP_CLAMP


# -- segment softmax ---------------------------------------------------------------


def test_segment_softmax_matches_jax():
    rng = np.random.default_rng(0)
    e, nh, num_segments = 400, 3, 50
    logits = rng.normal(size=(e, nh)).astype(np.float32) * 4
    logits[rng.random(e) < 0.1] = -np.inf  # masked edges
    ids = rng.integers(0, num_segments - 5, e)  # the last segments stay empty
    ids[:6] = 3
    logits[:6] = -np.inf  # a segment of masked edges only
    w = rng.normal(size=(e, nh)).astype(np.float32)

    def jax_loss(x):
        s = jax_segment_softmax(x, jnp.asarray(ids), num_segments)
        return jnp.sum(jnp.where(jnp.isfinite(x), s, 0.0) * w)

    x = torch.from_numpy(logits).requires_grad_()
    got = segment_softmax(x, torch.from_numpy(ids), num_segments)
    finite = torch.isfinite(x)
    (torch.where(finite, got, torch.zeros_like(got)) * torch.from_numpy(w)).sum().backward()
    want = np.asarray(jax_segment_softmax(jnp.asarray(logits), jnp.asarray(ids), num_segments))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-7)
    want_grad = np.asarray(jax.grad(jax_loss)(jnp.asarray(logits)))
    mask = np.isfinite(logits)
    np.testing.assert_allclose(x.grad.numpy()[mask], want_grad[mask], rtol=1e-5, atol=1e-6)
