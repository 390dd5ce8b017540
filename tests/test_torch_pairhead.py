"""PyTorch port: the fused pair head (K4f / K4b) against the JAX Pallas
kernel, and the dropout generator the kernels share with their plain
versions.

The problems are ``tests/test_pairhead_kernel.py``'s: a slot-major batch
over 300 patients, full lab table or span-bounded lab tiles, with and
without a tile mask.  JAX runs ``fused_pair_head`` in interpret mode with
``rate=0`` (its in-kernel generator only lowers on a TPU); the port runs its
autograd Function, whose wrappers take the plain versions on the CPU.  Both
are f32; the forward is held to ``atol=1e-5`` and the six gradients, sums
over up to 4,000 slots in another order, to ``rtol=atol=1e-4`` (the JAX
file's own bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.graph import hetero as jax_hetero
from multi_modal_gnn_tpu.ops.pallas_pairhead import fused_pair_head as jax_fused_pair_head
from multi_modal_gnn_tpu_torch.graph import hetero
from multi_modal_gnn_tpu_torch.ops import pairhead_kernels as pk
from multi_modal_gnn_tpu_torch.ops.pairhead import fused_pair_head

NAMES = ("proj_p", "proj_l", "w1", "b1", "w2", "b2")


def _problem(seed, num_l, lab_rows):
    rng = np.random.default_rng(seed)
    num_p, batch = 300, 4000
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
        l_s = l2
    params = dict(
        proj_p=rng.standard_normal((num_p, 64)).astype(np.float32),
        proj_l=rng.standard_normal((num_l, 64)).astype(np.float32),
        w1=(rng.standard_normal((64, 32)) * 0.1).astype(np.float32),
        b1=(rng.standard_normal(32) * 0.1).astype(np.float32),
        w2=(rng.standard_normal(32) * 0.1).astype(np.float32),
        b2=np.float32(0.3),
    )
    num_tiles = len(win_local) // hetero.TILE_E
    mask = np.random.default_rng(seed + 1).integers(0, 2, num_tiles).astype(np.int32)
    g = (np.random.default_rng(seed + 2).standard_normal(len(win_local)) * (win_local < 128))
    return dict(
        l_s=l_s, win_local=np.asarray(win_local, np.int32), tile_map=np.asarray(tile_map, np.int32),
        bases=bases, num_windows=plan.num_windows, lab_rows=lab_rows, params=params, mask=mask,
        g=g.astype(np.float32),
    )


def _jax(prob, tile_mask, *args):
    bases = None if prob["bases"] is None else jnp.asarray(prob["bases"])
    return jax_fused_pair_head(
        *args, jnp.asarray(prob["l_s"]), jnp.asarray(prob["win_local"]), jnp.asarray(prob["tile_map"]),
        jnp.zeros(2, jnp.uint32), tile_mask, bases, prob["num_windows"], 0.0, True,
        prob["lab_rows"], bool(prob["lab_rows"]),
    )


def _port(prob, tile_mask, *args, rate=0.0, seed=(0, 0)):
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    p = list(args)
    p[5] = p[5].reshape(1)
    return fused_pair_head(
        *p, t(prob["l_s"]), t(prob["win_local"]), t(prob["tile_map"]), seed,
        None if tile_mask is None else t(tile_mask),
        None if prob["bases"] is None else t(prob["bases"]),
        prob["num_windows"], rate, prob["lab_rows"], bool(prob["lab_rows"]),
    )


@pytest.mark.parametrize("masked", [False, True], ids=["all_tiles", "tile_mask"])
@pytest.mark.parametrize(
    "num_l,lab_rows", [(37, 0), (300, 32), (300, 128)], ids=["full_table", "span32", "span128"]
)
def test_pair_head_matches_jax(num_l, lab_rows, masked):
    prob = _problem(0 if not lab_rows else 13, num_l, lab_rows)
    mask = prob["mask"] if masked else None
    jargs = [jnp.asarray(v) for v in prob["params"].values()]
    targs = [torch.from_numpy(np.asarray(v)).requires_grad_() for v in prob["params"].values()]
    want = _jax(prob, None if mask is None else jnp.asarray(mask), *jargs)
    got = _port(prob, mask, *targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)

    g = prob["g"]
    jgrads = jax.grad(
        lambda *a: jnp.sum(_jax(prob, None if mask is None else jnp.asarray(mask), *a) * g),
        argnums=tuple(range(6)),
    )(*jargs)
    (got * torch.from_numpy(g)).sum().backward()
    for name, t, jg in zip(NAMES, targs, jgrads):
        np.testing.assert_allclose(
            t.grad.numpy().reshape(np.shape(jg)), np.asarray(jg), rtol=1e-4, atol=1e-4,
            err_msg=f"grad({name})",
        )


def test_pair_head_rejects_a_span_width_without_its_map():
    prob = _problem(13, 300, 32)
    args = [torch.from_numpy(np.asarray(v)) for v in prob["params"].values()]
    args[5] = args[5].reshape(1)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    with pytest.raises(ValueError):
        fused_pair_head(
            *args, t(prob["l_s"]), t(prob["win_local"]), t(prob["tile_map"]), (0, 0), None, None,
            prob["num_windows"], 0.0, 32, True,
        )


def _fmix32_ref(h):
    h = np.uint32(h)
    with np.errstate(over="ignore"):
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


def test_dropout_bits_are_the_documented_hash():
    seed = (0xDEADBEEF, 12345)
    slots = np.array([0, 1, 7, 1023, 4_000_000, 2**32 - 1], dtype=np.int64)
    got = pk.dropout_bits(seed, torch.from_numpy(slots), 1, 32).numpy()
    with np.errstate(over="ignore"):
        k1 = _fmix32_ref(seed[1])
        for i, e in enumerate(slots):
            key = _fmix32_ref(np.uint32(seed[0]) ^ _fmix32_ref(np.uint32(e) ^ k1))
            for c in range(32):
                ctr = np.uint32((64 + c + 1) * 0x9E3779B9 & 0xFFFFFFFF)
                assert got[i, c] == int(_fmix32_ref(key ^ ctr))


def test_dropout_keep_rate_and_unsigned_threshold():
    threshold, scale = pk.dropout_params(0.2)
    assert threshold == int(0.2 * 2**32) and scale == pytest.approx(1.25)
    bits = pk.dropout_bits((3, 4), torch.arange(20_000), 0, 64)
    assert int(bits.min()) >= 0 and int(bits.max()) < 2**32
    keep = (bits >= threshold).double().mean().item()
    n = bits.numel()
    assert abs(keep - 0.8) < 5 * (0.8 * 0.2 / n) ** 0.5  # a signed compare keeps 0.3
    with pytest.raises(ValueError):
        pk.dropout_params(1.0)


def test_dropout_forward_and_backward_share_the_masks():
    """With dropout on, the plain backward (autograd through the plain
    forward, which redraws the bits) equals a finite-difference directional
    derivative, and a second forward repeats the first bit for bit."""
    prob = _problem(13, 300, 32)
    args = [torch.from_numpy(np.asarray(v)).double() for v in prob["params"].values()]
    args[5] = args[5].reshape(1)
    seed = (11, 22)
    kw = dict(rate=0.2, seed=seed)
    out1 = _port(prob, prob["mask"], *args, **kw)
    out2 = _port(prob, prob["mask"], *args, **kw)
    assert torch.equal(out1, out2)
    active = out1 != 0
    assert 0 < int(active.sum())
    other = _port(prob, prob["mask"], *args, rate=0.2, seed=(12, 22))
    assert not torch.equal(out1, other)

    leaves = [a.clone().requires_grad_() for a in args]
    g = torch.from_numpy(prob["g"]).double()
    (_port(prob, prob["mask"], *leaves, **kw) * g).sum().backward()
    direction = [torch.randn_like(a, generator=torch.Generator().manual_seed(i)) for i, a in enumerate(args)]
    eps = 1e-8  # float64; larger steps cross ReLU kinks at this many units
    plus = _port(prob, prob["mask"], *[a + eps * d for a, d in zip(args, direction)], **kw)
    minus = _port(prob, prob["mask"], *[a - eps * d for a, d in zip(args, direction)], **kw)
    numeric = float(((plus - minus) * g).sum() / (2 * eps))
    analytic = float(sum((l.grad * d).sum() for l, d in zip(leaves, direction)))
    assert numeric == pytest.approx(analytic, rel=1e-6, abs=1e-6)
