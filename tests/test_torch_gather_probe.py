"""PyTorch port: P1, the in-kernel row-gather probe, against the JAX script.

``scripts/bench_gather_impl.py`` is imported by path and its own kernel
bodies (``_kernel_indicator``, ``_kernel_dyngather``) run under
``pl.pallas_call(..., interpret=True)`` with ``build``'s grid spec, at 2
tiles over a 64-row table.  The port's plain versions (which its wrappers
take for CPU tensors) must give the same per-slot row sums to a relative
``1e-5`` of the largest: sums of 64 f32 values in another order.  The
port's command line mirrors the script's flags and defaults.
"""

import ast
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from multi_modal_gnn_tpu_torch.config import ConfigError
from multi_modal_gnn_tpu_torch.ops import gather_probe as gp
from multi_modal_gnn_tpu_torch.tools import bench_gather

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "bench_gather_impl.py"


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("bench_gather_impl", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _interpret(script, kernel, idx, table):
    """The script's ``build`` grid spec around ``kernel``, in interpret mode."""
    num_tiles = idx.shape[0] // script.TILE_E
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=0,
        grid=(num_tiles,),
        in_specs=[
            pl.BlockSpec((script.TILE_E,), lambda t: (t,)),
            pl.BlockSpec(table.shape, lambda t: (0, 0)),
        ],
        out_specs=pl.BlockSpec((script.TILE_E,), lambda t: (t,)),
    )
    call = pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((num_tiles * script.TILE_E,), jnp.float32), interpret=True,
    )
    return np.asarray(call(jnp.asarray(idx), jnp.asarray(table)))


@pytest.mark.parametrize("variant", ["A", "B", "C"])
def test_plain_versions_match_the_script_kernels(script, variant):
    args = bench_gather.parse_args(["--tiles", "2", "--rows", "64", "--h", "64"])
    idx, table, padded = bench_gather.make_inputs(args)
    tpu_kernel, tpu_table, port = {
        "A": (script._kernel_indicator, table,
              lambda i: gp.gather_probe_indicator(i, torch.from_numpy(table))),
        "B": (functools.partial(script._kernel_dyngather, h=args.h), padded,
              lambda i: gp.gather_probe_padded(i, torch.from_numpy(padded), args.h)),
        "C": (functools.partial(script._kernel_dyngather, h=args.h), table,
              lambda i: gp.gather_probe_direct(i, torch.from_numpy(table))),
    }[variant]
    want = _interpret(script, tpu_kernel, idx, tpu_table)
    gp.reset_launch_counts()
    got = port(torch.from_numpy(idx)).numpy()
    assert not any(gp.launch_counts.values())  # the CPU took the plain version
    assert got.shape == want.shape == (2 * 1024,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def test_plain_version_reads_a_zero_row_outside_the_table():
    table = torch.randn(8, 16)
    idx = torch.tensor([0, 7, 8, -1] * 256, dtype=torch.int32)
    got = gp.gather_probe_indicator(idx, table)
    assert torch.equal(got[2::4], torch.zeros(256)) and torch.equal(got[3::4], torch.zeros(256))
    torch.testing.assert_close(got[0::4], table[0].sum().expand(256))


def test_command_line_mirrors_the_script():
    """The port's flags and defaults are the script's own (read from its
    ``add_argument`` calls); bf16 is refused; no card, no run."""
    defaults = {}
    for node in ast.walk(ast.parse(SCRIPT.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            flag = node.args[0].value.lstrip("-")
            defaults[flag] = next(ast.literal_eval(k.value) for k in node.keywords if k.arg == "default")
    assert vars(bench_gather.parse_args([])) == defaults
    args = bench_gather.parse_args(["--tiles", "3840", "--rows", "512", "--h", "128", "--dtype", "float32"])
    assert (args.tiles, args.rows, args.h) == (3840, 512, 128)
    with pytest.raises(ConfigError):
        bench_gather.parse_args(["--dtype", "bfloat16"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            bench_gather.main(["--tiles", "1", "--rows", "8", "--h", "16"])
