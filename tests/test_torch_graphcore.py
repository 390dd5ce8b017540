"""PyTorch port: the host graph core (``csrc/graphcore.cpp`` by ctypes,
``multi_modal_gnn_tpu_torch/native.py``).

Each of its five entry points against its plain numpy version on random
inputs, bit for bit, and against the JAX package's own core where that is
built (``native/libgraphcore.so``); the LABEVENTS scan on plain and gzip
files with malformed fields; the graph build with the core against the plain plans; the build under
its lock with several processes at once.  The tests skip only where no
C++ compiler is found.
"""

import dataclasses
import gzip
import os
import random
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from multi_modal_gnn_tpu import native as jax_native

from multi_modal_gnn_tpu_torch import native
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
from multi_modal_gnn_tpu_torch.graph.attn_plan import build_attn_plans
from multi_modal_gnn_tpu_torch.graph.hetero import SPAN_BASE_ALIGN, TILE_E, WINDOW
from multi_modal_gnn_tpu_torch.graph.indexer import NodeIndexer
from multi_modal_gnn_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def graphcore():
    if _build.cxx() is None:
        pytest.skip("no C++ compiler to build csrc/graphcore.cpp")
    native.load()


def assert_bits_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), (g[:10], w[:10])
        else:
            assert g == w


def _jax_core():
    """The JAX package's core where it is built, else None."""
    return jax_native if jax_native.available() else None


@pytest.mark.parametrize("seed", range(4))
def test_sort_factorize_window_span_equal_plain(seed):
    rng = np.random.default_rng(seed)
    jax_core = _jax_core()
    for _ in range(5):
        e = int(rng.integers(0, 6000))
        num_dst = int(rng.integers(1, 900))
        dst = rng.integers(0, num_dst, e).astype(np.int32)
        src = rng.integers(0, 5000, e).astype(np.int32)
        got = native.sort_edges_by_dst(dst, num_dst)
        assert_bits_equal(got, native.sort_edges_by_dst_plain(dst, num_dst))
        if jax_core and e:
            assert_bits_equal(got, jax_core.sort_edges_by_dst(dst, num_dst))

        ids = rng.integers(-40, 40, e).astype(np.int64) * (1 << int(rng.integers(0, 50)))
        got = native.factorize(ids)
        assert_bits_equal(got, native.factorize_plain(ids))
        if jax_core:
            assert_bits_equal(got, jax_core.factorize(ids))

        perm, _, row_ptr = native.sort_edges_by_dst_plain(dst, num_dst)
        s, d = src[perm], dst[perm]
        for tile_e in (TILE_E, 64):
            got = native.window_plan(s, d, row_ptr, num_dst, WINDOW, tile_e)
            assert_bits_equal(got, native.window_plan_plain(s, d, row_ptr, num_dst, WINDOW, tile_e))
            if jax_core:
                assert_bits_equal(got, jax_core.window_plan(s, d, row_ptr, num_dst, WINDOW, tile_e))
            win_src, win_local, tile_map, _ = got
            for block_rows in (16, 128, 256):
                args = (win_local, tile_map, win_src, 5000, block_rows, WINDOW, tile_e, SPAN_BASE_ALIGN)
                span = native.span_plan(*args)
                assert_bits_equal(span, native.span_plan_plain(*args))
                if jax_core:
                    assert_bits_equal(span, jax_core.span_plan(*args))


def test_bad_input_raises():
    with pytest.raises(ValueError, match="destinations"):
        native.sort_edges_by_dst(np.asarray([0, 5], np.int32), 3)
    with pytest.raises(ValueError, match="multiple of"):
        native.span_plan(np.zeros(64, np.int32), np.zeros(1, np.int32), np.zeros(64, np.int32), 10, 24, 128, 64, 16)
    with pytest.raises(ValueError, match="bad plan"):
        native.span_plan(np.zeros(64, np.int32), np.zeros(1, np.int32), np.full(64, 11, np.int32), 10, 16, 128, 64, 16)


# fields of every shape the scan parses: signs, spaces, quotes, hex and
# special floats, overflowing ids, dates of other shapes and impossible dates
_SUBJ = ["1", "2", "3", " 4", "+5", "-6", "7x", "", "x", '"8"', "99999999999", "2147483649", "1.9"]
_ITEM = ["50001", "50002", '"50003"', "", "abc", "7e3", " 12", "-3"]
_VAL = ["1.5", "nan", "NaN", "inf", "-Infinity", "0x1p3", "1e", "1e5", ".5", "5.", " 5", "5 ", "", '"2.5"',
        "1_000", "1e999", "abc", "-0", '"1,5"', "-nan"]
_TIME = ["2150-01-01 05:00:00", "2150-01-01", "", "2150-13-40 99:99:99", " 2150-1-1 1:2:3   ",
         "1969-12-31 23:59:59", "+215-01-01 00:00:00", "2150-01-0112:00:00xxxxx", '"2150-02-03 04:05:06"',
         "abcd-ef-gh ij:kl:mn", "-001-02-03 04:05:06"]


def _scan_file(tmp_path, seed, gz):
    rng = random.Random(seed)
    lines = ["ROW_ID,SUBJECT_ID,ITEMID,CHARTTIME,VALUENUM,FLAG"]
    for i in range(1500):
        fields = [str(i), rng.choice(_SUBJ), rng.choice(_ITEM), rng.choice(_TIME), rng.choice(_VAL),
                  rng.choice(["", "abnormal", '"a,b"'])]
        lines.append(",".join(fields) + rng.choice(["", "\r"]))
    lines.insert(700, "")  # a blank line
    lines.insert(701, "1,2")  # too few fields
    text = "\n".join(lines) + rng.choice(["", "\n"])
    path = tmp_path / ("le.csv.gz" if gz else "le.csv")
    with (gzip.open if gz else open)(path, "wt", newline="") as f:
        f.write(text)
    return path


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("ids", [[], [1, 2, 3, 4, 5, -6, 7, 8, 99999999999, 2147483649]])
def test_labevents_scan_equals_plain(tmp_path, gz, ids):
    path = _scan_file(tmp_path, seed=len(ids) + gz, gz=gz)
    got = native.labevents_scan(path, 1, 2, 4, 3, ids)
    assert len(got[0]) > 100 and (got[3] == -1).any() and (got[3] > 0).any() and np.isnan(got[2]).any()
    assert_bits_equal(got, native.labevents_scan_plain(path, 1, 2, 4, 3, ids))
    if _jax_core():
        assert_bits_equal(got, jax_native.labevents_scan(path, 1, 2, 4, 3, ids))
    with pytest.raises(FileNotFoundError):
        native.labevents_scan(tmp_path / "missing.csv", 1, 2, 4, 3, ids)


def test_graph_build_with_the_core_equals_the_plain_plans():
    config = Config.from_dict({"graph": {"dense_adjacency_max_bytes": 0, "src_span_rows": 256}})
    spec = SyntheticSpec(num_patients=4600, num_labs=40, num_diagnoses=30, num_medications=20,
                         mean_labs_per_patient=9.0, seed=2)
    native.reset_launch_counts()
    graph = make_synthetic_graph(spec, config, device="cpu")
    plans = build_attn_plans(graph)
    counts = dict(native.launch_counts)
    assert all(counts[name] for name in ("sort_edges_by_dst", "window_plan", "span_plan")), counts
    with native.plain_route():
        native.reset_launch_counts()
        plain = make_synthetic_graph(spec, config, device="cpu")
        plain_plans = build_attn_plans(plain)
        assert not any(native.launch_counts.values())
    assert_same(graph.edges, plain.edges)
    assert any(es.span_rows for es in graph.edges.values())
    assert_same(plans, plain_plans)


def assert_same(a, b, where="plan"):
    """Tensors, arrays, dataclasses, dicts and sequences equal, recursively."""
    if hasattr(a, "numpy"):
        assert a.dtype == b.dtype and np.array_equal(a.numpy(), b.numpy()), where
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_indexer_factorizes_ints_in_the_core():
    ids = np.asarray([7, 3, 7, 9, 3, 3, 11], np.int64)
    native.reset_launch_counts()
    ix = NodeIndexer("patient")
    np.testing.assert_array_equal(ix.add_many(ids), [0, 1, 0, 2, 1, 1, 3])
    np.testing.assert_array_equal(ix.lookup_many(np.asarray([11, 5, 7])), [3, -1, 0])
    assert native.launch_counts["factorize"] == 2
    assert ix.index_to_id == [7, 3, 9, 11]


def test_concurrent_builds_share_one_library(tmp_path):
    """Three processes build into one empty directory at once: the lock lets
    one compile, the others load its library; no temporary file is left."""
    script = textwrap.dedent(
        f"""
        import sys
        from pathlib import Path
        sys.path.insert(0, {str(REPO)!r})
        from multi_modal_gnn_tpu_torch.ops import _build
        _build.BUILD_DIR = Path({str(tmp_path)!r})
        print(_build.build_graphcore().name)
        """
    )
    procs = [subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=dict(os.environ, OMP_NUM_THREADS="1")) for _ in range(3)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        outs.append(out.strip())
    assert len(set(outs)) == 1 and outs[0].startswith("libgraphcore_")
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted([outs[0], "graphcore.lock"])
