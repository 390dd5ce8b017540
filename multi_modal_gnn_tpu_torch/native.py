"""The host graph core (``csrc/graphcore.cpp``) by ctypes, and the plain
numpy version of each of its entry points.

The graph build and the raw-data ingest take the core's routes: a stable
counting sort by destination (:func:`sort_edges_by_dst`), a first-seen
factorizer of int64 IDs (:func:`factorize`), the windowed layout
(:func:`window_plan`), the span-bounded tile packer (:func:`span_plan`) and
the one-pass LABEVENTS scan (:func:`labevents_scan`).  The library is built
with the host's C++ compiler at first use (``ops/_build.build_graphcore``);
a failed build raises with the compiler's output.  Nothing falls back to
numpy quietly: the ``*_plain`` functions are the reference the tests hold
the core to, bit for bit, and :func:`plain_route` switches the graph build
to them on request (to compare the two plans).  :data:`launch_counts`
counts the core's calls by entry point.
"""

from __future__ import annotations

import ctypes
import gzip
import re
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

ENTRY_POINTS = ("sort_edges_by_dst", "factorize", "window_plan", "span_plan", "labevents_scan")
# calls that ran in the library, by entry point
launch_counts: Dict[str, int] = {name: 0 for name in ENTRY_POINTS}

_lib: Optional[ctypes.CDLL] = None
_plain = False

_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


@contextmanager
def plain_route() -> Iterator[None]:
    """Within the block, the entry points run their plain numpy versions."""
    global _plain
    before, _plain = _plain, True
    try:
        yield
    finally:
        _plain = before


def load() -> ctypes.CDLL:
    """The loaded library, built at first call."""
    global _lib
    if _lib is not None:
        return _lib
    from multi_modal_gnn_tpu_torch.ops import _build

    lib = ctypes.CDLL(str(_build.build_graphcore()))
    i32, i64, p = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    signatures = {
        "sort_edges_by_dst": (ctypes.c_int, [_i32p, i64, i32, _i32p, _i32p, _i32p]),
        "factorize_i64": (i64, [_i64p, i64, _i32p, _i64p, i64]),
        "window_plan_sizes": (i64, [_i32p, i32, i32, i32]),
        "window_plan": (ctypes.c_int, [_i32p, _i32p, _i32p, i64, i32, i32, i32, _i32p, _i32p, _i32p]),
        "span_plan_sizes": (i64, [_i32p, _i32p, _i32p, i64, i32, i32, i32, i32, i32]),
        "span_plan": (ctypes.c_int, [_i32p, _i32p, _i32p, i64, i32, i32, i32, i32, i32, i64,
                                     _i64p, _i32p, _i32p, _i32p]),
        "labevents_scan": (p, [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               _i64p, i64, ctypes.POINTER(i64)]),
        "labevents_fetch": (None, [p, _i32p, _i32p, _f64p, _i64p]),
        "labevents_free": (None, [p]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = lib
    return lib


# -- sort by destination ------------------------------------------------------


def sort_edges_by_dst(dst: np.ndarray, num_dst: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable sort by destination: ``(perm, counts[num_dst], row_ptr[num_dst
    + 1])``, all int32, with ``dst[perm]`` ascending."""
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    if _plain:
        return sort_edges_by_dst_plain(dst, num_dst)
    lib = load()
    perm = np.empty(len(dst), np.int32)
    counts = np.empty(num_dst, np.int32)
    row_ptr = np.empty(num_dst + 1, np.int32)
    rc = lib.sort_edges_by_dst(dst, len(dst), num_dst, perm, counts, row_ptr)
    if rc != 0:
        raise ValueError(f"sort_edges_by_dst: destinations outside [0, {num_dst}) (rc {rc})")
    launch_counts["sort_edges_by_dst"] += 1
    return perm, counts, row_ptr


def sort_edges_by_dst_plain(dst: np.ndarray, num_dst: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    dst = np.asarray(dst, dtype=np.int32)
    perm = np.argsort(dst, kind="stable").astype(np.int32)
    counts = np.bincount(dst, minlength=num_dst).astype(np.int32)
    row_ptr = np.zeros(num_dst + 1, np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return perm, counts, row_ptr


# -- factorize ----------------------------------------------------------------


def factorize(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """First-seen codes of int64 IDs: ``(codes int32 [n], uniques int64)``
    with ``uniques[codes] == ids``."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if _plain:
        return factorize_plain(ids)
    lib = load()
    n = len(ids)
    codes = np.empty(n, np.int32)
    uniques = np.empty(max(n, 1), np.int64)
    n_unique = lib.factorize_i64(ids, n, codes, uniques, max(n, 1))
    if n_unique < 0:
        raise RuntimeError(f"factorize_i64 failed (rc {n_unique})")
    launch_counts["factorize"] += 1
    return codes, uniques[:n_unique].copy()


def factorize_plain(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    ids = np.asarray(ids, dtype=np.int64)
    uniq, first, inverse = np.unique(ids, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    return rank[inverse.ravel()], uniq[order]


# -- window plan --------------------------------------------------------------


def window_plan(
    src_sorted: np.ndarray, dst_sorted: np.ndarray, row_ptr: np.ndarray, num_dst: int, window: int, tile_e: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The windowed layout of dst-sorted edges: every ``window``-row output
    window owns a whole number of ``tile_e``-slot tiles (at least one), pad
    slots carry ``win_local == window``.  Returns ``(win_src, win_local,
    tile_map, num_windows)``."""
    src_sorted = np.ascontiguousarray(src_sorted, dtype=np.int32)
    dst_sorted = np.ascontiguousarray(dst_sorted, dtype=np.int32)
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int32)
    if _plain:
        return window_plan_plain(src_sorted, dst_sorted, row_ptr, num_dst, window, tile_e)
    lib = load()
    total = lib.window_plan_sizes(row_ptr, num_dst, window, tile_e)
    win_src = np.empty(total, np.int32)
    win_local = np.empty(total, np.int32)
    tile_map = np.empty(total // tile_e, np.int32)
    n_tiles = lib.window_plan(src_sorted, dst_sorted, row_ptr, len(src_sorted), num_dst, window, tile_e,
                              win_src, win_local, tile_map)
    launch_counts["window_plan"] += 1
    return win_src, win_local, tile_map[:n_tiles], max((num_dst + window - 1) // window, 1)


def window_plan_plain(
    src_sorted: np.ndarray, dst_sorted: np.ndarray, row_ptr: np.ndarray, num_dst: int, window: int, tile_e: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    src = np.asarray(src_sorted, dtype=np.int32)
    dst = np.asarray(dst_sorted, dtype=np.int32)
    num_windows = max((num_dst + window - 1) // window, 1)
    bounds = np.asarray(row_ptr, np.int64)[np.minimum(np.arange(num_windows + 1) * window, num_dst)]
    src_parts, local_parts, tile_map = [], [], []
    for w in range(num_windows):
        lo, hi = int(bounds[w]), int(bounds[w + 1])
        n = hi - lo
        n_pad = max(tile_e, ((n + tile_e - 1) // tile_e) * tile_e)
        pad = n_pad - n
        src_parts.append(np.concatenate([src[lo:hi], np.zeros(pad, np.int32)]))
        local_parts.append(np.concatenate([dst[lo:hi] - w * window, np.full(pad, window, np.int32)]))
        tile_map.append(np.full(n_pad // tile_e, w, np.int32))
    return (
        np.concatenate(src_parts).astype(np.int32),
        np.concatenate(local_parts).astype(np.int32),
        np.concatenate(tile_map).astype(np.int32),
        num_windows,
    )


# -- span plan ----------------------------------------------------------------


def span_plan(
    win_local: np.ndarray, win_tile_map: np.ndarray, row_idx: np.ndarray, num_rows: int,
    block_rows: int, window: int, tile_e: int, align: int,
) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray, np.ndarray]:
    """Re-lay a windowed plan so every tile's real slots address rows of one
    ``block_rows``-row span at an ``align``-aligned base (real slots of a
    window sorted by row, tiles packed greedily; a window left without real
    slots keeps one pad tile).  Returns ``(slot_moves, new_len, local2,
    tile_map2, base)``: ``slot_moves[old]`` is each real old slot's new slot
    (-1 for old padding), ``base[t]`` the row base of new tile ``t``."""
    win_local = np.ascontiguousarray(win_local, dtype=np.int32)
    win_tile_map = np.ascontiguousarray(win_tile_map, dtype=np.int32)
    row_idx = np.ascontiguousarray(row_idx, dtype=np.int32)
    if block_rows % align:
        raise ValueError(f"span block_rows must be a multiple of {align}, got {block_rows}")
    if _plain:
        return span_plan_plain(win_local, win_tile_map, row_idx, num_rows, block_rows, window, tile_e, align)
    lib = load()
    e_win = len(win_local)
    args = (win_local, win_tile_map, row_idx, e_win, num_rows, block_rows, window, tile_e, align)
    e_span = lib.span_plan_sizes(*args)
    if e_span < 0:
        raise ValueError(f"span_plan_sizes: bad plan (rc {e_span}; rows outside [0, {num_rows}) or a partial tile)")
    slot_moves = np.empty(e_win, np.int64)
    local2 = np.empty(e_span, np.int32)
    tile_map2 = np.empty(e_span // tile_e, np.int32)
    base = np.empty(e_span // tile_e, np.int32)
    rc = lib.span_plan(*args, e_span, slot_moves, local2, tile_map2, base)
    if rc != 0:
        raise RuntimeError(f"span_plan failed (rc {rc})")
    launch_counts["span_plan"] += 1
    return slot_moves, int(e_span), local2, tile_map2, base


def span_plan_plain(
    win_local: np.ndarray, win_tile_map: np.ndarray, row_idx: np.ndarray, num_rows: int,
    block_rows: int, window: int, tile_e: int, align: int,
) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray, np.ndarray]:
    win_local = np.asarray(win_local)
    win_tile_map = np.asarray(win_tile_map)
    row_idx = np.asarray(row_idx)
    e_win = len(win_local)
    num_tiles = e_win // tile_e
    real = win_local < window
    rows_pad = max(-(-max(num_rows, 1) // 128) * 128, block_rows)
    max_base = rows_pad - block_rows

    slot_window = np.repeat(win_tile_map, tile_e)
    order = np.lexsort((np.arange(e_win), row_idx, slot_window))
    order = order[real[order]]
    g_win = slot_window[order]
    g_row = row_idx[order]
    n = len(order)
    if n:
        w_starts = np.nonzero(np.r_[True, g_win[1:] != g_win[:-1]])[0]
        w_ends = np.r_[w_starts[1:], n]
    else:
        w_starts = w_ends = np.zeros(0, dtype=np.int64)

    slot_moves = np.full(e_win, -1, dtype=np.int64)
    tile_bases: list = []
    tile_windows: list = []
    out_len = 0
    for s, e in zip(w_starts, w_ends):
        w = int(g_win[s])
        i = int(s)
        while i < e:
            base = min((int(g_row[i]) // align) * align, max_base)
            cut = i + int(np.searchsorted(g_row[i:e], base + block_rows, "left"))
            j = min(i + tile_e, cut)
            slot_moves[order[i:j]] = out_len + np.arange(j - i)
            tile_bases.append(base)
            tile_windows.append(w)
            out_len += tile_e
            i = j

    # windows with no real slot still get one pad tile, so the window
    # sequence stays complete; then tiles re-sort by window and slot_moves
    # follows the tile permutation
    seen_windows = set(tile_windows)
    for w in range(int(win_tile_map.max()) + 1 if num_tiles else 0):
        if w not in seen_windows:
            tile_bases.append(0)
            tile_windows.append(w)
            out_len += tile_e
    t_order = np.argsort(np.asarray(tile_windows), kind="stable")
    if not np.array_equal(t_order, np.arange(len(t_order))):
        tile_new_pos = np.empty(len(t_order), dtype=np.int64)
        tile_new_pos[t_order] = np.arange(len(t_order))
        m = slot_moves >= 0
        slot_moves[m] = tile_new_pos[slot_moves[m] // tile_e] * tile_e + slot_moves[m] % tile_e
        tile_bases = list(np.asarray(tile_bases)[t_order])
        tile_windows = list(np.asarray(tile_windows)[t_order])

    local2 = np.full(out_len, window, dtype=np.int32)
    m = slot_moves >= 0
    local2[slot_moves[m]] = win_local[m]
    return (
        slot_moves,
        out_len,
        local2,
        np.asarray(tile_windows, dtype=np.int32),
        np.asarray(tile_bases, dtype=np.int32),
    )


# -- LABEVENTS scan -----------------------------------------------------------

LabScan = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def labevents_scan(path, col_subj: int, col_item: int, col_val: int, col_time: int, ids) -> LabScan:
    """One pass over a LABEVENTS CSV (plain or gzip): the rows whose
    SUBJECT_ID is in ``ids`` (empty: every row) and whose VALUENUM parses
    whole as a number.  Returns ``(subject int32, item int32, value float64,
    charttime int64)``, the chart time in epoch seconds of a
    ``YYYY-MM-DD HH:MM:SS`` field, -1 for any other.  Columns are 0-based
    field positions (``col_time`` < 0: none)."""
    ids = np.ascontiguousarray(np.sort(np.asarray(ids, dtype=np.int64)))
    cols = (col_subj, col_item, col_val, col_time)
    if _plain:
        return labevents_scan_plain(path, *cols, ids)
    if not Path(path).exists():
        raise FileNotFoundError(path)
    lib = load()
    n_out = ctypes.c_int64()
    handle = lib.labevents_scan(str(path).encode(), *cols, ids, len(ids), ctypes.byref(n_out))
    n = n_out.value
    if not handle:
        raise OSError(f"labevents_scan could not open {path} (rc {n})")
    launch_counts["labevents_scan"] += 1
    try:
        subj = np.empty(n, np.int32)
        item = np.empty(n, np.int32)
        val = np.empty(n, np.float64)
        time = np.empty(n, np.int64)
        if n:
            lib.labevents_fetch(handle, subj, item, val, time)
    finally:
        lib.labevents_free(handle)
    return subj, item, val, time


def open_bytes(path):
    """Binary reader of a plain or gzip file, told apart by the gzip magic
    bytes (as zlib's ``gzopen`` tells them apart)."""
    with open(path, "rb") as f:
        magic = f.read(2)
    return gzip.open(path, "rb") if magic == b"\x1f\x8b" else open(path, "rb")


_WS = " \t\n\v\f\r"
_STRTOLL = re.compile(r"[ \t\n\v\f\r]*([+-]?\d+)")
_STRTOD = re.compile(
    r"[ \t\n\v\f\r]*[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf(?:inity)?|nan(?:\([0-9A-Za-z_]*\))?"
    r"|0x(?:[0-9a-f]+\.?[0-9a-f]*|\.[0-9a-f]+)(?:p[+-]?\d+)?)",
    re.IGNORECASE,
)
# sscanf("%4d-%2d-%2d %2d:%2d:%2d"): each %Nd skips white space, then takes
# at most N characters, its sign included, greedily and without backtracking
_D4 = r"[ \t\n\v\f\r]*((?>[+-]\d{1,3}+|\d{1,4}+))"
_D2 = r"[ \t\n\v\f\r]*((?>[+-]\d|\d{1,2}+))"
_CHARTTIME = re.compile(_D4 + "-" + _D2 + "-" + _D2 + r"[ \t\n\v\f\r]*" + _D2 + ":" + _D2 + ":" + _D2)
_I64 = (-(1 << 63), (1 << 63) - 1)


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncating toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _days_from_civil(y: int, m: int, d: int) -> int:
    y -= m <= 2
    era = _cdiv(y if y >= 0 else y - 399, 400)
    yoe = y - era * 400
    doy = _cdiv(153 * (m + (-3 if m > 2 else 9)) + 2, 5) + d - 1
    doe = yoe * 365 + _cdiv(yoe, 4) - _cdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _strtoll(text: str) -> Optional[int]:
    m = _STRTOLL.match(text)
    return None if m is None else min(max(int(m.group(1)), _I64[0]), _I64[1])


def _strtod_whole(text: str) -> Optional[float]:
    if not text or _STRTOD.fullmatch(text) is None:
        return None
    s = text.lstrip(_WS)
    body = s.lstrip("+-")
    if body[:2].lower() == "0x":
        return float.fromhex(s)
    if body[:3].lower() == "nan":
        return float("-nan" if s.startswith("-") else "nan")
    return float(s)


def _int32(x: int) -> int:
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def _split(line: str, maxcol: int):
    """``(starts, lens)`` of fields ``0..maxcol`` as the core splits a line
    (a ``"`` toggles quoting; ``,`` outside quotes ends a field; a line
    break or NUL ends the line), or None when the line has fewer fields."""
    if '"' not in line:
        parts = re.split("[\r\n]", line, maxsplit=1)[0].split(",", maxcol + 1)
        if len(parts) <= maxcol:
            return None
        lens = [len(p) for p in parts[: maxcol + 1]]
        return np.cumsum([0] + [ln + 1 for ln in lens[:-1]]).tolist(), lens
    starts, lens = [0], []
    inq = False
    field = 0
    i = 0
    n = len(line)
    while True:
        c = line[i] if i < n else "\0"
        if c == '"':
            inq = not inq
        elif (c == "," and not inq) or c in "\n\r\0":
            lens.append(i - field)
            if c != "," or len(lens) > maxcol:
                break
            field = i + 1
            starts.append(field)
        i += 1
    return (starts, lens) if len(lens) > maxcol else None


def _field(line: str, starts, lens, c: int) -> Tuple[int, int]:
    s, ln = starts[c], lens[c]
    if ln >= 2 and line[s] == '"' and line[s + ln - 1] == '"':
        s, ln = s + 1, ln - 2
    return s, ln


def labevents_scan_plain(path, col_subj: int, col_item: int, col_val: int, col_time: int, ids) -> LabScan:
    """:func:`labevents_scan` line by line in Python: the same split, the
    same parse of each field (C's ``strtoll`` / ``strtod`` / ``sscanf`` on
    its first 63 bytes), the same filters."""
    keep = set(np.asarray(ids, dtype=np.int64).tolist())
    maxcol = max(col_subj, col_item, col_val, col_time)
    subj, item, val, time = [], [], [], []
    with open_bytes(path) as f:
        next(f, None)  # header
        for raw in f:
            line = raw.decode("latin-1").split("\0", 1)[0]
            split = _split(line, maxcol)
            if split is None:
                continue
            starts, lens = split
            s, ln = _field(line, starts, lens, col_subj)
            sid = _strtoll(line[s: s + min(ln, 63)])
            if sid is None or (keep and sid not in keep):
                continue
            s, ln = _field(line, starts, lens, col_val)
            v = _strtod_whole(line[s: s + min(ln, 63)])
            if v is None:
                continue
            s, ln = _field(line, starts, lens, col_item)
            iid = _strtoll(line[s: s + min(ln, 63)])
            if iid is None:
                continue
            ts = -1
            if col_time >= 0:
                s, ln = _field(line, starts, lens, col_time)
                m = _CHARTTIME.match(line, s) if ln >= 19 else None
                if m is not None:
                    y, mo, d, h, mi, se = (int(g) for g in m.groups())
                    ts = _days_from_civil(y, mo, d) * 86400 + h * 3600 + mi * 60 + se
            subj.append(_int32(sid))
            item.append(_int32(iid))
            val.append(v)
            time.append(ts)
    return (
        np.asarray(subj, np.int32), np.asarray(item, np.int32),
        np.asarray(val, np.float64), np.asarray(time, np.int64),
    )
