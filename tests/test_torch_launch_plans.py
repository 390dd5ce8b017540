"""PyTorch port: the launch plans of the kernels redesigned for the H100,
K2f (``ops/segment_kernels.fused_table_launch``), K4b / K5b
(``ops/pairhead_kernels.bwd_launch``), K4f / K5f (``fwd_launch``), K1
(``windowed_route``, ``windowed_launch``), K8
(``ops/attention_kernels.dkv_launch``) and K6 / K7 (``rows_launch``).

The wrappers derive them on the host before they launch, so they are checked
here without a card: every table the fused-table tier admits fits a block's
shared memory, the column slices cover the width, the unit counters hand out
every unit once, and the pair heads' shared memory does not depend on the
lab table.  The kernels themselves are compared with their plain versions on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import pytest
import torch

from multi_modal_gnn_tpu_torch.graph.attn_plan import ATTN_RESIDENT_MAX_ROWS
from multi_modal_gnn_tpu_torch.ops import attention_kernels as ak
from multi_modal_gnn_tpu_torch.ops import pairhead_kernels as pk
from multi_modal_gnn_tpu_torch.ops import segment_kernels as sk
from multi_modal_gnn_tpu_torch.ops.segment import FUSED_TABLE_MAX_BYTES, FUSED_TABLE_MAX_ROWS

H100_SMS = 132

# K2f, name: (tiles, table rows, width)
FUSED = {
    "lab_to_patient": (5239, 500, 128),  # scale_100k
    "diagnosis_to_patient": (782, 500, 128),
    "medication_to_patient": (1563, 300, 128),
    "largest_table": (100, FUSED_TABLE_MAX_ROWS, 128),
    "small_table": (10, 37, 128),
    "width_4": (10, 2048, 4),
    "width_36": (10, 2048, 36),
    "width_256": (10, 500, 256),
    "one_tile": (1, 37, 128),
}


@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_table_slices_fit_and_cover_the_width(name):
    num_tiles, rows, d = FUSED[name]
    launch = sk.fused_table_launch(num_tiles, rows, d, H100_SMS)
    assert launch.shared_bytes == 4 * rows * launch.stride + sk._FT_INDEX_BYTES <= sk._MAX_SHARED_BYTES
    assert launch.slice % 4 == 0 and launch.slice <= min(d, 128)
    assert launch.stride >= launch.slice and launch.stride % 4 == 0  # 16-byte cp.async rows
    assert (launch.slices - 1) * launch.slice < d <= launch.slices * launch.slice
    # the blocks of all slices share the SMs, one block each
    assert 1 <= launch.blocks and launch.blocks * launch.slices <= max(H100_SMS, launch.slices)
    # each warp's first grab is its own, then each atomicAdd of the slice's
    # counter hands out the next `grab` units: every unit once, in about
    # four grabs a warp
    assert launch.units == num_tiles * 1024 // 64 and launch.grab >= 1
    warps = launch.blocks * 16
    starts = list(range(0, warps * launch.grab, launch.grab)) + list(
        range(warps * launch.grab, launch.units, launch.grab)
    )
    units = [u for u0 in starts for u in range(u0, min(u0 + launch.grab, launch.units)) if u0 < launch.units]
    assert units == list(range(launch.units))
    assert -(-launch.units // (warps * launch.grab)) <= 4


@pytest.mark.parametrize("d", [4, 8, 36, 64, 128, 256, 512])
def test_every_table_the_tier_admits_fits(d):
    # the tier admits up to FUSED_TABLE_MAX_ROWS rows and FUSED_TABLE_MAX_BYTES
    rows = min(FUSED_TABLE_MAX_ROWS, FUSED_TABLE_MAX_BYTES // (4 * d))
    for r in (1, rows // 3, rows):
        assert sk.fused_table_launch(100, r, d, H100_SMS).shared_bytes <= sk._MAX_SHARED_BYTES


def test_fused_table_slices_are_as_wide_as_fit():
    # a 300-row table keeps whole 128-column rows, 500 rows take 64 columns,
    # 2048 rows 16 (padded: the row groups of a quarter-warp miss each other's banks)
    assert (sk.fused_table_launch(1563, 300, 128, H100_SMS).slice, sk.fused_table_launch(1563, 300, 128, H100_SMS).slices) == (128, 1)
    lab = sk.fused_table_launch(5239, 500, 128, H100_SMS)
    assert (lab.slice, lab.slices, lab.stride, lab.blocks) == (64, 2, 64, 66)
    big = sk.fused_table_launch(100, 2048, 128, H100_SMS)
    assert (big.slice, big.slices, big.stride) == (16, 8, 20)


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("num_tiles", [1, 7, 3821, 3974])
def test_pair_head_backward_plan(num_tiles, heads):
    launch = pk.bwd_launch(num_tiles, H100_SMS, heads)
    assert launch.units == num_tiles * 1024 // pk.BWD_UNIT and launch.heads == heads
    assert launch.threads == 32 * pk.BWD_WARPS == 256
    # one block an SM, never more blocks than the units keep busy
    assert 1 <= launch.blocks <= H100_SMS and launch.blocks <= -(-launch.units // pk.BWD_WARPS)
    if num_tiles >= 3821:  # scale_100k's train batches fill the card
        assert launch.blocks == H100_SMS


def test_pair_head_backward_shared_memory_is_the_same_for_any_lab_table():
    # W1's split fragments (4 x 8 KB), b1 and w2, and per warp 16 staging
    # rows of 72 and 40 floats, 2 x 16 rows of 72 for the group's Pp and Pl
    # rows and 3 x 128 words of unit metadata: 172 KB, whatever num_l is
    assert pk.BWD_SHARED_BYTES == 32_768 + 256 + 8 * (16 * (72 + 40 + 2 * 72) + 3 * 128) * 4 == 176_384
    assert pk.BWD_SHARED_BYTES <= sk._MAX_SHARED_BYTES
    assert pk.bwd_launch(10, H100_SMS).shared_bytes == pk.BWD_SHARED_BYTES
    # the staging row strides are 8 mod 32 floats: a fragment read (lane
    # g, t at row t, column g) and a float2 write (row g, columns 2t, 2t + 1)
    # of a half-warp each fall on distinct banks
    for stride in (72, 40):
        assert len({(t * stride + g) % 32 for g in range(8) for t in range(4)}) == 32
        for half in (range(0, 4), range(4, 8)):
            banks = [(g * stride + 2 * t + q) % 32 for g in half for t in range(4) for q in range(2)]
            assert len(set(banks)) == 32


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("num_tiles", [1, 7, 300, 3821, 3974, 6502])
def test_pair_head_forward_plan(num_tiles, heads):
    launch = pk.fwd_launch(num_tiles, H100_SMS, heads)
    assert launch.units == num_tiles * 1024 // pk.FWD_UNIT == num_tiles * 8 and launch.heads == heads
    assert launch.threads == 32 * pk.FWD_WARPS == 256
    # two blocks an SM a head (K5f: the tabular head's blocks follow the
    # GNN head's), and no block whose warps all start past the last unit
    assert 1 <= launch.blocks <= 2 * H100_SMS and (launch.blocks - 1) * pk.FWD_WARPS < launch.units
    if num_tiles >= 300:  # more units than warps: the counter hands out the rest
        assert launch.blocks == 2 * H100_SMS and launch.units > launch.blocks * pk.FWD_WARPS
    # each head's warps take a unit by index, then units from the head's
    # own counter (K5f: one counter a head): every unit of a head once
    assert _dealt_once(launch.units, launch.blocks * pk.FWD_WARPS, 1)


def test_pair_head_forward_shared_memory_fits_two_blocks_an_sm():
    # W1's split fragments for h0 @ W1 (2 x 8 KB), b1 and w2, and per warp
    # 2 x 16 staging rows of 72 floats and 2 x 128 words of unit metadata:
    # 96 KB, whatever num_l is; two blocks an SM, each with the 1 KB a block
    # reserves, fit the SM's 228 KB
    assert pk.FWD_SHARED_BYTES == 16_384 + 256 + 8 * (2 * 16 * 72 + 2 * 128) * 4 == 98_560
    assert 2 * (pk.FWD_SHARED_BYTES + 1024) <= 228 * 1024
    assert pk.FWD_SHARED_BYTES <= sk._MAX_SHARED_BYTES
    for heads in (1, 2):
        assert pk.fwd_launch(10, H100_SMS, heads).shared_bytes == pk.FWD_SHARED_BYTES


def _dealt_once(units: int, warps: int, grab: int) -> bool:
    """Each warp's first grab by its index, then each counter grab of
    ``grab`` units: every unit exactly once."""
    starts = list(range(0, warps * grab, grab)) + list(range(warps * grab, units, grab))
    got = [u for u0 in starts if u0 < units for u in range(u0, min(u0 + grab, units))]
    return got == list(range(units))


# K1 at its call sites (scale_100k, hidden 128) and at the tier's edges:
# name: (rows of x, width, pre-gathered, the route)
K1_ROUTES = {
    "paired_forward_from_patients": (100_000, 128, False, "global"),
    "span_backward_lab_gradient": (500, 128, False, "shared"),
    "paired_backward_diagnosis_gradient": (500, 128, False, "shared"),
    "paired_backward_medication_gradient": (300, 128, False, "shared"),
    "planned_gather_backward": (409_600, 128, True, "gathered"),
    "largest_table_the_tier_admits": (FUSED_TABLE_MAX_ROWS, 128, False, "shared"),
    "one_row_too_many": (FUSED_TABLE_MAX_ROWS + 1, 128, False, "global"),
    "too_many_bytes": (FUSED_TABLE_MAX_ROWS, 1024, False, "global"),
    "width_36": (37, 36, False, "shared"),
    "width_256": (37, 256, False, "shared"),
    "gathered_width_4": (1024, 4, True, "gathered"),
}


def test_k1_table_gates_are_the_fused_table_tiers():
    # K1 stages in shared memory exactly the tables the fused-table tier would
    assert (sk.WINDOWED_TABLE_MAX_ROWS, sk.WINDOWED_TABLE_MAX_BYTES) == (FUSED_TABLE_MAX_ROWS, FUSED_TABLE_MAX_BYTES)


@pytest.mark.parametrize("name", sorted(K1_ROUTES))
def test_k1_route_and_plan(name):
    rows, d, gathered, route = K1_ROUTES[name]
    assert sk.windowed_route(rows, d, gathered) == route
    num_tiles = max(1, rows // 1024) if gathered else 402
    launch = sk.windowed_launch(num_tiles, rows, d, H100_SMS, route)
    assert launch.shared_bytes <= sk._MAX_SHARED_BYTES
    assert launch.units == num_tiles * 1024 // 64
    assert (launch.slices - 1) * launch.slice < d <= launch.slices * launch.slice
    assert launch.slice % 4 == 0
    if route == "shared":  # K2f's own plan: the table's slice fits beside the indices
        assert launch == sk.fused_table_launch(num_tiles, rows, d, H100_SMS)
        assert launch.shared_bytes == 4 * rows * launch.stride + sk._FT_INDEX_BYTES
        assert _dealt_once(launch.units, launch.blocks * 16, launch.grab)
    else:  # a block a tile for each 128-column slice, no dynamic shared memory, no counter
        assert launch.shared_bytes == 0 and launch.grab == 1
        assert launch.slice == min(d, 128) and launch.blocks == num_tiles


def test_k1_rejects_an_unknown_route():
    with pytest.raises(ValueError):
        sk.windowed_launch(10, 100, 128, H100_SMS, "dense")


# K8 on scale_100k's HGT groups (4 heads of 32): name: (reverse tiles, rows
# of q / dO gathered, route, slice, slices)
K8_GROUPS = {
    "patient": (7828, 100_000, "sort", 64, 2),
    "lab": (5239, 500, "table", 32, 4),
    "diagnosis": (782, 500, "table", 32, 4),
    "medication": (1563, 300, "table", 64, 2),
}


def _k8_shared(launch, rows, h, num_heads):
    """The dynamic shared memory csrc/attention.cu sizes for the launch."""
    dh = h // num_heads
    if launch.route == "table":  # q, dO slices; LSE, delta of its heads; staged indices
        return 4 * (2 * rows * launch.stride + 2 * rows * (launch.slice // dh)) + 32 * 2 * 64 * 4
    groups = 32 * 32 // (launch.slice // 4)  # row groups of 32 warps
    kv = 2 if launch.stage_kv else 1  # the partial, and the window's k | v slice
    return 4 * (kv * 128 * 2 * launch.slice + groups * 2 * launch.slice) + 4 * 6 * 1024


@pytest.mark.parametrize("group", sorted(K8_GROUPS))
def test_k8_route_of_each_hgt_group(group):
    tiles, rows, route, width, slices = K8_GROUPS[group]
    launch = ak.dkv_launch(tiles, rows, 128, 4, H100_SMS)
    assert (launch.route, launch.slice, launch.slices) == (route, width, slices)
    assert launch.shared_bytes == _k8_shared(launch, rows, 128, 4) <= sk._MAX_SHARED_BYTES
    assert launch.blocks * launch.slices <= H100_SMS  # one block an SM
    if route == "table":
        units = tiles * 1024 // 64
        assert _dealt_once(units, launch.blocks * 32, launch.grab)
        assert -(-units // (launch.blocks * 32 * launch.grab)) <= 4  # about four grabs a warp
    else:  # the patient group keeps its window's k | v slice beside the partial
        assert launch.stage_kv and 1 <= launch.grab <= 8


HEADS = [(h, nh) for h in (4, 8, 32, 36, 64, 96, 128) for nh in (1, 2, 3, 4, 8, 16, 32) if ak.heads_supported(h, nh)]


@pytest.mark.parametrize("h,num_heads", HEADS)
@pytest.mark.parametrize("rows", [1, 37, ATTN_RESIDENT_MAX_ROWS, ATTN_RESIDENT_MAX_ROWS + 1, 100_000])
def test_k8_plan_fits_every_width_it_takes(h, num_heads, rows):
    launch = ak.dkv_launch(100, rows, h, num_heads, H100_SMS)
    dh = h // num_heads
    heads = launch.slice // dh
    assert launch.slice % dh == 0 and heads & (heads - 1) == 0 and num_heads % heads == 0
    assert launch.slices * launch.slice == h
    assert launch.shared_bytes == _k8_shared(launch, rows, h, num_heads) <= sk._MAX_SHARED_BYTES
    # the table route stages the gathered side only where the plans keep it resident
    assert (launch.route == "table") <= (rows <= ak.DKV_TABLE_MAX_ROWS == ATTN_RESIDENT_MAX_ROWS)
    assert launch.mode == (0 if launch.route == "table" else 1 if launch.stage_kv else 2)
    assert 1 <= launch.blocks and launch.grab >= 1


def test_k8_sort_route_reads_k_and_v_from_memory_only_when_a_head_is_too_wide():
    # one head of 128 columns: its k | v slice does not fit beside the partial
    wide = ak.dkv_launch(100, 100_000, 128, 1, H100_SMS)
    assert (wide.route, wide.slice, wide.stage_kv) == ("sort", 128, False)
    assert ak.dkv_launch(100, 100_000, 128, 2, H100_SMS).stage_kv


def test_attention_launches_use_the_cached_sm_count(monkeypatch):
    def no_query(*args):
        raise AssertionError("the SM count is asked of the device at every launch")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_query)
    monkeypatch.setattr(ak, "_sms", lambda device: H100_SMS)
    plan = torch.zeros(4 * 1024, dtype=torch.int32)
    tiles = torch.zeros(4, dtype=torch.int32)
    assert ak._launch_args("k", torch.device("cpu"), plan, plan, tiles) == 4
    # K6 / K7 plan their launch on the cached count too
    table = torch.zeros(300, 128)
    for kind in ("fwd", "dq"):
        assert ak._rows_plan("k", kind, table, plan, plan, tiles, 4) == ak.rows_launch(kind, 4, 128, 4, H100_SMS)


# K6 / K7 on scale_100k's HGT forward sides (4 heads of 32): name: tiles
K67_GROUPS = {"patient": 7866, "lab": 5545, "medication": 1101, "diagnosis": 417}


@pytest.mark.parametrize("kind", ["fwd", "dq"])
@pytest.mark.parametrize("group", sorted(K67_GROUPS))
def test_k6_k7_plan_of_each_hgt_group(group, kind):
    tiles = K67_GROUPS[group]
    plan = ak.fwd_launch if kind == "fwd" else ak.dq_launch
    launch = plan(tiles, 128, 4, H100_SMS)
    # the widest slice first: every head in one block
    assert (launch.slice, launch.slices) == (128, 1)
    assert launch.shared_bytes == ak._rows_shared_bytes(kind, 128) <= sk._MAX_SHARED_BYTES
    assert launch.blocks * launch.slices <= H100_SMS  # one wave: a block an SM
    # K6: a block's share in two grabs; K7: about a sixteenth, at most 8 tiles
    assert launch.grab == (-(-tiles // (launch.blocks * 2)) if kind == "fwd" else max(1, min(8, tiles // (launch.blocks * 16))))


@pytest.mark.parametrize("kind", ["fwd", "dq"])
@pytest.mark.parametrize("h,num_heads", HEADS)
def test_k6_k7_plan_fits_every_width_it_takes(h, num_heads, kind):
    launch = ak.rows_launch(kind, 100, h, num_heads, H100_SMS)
    dh = h // num_heads
    heads = launch.slice // dh
    assert launch.slice % dh == 0 and heads & (heads - 1) == 0 and num_heads % heads == 0
    assert launch.slices * launch.slice == h
    # the widest slice of whole heads that fits
    assert launch.slice == next(w for w in ak._head_slices(h, num_heads) if ak._rows_shared_bytes(kind, w) <= sk._MAX_SHARED_BYTES)
    assert launch.shared_bytes == ak._rows_shared_bytes(kind, launch.slice) <= sk._MAX_SHARED_BYTES
    assert launch.blocks * launch.slices <= H100_SMS and launch.grab >= 1
    # at every slice a row group's cut run (o; K6: and m, l a lane) starts 16-byte aligned
    for width in ak._head_slices(h, num_heads):
        edge = ak._rows_edge_floats(kind, width)
        assert edge % 4 == 0 and edge >= width + (width // 2 if kind == "fwd" else 0)


def test_k6_partial_entries_are_distinct_for_every_grab_and_window():
    # grab g's tiles of window w write entry g + w: distinct, and below the count the wrapper allocates
    gen = torch.Generator().manual_seed(0)
    for grab in (1, 3, 8):
        tile_map = torch.sort(torch.randint(0, 40, (500,), generator=gen)).values
        num_windows = int(tile_map.max()) + 3
        pairs = {(t // grab, int(w)) for t, w in enumerate(tile_map)}
        entries = {g + w for g, w in pairs}
        assert len(entries) == len(pairs)
        assert max(entries) < ak.fwd_partial_entries(500, grab, num_windows)


def test_k6_k7_plans_refuse_an_unknown_kind():
    with pytest.raises(ValueError):
        ak.rows_launch("dkv", 10, 128, 4, H100_SMS)
