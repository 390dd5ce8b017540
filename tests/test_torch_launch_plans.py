"""PyTorch port: the launch plans of the kernels redesigned for the H100,
K2f (``ops/segment_kernels.fused_table_launch``) and K4b / K5b
(``ops/pairhead_kernels.bwd_launch``).

The wrappers derive them on the host before they launch, so they are checked
here without a card: every table the fused-table tier admits fits a block's
shared memory, the column slices cover the width, the unit counters hand out
every unit once, and K4b's shared memory does not depend on the lab table.
The kernels themselves are compared with their plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import pytest

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
