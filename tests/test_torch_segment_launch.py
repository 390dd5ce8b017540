"""PyTorch port: the launch plan of the incidence-product kernels K2b and K3
(``ops/segment_kernels.incidence_launch``).

The wrappers derive it on the host before they launch, so it is checked
here without a card: the blocks' tile counter hands out every tile once in
small shares, the shared layout fits a block and keeps each mma fragment's
loads on distinct banks, and the ``scale_100k`` shapes fill an H100 (132
SMs) with one wave of two blocks per SM.  The kernels themselves are
compared with their plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import pytest

from multi_modal_gnn_tpu_torch.ops import segment_kernels as sk

H100_SMS = 132

# name: (tiles, rows of the row block a unit may use, 128-source chunks, D)
CASES = {
    "k2b_lab_to_patient": (5239, 128, 4, 128),  # scale_100k, 500 labs
    "k2b_diagnosis_to_patient": (782, 128, 4, 128),
    "k2b_medication_to_patient": (1563, 128, 3, 128),  # 300 rows: a partial chunk
    "k2b_width_36": (33, 128, 4, 36),
    "k2b_width_256": (40, 128, 3, 256),
    "k3_patient_to_lab": (5010, 256, 1, 128),  # span rows 256
    "k3_width_4": (10, 256, 1, 4),
    "k3_width_36_span_64": (100, 64, 1, 36),
    "k3_span_512": (7, 512, 1, 128),
    "one_tile": (1, 128, 1, 128),
}


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _launch(name, sms=H100_SMS):
    num_tiles, k_rows, chunks, d = CASES[name]
    return sk.incidence_launch(num_tiles, k_rows, chunks, d, sms, span=name.startswith("k3"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_grabs_hand_out_every_tile_once_in_small_shares(name):
    num_tiles, k_rows, chunks, d = CASES[name]
    launch = _launch(name)
    assert launch.chunks == chunks and launch.col_blocks == -(-d // 128)
    assert 1 <= launch.blocks <= num_tiles and 1 <= launch.grab <= 32
    # the kernel's counter: each atomicAdd hands out the next `grab` tiles
    starts = range(0, num_tiles, launch.grab)
    tiles = [t for g0 in starts for t in range(g0, min(g0 + launch.grab, num_tiles))]
    assert tiles == list(range(num_tiles))
    if launch.grab > 1:  # a block's share is taken in about sixteen grabs
        assert len(starts) >= 16 * launch.blocks


@pytest.mark.parametrize("name", sorted(CASES))
def test_shared_layout_fits_and_spreads_fragments_over_banks(name):
    num_tiles, k_rows, chunks, d = CASES[name]
    launch = _launch(name)
    cw, sb = launch.count_words, launch.b_stride
    assert 2 * cw >= _round8(k_rows)  # two 16-bit counts a word
    assert sb >= _round8(min(d, 128))  # the column tail is zero-padded to 8
    staged_slots = 2 * 1024 if name.startswith("k3") else 0  # K3: the next tile's slots
    assert launch.shared_bytes == 4 * (128 * cw + 2 * 32 * sb + staged_slots) <= sk._MAX_SHARED_BYTES
    # an A fragment: lane (g, t) reads the word of column k0 + t in row g
    # (k0 a multiple of 8); lanes of one word share it, the rest differ
    words = {(g, t): g * cw + t // 2 for g in range(8) for t in range(4)}
    banks = {}
    for w in words.values():
        banks.setdefault(w % 32, set()).add(w)
    assert all(len(ws) == 1 for ws in banks.values())
    # a B fragment: lane (g, t) reads row t, column n0 + g (n0 a multiple of 8)
    assert len({(t * sb + g) % 32 for g in range(8) for t in range(4)}) == 32


@pytest.mark.parametrize(
    "name,shared_bytes",
    [("k2b_lab_to_patient", 68_608), ("k3_patient_to_lab", 109_568)],
)
def test_scale_100k_runs_one_wave_of_two_blocks_per_sm(name, shared_bytes):
    num_tiles, k_rows, chunks, d = CASES[name]
    launch = _launch(name)
    assert launch.shared_bytes == shared_bytes
    assert 2 * (shared_bytes + 1024) <= sk._SM_SHARED_BYTES  # two blocks share an SM
    assert launch.blocks * launch.chunks * launch.col_blocks <= 2 * H100_SMS


def test_a_block_too_large_for_two_per_sm_plans_one_wave_of_one():
    launch = _launch("k3_span_512")
    assert 2 * (launch.shared_bytes + 1024) > sk._SM_SHARED_BYTES
    big = sk.incidence_launch(10_000, 512, 1, 128, H100_SMS, span=True)
    assert big.blocks <= H100_SMS
