"""The grouped matmul's host-side rules, on the CPU: which path a call takes
(``kernel.path``) and the tensor-core path's tile census worked out from
``group_sizes`` alone (``ref.tile_census``), which the kernel's own census
must equal on the card (``test_torch_cuda.py``, ``chip_smoke.py`` phase 4).

The counts below are worked out by hand for one bin and one column tile:
an output tile is 128 rows, two 64-row halves; a tile whose first row is at
or past the bin's size ``g`` is written as zeros, and in the others a half
is computed if its first row is below ``g`` and skipped otherwise.
"""

import re

import pytest
import torch

from repro_torch.kernels.grouped_matmul import kernel
from repro_torch.kernels.grouped_matmul.ref import tile_census

# (C, g, zero tiles, halves computed, halves skipped) for one bin
HAND = [
    # C = 128: one row tile
    (128, 0, 1, 0, 0), (128, 1, 0, 1, 1), (128, 63, 0, 1, 1), (128, 64, 0, 1, 1),
    (128, 65, 0, 2, 0), (128, 127, 0, 2, 0), (128, 128, 0, 2, 0),
    (128, 129, 0, 2, 0),  # past C: the kernel clamps g to C
    # C = 640: five row tiles
    (640, 0, 5, 0, 0), (640, 1, 4, 1, 1), (640, 63, 4, 1, 1), (640, 64, 4, 1, 1),
    (640, 65, 4, 2, 0), (640, 127, 4, 2, 0), (640, 128, 4, 2, 0),
    (640, 129, 3, 3, 1), (640, 640, 0, 10, 0),
    # C = 200: rows 128-199 make a second tile whose half 1 holds rows 192-199
    (200, 0, 2, 0, 0), (200, 1, 1, 1, 1), (200, 63, 1, 1, 1), (200, 64, 1, 1, 1),
    (200, 65, 1, 2, 0), (200, 127, 1, 2, 0), (200, 128, 1, 2, 0),
    (200, 129, 0, 3, 1), (200, 192, 0, 3, 1), (200, 193, 0, 4, 0), (200, 200, 0, 4, 0),
]


def _census(sizes, C, f, **tile):
    return tile_census(torch.tensor(sizes, dtype=torch.int32), C, f, **tile)


@pytest.mark.parametrize("C,g,zero,computed,skipped", HAND,
                         ids=[f"C{c}-g{g}" for c, g, *_ in HAND])
def test_tile_census_by_hand(C, g, zero, computed, skipped):
    assert _census([g], C, 256) == {
        "zero_tiles": zero, "halves_computed": computed, "halves_skipped": skipped}


@pytest.mark.parametrize("f,col_tiles", [(256, 1), (768, 3), (2048, 8), (300, 2), (8, 1)])
def test_tile_census_counts_each_column_tile(f, col_tiles):
    """Bins add up, and every column tile of a row tile counts alike."""
    sizes = [g for C, g, *_ in HAND if C == 640]
    want = {"zero_tiles": 0, "halves_computed": 0, "halves_skipped": 0}
    for C, g, zero, computed, skipped in HAND:
        if C == 640:
            want["zero_tiles"] += zero * col_tiles
            want["halves_computed"] += computed * col_tiles
            want["halves_skipped"] += skipped * col_tiles
    assert _census(sizes, 640, f) == want


def test_tile_census_other_tile_width():
    # 128-column tiles: twice the column tiles of 256 at f = 768
    assert _census([1, 0], 128, 768, BN=128) == {
        "zero_tiles": 6, "halves_computed": 6, "halves_skipped": 6}


def test_tile_census_every_half_is_counted_once():
    """Zero tiles hold two halves each; every half of every tile is in one
    of the three counts."""
    C, f = 640, 768
    sizes = torch.randint(0, C + 1, (128,), generator=torch.Generator().manual_seed(3),
                          dtype=torch.int32)
    got = tile_census(sizes, C, f)
    tiles = 128 * (C // 128) * (f // 256)
    assert 2 * got["zero_tiles"] + got["halves_computed"] + got["halves_skipped"] == 2 * tiles


def test_tile_census_defaults_are_the_source_tile():
    """ref.tile_census's default tile is the one the CUDA source compiles."""
    text = kernel.SOURCE.read_text()
    bn = int(re.search(r"constexpr int TMA_BN = (\d+);", text).group(1))
    half = int(re.search(r"constexpr int HALF = (\d+);", text).group(1))
    assert "constexpr int TBM = 2 * HALF;" in text
    params = tile_census.__defaults__
    assert params == (2 * half, bn)


A16 = 1 << 20  # a 16-byte aligned address


@pytest.mark.parametrize("dtype,d,f,pointers,want", [
    (torch.bfloat16, 2048, 768, (A16, A16, A16), "tma"),      # MoE gate/up
    (torch.bfloat16, 768, 2048, (A16, A16, A16), "tma"),      # MoE down
    (torch.bfloat16, 520, 136, (A16, A16, A16), "tma"),       # ragged C and k box
    (torch.bfloat16, 64, 36, (A16, A16, A16), "simt"),        # f % 8 != 0
    (torch.bfloat16, 70, 90, (A16, A16, A16), "simt"),        # d % 8 != 0
    (torch.bfloat16, 35, 17, (A16, A16, A16), "simt"),
    (torch.bfloat16, 0, 64, (A16, A16, A16), "simt"),         # nothing to contract
    (torch.bfloat16, 64, 64, (A16 + 2, A16, A16), "simt"),    # x unaligned
    (torch.bfloat16, 64, 64, (A16, A16 + 8, A16), "simt"),    # w unaligned
    (torch.bfloat16, 64, 64, (A16, A16, A16 + 4), "simt"),    # out unaligned
    (torch.float32, 2048, 2048, (A16, A16, A16), "simt"),     # f32: never TF32
], ids=["gate-up", "down", "ragged", "f36", "d70", "d35", "d0", "x+2", "w+8", "out+4",
        "f32"])
def test_path_from_shapes_and_pointers(dtype, d, f, pointers, want):
    assert kernel.path(dtype, d, f, *pointers) == want
