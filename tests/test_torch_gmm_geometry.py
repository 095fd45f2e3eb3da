"""PyTorch port, the mixture kernels' launch geometry on the CPU:
``gmm_kernel.mixture_geometry`` against the sizes csrc/gmm_kernel.cu asserts,
its fit in shared memory, and the two walks the kernels make (blocks over
row tiles, consumer threads over a tile's positions), mirrored here, each
covering every row and position once."""

import re
from pathlib import Path

import pytest
import torch

from neural_image_compression_tpu_torch.ops.kernels import gmm_kernel

torch.set_num_threads(1)

SMEM_LIMIT = 232448        # dynamic shared memory one block may use (H100)
SMEM_SM = 233472           # shared memory of an SM, 1 KB of it reserved a block
CONSUMERS = 256            # consumer threads a block

_ASSERT = re.compile(r"static_assert\(same\(geometry\((\d+), (\d+), (false|true)\), "
                     r"Geometry\{(\d+), (\d+), (\d+), (\d+)\}\)")


def _asserted():
    source = (Path(gmm_kernel.__file__).resolve().parents[2] / "csrc" /
              "gmm_kernel.cu").read_text()
    return {(int(k), int(m), b == "true"): tuple(map(int, rest))
            for k, m, b, *rest in _ASSERT.findall(source)}


def test_geometry_mirrors_the_sizes_csrc_asserts():
    asserted = _asserted()
    assert len(asserted) == 12
    for (k, m, backward), want in asserted.items():
        # ten tiles a block: more than the ring's stages, fewer than the 16
        # that take the larger tiles; the ring as csrc asserts it
        geo = gmm_kernel.mixture_geometry(10 * want[0] * 132 * want[3], k, m, backward)
        assert (geo["rows"], geo["stages"], geo["smem"], geo["blocks_per_sm"]) == want


@pytest.mark.parametrize("n", [73_728, 10**7])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("m", [16, 64, 128, 192])
@pytest.mark.parametrize("k", range(1, 9))
def test_geometry_fits_shared_memory(k, m, backward, n):
    geo = gmm_kernel.mixture_geometry(n, k, m, backward)
    streams = 3 * k + (2 if backward else 1)
    stage = geo["rows"] * m * 4 * streams
    # every width a model uses keeps a ring of at least two stages
    assert 2 <= geo["stages"] <= 8
    assert geo["smem"] == 128 + geo["stages"] * stage <= SMEM_LIMIT
    assert geo["blocks_per_sm"] * (geo["smem"] + 1024) <= SMEM_SM
    # rows in fours: every stream's chunk of a tile is a multiple of 16 bytes
    assert geo["rows"] % 4 == 0 and (geo["rows"] * m * 4) % 16 == 0
    # a block keeps at least about 25 KB in flight
    assert geo["stages"] * stage >= 25_000


def test_geometry_of_the_flagship():
    # M = 128, K = 3 at the serve's rows: 35 tiles of 8 rows a block, two
    # stages of 40 KB (forward), two blocks an SM
    fwd = gmm_kernel.mixture_geometry(73_728, 3, 128)
    assert (fwd["rows"], fwd["stages"], fwd["smem"], fwd["blocks_per_sm"]) == (8, 2, 82_048, 2)
    assert (fwd["tiles"], fwd["grid"]) == (9_216, 264)
    # a sweep step's 12,288 rows: tiles of 4 rows, five stages of 20 KB
    sweep = gmm_kernel.mixture_geometry(12_288, 3, 128)
    assert (sweep["rows"], sweep["stages"], sweep["smem"], sweep["grid"]) == (4, 5, 102_528, 264)
    # the train step's 4,096 rows: four tiles a block, so four stages
    bwd = gmm_kernel.mixture_geometry(4_096, 3, 128, backward=True)
    assert (bwd["rows"], bwd["stages"], bwd["tiles"], bwd["grid"]) == (4, 4, 1_024, 264)
    # refinement's 1,536 rows: one tile a block, on four blocks an SM where
    # the registers allow four (the forward's 48 a thread on an H100), each
    # read directly
    ref = gmm_kernel.mixture_geometry(1_536, 3, 128, resident=lambda smem: 4)
    assert (ref["stages"], ref["smem"], ref["blocks_per_sm"], ref["grid"]) == (0, 0, 4, 384)
    assert ref["ring_tiles"] == 0
    # stages that do not fit beside each other: every tile read directly
    assert gmm_kernel.mixture_geometry(100, 8, 2048, True)["stages"] == 0


@pytest.mark.parametrize("n", [1, 5, 700, 1_536, 4_096, 9_999])
@pytest.mark.parametrize("resident", [1, 2, 4, 7])
def test_small_calls_shrink_the_ring(n, resident):
    geo = gmm_kernel.mixture_geometry(n, 3, 128, resident=lambda smem: resident)
    per_block = -(-geo["tiles"] // geo["grid"])
    # never more stages than a block has tiles, nor more blocks than tiles;
    # a block of one tile reads it directly
    assert geo["stages"] == (0 if per_block == 1 else min(5, per_block))
    assert geo["grid"] == min(geo["tiles"], 132 * geo["blocks_per_sm"])
    assert geo["blocks_per_sm"] >= 2
    assert geo["smem"] == (128 + geo["stages"] * 20_480 if geo["stages"] else 0)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("n,k,m,sms", [(1, 3, 128, 132), (3, 3, 128, 132), (4, 3, 128, 132),
                                       (5, 3, 128, 132), (1_535, 3, 128, 132),
                                       (1_536, 3, 128, 132), (4_099, 3, 128, 132),
                                       (73_731, 3, 128, 132), (1_001, 2, 1, 132),
                                       (1_003, 2, 100, 7), (9_999, 8, 16, 3)])
def test_block_walk_covers_every_row_once(n, k, m, sms, backward):
    geo = gmm_kernel.mixture_geometry(n, k, m, backward, sms)
    rows, grid = geo["rows"], geo["grid"]
    seen = torch.zeros(n, dtype=torch.int32)
    for block in range(grid):
        for t in range(block, geo["tiles"], grid):  # block b: tiles b, b + grid, ...
            lo, hi = t * rows, min(n, (t + 1) * rows)
            # the ring (where there is one) takes every whole tile; the
            # ragged one is read directly
            assert (t < geo["ring_tiles"]) == (hi - lo == rows and geo["stages"] > 0)
            seen[lo:hi] += 1
    assert bool((seen == 1).all())
    assert geo["ring_tiles"] == (n // rows if geo["stages"] else 0)
    assert geo["tiles"] == -(-n // rows)


@pytest.mark.parametrize("m", [1, 7, 100, 128, 192, 255, 256, 300, 1000])
def test_consumer_walk_covers_a_tile_once(m):
    # the kernels' walk: (row, column) of thread i from one division, then
    # stepped by (256 // m, 256 % m) with a carry, never divided again
    k = 3
    rows = gmm_kernel.mixture_geometry(64, k, m)["rows"]
    positions = rows * m
    hit = torch.zeros(positions, dtype=torch.int32)
    hit_w = torch.zeros(rows * k * m, dtype=torch.int32)
    dr, dc = CONSUMERS // m, CONSUMERS % m
    for i in range(CONSUMERS):
        r, c = i // m, i % m
        for p in range(i, positions, CONSUMERS):
            assert p == r * m + c and 0 <= c < m
            hit[p] += 1
            e = p + r * (k - 1) * m  # (r, 0, c) of the (rows, K, M) streams
            for j in range(k):
                hit_w[e + j * m] += 1
            r, c = r + dr, c + dc
            if c >= m:
                r, c = r + 1, c - m
    assert bool((hit == 1).all()) and bool((hit_w == 1).all())
