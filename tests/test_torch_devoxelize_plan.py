"""The channel-major bf16 K2 / K5 launch plan (`ops/devoxelize.py:
_brick_plan`) on the CPU: its chunks of channels, and K5's staged points
against a numpy count of the points a brick's -1 halo holds in uniform
clouds and against the shared memory of an SM (two 512-thread blocks, or
one at 32 channels and 1,536 points)."""

import numpy as np
import pytest

from pvcnn_tpu_torch.ops import devoxelize

# K5's shared memory (csrc/devoxelize_bwd.cu): the halo's runs and rows'
# positions, the chunk's tile (528 bf16 a channel), then per staged point
# 16 bytes of weights, 4 of index and 2 * tc of g
_TILE_PITCH = 528
_SM_BYTES = 228 * 1024


def _brick(r):
    """(x, y, z) extent of a brick at R (16 z x 8 y x 4 x where R % 16 ==
    0, else 8^3)."""
    return (4, 8, 16) if r % 16 == 0 else (8, 8, 8)


def _k5_bytes(plan, r):
    bx, by, bz = _brick(r)
    rows = (bx + 1) * (by + 1)
    head = -(-((2 * rows * (bz + 1) + 2 * rows + 1) * 4) // 16) * 16
    return (head + plan.tc * _TILE_PITCH * 2
            + plan.staged * (16 + 4 + 2 * plan.tc))


def _halo_counts(points, r):
    """Points of each brick's -1 halo (its base bins o - 1 .. o + extent -
    1 on each axis) of one cloud, counted by numpy."""
    base = np.clip(np.floor(points).astype(int), 0, r - 1)
    hist = np.zeros((r + 1,) * 3, int)
    np.add.at(hist, tuple((base + 1).T), 1)     # bin u at u + 1: -1 is 0
    ext = _brick(r)
    counts = []
    for ox in range(0, r, ext[0]):
        for oy in range(0, r, ext[1]):
            for oz in range(0, r, ext[2]):
                counts.append(hist[ox:ox + ext[0] + 1, oy:oy + ext[1] + 1,
                                   oz:oz + ext[2] + 1].sum())
    return np.array(counts)


@pytest.mark.parametrize("c", [1, 5, 8, 9, 16, 17, 32, 64, 130, 256])
def test_brick_plan_chunks(c):
    """K2 and K5 take the narrowest chunk of 8, 16 or 32 channels that
    holds c (32 past 32)."""
    plan = devoxelize._brick_plan(2048, c, 32)
    assert plan.tc == next(t for t in (8, 16, 32) if t >= min(c, 32))


@pytest.mark.parametrize("n,c,r", [(2048, 64, 32), (2048, 128, 16),
                                   (2048, 16, 32), (2048, 32, 16),
                                   (8192, 32, 32), (1024, 64, 16),
                                   (256, 128, 8), (64, 256, 8),
                                   (4096, 64, 16), (4096, 128, 16),
                                   (4096, 64, 32), (500, 40, 12),
                                   (500, 130, 5), (0, 16, 8)])
def test_brick_plan_staged(n, c, r):
    """K5 stages n points (rounded up to 32) or its room: 1,536, or 768 at
    32 channels where uniform clouds' halos (numpy) hold at most 512
    points on average; a block fits the SM's shared memory twice, or once
    at 32 channels and 1,536 points."""
    plan = devoxelize._brick_plan(n, c, r)
    rng = np.random.default_rng(n + c + r)
    mean = np.mean([_halo_counts(rng.random((n, 3)) * (r - 1), r).mean()
                    for _ in range(4)])
    room = 768 if plan.tc == 32 and mean <= 512 * 0.95 else 1536
    if plan.tc == 32 and abs(mean - 512) > 0.05 * 512:
        assert plan.staged == min(-(-n // 32) * 32, room)
    blocks = 1 if plan.tc == 32 and plan.staged > 768 else 2
    assert blocks * _k5_bytes(plan, r) <= _SM_BYTES
    if plan.tc < 32:
        assert plan.staged == min(-(-n // 32) * 32, 1536)
