"""The bf16 K2 / K5 launch plan (`ops/devoxelize.py:_brick_plan`) on the
CPU: its chunks of channels, and K5's staged points against a numpy count
of the points a brick's -1 halo holds in uniform clouds and against the
shared memory of an SM (two 512-thread blocks, or one at 32 channels and
1,536 points), into a channel-major grid and into a channel-last one (at
every K5 call of S3DIS PVCNN's bf16 opt-in step, chip_smoke.py's
CALLS3_ON_BF16, and at the edges)."""

import os
import re

import numpy as np
import pytest

import chip_smoke
from pvcnn_tpu_torch.ops import devoxelize


def _k5_source():
    """K5's shared-memory layout as csrc/devoxelize_bwd.cu and bricks.cuh
    declare it: the channel-major tile's pitch, the channel-last tile's
    bins, the launcher's ceiling on dynamic bytes and the kernel's static
    bytes (a brick's listed bins and their count); and that the launcher
    sizes a staged point at 16 bytes of weights, 4 of index and 2 * tc of
    g."""
    csrc = os.path.join(os.path.dirname(devoxelize.__file__), os.pardir,
                        "csrc")

    def read(name):
        with open(os.path.join(csrc, name)) as f:
            return f.read()

    def one(src, pattern):
        found = re.findall(pattern, src)
        assert len(found) == 1, pattern
        return int(found[0])

    bwd = read("devoxelize_bwd.cu")
    bins = one(read("bricks.cuh"),
               r"static constexpr int kZ = BZ, kY = 8, "
               r"kX = (\d+) / \(8 \* BZ\);")
    assert "static_cast<size_t>(staged) * (16 * (1 + TC / 8) + 4)" in bwd
    assert "__shared__ unsigned short s_bins[Geo::kBins];" in bwd
    assert "__shared__ int s_nbins;" in bwd
    return {"pitch": one(bwd, r"constexpr int kTilePitch = (\d+);"),
            "last_bins": one(bwd, r"kChannelsFirst \? TC \* kTilePitch : "
                             r"(\d+) \* TC;"),
            "max_dynamic": 1024 * one(
                bwd, r"constexpr int kMaxBrickBytes = (\d+) \* 1024;"),
            "static": 2 * bins + 4}


# K5's shared memory (csrc/devoxelize_bwd.cu): the halo's runs and rows'
# positions, the chunk's tile (kTilePitch bf16 a channel into a
# channel-major grid), then per staged point 16 bytes of weights, 4 of
# index and 2 * tc of g
_SRC = _k5_source()
_TILE_PITCH = _SRC["pitch"]
_SM_BYTES = 228 * 1024


def _brick(r):
    """(x, y, z) extent of a brick at R (16 z x 8 y x 4 x where R % 16 ==
    0, else 8^3)."""
    return (4, 8, 16) if r % 16 == 0 else (8, 8, 8)


def _k5_bytes(plan, r, channels_first=True):
    """K5's dynamic shared memory: the head, the chunk's tile ([tc][528]
    channel-major, [512][tc] channel-last) and the staged points."""
    bx, by, bz = _brick(r)
    rows = (bx + 1) * (by + 1)
    head = -(-((2 * rows * (bz + 1) + 2 * rows + 1) * 4) // 16) * 16
    bins = _TILE_PITCH if channels_first else _SRC["last_bins"]
    tile = plan.tc * bins * 2
    return head + tile + plan.staged * (16 + 4 + 2 * plan.tc)


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


# the runtime's reservation of shared memory a block
_RESERVED = 1024
_OPTIN = sorted(c for k, c in chip_smoke.CALLS3_ON_BF16
                if k == "devoxelize_bwd_bf16")


@pytest.mark.parametrize("c,r,n", _OPTIN + [
    (32, 32, 8192), (9, 32, 4096), (130, 8, 256), (256, 8, 64),
    (1, 4, 500), (72, 5, 500), (130, 12, 500), (16, 8, 0)])
def test_brick_plan_channel_last(c, r, n):
    """Into a channel-last grid K5 runs the channel-major plan, with the
    source's channel-last tile ([512][tc]): in either layout the blocks an
    SM the plan promises (two, or one at 32 channels and 1,536 points) fit
    with their static bytes and the runtime's reservation, under the
    launcher's ceiling."""
    plan = devoxelize._brick_plan(n, c, r)
    blocks = 1 if plan.tc == 32 and plan.staged > 768 else 2
    for channels_first in (True, False):
        dynamic = _k5_bytes(plan, r, channels_first)
        assert dynamic <= _SRC["max_dynamic"]
        assert blocks * (dynamic + _SRC["static"] + _RESERVED) <= _SM_BYTES


def test_brick_plan_opt_in_cases():
    """The opt-in step's K5 calls, (64, 32), (64, 16) and (128, 16) at 4,096
    points: 32 channels a chunk; 768 staged points at R = 32 (a halo holds
    96 points on average, two blocks an SM), 1,536 at R = 16 (765, one)."""
    assert _OPTIN == [(64, 16, 4096), (64, 32, 4096), (128, 16, 4096)]
    assert [devoxelize._brick_plan(n, c, r) for c, r, n in _OPTIN] == [
        devoxelize.BrickPlan(32, 1536), devoxelize.BrickPlan(32, 768),
        devoxelize.BrickPlan(32, 1536)]
