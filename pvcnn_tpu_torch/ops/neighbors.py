"""Ball query and neighborhood grouping (counterpart of
pvcnn_tpu/ops/neighbors.py).

`ball_query` dispatches by device: a CUDA tensor goes to kernel K7
(pvcnn_tpu_torch/csrc/select.cu, launched by `_ball_query_plan`), a CPU
tensor to the plain version beside it (`_ball_query_plain`). Both answer
in fp32 whatever the input dtype, as the TPU kernel does
(pvcnn_tpu/ops/pallas/select.py:100): the first U point ids in index order
with d² < r², where r² is the fp32 rounding of float(radius) ** 2 and d² =
(dx² + dy²) + dz²; slots past the hit count hold the first hit, or 0 when
the center has none (ops/neighbors.py:69-74).
`grouping` is `take_rows`, differentiable in the features.
"""

from __future__ import annotations

import functools
import math
import struct
from typing import NamedTuple

import torch

from pvcnn_tpu_torch import kernels
from pvcnn_tpu_torch.ops.conv3d import _sm_count
from pvcnn_tpu_torch.ops.gather_utils import take_rows

__all__ = ["ball_query", "grouping", "sq_dist"]

# K7 (csrc/select.cu): points per shared-memory tile (kBqTile) and at most
# _BQ_CENTERS centers per block; it splits a cloud's points over blocks
# until about _BQ_WARPS_PER_SM warps per SM are in flight, no split under
# _BQ_MIN_POINTS points (the fastest of 28 plans at (1024, 8192) on an
# H100 80GB HBM3 at 700 W: 256 centers a block, 2 splits; a thread scans
# its split serially, so small clouds split down to one tile). A block's
# shared memory (2 tiles of float4 points, then U + 2 ints a center,
# csrc/select.cu:pvcnn_ball_query) stays within the _BQ_SMEM bytes an H100
# gives a block; where that holds fewer than 32 centers (U above 1,750),
# the hits go to device memory and only the counts stay in shared memory.
_BQ_TILE, _BQ_CENTERS, _BQ_WARPS_PER_SM, _BQ_MIN_POINTS = 256, 256, 12, 256
_BQ_SMEM = 227 * 1024


def _fp32(x: float) -> float:
    return struct.unpack("f", struct.pack("f", x))[0]


def sq_dist(queries: torch.Tensor, candidates: torch.Tensor):
    """[B, M, 3], [B, N, 3] -> [B, M, N] squared distances in fp32,
    (dx² + dy²) + dz² (the kernels' order)."""
    q = queries.float()
    c = candidates.float()
    dx = q[..., 0, None] - c[:, None, :, 0]
    dy = q[..., 1, None] - c[:, None, :, 1]
    dz = q[..., 2, None] - c[:, None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def ball_query(centers_coords: torch.Tensor, points_coords: torch.Tensor,
               radius: float, num_neighbors: int):
    """centers [B, M, 3], points [B, N, 3] -> [B, M, U] int32 neighbor
    indices into the N points."""
    fn = (_ball_query_plain if centers_coords.device.type == "cpu"
          else _ball_query_cuda)
    return fn(centers_coords.detach(), points_coords.detach(),
              _fp32(float(radius) ** 2), int(num_neighbors))


def _ball_query_plain(centers, points, r2, u):
    n = points.shape[1]
    hit = sq_dist(centers, points) < torch.tensor(r2, dtype=torch.float32)
    ids = torch.arange(n, device=points.device)
    key = torch.where(hit, ids, n)                 # misses sort after hits
    k = min(u, n)
    sel = key.topk(k, dim=-1, largest=False, sorted=True).values
    if k < u:
        sel = torch.nn.functional.pad(sel, (0, u - k), value=n)
    count = hit.sum(dim=-1, keepdim=True)
    first = torch.where(count > 0, sel[..., :1], 0)
    slots = torch.arange(u, device=points.device)
    return torch.where(slots < count, sel, first).to(torch.int32)


class BallQueryPlan(NamedTuple):
    """K7's launch (csrc/select.cu)."""

    threads: int        # centers per block, a multiple of 32
    splits: int         # blocks per center tile, each a run of points
    per_split: int      # points per split, a multiple of _BQ_TILE
    device_hits: bool = False   # hits in device memory, not shared memory

    def scratch_ints(self, b: int, m: int, u: int) -> int:
        """The splits' hits [splits, B, M, U] and counts [splits, B, M]."""
        return self.splits * b * m * (u + 1) if self.splits > 1 else 0


@functools.lru_cache(maxsize=None)
def _ball_query_plan(b, m, n, u, sms) -> BallQueryPlan:
    """K7's launch on a card of `sms` SMs for B clouds of M centers and N
    points: a thread per center, up to _BQ_CENTERS centers of one cloud per
    block (whole warps, fewer where U hits a center would overrun the
    block's shared memory; where not even 32 fit, above U = 1,750, the
    hits go to device memory); where those warps fall short of
    _BQ_WARPS_PER_SM per SM, each cloud's points are split over blocks in
    runs of whole tiles, none shorter than _BQ_MIN_POINTS points nor
    empty."""
    fit = (_BQ_SMEM - 2 * _BQ_TILE * 16) // (4 * (u + 2)) // 32 * 32
    device_hits = fit < 32
    threads = min(_BQ_CENTERS, 32 * math.ceil(m / 32))
    if not device_hits:
        threads = min(threads, fit)
    warps = b * math.ceil(m / threads) * threads // 32
    want = math.ceil(_BQ_WARPS_PER_SM * sms / max(1, warps))
    splits = max(1, min(want, n // _BQ_MIN_POINTS))
    per_split = _BQ_TILE * max(1, math.ceil(n / splits / _BQ_TILE))
    return BallQueryPlan(threads, max(1, math.ceil(n / per_split)),
                         per_split, device_hits)


def _ball_query_cuda(centers, points, r2, u):
    if centers.device.type != "cuda" or points.device != centers.device:
        raise ValueError("ball_query kernel needs centers and points on one "
                         f"CUDA device, got {centers.device} and "
                         f"{points.device}")
    b, m, three = centers.shape
    if three != 3 or points.dim() != 3 or points.shape[0] != b \
            or points.shape[2] != 3:
        raise ValueError(f"ball_query kernel takes [B, M, 3] and [B, N, 3], "
                         f"got {tuple(centers.shape)} and "
                         f"{tuple(points.shape)}")
    n = points.shape[1]
    centers = centers.float().contiguous()
    points = points.float().contiguous()
    out = torch.empty((b, m, u), dtype=torch.int32, device=centers.device)
    if b == 0 or m == 0 or u == 0:
        return out
    plan = _ball_query_plan(b, m, n, u, _sm_count(centers.device.index))
    # the splits' hits and counts, merged by the kernel's second pass
    scratch = (torch.empty(plan.scratch_ints(b, m, u), dtype=torch.int32,
                           device=centers.device)
               if plan.splits > 1 else None)
    with torch.cuda.device(centers.device):
        kernels.launch("ball_query", "pvcnn_ball_query", centers.data_ptr(),
                       points.data_ptr(), out.data_ptr(),
                       None if scratch is None else scratch.data_ptr(), b, m,
                       n, u, r2, *plan,
                       torch.cuda.current_stream().cuda_stream)
    return out


def grouping(features: torch.Tensor, indices: torch.Tensor):
    """features [B, N, C], indices [B, M, U] -> [B, M, U, C]."""
    b, m, u = indices.shape
    return take_rows(features, indices.reshape(b, m * u)).reshape(
        b, m, u, features.shape[-1])
