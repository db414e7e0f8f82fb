"""Ball query and neighborhood grouping (counterpart of
pvcnn_tpu/ops/neighbors.py).

`ball_query` dispatches by device: a CUDA tensor goes to kernel K7
(pvcnn_tpu_torch/csrc/select.cu), a CPU tensor to the plain version beside
it (`_ball_query_plain`). Both answer in fp32 whatever the input dtype, as
the TPU kernel does (pvcnn_tpu/ops/pallas/select.py:100): the first U point
ids in index order with d² < r², where r² is the fp32 rounding of
float(radius) ** 2 and d² = (dx² + dy²) + dz²; slots past the hit count
hold the first hit, or 0 when the center has none (ops/neighbors.py:69-74).
`grouping` is `take_rows`, differentiable in the features.
"""

from __future__ import annotations

import struct

import torch

from pvcnn_tpu_torch import kernels
from pvcnn_tpu_torch.ops.gather_utils import take_rows

__all__ = ["ball_query", "grouping", "sq_dist"]


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
    with torch.cuda.device(centers.device):
        kernels.launch("ball_query", "pvcnn_ball_query", centers.data_ptr(),
                       points.data_ptr(), out.data_ptr(), b, m, n, u, r2,
                       torch.cuda.current_stream().cuda_stream)
    return out


def grouping(features: torch.Tensor, indices: torch.Tensor):
    """features [B, N, C], indices [B, M, U] -> [B, M, U, C]."""
    b, m, u = indices.shape
    return take_rows(features, indices.reshape(b, m * u)).reshape(
        b, m, u, features.shape[-1])
