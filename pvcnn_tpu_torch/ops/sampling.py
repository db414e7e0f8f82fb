"""Furthest point sampling and feature gathering (counterpart of
pvcnn_tpu/ops/sampling.py; its `logits_mask` comes with the Frustum models).

`furthest_point_sample_indices` dispatches by device: a CUDA tensor goes to
kernel K6 (pvcnn_tpu_torch/csrc/fps.cu), a CPU tensor to the plain loop
beside it (`_fps_plain`). Both select in fp32 whatever the input dtype, as
the TPU kernel does (pvcnn_tpu/ops/pallas/fps.py:86): seed index 0,
distances from 1e38, d² = (dx² + dy²) + dz², argmax ties to the lowest
index (torch.argmax returns the first maximum). The indices carry no
gradient; `furthest_point_sample` gathers the coordinates with `take_rows`,
so a gradient flows into the chosen points.
"""

from __future__ import annotations

import torch

from pvcnn_tpu_torch import kernels
from pvcnn_tpu_torch.ops.gather_utils import take_rows

__all__ = ["furthest_point_sample", "furthest_point_sample_indices",
           "gather"]

# K6 holds a cloud in shared memory: 16 points per thread at 1024 threads
_FPS_MAX_POINTS = 16 * 1024


def furthest_point_sample_indices(coords: torch.Tensor, num_samples: int):
    """coords [B, N, 3] -> int32 indices [B, M] of the FPS-selected points."""
    fn = _fps_plain if coords.device.type == "cpu" else _fps_cuda
    return fn(coords.detach(), int(num_samples))


def _fps_plain(coords, m):
    b, n, _ = coords.shape
    x, y, z = coords.float().unbind(-1)
    out = torch.zeros((b, m), dtype=torch.int32, device=coords.device)
    dist = torch.full((b, n), 1e38, dtype=torch.float32, device=coords.device)
    last = torch.zeros((b, 1), dtype=torch.long, device=coords.device)
    for j in range(1, m):
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        last = dist.argmax(dim=1, keepdim=True)
        out[:, j] = last[:, 0]
    return out


def _fps_cuda(coords, m):
    if coords.device.type != "cuda":
        raise ValueError(f"fps kernel needs a CUDA tensor, got {coords.device}")
    if coords.dim() != 3 or coords.shape[2] != 3:
        raise ValueError(f"fps kernel takes [B, N, 3] coords, got "
                         f"{tuple(coords.shape)}")
    b, n, _ = coords.shape
    if not 0 < n <= _FPS_MAX_POINTS:
        raise ValueError(f"fps kernel takes 1 to {_FPS_MAX_POINTS} points a "
                         f"cloud, got {n}")
    coords = coords.float().contiguous()
    out = torch.empty((b, m), dtype=torch.int32, device=coords.device)
    with torch.cuda.device(coords.device):
        kernels.launch("fps", "pvcnn_fps", coords.data_ptr(), out.data_ptr(),
                       b, n, m, torch.cuda.current_stream().cuda_stream)
    return out


def gather(features: torch.Tensor, indices: torch.Tensor):
    """features [B, N, C], indices [B, M] -> [B, M, C]."""
    return take_rows(features, indices)


def furthest_point_sample(coords: torch.Tensor, num_samples: int):
    """coords [B, N, 3] -> [B, M, 3] coords of the FPS centers."""
    return gather(coords, furthest_point_sample_indices(coords, num_samples))
