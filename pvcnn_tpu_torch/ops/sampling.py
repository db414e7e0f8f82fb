"""Furthest point sampling and feature gathering (counterpart of
pvcnn_tpu/ops/sampling.py; its `logits_mask` comes with the Frustum models).

`furthest_point_sample_indices` dispatches by device: a CUDA tensor goes to
kernel K6 (pvcnn_tpu_torch/csrc/fps.cu: any cloud size, launched as
`_fps_plan` says), a CPU tensor to the plain loop beside it (`_fps_plain`).
Both select in fp32 whatever the input dtype, as the TPU kernel does
(pvcnn_tpu/ops/pallas/fps.py:86): seed index 0, distances from 1e38,
d² = (dx² + dy²) + dz², argmax ties to the lowest index (torch.argmax
returns the first maximum). The indices carry no gradient;
`furthest_point_sample` gathers the coordinates with `take_rows`, so a
gradient flows into the chosen points.
"""

from __future__ import annotations

import torch

from pvcnn_tpu_torch import kernels
from pvcnn_tpu_torch.ops.gather_utils import take_rows

__all__ = ["furthest_point_sample", "furthest_point_sample_indices",
           "gather"]


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


def _fps_plan(n):
    """K6's launch for clouds of n points: (cluster, threads, ppt) = blocks
    per cloud (a thread-block cluster), threads per block, points per
    thread in registers, or ppt = 0 to stream the points from global memory.
    The fastest measured at each size (`k1_k6_cases.py --sweep` on an H100
    at B = 32): one block up to 8,192 points (a cluster's barrier costs more
    a step than the work it splits), two blocks to 16,384, above that eight
    blocks that stream the points."""
    for cluster, threads, ppt in _FPS_PLANS:
        if cluster * threads * ppt >= n:
            return cluster, threads, ppt
    return 8, 512, 0


# (cluster, threads, ppt) by capacity, the first that holds the cloud
_FPS_PLANS = ((1, 32, 2), (1, 64, 4), (1, 128, 8), (1, 512, 16),
              (2, 512, 16))


def _fps_cuda(coords, m, plan=None, chain_only=False):
    """K6 on the card. plan: (cluster, threads, ppt), else `_fps_plan`'s;
    chain_only: the chain floor's probe (no distance work, the indices mean
    nothing)."""
    if coords.device.type != "cuda":
        raise ValueError(f"fps kernel needs a CUDA tensor, got {coords.device}")
    if coords.dim() != 3 or coords.shape[2] != 3 or coords.shape[1] == 0:
        raise ValueError(f"fps kernel takes [B, N, 3] coords with N > 0, got "
                         f"{tuple(coords.shape)}")
    b, n, _ = coords.shape
    cluster, threads, ppt = plan or _fps_plan(n)
    coords = coords.float().contiguous()
    out = torch.empty((b, m), dtype=torch.int32, device=coords.device)
    dist = (torch.empty((b, n), dtype=torch.float32, device=coords.device)
            if ppt == 0 else None)
    with torch.cuda.device(coords.device):
        args = ("pvcnn_fps", coords.data_ptr(), out.data_ptr(),
                None if dist is None else dist.data_ptr(), b, n, m, cluster,
                threads, ppt, int(chain_only),
                torch.cuda.current_stream().cuda_stream)
        if chain_only:             # the probe computes no FPS: not counted
            kernels.call(*args)
        else:
            kernels.launch("fps", *args)
    return out


def gather(features: torch.Tensor, indices: torch.Tensor):
    """features [B, N, C], indices [B, M] -> [B, M, C]."""
    return take_rows(features, indices)


def furthest_point_sample(coords: torch.Tensor, num_samples: int):
    """coords [B, N, 3] -> [B, M, 3] coords of the FPS centers."""
    return gather(coords, furthest_point_sample_indices(coords, num_samples))
