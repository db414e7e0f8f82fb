"""Furthest point sampling, feature gathering and the Frustum models'
foreground sampler (counterpart of pvcnn_tpu/ops/sampling.py).

`furthest_point_sample_indices` dispatches by device: a CUDA tensor goes to
kernel K6 (pvcnn_tpu_torch/csrc/fps.cu: any cloud size, launched as
`_fps_plan` says), a CPU tensor to the plain loop beside it (`_fps_plain`).
Both select in fp32 whatever the input dtype, as the TPU kernel does
(pvcnn_tpu/ops/pallas/fps.py:86): seed index 0, distances from 1e38,
d² = (dx² + dy²) + dz², argmax ties to the lowest index (torch.argmax
returns the first maximum). The indices carry no gradient;
`furthest_point_sample` gathers the coordinates with `take_rows`, so a
gradient flows into the chosen points.

`logits_mask` keeps M foreground points a cloud, as the JAX package's
on-device sampler does: a random permutation of the candidates (a sort of
uniform keys, candidates first) walked cyclically. It runs on the tensors'
device with no host sync, so the same code serves the CPU and the card.
"""

from __future__ import annotations

import torch

from pvcnn_tpu_torch import kernels
from pvcnn_tpu_torch.ops.gather_utils import take_rows

__all__ = ["furthest_point_sample", "furthest_point_sample_indices",
           "gather", "logits_mask", "logits_mask_indices"]


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


def logits_mask(coords: torch.Tensor, logits: torch.Tensor,
                num_points_per_object: int,
                generator: torch.Generator | None = None):
    """Foreground resampling from binary segmentation logits.

    coords [B, N, 3], logits [B, N, 2] -> (selected [B, M, 3] foreground
    coords minus their mean, mean [B, 3] of the foreground coords, mask
    [B, N] bool with logits[..., 0] < logits[..., 1]). The mean divides by
    max(count, 1); the M indices come from `logits_mask_indices`, looked up
    at call time, with draws from `generator` (a torch.Generator on the
    tensors' device; None: torch's default one)."""
    m = int(num_points_per_object)
    mask = logits[..., 0] < logits[..., 1]
    maskf = mask.to(coords.dtype)
    count = mask.sum(dim=-1)
    masked = coords * maskf[..., None]
    mean = masked.sum(dim=1) / count.clamp(min=1).to(coords.dtype)[:, None]
    idx = logits_mask_indices(mask, m, generator)
    return gather(masked - mean[:, None, :], idx), mean, mask


def logits_mask_indices(mask: torch.Tensor, m: int,
                        generator: torch.Generator | None = None):
    """The index selection of `logits_mask`: [B, N] bool -> [B, M] int32.

    Each point draws u uniform in [0, 1), a non-candidate u + 2, so the
    sorted keys list the candidates first in random order; slot j takes
    the (j mod max(count, 1))-th of them. With count >= M that is a uniform
    M-subset without replacement; with 0 < count < M each candidate is
    taken floor(M / count) or floor(M / count) + 1 times, the reference's
    repeat-and-shuffle law (pvcnn_tpu/ops/sampling.py:logits_mask_indices);
    with count = 0 every slot takes the first of a random order of all
    points."""
    b, n = mask.shape
    u = torch.rand((b, n), generator=generator, device=mask.device)
    key = torch.where(mask, u, u + 2.0)
    order = torch.argsort(key, dim=-1, stable=True)
    count = mask.sum(dim=-1, keepdim=True).clamp(min=1)
    j = torch.arange(m, device=mask.device)[None, :] % count
    return torch.gather(order, 1, j).to(torch.int32)
