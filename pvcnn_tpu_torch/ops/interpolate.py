"""Three-nearest-neighbor inverse-distance interpolation (counterpart of
pvcnn_tpu/ops/interpolate.py).

`three_nn` dispatches by device: a CUDA tensor goes to kernel K8
(pvcnn_tpu_torch/csrc/select.cu), a CPU tensor to the plain version beside
it (`_three_nn_plain`, a stable sort, so ties keep the lower index). Both
select in fp32 whatever the input dtype, as the TPU kernel does
(pvcnn_tpu/ops/pallas/select.py:169), and return the three smallest d²;
with fewer than 3 centers the unfilled slots hold index 0 and d² = inf
(fp32(1e40)). The weights come from those d² with the reference clamps
(1e-10, 1e10) in plain torch on both devices. Gradients flow only into the
center features, through `take_rows`.
"""

from __future__ import annotations

import torch

from pvcnn_tpu_torch import kernels
from pvcnn_tpu_torch.ops.gather_utils import take_rows
from pvcnn_tpu_torch.ops.neighbors import sq_dist

__all__ = ["nearest_neighbor_interpolate", "three_nn"]


def three_nn(points_coords: torch.Tensor, centers_coords: torch.Tensor):
    """[B, N, 3], [B, M, 3] -> (indices [B, N, 3] int32, weights [B, N, 3]
    float32)."""
    fn = (_three_nn_plain if points_coords.device.type == "cpu"
          else _three_nn_cuda)
    idx, d2 = fn(points_coords.detach(), centers_coords.detach())
    return idx, _weights_from_d2(d2)


def _weights_from_d2(best: torch.Tensor):
    """Inverse-distance weights from the squared distances [..., 3]
    (neighbor_interpolate.cu:61-67 clamps)."""
    best = best.clamp(1e-10, 1e10)
    d0, d1, d2 = best.unbind(-1)
    denom = d0 * d1 + d0 * d2 + d1 * d2
    return torch.stack([d1 * d2, d0 * d2, d0 * d1], dim=-1) / denom[..., None]


def _three_nn_plain(points, centers):
    d2 = sq_dist(points, centers)                          # [B, N, M]
    k = min(3, d2.shape[-1])
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if k < 3:
        vals = torch.nn.functional.pad(vals, (0, 3 - k), value=float("inf"))
        idx = torch.nn.functional.pad(idx, (0, 3 - k), value=0)
    return idx.to(torch.int32), vals


def _three_nn_cuda(points, centers):
    if points.device.type != "cuda" or centers.device != points.device:
        raise ValueError("three_nn kernel needs points and centers on one "
                         f"CUDA device, got {points.device} and "
                         f"{centers.device}")
    b, n, three = points.shape
    if three != 3 or centers.dim() != 3 or centers.shape[0] != b \
            or centers.shape[2] != 3:
        raise ValueError(f"three_nn kernel takes [B, N, 3] and [B, M, 3], "
                         f"got {tuple(points.shape)} and "
                         f"{tuple(centers.shape)}")
    m = centers.shape[1]
    points = points.float().contiguous()
    centers = centers.float().contiguous()
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=points.device)
    d2 = torch.empty((b, n, 3), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        kernels.launch("three_nn", "pvcnn_three_nn", points.data_ptr(),
                       centers.data_ptr(), idx.data_ptr(), d2.data_ptr(), b,
                       n, m, torch.cuda.current_stream().cuda_stream)
    return idx, d2


def nearest_neighbor_interpolate(points_coords: torch.Tensor,
                                 centers_coords: torch.Tensor,
                                 centers_features: torch.Tensor):
    """points [B, N, 3], centers [B, M, 3], center features [B, M, C] ->
    [B, N, C] inverse-distance weighted sum of the 3 nearest centers'
    features."""
    idx, w = three_nn(points_coords, centers_coords)
    b, n, _ = idx.shape
    gathered = take_rows(centers_features, idx.reshape(b, n * 3)).reshape(
        b, n, 3, -1)
    return (gathered * w[..., None].to(gathered.dtype)).sum(dim=2)
