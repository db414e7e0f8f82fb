"""Trilinear devoxelization: per-point trilinear interpolation out of a voxel
grid, and its gradient (counterpart of pvcnn_tpu/ops/devoxelize.py).

`devoxelize_rows` is a torch.autograd.Function whose forward and backward
dispatch by device. Forward: a CUDA tensor goes to kernel K2
(pvcnn_tpu_torch/csrc/devoxelize.cu), a CPU tensor to the plain 8-corner
gather beside it (`_devoxelize_plain`). Backward, the grid gradient: kernel
K5 (csrc/devoxelize_bwd.cu), or the plain 8-corner `scatter_add_`
(`_devoxelize_bwd_plain`). No gradient flows into norm_coords, as in the
reference.

Edge rule, bit-for-bit with the reference CUDA kernel: coordinates arrive
clamped to [0, R-1]; the hi corner collapses onto lo where the fractional
part is 0, and that corner's weight is then exactly 0.
"""

from __future__ import annotations

import torch

from pvcnn_tpu_torch import kernels

__all__ = ["corner_base_bins", "devoxelize_rows", "trilinear_devoxelize"]


def _corners(norm_coords: torch.Tensor, r: int):
    """[B, N, 3] -> (idx8 [B, N, 8] int64 flat indices, w8 [B, N, 8]
    weights), corner order 000, 001, ..., 111 (x, y, z bits)."""
    lo_f = torch.floor(norm_coords)
    frac = norm_coords - lo_f
    lo = lo_f.long()
    hi = lo + (frac > 0).long()
    x0, y0, z0 = lo.unbind(-1)
    x1, y1, z1 = hi.unbind(-1)
    fx, fy, fz = frac.unbind(-1)
    gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    r2 = r * r
    idx8 = torch.stack([
        x0 * r2 + y0 * r + z0, x0 * r2 + y0 * r + z1,
        x0 * r2 + y1 * r + z0, x0 * r2 + y1 * r + z1,
        x1 * r2 + y0 * r + z0, x1 * r2 + y0 * r + z1,
        x1 * r2 + y1 * r + z0, x1 * r2 + y1 * r + z1,
    ], dim=2)
    w8 = torch.stack([
        gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
        fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz,
    ], dim=2)
    return idx8, w8


def corner_base_bins(norm_coords: torch.Tensor, r: int):
    """[B, N, 3] -> [B, N] int32 flat base-corner bin (`_corners`' slot 0)."""
    lo = torch.floor(norm_coords).to(torch.int32)
    return lo[..., 0] * (r * r) + lo[..., 1] * r + lo[..., 2]


def devoxelize_rows(grid: torch.Tensor, norm_coords: torch.Tensor,
                    resolution: int, channels_first: bool = False):
    """grid [B, R^3, C] (or [B, C, R^3] with channels_first, the PVConv
    voxel branch's layout), norm_coords [B, N, 3] in [0, R-1] ->
    [B, N, C] trilinear interpolation. Differentiable in grid."""
    return _DevoxelizeRows.apply(grid, norm_coords, int(resolution),
                                 bool(channels_first))


class _DevoxelizeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, norm_coords, resolution, channels_first):
        fwd = (_devoxelize_plain if grid.device.type == "cpu"
               else _devoxelize_cuda)
        ctx.resolution = resolution
        ctx.channels_first = channels_first
        ctx.save_for_backward(norm_coords)
        return fwd(grid, norm_coords, resolution, channels_first)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (norm_coords,) = ctx.saved_tensors
        bwd = (_devoxelize_bwd_plain if g.device.type == "cpu"
               else _devoxelize_bwd_cuda)
        return (bwd(g, norm_coords, ctx.resolution, ctx.channels_first),
                None, None, None)


def _devoxelize_plain(grid, norm_coords, resolution, channels_first):
    r = int(resolution)
    b, n, _ = norm_coords.shape
    rows = grid.transpose(1, 2) if channels_first else grid      # [B, R^3, C]
    c = rows.shape[2]
    idx8, w8 = _corners(norm_coords.detach(), r)
    out = rows.new_zeros((b, n, c))
    for k in range(8):
        corner = torch.gather(rows, 1, idx8[..., k, None].expand(-1, -1, c))
        out = out + w8[..., k, None] * corner
    return out


def _devoxelize_cuda(grid, norm_coords, resolution, channels_first):
    r = int(resolution)
    if grid.device.type != "cuda" or norm_coords.device != grid.device:
        raise ValueError("trilinear_devoxelize kernel needs grid and "
                         "norm_coords on one CUDA device, got "
                         f"{grid.device} and {norm_coords.device}")
    if grid.dtype != torch.float32 or norm_coords.dtype != torch.float32:
        raise ValueError("trilinear_devoxelize kernel takes float32, got "
                         f"{grid.dtype} and {norm_coords.dtype}")
    b, n, three = norm_coords.shape
    if channels_first:
        bg, c, bins = grid.shape
    else:
        bg, bins, c = grid.shape
    if three != 3 or bg != b or bins != r ** 3:
        raise ValueError(f"grid {tuple(grid.shape)} and norm_coords "
                         f"{tuple(norm_coords.shape)} do not match R={r}")
    grid = grid.contiguous()
    norm_coords = norm_coords.detach().contiguous()
    out = torch.empty((b, n, c), dtype=torch.float32, device=grid.device)
    # the kernel maps a channel-major grid and a channel-last one differently
    with torch.cuda.device(grid.device):
        kernels.launch(
            "trilinear_devoxelize", "pvcnn_trilinear_devoxelize",
            grid.data_ptr(), norm_coords.data_ptr(), out.data_ptr(), b, n, c,
            r, int(channels_first), torch.cuda.current_stream().cuda_stream)
    return out


def _devoxelize_bwd_plain(g, norm_coords, resolution, channels_first):
    """g [B, N, C] -> grid gradient in the grid's layout: each point's
    cotangent times its corner weight, summed into the 8 corner bins."""
    r = int(resolution)
    b, n, c = g.shape
    idx8, w8 = _corners(norm_coords.detach(), r)
    rows = g.new_zeros((b, r ** 3, c))
    for k in range(8):
        rows.scatter_add_(1, idx8[..., k, None].expand(-1, -1, c),
                          w8[..., k, None] * g)
    return rows.transpose(1, 2).contiguous() if channels_first else rows


def _devoxelize_bwd_cuda(g, norm_coords, resolution, channels_first):
    r = int(resolution)
    if g.device.type != "cuda" or norm_coords.device != g.device:
        raise ValueError("devoxelize_bwd kernel needs g and norm_coords on "
                         f"one CUDA device, got {g.device} and "
                         f"{norm_coords.device}")
    if g.dtype != torch.float32 or norm_coords.dtype != torch.float32:
        raise ValueError("devoxelize_bwd kernel takes float32, got "
                         f"{g.dtype} and {norm_coords.dtype}")
    b, n, c = g.shape
    if tuple(norm_coords.shape) != (b, n, 3):
        raise ValueError(f"g {tuple(g.shape)} and norm_coords "
                         f"{tuple(norm_coords.shape)} do not match")
    bins = r ** 3
    g = g.contiguous()
    # glue: the forward's corners and weights, and a stable per-cloud sort
    # of the 8N corner bins that fixes each bin's summation order
    idx8, w8 = _corners(norm_coords.detach(), r)
    sorted_bin, perm = torch.sort(idx8.reshape(b, 8 * n).to(torch.int32),
                                  dim=1, stable=True)
    w8 = w8.reshape(b, 8 * n).contiguous()
    out = torch.empty((b, c, bins) if channels_first else (b, bins, c),
                      dtype=torch.float32, device=g.device)
    stride_v, stride_c = (1, bins) if channels_first else (c, 1)
    with torch.cuda.device(g.device):
        kernels.launch(
            "devoxelize_bwd", "pvcnn_devoxelize_bwd", g.data_ptr(),
            sorted_bin.data_ptr(), perm.data_ptr(), w8.data_ptr(),
            out.data_ptr(), b, n, c, bins, stride_v, stride_c,
            torch.cuda.current_stream().cuda_stream)
    return out


def trilinear_devoxelize(grid: torch.Tensor, norm_coords: torch.Tensor,
                         resolution: int):
    """grid [B, R, R, R, C], norm_coords [B, N, 3] (from normalize_coords;
    no gradient flows into them) -> [B, N, C] per-point features."""
    b, r = grid.shape[0], int(resolution)
    return devoxelize_rows(grid.reshape(b, r ** 3, grid.shape[-1]),
                           norm_coords, r)
