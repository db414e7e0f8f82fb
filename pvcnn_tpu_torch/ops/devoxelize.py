"""Trilinear devoxelization: per-point trilinear interpolation out of a voxel
grid, and its gradient (counterpart of pvcnn_tpu/ops/devoxelize.py).

`devoxelize_rows` is a torch.autograd.Function whose forward and backward
dispatch by device. Forward: a CUDA tensor goes to kernel K2
(pvcnn_tpu_torch/csrc/devoxelize.cu), a CPU tensor to the plain 8-corner
gather beside it (`_devoxelize_plain`). Backward, the grid gradient: kernel
K5 (csrc/devoxelize_bwd.cu: a counting sort of the N base bins on the card,
`_sort_points`, then a walk of each bin's 8 corner runs), or the plain
8-corner `scatter_add_` (`_devoxelize_bwd_plain`). No gradient flows into
norm_coords, as in the reference.

Edge rule, bit-for-bit with the reference CUDA kernel: coordinates arrive
clamped to [0, R-1]; the hi corner collapses onto lo where the fractional
part is 0, and that corner's weight is then exactly 0.

A bf16 grid (bf16 activations; the rows branch's channel-major grid or the
NDHWC branch's channel-last one) takes K2's and K5's bf16 modes on the
card (counted as trilinear_devoxelize_bf16 and devoxelize_bwd_bf16) and
the plain versions on widened operands on the CPU. Coordinates and weights
stay f32. Forward: f32 weights and sum, the output rounded to bf16 once
(pvcnn_tpu/ops/devoxelize.py:219-231, 250-258). Backward: each weight
rounded to bf16, each term w * g rounded to bf16, the terms summed in f32
and the sum rounded to bf16 (pvcnn_tpu/ops/devoxelize.py:366-395:
w8.astype(g.dtype) * g, the f32 scatter, .astype(g.dtype)). For a bf16
cotangent JAX's sorted Pallas scatter declines at depth 0 (:366-373) and
its corner-packed Pallas scatter or its one-hot `_scatter_sum` take the
terms, both with f32 sums; where no Pallas plan fits, its XLA
`segment_sum`s add the bf16 terms in bf16, rounding every partial sum. The
port sums in f32 and rounds once everywhere, as the channel-major bf16 K5
does. K5 takes one block per (cloud, brick of 512 bins) in both layouts,
and K2 on a channel-major grid; `_brick_plan` picks their chunk of
channels and how many of a brick's points K5 stages in shared memory. On
a channel-last grid K2 gives each point ceil(C / 8) lanes, 8 channels a
lane (the kernel computes that mapping).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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


class BrickPlan(NamedTuple):
    """The bf16 K5 launch (either layout) and the channel-major bf16 K2's:
    `tc` channels a chunk (8, 16 or 32), and K5's `staged` points a brick (the first of the points its
    halo's runs hold, in sort order, whose weights, index and g rows it
    keeps in shared memory; a denser brick reads the rest where they
    lie)."""

    tc: int
    staged: int


# K5's shared memory: ~6.5 KB (the halo's runs, its rows' positions) and
# the chunk's tile of sums (2 * 528 bytes a channel into a channel-major
# grid, 2 * 512 into a channel-last one), then per staged point 16 bytes
# of weights, 4 of index and 2 * tc of g: 1,536 points take 82 KB at tc =
# 16 (two 512-thread blocks an SM), 169 KB at tc = 32 (one); 768 at tc =
# 32 take 105 KB (two). The channel-last tile is the smaller, so one plan
# serves both layouts.
_K5_STAGED, _K5_FEW_STAGED = 1536, 768
_K5_DENSE = 512            # mean points a brick's halo holds from which
                           # tc = 32 stages 1,536


@functools.lru_cache(maxsize=None)
def _brick_plan(n: int, c: int, r: int) -> BrickPlan:
    """The plan for clouds of n points, c channels, an R^3 grid: the
    narrowest chunk of 8, 16 or 32 channels that holds c (32 past 32); K5
    stages 1,536 points, or 768 at 32 channels unless a brick's -1
    halo (17 x 9 x 5 bins where R % 16 == 0, else 9^3, at most R^3) holds
    more than 512 points on average (measured on the card: staging more
    points past that costs a block an SM more than reading them where
    they lie); never more than n (rounded up to 32)."""
    tc = 8 if c <= 8 else 16 if c <= 16 else 32
    halo = min(765 if r % 16 == 0 else 729, r ** 3)
    mean = n * halo / r ** 3
    room = (_K5_STAGED if tc < 32 or mean > _K5_DENSE else _K5_FEW_STAGED)
    return BrickPlan(tc, min(-(-n // 32) * 32, room))


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
    if grid.dtype == torch.bfloat16:           # f32 sum, rounded once
        return _devoxelize_plain(grid.float(), norm_coords, resolution,
                                 channels_first).to(grid.dtype)
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
    bf16 = grid.dtype == torch.bfloat16
    if (grid.dtype not in (torch.float32, torch.bfloat16)
            or norm_coords.dtype != torch.float32):
        raise ValueError(
            "trilinear_devoxelize kernel takes a float32 grid and "
            "norm_coords (trilinear_devoxelize), or a bfloat16 grid with "
            f"float32 norm_coords (trilinear_devoxelize_bf16), got "
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
    out = torch.empty((b, n, c), dtype=grid.dtype, device=grid.device)
    context, stream = kernels.launch_on(grid.device)
    with context:
        if bf16:
            # channel-major: a block a brick (the plan's chunk of channels);
            # channel-last: lanes over 8-channel groups (tc unused)
            kernels.launch(
                "trilinear_devoxelize_bf16", "pvcnn_trilinear_devoxelize_bf16",
                grid.data_ptr(), norm_coords.data_ptr(), out.data_ptr(), b,
                n, c, r, int(channels_first), _brick_plan(n, c, r).tc,
                stream)
        else:
            # the kernel maps a channel-major grid and a channel-last one
            # differently
            kernels.launch(
                "trilinear_devoxelize", "pvcnn_trilinear_devoxelize",
                grid.data_ptr(), norm_coords.data_ptr(), out.data_ptr(), b,
                n, c, r, int(channels_first), stream)
    return out


def _devoxelize_bwd_plain(g, norm_coords, resolution, channels_first):
    """g [B, N, C] -> grid gradient in the grid's layout: each point's
    cotangent times its corner weight, summed into the 8 corner bins."""
    r = int(resolution)
    b, n, c = g.shape
    idx8, w8 = _corners(norm_coords.detach(), r)
    bf16 = g.dtype == torch.bfloat16
    rows = g.new_zeros((b, r ** 3, c), dtype=torch.float32 if bf16 else None)
    for k in range(8):
        if bf16:       # bf16 weight, bf16 term, f32 sum
            term = (w8[..., k, None].to(g.dtype) * g).float()
        else:
            term = w8[..., k, None] * g
        rows.scatter_add_(1, idx8[..., k, None].expand(-1, -1, c), term)
    rows = rows.to(g.dtype)
    return rows.transpose(1, 2).contiguous() if channels_first else rows


def _devoxelize_bwd_cuda(g, norm_coords, resolution, channels_first):
    r = int(resolution)
    if g.device.type != "cuda" or norm_coords.device != g.device:
        raise ValueError("devoxelize_bwd kernel needs g and norm_coords on "
                         f"one CUDA device, got {g.device} and "
                         f"{norm_coords.device}")
    if (g.dtype not in (torch.float32, torch.bfloat16)
            or norm_coords.dtype != torch.float32):
        raise ValueError(
            "devoxelize_bwd kernel takes a float32 g and norm_coords "
            "(devoxelize_bwd), or a bfloat16 g with float32 norm_coords "
            f"(devoxelize_bwd_bf16), got {g.dtype} and {norm_coords.dtype}")
    b, n, c = g.shape
    if tuple(norm_coords.shape) != (b, n, 3):
        raise ValueError(f"g {tuple(g.shape)} and norm_coords "
                         f"{tuple(norm_coords.shape)} do not match")
    points, bounds = _sort_points(norm_coords.detach().contiguous(), r)
    return _launch_k5_sorted(g.contiguous(), points, bounds, r,
                             channels_first)


def _sort_points(norm_coords, r):
    """K5's glue, on the card: a stable per-cloud counting sort of the points
    by base bin (the clamped lo corner). -> (points [B, N, 4] float32: x, y,
    z and the point's index as int32 bits, in bin order; bounds [B, R^3 + 1]
    int32: base bin u's run is points[bounds[u]:bounds[u + 1]])."""
    b, n, _ = norm_coords.shape
    points = torch.empty((b, n, 4), dtype=torch.float32,
                         device=norm_coords.device)
    bounds = torch.empty((b, r ** 3 + 1), dtype=torch.int32,
                         device=norm_coords.device)
    context, stream = kernels.launch_on(norm_coords.device)
    with context:
        kernels.call("pvcnn_devoxelize_bwd_sort", norm_coords.data_ptr(),
                     points.data_ptr(), bounds.data_ptr(), b, n, r, stream)
    return points, bounds


def _sort_points_plain(norm_coords, r):
    """`_sort_points` in plain torch (the kernel's oracle): the same
    clamped base bins, a stable sort, and the runs' bounds from counts."""
    b, n, _ = norm_coords.shape
    lo = torch.floor(norm_coords).to(torch.int32).clamp(0, r - 1)
    base = (lo[..., 0] * r + lo[..., 1]) * r + lo[..., 2]
    _, perm = torch.sort(base, dim=1, stable=True)
    index = torch.arange(n, dtype=torch.int32, device=norm_coords.device)
    points = torch.cat([norm_coords, index.view(torch.float32).expand(
        b, n)[..., None]], dim=2)
    points = torch.gather(points, 1, perm[..., None].expand(-1, -1, 4))
    counts = torch.zeros((b, r ** 3 + 1), dtype=torch.int32,
                         device=norm_coords.device)
    counts.scatter_add_(1, base.long() + 1, torch.ones_like(base))
    return points, counts.cumsum(dim=1, dtype=torch.int32)


def _launch_k5_sorted(g, points, bounds, r, channels_first):
    """K5 alone on a contiguous float32 or bfloat16 g [B, N, C] and
    `_sort_points`' output: the grid gradient [B, C, R^3] with
    channels_first, else [B, R^3, C] (fp32: the walk maps the two layouts
    differently; bf16: the brick kernel, one plan for both)."""
    b, n, c = g.shape
    bins = r ** 3
    out = torch.empty((b, c, bins) if channels_first else (b, bins, c),
                      dtype=g.dtype, device=g.device)
    context, stream = kernels.launch_on(g.device)
    with context:
        if g.dtype == torch.bfloat16:
            plan = _brick_plan(n, c, r)
            kernels.launch(
                "devoxelize_bwd_bf16", "pvcnn_devoxelize_bwd_bf16",
                g.data_ptr(), points.data_ptr(), bounds.data_ptr(),
                out.data_ptr(), b, n, c, r, int(channels_first), plan.tc,
                plan.staged, stream)
        else:
            kernels.launch(
                "devoxelize_bwd", "pvcnn_devoxelize_bwd", g.data_ptr(),
                points.data_ptr(), bounds.data_ptr(), out.data_ptr(), b, n,
                c, r, int(channels_first), stream)
    return out


def trilinear_devoxelize(grid: torch.Tensor, norm_coords: torch.Tensor,
                         resolution: int):
    """grid [B, R, R, R, C], norm_coords [B, N, 3] (from normalize_coords;
    no gradient flows into them) -> [B, N, C] per-point features."""
    b, r = grid.shape[0], int(resolution)
    return devoxelize_rows(grid.reshape(b, r ** 3, grid.shape[-1]),
                           norm_coords, r)
