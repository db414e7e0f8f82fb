"""Average voxelization: coordinate normalization and the scatter-mean of point
features into a dense R^3 grid (counterpart of pvcnn_tpu/ops/voxelize.py).

`scatter_mean` is a torch.autograd.Function. Its forward dispatches by
device: a CUDA tensor goes to kernel K1 (pvcnn_tpu_torch/csrc/voxelize.cu), a
CPU tensor to the plain PyTorch version beside it (`_scatter_mean_plain`).
Both are deterministic: the kernel sums each bin in point order after a
stable sort, the plain version with `scatter_add_` on the CPU. Its backward
gathers each point's bin gradient divided by the bin's count, in plain torch
on both devices (an XLA gather in the JAX package, take_rows, not a Pallas
kernel).

`scatter_sum` is the same per-bin sum without the divide (K1's sum mode,
counted as the `scatter_sum` kernel; plain: `scatter_add_`): the backward of
the row gather `take_rows` (ops/gather_utils.py), as pvcnn_tpu/ops/voxelize.py:
_scatter_sum is in the JAX package.

bf16 values (bf16 activations): the mean, into the rows branch's
channel-major grid or the NDHWC branch's channel-last one, is K1's bf16
mode on the card (counted as `avg_voxelize_bf16`), the plain version on
the values widened to f32 on the CPU. The sums and the divide
are f32 and the means are rounded to bf16 once (pvcnn_tpu/ops/voxelize.py:
122-139: the f32 one-hot sums, means.astype(features.dtype)). The backward
divides by the counts cast to the cotangent's dtype, as the JAX package's
(counts above 256 are not exact in bf16) and rounds there. `scatter_sum`
of bf16 values (a bf16 cotangent of take_rows) is K1's bf16 sum mode on
the card (counted as `scatter_sum_bf16`), on the CPU `scatter_add_` on
the values widened to f32: f32 sums rounded to bf16 once, as the JAX
package's one-hot kernel sums and take_rows rounds
(pvcnn_tpu/ops/gather_utils.py:49).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from pvcnn_tpu_torch import kernels
from pvcnn_tpu_torch.ops.conv3d import _sm_count

__all__ = ["avg_voxelize", "flat_voxel_index", "normalize_coords",
           "scatter_mean", "scatter_sum"]


def normalize_coords(coords: torch.Tensor, resolution: int,
                     normalize: bool = True, eps: float = 0.0):
    """Reference Voxelization coordinate normalization.

    coords [B, N, 3] (detached, like the reference) ->
    (vox_coords [B, N, 3] int32 in [0, R-1], norm_coords [B, N, 3] float in
    [0, R-1]). Rounding is half to even, as in jnp.round."""
    coords = coords.detach()
    centered = coords - coords.mean(dim=1, keepdim=True)
    if normalize:
        max_norm = centered.norm(dim=-1, keepdim=True).amax(dim=1,
                                                            keepdim=True)
        norm_coords = centered / (max_norm * 2.0 + eps) + 0.5
    else:
        norm_coords = (centered + 1.0) / 2.0
    r = int(resolution)
    norm_coords = torch.clamp(norm_coords * r, 0.0, r - 1.0)
    vox_coords = torch.round(norm_coords).to(torch.int32)
    return vox_coords, norm_coords


def flat_voxel_index(vox_coords: torch.Tensor, resolution: int):
    """[B, N, 3] integer voxel coords -> [B, N] int32 flat index
    x * R^2 + y * R + z."""
    r = int(resolution)
    v = vox_coords.to(torch.int32)
    return v[..., 0] * (r * r) + v[..., 1] * r + v[..., 2]


def scatter_mean(features: torch.Tensor, flat_idx: torch.Tensor,
                 num_bins: int, channels_first: bool = False):
    """Per-cloud mean of the feature rows that share a bin.

    features [B, N, C] float, flat_idx [B, N] int in [0, num_bins) ->
    [B, num_bins, C], or [B, C, num_bins] with channels_first (the layout the
    conv consumes). Empty bins are 0. Differentiable in features."""
    return _ScatterMean.apply(features, flat_idx, int(num_bins),
                              bool(channels_first))


class _ScatterMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, flat_idx, num_bins, channels_first):
        if features.device.type == "cpu":
            out = _scatter_mean_plain(features, flat_idx, num_bins,
                                      channels_first)
            bounds = None
        else:
            out, bounds = _scatter_mean_cuda(features, flat_idx, num_bins,
                                             channels_first)
        ctx.channels_first = channels_first
        if ctx.needs_input_grad[0]:
            # on the card, the differences of the sort's run bounds
            counts = (_counts(flat_idx, num_bins) if bounds is None
                      else bounds[:, 1:] - bounds[:, :-1])
            ctx.save_for_backward(flat_idx, counts)
        return out

    @staticmethod
    def backward(ctx, g):
        flat_idx, counts = ctx.saved_tensors
        idx = flat_idx.long()
        # g[b, bin(n)] / max(count, 1) at each point
        denom = torch.gather(counts, 1, idx).clamp(min=1).to(g.dtype)
        if ctx.channels_first:                     # g [B, C, bins]
            rows = torch.gather(g, 2, idx[:, None, :].expand(-1, g.shape[1],
                                                             -1))
            rows = rows.transpose(1, 2)
        else:                                      # g [B, bins, C]
            rows = torch.gather(g, 1, idx[..., None].expand(-1, -1,
                                                            g.shape[2]))
        return rows / denom[..., None], None, None, None


def _counts(flat_idx, num_bins):
    """[B, N] bin ids -> [B, num_bins] int64 points per bin."""
    b = flat_idx.shape[0]
    offset = torch.arange(b, device=flat_idx.device)[:, None] * num_bins
    return torch.bincount((flat_idx.long() + offset).reshape(-1),
                          minlength=b * num_bins).reshape(b, num_bins)


def _scatter_mean_plain(features, flat_idx, num_bins, channels_first):
    if features.dtype == torch.bfloat16:       # f32 sums, rounded once
        return _scatter_mean_plain(features.float(), flat_idx, num_bins,
                                   channels_first).to(features.dtype)
    b, n, c = features.shape
    idx = flat_idx.long()
    sums = features.new_zeros((b, num_bins, c)).scatter_add_(
        1, idx[..., None].expand(-1, -1, c), features)
    counts = features.new_zeros((b, num_bins)).scatter_add_(
        1, idx, features.new_ones((b, n)))
    means = sums / torch.clamp(counts, min=1.0)[..., None]
    return means.transpose(1, 2).contiguous() if channels_first else means


def _scatter_mean_cuda(features, flat_idx, num_bins, channels_first):
    """K1 on the card -> (the means, the sort's run bounds [B, bins + 1])."""
    kernel = ("avg_voxelize_bf16" if features.dtype == torch.bfloat16
              else "avg_voxelize")
    return _launch_k1(kernel, features, flat_idx, num_bins, channels_first,
                      mean=True)


def scatter_sum(values: torch.Tensor, idx: torch.Tensor, num_bins: int):
    """Per-cloud sum of the rows that share a bin: values [B, K, C], idx
    [B, K] int in [0, num_bins) -> [B, num_bins, C] of values' dtype;
    empty bins are 0. bf16 values are summed in f32 and rounded once."""
    fn = _scatter_sum_plain if values.device.type == "cpu" else \
        _scatter_sum_cuda
    return fn(values, idx, int(num_bins))


def _scatter_sum_plain(values, idx, num_bins):
    if values.dtype == torch.bfloat16:         # f32 sums, rounded once
        return _scatter_sum_plain(values.float(), idx,
                                  num_bins).to(values.dtype)
    b, _, c = values.shape
    return values.new_zeros((b, num_bins, c)).scatter_add_(
        1, idx.long()[..., None].expand(-1, -1, c), values)


def _scatter_sum_cuda(values, idx, num_bins):
    kernel = ("scatter_sum_bf16" if values.dtype == torch.bfloat16
              else "scatter_sum")
    return _launch_k1(kernel, values, idx.to(torch.int32), num_bins,
                      False, mean=False)[0]


def _launch_k1(kernel, features, flat_idx, num_bins, channels_first, mean):
    if features.device.type != "cuda" or flat_idx.device != features.device:
        raise ValueError(f"{kernel} kernel needs values and indices on one "
                         f"CUDA device, got {features.device} and "
                         f"{flat_idx.device}")
    dtype = (torch.bfloat16 if kernel.endswith("_bf16")
             else torch.float32)
    if features.dtype != dtype or features.dim() != 3:
        raise ValueError(f"{kernel} kernel takes {dtype} [B, N, C] values, "
                         f"got {features.dtype} {tuple(features.shape)} "
                         "(avg_voxelize and scatter_sum take float32, "
                         "avg_voxelize_bf16 and scatter_sum_bf16 "
                         "bfloat16)")
    b, n, c = features.shape
    if flat_idx.shape != (b, n) or flat_idx.dtype != torch.int32:
        raise ValueError(f"{kernel} indices must be int32 [{b}, {n}], got "
                         f"{flat_idx.dtype} {tuple(flat_idx.shape)}")
    ids = flat_idx.contiguous()
    perm, bounds, hist = _sort_buffers(ids, num_bins)
    out = _launch_k1_sorted(kernel, features.contiguous(), perm, bounds,
                            num_bins, channels_first, mean, ids=ids,
                            hist=hist)
    return out, bounds


# K1's sort split over several blocks a cloud only where the points
# outnumber twice the bins and make two chunks of at least this many
# (else one block a cloud: the counts the split writes and scans, B x
# blocks x bins ints, would cost more than the placement it shares out)
_SORT_MIN_POINTS = 2048
# the shared-memory counters of csrc/counting_sort.cuh (kMaxSharedCounts)
_SORT_SHARED_BYTES = 200 * 1024
# K1's bf16 sum mode: runs longer than this many rows are cut into pieces
# of it, walked side by side (csrc/voxelize.cu:
# avg_voxelize_long_runs_kernel)
_LONG_RUN = 64


class SortPlan(NamedTuple):
    """K1's sort and bin walk for B clouds of N ids into `bins` bins."""

    parts: int          # blocks a cloud (1: avg_voxelize_sort_kernel)
    shared: bool        # counters in shared memory (else global)
    long_run: int       # bf16 sums: runs of more rows are cut into pieces


@functools.lru_cache(maxsize=None)
def _sort_plan(b, n, bins, sms) -> SortPlan:
    """The blocks a cloud of the sort on a card of `sms` SMs: as many as
    one wave of B x parts blocks holds (one block of 1,024 threads an SM),
    each a chunk of at least _SORT_MIN_POINTS points, where n >= 2 x bins;
    else one. (On an H100 at B = 32, 4 blocks a cloud sorted PVCNN2's
    32,768 ids into 8,192 bins in 0.066 ms at 3 and 0.087 at 5, two waves;
    split 2 ways, 8,192 ids into 32,768 bins took 0.211 against 0.040.)
    The bf16 sum mode cuts runs past _LONG_RUN rows where a cloud's mean
    run is that long (FP1's 384 rows into one bin: 0.159 -> 0.081 ms), and
    none elsewhere: cut among short runs, MSG's runs of up to 201 rows in
    (8,192, 512, 320) took 0.245 ms against 0.130 uncut."""
    parts = 1
    if n >= 2 * bins and n >= 2 * _SORT_MIN_POINTS:
        parts = max(1, min(sms // max(b, 1), n // _SORT_MIN_POINTS))
    return SortPlan(parts, (bins + 1) * 4 <= _SORT_SHARED_BYTES,
                    _LONG_RUN if n >= _LONG_RUN * bins else 0)


def _sort_chunks(n, parts):
    """The points [first, end) of each of a cloud's `parts` blocks, as the
    sort kernels cut them (csrc/voxelize.cu: chunk_at)."""
    return [(n * p // parts, n * (p + 1) // parts) for p in range(parts)]


def _cut_runs(count, long_run):
    """The pieces [first, end) of a run of `count` rows that K1's bf16
    mode walks side by side: the run itself where it has long_run rows or
    fewer (or long_run is 0), else pieces of long_run rows in order."""
    if not long_run or count <= long_run:
        return [(0, count)]
    return [(i, min(count, i + long_run)) for i in range(0, count, long_run)]


def _sort_buffers(ids, num_bins):
    """The sort's outputs for ids [B, N]: perm [B, N], bounds [B, bins + 1]
    and, where the plan splits a cloud over blocks, their counts [B, parts,
    bins] (else None)."""
    b, n = ids.shape
    dev = ids.device
    plan = _sort_plan(b, n, int(num_bins), _sm_count(dev.index))
    hist = (torch.empty((b, plan.parts, int(num_bins)), dtype=torch.int32,
                        device=dev) if plan.parts > 1 else None)
    return (torch.empty((b, n), dtype=torch.int32, device=dev),
            torch.empty((b, int(num_bins) + 1), dtype=torch.int32,
                        device=dev), hist)


def _sort_bins(flat_idx, num_bins):
    """K1's glue alone, on the card: a stable per-cloud counting sort of
    the int32 bin ids [B, N]. -> (perm [B, N] int32: the points in bin
    order, each bin in point order; bounds [B, bins + 1] int32: bin v's run
    is perm[bounds[v]:bounds[v + 1]])."""
    ids = flat_idx.contiguous()
    perm, bounds, hist = _sort_buffers(ids, num_bins)
    b, n = ids.shape
    context, stream = kernels.launch_on(ids.device)
    with context:
        kernels.call("pvcnn_avg_voxelize_sort", ids.data_ptr(),
                     perm.data_ptr(), bounds.data_ptr(),
                     None if hist is None else hist.data_ptr(), b, n,
                     int(num_bins), 1 if hist is None else hist.shape[1],
                     stream)
    return perm, bounds


def _sort_bins_plain(flat_idx, num_bins):
    """`_sort_bins` in plain torch (the sort kernel's oracle): a stable
    sort, and the runs' bounds from the counts."""
    _, perm = torch.sort(flat_idx, dim=1, stable=True)
    counts = _counts(flat_idx, num_bins)
    bounds = torch.cat([counts.new_zeros((counts.shape[0], 1)), counts], 1)
    return (perm.to(torch.int32),
            bounds.cumsum(dim=1).to(torch.int32))


def _launch_k1_sorted(kernel, features, perm, bounds, num_bins,
                      channels_first, mean, ids=None, hist=None):
    """K1 on checked, contiguous features: alone on `_sort_bins`' output,
    or with ids (contiguous int32 [B, N]) the sort into perm and bounds
    first, in the same call (hist: `_sort_buffers`' counts). ->
    channel-major [B, C, bins] with channels_first, else bin-major [B,
    bins, C] (the kernel maps the two layouts differently)."""
    b, n, c = features.shape
    dev = features.device
    out = torch.empty((b, c, num_bins) if channels_first else (b, num_bins, c),
                      dtype=features.dtype, device=dev)
    ids_ptr = None if ids is None else ids.data_ptr()
    sort = (None if hist is None else hist.data_ptr(),
            1 if hist is None else hist.shape[1])
    long_run = _sort_plan(b, n, int(num_bins), _sm_count(dev.index)).long_run
    context, stream = kernels.launch_on(dev)
    with context:
        if features.dtype == torch.bfloat16 and mean:
            kernels.launch(
                kernel, "pvcnn_avg_voxelize_bf16", features.data_ptr(),
                ids_ptr, perm.data_ptr(), bounds.data_ptr(), sort[0],
                out.data_ptr(), b, n, c, int(num_bins), sort[1],
                int(channels_first), stream)
        elif features.dtype == torch.bfloat16:     # bin-major sums
            kernels.launch(
                kernel, "pvcnn_scatter_sum_bf16", features.data_ptr(),
                ids_ptr, perm.data_ptr(), bounds.data_ptr(), sort[0],
                out.data_ptr(), b, n, c, int(num_bins), sort[1], long_run,
                stream)
        else:
            kernels.launch(
                kernel, "pvcnn_avg_voxelize", features.data_ptr(), ids_ptr,
                perm.data_ptr(), bounds.data_ptr(), sort[0], out.data_ptr(),
                b, n, c, int(num_bins), sort[1], int(channels_first),
                int(mean), stream)
    return out


def avg_voxelize(features: torch.Tensor, vox_coords: torch.Tensor,
                 resolution: int):
    """Scatter-mean point features onto a dense voxel grid.

    features [B, N, C], vox_coords [B, N, 3] int in [0, R-1] ->
    [B, R, R, R, C] grid with axes (x, y, z); empty voxels are zero."""
    b, _, c = features.shape
    r = int(resolution)
    grid = scatter_mean(features, flat_voxel_index(vox_coords, r), r ** 3)
    return grid.reshape(b, r, r, r, c)
