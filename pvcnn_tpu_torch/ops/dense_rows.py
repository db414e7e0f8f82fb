"""Fused dense layer on channel-last point rows, forward and backward
(counterpart of pvcnn_tpu/ops/pallas/dense_rows.py:dense_rows_act).

y = a(x) @ weight + bias over the last axis, where a(x) = t > 0 ? t :
slope * t with t = x * pscale + pshift (the previous BatchNorm's folded
affine and its activation) with the prologue, and a(x) = x without it. With
want_stats the op also returns the per-channel sum and sum of squares of
the biased y over all rows (the BatchNorm statistics of training).

`dense_rows_act` is a torch.autograd.Function whose forward and backward
dispatch by device: a CUDA tensor goes to the kernels, a CPU tensor to the
plain versions beside them.

  forward  K9 (csrc/dense_rows.cu) with its statistics epilogue; plain:
           activation, x @ W + b, y.sum(0) and (y * y).sum(0)
  dgrad    K9 again reading W in place as W^T, no prologue, bias or
           statistics, counted as `dense_rows_dgrad`; plain: g @ W^T
  wgrad    K10 (csrc/dense_rows.cu) with d(bias) from the same pass, its
           row chunks added in order (fp32: by a fold kernel; bf16: inside
           the launch); plain: a(x)^T @ g and g.sum(0)
  statistics fold (dL/dy += gs1 + 2 y gs2) and prologue backward: plain
           torch on both devices (XLA in the JAX package)

The kernels read the weight in either layout (`_layout`): the fused
SharedMLP passes its Conv1d weight's [Ci, Co] view, which no call copies.

Only the gradients autograd asks for are computed: a layer whose input is
the input cloud runs no dgrad.

bf16 activations (a bfloat16 x; weight, bias, pscale and pshift float32,
as the JAX op takes them): the kernels' bf16 mode on the card (K9 on
wgmma fed by TMA, counted as dense_rows_fwd_bf16 and dense_rows_dgrad_bf16;
K10 on wgmma reading x and g once, dense_rows_wgrad_bf16), the plain
versions on the operands widened to f32 on the CPU. The forward's launch
rounds the weight into a bf16 copy laid out for the kernel, which the op
keeps for the dgrad (the wrappers' `staged` dict): one cast a step. The
rounding points are the JAX package's (pvcnn_tpu/ops/pallas/
dense_rows.py):

  forward  the weight cast to bf16 (w.astype(x.dtype), :276); a(x) in f32
           from the bf16 x, rounded to bf16 (_fwd_kernel); f32 products
           and sums, the f32 bias added to the f32 sum, the statistics from
           it, y rounded to bf16 once
  backward the cotangent with the statistics' terms in f32, rounded to
           bf16 (ge2, :254); the dgrad's output rounded to bf16; the
           prologue's backward in f32 on it, dx rounded to bf16, dscale and
           dshift f32; dW and d(bias) f32 sums (K10), dW returned in the
           weight's dtype, float32, not rounded
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from pvcnn_tpu_torch import kernels
from pvcnn_tpu_torch.ops.conv3d import _sm_count
from pvcnn_tpu_torch.utils.dtype import wide

__all__ = ["dense_rows_act", "dense_rows_plan"]

# K9's and K10's GEMM tile (csrc/dense_gemm.cuh): 128 output rows by 128
# columns (64 where N <= 64) on 2 x columns threads, the reduction in slices
# of _BK through a cp.async ring of _STAGES slices, rows padded by _PAD;
# the blocks per SM that its __launch_bounds__ promise, by column tile
_BM, _BK, _STAGES, _PAD = 128, 16, 4, 4
_MIN_BLOCKS = {128: 2, 64: 3}
# K9 in bf16 (csrc/dense_rows.cu: w9): tiles of 128 rows, slices of 64 k,
# a warp's epilogue tile 16 x (64 + 8) f32
_W9_BM, _W9_BK, _W9_EPI_STRIDE = 128, 64, 72
# its rows read without TMA: a slice's 128 rows of 64 k as the 9 16-byte
# pieces that hold each, wherever it starts, in two buffers
_W9_DIRECT_PIECES = 9
# an H100 SM's shared memory, and what the runtime keeps of it per block
_SMEM_PER_SM, _SMEM_PER_BLOCK_RESERVED = 233472, 1024
# K10's split: the chunk count whose last wave of resident blocks is
# fullest within _WGRAD_WAVES waves, none shorter than _WGRAD_MIN_SLICES
_WGRAD_WAVES, _WGRAD_MIN_SLICES = 2, 8
# K10 in bf16 (csrc/dense_rows.cu: w10): 2 consumer warpgroups of 64 rows
# of dW, 64-channel chunks of 128-byte rows, at most this many ring slots
_W10_CONSUMERS, _W10_CHUNK, _W10_MAX_STAGES = 256, 64, 6


def dense_rows_plan(rows: int, ci: int, co: int, dtype) -> int | None:
    """The JAX package's gate of the fused dense layer, restated
    (pvcnn_tpu/ops/pallas/dense_rows.py:dense_rows_plan): its row tile, or
    None where the fused path is not taken. rows >= 1024 divisible by a
    tile of 1024, 512 or 256 rows whose blocks fit the TPU kernel's VMEM
    budget at the lane-padded widths, in the activations' dtype (bf16 rows
    take half the bytes, so a wide bf16 layer may fuse where its fp32 twin
    does not). The port's kernels take any shape; the SharedMLP routes the
    layers the JAX package routes."""
    if rows < 1024:
        return None
    ci_pad, co_pad = -(-ci // 128) * 128, -(-co // 128) * 128
    mb = 2 if dtype == torch.bfloat16 else 4
    for rt in (1024, 512, 256):
        if rows % rt:
            continue
        use = (2 * rt * ci_pad * mb + 2 * rt * co_pad * mb
               + ci_pad * co_pad * mb + 2 * rt * max(ci_pad, co_pad) * 4
               + (2 * ci_pad + 2 * co_pad) * 4 + 16 * co_pad * 4)
        if use <= 12 * 1024 * 1024:
            return rt
    return None


def dense_rows_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   pscale: torch.Tensor | None, pshift: torch.Tensor | None,
                   slope: float, has_prologue: bool, want_stats: bool):
    """x [..., Ci] raw rows, weight [Ci, Co] (the JAX Dense kernel layout),
    bias [Co], pscale/pshift [Ci] (read only with has_prologue) -> (y [...,
    Co], s1 [Co], s2 [Co]) with s1 = sum of y and s2 = sum of y^2 over all
    rows when want_stats, zeros otherwise. Differentiable in x, weight,
    bias, pscale and pshift. A bfloat16 x gives a bfloat16 y (the weight,
    bias and prologue stay float32, as do the statistics and the weight's
    gradient)."""
    return _DenseRowsAct.apply(x, weight, bias, pscale, pshift, float(slope),
                               bool(has_prologue), bool(want_stats))


class _DenseRowsAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, pscale, pshift, slope, has_prologue,
                want_stats):
        x2 = x.reshape(-1, x.shape[-1])
        # the bf16 kernel's copy of the weight, kept for the dgrad
        staged = {}
        if x.device.type == "cpu":
            y2, s1, s2 = _forward_plain(x2, weight, bias, pscale, pshift,
                                        slope, has_prologue, want_stats)
        else:
            y2, s1, s2 = _forward_cuda(x2, weight, bias, pscale, pshift,
                                       slope, has_prologue, want_stats,
                                       staged)
        y = y2.reshape(x.shape[:-1] + (weight.shape[1],))
        ctx.slope, ctx.has_prologue = slope, has_prologue
        ctx.want_stats = want_stats
        ctx.save_for_backward(x, weight, pscale, pshift,
                              y if want_stats else None, staged.get("w16"))
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, weight, pscale, pshift, y, *w16 = ctx.saved_tensors
        w16 = w16[0] if w16 else None
        slope, pro = ctx.slope, ctx.has_prologue
        need_x, need_w, need_b, need_s, need_t = ctx.needs_input_grad[:5]
        cpu = x.device.type == "cpu"
        # the statistics' cotangents fold into y's: s1 = sum(y),
        # s2 = sum(y^2) => dL/dy += gs1 + 2 * y * gs2 (y biased); a bf16
        # cotangent folded in f32 and rounded to bf16 (the JAX op's ge2)
        if ctx.want_stats:
            gy = (wide(gy) + gs1 + 2.0 * wide(y) * gs2).to(x.dtype)
        ci, co = weight.shape
        g2 = gy.reshape(-1, co).contiguous()
        x2 = x.reshape(-1, ci)
        dx = dw = dbias = dscale = dshift = None
        if need_x or (pro and (need_s or need_t)):
            # d loss / d a(x)
            dxt = (_dgrad_plain(g2, weight) if cpu else
                   _dgrad_cuda(g2, weight, {"w16": w16}))
            if pro:
                xf, dxw = wide(x2), wide(dxt)
                t = xf * pscale + pshift
                dxf = dxw * torch.where(t > 0, 1.0, slope).to(dxw.dtype)
                dx = ((dxf * pscale).to(x.dtype).reshape(x.shape) if need_x
                      else None)
                dscale = (dxf * xf).sum(0) if need_s else None
                dshift = dxf.sum(0) if need_t else None
            else:
                dx = dxt.reshape(x.shape)
        if need_w:
            dw, db = (_wgrad_plain if cpu else _wgrad_cuda)(
                x2, g2, pscale, pshift, slope, pro)
            dbias = db if need_b else None
        elif need_b:
            dbias = wide(g2).sum(0)
        return dx, dw, dbias, dscale, dshift, None, None, None


# ---- plain versions (CPU tensors; chip_smoke.py's comparison on the card) --
# A bf16 operand is widened to f32 and the result rounded where the bf16
# kernels round (the module docstring). They take the kernel wrappers'
# arguments; `staged` (the bf16 kernels' weight copy) is not read.

def _act_plain(x2, pscale, pshift, slope):
    t = x2 * pscale + pshift
    return torch.where(t > 0, t, slope * t)


def _activated(x2, pscale, pshift, slope, has_prologue):
    """The product's operand: a(x) (a bf16 x's computed in f32 and rounded
    to bf16), widened to f32 where x is bf16."""
    if not has_prologue:
        return wide(x2)
    a = _act_plain(wide(x2), pscale, pshift, slope)
    return a.to(x2.dtype).float() if x2.dtype == torch.bfloat16 else a


def _weight_of(weight, x2):
    """The weight as the product takes it: rounded to bf16 (and widened)
    for a bf16 x."""
    if x2.dtype == torch.bfloat16:
        return weight.to(torch.bfloat16).float()
    return weight


def _forward_plain(x2, weight, bias, pscale, pshift, slope, has_prologue,
                   want_stats, staged=None):
    a = _activated(x2, pscale, pshift, slope, has_prologue)
    y = a @ _weight_of(weight, x2) + bias
    if want_stats:
        return y.to(x2.dtype), y.sum(0), (y * y).sum(0)
    zeros = y.new_zeros(y.shape[1])
    return y.to(x2.dtype), zeros, zeros.clone()


def _dgrad_plain(g2, weight, staged=None):
    return (wide(g2) @ _weight_of(weight, g2).t()).to(g2.dtype)


def _wgrad_plain(x2, g2, pscale, pshift, slope, has_prologue):
    a = _activated(x2, pscale, pshift, slope, has_prologue)
    g = wide(g2)
    return a.t() @ g, g.sum(0)


# ---- kernels (CUDA tensors) ------------------------------------------------

class Plan(NamedTuple):
    """One launch of K9 or K10 (csrc/dense_gemm.cuh's tile)."""

    bn: int             # output columns per block: 64 or 128
    threads: int        # 2 * bn
    bk: int             # reduction slice
    stages: int         # cp.async ring slots
    smem_bytes: int     # dynamic shared memory per block
    tiles: int          # output tiles (row tiles x column tiles)
    splits: int         # K10's row chunks (1 for K9)
    chunk: int          # reduction length per chunk, a multiple of bk
    partial_bytes: int  # K10's chunk partials [splits][M][N] + [splits][N]


@functools.lru_cache(maxsize=None)
def _plan(m, n, k, wgrad, sms) -> Plan:
    """The launch of an [m, n] output reduced over k on a card of `sms`
    SMs by the fp32 core. K10 (wgrad) splits k into equal chunks of whole
    slices: the count whose last wave of resident blocks is fullest within
    _WGRAD_WAVES waves, the smaller on a tie, no chunk under
    _WGRAD_MIN_SLICES slices (one chunk where even that is too long)."""
    bn = 64 if n <= 64 else 128
    bk, threads = _BK, 2 * bn
    smem = 4 * _STAGES * _BK * (_BM + _PAD + bn + _PAD)
    tiles = math.ceil(m / _BM) * math.ceil(n / bn)
    slices = max(1, math.ceil(k / bk))
    if not wgrad:
        return Plan(bn, threads, bk, _STAGES, smem, tiles, 1, max(k, 1), 0)
    per_sm = min(_SMEM_PER_SM // (smem + _SMEM_PER_BLOCK_RESERVED),
                 _MIN_BLOCKS[bn])
    slots = per_sm * sms
    most = max(1, min(slices // _WGRAD_MIN_SLICES,
                      math.ceil(_WGRAD_WAVES * slots / tiles)))
    splits = min(range(1, most + 1),
                 key=lambda s: (math.ceil(tiles * s / slots) / s, s))
    chunk = bk * math.ceil(slices / splits)
    splits = math.ceil(slices * bk / chunk)
    partial = 4 * splits * (m * n + n) if splits > 1 else 0
    return Plan(bn, threads, bk, _STAGES, smem, tiles, splits, chunk,
                partial)


def _check(tensors, what, bf16=0):
    """Every operand on one CUDA device and float32, or, with bf16 = n and
    a bfloat16 first operand, the first n (the rows, the cotangent, the
    weight's bf16 copy) bfloat16 and the rest (bias, prologue) float32."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} kernel needs every operand on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    want = [torch.float32] * len(tensors)
    if bf16 and tensors[0].dtype == torch.bfloat16:
        want[:bf16] = [torch.bfloat16] * bf16
    got = [t.dtype for t in tensors]
    if got != want:
        raise ValueError(f"{what} kernel takes float32 operands, or "
                         f"bfloat16 rows with the rest float32 "
                         f"({what.replace(' ', '_')}_bf16), got {got}")


def _prologue(pscale, pshift, ci, has_prologue):
    """-> the (scale, shift) operands of the launch: contiguous [Ci]
    tensors, or (None, None) without the prologue."""
    if not has_prologue:
        return None, None
    if pscale.shape != (ci,) or pshift.shape != (ci,):
        raise ValueError(f"prologue scale/shift must be [{ci}]")
    return pscale.contiguous(), pshift.contiguous()


def _layout(t):
    """The kernels' view of an operand read as B(k, n) = t[k, n]: (tensor,
    floats per row or column, k-contiguous?). A contiguous t is read by
    rows; the transposed view of a contiguous tensor (the SharedMLP's
    weight) in place by columns; anything else is copied first."""
    if t.is_contiguous():
        return t, t.shape[1], 0
    if t.t().is_contiguous():
        return t, t.shape[0], 1
    return t.contiguous(), t.shape[1], 0


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(kernel, x2, b, bias, pro, slope, y, partial, has_prologue,
                plan):
    """y = a(x2) B (+ bias): x2 [rows, K] contiguous, B(k, n) = b[k, n]."""
    rows, k = x2.shape
    b, ld, kmajor = _layout(b)
    with torch.cuda.device(x2.device):
        kernels.launch(
            kernel, "pvcnn_dense_rows_fwd", x2.data_ptr(), b.data_ptr(), ld,
            kmajor, _ptr(bias), *map(_ptr, pro), slope, y.data_ptr(),
            _ptr(partial), rows, k, b.shape[1], int(has_prologue), plan.bn,
            torch.cuda.current_stream().cuda_stream)


def _forward_cuda(x2, weight, bias, pscale, pshift, slope, has_prologue,
                  want_stats, staged=None):
    """staged: a dict that receives a bf16 x's weight copy as "w16" (the
    dgrad's B)."""
    if x2.dtype == torch.bfloat16:
        return _forward_cuda_bf16(x2, weight, bias, pscale, pshift, slope,
                                  has_prologue, want_stats, staged)
    _check([x2, weight, bias] + ([pscale, pshift] if has_prologue else []),
           "dense_rows")
    rows, ci = x2.shape
    co = weight.shape[1]
    if weight.shape != (ci, co) or bias.shape != (co,):
        raise ValueError(f"dense_rows kernel takes weight [{ci}, Co] and "
                         f"bias [Co], got {tuple(weight.shape)} and "
                         f"{tuple(bias.shape)}")
    pro = _prologue(pscale, pshift, ci, has_prologue)
    x2, bias = x2.contiguous(), bias.contiguous()
    plan = _plan(rows, co, ci, False, _sm_count(x2.device.index))
    y = torch.empty((rows, co), dtype=torch.float32, device=x2.device)
    # one statistics slot per row tile, summed in a fixed order
    partial = (torch.empty((math.ceil(rows / _BM), 2, co),
                           dtype=torch.float32, device=x2.device)
               if want_stats else None)
    _launch_fwd("dense_rows_fwd", x2, weight, bias, pro, slope, y, partial,
                has_prologue, plan)
    if want_stats and rows:
        s1, s2 = partial.sum(dim=0)
    else:
        s1 = torch.zeros(co, dtype=torch.float32, device=x2.device)
        s2 = torch.zeros_like(s1)
    return y, s1, s2


def _dgrad_cuda(g2, weight, staged=None):
    """staged: a dict that may hold a bf16 g's weight copy as "w16" (the
    forward's), made here if not."""
    if g2.dtype == torch.bfloat16:
        return _dgrad_cuda_bf16(g2, weight, staged)
    _check([g2, weight], "dense_rows dgrad")
    rows, co = g2.shape
    ci = weight.shape[0]
    if weight.shape != (ci, co):
        raise ValueError(f"dgrad of weight {tuple(weight.shape)} does not "
                         f"match g {tuple(g2.shape)}")
    dxt = torch.empty((rows, ci), dtype=torch.float32, device=g2.device)
    plan = _plan(rows, ci, co, False, _sm_count(g2.device.index))
    # B(k, n) = W[n, k], read in place
    _launch_fwd("dense_rows_dgrad", g2.contiguous(), weight.t(), None,
                (None, None), 0.0, dxt, None, False, plan)
    return dxt


def _wgrad_cuda(x2, g2, pscale, pshift, slope, has_prologue):
    if x2.dtype == torch.bfloat16:
        return _wgrad_cuda_bf16(x2, g2, pscale, pshift, slope, has_prologue)
    _check([x2, g2] + ([pscale, pshift] if has_prologue else []),
           "dense_rows wgrad")
    rows, ci = x2.shape
    co = g2.shape[1]
    if g2.shape[0] != rows:
        raise ValueError(f"x {tuple(x2.shape)} and g {tuple(g2.shape)} "
                         "differ in rows")
    pro = _prologue(pscale, pshift, ci, has_prologue)
    dw = torch.empty((ci, co), dtype=torch.float32, device=x2.device)
    db = torch.empty(co, dtype=torch.float32, device=x2.device)
    if rows == 0:                        # no rows: nothing to launch
        return dw.zero_(), db.zero_()
    x2, g2 = x2.contiguous(), g2.contiguous()
    plan = _plan(ci, co, rows, True, _sm_count(x2.device.index))
    # the chunks' partials, added in order by the fold kernel: reproducible
    # bit for bit
    partial = (torch.empty(plan.partial_bytes // 4, dtype=torch.float32,
                           device=x2.device) if plan.splits > 1 else None)
    with torch.cuda.device(x2.device):
        kernels.launch(
            "dense_rows_wgrad", "pvcnn_dense_rows_wgrad", x2.data_ptr(),
            g2.data_ptr(), *map(_ptr, pro), slope, _ptr(partial),
            dw.data_ptr(), db.data_ptr(), rows, ci, co, plan.bn, plan.chunk,
            int(has_prologue), torch.cuda.current_stream().cuda_stream)
    return dw, db


# ---- the bf16 mode ------------------------------------------------------------

class WgmmaPlan(NamedTuple):
    """One launch of K9 in bf16 (csrc/dense_rows.cu: dense_rows_wgmma_kernel):
    persistent blocks of 2 consumer warpgroups and a producer warp."""

    bn: int             # output columns a tile: 64 or 128
    per_sm: int         # blocks an SM (its __launch_bounds__)
    col_tiles: int      # column tiles (grid.y)
    row_tiles: int      # tiles of 128 rows
    grid: int           # blocks a column tile (grid.x), each walking the
    #                     row tiles blockIdx.x, + grid, ... in order
    slices: int         # slices of 64 of the reduction
    stages: int         # ring slots
    resident: bool      # the block's column slice of the weight loaded once
    direct_bytes: int   # shared memory for a tile's rows read without TMA
    smem_bytes: int     # dynamic shared memory a block
    work_floats: int    # statistics slots [col tiles][grid][2][bn] + tickets


def _wgmma_smem(bn, a_tma, stages, slices, resident, direct_bytes):
    """csrc/dense_rows.cu's w9::Layout: the ring (A's slice of 128 x 64 bf16
    by TMA, and the weight's of 64 x bn unless resident), the resident
    weight, a tile's rows read without TMA, 8 warps' 16 x 72 f32 epilogue
    tiles, their [8][2][bn] f32 sums, the mbarriers, a flag and the
    1024-byte alignment."""
    b = _W9_BK * bn * 2
    stage = (_W9_BM * _W9_BK * 2 if a_tma else 0) + (0 if resident else b)
    return (stages * stage + (slices * b if resident else 0) + direct_bytes
            + 8 * 16 * _W9_EPI_STRIDE * 4 + 8 * 2 * bn * 4
            + 8 * (2 * stages + 1) + 16 + 1024)


def _padded(c):
    """csrc/dense_rows.cu's w9::padded: an axis of the weight's bf16 copy
    in whole column tiles (64, or a multiple of 128) and slices (64)."""
    return 64 if c <= 64 else -(-c // 128) * 128


@functools.lru_cache(maxsize=None)
def _wgmma_plan(m, n, k, a_tma, prologue, sms) -> WgmmaPlan:
    """K9's bf16 launch for an [m, n] output reduced over k on a card of
    `sms` SMs, A by TMA (a_tma) or staged slice by slice by the consumers
    (each row's 64 k in the 16-byte pieces that hold them), with or
    without the prologue. The column tile is 64 where n <= 64, else 128,
    with the blocks an SM of the kernel's __launch_bounds__ (2, or 1 at 128
    where A goes through registers: without TMA or with the prologue). The weight's column slice stays resident
    where it fits beside the deepest ring (4 slots, 2 at least; one unused
    slot where A comes without TMA), else it streams through the ring with
    A's slices; the persistent blocks fill the SMs' slots (per_sm each)
    across the column tiles, none without a row tile."""
    bn = 64 if n <= 64 else 128
    per_sm = 1 if bn == 128 and (prologue or not a_tma) else 2
    budget = _SMEM_PER_SM // per_sm - _SMEM_PER_BLOCK_RESERVED
    slices = max(1, math.ceil(k / _W9_BK))
    direct = 0 if a_tma else 2 * _W9_BM * _W9_DIRECT_PIECES * 16
    fits = [(stages, resident)
            for resident, depths in ((True, (4, 3, 2) if a_tma else (1,)),
                                     (False, (4, 3, 2)))
            for stages in depths
            if _wgmma_smem(bn, a_tma, stages, slices, resident,
                           direct) <= budget]
    stages, resident = fits[0]
    col_tiles = math.ceil(n / bn)
    row_tiles = math.ceil(m / _W9_BM)
    grid = max(1, min(row_tiles, per_sm * sms // col_tiles))
    return WgmmaPlan(bn, per_sm, col_tiles, row_tiles, grid, slices, stages,
                     resident, direct,
                     _wgmma_smem(bn, a_tma, stages, slices, resident,
                                 direct),
                     col_tiles * (grid * 2 * bn + 1))


def _tma_rows(t2):
    """Whether K9's bf16 mode reads the rows of t2 by TMA: a row stride of
    a multiple of 16 bytes and a 16-byte aligned base (else its consumers
    stage them, slice by slice)."""
    return t2.stride(0) % 8 == 0 and t2.data_ptr() % 16 == 0


def _rows_of(t2):
    """t2 as the kernel reads it: rows of contiguous elements (a copy only
    where the elements of a row are not)."""
    return t2 if t2.stride(1) == 1 or t2.shape[1] <= 1 else t2.contiguous()


def _weight16(weight):
    """weight [Ci, Co] (float32, any layout) -> the bf16 copy the forward's
    launch makes: [Kp / 8, Cop, 8] (Kp, Cop: Ci, Co padded by `_padded`),
    element (g, co, j) = weight[8 g + j, co] rounded to bf16, zeros past
    Ci and Co (the forward's B read K-major, the dgrad's W^T MN-major)."""
    ci, co = weight.shape
    w = torch.zeros((_padded(ci), _padded(co)), dtype=torch.bfloat16,
                    device=weight.device)
    w[:ci, :co] = weight
    return w.reshape(-1, 8, w.shape[1]).transpose(1, 2).contiguous()


def _forward_cuda_bf16(x2, weight, bias, pscale, pshift, slope, has_prologue,
                       want_stats, staged):
    rows, ci = x2.shape
    co = weight.shape[1]
    if weight.shape != (ci, co) or bias.shape != (co,):
        raise ValueError(f"dense_rows_bf16 kernel takes weight [{ci}, Co] "
                         f"and bias [Co], got {tuple(weight.shape)} and "
                         f"{tuple(bias.shape)}")
    _check([x2, weight, bias] + ([pscale, pshift] if has_prologue else []),
           "dense_rows", bf16=1)
    pro = _prologue(pscale, pshift, ci, has_prologue)
    x2, bias = _rows_of(x2), bias.contiguous()
    dev = x2.device
    tma = _tma_rows(x2)
    plan = _wgmma_plan(rows, co, ci, tma, has_prologue,
                       _sm_count(dev.index))
    w16 = torch.empty((_padded(ci) // 8, _padded(co), 8),
                      dtype=torch.bfloat16, device=dev)
    y = torch.empty((rows, co), dtype=torch.bfloat16, device=dev)
    # the statistics, then each block's slot and the column tiles' tickets
    # (the last block of a column tile adds the slots in order)
    stats = want_stats and rows > 0
    work = (torch.empty(2 * co + plan.work_floats, dtype=torch.float32,
                        device=dev) if stats else
            torch.zeros(2 * co, dtype=torch.float32, device=dev))
    context, stream = kernels.launch_on(dev)
    with context:
        kernels.launch(
            "dense_rows_fwd_bf16", "pvcnn_dense_rows_fwd_wgmma",
            x2.data_ptr(), x2.stride(0), int(tma), weight.data_ptr(),
            weight.stride(0), weight.stride(1), w16.data_ptr(),
            bias.data_ptr(), *map(_ptr, pro), slope, y.data_ptr(),
            work.data_ptr() if stats else None, rows, ci, co, plan.bn,
            plan.grid, plan.stages, int(plan.resident), plan.direct_bytes,
            plan.smem_bytes, stream)
    if staged is not None:
        staged["w16"] = w16
    return y, work[:co], work[co:2 * co]


def _dgrad_cuda_bf16(g2, weight, staged):
    rows, co = g2.shape
    ci = weight.shape[0]
    if weight.shape != (ci, co):
        raise ValueError(f"dgrad of weight {tuple(weight.shape)} does not "
                         f"match g {tuple(g2.shape)}")
    _check([g2, weight], "dense_rows dgrad", bf16=1)
    w16 = (staged or {}).get("w16")
    if w16 is None:
        w16 = _weight16(weight)
    want = (_padded(ci) // 8, _padded(co), 8)
    if w16.shape != want or w16.dtype != torch.bfloat16:
        raise ValueError(f"dense_rows_dgrad_bf16 takes the weight's bf16 "
                         f"copy {list(want)}, got {tuple(w16.shape)} "
                         f"{w16.dtype}")
    g2 = _rows_of(g2)
    dev = g2.device
    tma = _tma_rows(g2)
    plan = _wgmma_plan(rows, ci, co, tma, False, _sm_count(dev.index))
    dxt = torch.empty((rows, ci), dtype=torch.bfloat16, device=dev)
    # B(k, n) = W^T[co, ci]: the forward's copy read MN-major
    context, stream = kernels.launch_on(dev)
    with context:
        kernels.launch(
            "dense_rows_dgrad_bf16", "pvcnn_dense_rows_dgrad_wgmma",
            g2.data_ptr(), g2.stride(0), int(tma), w16.data_ptr(),
            dxt.data_ptr(), rows, ci, co, plan.bn, plan.grid, plan.stages,
            int(plan.resident), plan.direct_bytes, plan.smem_bytes, stream)
    return dxt


class WgradPlan(NamedTuple):
    """One launch of K10 in bf16 (csrc/dense_rows.cu:
    dense_rows_wgrad_wgmma_kernel): persistent blocks of 2 consumer
    warpgroups and a producer warp, one an SM, launched cooperatively."""

    a_route: int        # x's copy route (`_copy_route`; 1: bulk slices)
    bn: int             # dW columns a tile: 64, 128 or 256
    pair: bool          # Ci > 64: the warpgroups own two 64-channel tiles
    #                     of Ci (else one, each over half a slice's rows)
    sr: int             # rows a slice: 128, 64 or 32
    stages: int         # ring slots
    dslots: int         # raw buffers of g read raw (its route 2; else 0),
    #                     filled dslots - 1 slices ahead of their layout
    mtiles: int         # tiles along Ci (128 channels with pair, else 64)
    ntiles: int         # tiles along Co
    slices: int         # slices of sr rows
    parts: int          # runs of slices a tile's rows are cut into
    grid: int           # blocks: units (tile, part) blockIdx.x, + grid, ...
    smem_bytes: int     # dynamic shared memory a block
    work_floats: int    # the warpgroups' slots, d(bias) slots, a counter


def _w10_smem(bn, pair, sr, stages, dslots, a_route, b_route, ci):
    """csrc/dense_rows.cu's w10::Layout: the ring of slices (A's part: its
    chunks of 64 channels, each sr rows of 128 bytes, or with route 2 its
    raw rows' 16-byte pieces, or with route 1 the slice's rows as they
    lie, in whole KiB; then B's chunks); g's ring of dslots raw buffers
    with route 2; the d(bias) partials (8 f32 a consumer thread); the
    mbarriers; the 1024-byte alignment."""
    na, nb = (2 if pair else 1), bn // _W10_CHUNK
    raw = lambda w: sr * (w // 8 + 1) * 16
    kib = lambda n: -(-n // 1024) * 1024
    a_part = (kib(raw(na * _W10_CHUNK)) if a_route == 2 else
              kib(sr * ci * 2) if a_route == 1 else na * sr * 128)
    return (stages * (a_part + nb * sr * 128)
            + (dslots * raw(bn) if b_route == 2 else 0)
            + 8 * 4 * _W10_CONSUMERS + 8 * 2 * stages + 16 + 1024)


@functools.lru_cache(maxsize=None)
def _wgrad_plan(rows, ci, co, a_route, b_route, sms, bulk=False) -> WgradPlan:
    """K10's bf16 launch for dW [ci, co] over `rows` rows on a card of
    `sms` SMs, x (A) and g (B) each by its copy route (`_copy_route`),
    x's slices as bulk copies of its rows instead (route 1) where `bulk`
    (contiguous rows TMA cannot read) and 3 ring slots of them fit at
    slices of 128 (4 slots), 64 or 32 rows. The column tile the least of
    64, 128 and 256 that holds co (256 beyond); for g read raw 4 raw
    buffers (3 slices ahead), else 3, else 2; slices of 128 rows where 4
    ring slots fit beside the rest, else 64 (128 rows and 2 raw buffers
    last), with as many ring slots as fit (at most 6; at least 2 and the
    raw buffers' count); the row range of
    each tile cut into `parts` runs of whole slices, enough that the
    blocks fill the SMs once, no run empty, and the slots (a 64 x bn f32
    partial a warpgroup and unit) no larger than x and g themselves."""
    bn = 64 if co <= 64 else 128 if co <= 128 else 256
    pair = ci > _W10_CHUNK
    budget = _SMEM_PER_SM - _SMEM_PER_BLOCK_RESERVED
    dshapes = ([(128, 4), (128, 3), (64, 4), (64, 3), (128, 2), (64, 2)]
               if b_route == 2 else [(128, 0), (64, 0)])
    tries = ([(1, sr, d, max(4 if sr == 128 else 3, d))
              for sr in (128, 64, 32)
              for d in sorted({d for _, d in dshapes}, reverse=True)]
             if bulk else [])
    tries += [(a_route, sr, d, 4 if sr == 128 else max(2, d))
              for sr, d in dshapes]
    for route, sr, dslots, least in tries:
        fixed = _w10_smem(bn, pair, sr, 0, dslots, route, b_route, ci)
        stage = _w10_smem(bn, pair, sr, 1, dslots, route, b_route,
                          ci) - fixed
        stages = min(_W10_MAX_STAGES, (budget - fixed) // stage)
        if stages >= least and (bn < 256 or sr <= 64):
            a_route = route
            break
    mtiles = math.ceil(ci / (2 * _W10_CHUNK if pair else _W10_CHUNK))
    ntiles = math.ceil(co / bn)
    tiles = mtiles * ntiles
    slices = math.ceil(rows / sr)
    part_bytes = tiles * 2 * 64 * bn * 4
    parts = max(1, min(slices, sms // tiles,
                       2 * rows * (ci + co) // part_bytes))
    kps = parts if pair else 2 * parts
    work = ((2 * mtiles if pair else 1) * ntiles * kps * 64 * bn
            + ntiles * parts * bn + 1)
    return WgradPlan(a_route, bn, pair, sr, stages, dslots, mtiles, ntiles,
                     slices, parts, min(sms, tiles * parts),
                     _w10_smem(bn, pair, sr, stages, dslots, a_route,
                               b_route, ci), work)


def _copy_route(t2):
    """How K10's bf16 launch reads the bf16 rows of t2 (its route, in
    bytes a copy): 16, by TMA, where the row stride and the base are
    multiples of 16 bytes; 8 or 4, by cp.async of 8 or 4 bytes straight
    into the laid-out slice, where they are multiples of that; else 2, as
    raw rows (whole 16-byte pieces) that are laid out in the kernel."""
    ptr, step = t2.data_ptr(), 2 * t2.stride(0)
    return next((b for b in (16, 8, 4) if step % b == 0 and ptr % b == 0),
                2)


def _bulk_rows(t2, route):
    """Whether K10's bf16 launch may copy x's slices whole (route 1):
    rows TMA cannot read (route below 16) that lie contiguous (stride Ci)
    from a 16-byte aligned base."""
    return (route < 16 and t2.stride(0) == t2.shape[1]
            and t2.data_ptr() % 16 == 0)


def _wgrad_walk(plan):
    """The kernel's walk, restated: for each block, its units in order as
    (tile, part, first slice, end slice)."""
    tiles = plan.mtiles * plan.ntiles
    first = lambda part: part * plan.slices // plan.parts
    return [[(u % tiles, u // tiles, first(u // tiles),
              first(u // tiles + 1))
             for u in range(b, tiles * plan.parts, plan.grid)]
            for b in range(plan.grid)]


def _wgrad_cuda_bf16(x2, g2, pscale, pshift, slope, has_prologue):
    _check([x2, g2] + ([pscale, pshift] if has_prologue else []),
           "dense_rows wgrad", bf16=2)
    rows, ci = x2.shape
    co = g2.shape[1]
    if g2.shape[0] != rows:
        raise ValueError(f"x {tuple(x2.shape)} and g {tuple(g2.shape)} "
                         "differ in rows")
    pro = _prologue(pscale, pshift, ci, has_prologue)
    dev = x2.device
    dw = torch.empty((ci, co), dtype=torch.float32, device=dev)
    db = torch.empty(co, dtype=torch.float32, device=dev)
    if rows == 0:                        # no rows: nothing to launch
        return dw.zero_(), db.zero_()
    x2, g2 = _rows_of(x2), _rows_of(g2)
    a_route, b_route = _copy_route(x2), _copy_route(g2)
    plan = _wgrad_plan(rows, ci, co, a_route, b_route, _sm_count(dev.index),
                       _bulk_rows(x2, a_route))
    # the warpgroups' f32 partials, added in order inside the launch:
    # reproducible bit for bit
    work = torch.empty(plan.work_floats, dtype=torch.float32, device=dev)
    context, stream = kernels.launch_on(dev)
    with context:
        kernels.launch(
            "dense_rows_wgrad_bf16", "pvcnn_dense_rows_wgrad_bf16",
            x2.data_ptr(), x2.stride(0), plan.a_route, g2.data_ptr(),
            g2.stride(0), b_route, *map(_ptr, pro), slope, dw.data_ptr(),
            db.data_ptr(), work.data_ptr(), rows, ci, co, plan.bn,
            int(plan.pair), plan.sr, plan.stages, plan.dslots, plan.parts,
            plan.grid, plan.smem_bytes, stream)
    return dw, db
