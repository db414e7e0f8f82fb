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
           row chunks added by a fold kernel; plain: a(x)^T @ g and g.sum(0)
  statistics fold (dL/dy += gs1 + 2 y gs2) and prologue backward: plain
           torch on both devices (XLA in the JAX package)

The kernels read the weight in either layout (`_layout`): the fused
SharedMLP passes its Conv1d weight's [Ci, Co] view, which no call copies.

Only the gradients autograd asks for are computed: a layer whose input is
the input cloud runs no dgrad.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from pvcnn_tpu_torch import kernels
from pvcnn_tpu_torch.ops.conv3d import _sm_count

__all__ = ["dense_rows_act"]

# K9's and K10's GEMM tile (csrc/dense_gemm.cuh): 128 output rows by 128
# columns (64 where N <= 64) on 2 x columns threads, the reduction in slices
# of _BK through a cp.async ring of _STAGES slices, rows padded by _PAD;
# the blocks per SM that its __launch_bounds__ promise, by column tile
_BM, _BK, _STAGES, _PAD = 128, 16, 4, 4
_MIN_BLOCKS = {128: 2, 64: 3}
# an H100 SM's shared memory, and what the runtime keeps of it per block
_SMEM_PER_SM, _SMEM_PER_BLOCK_RESERVED = 233472, 1024
# K10's split: the chunk count whose last wave of resident blocks is
# fullest within _WGRAD_WAVES waves, none shorter than _WGRAD_MIN_SLICES
_WGRAD_WAVES, _WGRAD_MIN_SLICES = 2, 8


def dense_rows_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   pscale: torch.Tensor | None, pshift: torch.Tensor | None,
                   slope: float, has_prologue: bool, want_stats: bool):
    """x [..., Ci] raw rows, weight [Ci, Co] (the JAX Dense kernel layout),
    bias [Co], pscale/pshift [Ci] (read only with has_prologue) -> (y [...,
    Co], s1 [Co], s2 [Co]) with s1 = sum of y and s2 = sum of y^2 over all
    rows when want_stats, zeros otherwise. Differentiable in x, weight,
    bias, pscale and pshift."""
    return _DenseRowsAct.apply(x, weight, bias, pscale, pshift, float(slope),
                               bool(has_prologue), bool(want_stats))


class _DenseRowsAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, pscale, pshift, slope, has_prologue,
                want_stats):
        x2 = x.reshape(-1, x.shape[-1])
        fwd = _forward_plain if x.device.type == "cpu" else _forward_cuda
        y2, s1, s2 = fwd(x2, weight, bias, pscale, pshift, slope,
                         has_prologue, want_stats)
        y = y2.reshape(x.shape[:-1] + (weight.shape[1],))
        ctx.slope, ctx.has_prologue = slope, has_prologue
        ctx.want_stats = want_stats
        ctx.save_for_backward(x, weight, pscale, pshift,
                              y if want_stats else None)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, weight, pscale, pshift, y = ctx.saved_tensors
        slope, pro = ctx.slope, ctx.has_prologue
        need_x, need_w, need_b, need_s, need_t = ctx.needs_input_grad[:5]
        cpu = x.device.type == "cpu"
        # the statistics' cotangents fold into y's: s1 = sum(y),
        # s2 = sum(y^2) => dL/dy += gs1 + 2 * y * gs2 (y biased)
        if ctx.want_stats:
            gy = gy + gs1 + 2.0 * y * gs2
        ci, co = weight.shape
        g2 = gy.reshape(-1, co).contiguous()
        x2 = x.reshape(-1, ci)
        dx = dw = dbias = dscale = dshift = None
        if need_x or (pro and (need_s or need_t)):
            # d loss / d a(x)
            dxt = (_dgrad_plain if cpu else _dgrad_cuda)(g2, weight)
            if pro:
                t = x2 * pscale + pshift
                dxf = dxt * torch.where(t > 0, 1.0, slope).to(dxt.dtype)
                dx = (dxf * pscale).reshape(x.shape) if need_x else None
                dscale = (dxf * x2).sum(0) if need_s else None
                dshift = dxf.sum(0) if need_t else None
            else:
                dx = dxt.reshape(x.shape)
        if need_w:
            dw, db = (_wgrad_plain if cpu else _wgrad_cuda)(
                x2, g2, pscale, pshift, slope, pro)
            dbias = db if need_b else None
        elif need_b:
            dbias = g2.sum(0)
        return dx, dw, dbias, dscale, dshift, None, None, None


# ---- plain versions (CPU tensors; chip_smoke.py's comparison on the card) --

def _act_plain(x2, pscale, pshift, slope):
    t = x2 * pscale + pshift
    return torch.where(t > 0, t, slope * t)


def _forward_plain(x2, weight, bias, pscale, pshift, slope, has_prologue,
                   want_stats):
    a = _act_plain(x2, pscale, pshift, slope) if has_prologue else x2
    y = a @ weight + bias
    if want_stats:
        return y, y.sum(0), (y * y).sum(0)
    zeros = y.new_zeros(y.shape[1])
    return y, zeros, zeros.clone()


def _dgrad_plain(g2, weight):
    return g2 @ weight.t()


def _wgrad_plain(x2, g2, pscale, pshift, slope, has_prologue):
    a = _act_plain(x2, pscale, pshift, slope) if has_prologue else x2
    return a.t() @ g2, g2.sum(0)


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
    SMs. K10 (wgrad) splits k into equal chunks of whole slices: the count
    whose last wave of resident blocks is fullest within _WGRAD_WAVES
    waves, the smaller on a tie, no chunk under _WGRAD_MIN_SLICES slices
    (one chunk where even that is too long)."""
    bn = 64 if n <= 64 else 128
    threads = 2 * bn
    smem = 4 * _STAGES * _BK * (_BM + _PAD + bn + _PAD)
    tiles = math.ceil(m / _BM) * math.ceil(n / bn)
    slices = max(1, math.ceil(k / _BK))
    if not wgrad:
        return Plan(bn, threads, _BK, _STAGES, smem, tiles, 1, max(k, 1), 0)
    per_sm = min(_SMEM_PER_SM // (smem + _SMEM_PER_BLOCK_RESERVED),
                 _MIN_BLOCKS[bn])
    slots = per_sm * sms
    most = max(1, min(slices // _WGRAD_MIN_SLICES,
                      math.ceil(_WGRAD_WAVES * slots / tiles)))
    splits = min(range(1, most + 1),
                 key=lambda s: (math.ceil(tiles * s / slots) / s, s))
    chunk = _BK * math.ceil(slices / splits)
    splits = math.ceil(slices * _BK / chunk)
    partial = 4 * splits * (m * n + n) if splits > 1 else 0
    return Plan(bn, threads, _BK, _STAGES, smem, tiles, splits, chunk,
                partial)


def _check(tensors, what):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} kernel needs every operand on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{what} kernel takes float32 operands only (its "
                         "bf16 mode is queued in ROADMAP.md), got "
                         f"{[t.dtype for t in tensors]}")


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
                  want_stats):
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


def _dgrad_cuda(g2, weight):
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
