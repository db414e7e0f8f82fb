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
  dgrad    K9 again with W^T, no prologue and no statistics, counted as
           `dense_rows_dgrad`; plain: g @ W^T
  wgrad    K10 (csrc/dense_rows.cu) with d(bias) from the same pass; plain:
           a(x)^T @ g and g.sum(0)
  statistics fold (dL/dy += gs1 + 2 y gs2) and prologue backward: plain
           torch on both devices (XLA in the JAX package)

Only the gradients autograd asks for are computed: a layer whose input is
the input cloud runs no dgrad.
"""

from __future__ import annotations

import math

import torch

from pvcnn_tpu_torch import kernels

__all__ = ["dense_rows_act"]

# K9's and K10's output tile (csrc/fp32_tile.cuh) and K10's row slice
_TILE_M, _TILE_N, _SLICE = 128, 64, 16
# K10 splits its rows until about this many blocks are in flight
_WGRAD_BLOCKS = 1024


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

def _check(tensors, what):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} kernel needs every operand on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{what} kernel takes float32 operands, got "
                         f"{[t.dtype for t in tensors]}")


def _prologue(pscale, pshift, ci, has_prologue):
    """-> the (scale, shift) operands of the launch: contiguous [Ci]
    tensors, or (None, None) without the prologue."""
    if not has_prologue:
        return None, None
    if pscale.shape != (ci,) or pshift.shape != (ci,):
        raise ValueError(f"prologue scale/shift must be [{ci}]")
    return pscale.contiguous(), pshift.contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(kernel, x2, w, bias, pro, slope, y, partial, has_prologue):
    rows, ci = x2.shape
    with torch.cuda.device(x2.device):
        kernels.launch(
            kernel, "pvcnn_dense_rows_fwd", x2.data_ptr(), w.data_ptr(),
            bias.data_ptr(), *map(_ptr, pro), slope, y.data_ptr(),
            None if partial is None else partial.data_ptr(), rows, ci,
            w.shape[1], int(has_prologue),
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
    x2, w, bias = x2.contiguous(), weight.contiguous(), bias.contiguous()
    y = torch.empty((rows, co), dtype=torch.float32, device=x2.device)
    # one statistics slot per row tile, summed in a fixed order
    partial = (torch.empty((math.ceil(rows / _TILE_M), 2, co),
                           dtype=torch.float32, device=x2.device)
               if want_stats else None)
    _launch_fwd("dense_rows_fwd", x2, w, bias, pro, slope, y, partial,
                has_prologue)
    if want_stats:
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
    wt = weight.t().contiguous()                               # [Co, Ci]
    zero_bias = torch.zeros(ci, dtype=torch.float32, device=g2.device)
    dxt = torch.empty((rows, ci), dtype=torch.float32, device=g2.device)
    _launch_fwd("dense_rows_dgrad", g2.contiguous(), wt, zero_bias,
                (None, None), 0.0, dxt, None, False)
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
    x2, g2 = x2.contiguous(), g2.contiguous()
    # split-K: row chunks, enough for about _WGRAD_BLOCKS blocks
    tiles = math.ceil(ci / _TILE_M) * math.ceil(co / _TILE_N)
    parts = max(1, math.ceil(_WGRAD_BLOCKS / tiles))
    chunk = _SLICE * max(1, math.ceil(rows / parts / _SLICE))
    chunks = math.ceil(rows / chunk)
    partial = torch.empty((chunks, ci, co), dtype=torch.float32,
                          device=x2.device)
    dbias = torch.empty((chunks, co), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        kernels.launch(
            "dense_rows_wgrad", "pvcnn_dense_rows_wgrad", x2.data_ptr(),
            g2.data_ptr(), *map(_ptr, pro), slope, partial.data_ptr(),
            dbias.data_ptr(), rows, ci, co, chunk, int(has_prologue),
            torch.cuda.current_stream().cuda_stream)
    # the chunks summed in a fixed order: reproducible bit for bit
    return partial.sum(dim=0), dbias.sum(dim=0)
