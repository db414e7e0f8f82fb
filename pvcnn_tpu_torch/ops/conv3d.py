"""Fused conv3d on flat voxel rows, forward and backward (counterpart of
pvcnn_tpu/ops/pallas/conv_rows.py:conv3d_rows_act).

y = conv3d(a(x), weight) + bias, stride 1, zero padding k // 2, where
a(x) = leaky_relu(x * pscale + pshift, 0.1) with the prologue (the previous
BatchNorm's folded affine and LeakyReLU) and a(x) = x without it. Out-of-grid
taps read 0 after the activation. With want_stats the op also returns the
per-channel sum and sum of squares of the biased y (the BatchNorm statistics
of training).

`conv3d_rows_act` is a torch.autograd.Function whose forward and backward
dispatch by device: a CUDA tensor goes to the kernels, a CPU tensor to the
plain versions beside them.

  forward  K3 (csrc/conv3d.cu) with its statistics epilogue; plain:
           activation, F.conv3d, y.sum / (y * y).sum
  dgrad    K3 again, on the cotangent with flipped, io-swapped taps;
           plain: F.conv3d with the same weight
  wgrad    K4 (csrc/conv3d_wgrad.cu); plain: 27 tap products
  prologue backward, bias and statistics folds: plain torch on both devices
           (XLA in the JAX package)

Only the gradients autograd asks for are computed: the first PVConv's grid
comes from the input cloud, so its conv0 runs no dgrad.

`conv3d_same` is the NDHWC conv of the unfused voxel branch
(PVCNN_TPU_CONV_ROWS=0) with its custom weight gradient
(PVCNN_TPU_CUSTOM_CONV_WGRAD=1), counterpart of pvcnn_tpu/nn/conv3d.py:
conv3d_same, on channel-last grids [B, R, R, R, C]:

  forward  F.conv3d on the permuted (channels_last_3d) grid, both devices
  dgrad    F.conv3d of the cotangent with flipped, io-swapped taps
           (the JAX package runs these two as XLA convs, outside any
           Pallas kernel)
  wgrad    K11 (csrc/conv3d_ndhwc_wgrad.cu); plain: 27 shifted-slice
           products, the JAX package's own fallback
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pvcnn_tpu_torch import kernels

__all__ = ["conv3d_rows_act", "conv3d_same", "leaky_affine"]

# the forward prologue's scale/shift live in K3's shared memory
# (8 bytes per input channel beside its 24 KB of static tiles)
_MAX_PROLOGUE_CI = 2048
# K3's voxel tile (statistics slots); K4's and K11's tile shape
_FWD_TILE_V = 128
_WGRAD_TILE_M, _WGRAD_TILE_N, _WGRAD_SLICE = 128, 64, 16
# K4 and K11 split their reductions until about this many blocks are in
# flight
_WGRAD_BLOCKS = 2048


def leaky_affine(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor):
    """leaky_relu(x * scale + shift, 0.1) on [B, C, ...] with per-channel
    scale/shift [C]."""
    shape = (-1,) + (1,) * (x.dim() - 2)
    return F.leaky_relu(x * scale.reshape(shape) + shift.reshape(shape), 0.1)


def conv3d_rows_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    pscale: torch.Tensor | None, pshift: torch.Tensor | None,
                    resolution: int, has_prologue: bool,
                    want_stats: bool = False):
    """x [B, Ci, R^3] raw rows, weight [Co, Ci, 3, 3, 3] (torch Conv3d
    layout), bias [Co], pscale/pshift [Ci] (read only with has_prologue) ->
    (y [B, Co, R^3], s1 [Co], s2 [Co]) with s1 = sum of y and s2 = sum of
    y^2 over clouds and voxels when want_stats, zeros otherwise. The flat row
    index is x * R^2 + y * R + z. Differentiable in x, weight, bias, pscale
    and pshift."""
    return _Conv3dRowsAct.apply(x, weight, bias, pscale, pshift,
                                int(resolution), bool(has_prologue),
                                bool(want_stats))


class _Conv3dRowsAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, pscale, pshift, resolution,
                has_prologue, want_stats):
        fwd = _forward_plain if x.device.type == "cpu" else _forward_cuda
        y, s1, s2 = fwd(x, weight, bias, pscale, pshift, resolution,
                        has_prologue, want_stats)
        ctx.resolution = resolution
        ctx.has_prologue = has_prologue
        ctx.want_stats = want_stats
        ctx.save_for_backward(x, weight, pscale, pshift,
                              y if want_stats else None)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, weight, pscale, pshift, y = ctx.saved_tensors
        r, pro = ctx.resolution, ctx.has_prologue
        need_x, need_w, need_b, need_s, need_t = ctx.needs_input_grad[:5]
        cpu = x.device.type == "cpu"
        # the statistics' cotangents fold into y's: s1 = sum(y),
        # s2 = sum(y^2) => dL/dy += gs1 + 2 * y * gs2 (y biased)
        if ctx.want_stats:
            gy = gy + gs1[None, :, None] + 2.0 * y * gs2[None, :, None]
        gy = gy.contiguous()
        dx = dw = dbias = dscale = dshift = None
        if need_b:
            dbias = gy.sum(dim=(0, 2))
        if need_x or (pro and (need_s or need_t)):
            # d loss / d a(x) at every grid voxel
            dxt = (_dgrad_plain if cpu else _dgrad_cuda)(gy, weight, r)
            if pro:
                t = x * pscale[:, None] + pshift[:, None]
                dxf = dxt * torch.where(t > 0, 1.0, 0.1).to(dxt.dtype)
                dx = dxf * pscale[:, None] if need_x else None
                dscale = (dxf * x).sum(dim=(0, 2)) if need_s else None
                dshift = dxf.sum(dim=(0, 2)) if need_t else None
            else:
                dx = dxt
        if need_w:
            dw = (_wgrad_plain if cpu else _wgrad_cuda)(x, gy, pscale, pshift,
                                                        r, pro)
        return dx, dw, dbias, dscale, dshift, None, None, None


# ---- plain versions (CPU tensors; chip_smoke.py's comparison on the card) --

def _forward_plain(x, weight, bias, pscale, pshift, resolution, has_prologue,
                   want_stats):
    y = _conv3d_plain(x, weight, bias, pscale, pshift, resolution,
                      has_prologue)
    if want_stats:
        return (y,) + _stats_plain(y)
    zeros = y.new_zeros(y.shape[1])
    return y, zeros, zeros.clone()


def _conv3d_plain(x, weight, bias, pscale, pshift, resolution, has_prologue):
    r = int(resolution)
    b, ci, _ = x.shape
    k = weight.shape[-1]
    if has_prologue:
        x = leaky_affine(x, pscale, pshift)
    y = F.conv3d(x.reshape(b, ci, r, r, r), weight, bias, padding=k // 2)
    return y.reshape(b, weight.shape[0], r ** 3)


def _stats_plain(y):
    return y.sum(dim=(0, 2)), (y * y).sum(dim=(0, 2))


def _dgrad_weight(weight):
    """[Co, Ci, 3, 3, 3] -> the dgrad's forward weight [Ci, Co, 3, 3, 3]:
    taps flipped over the three spatial axes, channel axes swapped."""
    return weight.flip(2, 3, 4).transpose(0, 1)


def _dgrad_plain(gy, weight, resolution):
    r = int(resolution)
    b, co, _ = gy.shape
    dx = F.conv3d(gy.reshape(b, co, r, r, r), _dgrad_weight(weight),
                  padding=weight.shape[-1] // 2)
    return dx.reshape(b, weight.shape[1], r ** 3)


def _wgrad_plain(x, gy, pscale, pshift, resolution, has_prologue):
    """dW[co, ci, tap] = sum over clouds and voxels of g[co, v] * a(x)[ci,
    v + tap], the activated input zero-padded, one product per tap."""
    r = int(resolution)
    b, ci, _ = x.shape
    co = gy.shape[1]
    a = leaky_affine(x, pscale, pshift) if has_prologue else x
    ap = F.pad(a.reshape(b, ci, r, r, r), (1, 1, 1, 1, 1, 1))
    dw = x.new_empty((co, ci, 3, 3, 3))
    for tx in range(3):
        for ty in range(3):
            for tz in range(3):
                xs = ap[:, :, tx:tx + r, ty:ty + r, tz:tz + r].reshape(
                    b, ci, r ** 3)
                dw[:, :, tx, ty, tz] = torch.tensordot(gy, xs,
                                                       dims=([0, 2], [0, 2]))
    return dw


# ---- kernels (CUDA tensors) ------------------------------------------------

def _check(tensors, what):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} kernel needs every operand on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{what} kernel takes float32 operands, got "
                         f"{[t.dtype for t in tensors]}")


def _check_conv(x, weight, r):
    b, ci, bins = x.shape
    co = weight.shape[0]
    if tuple(weight.shape) != (co, ci, 3, 3, 3):
        raise ValueError("conv3d kernel takes a 3x3x3 weight [Co, "
                         f"{ci}, 3, 3, 3], got {tuple(weight.shape)}")
    if bins != r ** 3:
        raise ValueError(f"x {tuple(x.shape)} does not match R={r}")
    return b, ci, co, bins


def _launch_fwd(kernel, x, w_taps, bias, pro, y, partial, b, ci, co, r,
                has_prologue):
    with torch.cuda.device(x.device):
        kernels.launch(
            kernel, "pvcnn_conv3d_fwd", x.data_ptr(), w_taps.data_ptr(),
            bias.data_ptr(), *pro, y.data_ptr(),
            None if partial is None else partial.data_ptr(), b, ci, co, r,
            int(has_prologue), torch.cuda.current_stream().cuda_stream)


def _forward_cuda(x, weight, bias, pscale, pshift, resolution, has_prologue,
                  want_stats):
    r = int(resolution)
    _check([x, weight, bias] + ([pscale, pshift] if has_prologue else []),
           "conv3d")
    b, ci, co, bins = _check_conv(x, weight, r)
    if tuple(bias.shape) != (co,):
        raise ValueError(f"bias {tuple(bias.shape)} does not match Co={co}")
    if has_prologue and (pscale.shape != (ci,) or pshift.shape != (ci,)):
        raise ValueError(f"prologue scale/shift must be [{ci}]")
    if has_prologue and ci > _MAX_PROLOGUE_CI:
        raise ValueError(f"conv3d kernel's prologue takes at most "
                         f"{_MAX_PROLOGUE_CI} input channels, got {ci}")
    x, bias = x.contiguous(), bias.contiguous()
    # tap-major [27 * Ci, Co] (the JAX [k, k, k, Ci, Co] layout, flattened)
    w_taps = weight.permute(2, 3, 4, 1, 0).reshape(27 * ci, co).contiguous()
    if has_prologue:
        pscale, pshift = pscale.contiguous(), pshift.contiguous()
        pro = (pscale.data_ptr(), pshift.data_ptr())
    else:
        pro = (None, None)
    y = torch.empty((b, co, bins), dtype=torch.float32, device=x.device)
    # one statistics slot per (cloud, voxel tile), summed in a fixed order
    partial = (torch.empty((2, co, b * math.ceil(bins / _FWD_TILE_V)),
                           dtype=torch.float32, device=x.device)
               if want_stats else None)
    _launch_fwd("conv3d_fwd", x, w_taps, bias, pro, y, partial, b, ci, co, r,
                has_prologue)
    if want_stats:
        s1, s2 = partial.sum(dim=2)
    else:
        s1 = torch.zeros(co, dtype=torch.float32, device=x.device)
        s2 = torch.zeros_like(s1)
    return y, s1, s2


def _dgrad_cuda(gy, weight, resolution):
    r = int(resolution)
    _check([gy, weight], "conv3d dgrad")
    wt = _dgrad_weight(weight)                         # [Ci, Co, 3, 3, 3]
    b, co, ci, bins = _check_conv(gy, wt, r)
    gy = gy.contiguous()
    w_taps = wt.permute(2, 3, 4, 1, 0).reshape(27 * co, ci).contiguous()
    zero_bias = torch.zeros(ci, dtype=torch.float32, device=gy.device)
    dx = torch.empty((b, ci, bins), dtype=torch.float32, device=gy.device)
    _launch_fwd("conv3d_dgrad", gy, w_taps, zero_bias, (None, None), dx,
                None, b, co, ci, r, False)
    return dx


def _wgrad_cuda(x, gy, pscale, pshift, resolution, has_prologue):
    r = int(resolution)
    _check([x, gy] + ([pscale, pshift] if has_prologue else []),
           "conv3d wgrad")
    b, ci, bins = x.shape
    co = gy.shape[1]
    if bins != r ** 3 or tuple(gy.shape) != (b, co, bins):
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(gy.shape)} do "
                         f"not match R={r}")
    if has_prologue and (pscale.shape != (ci,) or pshift.shape != (ci,)):
        raise ValueError(f"prologue scale/shift must be [{ci}]")
    x, gy = x.contiguous(), gy.contiguous()
    if has_prologue:
        pro = (pscale.contiguous().data_ptr(), pshift.contiguous().data_ptr())
    else:
        pro = (None, None)
    # split-K: voxel chunks per cloud, enough for about _WGRAD_BLOCKS blocks
    tiles = (math.ceil(27 * ci / _WGRAD_TILE_M)
             * math.ceil(co / _WGRAD_TILE_N))
    per_cloud = max(1, math.ceil(_WGRAD_BLOCKS / (tiles * b)))
    chunk = _WGRAD_SLICE * math.ceil(bins / per_cloud / _WGRAD_SLICE)
    chunks = math.ceil(bins / chunk)
    partial = torch.empty((b * chunks, 27 * ci, co), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        kernels.launch(
            "conv3d_wgrad", "pvcnn_conv3d_wgrad", x.data_ptr(),
            gy.data_ptr(), *pro, partial.data_ptr(), b, ci, co, r, chunk,
            int(has_prologue), torch.cuda.current_stream().cuda_stream)
    # the slices summed in a fixed order: reproducible bit for bit
    w_taps = partial.sum(dim=0)
    return w_taps.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2).contiguous()


# ---- NDHWC conv with its custom weight gradient ----------------------------

def conv3d_same(x: torch.Tensor, weight: torch.Tensor):
    """x [B, R, R, R, Ci] channel-last grid, weight [Co, Ci, k, k, k] (torch
    Conv3d layout, odd k) -> [B, R, R, R, Co]: stride 1, zero padding
    k // 2, no bias. Differentiable in x and weight."""
    return _Conv3dSame.apply(x, weight)


def _conv_ndhwc(x, weight):
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight,
                 padding=weight.shape[-1] // 2)
    return y.permute(0, 2, 3, 4, 1)


class _Conv3dSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return _conv_ndhwc(x, weight)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad
        dx = dw = None
        if need_x:
            dx = _conv_ndhwc(g, _dgrad_weight(weight))
        if need_w:
            wgrad = (_ndhwc_wgrad_plain if x.device.type == "cpu"
                     else _ndhwc_wgrad_cuda)
            dw = wgrad(x, g, weight.shape[-1])
        return dx, dw


def _ndhwc_wgrad_plain(x, g, k):
    """dW[co, ci, kx, ky, kz] = sum over clouds and voxels of
    xpad[b, v + (kx, ky, kz), ci] * g[b, v, co], one product per tap."""
    b, d, h, w, ci = x.shape
    co = g.shape[-1]
    p = k // 2
    xp = F.pad(x, (0, 0, p, p, p, p, p, p))
    gf = g.reshape(-1, co)
    dw = x.new_empty((k, k, k, ci, co))
    for kx in range(k):
        for ky in range(k):
            for kz in range(k):
                xs = xp[:, kx:kx + d, ky:ky + h, kz:kz + w, :].reshape(-1, ci)
                dw[kx, ky, kz] = xs.t() @ gf
    return dw.permute(4, 3, 0, 1, 2).contiguous()


def _ndhwc_wgrad_cuda(x, g, k):
    _check([x, g], "conv3d_ndhwc_wgrad")
    b, r, r2, r3, ci = x.shape
    co = g.shape[-1]
    if k != 3:
        raise ValueError(f"conv3d_ndhwc_wgrad kernel takes 3x3x3 taps, got "
                         f"k={k}")
    if not r == r2 == r3 or tuple(g.shape) != (b, r, r, r, co):
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(g.shape)} are "
                         "not matching cubic grids")
    x, g = x.contiguous(), g.contiguous()
    bins = r ** 3
    # split-K: voxel chunks per cloud, as K4's
    tiles = (math.ceil(27 * ci / _WGRAD_TILE_M)
             * math.ceil(co / _WGRAD_TILE_N))
    per_cloud = max(1, math.ceil(_WGRAD_BLOCKS / (tiles * b)))
    chunk = _WGRAD_SLICE * math.ceil(bins / per_cloud / _WGRAD_SLICE)
    chunks = math.ceil(bins / chunk)
    partial = torch.empty((b * chunks, 27 * ci, co), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        kernels.launch(
            "conv3d_ndhwc_wgrad", "pvcnn_conv3d_ndhwc_wgrad", x.data_ptr(),
            g.data_ptr(), partial.data_ptr(), b, ci, co, r, chunk,
            torch.cuda.current_stream().cuda_stream)
    # the slices summed in a fixed order: reproducible bit for bit
    w_taps = partial.sum(dim=0)
    return w_taps.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2).contiguous()
