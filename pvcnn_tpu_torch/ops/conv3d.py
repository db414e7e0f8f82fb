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

bf16 activations (a bfloat16 x and weight; bias, pscale and pshift stay
float32): the kernels' bf16 mode (csrc/conv3d_bf16.cu: wgmma on TMA-fed
rings, counted as conv3d_fwd_bf16, conv3d_dgrad_bf16 and
conv3d_wgrad_bf16) on the card, on the CPU the plain versions on the
operands widened to f32. The kernels read their operands staged as [B,
Cp / 8, R^3, 8] (_stage_bf16); the op keeps the forward's staged a(x)
for K4 and stages the cotangent once for the dgrad and K4 (the wrappers'
`staged` dict). The rounding points are the JAX package's
(pvcnn_tpu/ops/pallas/conv_rows.py):

  forward  a(x) in f32, rounded to bf16 before the product (_stage_act);
           f32 products and sums; the f32 bias added to the f32 sum; the
           statistics from it; y rounded to bf16 once (_fwd_act_kernel)
  backward the cotangent with the statistics' terms in f32, its bias sum in
           f32, then rounded to bf16 (_act_bwd: ge); the dgrad's output
           rounded to bf16 (_run_fwd's out dtype); the prologue's backward
           in f32 on it, dx rounded to bf16, dscale and dshift f32; dW
           summed in f32 and rounded to bf16 once (dw.astype(kernel.dtype)),
           which the caller's weight.to(bfloat16) widens back to f32

`conv3d_same` is the NDHWC conv of the unfused voxel branch
(PVCNN_TPU_CONV_ROWS=0) with its custom weight gradient
(PVCNN_TPU_CUSTOM_CONV_WGRAD=1), counterpart of pvcnn_tpu/nn/conv3d.py:
conv3d_same, on channel-last grids [B, R, R, R, C]:

  forward  F.conv3d on the permuted (channels_last_3d) grid, both devices
  dgrad    F.conv3d of the cotangent with flipped, io-swapped taps
           (the JAX package runs these two as XLA convs, outside any
           Pallas kernel)
  wgrad    K11 (csrc/conv3d_ndhwc_wgrad.cu, K4's design on channel-last
           operands, K4's plan); plain: 27 shifted-slice products, the JAX
           package's own fallback

On bf16 x and weight (the NDHWC branch with bf16 activations) the convs
are cuDNN's bf16 convs on the card (f32 sums, the output rounded to bf16
once; on the CPU the f32 conv of the widened operands, rounded), and the
weight gradient is K11's bf16 mode (counted as conv3d_ndhwc_wgrad_bf16):
K4's bf16 core (csrc/conv3d_bf16.cu) reading x and dY in place by 5-d
tensor maps (an operand whose channels are not whole 16-byte pieces, x at
Ci = 9, copied into K4's staged layout by a channel-last staging pass
first), dW summed in f32 in a fixed order and rounded to bf16 once, as the JAX package's
dw.astype(kernel.dtype) with a bf16 kernel (pvcnn_tpu/nn/conv3d.py:65-75);
plain: the 27 products on the widened operands, rounded once. The JAX
package runs its Pallas kernel only where conv3d_wgrad_plan plans (on a
TPU, grids of (R + 2)^3 >= 16,384 voxels) and the same 27 products in XLA
elsewhere, both f32 sums rounded once: one function, which the port runs
by K11 at every R.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from pvcnn_tpu_torch import kernels
from pvcnn_tpu_torch.utils.dtype import wide

__all__ = ["conv3d_ndhwc", "conv3d_rows_act", "conv3d_same",
           "leaky_affine"]

# K3's voxels per warp (statistics slots)
_FWD_TILE_V = 128
# K3 fills the card with at least this many waves of blocks (3 per SM, its
# __launch_bounds__) before it splits its reduction, into at most
# _FWD_SPLITS blocks
_FWD_WAVES, _FWD_BLOCKS_PER_SM, _FWD_SPLITS = 2, 3, 8
# K4 (and K11, its channel-last twin): voxels per slice of its reduction;
# at most _K4_THREADS threads per block (3 * cb * columns / 8), about
# _K4_WARPS_PER_SM warps resident per SM (the registers of
# __launch_bounds__(192, 2)); it splits the reduction so that its blocks
# fill at most _K4_WAVES waves, no split under _K4_MIN_SLICES slices
_K4_SLICE, _K4_THREADS, _K4_WARPS_PER_SM = 32, 192, 12
_K4_WAVES, _K4_MIN_SLICES = 2, 8


def leaky_affine(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor):
    """leaky_relu(x * scale + shift, 0.1) on [B, C, ...] with per-channel
    scale/shift [C]. A bf16 x is computed in f32 and the result rounded to
    bf16 (pvcnn_tpu/nn/pvconv.py:142-145)."""
    if x.dtype == torch.bfloat16:
        return leaky_affine(x.float(), scale, shift).to(x.dtype)
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
    and pshift. A bfloat16 x takes a bfloat16 weight and returns a bfloat16
    y (the statistics stay float32)."""
    return _Conv3dRowsAct.apply(x, weight, bias, pscale, pshift,
                                int(resolution), bool(has_prologue),
                                bool(want_stats))


class _Conv3dRowsAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, pscale, pshift, resolution,
                has_prologue, want_stats):
        fwd = _forward_plain if x.device.type == "cpu" else _forward_cuda
        staged = {}
        y, s1, s2 = fwd(x, weight, bias, pscale, pshift, resolution,
                        has_prologue, want_stats, staged=staged)
        ctx.resolution = resolution
        ctx.has_prologue = has_prologue
        ctx.want_stats = want_stats
        # the bf16 kernels' staged a(x), kept for K4: it saves K4 a staging
        # pass for 6% more peak memory at 1x (PERF.md, section 6)
        keep = ((staged["xt"],) if "xt" in staged and ctx.needs_input_grad[1]
                else ())
        ctx.save_for_backward(x, weight, pscale, pshift,
                              y if want_stats else None, *keep)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, weight, pscale, pshift, y, *xt = ctx.saved_tensors
        r, pro = ctx.resolution, ctx.has_prologue
        need_x, need_w, need_b, need_s, need_t = ctx.needs_input_grad[:5]
        cpu = x.device.type == "cpu"
        # a bf16 operand widened to f32, rounded back to x's dtype where the
        # JAX package rounds (the module docstring)
        gy = wide(gy)
        # the statistics' cotangents fold into y's: s1 = sum(y),
        # s2 = sum(y^2) => dL/dy += gs1 + 2 * y * gs2 (y biased)
        if ctx.want_stats:
            gy = gy + gs1[None, :, None] + 2.0 * wide(y) * gs2[None, :, None]
        dx = dw = dbias = dscale = dshift = None
        if need_b:
            dbias = gy.sum(dim=(0, 2))
        gy = gy.to(x.dtype).contiguous()
        # the bf16 kernels' staged operands: the forward's a(x), and the
        # cotangent, staged once for the dgrad and K4
        staged = {"xt": xt[0]} if xt else {}
        if need_x or (pro and (need_s or need_t)):
            # d loss / d a(x) at every grid voxel
            dxt = (_dgrad_plain if cpu else _dgrad_cuda)(gy, weight, r,
                                                         staged=staged)
            if pro:
                xf, dxw = wide(x), wide(dxt)
                t = xf * pscale[:, None] + pshift[:, None]
                dxf = dxw * torch.where(t > 0, 1.0, 0.1).to(dxw.dtype)
                dx = (dxf * pscale[:, None]).to(x.dtype) if need_x else None
                dscale = (dxf * xf).sum(dim=(0, 2)) if need_s else None
                dshift = dxf.sum(dim=(0, 2)) if need_t else None
            else:
                dx = dxt
        if need_w:
            dw = (_wgrad_plain if cpu else _wgrad_cuda)(
                x, gy, pscale, pshift, r, pro, staged=staged)
        return dx, dw, dbias, dscale, dshift, None, None, None


# ---- plain versions (CPU tensors; chip_smoke.py's comparison on the card) --
# A bf16 operand is widened to f32 and the result rounded where the bf16
# kernels round (the module docstring). They take the kernel wrappers'
# arguments; `staged` (the bf16 kernels' staged copies) is not read.

def _activated(x, pscale, pshift, has_prologue):
    """a(x) in f32, rounded to x's dtype (the bf16 kernels' prologue pass),
    widened back to f32; x itself without the prologue."""
    if not has_prologue:
        return x.float()
    return leaky_affine(x.float(), pscale, pshift).to(x.dtype).float()


def _forward_plain(x, weight, bias, pscale, pshift, resolution, has_prologue,
                   want_stats, staged=None):
    if x.dtype == torch.bfloat16:
        y = _conv3d_plain(_activated(x, pscale, pshift, has_prologue),
                          weight.float(), bias, None, None, resolution, False)
    else:
        y = _conv3d_plain(x, weight, bias, pscale, pshift, resolution,
                          has_prologue)
    if want_stats:
        return (y.to(x.dtype),) + _stats_plain(y)
    zeros = y.new_zeros(y.shape[1])
    return y.to(x.dtype), zeros, zeros.clone()


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


def _dgrad_plain(gy, weight, resolution, staged=None):
    r = int(resolution)
    b, co, _ = gy.shape
    dx = F.conv3d(wide(gy.reshape(b, co, r, r, r)),
                  wide(_dgrad_weight(weight)),
                  padding=weight.shape[-1] // 2)
    return dx.reshape(b, weight.shape[1], r ** 3).to(gy.dtype)


def _wgrad_plain(x, gy, pscale, pshift, resolution, has_prologue,
                 staged=None):
    """dW[co, ci, tap] = sum over clouds and voxels of g[co, v] * a(x)[ci,
    v + tap], the activated input zero-padded, one product per tap."""
    r = int(resolution)
    b, ci, _ = x.shape
    co = gy.shape[1]
    if x.dtype == torch.bfloat16:
        a = _activated(x, pscale, pshift, has_prologue)
    else:
        a = leaky_affine(x, pscale, pshift) if has_prologue else x
    ap = F.pad(a.reshape(b, ci, r, r, r), (1, 1, 1, 1, 1, 1))
    g = wide(gy)
    dw = a.new_empty((co, ci, 3, 3, 3))
    for tx in range(3):
        for ty in range(3):
            for tz in range(3):
                xs = ap[:, :, tx:tx + r, ty:ty + r, tz:tz + r].reshape(
                    b, ci, r ** 3)
                dw[:, :, tx, ty, tz] = torch.tensordot(g, xs,
                                                       dims=([0, 2], [0, 2]))
    return dw.to(x.dtype)


# ---- kernels (CUDA tensors) ------------------------------------------------

def _check(tensors, what, bf16=()):
    """Every operand on one CUDA device and float32, or, where `bf16` names
    the kernel's bf16 mode, the first len(bf16) operands bfloat16 (the
    activations and the weight) and the rest float32."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} kernel needs every operand on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    want = [torch.float32] * len(tensors)
    if bf16 and tensors[0].dtype == torch.bfloat16:
        want[:len(bf16)] = [torch.bfloat16] * len(bf16)
    got = [t.dtype for t in tensors]
    if got != want:
        modes = f"float32 operands ({what})"
        if bf16:
            modes += (f", or bfloat16 {' and '.join(bf16)} with the rest "
                      f"float32 ({what}_bf16)")
        raise ValueError(f"{what} kernel takes {modes}, got {got}")


def _check_conv(x, weight, r):
    b, ci, bins = x.shape
    co = weight.shape[0]
    if tuple(weight.shape) != (co, ci, 3, 3, 3):
        raise ValueError("conv3d kernel takes a 3x3x3 weight [Co, "
                         f"{ci}, 3, 3, 3], got {tuple(weight.shape)}")
    if bins != r ** 3:
        raise ValueError(f"x {tuple(x.shape)} does not match R={r}")
    return b, ci, co, bins


def _fwd_plan(b, ci, co, r, sms):
    """K3's launch on a card of `sms` SMs -> (wm, splits). The block tile is
    16 * wm output channels x 512 / wm voxels: wm = 2 where Co <= 32 (no
    half of a 64-channel tile multiplies zero weights), else 4. Where the
    blocks fill fewer than _FWD_WAVES waves, the 27 * Ci reduction is split
    over `splits` blocks per tile: the count whose last wave is fullest,
    the smaller on a tie."""
    wm = 2 if co <= 32 else 4
    blocks = (b * math.ceil(co / (16 * wm))
              * math.ceil(r ** 3 / (_FWD_TILE_V * 4 // wm)))
    slots = _FWD_BLOCKS_PER_SM * sms
    if blocks >= _FWD_WAVES * slots:
        return wm, 1
    most = min(_FWD_SPLITS, math.ceil(27 * ci / 16))
    return wm, min(range(1, most + 1),
                   key=lambda s: (math.ceil(blocks * s / slots) / s, s))


class WgradPlan(NamedTuple):
    """K4's launch (csrc/conv3d_wgrad.cu), and K11's."""

    seg: int            # z-segment length L: 8, 16 or 32
    cols: int           # output channels per block: 32 or 64
    cb: int             # input channels per block (27 * cb rows)
    tiles: int          # blocks per split: row tiles x column tiles
    slices: int         # 32-voxel slices of the B * R^3 reduction
    splits: int         # blocks per tile, each an equal run of slices
    partial_bytes: int  # the split partials [splits, Co, Ci, 27] (0: none)

    @property
    def tile(self) -> str:
        return f"{27 * self.cb}x{self.cols}"

    @property
    def per_split(self) -> int:
        return math.ceil(self.slices / self.splits)


@functools.lru_cache(maxsize=None)
def _wgrad_plan(b, ci, co, r, sms) -> WgradPlan:
    """K4's launch on a card of `sms` SMs. The reduction runs over
    z-segments of L = 8, 16 or 32 voxels (the least at least R, 32 above),
    32 / L per slice, across the clouds; a block takes all 27 taps of cb
    input channels against 32 output channels where Co <= 32, else 64, with
    3 * cb * cols / 8 <= 192 threads, cb the same in every row tile. The
    slices are split over `splits` blocks per tile: the count whose last
    wave is fullest within _K4_WAVES waves of resident blocks, the smaller
    on a tie, no split shorter than _K4_MIN_SLICES slices (one block per
    tile where even that is too long)."""
    seg = 8 if r <= 8 else 16 if r <= 16 else 32
    cols = 32 if co <= 32 else 64
    row_tiles = math.ceil(ci / (_K4_THREADS // (3 * cols // 8)))
    cb = math.ceil(ci / row_tiles)
    tiles = row_tiles * math.ceil(co / cols)
    segs = b * r * r * math.ceil(r / seg)
    slices = math.ceil(segs * seg / _K4_SLICE)
    warps = math.ceil(3 * cb * cols // 8 / 32)
    slots = max(1, _K4_WARPS_PER_SM // warps) * sms
    most = max(1, min(slices // _K4_MIN_SLICES,
                      math.ceil(_K4_WAVES * slots / tiles)))
    splits = min(range(1, most + 1),
                 key=lambda s: (math.ceil(tiles * s / slots) / s, s))
    # equal runs of ceil(slices / splits): none of them empty
    splits = math.ceil(slices / math.ceil(slices / splits))
    partial = 4 * splits * 27 * ci * co if splits > 1 else 0
    return WgradPlan(seg, cols, cb, tiles, slices, splits, partial)


# K11's staging of x (csrc/conv3d_ndhwc_wgrad.cu: Layout)
_NDHWC_LAYOUTS = {"last_rows": 1, "last_slots": 2}


def _ndhwc_layout(ci, plan) -> str:
    """How K11 stages x: z-slots of channel quads by 16-byte copies where
    Ci and cb are multiples of 4 (and x is aligned), else K4's rows, of x
    transposed to channel-major by the wrapper
    (csrc/conv3d_ndhwc_wgrad.cu)."""
    return ("last_slots" if ci % 4 == 0 and plan.cb % 4 == 0
            else "last_rows")


@functools.lru_cache(maxsize=None)
@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_fwd(kernel, x, w_taps, bias, pro, y, partial, b, ci, co, r):
    """pro: the prologue's (scale, shift, activated-input buffer) pointers,
    or three Nones."""
    wm, splits = _fwd_plan(b, ci, co, r, _sm_count(x.device.index))
    # the split reduction's partial outputs, summed by the kernel's second
    # pass in a fixed order
    ypart = (torch.empty((splits, b, co, r ** 3), dtype=torch.float32,
                         device=x.device) if splits > 1 else None)
    with torch.cuda.device(x.device):
        kernels.launch(
            kernel, "pvcnn_conv3d_fwd", x.data_ptr(), w_taps.data_ptr(),
            bias.data_ptr(), *pro, y.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if ypart is None else ypart.data_ptr(), b, ci, co, r, wm,
            splits, torch.cuda.current_stream().cuda_stream)


def _forward_cuda(x, weight, bias, pscale, pshift, resolution, has_prologue,
                  want_stats, staged=None):
    """staged: a dict that receives a bf16 x's staged a(x) as "xt" (K4's
    operand, csrc/conv3d_bf16.cu's layout)."""
    r = int(resolution)
    _check([x, weight, bias] + ([pscale, pshift] if has_prologue else []),
           "conv3d_fwd", bf16=("x", "weight"))
    if x.dtype == torch.bfloat16:
        y, s1, s2, xt = _forward_cuda_bf16(x, weight, bias, pscale, pshift, r,
                                           has_prologue, want_stats)
        if staged is not None:
            staged["xt"] = xt
        return y, s1, s2
    b, ci, co, bins = _check_conv(x, weight, r)
    if tuple(bias.shape) != (co,):
        raise ValueError(f"bias {tuple(bias.shape)} does not match Co={co}")
    if has_prologue and (pscale.shape != (ci,) or pshift.shape != (ci,)):
        raise ValueError(f"prologue scale/shift must be [{ci}]")
    x, bias = x.contiguous(), bias.contiguous()
    # tap-major [27 * Ci, Co] (the JAX [k, k, k, Ci, Co] layout, flattened)
    w_taps = weight.permute(2, 3, 4, 1, 0).reshape(27 * ci, co).contiguous()
    if has_prologue:
        pscale, pshift = pscale.contiguous(), pshift.contiguous()
        # the prologue's pass writes the activated input here
        xact = torch.empty_like(x)
        pro = (pscale.data_ptr(), pshift.data_ptr(), xact.data_ptr())
    else:
        pro = (None, None, None)
    y = torch.empty((b, co, bins), dtype=torch.float32, device=x.device)
    # one statistics slot per (cloud, 128-voxel tile of a warp), summed in
    # a fixed order
    partial = (torch.empty((2, co, b * math.ceil(bins / _FWD_TILE_V)),
                           dtype=torch.float32, device=x.device)
               if want_stats else None)
    _launch_fwd("conv3d_fwd", x, w_taps, bias, pro, y, partial, b, ci, co, r)
    if want_stats:
        s1, s2 = partial.sum(dim=2)
    else:
        s1 = torch.zeros(co, dtype=torch.float32, device=x.device)
        s2 = torch.zeros_like(s1)
    return y, s1, s2


def _dgrad_cuda(gy, weight, resolution, staged=None):
    """staged: a dict that holds, or receives, a bf16 gy's staged copy as
    "gt" (shared with K4)."""
    r = int(resolution)
    _check([gy, weight], "conv3d_dgrad", bf16=("dy", "weight"))
    if gy.dtype == torch.bfloat16:
        return _dgrad_cuda_bf16(gy, weight, r,
                                {} if staged is None else staged)
    wt = _dgrad_weight(weight)                         # [Ci, Co, 3, 3, 3]
    b, co, ci, bins = _check_conv(gy, wt, r)
    gy = gy.contiguous()
    w_taps = wt.permute(2, 3, 4, 1, 0).reshape(27 * co, ci).contiguous()
    zero_bias = torch.zeros(ci, dtype=torch.float32, device=gy.device)
    dx = torch.empty((b, ci, bins), dtype=torch.float32, device=gy.device)
    _launch_fwd("conv3d_dgrad", gy, w_taps, zero_bias, (None, None, None),
                dx, None, b, co, ci, r)
    return dx


def _wgrad_cuda(x, gy, pscale, pshift, resolution, has_prologue,
                staged=None):
    """staged: a dict that may hold a bf16 a(x)'s and gy's staged copies as
    "xt" and "gt" (csrc/conv3d_bf16.cu's layout)."""
    r = int(resolution)
    _check([x, gy] + ([pscale, pshift] if has_prologue else []),
           "conv3d_wgrad", bf16=("x", "dy"))
    if x.dtype == torch.bfloat16:
        return _wgrad_cuda_bf16(x, gy, pscale, pshift, r, has_prologue,
                                {} if staged is None else staged)
    b, ci, bins = x.shape
    co = gy.shape[1]
    if bins != r ** 3 or tuple(gy.shape) != (b, co, bins):
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(gy.shape)} do "
                         f"not match R={r}")
    if has_prologue and (pscale.shape != (ci,) or pshift.shape != (ci,)):
        raise ValueError(f"prologue scale/shift must be [{ci}]")
    dw = torch.empty((co, ci, 3, 3, 3), dtype=torch.float32, device=x.device)
    if b == 0 or r == 0:                 # no voxels: nothing to launch
        return dw.zero_()
    x, gy = x.contiguous(), gy.contiguous()
    if has_prologue:
        pscale, pshift = pscale.contiguous(), pshift.contiguous()
        # the prologue's pass writes the activated input here
        xact = torch.empty_like(x)
        pro = (pscale.data_ptr(), pshift.data_ptr(), xact.data_ptr())
    else:
        pro = (None, None, None)
    plan = _wgrad_plan(b, ci, co, r, _sm_count(x.device.index))
    # the split partials, summed by the kernel's second pass in a fixed
    # order: reproducible bit for bit
    partial = (torch.empty((plan.splits, co, ci, 27), dtype=torch.float32,
                           device=x.device) if plan.splits > 1 else None)
    with torch.cuda.device(x.device):
        kernels.launch(
            "conv3d_wgrad", "pvcnn_conv3d_wgrad", x.data_ptr(),
            gy.data_ptr(), *pro,
            None if partial is None else partial.data_ptr(), dw.data_ptr(),
            b, ci, co, r, plan.seg, plan.cols, plan.cb, plan.splits,
            torch.cuda.current_stream().cuda_stream)
    return dw


# ---- the bf16 mode of K3 and K4 (csrc/conv3d_bf16.cu) -----------------------

def _ptr(t):
    return None if t is None else t.data_ptr()


def _round16(c):
    return -(-c // 16) * 16


def _bf16_tiles(r):
    """K3's bf16 output tiles (one statistics slot each) and K4's bf16
    reduction chunks per cloud of an R^3 grid: 2 x 8 x 8 voxels (x, y, z)."""
    return math.ceil(r / 2) * math.ceil(r / 8) ** 2


def _stage_bf16(x, pscale=None, pshift=None):
    """x [B, C, R^3] bf16 on the card -> the staged operand [B, Cp / 8, R^3,
    8] of K3's and K4's bf16 modes: 8-channel groups, a voxel's 8 channels
    fastest, Cp = C rounded up to 16 (zeros past C); with pscale/pshift
    a(x), rounded to bf16 once."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError("the bf16 staging pass takes a bfloat16 tensor on "
                         f"a CUDA device, got {x.dtype} on {x.device}")
    b, c, bins = x.shape
    xt = torch.empty((b, _round16(c) // 8, bins, 8), dtype=torch.bfloat16,
                     device=x.device)
    with torch.cuda.device(x.device):
        kernels.call("pvcnn_conv3d_bf16_stage", x.data_ptr(), _ptr(pscale),
                     _ptr(pshift), xt.data_ptr(), b, c, bins,
                     torch.cuda.current_stream().cuda_stream)
    return xt


def _k3_bf16_cols(co):
    """K3's bf16 output channels a block (wgmma's N): the least of 16, 32,
    64 that holds Co, else 128 (ceil(Co / 128) blocks)."""
    return next((n for n in (16, 32, 64) if co <= n), 128)


def _launch_fwd_bf16(kernel, x, pro, xt, weight, flip, bias, y, stats, r):
    """K3's bf16 mode, one launcher call: x [B, Ci, R^3] staged into xt
    [B, Cp / 8, R^3, 8] (pro: the prologue's (scale, shift) or two Nones),
    or xt given staged (x None); weight [Co, Ci, 3, 3, 3] (flip: the
    forward's [Ci, Co, 3, 3, 3], taps reversed: the data gradient) laid
    out for the kernel; y [B, Co, R^3]; stats [2, Co] or None (the
    BatchNorm sums)."""
    b, co = y.shape[:2]
    ci = weight.shape[0 if flip else 1]
    n = _k3_bf16_cols(co)
    ws = torch.empty(-(-co // n) * n * _round16(ci) * 27,
                     dtype=torch.bfloat16, device=y.device)
    # one statistics slot per (cloud, tile), added in a fixed order
    partial = (torch.empty((2, co, b * _bf16_tiles(r)), dtype=torch.float32,
                           device=y.device) if stats is not None else None)
    with torch.cuda.device(y.device):
        kernels.launch(
            kernel, "pvcnn_conv3d_bf16_fwd", _ptr(x), *(_ptr(t) for t in pro),
            xt.data_ptr(), weight.data_ptr(), ws.data_ptr(), _ptr(bias),
            y.data_ptr(), _ptr(partial), _ptr(stats), b, ci, co, r, n,
            int(flip), torch.cuda.current_stream().cuda_stream)


def _forward_cuda_bf16(x, weight, bias, pscale, pshift, r, has_prologue,
                       want_stats):
    """-> (y, s1, s2, the staged a(x))"""
    b, ci, co, bins = _check_conv(x, weight, r)
    if tuple(bias.shape) != (co,):
        raise ValueError(f"bias {tuple(bias.shape)} does not match Co={co}")
    if has_prologue and (pscale.shape != (ci,) or pshift.shape != (ci,)):
        raise ValueError(f"prologue scale/shift must be [{ci}]")
    pro = ((pscale.contiguous(), pshift.contiguous()) if has_prologue
           else (None, None))
    x = x.contiguous()
    dev = x.device
    y = torch.empty((b, co, bins), dtype=torch.bfloat16, device=dev)
    xt = torch.empty((b, _round16(ci) // 8, bins, 8), dtype=torch.bfloat16,
                     device=dev)
    stats = (torch.empty((2, co), dtype=torch.float32, device=dev)
             if want_stats and b else
             torch.zeros((2, co), dtype=torch.float32, device=dev))
    _launch_fwd_bf16("conv3d_fwd_bf16", x, pro, xt, weight.contiguous(),
                     False, bias.contiguous(), y,
                     stats if want_stats else None, r)
    return y, stats[0], stats[1], xt


def _dgrad_cuda_bf16(gy, weight, r, staged):
    """staged["gt"]: gy staged (K4 shares it), here if not given."""
    b, co, bins = gy.shape
    ci = weight.shape[1]
    if tuple(weight.shape) != (co, ci, 3, 3, 3) or bins != r ** 3:
        raise ValueError(f"dy {tuple(gy.shape)} does not match the weight "
                         f"{tuple(weight.shape)} at R={r}")
    dx = torch.empty((b, ci, bins), dtype=torch.bfloat16, device=gy.device)
    x = None
    if "gt" not in staged:
        x = gy.contiguous()
        staged["gt"] = torch.empty((b, _round16(co) // 8, bins, 8),
                                   dtype=torch.bfloat16, device=gy.device)
    _launch_fwd_bf16("conv3d_dgrad_bf16", x, (None, None), staged["gt"],
                     weight.contiguous(), True, None, dx, None, r)
    return dx


class WgradBf16Plan(NamedTuple):
    """K4's bf16 launch (csrc/conv3d_bf16.cu: conv3d_bf16_wgrad_kernel)."""

    cols: int        # input channels of one warpgroup product: 16, 32, 64
    col_blocks: int  # column blocks a Co tile: Cp / 16 (cols 16: 27 taps a
    #                  block), else 3 * Cp / cols (one dx plane a block)
    co_tiles: int    # 64-channel tiles of Co
    chunks: int      # 2 x 8 x 8-voxel chunks of the reduction, B * tiles
    splits: int      # blocks a (column block, Co tile): runs of chunks
    per_split: int   # chunks a run (the last may be shorter, none empty)


@functools.lru_cache(maxsize=None)
def _wgrad_bf16_plan(b, ci, co, r, sms) -> WgradBf16Plan:
    """K4's bf16 launch on a card of `sms` SMs. A block holds one 64-row
    tile of Co against its columns (all 27 taps of 16 input channels where
    Cp is an odd multiple of 16, else a dx plane of 32 or 64 channels) and
    takes one SM (its ring: 117-168 KB); the B * tiles chunks are split
    into equal runs so that the blocks fill one wave, the splits' f32
    partials added in split order."""
    cp = _round16(ci)
    cols = 64 if cp % 64 == 0 else 32 if cp % 32 == 0 else 16
    col_blocks = cp // 16 if cols == 16 else 3 * cp // cols
    co_tiles = math.ceil(co / 64)
    chunks = b * _bf16_tiles(r)
    want = min(chunks, max(1, sms // (col_blocks * co_tiles)))
    per = math.ceil(chunks / want)
    return WgradBf16Plan(cols, col_blocks, co_tiles, chunks,
                         math.ceil(chunks / per), per)


def _wgrad_cuda_bf16(x, gy, pscale, pshift, r, has_prologue, staged):
    """staged["xt"], ["gt"]: a(x) and gy staged (the forward's and the
    dgrad's copies), here if not given."""
    b, ci, bins = x.shape
    co = gy.shape[1]
    if bins != r ** 3 or tuple(gy.shape) != (b, co, bins):
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(gy.shape)} do "
                         f"not match R={r}")
    if has_prologue and (pscale.shape != (ci,) or pshift.shape != (ci,)):
        raise ValueError(f"prologue scale/shift must be [{ci}]")
    dw = torch.empty((co, ci, 3, 3, 3), dtype=torch.bfloat16,
                     device=x.device)
    if b == 0 or r == 0:                 # no voxels: nothing to launch
        return dw.zero_()
    xt, gt = staged.get("xt"), staged.get("gt")
    if xt is None:
        pro = ((pscale.contiguous(), pshift.contiguous()) if has_prologue
               else (None, None))
        xt = _stage_bf16(x.contiguous(), *pro)
    if gt is None:
        gt = _stage_bf16(gy.contiguous())
    plan = _wgrad_bf16_plan(b, ci, co, r, _sm_count(x.device.index))
    # each split's f32 partial, added in split order by the kernel's second
    # pass: reproducible bit for bit
    partial = torch.empty((plan.splits, co, _round16(ci), 27),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        kernels.launch(
            "conv3d_wgrad_bf16", "pvcnn_conv3d_bf16_wgrad", xt.data_ptr(),
            gt.data_ptr(), partial.data_ptr(), dw.data_ptr(), b, ci, co, r,
            plan.cols, plan.splits, plan.per_split,
            torch.cuda.current_stream().cuda_stream)
    return dw


# ---- NDHWC conv with its custom weight gradient ----------------------------

def conv3d_same(x: torch.Tensor, weight: torch.Tensor):
    """x [B, R, R, R, Ci] channel-last grid, weight [Co, Ci, k, k, k] (torch
    Conv3d layout, odd k) -> [B, R, R, R, Co]: stride 1, zero padding
    k // 2, no bias. Differentiable in x and weight."""
    return _Conv3dSame.apply(x, weight)


def conv3d_ndhwc(x: torch.Tensor, weight: torch.Tensor):
    """x [B, R, R, R, Ci] * weight [Co, Ci, k, k, k] -> [B, R, R, R, Co]
    (stride 1, zero padding k // 2, no bias), differentiable by torch's
    autograd: bf16 operands on the card by cuDNN's bf16 conv, on the CPU
    widened to f32 and the output rounded to bf16 (one rounding of the f32
    sums, as on the card)."""
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return conv3d_ndhwc(x.float(), weight.float()).to(x.dtype)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight,
                 padding=weight.shape[-1] // 2)
    return y.permute(0, 2, 3, 4, 1)


class _Conv3dSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return conv3d_ndhwc(x, weight)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad
        dx = dw = None
        if need_x:
            dx = conv3d_ndhwc(g, _dgrad_weight(weight))
        if need_w:
            wgrad = (_ndhwc_wgrad_plain if x.device.type == "cpu"
                     else _ndhwc_wgrad_cuda)
            dw = wgrad(x, g, weight.shape[-1])
        return dx, dw


def _ndhwc_wgrad_plain(x, g, k):
    """dW[co, ci, kx, ky, kz] = sum over clouds and voxels of
    xpad[b, v + (kx, ky, kz), ci] * g[b, v, co], one product per tap; bf16
    operands widened, the f32 sums rounded to bf16 once."""
    if x.dtype == torch.bfloat16:
        return _ndhwc_wgrad_plain(x.float(), wide(g), k).to(x.dtype)
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
    _check([x, g], "conv3d_ndhwc_wgrad", bf16=("x", "dy"))
    b, r, r2, r3, ci = x.shape
    co = g.shape[-1]
    if k != 3:
        raise ValueError(f"conv3d_ndhwc_wgrad kernel takes 3x3x3 taps, got "
                         f"k={k}")
    if not r == r2 == r3 or tuple(g.shape) != (b, r, r, r, co):
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(g.shape)} are "
                         "not matching cubic grids")
    if x.dtype == torch.bfloat16:
        return _ndhwc_wgrad_cuda_bf16(x, g, r)
    dw = torch.empty((co, ci, 3, 3, 3), dtype=torch.float32, device=x.device)
    if b == 0 or r == 0:                 # no voxels: nothing to launch
        return dw.zero_()
    g = g.contiguous()
    plan = _wgrad_plan(b, ci, co, r, _sm_count(x.device.index))
    layout = _ndhwc_layout(ci, plan)
    if layout == "last_slots":
        x = x.contiguous()
    if layout == "last_rows" or x.data_ptr() % 16:
        # x's rows as K4 stages them: channel-major [B, Ci, R^3]
        layout = "last_rows"
        x = x.permute(0, 4, 1, 2, 3).contiguous()
    # the split partials, summed by the kernel's second pass in a fixed
    # order: reproducible bit for bit
    partial = (torch.empty((plan.splits, co, ci, 27), dtype=torch.float32,
                           device=x.device) if plan.splits > 1 else None)
    with torch.cuda.device(x.device):
        kernels.launch(
            "conv3d_ndhwc_wgrad", "pvcnn_conv3d_ndhwc_wgrad", x.data_ptr(),
            g.data_ptr(), None if partial is None else partial.data_ptr(),
            dw.data_ptr(), b, ci, co, r, plan.seg, plan.cols, plan.cb,
            plan.splits, _NDHWC_LAYOUTS[layout],
            torch.cuda.current_stream().cuda_stream)
    return dw


def _stage_last_bf16(x):
    """x [B, R, R, R, C] bf16 on the card -> K4's bf16 staged operand [B,
    Cp / 8, R^3, 8] (Cp = C rounded up to 16, zeros past C), by the
    channel-last staging pass: no transpose, a voxel's 8-channel groups
    are 16 contiguous bytes of x."""
    b, c = x.shape[0], x.shape[-1]
    bins = x.shape[1] * x.shape[2] * x.shape[3]
    x = x.contiguous()
    xt = torch.empty((b, _round16(c) // 8, bins, 8), dtype=torch.bfloat16,
                     device=x.device)
    context, stream = kernels.launch_on(x.device)
    with context:
        kernels.call("pvcnn_conv3d_bf16_stage_last", x.data_ptr(),
                     xt.data_ptr(), b, c, bins, stream)
    return xt


def _in_place(t):
    """Whether K11's bf16 mode reads the channel-last grid t in place (its
    5-d tensor maps: rows of C channels in whole 16-byte pieces, a 16-byte
    aligned base, contiguous), else from a staged copy."""
    return (t.shape[-1] % 8 == 0 and t.is_contiguous()
            and t.data_ptr() % 16 == 0)


def _ndhwc_wgrad_cuda_bf16(x, g, r, staged=False):
    """K11's bf16 mode: K4's bf16 core and split plan on x and dY -> dW [Co,
    Ci, 3, 3, 3] bf16, each grid read in place where it can be
    (`_in_place`), else copied into K4's staged layout by the channel-last
    staging pass (x at Ci = 9). staged=True stages both and runs K4's own
    launcher (the route before the in-place maps, kept for the tests)."""
    b, ci, co = x.shape[0], x.shape[-1], g.shape[-1]
    dw = torch.empty((co, ci, 3, 3, 3), dtype=torch.bfloat16,
                     device=x.device)
    if b == 0 or r == 0:                 # no voxels: nothing to launch
        return dw.zero_()
    last = 0 if staged else int(_in_place(x)) | 2 * int(_in_place(g))
    xs = x if last & 1 else _stage_last_bf16(x)
    gs = g if last & 2 else _stage_last_bf16(g)
    plan = _wgrad_bf16_plan(b, ci, co, r, _sm_count(x.device.index))
    # each split's f32 partial, added in split order: reproducible bit for
    # bit
    partial = torch.empty((plan.splits, co, _round16(ci), 27),
                          dtype=torch.float32, device=x.device)
    args = (xs.data_ptr(), gs.data_ptr()) + ((last,) if not staged else ())
    context, stream = kernels.launch_on(x.device)
    with context:
        kernels.launch(
            "conv3d_ndhwc_wgrad_bf16",
            "pvcnn_conv3d_bf16_wgrad" if staged
            else "pvcnn_conv3d_bf16_wgrad_last", *args, partial.data_ptr(),
            dw.data_ptr(), b, ci, co, r, plan.cols, plan.splits,
            plan.per_split, stream)
    return dw
