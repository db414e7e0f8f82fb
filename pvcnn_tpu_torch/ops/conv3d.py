"""Fused conv3d forward on flat voxel rows (counterpart of the forward of
pvcnn_tpu/ops/pallas/conv_rows.py:conv3d_rows_act).

y = conv3d(a(x), weight) + bias, stride 1, zero padding k // 2, where
a(x) = leaky_relu(x * pscale + pshift, 0.1) with the prologue (the previous
BatchNorm's folded affine and LeakyReLU) and a(x) = x without it. Out-of-grid
taps read 0 after the activation.

`conv3d_rows_act` is the dispatch point of kernel K3
(pvcnn_tpu_torch/csrc/conv3d.cu): a CUDA tensor goes to the kernel, a CPU
tensor to the plain version beside it (`_conv3d_plain`: the activation, then
`F.conv3d`). The TPU kernel's BN-statistics epilogue serves training only and
is not part of this forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pvcnn_tpu_torch import kernels

__all__ = ["conv3d_rows_act", "leaky_affine"]

# the prologue's scale/shift live in the kernel's shared memory
# (8 bytes per input channel beside its 24 KB of static tiles)
_MAX_PROLOGUE_CI = 2048


def leaky_affine(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor):
    """leaky_relu(x * scale + shift, 0.1) on [B, C, ...] with per-channel
    scale/shift [C]."""
    shape = (-1,) + (1,) * (x.dim() - 2)
    return F.leaky_relu(x * scale.reshape(shape) + shift.reshape(shape), 0.1)


def conv3d_rows_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    pscale: torch.Tensor | None, pshift: torch.Tensor | None,
                    resolution: int, has_prologue: bool):
    """x [B, Ci, R^3] raw rows, weight [Co, Ci, k, k, k] (torch Conv3d
    layout), bias [Co], pscale/pshift [Ci] (read only with has_prologue) ->
    y [B, Co, R^3]. The flat row index is x * R^2 + y * R + z."""
    if x.device.type == "cpu":
        return _conv3d_plain(x, weight, bias, pscale, pshift, resolution,
                             has_prologue)
    return _conv3d_cuda(x, weight, bias, pscale, pshift, resolution,
                        has_prologue)


def _conv3d_plain(x, weight, bias, pscale, pshift, resolution, has_prologue):
    r = int(resolution)
    b, ci, _ = x.shape
    k = weight.shape[-1]
    if has_prologue:
        x = leaky_affine(x, pscale, pshift)
    y = F.conv3d(x.reshape(b, ci, r, r, r), weight, bias, padding=k // 2)
    return y.reshape(b, weight.shape[0], r ** 3)


def _conv3d_cuda(x, weight, bias, pscale, pshift, resolution, has_prologue):
    r = int(resolution)
    tensors = [x, weight, bias] + ([pscale, pshift] if has_prologue else [])
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("conv3d kernel needs every operand on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("conv3d kernel takes float32 operands, got "
                         f"{[t.dtype for t in tensors]}")
    b, ci, bins = x.shape
    co = weight.shape[0]
    if tuple(weight.shape) != (co, ci, 3, 3, 3):
        raise ValueError("conv3d kernel takes a 3x3x3 weight [Co, "
                         f"{ci}, 3, 3, 3], got {tuple(weight.shape)}")
    if bins != r ** 3 or tuple(bias.shape) != (co,):
        raise ValueError(f"x {tuple(x.shape)} / bias {tuple(bias.shape)} do "
                         f"not match R={r}, Co={co}")
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
    with torch.cuda.device(x.device):
        kernels.launch(
            "conv3d_fwd", "pvcnn_conv3d_fwd", x.data_ptr(), w_taps.data_ptr(),
            bias.data_ptr(), *pro, y.data_ptr(), b, ci, co, r,
            int(has_prologue), torch.cuda.current_stream().cuda_stream)
    return y
