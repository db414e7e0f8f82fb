"""Row gather with a scatter-sum backward (counterpart of
pvcnn_tpu/ops/gather_utils.py:take_rows).

The forward is a plain `torch.gather` on both devices (an XLA gather in the
JAX package, not a Pallas kernel). The backward is `scatter_sum`
(ops/voxelize.py): on a CUDA tensor kernel K1 in its sum mode, on a CPU
tensor `scatter_add_`, as the JAX custom VJP routes it through the one-hot
scatter kernel. It serves grouping, the FPS gather and the three-NN
interpolation, whose reference backwards are these scatter-adds. A bf16
cotangent (bf16 activations) takes K1's bf16 sum mode (`scatter_sum_bf16`)
on the card: f32 sums rounded to bf16 once, as the JAX backward's
`_scatter_sum(g, idx, m).astype(g.dtype)`.
"""

from __future__ import annotations

import torch

from pvcnn_tpu_torch.ops.voxelize import scatter_sum

__all__ = ["take_rows"]


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [B, M, C], idx [B, K] int -> [B, K, C] (rows table[b, idx[b, k]]).
    Differentiable in table."""
    return _TakeRows.apply(table, idx)


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.num_rows = table.shape[1]
        ctx.save_for_backward(idx)
        return torch.gather(table, 1, idx.long()[..., None].expand(
            -1, -1, table.shape[2]))

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        return scatter_sum(g, idx, ctx.num_rows), None
