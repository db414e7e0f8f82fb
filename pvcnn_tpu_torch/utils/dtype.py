"""The activation-dtype policy (the JAX modules' `dtype` setting): which
dtypes a module takes, the refusal where only fp32 is ported, and the
widening of a bf16 operand to f32 that the plain versions and the losses
compute in."""

from __future__ import annotations

import torch

__all__ = ["fp32_only", "resolve_dtype", "wide"]


def resolve_dtype(dtype) -> torch.dtype | None:
    """A module's activation dtype: None, "float32" or torch.float32 -> None
    (the fp32 path: no casts); "bfloat16" or torch.bfloat16 ->
    torch.bfloat16."""
    if dtype is None:
        return None
    named = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    dt = named.get(dtype) if isinstance(dtype, str) else dtype
    if dt == torch.float32:
        return None
    if dt == torch.bfloat16:
        return torch.bfloat16
    raise ValueError(f"activation dtype must be float32 or bfloat16, got "
                     f"{dtype!r}")


def fp32_only(dtype, what: str) -> None:
    """Refuse bf16 activations where the port runs only fp32 (ROADMAP.md,
    Queue 1: the rest of bf16), rather than run fp32 quietly."""
    if resolve_dtype(dtype) is not None:
        raise NotImplementedError(
            f"{what} runs float32 activations only; bf16 activations are "
            "ported for ShapeNet PVCNN, S3DIS PVCNN2, S3DIS PVCNN and "
            "ShapeNet PointNet++ SSG / MSG, on every branch the switches "
            "open, and the rest is queued in ROADMAP.md (Queue 1)")


def wide(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor widened to f32; any other as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t
