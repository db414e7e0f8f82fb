"""Eval-mode prediction (counterpart of pvcnn_tpu/train/trainer.py:
Trainer._eval_step_impl and Trainer.predict).

The JAX evaluator runs at fp32 matmul precision for checkpoint parity. On an
H100 torch would run convolutions (cuDNN) in TF32 by default, so prediction
turns TF32 off for both matmuls and cuDNN while it runs, and restores the
previous settings after.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

__all__ = ["fp32_precision", "predict"]


@contextlib.contextmanager
def fp32_precision():
    """Full-fp32 matmuls and convolutions (TF32 off) inside the block."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def predict(model: nn.Module, inputs):
    """Eval-mode forward of a [B, N, C] batch -> softmax probabilities over
    the last axis, in fp32. A model with dict inputs and outputs (the
    Frustum models, whose foreground sampler draws in eval mode too) gives
    its output dict as it is."""
    model.eval()
    with torch.inference_mode(), fp32_precision():
        outputs = model(inputs)
        if isinstance(outputs, dict):
            return outputs
        return torch.softmax(outputs, dim=-1)
