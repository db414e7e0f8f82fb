"""pvcnn_tpu_torch: the PyTorch and CUDA port of pvcnn_tpu for NVIDIA Hopper.

The JAX package `pvcnn_tpu` stays the reference; this package mirrors its
module paths and names. Public ops keep the JAX layouts (point features
[B, N, C], coords [B, N, 3], grids [B, R, R, R, C]); module names keep the
reference's torch names, so `state_dict()` matches released checkpoints.
Every TPU kernel on the ported path is a hand-written CUDA kernel
(`csrc/`, built and loaded by `kernels`), with a plain PyTorch version
beside it that CPU tensors use.
"""

__version__ = "0.1.0"
