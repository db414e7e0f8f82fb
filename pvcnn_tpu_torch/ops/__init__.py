"""Point-voxel ops. Each op that holds a kernel dispatches by device: CUDA
tensors go to the hand-written kernel, CPU tensors to its plain PyTorch
version in the same module."""

from pvcnn_tpu_torch.ops.conv3d import conv3d_rows_act, leaky_affine
from pvcnn_tpu_torch.ops.devoxelize import (corner_base_bins, devoxelize_rows,
                                            trilinear_devoxelize)
from pvcnn_tpu_torch.ops.voxelize import (avg_voxelize, flat_voxel_index,
                                          normalize_coords, scatter_mean)

__all__ = ["avg_voxelize", "conv3d_rows_act", "corner_base_bins",
           "devoxelize_rows", "flat_voxel_index", "leaky_affine",
           "normalize_coords", "scatter_mean", "trilinear_devoxelize"]
