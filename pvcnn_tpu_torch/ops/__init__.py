"""Point-voxel and point-set ops. Each op that holds a kernel dispatches by
device: CUDA tensors go to the hand-written kernel, CPU tensors to its plain
PyTorch version in the same module."""

from pvcnn_tpu_torch.ops.conv3d import (conv3d_rows_act, conv3d_same,
                                        leaky_affine)
from pvcnn_tpu_torch.ops.dense_rows import dense_rows_act
from pvcnn_tpu_torch.ops.devoxelize import (corner_base_bins, devoxelize_rows,
                                            trilinear_devoxelize)
from pvcnn_tpu_torch.ops.gather_utils import take_rows
from pvcnn_tpu_torch.ops.interpolate import (nearest_neighbor_interpolate,
                                             three_nn)
from pvcnn_tpu_torch.ops.neighbors import ball_query, grouping
from pvcnn_tpu_torch.ops.sampling import (furthest_point_sample,
                                          furthest_point_sample_indices,
                                          gather, logits_mask,
                                          logits_mask_indices)
from pvcnn_tpu_torch.ops.voxelize import (avg_voxelize, flat_voxel_index,
                                          normalize_coords, scatter_mean,
                                          scatter_sum)

__all__ = ["avg_voxelize", "ball_query", "conv3d_rows_act", "conv3d_same",
           "corner_base_bins", "dense_rows_act", "devoxelize_rows",
           "flat_voxel_index", "furthest_point_sample",
           "furthest_point_sample_indices", "gather", "grouping",
           "leaky_affine", "logits_mask", "logits_mask_indices",
           "nearest_neighbor_interpolate", "normalize_coords",
           "scatter_mean", "scatter_sum", "take_rows", "three_nn",
           "trilinear_devoxelize"]
