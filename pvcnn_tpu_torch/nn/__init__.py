from pvcnn_tpu_torch.nn.conv3d import Conv3dSame
from pvcnn_tpu_torch.nn.pvconv import PVConv, SE3d, Voxelization
from pvcnn_tpu_torch.nn.shared_mlp import BatchNorm, SharedMLP, SplitDense

__all__ = ["BatchNorm", "Conv3dSame", "PVConv", "SE3d", "SharedMLP",
           "SplitDense", "Voxelization"]
