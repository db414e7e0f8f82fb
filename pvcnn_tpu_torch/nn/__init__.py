from pvcnn_tpu_torch.nn.conv3d import Conv3dSame
from pvcnn_tpu_torch.nn.frustum import FrustumPointNetLoss, get_box_corners_3d
from pvcnn_tpu_torch.nn.pointnet import (BallQuery, PointNetAModule,
                                         PointNetFPModule, PointNetSAModule)
from pvcnn_tpu_torch.nn.pvconv import PVConv, SE3d, Voxelization
from pvcnn_tpu_torch.nn.shared_mlp import (BatchNorm, Dense2d, DenseBNReLU,
                                           SharedMLP, SplitDense)

__all__ = ["BallQuery", "BatchNorm", "Conv3dSame", "Dense2d", "DenseBNReLU",
           "FrustumPointNetLoss", "PVConv", "PointNetAModule",
           "PointNetFPModule", "PointNetSAModule", "SE3d", "SharedMLP",
           "SplitDense", "Voxelization", "get_box_corners_3d"]
