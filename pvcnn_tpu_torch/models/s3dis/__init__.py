from pvcnn_tpu_torch.models.s3dis.pointnet import PointNet
from pvcnn_tpu_torch.models.s3dis.pvcnn import PVCNN
from pvcnn_tpu_torch.models.s3dis.pvcnnpp import PVCNN2

__all__ = ["PVCNN", "PVCNN2", "PointNet"]
