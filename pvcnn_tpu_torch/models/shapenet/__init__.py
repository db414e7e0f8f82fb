from pvcnn_tpu_torch.models.shapenet.pvcnn import PVCNN

__all__ = ["PVCNN"]
