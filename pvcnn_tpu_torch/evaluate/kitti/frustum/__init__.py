from pvcnn_tpu_torch.evaluate.kitti.frustum.eval import evaluate

__all__ = ["evaluate"]
