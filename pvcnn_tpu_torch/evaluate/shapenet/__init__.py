from pvcnn_tpu_torch.evaluate.shapenet.eval import evaluate

__all__ = ["evaluate"]
