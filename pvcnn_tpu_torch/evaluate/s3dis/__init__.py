from pvcnn_tpu_torch.evaluate.s3dis.eval import evaluate

__all__ = ["evaluate"]
