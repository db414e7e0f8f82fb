"""The evaluators (counterpart of pvcnn_tpu/evaluate/)."""

import os

__all__ = ["configured_model"]


def configured_model(configs):
    """The model configs.model() builds, with the weights of
    configs.evaluate.best_checkpoint_path (the port's training checkpoint
    or a reference .pth.tar: a trusted file, it is unpickled) -> it, or
    None where the checkpoint is missing (printed)."""
    from pvcnn_tpu_torch.utils.weights import load_reference_checkpoint

    checkpoint = configs.evaluate.best_checkpoint_path
    if not os.path.exists(checkpoint):
        print(f"==> no checkpoint at {checkpoint}")
        return None
    print(f'==> loading checkpoint "{checkpoint}"')
    return load_reference_checkpoint(configs.model(), checkpoint)
