"""Training loop, evaluation and checkpoints (counterpart of
pvcnn_tpu/train/trainer.py: Trainer.train_epoch / evaluate and
save/load/copy_checkpoint).

The step is the JAX trainer's: train-mode forward (batch-statistic
BatchNorms, dropout), criterion, backward, optimizer update. Losses stay on
the device and are fetched once per epoch, not once per step, so the host
never waits on the card inside an epoch. Dropout draws from a
torch.Generator on the model's device that the Trainer owns, seeded with
`seed`; a model that samples (the Frustum models' foreground sampler) draws
from a second one, seeded apart (the JAX trainer's `sample` stream,
has_sample_rng), in training and evaluation alike. Inputs and targets are
arrays, or dicts of arrays (the Frustum batches); outputs a tensor or a
dict of tensors. fp32 throughout with TF32 off
(train/predict.py:fp32_precision).

A checkpoint is {"epoch", "model": state_dict, "optimizer": state_dict,
"meters"}; its `model` entry carries the reference's module names, so
pvcnn_tpu/utils/checkpoint_import.py:import_state_dict maps it into JAX
variables.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch
import torch.nn as nn

from pvcnn_tpu_torch.models.utils import (set_dropout_generator,
                                          set_sample_generator)
from pvcnn_tpu_torch.train.optim import set_learning_rate
from pvcnn_tpu_torch.train.predict import fp32_precision

__all__ = ["SAMPLE_SEED_OFFSET", "Trainer", "copy_checkpoint",
           "load_checkpoint", "save_checkpoint"]

# the sampler's generator is seeded with seed + SAMPLE_SEED_OFFSET, apart
# from the dropout generator's seed
SAMPLE_SEED_OFFSET = 0x5A3D1E


class Trainer:
    def __init__(self, model: nn.Module, criterion, optimizer,
                 device="cuda", seed: int = 0):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.criterion = criterion
        self.optimizer = optimizer
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        set_dropout_generator(self.model, self.generator)
        self.sample_generator = torch.Generator(device=self.device)
        self.sample_generator.manual_seed(int(seed) + SAMPLE_SEED_OFFSET)
        set_sample_generator(self.model, self.sample_generator)

    def _to_device(self, array):
        if isinstance(array, dict):
            return {k: self._to_device(v) for k, v in array.items()}
        return torch.from_numpy(np.asarray(array)).to(self.device)

    def train_step(self, inputs: torch.Tensor, targets: torch.Tensor):
        """One update on a device batch -> the loss, still on the device."""
        self.model.train()
        with fp32_precision():
            loss = self.criterion(self.model(inputs), targets)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
        return loss.detach()

    def train_epoch(self, loader, epoch: int, scheduler=None,
                    max_steps: int | None = None) -> float:
        """Train one epoch at the scheduler's lr for `epoch` (at most
        `max_steps` steps) -> the mean loss, fetched once."""
        if scheduler is not None:
            set_learning_rate(self.optimizer, scheduler(epoch))
        loader.epoch = epoch
        losses = []
        for inputs, targets in loader:
            if max_steps is not None and len(losses) >= max_steps:
                break
            losses.append(self.train_step(self._to_device(inputs),
                                          self._to_device(targets)))
        if not losses:
            return 0.0
        return float(torch.stack(losses).mean().item())

    def evaluate(self, loader, meters: dict) -> dict:
        """Eval-mode forward over the loader, each meter updated with the
        outputs of every batch (numpy; a dict of them for a dict output) ->
        {name: meter.compute()}."""
        self.model.eval()
        with torch.inference_mode(), fp32_precision():
            for inputs, targets in loader:
                outputs = _to_numpy(self.model(self._to_device(inputs)))
                for meter in meters.values():
                    meter.update(outputs, targets)
        return {k: meter.compute() for k, meter in meters.items()}


def _to_numpy(outputs):
    if isinstance(outputs, dict):
        return {k: v.cpu().numpy() for k, v in outputs.items()}
    return outputs.cpu().numpy()


def save_checkpoint(path: str, epoch: int, model: nn.Module, optimizer,
                    meters: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"epoch": int(epoch), "model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "meters": {k: float(v) for k, v in (meters or {}).items()}},
               tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, model: nn.Module, optimizer=None):
    """Restore the model (and the optimizer, if given) -> (epoch, meters)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    return int(payload["epoch"]), dict(payload.get("meters", {}))


def copy_checkpoint(src: str, dst: str) -> None:
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    shutil.copyfile(src, dst)
