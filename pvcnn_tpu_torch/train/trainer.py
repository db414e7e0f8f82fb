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

The learning rate is set once per epoch (scheduler_unit "epoch") or
before every step from a step count that runs on across epochs ("iter"),
as the JAX trainer's `_step_count`. A step may return a dict of named
losses; the epoch then returns a dict of their means.

DMLTrainer (deep mutual learning, the JAX package's DMLTrainer) trains
two peers of one architecture at once: each one's loss adds
KL(softmax(peer) || softmax(own)) with the peer's logits detached. Each
peer runs one train-mode forward a step, so its BatchNorm running
statistics move once and its dropout masks are drawn once, as in the
reference's step (JAX runs a second forward for the gradient, which XLA
merges with the first, and keeps only its statistics).

fit is the entry points' epoch loop (the JAX train.py's and
train_dml.py's): resume, train, score every peer, write the checkpoints.

A checkpoint is {"epoch", "model": state_dict, "optimizer": state_dict,
"meters"}; its `model` entry carries the reference's module names, so
pvcnn_tpu/utils/checkpoint_import.py:import_state_dict maps it into JAX
variables.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch
import torch.nn as nn

from pvcnn_tpu_torch.models.utils import (set_dropout_generator,
                                          set_sample_generator)
from pvcnn_tpu_torch.train.optim import set_learning_rate
from pvcnn_tpu_torch.train.predict import fp32_precision

__all__ = ["DMLTrainer", "SAMPLE_SEED_OFFSET", "STUDENT_SEED_OFFSET",
           "Trainer", "check_device", "copy_checkpoint", "fit",
           "load_checkpoint", "save_checkpoint"]

# the sampler's generator is seeded with seed + SAMPLE_SEED_OFFSET, apart
# from the dropout generator's seed
SAMPLE_SEED_OFFSET = 0x5A3D1E
# a DML student's generators are seeded with seed + STUDENT_SEED_OFFSET,
# apart from the teacher's
STUDENT_SEED_OFFSET = 100


def check_device(device) -> torch.device:
    """torch.device(device), refusing cuda where CUDA is not available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but CUDA is not available")
    return device


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
        # steps taken by this trainer, across epochs (scheduler_unit "iter")
        self.step_count = 0

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

    def set_learning_rate(self, lr: float) -> None:
        set_learning_rate(self.optimizer, lr)

    def train_epoch(self, loader, epoch: int, scheduler=None,
                    max_steps: int | None = None,
                    scheduler_unit: str = "epoch"):
        """Train one epoch (at most `max_steps` steps) -> the mean loss, or
        a dict of mean losses where the step returns named ones, fetched
        once. The scheduler gives the lr for `epoch` (scheduler_unit
        "epoch") or, before each step, for the trainer's step count
        ("iter")."""
        if scheduler_unit not in ("epoch", "iter"):
            raise ValueError(f"unknown scheduler_unit {scheduler_unit!r}")
        if scheduler is not None and scheduler_unit == "epoch":
            self.set_learning_rate(scheduler(epoch))
        loader.epoch = epoch
        losses = []
        for inputs, targets in loader:
            if max_steps is not None and len(losses) >= max_steps:
                break
            if scheduler is not None and scheduler_unit == "iter":
                self.set_learning_rate(scheduler(self.step_count))
            losses.append(self.train_step(self._to_device(inputs),
                                          self._to_device(targets)))
            self.step_count += 1
        if not losses:
            return 0.0
        if isinstance(losses[0], dict):
            names = sorted(losses[0])
            means = torch.stack([torch.stack([loss[k] for k in names])
                                 for loss in losses]).mean(0).tolist()
            return dict(zip(names, means))
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


class DMLTrainer(Trainer):
    """Deep mutual learning (pvcnn_tpu/train/trainer.py:DMLTrainer): the
    teacher is this Trainer's own model and optimizer, the student a Trainer
    of its own whose generators are seeded with seed +
    STUDENT_SEED_OFFSET (the two hold what the JAX DMLState threads
    through its step). A step returns {"loss/train", "loss/train_student"};
    the scheduler sets both optimizers' lr. `evaluate` scores the teacher,
    `self.student.evaluate` the student."""

    def __init__(self, model: nn.Module, criterion, optimizer,
                 student: nn.Module, student_optimizer, criterion_dml,
                 device="cuda", seed: int = 0):
        super().__init__(model, criterion, optimizer, device, seed)
        self.criterion_dml = criterion_dml
        self.student = Trainer(student, criterion, student_optimizer, device,
                               int(seed) + STUDENT_SEED_OFFSET)

    def set_learning_rate(self, lr: float) -> None:
        set_learning_rate(self.optimizer, lr)
        set_learning_rate(self.student.optimizer, lr)

    def losses(self, inputs, targets):
        """Both peers' train-mode forward, once each -> (teacher loss,
        student loss): each CE(own) + KL(peer detached, own)."""
        self.model.train()
        self.student.model.train()
        out_t = self.model(inputs)
        out_s = self.student.model(inputs)
        return (self.criterion(out_t, targets)
                + self.criterion_dml(out_s.detach(), out_t),
                self.student.criterion(out_s, targets)
                + self.criterion_dml(out_t.detach(), out_s))

    def train_step(self, inputs, targets):
        """One update of both peers: their losses, one backward (the two
        graphs share nothing), both optimizers step -> the named losses,
        still on the device."""
        with fp32_precision():
            loss_t, loss_s = self.losses(inputs, targets)
            self.optimizer.zero_grad(set_to_none=True)
            self.student.optimizer.zero_grad(set_to_none=True)
            (loss_t + loss_s).backward()
            self.optimizer.step()
            self.student.optimizer.step()
        return {"loss/train": loss_t.detach(),
                "loss/train_student": loss_s.detach()}


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


def fit(trainer: Trainer, train_loader, eval_loader, make_meters, metrics,
        *, epochs: int, save_path: str, scheduler=None,
        scheduler_unit: str = "epoch", max_steps: int | None = None,
        timings: dict | None = None) -> dict:
    """Train `trainer` to `epochs` epochs and score `eval_loader` with fresh
    `make_meters()` after each, for every peer: the trainer itself and, for
    a DMLTrainer, its student, whose meters print with a _student suffix.
    An iter schedule's cosine t_max is stretched by the steps in an epoch.

    Checkpoints, in the JAX entry points' layout under `save_path`: each
    peer's latest (latest.pth.tar, the student's latest.pth.tar.student)
    and, on a new best of metrics[0], best.pth.tar (best_student.pth.tar);
    the trainer's of every epoch at latest/e{N}.pth.tar and, on a new best
    of each metric m, at best/best.{m with / as .}.pth.tar. A save path
    that holds latest.pth.tar resumes every peer, its bests and the step
    count. `timings`, if given, gets the seconds of the epochs' training
    (to the mean loss on the host) and of their scoring under "train" and
    "eval". -> {peer suffix ("" or "_student"): its last meters, with each
    metric's best under m + "_best"}."""
    peers = {"": trainer}
    if isinstance(trainer, DMLTrainer):
        peers["_student"] = trainer.student
    steps = len(train_loader)
    if max_steps is not None:
        steps = min(steps, max_steps)
    if scheduler_unit == "iter" and hasattr(scheduler, "t_max"):
        scheduler.t_max = epochs * steps

    latest = os.path.join(save_path, "latest.pth.tar")
    paths = {tag: latest + ("." + tag[1:] if tag else "") for tag in peers}
    best = {tag: dict.fromkeys(metrics) for tag in peers}
    start = 0
    if os.path.exists(latest):
        print(f'==> loading checkpoint "{latest}"')
        for tag, peer in peers.items():
            if os.path.exists(paths[tag]):
                epoch, saved = load_checkpoint(paths[tag], peer.model,
                                               peer.optimizer)
                best[tag] = {m: saved.get(m + "_best") for m in metrics}
                if not tag:
                    start = epoch + 1
        trainer.step_count = start * steps

    def evaluate() -> dict:
        return {tag: peer.evaluate(eval_loader, make_meters())
                for tag, peer in peers.items()}

    def report(scores: dict) -> None:
        for tag, meters in scores.items():
            for k, v in meters.items():
                print(f"[{k}{tag}] = {v:2f}")

    if start >= epochs:                   # finished: report once
        scores = evaluate()
        report(scores)
        return scores

    for epoch in range(start, epochs):
        print(f"\n==> training epoch {epoch}/{epochs}")
        begin = time.perf_counter()
        loss = trainer.train_epoch(train_loader, epoch, scheduler,
                                   max_steps, scheduler_unit)
        seconds = time.perf_counter() - begin
        if not isinstance(loss, dict):
            loss = {"loss/train": loss}
        for k in sorted(loss):
            print(f"[{k}] = {loss[k]:.6f}")
        print(f"[seconds] = {seconds:.3f}")
        begin = time.perf_counter()
        scores = evaluate()
        if timings is not None:
            timings["train"] = timings.get("train", 0.0) + seconds
            timings["eval"] = (timings.get("eval", 0.0)
                               + time.perf_counter() - begin)
        is_best = {}
        for tag, meters in scores.items():
            for m in metrics:
                is_best[tag, m] = (best[tag][m] is None
                                   or best[tag][m] < meters[m])
                if is_best[tag, m]:
                    best[tag][m] = meters[m]
                meters[m + "_best"] = best[tag][m]
        report(scores)
        for tag, peer in peers.items():
            save_checkpoint(paths[tag], epoch, peer.model, peer.optimizer,
                            scores[tag])
            if is_best[tag, metrics[0]]:
                copy_checkpoint(paths[tag],
                                os.path.join(save_path, f"best{tag}.pth.tar"))
        copy_checkpoint(latest, os.path.join(save_path, "latest",
                                             f"e{epoch}.pth.tar"))
        for m in metrics:
            if is_best["", m]:
                copy_checkpoint(latest, os.path.join(
                    save_path, "best",
                    "best.{}.pth.tar".format(m.replace("/", "."))))
        print(f"[save_path] = {save_path}")
    return scores
