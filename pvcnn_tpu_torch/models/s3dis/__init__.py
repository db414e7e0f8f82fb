"""The S3DIS models and their recipes, as the JAX package's configs set them
(configs/s3dis/__init__.py and {pvcnn,pvcnn2,pointnet}/__init__.py): 13
classes, windows of 9 channels (6 extra: rgb and the room-normalized
coordinates), holdout area 5; Adam at lr 1e-3, 50 epochs, batch 32. PVCNN
takes 4,096 points a window, PVCNN2 8,192, PointNet 4,096; PVCNN and
PVCNN2 decay weights by 1e-5 under CosineAnnealingLR(t_max=50), PointNet
by none under MultiStepLR([5, 10, ..., 35], 0.5). The schedules keep the
configs' t_max whatever the number of epochs run, as a JAX run with
another num_epochs does. The JAX PVCNN config's train-step presort is a
layout of the JAX trainer and has no counterpart here.
"""

from typing import Callable, NamedTuple

from pvcnn_tpu_torch.models.s3dis.pointnet import PointNet
from pvcnn_tpu_torch.models.s3dis.pvcnn import PVCNN
from pvcnn_tpu_torch.models.s3dis.pvcnnpp import PVCNN2
from pvcnn_tpu_torch.train.optim import CosineAnnealingLR, MultiStepLR

__all__ = ["BATCH_SIZE", "EPOCHS", "EXTRA_FEATURE_CHANNELS", "HOLDOUT_AREA",
           "LR", "MODELS", "NUM_CLASSES", "PVCNN", "PVCNN2", "PointNet",
           "S3DISModel", "save_path"]

NUM_CLASSES, EXTRA_FEATURE_CHANNELS, HOLDOUT_AREA = 13, 6, 5
EPOCHS, BATCH_SIZE, LR = 50, 32, 1e-3


class S3DISModel(NamedTuple):
    """An S3DIS model as its config makes it: `build(width_multiplier)` ->
    module, the points of a window, Adam's weight decay, `scheduler()` ->
    the lr schedule, and the widths of its configs (configs/s3dis/<name>/
    area5/c*.py; none where the model has one config)."""

    build: Callable
    num_points: int
    weight_decay: float
    scheduler: Callable
    widths: tuple


def _builder(cls):
    def build(width_multiplier=1.0):
        return cls(NUM_CLASSES, EXTRA_FEATURE_CHANNELS,
                   width_multiplier=width_multiplier)
    return build


def _cosine():
    return CosineAnnealingLR(t_max=EPOCHS)


MODELS = {
    "pvcnn": S3DISModel(_builder(PVCNN), 4096, 1e-5, _cosine,
                        (1.0, 0.25, 0.125)),
    "pvcnn2": S3DISModel(_builder(PVCNN2), 8192, 1e-5, _cosine, (1.0, 0.5)),
    "pointnet": S3DISModel(
        _builder(PointNet), 4096, 0.0,
        lambda: MultiStepLR(milestones=[5, 10, 15, 20, 25, 30, 35],
                            gamma=0.5), ()),
}


def save_path(model: str, width_multiplier: float = 1.0,
              holdout_area: int = HOLDOUT_AREA) -> str:
    """The JAX train.py's save path of the model's config: runs/s3dis.
    <model>.area<holdout>[.c<width>] (c1, c0p25, ...), without the width
    for a model of one config at width 1."""
    path = f"runs/s3dis.{model}.area{holdout_area}"
    if MODELS[model].widths or width_multiplier != 1.0:
        path += ".c" + f"{width_multiplier:g}".replace(".", "p")
    return path
