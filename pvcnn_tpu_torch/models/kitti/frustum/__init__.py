"""The KITTI Frustum models and their recipes, as the JAX package's configs
set them (configs/kitti/__init__.py, configs/kitti/frustum/__init__.py and
{pvcnne,pointnet2,pointnet}.py): 3 classes (Car, Pedestrian, Cyclist),
frustums of 1,024 points with 1 extra channel, 512 points an object, 12
heading bins and the 8 size templates of data/kitti/attributes.py; Adam at
lr 1e-3 for 209 epochs, batch 32 (24 for pointnet2), CosineAnnealingLR
(StepLR(25, 0.5) for pointnet), and FrustumPointNetLoss at the weights
1 / 10 / 20 / 20."""

from typing import Callable, NamedTuple

from pvcnn_tpu_torch.data.kitti import attributes
from pvcnn_tpu_torch.models.kitti.frustum.box_estimation import (
    BoxEstimationPointNet, BoxEstimationPointNet2, CenterRegressionNet)
from pvcnn_tpu_torch.models.kitti.frustum.frustum_net import (
    FrustumNet, FrustumPointNet, FrustumPointNet2, FrustumPVCNNE)
from pvcnn_tpu_torch.models.kitti.frustum.segmentation import (
    InstanceSegmentationNet, InstanceSegmentationPointNet,
    InstanceSegmentationPointNet2, InstanceSegmentationPVCNN)
from pvcnn_tpu_torch.nn.frustum import FrustumPointNetLoss
from pvcnn_tpu_torch.train.optim import CosineAnnealingLR, StepLR

__all__ = ["BoxEstimationPointNet", "BoxEstimationPointNet2",
           "CLASSES", "CenterRegressionNet", "EPOCHS",
           "EXTRA_FEATURE_CHANNELS", "FrustumModel", "FrustumNet",
           "FrustumPVCNNE", "FrustumPointNet", "FrustumPointNet2",
           "InstanceSegmentationNet", "InstanceSegmentationPVCNN",
           "InstanceSegmentationPointNet", "InstanceSegmentationPointNet2",
           "LR", "MODELS", "NUM_HEADING_ANGLE_BINS", "NUM_POINTS",
           "NUM_POINTS_PER_OBJECT", "criterion"]

CLASSES = ("Car", "Pedestrian", "Cyclist")
NUM_POINTS, EXTRA_FEATURE_CHANNELS = 1024, 1
NUM_POINTS_PER_OBJECT, NUM_HEADING_ANGLE_BINS = 512, 12
EPOCHS, LR = 209, 1e-3


class FrustumModel(NamedTuple):
    """A Frustum model as its config makes it: `build(width_multiplier)`
    -> module, its batch size, and `scheduler(epochs)` -> its schedule."""

    build: Callable
    batch_size: int
    scheduler: Callable


def _builder(factory):
    def build(width_multiplier=1.0):
        templates = attributes.size_templates()
        return factory(len(CLASSES), NUM_HEADING_ANGLE_BINS, len(templates),
                       NUM_POINTS_PER_OBJECT, templates,
                       extra_feature_channels=EXTRA_FEATURE_CHANNELS,
                       width_multiplier=width_multiplier)
    return build


MODELS = {
    "pvcnne": FrustumModel(_builder(FrustumPVCNNE), 32,
                           lambda epochs: CosineAnnealingLR(t_max=epochs)),
    "pointnet2": FrustumModel(_builder(FrustumPointNet2), 24,
                              lambda epochs: CosineAnnealingLR(t_max=epochs)),
    "pointnet": FrustumModel(_builder(FrustumPointNet), 32,
                             lambda epochs: StepLR(step_size=25, gamma=0.5)),
}


def criterion() -> FrustumPointNetLoss:
    """The configs' loss: FrustumPointNetLoss over NH bins and the 8 size
    templates, weights 1 / 10 / 20 / 20."""
    templates = attributes.size_templates()
    return FrustumPointNetLoss(NUM_HEADING_ANGLE_BINS, len(templates),
                               templates, box_loss_weight=1.0,
                               corners_loss_weight=10.0,
                               heading_residual_loss_weight=20.0,
                               size_residual_loss_weight=20.0)
