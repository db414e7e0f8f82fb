from typing import Callable, NamedTuple

from pvcnn_tpu_torch.models.shapenet.pointnet import PointNet
from pvcnn_tpu_torch.models.shapenet.pointnetpp import (PointNet2,
                                                        PointNet2MSG,
                                                        PointNet2SSG,
                                                        pointnet2_msg,
                                                        pointnet2_ssg)
from pvcnn_tpu_torch.models.shapenet.pvcnn import PVCNN

__all__ = ["MODELS", "PVCNN", "PointNet", "PointNet2", "PointNet2MSG",
           "PointNet2SSG", "ShapeNetModel", "pointnet2_msg", "pointnet2_ssg"]


class ShapeNetModel(NamedTuple):
    """A ShapeNet model as the JAX package's config makes it: `build`
    (num_classes, num_shapes, width_multiplier) -> module, and the input
    columns its dataset gives it after xyz."""

    build: Callable
    with_normal: bool
    with_one_hot_shape_id: bool


# configs/shapenet/{pvcnn/c1, pointnet, pointnet2ssg, pointnet2msg}.py
MODELS = {
    "pvcnn": ShapeNetModel(
        lambda c, s, r: PVCNN(c, s, 3, width_multiplier=r), True, True),
    "pointnet": ShapeNetModel(
        lambda c, s, r: PointNet(c, s, extra_feature_channels=0,
                                 width_multiplier=r), False, True),
    "pointnet2ssg": ShapeNetModel(
        lambda c, s, r: pointnet2_ssg(c, s, 3, width_multiplier=r), True,
        False),
    "pointnet2msg": ShapeNetModel(
        lambda c, s, r: pointnet2_msg(c, s, 3, width_multiplier=r), True,
        True),
}
