"""Frustum-PointNet's multi-task detection loss and the 3-D box corners
(counterpart of pvcnn_tpu/nn/frustum.py; reference modules/frustum.py:
11-124).

Pure functions of (outputs, targets): no learnable state. Tensors are
channel-last, as the models give them: mask_logits [B, N, 2].
"""

from __future__ import annotations

import numpy as np
import torch

from pvcnn_tpu_torch.ops.losses import cross_entropy, huber_loss

__all__ = ["FrustumPointNetLoss", "get_box_corners_3d"]


def get_box_corners_3d(centers: torch.Tensor, headings: torch.Tensor,
                       sizes: torch.Tensor, with_flip: bool = False):
    """Rotated 3-D box corners: centers [B, 3], headings [B], sizes [B, 3]
    (l, w, h) -> corners [B, 3, 8], in the reference's corner order (and,
    with_flip, the corners of the box turned by pi about its y axis)."""
    l, w, h = sizes[:, 0], sizes[:, 1], sizes[:, 2]
    x_c = torch.stack([l, l, -l, -l, l, l, -l, -l], dim=1) * 0.5
    y_c = torch.stack([h, h, h, h, -h, -h, -h, -h], dim=1) * 0.5
    z_c = torch.stack([w, -w, -w, w, w, -w, -w, w], dim=1) * 0.5
    corners = torch.stack([x_c, y_c, z_c], dim=1)                 # [B, 3, 8]
    c, s = torch.cos(headings), torch.sin(headings)
    o, z = torch.ones_like(headings), torch.zeros_like(headings)
    rot = torch.stack([c, z, s, z, o, z, -s, z, c], dim=1).reshape(-1, 3, 3)
    out = torch.matmul(rot, corners) + centers[:, :, None]
    if not with_flip:
        return out
    flip = torch.stack([-c, z, -s, z, o, z, s, z, -c],
                       dim=1).reshape(-1, 3, 3)
    return out, torch.matmul(flip, corners) + centers[:, :, None]


class FrustumPointNetLoss:
    """mask, heading-bin and size-template cross entropies; Huber losses on
    the center distances (knee 2 for `center`, 1 for `center_reg`), on the
    normalized heading and size residuals and on the corner distances (the
    nearer of the box and its flip), weighted as the configs do
    (configs/kitti/frustum/__init__.py: 1 / 10 / 20 / 20)."""

    def __init__(self, num_heading_angle_bins: int, num_size_templates: int,
                 size_templates, box_loss_weight: float = 1.0,
                 corners_loss_weight: float = 10.0,
                 heading_residual_loss_weight: float = 20.0,
                 size_residual_loss_weight: float = 20.0):
        self.num_heading_angle_bins = int(num_heading_angle_bins)
        self.num_size_templates = int(num_size_templates)
        self.size_templates = np.asarray(size_templates).reshape(-1, 3)
        self.box_loss_weight = box_loss_weight
        self.corners_loss_weight = corners_loss_weight
        self.heading_residual_loss_weight = heading_residual_loss_weight
        self.size_residual_loss_weight = size_residual_loss_weight
        self._constants = {}

    def _templates_and_bins(self, dtype, device):
        """The size templates [NS, 3] and the heading bins' centers [NH]
        on `device`, made once a (dtype, device): a copy from the host each
        step would make the host wait for the queued forward."""
        key = (dtype, device)
        if key not in self._constants:
            np_dtype = torch.empty((), dtype=dtype).numpy().dtype
            nh = self.num_heading_angle_bins
            # np.arange in the dtype: the JAX package's bin centers, bit for
            # bit
            self._constants[key] = tuple(
                torch.from_numpy(a).to(device) for a in (
                    self.size_templates.astype(np_dtype),
                    np.arange(0, 2 * np.pi, 2 * np.pi / nh, dtype=np_dtype)))
        return self._constants[key]

    def __call__(self, inputs: dict, targets: dict) -> torch.Tensor:
        nh = self.num_heading_angle_bins
        center = inputs["center"]                                 # [B, 3]
        dev = center.device
        templates, bin_centers = self._templates_and_bins(center.dtype, dev)

        heading_bin_id = targets["heading_bin_id"].long()          # [B]
        size_id = targets["size_template_id"].long()               # [B]
        center_target = targets["center"]                          # [B, 3]
        heading_res_target = targets["heading_residual"]           # [B]
        size_res_target = targets["size_residual"]                 # [B, 3]
        batch = torch.arange(center.shape[0], device=dev)

        mask_loss = cross_entropy(inputs["mask_logits"],
                                  targets["mask_logits"])
        heading_loss = cross_entropy(inputs["heading_scores"], heading_bin_id)
        size_loss = cross_entropy(inputs["size_scores"], size_id)
        center_loss = huber_loss(
            torch.linalg.norm(center_target - center, dim=-1), delta=2.0)
        center_reg_loss = huber_loss(
            torch.linalg.norm(center_target - inputs["center_reg"], dim=-1),
            delta=1.0)

        heading_res_norm = inputs["heading_residuals_normalized"][
            batch, heading_bin_id]                                 # [B]
        heading_res_norm_loss = huber_loss(
            heading_res_norm - heading_res_target / (np.pi / nh), delta=1.0)
        size_res_norm = inputs["size_residuals_normalized"][
            batch, size_id]                                        # [B, 3]
        size_res_norm_loss = huber_loss(
            torch.linalg.norm(size_res_target / templates[size_id]
                              - size_res_norm, dim=-1), delta=1.0)

        heading = (inputs["heading_residuals"][batch, heading_bin_id]
                   + bin_centers[heading_bin_id])
        size = inputs["size_residuals"][batch, size_id] + templates[size_id]
        corners = get_box_corners_3d(center, heading, size)
        corners_target, corners_target_flip = get_box_corners_3d(
            center_target, bin_centers[heading_bin_id] + heading_res_target,
            templates[size_id] + size_res_target, with_flip=True)
        corners_loss = huber_loss(torch.minimum(
            torch.linalg.norm(corners - corners_target, dim=1),
            torch.linalg.norm(corners - corners_target_flip, dim=1)),
            delta=1.0)

        return mask_loss + self.box_loss_weight * (
            center_loss + center_reg_loss + heading_loss + size_loss
            + self.heading_residual_loss_weight * heading_res_norm_loss
            + self.size_residual_loss_weight * size_res_norm_loss
            + self.corners_loss_weight * corners_loss)
