"""Synthetic KITTI frustum batches, in the layout the JAX package's
FrustumKitti dataset (pvcnn_tpu/data/kitti/frustum.py) gives the Frustum
models after its frustum rotation: camera frame (x right, y down, z forward
along the frustum's axis), points [B, N, 4] (xyz and an intensity), the
one-hot class and the box targets. There is no KITTI data in the
repository; these batches drive the models' tests and smoke runs.
"""

from __future__ import annotations

import numpy as np

from pvcnn_tpu_torch.data.kitti import attributes

__all__ = ["angle_to_bin_id", "synthetic_batch"]

# classes (Car, Pedestrian, Cyclist) -> their size template in
# attributes.class_names order
_TEMPLATE_OF_CLASS = (0, 3, 5)


def angle_to_bin_id(angle: float, num_angle_bins: int):
    """bin_id * (2 pi / NH) + residual = angle (mod 2 pi), the residual in
    +-half a bin (pvcnn_tpu/data/kitti/frustum.py:angle_to_bin_id)."""
    angle = angle % (2 * np.pi)
    per_bin = 2 * np.pi / float(num_angle_bins)
    shifted = (angle + per_bin / 2) % (2 * np.pi)
    bin_id = int(shifted / per_bin)
    return bin_id, shifted - (bin_id * per_bin + per_bin / 2)


def synthetic_batch(rng: np.random.RandomState, batch_size: int,
                    num_points: int, num_heading_angle_bins: int = 12,
                    depth=(5.0, 40.0)):
    """-> (inputs {"features" [B, N, 4] float32, "one_hot_vectors" [B, 3]},
    targets {"mask_logits" [B, N], "center" [B, 3], "heading_bin_id" [B],
    "heading_residual" [B], "size_template_id" [B], "size_residual" [B, 3],
    "class_id" [B]}).

    Each frustum holds one object: a box of its class's size template
    (plus a residual of up to 10%) at a depth in `depth` metres, turned
    about y by a uniform heading, holding 30-60% of the points (uniform
    inside it: the mask targets); the other points spread over the frustum
    from 1 m to 1.5 times the object's depth, so most of the cloud is
    sparse. The intensity is uniform in [0, 1)."""
    b, n = batch_size, num_points
    templates = attributes.size_templates()
    features = np.empty((b, n, 4), np.float32)
    mask = np.zeros((b, n), np.int64)
    targets = {k: [] for k in ("center", "heading_bin_id", "heading_residual",
                               "size_template_id", "size_residual",
                               "class_id")}
    one_hot = np.zeros((b, len(_TEMPLATE_OF_CLASS)), np.float32)
    for i in range(b):
        cls = rng.randint(len(_TEMPLATE_OF_CLASS))
        one_hot[i, cls] = 1.0
        size_id = _TEMPLATE_OF_CLASS[cls]
        residual = templates[size_id] * rng.uniform(-0.1, 0.1, 3)
        l, w, h = templates[size_id] + residual
        z = rng.uniform(*depth)
        center = np.array([z * rng.uniform(-0.05, 0.05),
                           1.0 + rng.uniform(-0.3, 0.3), z])
        heading = rng.uniform(0, 2 * np.pi)
        fg = int(n * rng.uniform(0.3, 0.6))
        # inside the box: the rotation of nn/frustum.py:get_box_corners_3d
        local = rng.uniform(-0.5, 0.5, (fg, 3)) * [l, h, w]
        c, s = np.cos(heading), np.sin(heading)
        box = np.stack([c * local[:, 0] + s * local[:, 2], local[:, 1],
                        -s * local[:, 0] + c * local[:, 2]], -1) + center
        # the frustum around it, from 1 m to 1.5 times its depth
        zb = rng.uniform(1.0, 1.5 * z, n - fg)
        half_x = (0.5 * max(l, w) + abs(center[0])) / z + 0.02
        half_y = (0.5 * h + abs(center[1])) / z + 0.02
        back = np.stack([zb * rng.uniform(-half_x, half_x, n - fg),
                         zb * rng.uniform(-half_y, half_y, n - fg), zb], -1)
        order = rng.permutation(n)
        xyz = np.concatenate([box, back])[order]
        mask[i] = (order < fg).astype(np.int64)
        features[i, :, :3] = xyz
        features[i, :, 3] = rng.uniform(0, 1, n)
        bin_id, bin_res = angle_to_bin_id(heading, num_heading_angle_bins)
        for key, value in (("center", center), ("heading_bin_id", bin_id),
                           ("heading_residual", bin_res),
                           ("size_template_id", size_id),
                           ("size_residual", residual), ("class_id", cls)):
            targets[key].append(value)
    targets = {k: np.asarray(v) for k, v in targets.items()}
    for key in ("center", "heading_residual", "size_residual"):
        targets[key] = targets[key].astype(np.float32)
    for key in ("heading_bin_id", "size_template_id", "class_id"):
        targets[key] = targets[key].astype(np.int64)
    targets["mask_logits"] = mask
    return {"features": features, "one_hot_vectors": one_hot}, targets
