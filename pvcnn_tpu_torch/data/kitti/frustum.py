"""KITTI Frustum data (counterpart of pvcnn_tpu/data/kitti/frustum.py;
reference datasets/kitti/frustum.py): the reader of the frustum pickles,
FrustumKitti, with its frustum rotation, flip, depth shift and heading
bins; synthetic frustum batches in the layout the reader gives the
Frustum models after its frustum rotation (camera frame: x right, y down,
z forward along the frustum's axis; points [B, N, 4], xyz and an
intensity; the one-hot class and the box targets); and a synthetic tree
of pickles and label files in the layout of the real data. There is no
KITTI data in the repository: the synthetic batches and trees drive the
tests and smoke runs.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from pvcnn_tpu_torch.data.kitti import attributes

__all__ = ["FrustumKitti", "angle_to_bin_id", "box_corners_np",
           "rotate_points_along_y", "synthetic_batch", "write_synthetic_root"]

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


def box_corners_np(centers, headings, sizes):
    """numpy twin of nn/frustum.py:get_box_corners_3d -> [B, 3, 8]."""
    l, w, h = sizes[:, 0], sizes[:, 1], sizes[:, 2]
    x_c = np.stack([l, l, -l, -l, l, l, -l, -l], axis=1) * 0.5
    y_c = np.stack([h, h, h, h, -h, -h, -h, -h], axis=1) * 0.5
    z_c = np.stack([w, -w, -w, w, w, -w, -w, w], axis=1) * 0.5
    corners = np.stack([x_c, y_c, z_c], axis=1)
    c, s = np.cos(headings), np.sin(headings)
    o, z = np.ones_like(headings), np.zeros_like(headings)
    rot = np.stack([c, z, s, z, o, z, -s, z, c], axis=1).reshape(-1, 3, 3)
    return np.matmul(rot, corners) + centers[:, :, None]


def rotate_points_along_y(features, rotation_angle):
    """Rotate the xz-plane coordinates of [n, >= 3] points (camera frame: z
    forward, x right, y down) in place by `rotation_angle` -> features."""
    c, s = np.cos(rotation_angle), np.sin(rotation_angle)
    rotation_matrix_transpose = [[c, s], [-s, c]]
    features[:, [0, 2]] = np.dot(features[:, [0, 2]],
                                 rotation_matrix_transpose)
    return features


class _FrustumKittiDataset:
    """One split of the frustum pickles. Items are (inputs {"features"
    [num_points, 4] float32, "one_hot_vectors" [num_classes]}, targets):
    the box targets of synthetic_batch's items, or for the rgb-detection
    split {"rotation_angle", "rgb_score"}. Each item resamples num_points
    of the frustum's points with replacement and, where asked, flips x and
    shifts the depth, drawing from `rng` in the order the JAX reader draws
    from numpy's global state (choice, then random for the flip, then
    randn for the shift)."""

    def __init__(self, root, num_points, split, classes,
                 num_heading_angle_bins, class_name_to_size_template_id,
                 rng, from_rgb_detection=False, random_flip=False,
                 random_shift=False, frustum_rotate=False):
        assert split in ("train", "val")
        self.root = root
        self.split = split
        self.classes = classes
        self.num_classes = len(classes)
        self.class_name_to_class_id = {c: i for i, c in enumerate(classes)}
        self.num_heading_angle_bins = num_heading_angle_bins
        self.class_name_to_size_template_id = class_name_to_size_template_id
        self.num_points = num_points
        self.rng = rng
        self.random_flip = random_flip
        self.random_shift = random_shift
        self.frustum_rotate = frustum_rotate
        self.from_rgb_detection = from_rgb_detection
        self.data = {}
        if from_rgb_detection:
            path = os.path.join(
                root, f"frustum_carpedcyc_{split}_rgb_detection.pickle")
            keys = ("ids", "boxes_2d", "point_clouds", "class_names",
                    "frustum_rotation_angles", "probs")
        else:
            path = os.path.join(root, f"frustum_carpedcyc_{split}.pickle")
            keys = ("ids", "boxes_2d", "boxes_3d", "point_clouds",
                    "mask_logits", "class_names", "heading_angles", "sizes",
                    "frustum_rotation_angles")
        with open(path, "rb") as fp:
            for key in keys:
                self.data[key] = pickle.load(fp, encoding="latin1")

    def __len__(self):
        return len(self.data["point_clouds"])

    def __getitem__(self, index):
        # the frustum angle runs clockwise from +x; + pi / 2 turns the
        # frustum's axis onto +z, and the heading by the same angle
        rotation_angle = np.pi / 2.0 + self.data["frustum_rotation_angles"][
            index]
        class_name = self.data["class_names"][index]
        one_hot = np.zeros(self.num_classes, dtype=np.float32)
        one_hot[self.class_name_to_class_id[class_name]] = 1

        point_cloud = self.data["point_clouds"][index]
        if self.frustum_rotate:
            point_cloud = rotate_points_along_y(np.copy(point_cloud),
                                                rotation_angle)
        choice = self.rng.choice(point_cloud.shape[0], self.num_points,
                                 replace=True)
        point_cloud = point_cloud[choice, :]
        if self.from_rgb_detection:
            return ({"features": point_cloud.astype(np.float32),
                     "one_hot_vectors": one_hot},
                    {"rotation_angle": np.float32(rotation_angle),
                     "rgb_score": self.data["probs"][index]})

        mask_logits = self.data["mask_logits"][index][choice]
        box3d = self.data["boxes_3d"][index]
        center = (box3d[0, :] + box3d[6, :]) / 2.0
        heading_angle = self.data["heading_angles"][index]
        size_template_id = self.class_name_to_size_template_id[class_name]
        size_residual = (self.data["sizes"][index]
                         - attributes.class_name_to_size_template[class_name])
        if self.frustum_rotate:
            center = rotate_points_along_y(center[None, :],
                                           rotation_angle).squeeze()
            heading_angle = heading_angle - rotation_angle
        if self.random_flip and self.rng.random_sample() > 0.5:
            point_cloud[:, 0] = -point_cloud[:, 0]
            center[0] = -center[0]
            heading_angle = np.pi - heading_angle
        if self.random_shift:
            dist = np.sqrt(np.sum(center[0] ** 2 + center[1] ** 2))
            shift = np.clip(self.rng.randn() * dist * 0.05, dist * 0.8,
                            dist * 1.2)
            point_cloud[:, 2] += shift
            center[2] += shift
        heading_bin_id, heading_residual = angle_to_bin_id(
            heading_angle, self.num_heading_angle_bins)
        return ({"features": point_cloud.astype(np.float32),
                 "one_hot_vectors": one_hot},
                {"mask_logits": mask_logits.astype(np.int64),
                 "center": center.astype(np.float32),
                 "heading_bin_id": np.int64(heading_bin_id),
                 "heading_residual": np.float32(heading_residual),
                 "size_template_id": np.int64(size_template_id),
                 "size_residual": size_residual.astype(np.float32),
                 "class_id": np.int64(
                     self.class_name_to_class_id[class_name])})


class FrustumKitti(dict):
    """{split: dataset} over the pickles at `root`
    (frustum_carpedcyc_{split}.pickle, or for val with from_rgb_detection
    frustum_carpedcyc_val_rgb_detection.pickle). The splits draw from one
    `rng` (np.random.RandomState(seed) if absent), as the JAX reader's
    draw from numpy's global state; val never flips or shifts."""

    def __init__(self, root, num_points, split=None,
                 classes=("Car", "Pedestrian", "Cyclist"),
                 num_heading_angle_bins=12,
                 class_name_to_size_template_id=None,
                 from_rgb_detection=False, random_flip=False,
                 random_shift=False, frustum_rotate=False, rng=None,
                 seed=0):
        super().__init__()
        if class_name_to_size_template_id is None:
            class_name_to_size_template_id = {
                c: i for i, c in enumerate(attributes.class_names)}
        if rng is None:
            rng = np.random.RandomState(seed)
        if not isinstance(split, (list, tuple)):
            split = ["train", "val"] if split is None else [split]
        common = dict(root=root, num_points=num_points, classes=classes,
                      num_heading_angle_bins=num_heading_angle_bins,
                      class_name_to_size_template_id=(
                          class_name_to_size_template_id),
                      rng=rng, frustum_rotate=frustum_rotate)
        if "train" in split:
            self["train"] = _FrustumKittiDataset(
                split="train", random_flip=random_flip,
                random_shift=random_shift, **common)
        if "val" in split:
            self["val"] = _FrustumKittiDataset(
                split="val", from_rgb_detection=from_rgb_detection,
                **common)


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


# a KITTI-like camera (focal length and principal point in pixels) that
# gives the synthetic objects their 2-D boxes
_FOCAL, _CU, _CV = 721.5377, 609.5593, 172.854
# the range of points a frustum holds
_POINTS = (256, 1024)


def _synthetic_object(rng: np.random.RandomState, num_points: int) -> dict:
    """One object from synthetic_batch's generator, moved from its frustum
    frame into the camera frame: its frustum axis turned by a rotation
    angle in [-0.6, 0.6] away from +z. Its corners [8, 3] are
    nn/frustum.py:get_box_corners_3d's (corners 0 and 6 opposite)."""
    inputs, targets = synthetic_batch(rng, 1, num_points)
    per_bin = 2 * np.pi / 12
    heading = (float(targets["heading_bin_id"][0]) * per_bin
               + float(targets["heading_residual"][0]))
    name = ("Car", "Pedestrian", "Cyclist")[int(targets["class_id"][0])]
    size = (attributes.class_name_to_size_template[name]
            + targets["size_residual"][0].astype(np.float64))
    angle = rng.uniform(-0.6, 0.6)
    cloud = rotate_points_along_y(inputs["features"][0].copy(), -angle)
    center = rotate_points_along_y(
        targets["center"][0].astype(np.float64)[None, :], -angle)[0]
    corners = box_corners_np(center[None], np.array([heading + angle]),
                          size[None])[0].T
    u = _FOCAL * corners[:, 0] / corners[:, 2] + _CU
    v = _FOCAL * corners[:, 1] / corners[:, 2] + _CV
    return {"box_2d": np.array([u.min(), v.min(), u.max(), v.max()]),
            "box_3d": corners, "point_cloud": cloud,
            "mask": targets["mask_logits"][0], "name": name,
            "heading": heading + angle, "size": size,
            "frustum_angle": angle - np.pi / 2, "center": center}


def write_synthetic_root(root: str, rng: np.random.RandomState, n: int,
                         objects_per_image: int = 2) -> dict:
    """Write a synthetic KITTI Frustum tree at `root`, in the layout of the
    real data: frustum_carpedcyc_{train,val}.pickle with `n` frustums
    each, frustum_carpedcyc_val_rgb_detection.pickle (the val objects, as
    a 2-D detector would propose them: boxes moved by up to 2 pixels and a
    score in [0.5, 1)), the val objects' label files
    ground_truth/NNNNNN.txt and image_sets/val.txt. Each frustum holds one
    real box of synthetic_batch's generator with 256-1,024 points;
    `objects_per_image` frustums share an image id. -> {"ground_truth",
    "image_ids"}: the label folder and the id list."""
    os.makedirs(root, exist_ok=True)
    val = None
    for split in ("train", "val"):
        objects = [_synthetic_object(rng, rng.randint(*_POINTS))
                   for _ in range(n)]
        ids = [i // objects_per_image for i in range(n)]
        with open(os.path.join(root, f"frustum_carpedcyc_{split}.pickle"),
                  "wb") as f:
            for value in (ids, [o["box_2d"] for o in objects],
                          [o["box_3d"] for o in objects],
                          [o["point_cloud"] for o in objects],
                          [o["mask"] for o in objects],
                          [o["name"] for o in objects],
                          [o["heading"] for o in objects],
                          [o["size"] for o in objects],
                          [o["frustum_angle"] for o in objects]):
                pickle.dump(value, f)
        val = (ids, objects)
    ids, objects = val
    with open(os.path.join(root,
                           "frustum_carpedcyc_val_rgb_detection.pickle"),
              "wb") as f:
        for value in (ids, [o["box_2d"] + rng.uniform(-2, 2, 4)
                            for o in objects],
                      [o["point_cloud"] for o in objects],
                      [o["name"] for o in objects],
                      [o["frustum_angle"] for o in objects],
                      [float(rng.uniform(0.5, 1.0)) for _ in objects]):
            pickle.dump(value, f)
    labels = os.path.join(root, "ground_truth")
    os.makedirs(labels, exist_ok=True)
    lines = {}
    for image, o in zip(ids, objects):
        l, w, h = o["size"]
        x, y, z = o["center"]
        ry = np.mod(o["heading"] + np.pi, 2 * np.pi) - np.pi
        alpha = np.mod(ry - np.arctan2(x, z) + np.pi, 2 * np.pi) - np.pi
        lines.setdefault(image, []).append(
            "{} 0.00 0 {:.2f} {:.2f} {:.2f} {:.2f} {:.2f} {:.2f} {:.2f} "
            "{:.2f} {:.2f} {:.2f} {:.2f} {:.2f}\n".format(
                o["name"], alpha, *o["box_2d"], h, w, l, x, y + h / 2, z,
                ry))
    for image, text in lines.items():
        with open(os.path.join(labels, f"{image:06d}.txt"), "w") as f:
            f.writelines(text)
    image_ids = os.path.join(root, "image_sets", "val.txt")
    os.makedirs(os.path.dirname(image_ids), exist_ok=True)
    with open(image_ids, "w") as f:
        f.writelines(f"{image:06d}\n" for image in sorted(lines))
    return {"ground_truth": labels, "image_ids": image_ids}
