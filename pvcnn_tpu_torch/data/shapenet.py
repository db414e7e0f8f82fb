"""ShapeNet part-segmentation data (counterpart of pvcnn_tpu/data/shapenet.py):
the file layout, normalization, and the split dataset the trainer samples.

A tree holds `synsetoffset2category.txt` (one `<name> <shape dir>` line per
shape category, in shape-id order), `train_test_split/
shuffled_<split>_file_list.json` (entries `shape_data/<dir>/<item>`) and one
whitespace table per item, `<dir>/<item>.txt`, with columns
x y z nx ny nz part_label, parsed by the host library (native.loadtxt:
each token rounded once to float32, as the JAX reader's
pvcnn_tpu.native.loadtxt does).
"""

from __future__ import annotations

import json
import os

import numpy as np

from pvcnn_tpu_torch import native

__all__ = ["NUM_CLASSES", "NUM_SHAPES", "SHAPE_PART_CLASSES", "ShapeNet",
           "ShapeNetDataset", "file_paths", "normalize_point_cloud",
           "write_synthetic"]

NUM_SHAPES = 16
NUM_CLASSES = 50
# part classes of each shape category, in shape-id order
SHAPE_PART_CLASSES = (
    ("Airplane", (0, 1, 2, 3)), ("Bag", (4, 5)), ("Cap", (6, 7)),
    ("Car", (8, 9, 10, 11)), ("Chair", (12, 13, 14, 15)),
    ("Earphone", (16, 17, 18)), ("Guitar", (19, 20, 21)),
    ("Knife", (22, 23)), ("Lamp", (24, 25, 26, 27)), ("Laptop", (28, 29)),
    ("Motorbike", (30, 31, 32, 33, 34, 35)), ("Mug", (36, 37)),
    ("Pistol", (38, 39, 40)), ("Rocket", (41, 42, 43)),
    ("Skateboard", (44, 45, 46)), ("Table", (47, 48, 49)),
)


def file_paths(root: str, split: str = "test"):
    """-> [(item .txt path, shape id)] for `split` ('train' also reads
    'val', as the reference does)."""
    shape_ids = {}
    with open(os.path.join(root, "synsetoffset2category.txt")) as f:
        for shape_id, line in enumerate(f):
            _, shape_dir = line.strip().split()
            shape_ids[shape_dir] = shape_id
    out = []
    for s in (["train", "val"] if split == "train" else [split]):
        with open(os.path.join(root, "train_test_split",
                               f"shuffled_{s}_file_list.json")) as f:
            for entry in json.load(f):
                _, shape_dir, name = entry.split("/")
                out.append((os.path.join(root, shape_dir, name + ".txt"),
                            shape_ids[shape_dir]))
    return out


def normalize_point_cloud(points: np.ndarray) -> np.ndarray:
    """Center on the mean and scale the farthest point to norm 1."""
    points = points - points.mean(axis=0)
    return points / np.max(np.linalg.norm(points, axis=1))


class ShapeNetDataset:
    """One split of a ShapeNet tree as (features [num_points, C] float32,
    labels [num_points] int64) samples: normalized xyz, then the normals
    (with_normal) and the one-hot shape id per point
    (with_one_hot_shape_id), so C is 3, 6, 19 or 22.

    Each sample resamples num_points of the shape's points with replacement
    and, in the train split, adds N(0, 0.01) noise clipped to +-0.05 to xyz, drawing both from this dataset's own
    np.random.RandomState(seed) in the order pvcnn_tpu/data/shapenet.py draws
    them from numpy's global state. 'train' reads the train and val lists.
    Parsed shapes stay cached in memory."""

    def __init__(self, root: str, num_points: int, split: str = "train",
                 seed: int = 0, with_normal: bool = True,
                 with_one_hot_shape_id: bool = True):
        self.file_paths = file_paths(root, split)
        self.num_points = int(num_points)
        self.jitter = split == "train"
        self.with_normal = with_normal
        self.with_one_hot_shape_id = with_one_hot_shape_id
        self.rng = np.random.RandomState(seed)
        self.cache = {}

    @property
    def in_channels(self) -> int:
        return (3 + 3 * self.with_normal
                + NUM_SHAPES * self.with_one_hot_shape_id)

    def __len__(self):
        return len(self.file_paths)

    def __getitem__(self, index):
        if index not in self.cache:
            path, shape_id = self.file_paths[index]
            data = native.loadtxt(path)
            columns = [normalize_point_cloud(data[:, :3])]
            if self.with_normal:
                columns.append(data[:, 3:6])
            packed = np.concatenate(columns, axis=1).astype(np.float32)
            self.cache[index] = (packed, data[:, -1].astype(np.int64),
                                 shape_id)
        packed, label, shape_id = self.cache[index]
        n, width = self.num_points, packed.shape[1]
        choice = self.rng.randint(0, label.shape[0], n)
        features = np.zeros((n, self.in_channels), dtype=np.float32)
        features[:, :width] = packed[choice]
        if self.jitter:
            features[:, :3] += np.clip(0.01 * self.rng.randn(n, 3), -0.05,
                                       0.05)
        if self.with_one_hot_shape_id:
            features[:, width + shape_id] = 1.0
        return features, label[choice]


class ShapeNet(dict):
    """The splits of the ShapeNet tree at `root` by name, 'train' and
    'test' unless `split` names others (the configs' dataset; counterpart
    of the JAX package's ShapeNet). The train split draws from
    np.random.RandomState(seed), any other from seed + 1, as
    train/shapenet.py's loaders do; `jitter` applies to the train split
    only. The points are always normalized (`normalize=False` raises)."""

    def __init__(self, root, num_points, split=None, with_normal=True,
                 with_one_hot_shape_id=True, normalize=True, jitter=True,
                 seed=0):
        super().__init__()
        if not normalize:
            raise ValueError("the port's ShapeNet reader always normalizes")
        if split is None:
            split = ["train", "test"]
        elif not isinstance(split, (list, tuple)):
            split = [split]
        for s in split:
            dataset = ShapeNetDataset(
                root, num_points, s, seed=seed + (s != "train"),
                with_normal=with_normal,
                with_one_hot_shape_id=with_one_hot_shape_id)
            dataset.jitter = dataset.jitter and jitter
            self[s] = dataset


def write_synthetic(root: str, items, seed: int = 0):
    """Write a synthetic tree in the layout above, for tests and smoke runs
    (its labels carry no signal). `items`: (shape id, number of points) per
    item; points lie on a noisy ellipsoid with unit normals, labels are drawn
    from the shape's part classes, and every split lists every item.
    -> the list entries."""
    rng = np.random.RandomState(seed)
    dirs = [f"{2690000 + i:08d}" for i in range(NUM_SHAPES)]
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as f:
        for (name, _), d in zip(SHAPE_PART_CLASSES, dirs):
            f.write(f"{name}\t{d}\n")
    os.makedirs(os.path.join(root, "train_test_split"), exist_ok=True)
    entries = []
    for k, (shape_id, n) in enumerate(items):
        os.makedirs(os.path.join(root, dirs[shape_id]), exist_ok=True)
        normals = rng.randn(n, 3)
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        xyz = normals * [1.0, 0.6, 0.3] + 0.02 * rng.randn(n, 3)
        parts = SHAPE_PART_CLASSES[shape_id][1]
        labels = rng.randint(parts[0], parts[-1] + 1, size=(n, 1))
        np.savetxt(os.path.join(root, dirs[shape_id], f"item{k}.txt"),
                   np.concatenate([xyz, normals, labels], axis=1), fmt="%.6f")
        entries.append(f"shape_data/{dirs[shape_id]}/item{k}")
    for split in ("train", "val", "test"):
        with open(os.path.join(root, "train_test_split",
                               f"shuffled_{split}_file_list.json"), "w") as f:
            json.dump(entries, f)
    return entries
