"""S3DIS semantic-segmentation reader over prepared windows (counterpart of
pvcnn_tpu/data/s3dis.py; reference datasets/s3dis.py).

The layout is the JAX package's: per room `{zero,half}_0.h5` files with the
datasets data [W, P, 9], label_seg [W, P], data_num [W] and
indices_split_to_full [W, P] (data/prepare_s3dis.py writes them); the
features are [x_in_block, y_in_block, z, r, g, b, x/X, y/Y, z/Z]. Items
come out channel-last: [num_points, 9] float32 (6 columns without the
normalized coordinates) and [num_points] int64 labels, num_points of the
window's valid points drawn with replacement only where it has fewer.

Windows are read through an opener: path -> an object with the four
datasets as array-likes and a close(). `open_h5` (the default) opens the
h5 file, importing h5py at its first call; `WindowStore` holds the same
arrays in memory under the same paths, for a machine without h5py. A path
the store lacks raises KeyError: neither opener stands in for the other.

Draws: the point choice and the eviction from the cache of open files (20
entries for train, 30 for test) draw from one np.random.RandomState that
the splits share, in the JAX reader's order (it draws both from numpy's
global state), so a seed gives the JAX reader's items past any number of
evictions.
"""

from __future__ import annotations

import os
import threading
from typing import NamedTuple

import numpy as np

__all__ = ["S3DIS", "WindowFile", "WindowStore", "open_h5"]

# the datasets an opener gives, as attributes of a WindowFile
FIELDS = ("data", "label_seg", "data_num", "indices_split_to_full")


class WindowFile(NamedTuple):
    """One window file's datasets (array-likes indexed by window) and the
    function that closes it."""

    data: object
    label_seg: object
    data_num: object
    indices_split_to_full: object
    close: object


def open_h5(path: str) -> WindowFile:
    """The window file at `path`, opened read-only with h5py."""
    import h5py  # only here: the package imports without h5py

    f = h5py.File(path, "r")
    return WindowFile(*(f[name] for name in FIELDS), f.close)


class WindowStore(dict):
    """Window files in memory: path -> {dataset name: array}. Called with a
    path, it opens that entry as open_h5 opens a file."""

    def __call__(self, path: str) -> WindowFile:
        arrays = self[path]
        return WindowFile(*(arrays[name] for name in FIELDS), lambda: None)


class _S3DISDataset:
    def __init__(self, root, num_points, split="train",
                 with_normalized_coords=True, holdout_area=5, *, rng,
                 opener=open_h5):
        if split not in ("train", "test"):
            raise ValueError(f"unknown split {split!r}")
        self.root = root
        self.split = split
        self.num_points = num_points
        self.holdout_area = None if holdout_area is None else int(holdout_area)
        self.with_normalized_coords = with_normalized_coords
        self.rng = rng
        self.opener = opener
        self.cache_size = 20 if split == "train" else 30
        self.cache = {}
        # lookup, eviction, read and the item's draws are one critical
        # section: a thread must not read from a file another thread just
        # closed, nor draw between another item's eviction and choice
        self._cache_lock = threading.Lock()

        if split == "train":
            areas = [os.path.join(root, f"Area_{a}") for a in range(1, 7)
                     if a != self.holdout_area]
        else:
            areas = [os.path.join(root, f"Area_{self.holdout_area}")]

        self.num_scene_windows = 0
        index_to_filename, scene_list, filename_to_start_index = [], {}, {}
        for area in areas:
            if not os.path.isdir(area):
                continue
            for scene in sorted(os.listdir(area)):
                current_scene = os.path.join(area, scene)
                scene_list[current_scene] = []
                for offset in ("zero", "half"):
                    current_file = os.path.join(current_scene, f"{offset}_0.h5")
                    filename_to_start_index[current_file] = \
                        self.num_scene_windows
                    window_file = opener(current_file)
                    try:
                        num_windows = window_file.data.shape[0]
                    finally:
                        window_file.close()
                    self.num_scene_windows += num_windows
                    index_to_filename.extend([current_file] * num_windows)
                    scene_list[current_scene].append(current_file)
        self.index_to_filename = index_to_filename
        self.filename_to_start_index = filename_to_start_index
        self.scene_list = scene_list

    def __len__(self):
        return self.num_scene_windows

    def _file(self, filename) -> WindowFile:
        if filename in self.cache:
            return self.cache[filename]
        window_file = self.opener(filename)
        if len(self.cache) >= self.cache_size:
            victim = sorted(self.cache)[self.rng.randint(0, self.cache_size)]
            self.cache.pop(victim).close()
        self.cache[filename] = window_file
        return window_file

    def after_fork(self):
        """In a forked loader worker (data/loader.py): a lock and a cache
        of its own. The parent's open files stay referenced here, unused
        and unclosed: an h5py handle must not be used across a fork."""
        self._cache_lock = threading.Lock()
        self._parent_files = self.cache
        self.cache = {}

    def __del__(self):
        for window_file in getattr(self, "cache", {}).values():
            try:
                window_file.close()
            except Exception:
                pass

    def __getitem__(self, index):
        filename = self.index_to_filename[index]
        pos = index - self.filename_to_start_index[filename]
        with self._cache_lock:
            window_file = self._file(filename)
            window_data = np.asarray(window_file.data[pos], dtype=np.float32)
            window_label = np.asarray(window_file.label_seg[pos],
                                      dtype=np.int64)
            num_valid = int(window_file.data_num[pos])
            choices = self.rng.choice(num_valid, self.num_points,
                                      replace=(num_valid < self.num_points))
        data = window_data[choices]          # [num_points, 9], channel-last
        label = window_label[choices]
        if not self.with_normalized_coords:
            data = data[:, :-3]
        return data, label


class S3DIS(dict):
    """The splits (train: every area but holdout_area; test: holdout_area)
    of the prepared tree at `root`, by name. Their draws share `rng`
    (np.random.RandomState(0) if absent); `opener` reads the window files
    (open_h5, or a WindowStore)."""

    def __init__(self, root, num_points, split=None,
                 with_normalized_coords=True, holdout_area=5, rng=None,
                 opener=open_h5):
        super().__init__()
        if split is None:
            split = ["train", "test"]
        elif not isinstance(split, (list, tuple)):
            split = [split]
        if rng is None:
            rng = np.random.RandomState(0)
        for s in split:
            self[s] = _S3DISDataset(
                root=root, num_points=num_points, split=s,
                with_normalized_coords=with_normalized_coords,
                holdout_area=holdout_area, rng=rng, opener=opener)
