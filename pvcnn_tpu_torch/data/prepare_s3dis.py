"""S3DIS offline preparation (counterpart of pvcnn_tpu/data/prepare_s3dis.py;
reference data/s3dis/prepare_data.py): raw annotation txts -> per-room
xyzrgb.npy / label.npy -> h5 windows.

Each room is cut into 1.5 m XY blocks at two offsets (zero, half); blocks
under max_num_points / 10 points merge into their first large neighbour;
each block is resampled to a uniform count a 3 cm grid cell and split into
windows of at most max_num_points points, with the features [x_in_block,
y_in_block, z, r, g, b, x/X, y/Y, z/Z] and `indices_split_to_full`, the
room point of each window point, for the scene-level voting evaluator.

`room_windows` is the per-room numpy work: it returns, per offset and
flush, the arrays the JAX package writes to `{zero,half}_{k}.h5`. The files
are the JAX package's, byte for byte in their datasets: the float64 `data`,
the flush every 2,048 windows (the reader reads only `_0`), and the rows
past `data_num` left from earlier windows in the room's buffers. Every draw
comes from the RandomState passed in, in the JAX package's order (it draws
from numpy's global state), so one seed gives equal files. h5py is
imported only to write them.

There is no S3DIS data in the repository: `synthetic_room` draws a room's
xyzrgb.npy / label.npy arrays (a box-shaped office: floor, ceiling, walls,
door, window, board, beam, column and furniture, points on their
surfaces), for the smoke runs.

Run: python -m pvcnn_tpu_torch.data.prepare_s3dis -d <raw_dir> -f <out_dir>
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np

__all__ = ["DATASETS", "OBJECT_DICT", "WINDOWS_PER_FILE", "prepare_labels",
           "prepare_windows", "room_windows", "synthetic_room",
           "write_windows"]

OBJECT_DICT = {
    "clutter": 0, "ceiling": 1, "floor": 2, "wall": 3, "beam": 4, "column": 5,
    "door": 6, "window": 7, "table": 8, "chair": 9, "sofa": 10, "bookcase": 11,
    "board": 12,
}
# windows a `{offset}_{k}.h5` file holds at most
WINDOWS_PER_FILE = 2048
# the datasets of a window file, in the order they are written
DATASETS = ("data", "data_num", "label", "label_seg", "indices_split_to_full")
# the 8-neighbourhood in the order a small block looks for a large one
_NEIGHBOURS = ((0, 1), (1, 0), (0, -1), (-1, 0), (-1, 1), (1, 1), (1, -1),
               (-1, -1))


def prepare_labels(data_dir: str, output_dir: str) -> None:
    """Annotation txts -> per-room xyzrgb.npy + label.npy."""
    for area in sorted(os.listdir(data_dir)):
        area_path = os.path.join(data_dir, area)
        if not os.path.isdir(area_path):
            continue
        for room in sorted(os.listdir(area_path)):
            annotations = os.path.join(area_path, room, "Annotations")
            if not os.path.isdir(annotations):
                continue
            out_room = os.path.join(output_dir, area, room)
            if os.path.exists(os.path.join(out_room, ".labels")):
                print(f"{out_room} already processed, skipping")
                continue
            os.makedirs(out_room, exist_ok=True)
            xyz_parts, label_parts = [], []
            for obj in sorted(os.listdir(annotations)):
                key = obj.split("_", 1)[0]
                if key not in OBJECT_DICT:
                    continue
                try:
                    pts = np.loadtxt(os.path.join(annotations, obj))
                except ValueError as e:
                    print(f"ERROR loading {obj}: {e}")
                    continue
                xyz_parts.append(pts)
                label_parts.append(np.full((pts.shape[0], 1), OBJECT_DICT[key]))
            xyz_room = np.concatenate(xyz_parts, axis=0)
            label_room = np.concatenate(label_parts, axis=0)
            np.save(os.path.join(out_room, "xyzrgb.npy"), xyz_room)
            np.save(os.path.join(out_room, "label.npy"), label_room)
            open(os.path.join(out_room, ".labels"), "w").close()
            print(f"prepared {out_room}: {xyz_room.shape[0]} points")


def _unique_rows(rows):
    """np.unique(rows, return_inverse=True, return_counts=True, axis=0) for
    rows of non-negative ints, through one int64 key a row: the same rows,
    inverse (1-D) and counts, without sorting rows as records."""
    span = rows.max(axis=0) + 1
    keys = rows[:, 0]
    for d in range(1, rows.shape[1]):
        keys = keys * span[d] + rows[:, d]
    _, first, inverse, counts = np.unique(keys, return_index=True,
                                          return_inverse=True,
                                          return_counts=True)
    return rows[first], inverse.reshape(-1), counts


def _grid_resample(point_indices, xyz, grid_size, rng):
    """Resample one block to the mean count of its occupied grid cells: a
    cell with fewer points repeats them, shuffled, up to that count (one
    draw a cell, in cell order); the others keep all theirs."""
    block_points = xyz[point_indices]
    block_min = block_points.min(axis=0, keepdims=True)
    grids_of = np.floor((block_points - block_min) / grid_size).astype(np.int64)
    _, grid_ids, counts = _unique_rows(grids_of)
    order = np.argsort(grid_ids)
    starts = np.cumsum(counts) - counts
    avg = int(np.average(counts))
    pieces, done = [], 0
    for cell in np.flatnonzero(counts < avg):
        start, count = starts[cell], counts[cell]
        pieces.append(order[done:start])
        idx_in_block = np.repeat(order[start:start + count],
                                 math.ceil(avg / count))
        rng.shuffle(idx_in_block)
        pieces.append(idx_in_block[:avg])
        done = start + count
    pieces.append(order[done:])
    return point_indices[np.concatenate(pieces)]


def _blocks(xyz, offset, block_size, max_num_points):
    """The room's points per XY block at `offset`, small blocks merged into
    their first large neighbour (emptied, not removed), and the last
    non-empty block's index."""
    xyz_min = xyz.min(axis=0, keepdims=True) - offset
    xyz_max = xyz.max(axis=0, keepdims=True)
    bsize = (block_size, block_size,
             2 * (xyz_max[0, -1] - xyz_min[0, -1]))          # no z split
    xyz_blocks = np.floor((xyz - xyz_min) / bsize).astype(np.int64)
    blocks, block_ids, block_counts = _unique_rows(xyz_blocks)
    point_indices = np.split(np.argsort(block_ids),
                             np.cumsum(block_counts[:-1]))
    block_map = {(b[0], b[1]): i for i, b in enumerate(blocks)}
    # the threshold holds against the counts before any merge
    threshold = max_num_points / 10
    for bi in range(blocks.shape[0]):
        if block_counts[bi] >= threshold:
            continue
        b = (blocks[bi][0], blocks[bi][1])
        for dx, dy in _NEIGHBOURS:
            nbr = block_map.get((b[0] + dx, b[1] + dy))
            if nbr is None or block_counts[nbr] < threshold:
                continue
            point_indices[nbr] = np.concatenate(
                [point_indices[nbr], point_indices[bi]])
            point_indices[bi] = np.array([], dtype=np.int64)
            break
    last_nonempty = max((bi for bi in range(blocks.shape[0])
                         if point_indices[bi].shape[0]), default=-1)
    return point_indices, last_nonempty


def room_windows(xyzrgb: np.ndarray, labels: np.ndarray, dataset_idx: int,
                 rng: np.random.RandomState, max_num_points: int = 8192,
                 block_size: float = 1.5, grid_size: float = 0.03):
    """One room's windows -> [(offset name, k, {dataset: array})], one entry
    a `{offset}_{k}.h5` file, in the order the JAX package writes them.

    xyzrgb [P, 6] (rgb in 0-255) and labels [P] (or [P, 1]) are a room's
    xyzrgb.npy and label.npy; dataset_idx fills the `label` dataset (the
    room's index among its area's entries). The arrays are copies of the
    room's buffers at each flush, so rows past a window's data_num hold what
    earlier windows of the room (either offset) left there."""
    xyzrgb = np.array(xyzrgb)
    labels = np.asarray(labels).astype(int).flatten()
    xyzrgb[:, 0:3] -= np.amin(xyzrgb, axis=0)[0:3]
    xyz, rgb = np.split(xyzrgb, [3], axis=-1)
    rgb = rgb / 255.0
    max_room = xyz.max(axis=0)

    data = np.zeros((WINDOWS_PER_FILE, max_num_points, 9))
    data_num = np.zeros(WINDOWS_PER_FILE, dtype=np.int32)
    label = np.zeros(WINDOWS_PER_FILE, dtype=np.int32)
    label_seg = np.zeros((WINDOWS_PER_FILE, max_num_points), dtype=np.int32)
    split_to_full = np.zeros((WINDOWS_PER_FILE, max_num_points),
                             dtype=np.int32)
    buffers = (data, data_num, label, label_seg, split_to_full)

    files = []
    for offset_name, offset in (("zero", 0.0), ("half", block_size / 2)):
        idx_h5 = 0
        idx = 0
        block_point_indices, last_nonempty = _blocks(xyz, offset, block_size,
                                                     max_num_points)
        for bi in range(last_nonempty + 1):
            if block_point_indices[bi].shape[0] == 0:
                continue
            block_point_indices[bi] = _grid_resample(
                block_point_indices[bi], xyz, grid_size, rng)

        for bi in range(last_nonempty + 1):
            point_indices = block_point_indices[bi]
            if point_indices.shape[0] == 0:
                continue
            n = point_indices.shape[0]
            n_splits = int(math.ceil(n / max_num_points))
            per = int(math.ceil(n / n_splits))
            nums = [per] * n_splits
            nums[-1] = n - per * (n_splits - 1)
            starts = [0] + list(np.cumsum(nums))

            rng.shuffle(point_indices)
            pts = xyz[point_indices]
            block_rgb = rgb[point_indices]
            block_labels = labels[point_indices]
            x, y, z = np.split(pts, (1, 2), axis=-1)
            norm = pts / max_room
            x = x - (x.min() + block_size / 2)
            y = y - (y.min() + block_size / 2)
            feat = np.concatenate([x, y, z, block_rgb, norm], axis=-1)

            for si in range(n_splits):
                s, num = starts[si], nums[si]
                j = idx % WINDOWS_PER_FILE
                data[j, :num] = feat[s:s + num]
                data_num[j] = num
                label[j] = dataset_idx
                label_seg[j, :num] = block_labels[s:s + num]
                split_to_full[j, :num] = point_indices[s:s + num]
                if ((idx + 1) % WINDOWS_PER_FILE == 0
                        or (bi == last_nonempty and si == n_splits - 1)):
                    files.append((offset_name, idx_h5, {
                        name: buf[:j + 1].copy()
                        for name, buf in zip(DATASETS, buffers)}))
                    idx_h5 += 1
                idx += 1
    return files


def write_windows(path: str, arrays: dict) -> None:
    """One window file's datasets into the h5 file at `path`."""
    import h5py  # only here: the package imports without h5py

    with h5py.File(path, "w") as f:
        for name in DATASETS:
            f.create_dataset(name, data=arrays[name])


def prepare_windows(root: str, max_num_points: int = 8192,
                    block_size: float = 1.5, grid_size: float = 0.03,
                    rng: np.random.RandomState | None = None) -> None:
    """Each prepared room under root/Area_{1..6} -> its window files, with
    draws from `rng` (np.random.RandomState(0) if absent). A room with a
    .dataset marker is skipped."""
    if rng is None:
        rng = np.random.RandomState(0)
    for area_idx in range(1, 7):
        folder = os.path.join(root, f"Area_{area_idx}")
        if not os.path.isdir(folder):
            continue
        for dataset_idx, dataset in enumerate(sorted(os.listdir(folder))):
            marker = os.path.join(folder, dataset, ".dataset")
            if os.path.exists(marker):
                print(f"{folder}/{dataset} already processed, skipping")
                continue
            xyzrgb = np.load(os.path.join(folder, dataset, "xyzrgb.npy"))
            labels = np.load(os.path.join(folder, dataset, "label.npy"))
            for offset_name, k, arrays in room_windows(
                    xyzrgb, labels, dataset_idx, rng, max_num_points,
                    block_size, grid_size):
                path = os.path.join(folder, dataset, f"{offset_name}_{k}.h5")
                write_windows(path, arrays)
                print(f"saved {path} ({arrays['data'].shape[0]} windows)")
            open(marker, "w").close()


# each class's base colour in a synthetic room
_COLOURS = ((120, 120, 120), (230, 230, 220), (150, 110, 80), (200, 200, 190),
            (180, 170, 160), (190, 190, 180), (140, 90, 50), (170, 200, 230),
            (160, 120, 70), (60, 60, 70), (90, 40, 40), (110, 80, 50),
            (240, 240, 240))


def _box(lo, hi, label):
    """The five faces of a box standing on the floor or hanging from the
    ceiling (no bottom face): (corner, edge u, edge v, label)."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    ex, ey, ez = np.diag(hi - lo)
    return [(lo + ez, ex, ey, label), (lo, ex, ez, label),
            (lo + ey, ex, ez, label), (lo, ey, ez, label),
            (lo + ex, ey, ez, label)]


def synthetic_room(rng: np.random.RandomState, num_points: int):
    """A synthetic office of 5-8 m x 4-6 m x 3 m -> (xyzrgb [P, 6] float64,
    rgb in 0-255, labels [P, 1] int64), as prepare_labels would save them:
    num_points points on its surfaces (uniform by area, 3 mm of noise),
    coloured by class with noise, in a random order."""
    length, width, height = rng.uniform(5, 8), rng.uniform(4, 6), 3.0
    o = np.zeros(3)
    ex, ey, ez = np.diag([length, width, height])
    rects = [(o, ex, ey, 2), (o + ez, ex, ey, 1), (o, ex, ez, 3),
             (o + ey, ex, ez, 3), (o, ey, ez, 3), (o + ex, ey, ez, 3),
             ((0.02, 0.5, 0), (0, 0.9, 0), (0, 0, 2.1), 6),
             ((length / 2, width - 0.02, 0.9), (1.5, 0, 0), (0, 0, 1.2), 7),
             ((length - 0.02, 1, 0.9), (0, 2, 0), (0, 0, 1.1), 12)]
    rects += _box((length / 2 - 0.2, 0, height - 0.4),
                  (length / 2 + 0.2, width, height), 4)
    rects += _box((0, width - 0.5, 0), (0.5, width, height), 5)
    for _ in range(2):
        x, y = rng.uniform(1, length - 2.5), rng.uniform(1, width - 2)
        rects += _box((x, y, 0.72), (x + 1.6, y + 0.8, 0.76), 8)
        for dx in (0.3, 1.0):
            rects += _box((x + dx, y - 0.6, 0), (x + dx + 0.45, y - 0.15, 0.9),
                          9)
    rects += _box((length - 0.45, width - 2.5, 0), (length, width - 1.3, 2),
                  11)
    rects += _box((1, 0.05, 0), (3, 0.95, 0.8), 10)
    rects += _box((length - 1.5, 0.2, 0), (length - 1, 0.7, 0.5), 0)
    rects = [tuple(np.asarray(a, float) for a in r[:3]) + (r[3],)
             for r in rects]
    areas = np.array([np.linalg.norm(np.cross(u, v)) for _, u, v, _ in rects])
    counts = rng.multinomial(num_points, areas / areas.sum())
    xyz = np.concatenate([corner + rng.rand(n, 1) * u + rng.rand(n, 1) * v
                          for (corner, u, v, _), n in zip(rects, counts)])
    xyz += rng.normal(0, 0.003, xyz.shape)
    labels = np.repeat([r[3] for r in rects], counts)
    rgb = np.asarray(_COLOURS, float)[labels] + rng.normal(0, 12, xyz.shape)
    order = rng.permutation(num_points)
    xyzrgb = np.concatenate([xyz, np.clip(rgb, 0, 255).round()], axis=1)
    return xyzrgb[order], labels[order, None].astype(np.int64)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m pvcnn_tpu_torch.data.prepare_s3dis",
        description="S3DIS annotations -> per-room npy -> h5 windows")
    parser.add_argument(
        "-d", "--data", dest="data_dir",
        default="data/s3dis/Stanford3dDataset_v1.2_Aligned_Version")
    parser.add_argument("-f", "--folder", dest="output_dir",
                        default="data/s3dis/pointcnn")
    parser.add_argument("--max_num_points", "-m", type=int, default=8192)
    parser.add_argument("--block_size", "-b", type=float, default=1.5)
    parser.add_argument("--grid_size", "-g", type=float, default=0.03)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the resampling and window shuffles")
    args = parser.parse_args(argv)
    prepare_labels(args.data_dir, args.output_dir)
    prepare_windows(args.output_dir, args.max_num_points, args.block_size,
                    args.grid_size, np.random.RandomState(args.seed))


if __name__ == "__main__":
    main()
