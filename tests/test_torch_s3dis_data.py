"""The port's S3DIS preparation and reader against the JAX package's, on a
synthetic annotation tree of small rooms (a few hundred points, windows of
at most 128 points, a 0.1 m grid, as tests/test_s3dis_pipeline.py):
data/prepare_s3dis.py writes the JAX package's npy and h5 files exactly
for a shared seed (one room wide enough to split a block and to merge a
small one into its neighbour); data/s3dis.py gives the JAX reader's items
for a shared seed past the evictions of its cache of open files (11 train
rooms, 22 files), through the h5 files and through an in-memory
WindowStore alike; and the package imports without h5py.
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from pvcnn_tpu.data import prepare_s3dis as jprep
from pvcnn_tpu.data.s3dis import S3DIS as JS3DIS
from pvcnn_tpu_torch.data import prepare_s3dis as tprep
from pvcnn_tpu_torch.data.s3dis import S3DIS, WindowStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_POINTS, GRID = 128, 0.1
# rooms a synthetic area holds: 11 in the train areas, 2 in Area_5
ROOMS = {"Area_1": 6, "Area_2": 5, "Area_5": 2}
# (annotation, points) of a room, extents in m; the wide room's chair
# leaves a few points in a block of their own past x = 3
OBJECTS = (("chair_1", 60), ("floor_1", 120), ("wall_2", 90),
           ("stairs_1", 10))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module (tests/test_torch_frustum.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def write_raw(raw, rng, rooms=ROOMS):
    """A synthetic S3DIS annotation tree: per room four annotation txts
    (one of a class S3DIS lacks, which preparation skips); Area_1's first
    room is 3 m wide at three times the points."""
    for area, count in rooms.items():
        for r in range(count):
            ann = os.path.join(raw, area, f"room_{r + 1}", "Annotations")
            os.makedirs(ann)
            wide = area == "Area_1" and r == 0
            for name, n in OBJECTS:
                n *= 3 if wide else 1
                pts = np.concatenate([
                    rng.rand(n, 3) * [3.0 if wide else 1.4, 1.4, 2.5],
                    rng.randint(0, 255, size=(n, 3))], axis=1)
                if wide and name == "chair_1":
                    pts[:5, 0] = 3.0 + rng.rand(5) * 0.2
                np.savetxt(os.path.join(ann, f"{name}.txt"), pts, fmt="%.4f")


def prepare(module, raw, out, **kwargs):
    module.prepare_labels(raw, out)
    module.prepare_windows(out, max_num_points=MAX_POINTS, block_size=1.5,
                           grid_size=GRID, **kwargs)
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same raw tree prepared by JAX (np.random.seed(3)) and by the port
    (RandomState(3)) -> {"jax": root, "port": root}."""
    raw = str(tmp_path_factory.mktemp("s3dis_raw"))
    write_raw(raw, np.random.RandomState(0))
    np.random.seed(3)
    jax_root = prepare(jprep, raw, str(tmp_path_factory.mktemp("jax")))
    port_root = prepare(tprep, raw, str(tmp_path_factory.mktemp("port")),
                        rng=np.random.RandomState(3))
    return {"jax": jax_root, "port": port_root}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def test_prepared_files_equal_jax(trees):
    """Every npy and every h5 dataset the port writes equals JAX's,
    dtype included (the float64 data, the stale rows past data_num)."""
    files = _files(trees["jax"])
    assert files == _files(trees["port"])
    assert sum(f.endswith(".h5") for f in files) == 2 * sum(ROOMS.values())
    for name in files:
        mine, theirs = (os.path.join(trees[k], name) for k in ("port", "jax"))
        if name.endswith(".npy"):
            a, b = np.load(mine), np.load(theirs)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        elif name.endswith(".h5"):
            with h5py.File(mine, "r") as fa, h5py.File(theirs, "r") as fb:
                assert list(fa) == list(fb) == sorted(tprep.DATASETS)
                for key in fb:
                    assert fa[key].dtype == fb[key].dtype, (name, key)
                    assert np.array_equal(fa[key][...], fb[key][...]), \
                        (name, key)


def test_preparation_splits_and_merges(trees):
    """The wide room's tail block merges into its neighbour (the
    reference's threshold of max_num_points / 10 points), a block splits
    into several windows, and a half-offset window's rows past its
    data_num hold the zero-offset window's of the same slot, not zeros
    (the reference never clears its buffers)."""
    room = os.path.join(trees["port"], "Area_1", "room_1")
    xyzrgb = np.load(os.path.join(room, "xyzrgb.npy"))
    xyz = xyzrgb[:, :3] - xyzrgb[:, :3].min(axis=0)
    indices, last = tprep._blocks(xyz, 0.0, 1.5, MAX_POINTS)
    sizes = [len(i) for i in indices]
    assert 0 in sizes and sum(sizes) == len(xyz) and last < len(sizes)
    files = {}
    for offset in ("zero", "half"):
        with h5py.File(os.path.join(room, f"{offset}_0.h5"), "r") as f:
            files[offset] = f["data_num"][...], f["data"][...]
    (nums, data), (half_nums, half_data) = files["zero"], files["half"]
    assert len(nums) > sum(1 for s in sizes if s)
    stale = [j for j in range(min(len(nums), len(half_nums)))
             if half_nums[j] < nums[j]]
    assert stale
    for j in stale:
        np.testing.assert_array_equal(half_data[j, half_nums[j]:nums[j]],
                                      data[j, half_nums[j]:nums[j]])


def test_unique_rows_is_numpy_unique():
    """_unique_rows gives np.unique(axis=0)'s rows, inverse and counts."""
    rows = np.random.RandomState(0).randint(0, 7, (500, 3))
    got = tprep._unique_rows(rows)
    want = np.unique(rows, return_inverse=True, return_counts=True, axis=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w).reshape(g.shape))


def _assert_items_equal(got, want):
    for (x, y), (wx, wy) in zip(got, want):
        assert x.dtype == wx.dtype and y.dtype == wy.dtype
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("normalized", [True, False])
def test_reader_items_equal_jax(trees, split, normalized):
    """Items drawn from RandomState(s) equal the JAX reader's from
    np.random.seed(s), exactly, over more files than the cache holds (its
    evictions draw from the same stream); the walk (len, scenes, start
    indices, files) is JAX's."""
    root, seed = trees["jax"], 11
    mine = S3DIS(root, 64, split=split, with_normalized_coords=normalized,
                 rng=np.random.RandomState(seed))[split]
    theirs = JS3DIS(root, 64, split=split,
                    with_normalized_coords=normalized)[split]
    assert len(mine) == len(theirs) > 0
    assert mine.scene_list == theirs.scene_list
    assert mine.index_to_filename == theirs.index_to_filename
    assert mine.filename_to_start_index == theirs.filename_to_start_index
    order = np.random.RandomState(1).randint(0, len(mine), 120)
    np.random.seed(seed)
    want = [theirs[int(i)] for i in order]
    got = [mine[int(i)] for i in order]
    assert got[0][0].shape == (64, 9 if normalized else 6)
    _assert_items_equal(got, want)
    if split == "train":
        assert len(set(mine.index_to_filename)) > mine.cache_size
        assert len(mine.cache) == mine.cache_size


def test_store_gives_the_h5_items(trees):
    """The reader over a WindowStore of the h5 files' arrays gives the
    items it gives over the files; the store knows only its paths."""
    root = trees["port"]
    store = WindowStore()
    for name in _files(root):
        if name.endswith(".h5"):
            path = os.path.join(root, name)
            with h5py.File(path, "r") as f:
                store[path] = {k: f[k][...] for k in f}
    via_h5 = S3DIS(root, 64, rng=np.random.RandomState(5))
    via_store = S3DIS(root, 64, rng=np.random.RandomState(5), opener=store)
    for split in ("train", "test"):
        order = np.random.RandomState(2).randint(0, len(via_h5[split]), 50)
        _assert_items_equal([via_store[split][int(i)] for i in order],
                            [via_h5[split][int(i)] for i in order])
    with pytest.raises(KeyError):
        store(os.path.join(root, "Area_9", "room_1", "zero_0.h5"))


def test_imports_without_h5py(tmp_path):
    """With h5py unimportable, every module of the port and chip_smoke.py
    import; the h5 opener and writer raise ImportError."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['h5py'] = None\n"
        "import pvcnn_tpu_torch\n"
        "for m in pkgutil.walk_packages(pvcnn_tpu_torch.__path__, "
        "'pvcnn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from pvcnn_tpu_torch.data.s3dis import open_h5\n"
        "from pvcnn_tpu_torch.data.prepare_s3dis import write_windows\n"
        "for call in (lambda: open_h5('x.h5'),\n"
        "             lambda: write_windows('x.h5', {})):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError:\n"
        "        print('ImportError')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ImportError", "ImportError"]


def test_prepare_cli(tmp_path):
    """python -m pvcnn_tpu_torch.data.prepare_s3dis -d <raw> -f <out>: the
    JAX flags (and --seed) write a room's npy and window files."""
    raw, out = str(tmp_path / "raw"), str(tmp_path / "out")
    write_raw(raw, np.random.RandomState(4), {"Area_5": 1})
    tprep.main(["-d", raw, "-f", out, "-m", str(MAX_POINTS), "-g", str(GRID),
                "--seed", "1"])
    room = os.path.join(out, "Area_5", "room_1")
    assert sorted(os.listdir(room)) == [".dataset", ".labels", "half_0.h5",
                                        "label.npy", "xyzrgb.npy",
                                        "zero_0.h5"]
    with h5py.File(os.path.join(room, "zero_0.h5"), "r") as f:
        assert f["data"].shape[1:] == (MAX_POINTS, 9)
