"""The port's host library (pvcnn_tpu_torch/native, built here with g++)
against the JAX package's (pvcnn_tpu.native on its C++ path): the float
table parser bit for bit, on tokens near a float32 tie too, where
np.loadtxt(dtype=float32) rounds twice and differs; the ShapeNet reader's
items and the voting evaluator's inputs on such a table, against JAX's;
the vote reducer exactly, against JAX's C++ path and the plain lexsort;
the call sites on the library, with no fallback, and a failed build."""

import decimal
import os

import numpy as np
import pytest

from pvcnn_tpu import native as jnative
from pvcnn_tpu.data.shapenet import ShapeNet
from pvcnn_tpu_torch import native
from pvcnn_tpu_torch.data import shapenet as tdata
from pvcnn_tpu_torch.evaluate import votes
from pvcnn_tpu_torch.evaluate.shapenet import eval as teval


@pytest.fixture(autouse=True)
def _native_paths(monkeypatch):
    """The JAX package on its C++ path."""
    monkeypatch.delenv("PVCNN_TPU_NO_NATIVE", raising=False)
    assert jnative.available()


def tie_tokens(rng, n):
    """n decimal tokens just past the midpoint between a float32 with an
    even last mantissa bit and its neighbour away from zero: float64
    parses them to the midpoint, which rounds to the even float32 (the
    nearer to zero), while strtof rounds them once, away from zero."""
    out = []
    with decimal.localcontext() as ctx:
        ctx.prec = 50
        while len(out) < n:
            f = np.float32(rng.uniform(1e-3, 1e3))
            if f.view(np.int32) & 1:
                continue
            up = np.nextafter(f, np.float32(np.inf))
            mid = decimal.Decimal((float(f) + float(up)) / 2)
            token = f"{mid * (1 + decimal.Decimal('1e-24')):.30e}"
            out.append(token if rng.rand() < 0.5 else "-" + token)
    return out


def _write(path, text):
    with open(path, "w", newline="") as f:
        f.write(text)
    return path


def test_tie_tokens_round_once(tmp_path):
    """A token just past the tie between 1.0 and its neighbour: strtof's
    1.0000001192092896, where np.loadtxt(dtype=float32) gives 1.0."""
    path = _write(tmp_path / "t.txt", "1.00000005960464477550 2 3\n")
    got = native.loadtxt(str(path))
    assert got.shape == (1, 3) and got[0, 0] == np.float32(1.0000001192092896)
    np.testing.assert_array_equal(got, jnative.loadtxt(str(path)))
    assert np.loadtxt(str(path), dtype=np.float32)[0] == np.float32(1.0)


@pytest.mark.parametrize("case", ["random", "ties", "blank_crlf", "one_row",
                                  "junk"])
def test_loadtxt_matches_jax_native(tmp_path, case):
    """Bit for bit the JAX package's C++ parser: full-precision random
    tables, tie tokens (where np.loadtxt differs), blank lines and CRLF
    line ends, a one-row table (kept 2-D), an unparsable token (skipped)."""
    rng = np.random.RandomState(len(case))
    if case == "ties":
        rows = np.array(tie_tokens(rng, 7 * 40)).reshape(40, 7)
    else:
        values = rng.randn(1 if case == "one_row" else 50, 7) * \
            10.0 ** rng.randint(-6, 6, (1, 7))
        rows = np.vectorize(repr)(values)
    lines = [" ".join(r) for r in rows]
    if case == "blank_crlf":
        lines = lines[:5] + [""] + lines[5:] + ["", ""]
    if case == "junk":
        lines[3] += " abc"
    end = "\r\n" if case == "blank_crlf" else "\n"
    path = str(_write(tmp_path / f"{case}.txt", end.join(lines) + end))
    got = native.loadtxt(path)
    want = jnative.loadtxt(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape == (len(rows), 7)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if case == "ties":
        assert (np.loadtxt(path, dtype=np.float32) != got).all()


def test_loadtxt_refuses_ragged_tables(tmp_path):
    path = str(_write(tmp_path / "r.txt", "1 2 3\n4 5\n"))
    with pytest.raises(ValueError, match="columns"):
        native.loadtxt(path)
    np.testing.assert_array_equal(native.loadtxt(path, num_cols=5),
                                  [[1, 2, 3, 4, 5]])


@pytest.fixture(scope="module")
def tie_tree(tmp_path_factory):
    """A synthetic ShapeNet tree whose item tables hold tie tokens in
    every coordinate and normal column."""
    root = str(tmp_path_factory.mktemp("shapenet_ties"))
    tdata.write_synthetic(root, [(0, 90), (3, 70), (9, 60)])
    rng = np.random.RandomState(11)
    for path, _ in tdata.file_paths(root, "test"):
        labels = np.loadtxt(path)[:, -1].astype(int)
        tokens = np.array(tie_tokens(rng, 6 * len(labels))).reshape(-1, 6)
        with open(path, "w") as f:
            for row, label in zip(tokens, labels):
                f.write(" ".join(row) + f" {label}\n")
    return root


def test_shapenet_items_match_jax_on_tie_tokens(tie_tree):
    """Step 0's repair: the port's reader parses as JAX's does, so its
    items equal JAX _ShapeNetDataset's bit for bit on a table of tie
    tokens; the port's former np.loadtxt parse gives other values."""
    mine = tdata.ShapeNetDataset(tie_tree, 64, "train", seed=4)
    theirs = ShapeNet(tie_tree, 64, split="train")["train"]
    np.random.seed(4)
    for i in (0, 1, 2, 4, 4):
        f_m, y_m = mine[i]
        f_t, y_t = theirs[i]
        np.testing.assert_array_equal(y_m, y_t)
        np.testing.assert_array_equal(f_m.view(np.int32), f_t.view(np.int32))
    for path, _ in tdata.file_paths(tie_tree, "train"):
        got = native.loadtxt(path)
        np.testing.assert_array_equal(got, jnative.loadtxt(path))
        assert (np.loadtxt(path, dtype=np.float32, ndmin=2)[:, :6]
                != got[:, :6]).all()


def test_shapenet_evaluator_inputs_match_jax_on_tie_tokens(tie_tree):
    """The voting evaluator's sub-clouds are the JAX evaluator's: its
    point sets built from pvcnn_tpu.native.loadtxt and the JAX dataset's
    normalization, shuffled by the same seeded generator."""
    seen = []

    def predict(chunk):
        seen.append(chunk.copy())
        return np.full(chunk.shape[:2] + (50,), 1 / 50, np.float32)

    num_points, num_votes, batch = 32, 2, 4
    teval.evaluate_with(predict, tie_tree, num_points=num_points,
                        num_votes=num_votes, batch_size=batch, seed=3)
    rng = np.random.RandomState(3)
    want = []
    for path, shape_id in tdata.file_paths(tie_tree, "test"):
        data = jnative.loadtxt(path)
        one_hot = np.zeros((len(data), 16), np.float32)
        one_hot[:, shape_id] = 1.0
        point_set = np.concatenate([_jax_normalize(data[:, :3]),
                                    data[:, 3:6], one_hot], axis=-1)
        extra = num_votes * -(-len(data) // num_points)
        shuffled = np.tile(np.arange(len(data)),
                           -(-extra * num_points // len(data)))
        shuffled = shuffled[:extra * num_points]
        rng.shuffle(shuffled)
        clouds = point_set[shuffled].reshape(extra, num_points, -1)
        for start in range(0, extra, batch):
            chunk = clouds[start:start + batch]
            if len(chunk) < batch:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[:1], batch - len(chunk), 0)])
            want.append(chunk)
    assert len(seen) == len(want)
    for got, ref in zip(seen, want):
        np.testing.assert_array_equal(got.view(np.int32),
                                      ref.astype(np.float32).view(np.int32))


def _jax_normalize(coords):
    from pvcnn_tpu.data.shapenet import _ShapeNetDataset

    return _ShapeNetDataset.normalize_point_cloud(coords)


def _votes(rng, points, n, call):
    """Votes with many exact ties: confidences in quarters, point indices
    repeated, predictions that differ between tied votes."""
    conf = rng.randint(0, 5, n).astype(np.float32) / 4
    idx = rng.randint(0, points, n).astype(np.int64)
    pred = (rng.randint(0, 13, n) + call).astype(np.int64)
    return conf, pred, idx


@pytest.mark.parametrize("seed", range(3))
def test_vote_reduce_max_matches_jax_native_and_plain(seed):
    """Four calls into one scene whose kept votes start non-empty: the
    port's reducer, JAX's C++ reducer and the plain lexsort keep the same
    confidences and predictions, the first of equal votes winning within
    a call and across calls."""
    rng = np.random.RandomState(seed)
    points = 80
    calls = [_votes(rng, points, 600, call) for call in range(4)]
    start_conf = (rng.randint(0, 3, points) / 4).astype(np.float32)
    start_pred = rng.randint(-1, 13, points).astype(np.int64)
    outs = []
    for fn in (votes.vote_reduce_max, native.vote_reduce_max,
               jnative.vote_reduce_max, votes.vote_reduce_max_plain):
        conf, pred = start_conf.copy(), start_pred.copy()
        for c, p, i in calls:
            fn(c, p, i, conf, pred)
        outs.append((conf, pred))
    for conf, pred in outs[1:]:
        np.testing.assert_array_equal(conf, outs[0][0])
        np.testing.assert_array_equal(pred, outs[0][1])
    assert (outs[0][0] > start_conf).any() and (outs[0][0] == 1.0).any()


def test_vote_reduce_max_refuses_bad_kept_arrays():
    conf, pred, idx = _votes(np.random.RandomState(0), 10, 20, 0)
    with pytest.raises(TypeError):
        native.vote_reduce_max(conf, pred, idx, np.zeros(10),
                               np.zeros(10, np.int64))
    with pytest.raises(IndexError):
        native.vote_reduce_max(conf, pred, idx + 10, np.zeros(10, np.float32),
                               np.zeros(10, np.int64))


def test_call_sites_take_the_library(tmp_path, monkeypatch):
    """The ShapeNet reader's and evaluator's parser and the voting
    evaluators' reducer go through the library, with no plain fallback:
    made to raise, library() raises from each."""
    def refuse():
        raise RuntimeError("the library was used")

    monkeypatch.setattr(native, "library", refuse)
    path = str(_write(tmp_path / "t.txt", "0.5 1.5\n"))
    with pytest.raises(RuntimeError, match="library was used"):
        native.loadtxt(path)
    assert votes.vote_reduce_max is native.vote_reduce_max
    assert tdata.native is native and teval.native is native
    conf, pred, idx = _votes(np.random.RandomState(0), 10, 20, 0)
    with pytest.raises(RuntimeError, match="library was used"):
        votes.vote_reduce_max(conf, pred, idx, np.zeros(10, np.float32),
                              np.zeros(10, np.int64))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails raises RuntimeError with its output, from
    build() and from a call that needs the library; nothing falls back."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", ("g++", "--no-such-flag", "-shared"))
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no-such-flag"):
            native.build()
        path = str(_write(tmp_path / "t.txt", "1 2\n"))
        with pytest.raises(RuntimeError, match="failed"):
            native.loadtxt(path)
        assert not any(p.suffix == ".so"
                       for p in (tmp_path / "build").iterdir())
    finally:
        native.library.cache_clear()


def test_build_is_keyed_by_source_and_command(tmp_path, monkeypatch):
    """A fresh build directory gets one library named by the hash of the
    source and the command; a second build finds it."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    first = native.build()
    assert first.parent == tmp_path and first.name.startswith("ptio_")
    assert native.build() == first
    assert [p.name for p in tmp_path.iterdir()] == [first.name]
    monkeypatch.setattr(native, "CXX", native.CXX + ("-DVARIANT",))
    assert native.build() != first
    assert os.path.getsize(first) > 0
