"""The port's host library (counterpart of pvcnn_tpu/native): ptio.cpp's
float-table parser and vote reducer, compiled at first use and loaded with
ctypes.

`ptio.cpp` is built with `g++ -O3 -shared -fPIC -std=c++17` (CXX) into
`build/pvcnn_tpu_torch/` at the repository root, the kernels' build
directory, under a name keyed by a hash of the source and the command, so
an edit rebuilds. It is written to a temporary name and renamed into place,
so processes that build at once (test workers) do not collide. A failed
build raises: nothing falls back. The plain versions, np.loadtxt (exact
only where each token rounds to the same float32 from float64 as by
strtof) and evaluate/votes.py:vote_reduce_max_plain, serve as references
only.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["BUILD_DIR", "CXX", "build", "library", "loadtxt",
           "vote_reduce_max"]

SOURCE = Path(__file__).resolve().parent / "ptio.cpp"
BUILD_DIR = SOURCE.parents[2] / "build" / "pvcnn_tpu_torch"
CXX = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17")

_F32 = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.POINTER(ctypes.c_int64)


def build() -> Path:
    """Compile ptio.cpp if it is not built yet -> the library's path.
    Raises RuntimeError with the compiler's output on failure."""
    digest = hashlib.sha256(" ".join(CXX).encode())
    digest.update(SOURCE.read_bytes())
    path = Path(BUILD_DIR) / f"ptio_{digest.hexdigest()[:16]}.so"
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [*CXX, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{' '.join(cmd)} did not run: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded host library, built at first use."""
    lib = ctypes.CDLL(str(build()))
    lib.parse_float_table.restype = ctypes.c_int64
    lib.parse_float_table.argtypes = [ctypes.c_char_p, ctypes.c_int64, _F32,
                                      ctypes.c_int64]
    lib.count_float_table.restype = ctypes.c_int64
    lib.count_float_table.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.vote_reduce_max.restype = None
    lib.vote_reduce_max.argtypes = [_F32, _I64, _I64, ctypes.c_int64, _F32,
                                    _I64]
    return lib


def loadtxt(path: str, num_cols: int | None = None) -> np.ndarray:
    """A whitespace-separated float table -> [rows, cols] float32, each
    token rounded once (strtof), a one-row file kept 2-D. `num_cols`
    defaults to the first non-blank line's token count; unparsable tokens
    are skipped, and a value count that is not a multiple of the columns
    raises ValueError."""
    with open(path, "rb") as f:
        buf = f.read()
    if num_cols is None:
        first = next((line for line in buf.splitlines() if line.split()),
                     b"")
        num_cols = max(len(first.split()), 1)
    lib = library()
    count = lib.count_float_table(buf, len(buf))
    out = np.empty(count, dtype=np.float32)
    n = lib.parse_float_table(buf, len(buf), out.ctypes.data_as(_F32), count)
    if n < 0 or n % num_cols:
        raise ValueError(f"{path}: {n} values do not fill rows of "
                         f"{num_cols} columns")
    return out[:n].reshape(-1, num_cols)


def vote_reduce_max(vote_confidences, vote_predictions, point_indices,
                    confidences: np.ndarray, predictions: np.ndarray) -> None:
    """ptio.cpp's reducer: in vote order, a vote replaces its point's kept
    (confidence, prediction) only if strictly more confident. The kept
    arrays are updated in place: float32 and int64, C-contiguous. Point
    indices must lie in [0, len(confidences))."""
    if confidences.dtype != np.float32 or predictions.dtype != np.int64 \
            or not (confidences.flags.c_contiguous
                    and predictions.flags.c_contiguous):
        raise TypeError("the kept votes must be C-contiguous float32 "
                        "confidences and int64 predictions")
    conf = np.ascontiguousarray(vote_confidences, dtype=np.float32)
    pred = np.ascontiguousarray(vote_predictions, dtype=np.int64)
    idx = np.ascontiguousarray(point_indices, dtype=np.int64)
    if not len(conf) == len(pred) == len(idx):
        raise ValueError("votes of unequal lengths")
    if len(idx) and (idx.min() < 0 or idx.max() >= len(confidences)):
        raise IndexError("a vote's point index is out of range")
    library().vote_reduce_max(conf.ctypes.data_as(_F32),
                              pred.ctypes.data_as(_I64),
                              idx.ctypes.data_as(_I64), len(conf),
                              confidences.ctypes.data_as(_F32),
                              predictions.ctypes.data_as(_I64))
