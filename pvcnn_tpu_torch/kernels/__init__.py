"""Build, load and count the port's hand-written CUDA kernels.

The sources in `pvcnn_tpu_torch/csrc/*.cu` export plain C functions. At first
use each is compiled by its own nvcc process, all started together, and the
objects are linked into one shared library under `build/pvcnn_tpu_torch/` at
the repository root (keyed by a hash of the sources and flags, so an edit
rebuilds). It is loaded with ctypes: pointers and the CUDA stream pass as
`c_void_p`, sizes as `c_int`. A failed build raises; nothing falls back.

Each kernel has a `Kernel` record with a plain-int launch counter. The op
wrappers (`pvcnn_tpu_torch/ops/`) add one to it where they launch the kernel
and nowhere else, so a run can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["KERNELS", "Kernel", "build", "call", "launch", "library",
           "launch_counts", "reset_launch_counts"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pvcnn_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# exported C function -> argument types (pointers, sizes, stream last)
_SIGNATURES = {
    "pvcnn_avg_voxelize_sort": [_P, _P, _P, _I, _I, _I, _P],
    "pvcnn_avg_voxelize": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "pvcnn_trilinear_devoxelize": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "pvcnn_conv3d_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _P],
    "pvcnn_conv3d_wgrad": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _I, _P],
    "pvcnn_devoxelize_bwd_sort": [_P, _P, _P, _I, _I, _I, _P],
    "pvcnn_devoxelize_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "pvcnn_fps": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "pvcnn_ball_query": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "pvcnn_three_nn": [_P, _P, _P, _P, _I, _I, _I, _P],
    "pvcnn_dense_rows_fwd": [_P, _P, _P, _P, _P, _F, _P, _P, _I, _I, _I, _I,
                             _P],
    "pvcnn_dense_rows_wgrad": [_P, _P, _P, _P, _F, _P, _P, _I, _I, _I, _I,
                               _I, _P],
    "pvcnn_conv3d_ndhwc_wgrad": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
}


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: what it replaces and how often it ran."""

    name: str
    source: str        # path in the repository
    replaces: str      # file:line of the TPU kernel it replaces
    launches: int = 0


KERNELS = {k.name: k for k in (
    Kernel("avg_voxelize", "pvcnn_tpu_torch/csrc/voxelize.cu",
           "pvcnn_tpu/ops/pallas/scatter.py:144"),
    Kernel("trilinear_devoxelize", "pvcnn_tpu_torch/csrc/devoxelize.cu",
           "pvcnn_tpu/ops/pallas/sorted_gather.py:178"),
    Kernel("conv3d_fwd", "pvcnn_tpu_torch/csrc/conv3d.cu",
           "pvcnn_tpu/ops/pallas/conv_rows.py:636"),
    # the same kernel as the conv's data gradient, counted apart
    Kernel("conv3d_dgrad", "pvcnn_tpu_torch/csrc/conv3d.cu",
           "pvcnn_tpu/ops/pallas/conv_rows.py:477"),
    Kernel("conv3d_wgrad", "pvcnn_tpu_torch/csrc/conv3d_wgrad.cu",
           "pvcnn_tpu/ops/pallas/conv_rows.py:527"),
    Kernel("devoxelize_bwd", "pvcnn_tpu_torch/csrc/devoxelize_bwd.cu",
           "pvcnn_tpu/ops/pallas/sorted_scatter.py:209"),
    # K1 in its sum mode, the take_rows backward, counted apart
    Kernel("scatter_sum", "pvcnn_tpu_torch/csrc/voxelize.cu",
           "pvcnn_tpu/ops/pallas/scatter.py:144"),
    Kernel("fps", "pvcnn_tpu_torch/csrc/fps.cu",
           "pvcnn_tpu/ops/pallas/fps.py:83"),
    Kernel("ball_query", "pvcnn_tpu_torch/csrc/select.cu",
           "pvcnn_tpu/ops/pallas/select.py:95"),
    Kernel("three_nn", "pvcnn_tpu_torch/csrc/select.cu",
           "pvcnn_tpu/ops/pallas/select.py:144"),
    Kernel("dense_rows_fwd", "pvcnn_tpu_torch/csrc/dense_rows.cu",
           "pvcnn_tpu/ops/pallas/dense_rows.py:119"),
    # K9 again as the dense layer's data gradient, counted apart
    Kernel("dense_rows_dgrad", "pvcnn_tpu_torch/csrc/dense_rows.cu",
           "pvcnn_tpu/ops/pallas/dense_rows.py:119"),
    Kernel("dense_rows_wgrad", "pvcnn_tpu_torch/csrc/dense_rows.cu",
           "pvcnn_tpu/ops/pallas/dense_rows.py:158"),
    Kernel("conv3d_ndhwc_wgrad", "pvcnn_tpu_torch/csrc/conv3d_ndhwc_wgrad.cu",
           "pvcnn_tpu/ops/pallas/conv_wgrad.py:166"),
)}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "pvcnn_tpu_torch kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(extra_flags=()) -> tuple[Path, float, str]:
    """Compile the kernel library if it is not built yet.

    Returns (library path, build seconds (0.0 when it was already built),
    nvcc's output). Raises RuntimeError with nvcc's output on failure."""
    cu, cuh = _sources()
    flags = NVCC_FLAGS + tuple(extra_flags)
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in cu + cuh:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    lib_path = BUILD_DIR / f"pvcnn_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path, 0.0, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs = [os.path.join(objdir, src.stem + ".o") for src in cu]
        cmds = [[nvcc, *flags, "-c", "-o", obj, str(src)]
                for src, obj in zip(cu, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{log}")
        tmp = os.path.join(objdir, lib_path.name)
        cmd = [nvcc, *flags, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{logs[-1]}")
        os.replace(tmp, lib_path)
    return lib_path, time.perf_counter() - start, "".join(logs)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib_path, _, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pvcnn_error_string.argtypes = [ctypes.c_int]
    lib.pvcnn_error_string.restype = ctypes.c_char_p
    return lib


def call(fn: str, *args) -> None:
    """Call exported launcher `fn` and raise if CUDA refused it (the
    launcher returns cudaGetLastError()). Counts nothing: a kernel's glue
    (K1's and K5's sorts) launches through here."""
    lib = library()
    code = getattr(lib, fn)(*args)
    if code != 0:
        msg = lib.pvcnn_error_string(code).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} (cudaError {code})")


def launch(kernel: str, fn: str, *args) -> None:
    """`call` the launcher `fn` of `kernel` and count the launch."""
    call(fn, *args)
    KERNELS[kernel].launches += 1
