#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pvcnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines and raising on failure:

  1. device     requires CUDA (exits non-zero without it), prints
                `nvidia-smi --query-gpu=name,power.limit`, turns TF32 off;
  2. build      compiles the CUDA kernels from pvcnn_tpu_torch/csrc;
  3. kernels    each kernel against its plain PyTorch version on the card,
                at the shapes ShapeNet PVCNN 1x gives it (B=32, N=2048):
                max abs/rel difference and median CUDA-event times;
  4. slice      PVCNN 1x eval forward on a 32 x 2048 x 22 batch with seeded
                weights: kernel path against the plain path on the card, and
                against the CPU plain path on a 2-cloud batch; every launch
                counter must move; ms/batch of both paths;
  5. evaluator  the voting evaluator (10 votes, batch 32) on a synthetic
                ShapeNet tree, from zeroed launch counters: the port's main
                path through its user entry point.

The last two lines are a JSON object with the per-kernel record and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

B, N, SEED = 32, 2048, 0
# kernel-vs-plain tolerances: K1/K2 sum a few fp32 terms in another order;
# K3 sums 27 * Ci terms in another order than cuDNN's fp32 (TF32 off) conv
TOL = {"avg_voxelize": (1e-5, 1e-6), "trilinear_devoxelize": (1e-5, 1e-6),
       "conv3d_fwd": (1e-4, 1e-4)}
# (kernel, case) -> calls per PVCNN 1x forward; cases: K1 (C, R), K2 (C, R),
# K3 (Ci, Co, R, prologue). Cases with 0 calls are checked but not timed
# into the per-forward sums.
CALLS = {
    ("avg_voxelize", (6, 32)): 1, ("avg_voxelize", (64, 16)): 1,
    ("avg_voxelize", (128, 16)): 1,
    ("trilinear_devoxelize", (64, 32)): 1,
    ("trilinear_devoxelize", (128, 16)): 2,
    ("conv3d_fwd", (6, 64, 32, False)): 1, ("conv3d_fwd", (6, 64, 32, True)): 0,
    ("conv3d_fwd", (64, 64, 32, False)): 0, ("conv3d_fwd", (64, 64, 32, True)): 1,
    ("conv3d_fwd", (64, 128, 16, False)): 1,
    ("conv3d_fwd", (64, 128, 16, True)): 0,
    ("conv3d_fwd", (128, 128, 16, False)): 1,
    ("conv3d_fwd", (128, 128, 16, True)): 2,
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def cloud(rng: np.random.RandomState, b: int, n: int) -> np.ndarray:
    """[b, n, 22] ShapeNet-like inputs: unit-normalized xyz on a noisy
    ellipsoid, unit normals, one-hot shape id."""
    dirs = rng.randn(b, n, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    xyz = dirs * np.array([1.0, 0.6, 0.3]) + 0.02 * rng.randn(b, n, 3)
    xyz -= xyz.mean(axis=1, keepdims=True)
    xyz /= np.linalg.norm(xyz, axis=-1).max(axis=1)[:, None, None]
    one_hot = np.zeros((b, n, 16))
    one_hot[np.arange(b), :, rng.randint(0, 16, b)] = 1.0
    return np.concatenate([xyz, dirs, one_hot], axis=-1).astype(np.float32)


@contextlib.contextmanager
def plain_on_card():
    """Route CUDA tensors to the plain PyTorch versions (the comparison
    path of this script; the package itself never does this)."""
    from pvcnn_tpu_torch.ops import conv3d, devoxelize, voxelize

    with mock.patch.object(voxelize, "_scatter_mean_cuda",
                           voxelize._scatter_mean_plain), \
            mock.patch.object(devoxelize, "_devoxelize_cuda",
                              devoxelize._devoxelize_plain), \
            mock.patch.object(conv3d, "_conv3d_cuda", conv3d._conv3d_plain):
        yield


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log("device", f"{name}, {torch.cuda.device_count()} device(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return name


def phase_build() -> None:
    from pvcnn_tpu_torch import kernels

    path, seconds, _ = kernels.build()
    kernels.library()
    log("build", f"{path.name} built in {seconds:.2f} s" if seconds
        else f"{path.name} already built")


def _compare(kernel, case, got, want) -> float:
    rtol, atol = TOL[kernel]
    err = (got - want).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{kernel} {case}: non-finite output")
    bad = err > atol + rtol * want.abs()
    big = want.abs() > 1e-3           # relative error where it means something
    rel = (err[big] / want.abs()[big]).max().item() if big.any() else 0.0
    log("kernels", f"{kernel} {case}: max_abs_err {err.max().item():.3e} "
        f"max_rel_err {rel:.3e} where |plain| > 1e-3 (rtol {rtol}, "
        f"atol {atol})")
    if bad.any():
        raise AssertionError(f"{kernel} {case}: {int(bad.sum())} elements "
                             "outside tolerance")
    return err.max().item()


def phase_kernels() -> dict:
    from pvcnn_tpu_torch import ops
    from pvcnn_tpu_torch.ops import conv3d, devoxelize, voxelize

    dev = torch.device("cuda")
    torch.manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    coords = torch.from_numpy(cloud(rng, B, N)[..., :3]).to(dev)
    rec = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in TOL}

    def record(kernel, case, err, run_k, run_p):
        ms, plain_ms = time_ms(run_k), time_ms(run_p)
        log("kernels", f"{kernel} {case}: {ms:.4f} ms vs plain "
            f"{plain_ms:.4f} ms ({CALLS[(kernel, case)]} per forward)")
        r = rec[kernel]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += CALLS[(kernel, case)] * ms
        r["plain_ms"] += CALLS[(kernel, case)] * plain_ms

    for c, r in ((6, 32), (64, 16), (128, 16)):
        vox, _ = ops.normalize_coords(coords, r, normalize=False)
        flat = ops.flat_voxel_index(vox, r)
        feats = torch.randn(B, N, c, device=dev)
        run_k = lambda: voxelize._scatter_mean_cuda(feats, flat, r ** 3, True)
        run_p = lambda: voxelize._scatter_mean_plain(feats, flat, r ** 3, True)
        got, again = run_k(), run_k()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"avg_voxelize {(c, r)}: two runs differ")
        log("kernels", f"avg_voxelize {(c, r)}: two runs bitwise equal")
        err = _compare("avg_voxelize", (c, r), got, run_p())
        record("avg_voxelize", (c, r), err, run_k, run_p)

    for c, r in ((64, 32), (128, 16)):
        _, norm = ops.normalize_coords(coords, r, normalize=False)
        grid = torch.randn(B, c, r ** 3, device=dev)
        run_k = lambda: devoxelize._devoxelize_cuda(grid, norm, r, True)
        run_p = lambda: devoxelize._devoxelize_plain(grid, norm, r, True)
        err = _compare("trilinear_devoxelize", (c, r), run_k(), run_p())
        record("trilinear_devoxelize", (c, r), err, run_k, run_p)

    for ci, co, r in ((6, 64, 32), (64, 64, 32), (64, 128, 16),
                      (128, 128, 16)):
        bound = 1.0 / (27 * ci) ** 0.5
        x = torch.randn(B, ci, r ** 3, device=dev)
        w = torch.empty(co, ci, 3, 3, 3, device=dev).uniform_(-bound, bound)
        bias = torch.empty(co, device=dev).uniform_(-bound, bound)
        scale = torch.empty(ci, device=dev).uniform_(0.5, 1.5)
        shift = torch.randn(ci, device=dev) * 0.5
        for pro in (False, True):
            args = (x, w, bias, scale, shift, r, pro)
            run_k = lambda: conv3d._conv3d_cuda(*args)
            run_p = lambda: conv3d._conv3d_plain(*args)
            case = (ci, co, r, pro)
            got, want = run_k(), run_p()
            err = _compare("conv3d_fwd", case, got, want)
            exact = conv3d._conv3d_plain(*(a.double() for a in args[:5]),
                                         r, pro)
            log("kernels", f"conv3d_fwd {case}: max |. - fp64 conv| kernel "
                f"{(got - exact).abs().max().item():.3e}, plain "
                f"{(want - exact).abs().max().item():.3e}")
            record("conv3d_fwd", case, err, run_k, run_p)
    for k, r in rec.items():
        log("kernels", f"{k}: {r['ms']:.4f} ms per forward vs plain "
            f"{r['plain_ms']:.4f} ms")
    return rec


def phase_slice() -> None:
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.models.shapenet import PVCNN
    from pvcnn_tpu_torch.utils.weights import init_random_

    dev = torch.device("cuda")
    model = init_random_(PVCNN(50, 16, 3, width_multiplier=1.0), SEED).eval()
    x_all = cloud(np.random.RandomState(SEED + 1), B, N)
    x_cpu = torch.from_numpy(x_all[:2])
    with torch.inference_mode():
        want_small = model(x_cpu)                  # CPU: the plain versions
    model = model.to(dev)
    x = torch.from_numpy(x_all).to(dev)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        logits = model(x)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        with plain_on_card():
            plain = model(x)
        small = model(x_cpu.to(dev)).cpu()
        if logits.shape != (B, N, 50) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
        log("slice", f"launches in one forward: {counts}")
        if min(counts.values()) == 0:
            raise AssertionError(f"a kernel did not run: {counts}")
        diff = (logits - plain).abs().max().item()
        agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
        diff_cpu = (small - want_small).abs().max().item()
        log("slice", f"kernel vs plain path on the card: max |dlogit| "
            f"{diff:.3e} (atol 1e-3), argmax agreement {agree:.6f} (>= 0.999)")
        log("slice", f"kernel path on the card vs plain path on the CPU "
            f"(2 clouds): max |dlogit| {diff_cpu:.3e} (atol 1e-3)")
        if diff > 1e-3 or agree < 0.999 or diff_cpu > 1e-3:
            raise AssertionError("slice forward disagrees with the plain path")
        ms_k, ms_p = [], []
        for _ in range(3):                         # in turns: kernel, plain
            ms_k.append(time_ms(lambda: model(x), reps=5, warmup=1))
            with plain_on_card():
                ms_p.append(time_ms(lambda: model(x), reps=5, warmup=1))
    log("slice", f"PVCNN 1x forward, {B} x {N}: kernel path "
        f"{np.median(ms_k):.3f} ms/batch, plain path {np.median(ms_p):.3f} "
        f"ms/batch (medians of {ms_k} / {ms_p})")


def phase_evaluator() -> dict:
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.data.shapenet import write_synthetic
    from pvcnn_tpu_torch.evaluate.shapenet.eval import evaluate, mean_iou

    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as root:
        # 2 categories x 2 shapes of 2000-3000 points
        num_items = len(write_synthetic(
            root, [(0, 2417), (0, 2946), (4, 2081), (4, 2590)], seed=SEED))
        kernels.reset_launch_counts()
        start = time.perf_counter()
        stats = evaluate(root, width_multiplier=1.0, num_votes=10,
                         batch_size=32, device="cuda", seed=SEED)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = kernels.launch_counts()
    if stats.shape != (16, 2) or not np.isfinite(stats).all() \
            or int(stats[:, 1].sum()) != num_items:
        raise AssertionError(f"bad evaluator stats {stats}")
    log("evaluator", f"{num_items} synthetic shapes, 10 votes, batch 32: "
        f"{seconds:.2f} s, mIoU {mean_iou(stats):.4f} (random weights, "
        f"synthetic labels), launches {counts}")
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel did not run: {counts}")
    return counts


def main() -> None:
    name = phase_device()
    phase_build()
    rec = phase_kernels()
    phase_slice()
    counts = phase_evaluator()
    from pvcnn_tpu_torch import kernels

    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": counts[k.name],
         "max_abs_err": rec[k.name]["max_abs_err"], "ms": rec[k.name]["ms"],
         "plain_ms": rec[k.name]["plain_ms"]}
        for k in kernels.KERNELS.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
