#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pvcnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Three main paths: ShapeNet PVCNN 1x (B = 32, N = 2048), S3DIS PVCNN2 1x
(B = 32, N = 8192, 9 channels, 13 classes) and S3DIS PVCNN 1x (B = 32,
N = 4096, 9 channels, 13 classes) with the three switches that open its
opt-in path (PVCNN_TPU_DENSE_BN_FUSED=auto, PVCNN_TPU_CONV_ROWS=0,
PVCNN_TPU_CUSTOM_CONV_WGRAD=1). Phases, each printing its own lines and
raising on failure:

  1. device     requires CUDA (exits non-zero without it), prints
                `nvidia-smi --query-gpu=name,power.limit`, turns TF32 off;
  2. build      compiles the CUDA kernels from pvcnn_tpu_torch/csrc;
  3. kernels    each kernel against its plain PyTorch version on the card,
                at the shapes ShapeNet PVCNN 1x training gives it: two runs
                bitwise equal, max abs/rel difference, median CUDA-event
                times of the kernel, the plain version and (where one
                PyTorch call computes the same function) that call, and the
                least time the card could take (bound); K1's and K5's
                times also split into their sort glue and the kernel
                alone, with their longest runs; K3's tile and split of
                its reduction per case, and where it splits, its time
                with and without the split, in turns; K4's plan per case
                (tile, z-segment, splits, partial-buffer bytes) and its
                share of its bound;
  4. slice      PVCNN 1x eval forward on a 32 x 2048 x 22 batch with seeded
                weights: kernel path against the plain path on the card, and
                against the CPU plain path on a 2-cloud batch; ms/batch;
  5. evaluator  the voting evaluator (5 votes, batch 32) on a synthetic
                ShapeNet tree, from zeroed launch counters: the eval path
                through its user entry point;
  6. train      PVCNN 1x training steps (Adam, dropout from one seeded
                generator) on the kernel path and on the plain path from the
                same weights: step-1 loss and gradients, losses of steps 2-3,
                bitwise-equal step-1 gradients over two kernel-path runs,
                launches per step, ms/step and peak memory of both paths
                (with --profile: a torch.profiler breakdown of 3 steps);
  7. trainer    the training entry point (one epoch of 4 steps at batch 32
                on a synthetic tree of 64 shapes, then the test split), from
                zeroed launch counters: the ShapeNet main path; its
                checkpoints are written and a resumed run loads them;
  8. pvcnn2 kernels
                the same as phase 3 at the shapes PVCNN2 training gives
                every kernel (FPS, ball query, three-NN, K1's sum mode for
                the take_rows backward, K1-K5 at R = 32, 16, 8), on
                synthetic S3DIS windows; the index kernels must equal their
                plain versions exactly; each FPS case logs its launch plan
                (cluster, threads, points per thread), its chain floor (the
                kernel's argmax and exchange alone) and the share of its
                bound (the larger of chain floor and FLOP bound); each
                three-NN case its plan, device time and share of its
                bound; then, not counted per step, ball query on a dense
                cloud at U = 32 and U = 2,048 and three-NN at the coming
                PointNet++ paths' shapes (NN_MORE), held exactly to the
                plain versions;
  9. pvcnn2 slice
                PVCNN2 eval forward, as phase 4;
 10. pvcnn2 train
                PVCNN2 training steps (Adam, weight decay 1e-5), as phase 6
                (with --profile: its torch.profiler breakdown too);
 11. pvcnn2 trainer
                from zeroed launch counters, Trainer.train_epoch (4 steps of
                the c1 recipe: Adam lr 1e-3, weight decay 1e-5, cosine
                schedule) and Trainer.evaluate with MeterS3DIS iou and
                overall, through data/loader.py's DataLoader over in-memory
                windows, and a save_checkpoint/load_checkpoint round trip:
                the PVCNN2 main path;
 12. pvcnn kernels
                the same as phase 3 for both paths of S3DIS PVCNN 1x
                training: on the default path K1-K5 channel-major at its
                eight convs; on the opt-in path K9 (with and without its
                prologue), its dgrad and K10 at the six fused SharedMLP
                layers' shapes (131,072 rows), K11 at the eight convs'
                shapes, K1/K2/K5 in their channel-last modes;
 13. pvcnn slice
                S3DIS PVCNN 1x eval forward (default path), as phase 4;
 14. pvcnn train
                S3DIS PVCNN 1x training steps, as phase 10, first with the
                switches off (K1-K5), then on (K9-K11 and K1/K2/K5
                channel-last); the switched-on step 1 against the
                switched-off one (the same function in another order);
                then each of the six mixed settings of the switches: its
                launches per step, step 1 against the switched-off one,
                ms/step;
 15. pvcnn trainer
                as phase 11, with the switches off and then on: the two
                S3DIS PVCNN main paths.

The last two lines are a JSON object with the per-kernel record and
{"ok": true, "device": {...}}. A kernel's `launches` sums its launches in
the trainer phases (7, 11 and both runs of 15); its times, bounds and
library time are per training step, summed over the paths' steps (each
path's own numbers under "paths"; K1's and K5's records there also carry
glue_ms and kernel_alone_ms, the two parts of their ms).
"""

from __future__ import annotations

import contextlib
import copy
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
N2 = 8192                    # S3DIS PVCNN2 window size
N3 = 4096                    # S3DIS PVCNN window size
DEVICE = "cuda"
# the card's peaks (NVIDIA H100 SXM data sheet): fp32 outside the tensor
# cores and HBM bandwidth; the bound of a call is the larger of its FLOPs
# over the first and its bytes (inputs read once, outputs written once)
# over the second
PEAK_FP32_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# kernel-vs-plain tolerances (rtol, atol): K1/K2/K5 and K1's sum mode sum a
# few fp32 terms in another order; K3 and its dgrad sum 27 * Ci terms in
# another order than cuDNN's fp32 (TF32 off) conv; K9 and its dgrad sum
# Ci (Co) products in another order than cuBLAS; K4, K10 and K11 sum
# B * R^3 (or B * N) products, so their atol is relative to the gradient's
# largest entry. The index kernels (fps, ball_query, three_nn) must equal
# their plain versions exactly; three_nn's d² and weights are held to 1e-5.
TOL = {"avg_voxelize": (1e-5, 1e-6), "trilinear_devoxelize": (1e-5, 1e-6),
       "conv3d_fwd": (1e-4, 1e-4), "conv3d_dgrad": (1e-4, 1e-4),
       "conv3d_wgrad": (1e-4, 1e-4), "devoxelize_bwd": (1e-5, 1e-5),
       "scatter_sum": (1e-5, 1e-5), "three_nn": (1e-5, 1e-5),
       "fps": (0.0, 0.0), "ball_query": (0.0, 0.0),
       "dense_rows_fwd": (1e-4, 1e-4), "dense_rows_dgrad": (1e-4, 1e-4),
       "dense_rows_wgrad": (1e-4, 1e-4), "conv3d_ndhwc_wgrad": (1e-4, 1e-4)}
# (kernel, case) -> calls per ShapeNet PVCNN 1x training step (the
# forward's calls are the eval forward's too). Cases: K1/K2/K5 (C, R, N);
# K3 and K4 (Ci, Co, R, prologue) of the forward conv; dgrad (Co, Ci, R) of
# the forward conv it differentiates (the dgrad maps Co -> Ci channels).
# Cases with 0 calls are checked but not timed.
CALLS = {
    ("avg_voxelize", (6, 32, N)): 1, ("avg_voxelize", (64, 16, N)): 1,
    ("avg_voxelize", (128, 16, N)): 1,
    ("trilinear_devoxelize", (64, 32, N)): 1,
    ("trilinear_devoxelize", (128, 16, N)): 2,
    ("conv3d_fwd", (6, 64, 32, False)): 1,
    ("conv3d_fwd", (6, 64, 32, True)): 0,
    ("conv3d_fwd", (64, 64, 32, False)): 0,
    ("conv3d_fwd", (64, 64, 32, True)): 1,
    ("conv3d_fwd", (64, 128, 16, False)): 1,
    ("conv3d_fwd", (64, 128, 16, True)): 0,
    ("conv3d_fwd", (128, 128, 16, True)): 2,
    ("conv3d_fwd", (128, 128, 16, False)): 1,
    ("conv3d_dgrad", (64, 64, 32)): 1,
    ("conv3d_dgrad", (128, 64, 16)): 1,
    ("conv3d_dgrad", (128, 128, 16)): 3,
    ("devoxelize_bwd", (64, 32, N)): 1, ("devoxelize_bwd", (128, 16, N)): 2,
}
# The same per S3DIS PVCNN2 1x training step, from the model's structure:
# the PVConv blocks (Ci -> Co, R, points) SA1 (9 -> 32, 32, 8192) and
# (32 -> 32, 32, 8192); SA2 3 x (64 -> 64, 16, 1024); SA3 3 x (128 -> 128,
# 8, 256); FP1 (256 -> 256, 8, 64); FP2 (256 -> 256, 8, 256); FP3 2 x
# (128 -> 128, 16, 1024); FP4 (64 -> 64, 32, 8192). The first conv0 runs no
# dgrad. Then FPS (N, M), ball query (M, N, radius, U) and three-NN (N, M)
# per level, and K1's sum mode (K rows, bins, C) for the take_rows
# backwards of the 4 SA groupings and the 4 FP interpolations.
CALLS2 = {
    ("avg_voxelize", (9, 32, 8192)): 1, ("avg_voxelize", (32, 32, 8192)): 1,
    ("avg_voxelize", (64, 16, 1024)): 3, ("avg_voxelize", (128, 8, 256)): 3,
    ("avg_voxelize", (256, 8, 64)): 1, ("avg_voxelize", (256, 8, 256)): 1,
    ("avg_voxelize", (128, 16, 1024)): 2,
    ("avg_voxelize", (64, 32, 8192)): 1,
    ("conv3d_fwd", (9, 32, 32, False)): 1,
    ("conv3d_fwd", (32, 32, 32, False)): 1,
    ("conv3d_fwd", (32, 32, 32, True)): 2,
    ("conv3d_fwd", (64, 64, 16, False)): 3,
    ("conv3d_fwd", (64, 64, 16, True)): 3,
    ("conv3d_fwd", (128, 128, 8, False)): 3,
    ("conv3d_fwd", (128, 128, 8, True)): 3,
    ("conv3d_fwd", (256, 256, 8, False)): 2,
    ("conv3d_fwd", (256, 256, 8, True)): 2,
    ("conv3d_fwd", (128, 128, 16, False)): 2,
    ("conv3d_fwd", (128, 128, 16, True)): 2,
    ("conv3d_fwd", (64, 64, 32, False)): 1,
    ("conv3d_fwd", (64, 64, 32, True)): 1,
    ("conv3d_dgrad", (32, 32, 32)): 3, ("conv3d_dgrad", (64, 64, 16)): 6,
    ("conv3d_dgrad", (128, 128, 8)): 6, ("conv3d_dgrad", (256, 256, 8)): 4,
    ("conv3d_dgrad", (128, 128, 16)): 4, ("conv3d_dgrad", (64, 64, 32)): 2,
    ("fps", (8192, 1024)): 1, ("fps", (1024, 256)): 1, ("fps", (256, 64)): 1,
    ("fps", (64, 16)): 1,
    ("ball_query", (1024, 8192, 0.1, 32)): 1,
    ("ball_query", (256, 1024, 0.2, 32)): 1,
    ("ball_query", (64, 256, 0.4, 32)): 1,
    ("ball_query", (16, 64, 0.8, 32)): 1,
    ("three_nn", (64, 16)): 1, ("three_nn", (256, 64)): 1,
    ("three_nn", (1024, 256)): 1, ("three_nn", (8192, 1024)): 1,
    ("scatter_sum", (32768, 8192, 32)): 1,
    ("scatter_sum", (8192, 1024, 64)): 1,
    ("scatter_sum", (2048, 256, 128)): 1, ("scatter_sum", (512, 64, 256)): 1,
    ("scatter_sum", (192, 16, 512)): 1, ("scatter_sum", (768, 64, 256)): 1,
    ("scatter_sum", (3072, 256, 256)): 1,
    ("scatter_sum", (24576, 1024, 128)): 1,
}
# three-NN (N, M) on the PointNet++ paths still to be ported, timed and held
# to the plain version, not counted per step: ShapeNet PointNet2's feature
# propagation (pvcnn_tpu/models/shapenet/pointnetpp.py:108-121; (128, 1)
# against the group-all level's single center) and Frustum PointNet2's
# (pvcnn_tpu/models/kitti/frustum/segmentation.py:110-117)
NN_MORE = ((2048, 512), (512, 128), (128, 1), (1024, 128), (128, 32),
           (32, 1))
# a PVConv's devoxelize and its backward run at (Co, R, points)
for _case, _n in (((32, 32, 8192), 2), ((64, 16, 1024), 3),
                  ((128, 8, 256), 3), ((256, 8, 64), 1), ((256, 8, 256), 1),
                  ((128, 16, 1024), 2), ((64, 32, 8192), 1)):
    CALLS2[("trilinear_devoxelize", _case)] = _n
    CALLS2[("devoxelize_bwd", _case)] = _n
# The same per S3DIS PVCNN 1x training step, from the model's structure:
# PVConvs (Ci -> Co, R) 9 -> 64 at 32, 2 x 64 -> 64 at 16, 64 -> 128 at 16,
# without SE. On the default path (switches off) K1/K2/K5 run channel-major
# (C, R, N) and K3/K4 at each PVConv's two convs; the first conv0 runs no
# dgrad.
CALLS3 = {
    ("avg_voxelize", (9, 32, N3)): 1, ("avg_voxelize", (64, 16, N3)): 3,
    ("conv3d_fwd", (9, 64, 32, False)): 1,
    ("conv3d_fwd", (64, 64, 32, True)): 1,
    ("conv3d_fwd", (64, 64, 16, False)): 2,
    ("conv3d_fwd", (64, 64, 16, True)): 2,
    ("conv3d_fwd", (64, 128, 16, False)): 1,
    ("conv3d_fwd", (128, 128, 16, True)): 1,
    ("conv3d_dgrad", (64, 64, 32)): 1, ("conv3d_dgrad", (64, 64, 16)): 4,
    ("conv3d_dgrad", (128, 64, 16)): 1, ("conv3d_dgrad", (128, 128, 16)): 1,
}
# On the opt-in path (switches on) K1/K2/K5 run channel-last (C, R, N) and
# K11 (Ci, Co, R) serves both convs of each PVConv; the fused SharedMLP
# layers (Ci, Co) are the four point branches, 128 -> 1024 and the
# classifier's 512 -> 256 (its first layer takes a list and stays unfused),
# on B * N rows: K9 and K10 (Ci, Co, prologue), the dgrad (Co, Ci) of the
# layer it differentiates (the first point branch's input is the cloud: no
# dgrad).
CALLS3_ON = {
    ("avg_voxelize", (9, 32, N3)): 1, ("avg_voxelize", (64, 16, N3)): 3,
    ("dense_rows_fwd", (9, 64, False)): 1,
    ("dense_rows_fwd", (64, 64, False)): 2,
    ("dense_rows_fwd", (64, 64, True)): 0,
    ("dense_rows_fwd", (64, 128, False)): 1,
    ("dense_rows_fwd", (128, 1024, False)): 1,
    ("dense_rows_fwd", (512, 256, False)): 1,
    ("dense_rows_fwd", (512, 256, True)): 0,
    ("dense_rows_dgrad", (64, 64)): 2, ("dense_rows_dgrad", (128, 64)): 1,
    ("dense_rows_dgrad", (1024, 128)): 1, ("dense_rows_dgrad", (256, 512)): 1,
    ("conv3d_ndhwc_wgrad", (9, 64, 32)): 1,
    ("conv3d_ndhwc_wgrad", (64, 64, 32)): 1,
    ("conv3d_ndhwc_wgrad", (64, 64, 16)): 4,
    ("conv3d_ndhwc_wgrad", (64, 128, 16)): 1,
    ("conv3d_ndhwc_wgrad", (128, 128, 16)): 1,
}
for _calls in (CALLS3, CALLS3_ON):
    for _case, _n in (((64, 32, N3), 1), ((64, 16, N3), 2),
                      ((128, 16, N3), 1)):
        _calls[("trilinear_devoxelize", _case)] = _n
        _calls[("devoxelize_bwd", _case)] = _n
for _calls in (CALLS, CALLS2, CALLS3, CALLS3_ON):
    for (_k, _c), _n in list(_calls.items()):
        if _k == "conv3d_fwd":
            _calls[("conv3d_wgrad", _c)] = _n
        if _k == "dense_rows_fwd":
            _calls[("dense_rows_wgrad", _c)] = _n
# the JAX package's switches that open S3DIS PVCNN's opt-in path
SWITCHES = {"PVCNN_TPU_DENSE_BN_FUSED": "auto", "PVCNN_TPU_CONV_ROWS": "0",
            "PVCNN_TPU_CUSTOM_CONV_WGRAD": "1"}


def per_step3(on: frozenset) -> dict:
    """Launches per S3DIS PVCNN 1x training step with the switches in `on`
    set and the others at their defaults. CUSTOM_CONV_WGRAD acts only on
    the NDHWC branch, which CONV_ROWS=0 opens."""
    if "PVCNN_TPU_CONV_ROWS" in on:
        steps = {"avg_voxelize": 4, "trilinear_devoxelize": 4,
                 "devoxelize_bwd": 4}
        if "PVCNN_TPU_CUSTOM_CONV_WGRAD" in on:
            steps["conv3d_ndhwc_wgrad"] = 8
    else:
        steps = {"avg_voxelize": 4, "trilinear_devoxelize": 4,
                 "conv3d_fwd": 8, "conv3d_dgrad": 7, "conv3d_wgrad": 8,
                 "devoxelize_bwd": 4}
    if "PVCNN_TPU_DENSE_BN_FUSED" in on:
        steps.update(dense_rows_fwd=6, dense_rows_dgrad=5, dense_rows_wgrad=6)
    return steps


PER_STEP = {"avg_voxelize": 3, "trilinear_devoxelize": 3, "conv3d_fwd": 6,
            "conv3d_dgrad": 5, "conv3d_wgrad": 6, "devoxelize_bwd": 3}
PER_STEP2 = {"avg_voxelize": 13, "trilinear_devoxelize": 13,
             "conv3d_fwd": 26, "conv3d_dgrad": 25, "conv3d_wgrad": 26,
             "devoxelize_bwd": 13, "scatter_sum": 8, "fps": 4,
             "ball_query": 4, "three_nn": 4}
PER_STEP3 = per_step3(frozenset())
PER_STEP3_ON = per_step3(frozenset(SWITCHES))


def check_calls() -> None:
    """Each record's calls per step sum to the launches per step that the
    training phases count."""
    for calls, per_step in ((CALLS, PER_STEP), (CALLS2, PER_STEP2),
                            (CALLS3, PER_STEP3), (CALLS3_ON, PER_STEP3_ON)):
        sums = {}
        for (k, _), n in calls.items():
            sums[k] = sums.get(k, 0) + n
        if {k: n for k, n in sums.items() if n} != per_step:
            raise AssertionError(f"calls per case {sums} do not sum to the "
                                 f"launches per step {per_step}")


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


def windows(rng: np.random.RandomState, b: int, n: int):
    """[b, n, 9] S3DIS-like windows and [b, n] labels in 0..12: xyz in the
    block (x, y uniform in [0, 1], z in [0, 3]), rgb in [0, 1], and xyz
    normalized by a room of 3-9 m x 3-7 m x 3 m that holds the block."""
    xyz = rng.rand(b, n, 3) * [1.0, 1.0, 3.0]
    rgb = rng.rand(b, n, 3)
    offset = rng.rand(b, 1, 3) * [6.0, 4.0, 0.0]
    room = offset + rng.rand(b, 1, 3) * [2.0, 2.0, 0.0] + [1.0, 1.0, 3.0]
    x = np.concatenate([xyz, rgb, (xyz + offset) / room], axis=-1)
    return x.astype(np.float32), rng.randint(0, 13, (b, n)).astype(np.int64)


@contextlib.contextmanager
def switches(on=frozenset(SWITCHES)):
    """Set the switches named in `on` (by default all three: the opt-in
    path), unset the others; restore them all after."""
    saved = {name: os.environ.get(name) for name in SWITCHES}
    for name in SWITCHES:
        os.environ.pop(name, None)
    os.environ.update({name: SWITCHES[name] for name in on})
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


@contextlib.contextmanager
def plain_on_card():
    """Route CUDA tensors to the plain PyTorch versions, forward and
    backward (the comparison path of this script; the package itself never
    does this)."""
    from pvcnn_tpu_torch.ops import (conv3d, dense_rows, devoxelize,
                                     interpolate, neighbors, sampling,
                                     voxelize)

    def scatter_mean_plain(features, flat_idx, num_bins, channels_first):
        return (voxelize._scatter_mean_plain(features, flat_idx, num_bins,
                                             channels_first),
                voxelize._sort_bins_plain(flat_idx, num_bins)[1])

    patches = ((voxelize, "_scatter_mean_cuda", scatter_mean_plain),
               (voxelize, "_scatter_sum_cuda", voxelize._scatter_sum_plain),
               (devoxelize, "_devoxelize_cuda", devoxelize._devoxelize_plain),
               (devoxelize, "_devoxelize_bwd_cuda",
                devoxelize._devoxelize_bwd_plain),
               (conv3d, "_forward_cuda", conv3d._forward_plain),
               (conv3d, "_dgrad_cuda", conv3d._dgrad_plain),
               (conv3d, "_wgrad_cuda", conv3d._wgrad_plain),
               (sampling, "_fps_cuda", sampling._fps_plain),
               (neighbors, "_ball_query_cuda", neighbors._ball_query_plain),
               (interpolate, "_three_nn_cuda", interpolate._three_nn_plain),
               (dense_rows, "_forward_cuda", dense_rows._forward_plain),
               (dense_rows, "_dgrad_cuda", dense_rows._dgrad_plain),
               (dense_rows, "_wgrad_cuda", dense_rows._wgrad_plain),
               (conv3d, "_ndhwc_wgrad_cuda", conv3d._ndhwc_wgrad_plain))
    with contextlib.ExitStack() as stack:
        for module, name, plain in patches:
            stack.enter_context(mock.patch.object(module, name, plain))
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


def _compare(kernel, case, got, want, atol_scale: float = 1.0) -> float:
    rtol, atol = TOL[kernel]
    atol *= atol_scale
    err = (got - want).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{kernel} {case}: non-finite output")
    bad = err > atol + rtol * want.abs()
    big = want.abs() > 1e-3           # relative error where it means something
    rel = (err[big] / want.abs()[big]).max().item() if big.any() else 0.0
    log("kernels", f"{kernel} {case}: max_abs_err {err.max().item():.3e} "
        f"max_rel_err {rel:.3e} where |plain| > 1e-3 (rtol {rtol}, "
        f"atol {atol:.3g})")
    if bad.any():
        raise AssertionError(f"{kernel} {case}: {int(bad.sum())} elements "
                             "outside tolerance")
    return err.max().item()


def _twice(kernel, case, run):
    """Run a kernel twice; the outputs must be equal bit for bit."""
    got, again = run(), run()
    torch.cuda.synchronize()
    got_t = got if isinstance(got, tuple) else (got,)
    again_t = again if isinstance(again, tuple) else (again,)
    if not all(torch.equal(a, b) for a, b in zip(got_t, again_t)):
        raise AssertionError(f"{kernel} {case}: two runs differ")
    log("kernels", f"{kernel} {case}: two runs bitwise equal")
    return got


def _bound_ms(flops: float, nbytes: float):
    ops_ms, bytes_ms = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ops_ms, bytes_ms


def _library_agrees(kernel, case, got, want, atol_scale=1.0) -> bool:
    """Does the library call compute the kernel's function? Held to 1e-4
    (rtol and atol): grid_sample maps the coordinates to [-1, 1] and back,
    which moves the interpolation weights by about 1e-6 relative."""
    rtol, atol = (max(t, 1e-4) for t in TOL[kernel])
    ok = bool((got - want).abs().le(atol * atol_scale
                                    + rtol * want.abs()).all())
    if not ok:
        log("kernels", f"{kernel} {case}: the library call disagrees with "
            f"the plain version (max {(got - want).abs().max().item():.3e});"
            " not timed as its yardstick")
    return ok


class Record:
    """Per-kernel sums over one model's training step: each case's time
    (kernel, plain version, library call), bound and error, weighted by
    its calls per step."""

    def __init__(self, calls: dict):
        self.calls = calls
        self.rec = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                        "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
                        "library_ms": 0.0, "library_cases": 0, "cases": 0,
                        "glue_ms": 0.0, "kernel_alone_ms": 0.0,
                        "split_cases": 0}
                    for k in TOL}

    def add(self, kernel, case, err, run_k, run_p, flops, nbytes,
            run_lib=None, plain_reps=20, split=None):
        """split: (glue, kernel alone) callables that time `run_k`'s two
        parts apart (K1, K5: the sort, and the kernel on its output).
        Returns (ms, bound ms) of a timed case, None where it has no
        calls."""
        calls = self.calls.get((kernel, case), 0)
        r = self.rec[kernel]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if calls == 0:
            return None
        ms = time_ms(run_k)
        plain_ms = time_ms(run_p, reps=plain_reps, warmup=1)
        lib_ms = time_ms(run_lib) if run_lib is not None else None
        bound, ops_ms, bytes_ms = _bound_ms(flops, nbytes)
        lib = f", library {lib_ms:.4f} ms" if lib_ms is not None else ""
        parts = ""
        if split is not None:
            glue_ms, alone_ms = time_ms(split[0]), time_ms(split[1])
            parts = f" (glue {glue_ms:.4f} ms, kernel alone {alone_ms:.4f})"
            r["glue_ms"] += calls * glue_ms
            r["kernel_alone_ms"] += calls * alone_ms
            r["split_cases"] += calls
        log("kernels", f"{kernel} {case}: {ms:.4f} ms{parts} vs plain "
            f"{plain_ms:.4f} ms{lib}, bound {bound:.4f} ms "
            f"({'operations' if ops_ms >= bytes_ms else 'bytes'}); "
            f"{calls} per step")
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound), ("ops_ms", ops_ms),
                         ("bytes_ms", bytes_ms)):
            r[key] += calls * val
        r["cases"] += calls
        if lib_ms is not None:
            r["library_ms"] += calls * lib_ms
            r["library_cases"] += calls
        return ms, bound

    def summary(self, label: str) -> dict:
        for k, r in self.rec.items():
            if not r["cases"]:
                continue
            lib = (f", library {r['library_ms']:.4f} ms"
                   if r["library_cases"] == r["cases"] else "")
            parts = (f" (glue {r['glue_ms']:.4f} ms, kernel alone "
                     f"{r['kernel_alone_ms']:.4f})"
                     if r["split_cases"] == r["cases"] else "")
            log("kernels", f"{label} {k}: {r['ms']:.4f} ms{parts} per "
                f"training step vs plain {r['plain_ms']:.4f} ms{lib}, bound "
                f"{r['bound_ms']:.4f} ms")
        return self.rec


def _k1_split(kernel, values, idx, bins, cf, mean):
    """K1's glue (the int32 cast and the counting-sort kernel) and the
    kernel alone on its output, as the two callables of Record.add's split;
    and the longest run (the most rows of one cloud in one bin), which one
    lane group walks serially."""
    from pvcnn_tpu_torch.ops import voxelize

    perm, bounds = voxelize._sort_bins(idx.to(torch.int32), bins)
    run_glue = lambda: voxelize._sort_bins(idx.to(torch.int32), bins)
    run_alone = lambda: voxelize._launch_k1_sorted(
        kernel, values, perm, bounds, bins, cf, mean)
    longest = int((bounds[:, 1:] - bounds[:, :-1]).max())
    return (run_glue, run_alone), longest


def _grid5(norm, r):
    """norm_coords [B, N, 3] in [0, R-1] -> grid_sample's [B, 1, 1, N, 3]
    (x, y, z) = (z, y, x) in [-1, 1] (align_corners=True)."""
    return (norm.flip(-1) * (2.0 / (r - 1)) - 1.0)[:, None, None]


def _time_pvconv_kernels(rec: Record, coords_of, normalize: bool,
                         cf: bool = True) -> None:
    """K1-K5 at the cases of rec.calls: K1/K2/K5 (C, R, N) on the coords
    coords_of(N), channel-major grids [B, C, R^3] with cf (the rows branch)
    or channel-last [B, R^3, C] without (the NDHWC branch); the convs (Ci,
    Co, R, prologue) on random grids."""
    import torch.nn.functional as F

    from pvcnn_tpu_torch import ops
    from pvcnn_tpu_torch.ops import conv3d, devoxelize, voxelize

    dev = torch.device(DEVICE)
    cases = lambda kernel: sorted(c for k, c in rec.calls if k == kernel)
    for c, r, n in cases("avg_voxelize"):
        vox, _ = ops.normalize_coords(coords_of(n), r, normalize=normalize)
        flat = ops.flat_voxel_index(vox, r)
        feats = torch.randn(B, n, c, device=dev)
        run_k = lambda: voxelize._scatter_mean_cuda(feats, flat, r ** 3,
                                                    cf)[0]
        run_p = lambda: voxelize._scatter_mean_plain(feats, flat, r ** 3, cf)
        idx = flat.long()[..., None].expand(-1, -1, c)
        run_lib = lambda: feats.new_zeros(B, r ** 3, c).scatter_reduce_(
            1, idx, feats, "mean", include_self=False)
        case = (c, r, n)
        got = _twice("avg_voxelize", case, run_k)
        want = run_p()
        err = _compare("avg_voxelize", case, got, want)
        lib = run_lib()
        lib_ok = _library_agrees("avg_voxelize", case,
                                 lib.transpose(1, 2) if cf else lib, want)
        split, longest = _k1_split("avg_voxelize", feats, flat, r ** 3, cf,
                                   True)
        log("kernels", f"avg_voxelize {case}: longest run {longest} rows")
        rec.add("avg_voxelize", case, err, run_k, run_p, B * n * c,
                4 * (B * n * c + B * n + B * r ** 3 * c),
                run_lib if lib_ok else None, split=split)

    for c, r, n in cases("trilinear_devoxelize"):
        _, norm = ops.normalize_coords(coords_of(n), r, normalize=normalize)
        grid = torch.randn(B, c, r ** 3, device=dev)
        if not cf:
            grid = grid.transpose(1, 2).contiguous()
        run_k = lambda: devoxelize._devoxelize_cuda(grid, norm, r, cf)
        run_p = lambda: devoxelize._devoxelize_plain(grid, norm, r, cf)
        g5 = (grid if cf else grid.transpose(1, 2)).reshape(B, c, r, r, r)
        gs = _grid5(norm, r)
        run_lib = lambda: F.grid_sample(g5, gs, mode="bilinear",
                                        align_corners=True)
        case = (c, r, n)
        got = _twice("trilinear_devoxelize", case, run_k)
        want = run_p()
        err = _compare("trilinear_devoxelize", case, got, want)
        lib_ok = _library_agrees("trilinear_devoxelize", case,
                                 run_lib().reshape(B, c, n).transpose(1, 2),
                                 want)
        rec.add("trilinear_devoxelize", case, err, run_k, run_p,
                16 * B * n * c, 4 * (B * c * r ** 3 + 3 * B * n + B * n * c),
                run_lib if lib_ok else None)

        # K5: the grid gradient of the same gather
        g = torch.randn(B, n, c, device=dev)
        run_k = lambda: devoxelize._devoxelize_bwd_cuda(g, norm, r, cf)
        points, bounds = devoxelize._sort_points(norm, r)
        split = (lambda: devoxelize._sort_points(norm, r),
                 lambda: devoxelize._launch_k5_sorted(g, points, bounds, r,
                                                      cf))
        log("kernels", f"devoxelize_bwd {case}: longest run "
            f"{int((bounds[:, 1:] - bounds[:, :-1]).max())} points")
        run_p = lambda: devoxelize._devoxelize_bwd_plain(g, norm, r, cf)
        gt5 = g.transpose(1, 2).reshape(B, c, 1, 1, n)
        run_lib = lambda: torch.ops.aten.grid_sampler_3d_backward(
            gt5, g5, gs, 0, 0, True, [True, False])[0]
        got = _twice("devoxelize_bwd", case, run_k)
        want = run_p()
        err = _compare("devoxelize_bwd", case, got, want)
        lib = run_lib().reshape(B, c, r ** 3)
        lib_ok = _library_agrees("devoxelize_bwd", case,
                                 lib if cf else lib.transpose(1, 2), want)
        rec.add("devoxelize_bwd", case, err, run_k, run_p, 16 * B * n * c,
                4 * (B * n * c + 3 * B * n + B * c * r ** 3),
                run_lib if lib_ok else None, split=split)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def tile(kernel, case, ci, co, r):
        wm, splits = conv3d._fwd_plan(B, ci, co, r, sms)
        log("kernels", f"{kernel} {case}: tile {16 * wm} x {512 // wm}, "
            f"reduction in {splits} split(s)")

    def split_ab(kernel, case, ci, co, r, run_k):
        """Where K3 splits its reduction: its time with the split and with
        one block per tile, in turns (what the split itself gains)."""
        wm, splits = conv3d._fwd_plan(B, ci, co, r, sms)
        if splits == 1 or (kernel, case) not in rec.calls:
            return
        plan, times = conv3d._fwd_plan, {splits: [], 1: []}
        for n in (splits, 1, 1, splits):
            conv3d._fwd_plan = lambda *a, n=n: (wm, n)
            try:
                times[n].append(time_ms(run_k))
            finally:
                conv3d._fwd_plan = plan
        log("kernels", f"{kernel} {case}: in {splits} splits "
            + " / ".join(f"{t:.4f}" for t in times[splits])
            + " ms, in 1 " + " / ".join(f"{t:.4f}" for t in times[1])
            + " ms (in turns)")

    for ci, co, r in sorted({c[:3] for c in cases("conv3d_fwd")}):
        bound = 1.0 / (27 * ci) ** 0.5
        x = torch.randn(B, ci, r ** 3, device=dev)
        w = torch.empty(co, ci, 3, 3, 3, device=dev).uniform_(-bound, bound)
        bias = torch.empty(co, device=dev).uniform_(-bound, bound)
        scale = torch.empty(ci, device=dev).uniform_(0.5, 1.5)
        shift = torch.randn(ci, device=dev) * 0.5
        gy = torch.randn(B, co, r ** 3, device=dev)
        flops = 2.0 * B * r ** 3 * 27 * ci * co
        for pro in (False, True):
            case = (ci, co, r, pro)
            if ("conv3d_fwd", case) not in rec.calls:
                continue
            args = (x, w, bias, scale, shift, r, pro)
            xa = conv3d.leaky_affine(x, scale, shift) if pro else x
            x5 = xa.reshape(B, ci, r, r, r)
            # K3 forward with its statistics epilogue (the training call)
            run_k = lambda: conv3d._forward_cuda(*args, True)
            run_p = lambda: conv3d._forward_plain(*args, True)
            run_lib = lambda: F.conv3d(x5, w, bias, padding=1)
            tile("conv3d_fwd", case, ci, co, r)
            y, s1, s2 = _twice("conv3d_fwd", case, run_k)
            want, w1, w2 = run_p()
            err = _compare("conv3d_fwd", case, y, want)
            exact = conv3d._conv3d_plain(*(a.double() for a in args[:5]),
                                         r, pro)
            log("kernels", f"conv3d_fwd {case}: max |. - fp64 conv| kernel "
                f"{(y - exact).abs().max().item():.3e}, plain "
                f"{(want - exact).abs().max().item():.3e}")
            # statistics: a sum of B * R^3 terms, held to 1e-4 of the sum
            # of their magnitudes
            mag1 = want.abs().sum(dim=(0, 2))
            e1 = ((s1 - w1).abs() / mag1).max().item()
            e2 = ((s2 - w2).abs() / w2).max().item()
            log("kernels", f"conv3d_fwd {case} statistics: max |s1 - plain| "
                f"/ sum|y| {e1:.3e}, max |s2 - plain| / s2 {e2:.3e} "
                "(<= 1e-4)")
            if e1 > 1e-4 or e2 > 1e-4:
                raise AssertionError(f"conv3d_fwd {case}: statistics "
                                     "disagree with the plain sums")
            lib_ok = _library_agrees("conv3d_fwd", case, run_lib().reshape(
                B, co, r ** 3), want)
            rec.add("conv3d_fwd", case, err, run_k, run_p, flops,
                    4 * (B * ci * r ** 3 + 27 * ci * co + B * co * r ** 3),
                    run_lib if lib_ok else None)
            split_ab("conv3d_fwd", case, ci, co, r, run_k)

            # K4: the weight gradient, against the plain version and fp64
            run_k = lambda: conv3d._wgrad_cuda(x, gy, scale, shift, r, pro)
            run_p = lambda: conv3d._wgrad_plain(x, gy, scale, shift, r, pro)
            run_lib = lambda: torch.nn.grad.conv3d_weight(x5, w.shape,
                                                          gy.reshape(
                                                              B, co, r, r, r),
                                                          padding=1)
            dw = _twice("conv3d_wgrad", case, run_k)
            want = run_p()
            scale_w = want.abs().max().item()
            err = _compare("conv3d_wgrad", case, dw, want, scale_w)
            exact = conv3d._wgrad_plain(x.double(), gy.double(),
                                        scale.double(), shift.double(), r,
                                        pro)
            log("kernels", f"conv3d_wgrad {case}: max |. - fp64| / max|dW| "
                f"kernel {(dw - exact).abs().max().item() / scale_w:.3e}, "
                f"plain {(want - exact).abs().max().item() / scale_w:.3e}")
            lib_ok = _library_agrees("conv3d_wgrad", case, run_lib(), want,
                                     scale_w)
            timed = rec.add("conv3d_wgrad", case, err, run_k, run_p, flops,
                            4 * (B * ci * r ** 3 + B * co * r ** 3
                                 + 27 * ci * co),
                            run_lib if lib_ok else None)
            plan = conv3d._wgrad_plan(B, ci, co, r, sms)
            share = (f", {timed[1] / timed[0]:.1%} of its bound"
                     if timed else "")
            log("kernels", f"conv3d_wgrad {case}: tile {plan.tile}, "
                f"z-segments of {plan.seg}, {plan.splits} split(s) of "
                f"{plan.per_split} slices, partial buffer "
                f"{plan.partial_bytes} bytes{share}")

        # K3 as the dgrad: Co -> Ci channels, flipped io-swapped taps
        if ("conv3d_dgrad", (co, ci, r)) in rec.calls:
            case = (co, ci, r)
            run_k = lambda: conv3d._dgrad_cuda(gy, w, r)
            run_p = lambda: conv3d._dgrad_plain(gy, w, r)
            g5 = gy.reshape(B, co, r, r, r)
            run_lib = lambda: torch.nn.grad.conv3d_input(
                (B, ci, r, r, r), w, g5, padding=1)
            tile("conv3d_dgrad", case, co, ci, r)
            dx = _twice("conv3d_dgrad", case, run_k)
            want = run_p()
            err = _compare("conv3d_dgrad", case, dx, want)
            lib_ok = _library_agrees("conv3d_dgrad", case,
                                     run_lib().reshape(B, ci, r ** 3), want)
            rec.add("conv3d_dgrad", case, err, run_k, run_p, flops,
                    4 * (B * co * r ** 3 + 27 * ci * co + B * ci * r ** 3),
                    run_lib if lib_ok else None)
            split_ab("conv3d_dgrad", case, co, ci, r, run_k)


def phase_kernels() -> dict:
    """K1-K5 at the shapes ShapeNet PVCNN 1x training gives them."""
    torch.manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    coords = torch.from_numpy(cloud(rng, B, N)[..., :3]).to(DEVICE)
    rec = Record(CALLS)
    _time_pvconv_kernels(rec, lambda n: coords[:, :n], normalize=False)
    return rec.summary("ShapeNet PVCNN 1x")


def _exact(kernel, case, got, want) -> None:
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{kernel} {case}: {bad} indices differ from "
                             "the plain version")
    log("kernels", f"{kernel} {case}: indices equal the plain version's")


def phase_pvcnn2_kernels() -> dict:
    """Every kernel of the PVCNN2 training step at its shapes there, on
    one batch of synthetic windows: the FPS / ball-query / three-NN
    hierarchy of the model (8192 -> 1024 -> 256 -> 64 -> 16 points), K1's
    sum mode on the take_rows backwards it implies, and K1-K5."""
    from pvcnn_tpu_torch.ops import interpolate, neighbors, sampling, voxelize

    dev = torch.device(DEVICE)
    torch.manual_seed(SEED)
    x, _ = windows(np.random.RandomState(SEED + 10), B, N2)
    levels = [torch.from_numpy(x[..., :3]).to(dev)]
    rec = Record(CALLS2)
    for (n, m) in ((8192, 1024), (1024, 256), (256, 64), (64, 16)):
        pts = levels[-1]
        case = (n, m)
        run_k = lambda: sampling._fps_cuda(pts, m)
        run_p = lambda: sampling._fps_plain(pts, m)
        idx = _twice("fps", case, run_k)
        _exact("fps", case, idx, run_p())
        ms, bound = rec.add("fps", case, 0.0, run_k, run_p,
                            10.0 * B * n * (m - 1), 4 * (B * n * 3 + B * m),
                            plain_reps=3)
        # the chain floor: the same steps' argmax and exchange alone
        chain = time_ms(lambda: sampling._fps_cuda(pts, m, chain_only=True))
        holds = "chain floor" if chain >= bound else "FLOP bound"
        log("kernels", f"fps {case}: {m - 1} dependent steps; (cluster, "
            f"threads, points per thread) {sampling._fps_plan(n)}; chain "
            f"floor {chain:.4f} ms, FLOP bound {bound:.4f} ms: the {holds} "
            f"holds, {max(chain, bound) / ms:.1%} of the kernel's time")
        levels.append(torch.gather(pts, 1, idx.long()[..., None].expand(
            -1, -1, 3)))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    group_idx, interp_idx = {}, {}
    for level, (radius, u) in enumerate(((0.1, 32), (0.2, 32), (0.4, 32),
                                         (0.8, 32))):
        pts, ctr = levels[level], levels[level + 1]
        n, m = pts.shape[1], ctr.shape[1]
        r2 = neighbors._fp32(radius ** 2)
        case = (m, n, radius, u)
        run_k = lambda: neighbors._ball_query_cuda(ctr, pts, r2, u)
        run_p = lambda: neighbors._ball_query_plain(ctr, pts, r2, u)
        got = _twice("ball_query", case, run_k)
        _exact("ball_query", case, got, run_p())
        # the points each center scans: to its U-th hit, or all N (a
        # center with fewer than U hits repeats its first hit in the last
        # slot)
        full = got[..., u - 1] != got[..., 0]
        scanned = torch.where(full, got[..., u - 1].long() + 1, n).sum()
        hits = (neighbors.sq_dist(ctr, pts) < r2).sum(-1)
        log("kernels", f"ball_query {case}: mean hits {hits.float().mean():.2f}"
            f", {float((hits < u).float().mean()):.3f} of the centers take "
            f"the fill; {float(scanned) / (B * m * n):.3f} of the points "
            f"scanned; plan {neighbors._ball_query_plan(B, m, n, u, sms)}")
        rec.add("ball_query", case, 0.0, run_k, run_p, 9.0 * float(scanned),
                4 * (B * m * 3 + B * n * 3 + B * m * u), plain_reps=5)
        group_idx[level] = got.reshape(B, m * u)

        case = (n, m)
        run_k = lambda: interpolate._three_nn_cuda(pts, ctr)
        run_p = lambda: interpolate._three_nn_plain(pts, ctr)
        idx, d2 = _twice("three_nn", case, run_k)
        want_idx, want_d2 = run_p()
        _exact("three_nn", case, idx, want_idx)
        err = _compare("three_nn", case, d2, want_d2)
        err = max(err, _compare("three_nn", case,
                                interpolate._weights_from_d2(d2),
                                interpolate._weights_from_d2(want_d2)))
        ms, bound = rec.add("three_nn", case, err, run_k, run_p,
                            9.0 * B * n * m,
                            4 * (B * n * 3 + B * m * 3 + 2 * B * n * 3),
                            plain_reps=5)
        _three_nn_log(case, run_k, ms, bound, sms)
        interp_idx[level] = idx.reshape(B, n * 3)

    _ball_query_dense(dev)
    _ball_query_many(dev)
    _three_nn_more(dev, sms)

    # the take_rows backwards: SA groupings (B, M*U rows into N bins) and
    # FP interpolations (B, 3N rows into M bins)
    sa_c, fp_c = (32, 64, 128, 256), (128, 256, 256, 512)
    sources = [(group_idx[l], levels[l].shape[1], sa_c[l]) for l in range(4)]
    sources += [(interp_idx[l], levels[l + 1].shape[1], fp_c[l])
                for l in range(4)]
    for idx, bins, c in sources:
        k = idx.shape[1]
        case = (k, bins, c)
        values = torch.randn(B, k, c, device=dev)
        run_k = lambda: voxelize._scatter_sum_cuda(values, idx, bins)
        run_p = lambda: voxelize._scatter_sum_plain(values, idx, bins)
        flat = (idx.long() + torch.arange(B, device=dev)[:, None] * bins
                ).reshape(-1)
        rows = values.reshape(-1, c)
        run_lib = lambda: values.new_zeros(B * bins, c).index_add_(
            0, flat, rows)
        got = _twice("scatter_sum", case, run_k)
        want = run_p()
        err = _compare("scatter_sum", case, got, want)
        lib_ok = _library_agrees("scatter_sum", case,
                                 run_lib().reshape(B, bins, c), want)
        split, longest = _k1_split("scatter_sum", values, idx, bins, False,
                                   False)
        log("kernels", f"scatter_sum {case}: longest run {longest} rows")
        rec.add("scatter_sum", case, err, run_k, run_p, B * k * c,
                4 * (B * k * c + B * k + B * bins * c),
                run_lib if lib_ok else None, split=split)

    by_n = {t.shape[1]: t for t in levels}
    _time_pvconv_kernels(rec, lambda n: by_n[n], normalize=True)
    return rec.summary("S3DIS PVCNN2 1x")


def _ball_query_dense(dev) -> None:
    """K7 on a dense cloud, where every center has all N points in its
    radius and stops at its U-th hit: indices equal to the plain
    version's, timed, not counted per step."""
    from pvcnn_tpu_torch.ops import neighbors

    pts = 0.5 + 0.01 * np.random.RandomState(SEED).rand(B, N2, 3)
    pts = torch.from_numpy(pts.astype(np.float32)).to(dev)
    ctr = pts[:, :1024].contiguous()
    r2, u = neighbors._fp32(0.1 ** 2), 32
    case = (1024, N2, 0.1, u, "dense")
    run_k = lambda: neighbors._ball_query_cuda(ctr, pts, r2, u)
    got = _twice("ball_query", case, run_k)
    _exact("ball_query", case, got, neighbors._ball_query_plain(ctr, pts, r2,
                                                                 u))
    log("kernels", f"ball_query {case}: {time_ms(run_k):.4f} ms, every "
        f"center stops after {u} of {N2} points; not counted per step")


def _ball_query_many(dev) -> None:
    """K7 at U = 2,048 neighbors a center, its device-memory path, on a
    dense cloud (every center stops at its U-th hit of N = 8,192 points):
    indices equal to the plain version's, not counted per step."""
    from pvcnn_tpu_torch.ops import neighbors

    pts = 0.5 + 0.01 * np.random.RandomState(SEED + 1).rand(B, N2, 3)
    pts = torch.from_numpy(pts.astype(np.float32)).to(dev)
    ctr = pts[:, :1024].contiguous()
    r2, u = neighbors._fp32(0.1 ** 2), 2048
    case = (1024, N2, 0.1, u, "dense")
    run_k = lambda: neighbors._ball_query_cuda(ctr, pts, r2, u)
    got = _twice("ball_query", case, run_k)
    _exact("ball_query", case, got, neighbors._ball_query_plain(ctr, pts, r2,
                                                                 u))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log("kernels", f"ball_query {case}: {time_ms(run_k):.4f} ms, plan "
        f"{neighbors._ball_query_plan(B, 1024, N2, u, sms)}; not counted "
        "per step")


def _three_nn_log(case, run_k, ms, bound, sms) -> None:
    """A K8 case's plan, device time (torch.profiler over 10 calls) and
    share of its bound."""
    import cases_util
    from pvcnn_tpu_torch.ops import interpolate

    own, _ = cases_util.device_ms(run_k, ("three_nn",))
    n, m = case
    log("kernels", f"three_nn {case}: plan "
        f"{interpolate._three_nn_plan(B, n, m, sms)}; device {own:.4f} ms "
        f"({bound / own:.1%} of the bound), {ms:.4f} ms by events "
        f"({bound / ms:.1%})")


def nn_more_inputs(dev):
    """(N, M), queries [B, N, 3], centers [B, M, 3] for each NN_MORE case:
    ShapeNet-like clouds, the centers their first M points, or the origin
    where M = 1 (a group-all level's center)."""
    rng = np.random.RandomState(SEED + 30)
    for n, m in NN_MORE:
        pts = torch.from_numpy(cloud(rng, B, n)[..., :3]).to(dev)
        ctr = (pts[:, :m].contiguous() if m > 1
               else torch.zeros(B, 1, 3, device=dev))
        yield (n, m), pts, ctr


def _three_nn_more(dev, sms) -> None:
    """K8 at the coming PointNet++ paths' shapes (NN_MORE), 32 clouds each:
    indices and d² equal to the plain version's, timed, not counted per
    step."""
    from pvcnn_tpu_torch.ops import interpolate

    for case, pts, ctr in nn_more_inputs(dev):
        n, m = case
        run_k = lambda: interpolate._three_nn_cuda(pts, ctr)
        idx, d2 = _twice("three_nn", case, run_k)
        want_idx, want_d2 = interpolate._three_nn_plain(pts, ctr)
        _exact("three_nn", case, idx, want_idx)
        if not torch.equal(d2, want_d2):
            raise AssertionError(f"three_nn {case}: d² differs from the "
                                 "plain version's")
        bound, _, _ = _bound_ms(9.0 * B * n * m,
                                4 * (B * n * 3 + B * m * 3 + 2 * B * n * 3))
        _three_nn_log(case, run_k, time_ms(run_k), bound, sms)


def _time_dense_kernels(rec: Record, rows: int) -> None:
    """K9 (forward and dgrad) and K10 at the cases of rec.calls, on random
    [rows, Ci] inputs and [rows, Co] cotangents."""
    import torch.nn.functional as F

    from pvcnn_tpu_torch.ops import dense_rows

    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for ci, co in sorted({c[:2] for k, c in rec.calls
                          if k == "dense_rows_fwd"}):
        bound = 1.0 / ci ** 0.5
        x = torch.randn(rows, ci, device=dev)
        # the fused SharedMLP's layout: its Conv1d weight [Co, Ci] seen as
        # [Ci, Co], which the kernels read in place
        wt = torch.empty(co, ci, device=dev).uniform_(-bound, bound)
        w = wt.t()
        bias = torch.empty(co, device=dev).uniform_(-bound, bound)
        scale = torch.empty(ci, device=dev).uniform_(0.5, 1.5)
        shift = torch.randn(ci, device=dev) * 0.5
        g = torch.randn(rows, co, device=dev)
        flops = 2.0 * rows * ci * co
        for pro in (False, True):
            case = (ci, co, pro)
            if ("dense_rows_fwd", case) not in rec.calls:
                continue
            args = (x, w, bias, scale, shift, 0.0, pro)
            xa = dense_rows._act_plain(x, scale, shift, 0.0) if pro else x
            # K9 with its statistics epilogue (the training call); the
            # library's is F.linear and the two sums on the activated input
            run_k = lambda: dense_rows._forward_cuda(*args, True)
            run_p = lambda: dense_rows._forward_plain(*args, True)

            def run_lib():
                y = F.linear(xa, wt, bias)
                return y, y.sum(0), (y * y).sum(0)

            y, s1, s2 = _twice("dense_rows_fwd", case, run_k)
            want, w1, w2 = run_p()
            err = _compare("dense_rows_fwd", case, y, want)
            mag1 = want.abs().sum(dim=0)
            e1 = ((s1 - w1).abs() / mag1).max().item()
            e2 = ((s2 - w2).abs() / w2).max().item()
            log("kernels", f"dense_rows_fwd {case} statistics: max |s1 - "
                f"plain| / sum|y| {e1:.3e}, max |s2 - plain| / s2 {e2:.3e} "
                "(<= 1e-4)")
            if e1 > 1e-4 or e2 > 1e-4:
                raise AssertionError(f"dense_rows_fwd {case}: statistics "
                                     "disagree with the plain sums")
            lib_ok = _library_agrees("dense_rows_fwd", case, run_lib()[0],
                                     want)
            rec.add("dense_rows_fwd", case, err, run_k, run_p, flops,
                    4 * (rows * ci + ci * co + co + rows * co + 2 * co),
                    run_lib if lib_ok else None)

            # K10: dW and d(bias) in one pass, against fp64 too
            log("kernels", f"dense_rows_wgrad {case}: plan "
                f"{dense_rows._plan(ci, co, rows, True, sms)}")
            run_k = lambda: dense_rows._wgrad_cuda(x, g, scale, shift, 0.0,
                                                   pro)
            run_p = lambda: dense_rows._wgrad_plain(x, g, scale, shift, 0.0,
                                                    pro)
            run_lib = lambda: (torch.matmul(xa.t(), g), g.sum(0))
            dw, db = _twice("dense_rows_wgrad", case, run_k)
            want_dw, want_db = run_p()
            scale_w = want_dw.abs().max().item()
            err = max(_compare("dense_rows_wgrad", case, dw, want_dw,
                               scale_w),
                      _compare("dense_rows_wgrad", case, db, want_db,
                               want_db.abs().max().item()))
            exact, _ = dense_rows._wgrad_plain(
                x.double(), g.double(), scale.double(), shift.double(), 0.0,
                pro)
            e_k = (dw - exact).abs().max().item() / scale_w
            e_p = (want_dw - exact).abs().max().item() / scale_w
            log("kernels", f"dense_rows_wgrad {case}: max |. - fp64| / "
                f"max|dW| kernel {e_k:.3e}, plain {e_p:.3e}")
            lib_ok = _library_agrees("dense_rows_wgrad", case, run_lib()[0],
                                     want_dw, scale_w)
            rec.add("dense_rows_wgrad", case, err, run_k, run_p, flops,
                    4 * (rows * ci + rows * co + ci * co + co),
                    run_lib if lib_ok else None)

        # K9 as the dgrad: Co -> Ci channels through W^T
        if ("dense_rows_dgrad", (co, ci)) in rec.calls:
            case = (co, ci)
            run_k = lambda: dense_rows._dgrad_cuda(g, w)
            run_p = lambda: dense_rows._dgrad_plain(g, w)
            run_lib = lambda: F.linear(g, w)
            dx = _twice("dense_rows_dgrad", case, run_k)
            want = run_p()
            err = _compare("dense_rows_dgrad", case, dx, want)
            lib_ok = _library_agrees("dense_rows_dgrad", case, run_lib(),
                                     want)
            rec.add("dense_rows_dgrad", case, err, run_k, run_p, flops,
                    4 * (rows * co + ci * co + rows * ci),
                    run_lib if lib_ok else None)


def _time_ndhwc_wgrad(rec: Record) -> None:
    """K11 at the cases (Ci, Co, R) of rec.calls on random channel-last
    grids and cotangents, against fp64 too."""
    from pvcnn_tpu_torch.ops import conv3d

    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for ci, co, r in sorted(c for k, c in rec.calls
                            if k == "conv3d_ndhwc_wgrad"):
        case = (ci, co, r)
        x = torch.randn(B, r, r, r, ci, device=dev)
        g = torch.randn(B, r, r, r, co, device=dev)
        run_k = lambda: conv3d._ndhwc_wgrad_cuda(x, g, 3)
        run_p = lambda: conv3d._ndhwc_wgrad_plain(x, g, 3)
        xp, gp = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
        run_lib = lambda: torch.nn.grad.conv3d_weight(
            xp, (co, ci, 3, 3, 3), gp, padding=1)
        dw = _twice("conv3d_ndhwc_wgrad", case, run_k)
        want = run_p()
        scale_w = want.abs().max().item()
        err = _compare("conv3d_ndhwc_wgrad", case, dw, want, scale_w)
        exact = conv3d._ndhwc_wgrad_plain(x.double(), g.double(), 3)
        log("kernels", f"conv3d_ndhwc_wgrad {case}: max |. - fp64| / max|dW|"
            f" kernel {(dw - exact).abs().max().item() / scale_w:.3e}, "
            f"plain {(want - exact).abs().max().item() / scale_w:.3e}")
        del exact
        lib_ok = _library_agrees("conv3d_ndhwc_wgrad", case, run_lib(), want,
                                 scale_w)
        timed = rec.add("conv3d_ndhwc_wgrad", case, err, run_k, run_p,
                        2.0 * 27 * ci * co * B * r ** 3,
                        4 * (B * r ** 3 * (ci + co) + 27 * ci * co),
                        run_lib if lib_ok else None)
        plan = conv3d._wgrad_plan(B, ci, co, r, sms)
        share = (f", {timed[1] / timed[0]:.1%} of its bound"
                 if timed else "")
        log("kernels", f"conv3d_ndhwc_wgrad {case}: tile {plan.tile}, "
            f"z-segments of {plan.seg}, x staged in "
            f"{conv3d._ndhwc_layout(ci, plan)}, {plan.splits} split(s) of "
            f"{plan.per_split} slices, partial buffer {plan.partial_bytes} "
            f"bytes{share}")


def phase_pvcnn_s3dis_kernels():
    """Every kernel of the S3DIS PVCNN 1x training step at its shapes
    there, on one batch of synthetic windows: on the default path K1-K5
    channel-major; on the opt-in path K9/K10 and the dgrad on B * N rows,
    K11 on the eight convs' grids, K1/K2/K5 channel-last. Returns the two
    records (default, opt-in)."""
    torch.manual_seed(SEED)
    x, _ = windows(np.random.RandomState(SEED + 20), B, N3)
    coords = torch.from_numpy(x[..., :3]).to(DEVICE)
    off = Record(CALLS3)
    _time_pvconv_kernels(off, lambda n: coords[:, :n], normalize=True)
    on = Record(CALLS3_ON)
    _time_dense_kernels(on, B * N3)
    _time_ndhwc_wgrad(on)
    _time_pvconv_kernels(on, lambda n: coords[:, :n], normalize=True,
                         cf=False)
    return (off.summary("S3DIS PVCNN 1x"),
            on.summary("S3DIS PVCNN 1x opt-in"))


def phase_slice(label: str, model, x_all: np.ndarray,
                fwd_kernels) -> None:
    """Eval forward on the kernel path against the plain path on the card
    (and against the CPU plain path on a 2-cloud batch); ms per batch."""
    from pvcnn_tpu_torch import kernels

    dev = torch.device(DEVICE)
    b, n = x_all.shape[:2]
    model = model.eval()
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
        if logits.shape[:2] != (b, n) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
        log("slice", f"{label}: launches in one forward: "
            f"{ {k: v for k, v in counts.items() if v} }")
        if min(counts[k] for k in fwd_kernels) == 0:
            raise AssertionError(f"a kernel did not run: {counts}")
        diff = (logits - plain).abs().max().item()
        agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
        diff_cpu = (small - want_small).abs().max().item()
        log("slice", f"{label}: kernel vs plain path on the card: max "
            f"|dlogit| {diff:.3e} (atol 1e-3), argmax agreement {agree:.6f} "
            "(>= 0.999)")
        log("slice", f"{label}: kernel path on the card vs plain path on "
            f"the CPU (2 clouds): max |dlogit| {diff_cpu:.3e} (atol 1e-3)")
        if diff > 1e-3 or agree < 0.999 or diff_cpu > 1e-3:
            raise AssertionError("slice forward disagrees with the plain path")
        ms_k, ms_p = [], []
        for _ in range(3):                         # in turns: kernel, plain
            ms_k.append(time_ms(lambda: model(x), reps=5, warmup=1))
            with plain_on_card():
                ms_p.append(time_ms(lambda: model(x), reps=5, warmup=1))
    log("slice", f"{label} forward, {b} x {n}: kernel path "
        f"{np.median(ms_k):.3f} ms/batch, plain path {np.median(ms_p):.3f} "
        f"ms/batch (medians of {ms_k} / {ms_p})")


def _scratch_dir() -> str:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(path, exist_ok=True)
    return path


def phase_evaluator() -> None:
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.data.shapenet import write_synthetic
    from pvcnn_tpu_torch.evaluate.shapenet.eval import evaluate, mean_iou

    with tempfile.TemporaryDirectory(dir=_scratch_dir()) as root:
        # 2 categories x 2 shapes of 2000-3000 points
        num_items = len(write_synthetic(
            root, [(0, 2417), (0, 2946), (4, 2081), (4, 2590)], seed=SEED))
        kernels.reset_launch_counts()
        start = time.perf_counter()
        stats = evaluate(root, width_multiplier=1.0, num_votes=5,
                         batch_size=32, device=DEVICE, seed=SEED)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = kernels.launch_counts()
    if stats.shape != (16, 2) or not np.isfinite(stats).all() \
            or int(stats[:, 1].sum()) != num_items:
        raise AssertionError(f"bad evaluator stats {stats}")
    log("evaluator", f"{num_items} synthetic shapes, 5 votes, batch 32: "
        f"{seconds:.2f} s, mIoU {mean_iou(stats):.4f} (random weights, "
        f"synthetic labels), launches {counts}")
    if min(counts[k] for k in ("avg_voxelize", "trilinear_devoxelize",
                               "conv3d_fwd")) == 0:
        raise AssertionError(f"a kernel did not run: {counts}")


def _flat_grads(model) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1) for p in model.parameters()])


def _trainer(base, weight_decay: float):
    """A Trainer (Adam lr 1e-3, seeded dropout) on a copy of base."""
    from pvcnn_tpu_torch.nn.loss import CrossEntropyLoss
    from pvcnn_tpu_torch.train.optim import Adam
    from pvcnn_tpu_torch.train.trainer import Trainer

    model = copy.deepcopy(base)
    return Trainer(model, CrossEntropyLoss(),
                   Adam(model.parameters(), lr=1e-3,
                        weight_decay=weight_decay), torch.device(DEVICE), SEED)


def grads_of(trainer, x, y, seed):
    """Step-1 loss and gradients, without the update."""
    trainer.generator.manual_seed(seed)
    trainer.model.train()
    trainer.optimizer.zero_grad(set_to_none=True)
    loss = trainer.criterion(trainer.model(x), y)
    loss.backward()
    return loss.item(), _flat_grads(trainer.model).clone()


def phase_train(label: str, base, batches, per_step: dict, profile: bool,
                weight_decay: float = 0.0, traj_rtol: float = 1e-3):
    """Training steps on the kernel path and on the plain path. Returns
    the kernel path's step-1 (loss, gradients). traj_rtol bounds the
    relative loss difference of steps 2-3."""
    from pvcnn_tpu_torch import kernels

    b, n = batches[0][0].shape[:2]
    make = lambda: _trainer(base, weight_decay)
    kern, plain = make(), make()
    # two kernel-path runs from the same state (running statistics move
    # but do not enter the train-mode output)
    loss_k, grads_k = grads_of(kern, *batches[0], SEED)
    loss_k2, grads_k2 = grads_of(kern, *batches[0], SEED)
    if loss_k != loss_k2 or not torch.equal(grads_k, grads_k2):
        raise AssertionError("two kernel-path runs of step 1 differ")
    log("train", f"{label}: step-1 loss and gradients of two kernel-path "
        "runs are bitwise equal")
    with plain_on_card():
        loss_p, grads_p = grads_of(plain, *batches[0], SEED)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    g, w = grads_k.double(), grads_p.double()
    flipped = ((g - w).abs() > 5e-3 * w.abs().max()).double().mean().item()
    rel_l2 = ((g - w).norm() / w.norm()).item()
    log("train", f"{label} step 1: loss kernel {loss_k:.7f} plain "
        f"{loss_p:.7f} (rel {rel_loss:.2e} <= 1e-5); gradients flipped "
        f"fraction {flipped:.2e} (< 2e-3), rel-L2 {rel_l2:.2e} (< 5e-2)")
    if rel_loss > 1e-5 or flipped >= 2e-3 or rel_l2 >= 5e-2:
        raise AssertionError("step-1 kernel path disagrees with plain path")

    # steps 1-3 with updates, both paths from the same start; the kernel
    # path's counters read per step
    kern, plain = make(), make()
    kern.generator.manual_seed(SEED)
    plain.generator.manual_seed(SEED)
    losses_k, losses_p = [], []
    for i, (x, y) in enumerate(batches):
        kernels.reset_launch_counts()
        losses_k.append(kern.train_step(x, y).item())
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        if counts != per_step:
            raise AssertionError(f"step {i + 1} launches {counts}, expected "
                                 f"{per_step}")
        with plain_on_card():
            losses_p.append(plain.train_step(x, y).item())
    log("train", f"{label}: launches per step: {counts}")
    # the plain path's own run-to-run spread: its scatters use float
    # atomics, so its trajectory moves between runs once a gate flips
    again = make()
    again.generator.manual_seed(SEED)
    with plain_on_card():
        losses_p2 = [again.train_step(x, y).item() for x, y in batches]
    del again
    rel = [abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p)]
    own = [abs(a - b) / abs(b) for a, b in zip(losses_p2, losses_p)]
    log("train", f"{label}: losses kernel {losses_k} plain {losses_p}: "
        f"relative differences {['%.2e' % r for r in rel]} (step 1 <= 1e-5, "
        f"steps 2-3 <= {traj_rtol:g}); plain against a second plain run "
        f"{['%.2e' % r for r in own]}")
    if not all(np.isfinite(losses_k)) or rel[0] > 1e-5 \
            or max(rel[1:]) > traj_rtol:
        raise AssertionError("training losses disagree")

    x, y = batches[0]
    ms_k, ms_p, mem = [], [], {}
    for _ in range(3):                               # in turns
        for name, trainer in (("kernel", kern), ("plain", plain)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ctx = plain_on_card() if name == "plain" else \
                contextlib.nullcontext()
            with ctx:
                ms = time_ms(lambda: trainer.train_step(x, y), reps=5,
                             warmup=1)
            (ms_k if name == "kernel" else ms_p).append(ms)
            mem[name] = torch.cuda.max_memory_allocated() / 2 ** 30
    log("train", f"{label} training step, {b} x {n}, fp32: kernel path "
        f"{np.median(ms_k):.3f} ms/step, plain path {np.median(ms_p):.3f} "
        f"ms/step (medians of {ms_k} / {ms_p}); peak memory kernel "
        f"{mem['kernel']:.3f} GiB, plain {mem['plain']:.3f} GiB")
    if profile:
        _profile_steps(label, kern, x, y)
    return loss_k, grads_k


def phase_same_function(label: str, off, on,
                        what: str = "switches on") -> None:
    """Step 1 of the switched-on kernel path against the switched-off one:
    the same function in another order, held to phase 6's criteria."""
    (loss_off, g_off), (loss_on, g_on) = off, on
    rel_loss = abs(loss_on - loss_off) / abs(loss_off)
    g, w = g_on.double(), g_off.double()
    flipped = ((g - w).abs() > 5e-3 * w.abs().max()).double().mean().item()
    rel_l2 = ((g - w).norm() / w.norm()).item()
    log("train", f"{label} step 1, {what} vs off: loss {loss_on:.7f} "
        f"vs {loss_off:.7f} (rel {rel_loss:.2e} <= 1e-5); gradients flipped "
        f"fraction {flipped:.2e} (< 2e-3), rel-L2 {rel_l2:.2e} (< 5e-2)")
    if rel_loss > 1e-5 or flipped >= 2e-3 or rel_l2 >= 5e-2:
        raise AssertionError(f"the step with {what} disagrees with the "
                             "switched-off one")


def phase_switch_settings(label: str, base, batch, off) -> None:
    """Each of the six mixed settings of the three switches (all off and
    all on run in full in phase 14): from zeroed counters, one training
    step must launch exactly the kernels per_step3 names, its step 1 must
    agree with the switched-off one, and its ms/step is timed."""
    from itertools import combinations

    from pvcnn_tpu_torch import kernels

    x, y = batch
    for size in (1, 2):
        for on in map(frozenset, combinations(sorted(SWITCHES), size)):
            what = " + ".join(f"{n.removeprefix('PVCNN_TPU_')}="
                              f"{SWITCHES[n]}" for n in sorted(on))
            with switches(on):
                trainer = _trainer(base, 1e-5)
                phase_same_function(label, off, grads_of(trainer, x, y, SEED),
                                    what)
                kernels.reset_launch_counts()
                trainer.train_step(x, y)
                counts = {k: v for k, v in kernels.launch_counts().items()
                          if v}
                if counts != per_step3(on):
                    raise AssertionError(f"{what}: launches {counts}, "
                                         f"expected {per_step3(on)}")
                ms = time_ms(lambda: trainer.train_step(x, y), reps=5,
                             warmup=1)
            log("train", f"{label}, {what}: {ms:.3f} ms/step, launches per "
                f"step {counts}")
            del trainer


# torch.profiler kernel names -> the groups of the step's time split
PROFILE_GROUPS = (
    ("K3 conv3d forward + dgrad", ("conv3d_fwd_kernel",
                                   "conv3d_split_sum_kernel")),
    ("K4 conv3d wgrad", ("conv3d_wgrad_kernel", "conv3d_wgrad_sum_kernel")),
    ("K3 / K4 prologue pass", ("conv3d_prologue_kernel",)),
    ("K11 conv3d NDHWC wgrad", ("conv3d_ndhwc_wgrad_kernel",
                                "conv3d_ndhwc_wgrad_sum_kernel")),
    ("K9 dense forward + dgrad", ("dense_rows_fwd_kernel",)),
    ("K10 dense wgrad + fold", ("dense_rows_wgrad_kernel",
                                "dense_rows_fold_kernel")),
    ("K5 devoxelize backward", ("devoxelize_bwd_kernel",)),
    ("K5 sort (glue)", ("devoxelize_bwd_sort_kernel",)),
    ("K2 trilinear devoxelize", ("trilinear_devoxelize_kernel",
                                 "trilinear_devoxelize_planes_kernel")),
    ("K1 avg_voxelize + scatter_sum", ("avg_voxelize_bins_kernel",)),
    ("K1 sort (glue)", ("avg_voxelize_sort_kernel",)),
    ("K6 fps", ("fps_kernel",)),
    ("K7 ball_query", ("ball_query_kernel", "ball_query_merge_kernel")),
    ("K8 three_nn", ("three_nn_kernel",)),
    ("cuDNN conv (NDHWC forward, dgrad)", ("fprop", "dgrad", "cudnn",
                                          "convolve")),
    ("matmuls (cuBLAS/CUTLASS)", ("gemm", "cutlass", "xmma")),
    ("batch norm", ("batch_norm",)),
    ("sort", ("sort", "radix")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "Functor")),
)


def _profile_steps(label, trainer, x, y) -> None:
    """torch.profiler over 3 kernel-path steps: device time by kernel
    group and the device's idle share of the host-clock window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = 3
    for _ in range(2):
        trainer.train_step(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / steps
    groups = {name: [0.0, 0.0] for name, _ in PROFILE_GROUPS}
    groups["other"] = [0.0, 0.0]
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue                              # host-side rows
        ms = evt.self_device_time_total / 1e3 / steps
        rows.append((ms, evt.count / steps, evt.key))
        group = next((name for name, keys in PROFILE_GROUPS
                      if any(k in evt.key for k in keys)), "other")
        groups[group][0] += ms
        groups[group][1] += evt.count / steps
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    for ms, count, key in rows[:20]:
        log("profile", f"{label}: {ms:9.4f} ms/step {count:6.1f}/step "
            f"{key[:100]}")
    for name, (ms, count) in sorted(groups.items(), key=lambda g: -g[1][0]):
        log("profile", f"{label}: {name}: {ms:.3f} ms/step, {count:.0f} "
            "launches/step")
    log("profile", f"{label}: host-clock {wall_ms:.3f} ms/step, device busy "
        f"{busy:.3f} ms/step, idle share {1 - busy / wall_ms:.4f}")


def phase_trainer() -> dict:
    """The training entry point, one short epoch, from zeroed counters."""
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.data.shapenet import write_synthetic
    from pvcnn_tpu_torch.models.shapenet import PVCNN
    from pvcnn_tpu_torch.train.shapenet import train
    from pvcnn_tpu_torch.train.trainer import load_checkpoint

    rng = np.random.RandomState(SEED + 3)
    items = [(int(s), int(n)) for s, n in zip(rng.randint(0, 16, 64),
                                              rng.randint(2000, 3000, 64))]
    with tempfile.TemporaryDirectory(dir=_scratch_dir()) as root:
        write_synthetic(root, items, seed=SEED)
        save = os.path.join(root, "run")
        kernels.reset_launch_counts()
        start = time.perf_counter()
        meters = train(root, width_multiplier=1.0, batch_size=32, epochs=1,
                       max_steps=4, save_path=save, device=DEVICE, seed=SEED)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = kernels.launch_counts()
        names = ("latest.pth.tar", "latest/e0.pth.tar", "best.pth.tar")
        missing = [n for n in names
                   if not os.path.exists(os.path.join(save, n))]
        if missing:
            raise AssertionError(f"trainer wrote no {missing}")
        epoch, saved = load_checkpoint(os.path.join(save, "latest.pth.tar"),
                                       PVCNN(50, 16, 3))
        again = train(root, width_multiplier=1.0, batch_size=32, epochs=1,
                      save_path=save, device=DEVICE, seed=SEED)
    iou = meters["acc/iou_test"]
    log("trainer", f"64 synthetic shapes, 1 epoch of 4 steps at batch 32 + "
        f"test split: {seconds:.2f} s, acc/iou_test {iou:.4f} (random "
        f"labels), checkpoints {list(names)}, launches {counts}")
    log("trainer", f"resumed run loaded epoch {epoch} and re-evaluated "
        f"acc/iou_test {again['acc/iou_test']:.4f}")
    if not 0.0 <= iou <= 1.0 or epoch != 0 \
            or saved["acc/iou_test"] != iou \
            or abs(again["acc/iou_test"] - iou) > 1e-6:
        raise AssertionError("trainer checkpoints do not round-trip")
    if min(counts[k] for k in PER_STEP) == 0:
        raise AssertionError(f"a kernel did not run: {counts}")
    return counts


def phase_s3dis_trainer(label: str, make_model, n: int,
                        per_step: dict) -> dict:
    """An S3DIS main path from zeroed counters: Trainer.train_epoch (4
    steps of the c1 recipe) and Trainer.evaluate with MeterS3DIS through
    the DataLoader, then a checkpoint round trip."""
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.data.loader import DataLoader
    from pvcnn_tpu_torch.meters.s3dis import MeterS3DIS
    from pvcnn_tpu_torch.nn.loss import CrossEntropyLoss
    from pvcnn_tpu_torch.train.optim import Adam, CosineAnnealingLR
    from pvcnn_tpu_torch.train.trainer import (Trainer, load_checkpoint,
                                               save_checkpoint)
    from pvcnn_tpu_torch.utils.weights import init_random_

    rng = np.random.RandomState(SEED + 4)
    train_x, train_y = windows(rng, 4 * B, n)
    test_x, test_y = windows(rng, B, n)
    train_set = list(zip(train_x, train_y))
    test_set = list(zip(test_x, test_y))
    model = init_random_(make_model(), SEED)
    optimizer = Adam(model.parameters(), lr=1e-3, weight_decay=1e-5)
    scheduler = CosineAnnealingLR(t_max=50).bind(1e-3)
    trainer = Trainer(model, CrossEntropyLoss(), optimizer, DEVICE, SEED)
    meters = {"acc/iou_test": MeterS3DIS("iou", 13),
              "acc/acc_test": MeterS3DIS("overall", 13)}
    kernels.reset_launch_counts()
    start = time.perf_counter()
    loss = trainer.train_epoch(DataLoader(train_set, B, shuffle=True,
                                          seed=SEED), 0, scheduler)
    scores = trainer.evaluate(DataLoader(test_set, B), meters)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = kernels.launch_counts()
    with tempfile.TemporaryDirectory(dir=_scratch_dir()) as root:
        path = os.path.join(root, "latest.pth.tar")
        save_checkpoint(path, 0, model, optimizer, scores)
        again = make_model()
        epoch, saved = load_checkpoint(path, again)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(
        model.state_dict().values(), again.state_dict().values()))
    log("trainer", f"{label}: {len(train_set)} synthetic windows, 1 epoch of "
        f"{len(train_set) // B} steps at batch {B} (lr {scheduler(0):g}, "
        f"weight decay 1e-5) + {len(test_set)} test windows: {seconds:.2f} "
        f"s, mean loss {loss:.4f}, {scores} (random labels), launches "
        f"{counts}")
    log("trainer", f"{label} checkpoint round trip: epoch {epoch}, meters "
        f"{saved}, state_dict equal {same}")
    if not np.isfinite(loss) or not all(0.0 <= v <= 1.0
                                        for v in scores.values()):
        raise AssertionError(f"bad {label} trainer result {loss} {scores}")
    if not same or epoch != 0 or saved != scores:
        raise AssertionError(f"{label} checkpoint does not round-trip")
    if min(counts[k] for k in per_step) == 0:
        raise AssertionError(f"a kernel did not run: {counts}")
    return counts


def main() -> None:
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.models.s3dis import PVCNN as S3DISPVCNN
    from pvcnn_tpu_torch.models.s3dis import PVCNN2
    from pvcnn_tpu_torch.models.shapenet import PVCNN
    from pvcnn_tpu_torch.utils.weights import init_random_

    profile = "--profile" in sys.argv[1:]
    name = phase_device()
    check_calls()
    phase_build()
    dev = torch.device(DEVICE)

    rec = {"ShapeNet PVCNN 1x": phase_kernels()}
    fwd = ("avg_voxelize", "trilinear_devoxelize", "conv3d_fwd")
    phase_slice("PVCNN 1x", init_random_(PVCNN(50, 16, 3), SEED),
                cloud(np.random.RandomState(SEED + 1), B, N), fwd)
    phase_evaluator()
    rng = np.random.RandomState(SEED + 2)
    batches = [(torch.from_numpy(cloud(rng, B, N)).to(dev),
                torch.from_numpy(rng.randint(0, 50, (B, N))).to(dev))
               for _ in range(3)]
    phase_train("PVCNN 1x", init_random_(PVCNN(50, 16, 3), SEED), batches,
                PER_STEP, profile)
    counts = {"ShapeNet PVCNN 1x": phase_trainer()}

    rec["S3DIS PVCNN2 1x"] = phase_pvcnn2_kernels()
    fwd2 = fwd + ("fps", "ball_query", "three_nn")
    phase_slice("PVCNN2 1x", init_random_(PVCNN2(13, 6), SEED),
                windows(np.random.RandomState(SEED + 11), B, N2)[0], fwd2)
    rng = np.random.RandomState(SEED + 12)
    batches = [tuple(torch.from_numpy(a).to(dev) for a in windows(rng, B, N2))
               for _ in range(3)]
    # PVCNN2's plain path differs from itself by more than 1e-3 at step 3
    # in some runs (the phase logs that spread; its step-1 gradients sit
    # 1.3e-2 from the kernel path's, against 5e-3 for ShapeNet): hold its
    # steps 2-3 to 5e-3
    phase_train("PVCNN2 1x", init_random_(PVCNN2(13, 6), SEED), batches,
                PER_STEP2, profile, weight_decay=1e-5, traj_rtol=5e-3)
    counts["S3DIS PVCNN2 1x"] = phase_s3dis_trainer(
        "PVCNN2", lambda: PVCNN2(13, 6), N2, PER_STEP2)

    rec["S3DIS PVCNN 1x"], rec["S3DIS PVCNN 1x opt-in"] = \
        phase_pvcnn_s3dis_kernels()
    phase_slice("S3DIS PVCNN 1x", init_random_(S3DISPVCNN(13, 6), SEED),
                windows(np.random.RandomState(SEED + 21), B, N3)[0], fwd)
    rng = np.random.RandomState(SEED + 22)
    batches = [tuple(torch.from_numpy(a).to(dev) for a in windows(rng, B, N3))
               for _ in range(3)]
    base = init_random_(S3DISPVCNN(13, 6), SEED)
    off = phase_train("S3DIS PVCNN 1x", base, batches, PER_STEP3, profile,
                      weight_decay=1e-5)
    with switches():
        on = phase_train("S3DIS PVCNN 1x, switches on", base, batches,
                         PER_STEP3_ON, profile, weight_decay=1e-5)
    phase_same_function("S3DIS PVCNN 1x", off, on)
    phase_switch_settings("S3DIS PVCNN 1x", base, batches[0], off)
    counts["S3DIS PVCNN 1x"] = phase_s3dis_trainer(
        "S3DIS PVCNN", lambda: S3DISPVCNN(13, 6), N3, PER_STEP3)
    with switches():
        counts["S3DIS PVCNN 1x opt-in"] = phase_s3dis_trainer(
            "S3DIS PVCNN, switches on", lambda: S3DISPVCNN(13, 6), N3,
            PER_STEP3_ON)

    lines = []
    for k in kernels.KERNELS.values():
        paths = {}
        for path, r in ((p, rec[p][k.name]) for p in rec):
            if not r["cases"] and not counts[path][k.name]:
                continue
            paths[path] = {
                "launches": counts[path][k.name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "library_ms": (r["library_ms"]
                               if r["library_cases"] == r["cases"] else None)}
            if r["cases"] and r["split_cases"] == r["cases"]:
                # K1: "ms" split into its sort glue and the kernel alone
                paths[path].update(glue_ms=r["glue_ms"],
                                   kernel_alone_ms=r["kernel_alone_ms"])
        total = lambda key: sum(rec[p][k.name][key] for p in paths)
        lib = [p["library_ms"] for p in paths.values()]
        lines.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces,
            "launches": sum(p["launches"] for p in paths.values()),
            "max_abs_err": max(p["max_abs_err"] for p in paths.values()),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("operations" if total("ops_ms") >= total("bytes_ms")
                         else "bytes"),
            "library_ms": None if None in lib else sum(lib),
            "paths": paths})
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
