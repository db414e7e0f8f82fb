#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pvcnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Main paths: ShapeNet PVCNN 1x (B = 32, N = 2048), S3DIS PVCNN2 1x
(B = 32, N = 8192, 9 channels, 13 classes), S3DIS PVCNN 1x (B = 32,
N = 4096, 9 channels, 13 classes) with the three switches that open its
opt-in path (PVCNN_TPU_DENSE_BN_FUSED=auto, PVCNN_TPU_CONV_ROWS=0,
PVCNN_TPU_CUSTOM_CONV_WGRAD=1), ShapeNet PointNet++ MSG 1x (B = 32,
N = 2048, 22 channels, 50 classes; with DENSE_BN_FUSED=auto its opt-in
path) and SSG 1x (6 channels), the PointNets, whose default paths
launch no kernel, and the KITTI Frustum family at its configs' full width
(FrustumPVCNNE and FrustumPointNet at B = 32, FrustumPointNet2 at B = 24,
frustums of 1,024 points x 4 channels, 512 points an object; synthetic
frustum batches and trees, data/kitti/frustum.py), ShapeNet PVCNN 1x by
deep mutual learning, and the entry points that train and evaluate them
(S3DIS's on synthetic rooms prepared into windows).
Phases, each printing its own lines and its seconds, and raising on
failure:

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
                cloud at U = 32 and U = 2,048 and three-NN at the
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
                S3DIS PVCNN main paths;
 16. pointnet2 kernels
                as phase 8 at the shapes ShapeNet PointNet++ SSG and MSG
                training give FPS, ball query (U up to 128, radii up to
                0.8), three-NN (against the group-all level's one center)
                and K1's sum mode (384 rows into one bin among them); and
                K9 (its dgrad) and K10 at the MSG step's 26 fused
                SharedMLP layers (DENSE_BN_FUSED=auto);
 17. pointnet2 slice
                MSG and SSG eval forward, as phase 4;
 18. pointnet2 train
                MSG training steps, as phase 6; one step with
                DENSE_BN_FUSED=auto (K9/K10) against its step 1 (launches
                asserted, ms/step; with --profile its breakdown too); SSG
                training steps, as phase 6;
 19. pointnet2 trainer
                the training entry point with model pointnet2msg and then
                pointnet2ssg, as phase 7: the two PointNet++ main paths;
                the voting evaluator with pointnet2ssg (six input columns);
 20. pointnet
                ShapeNet PointNet with its T-Nets (32 x 2048 x 19) and
                S3DIS PointNet (32 x 4096): eval forward and training step
                (ms, peak memory) without a launch, then one step with
                DENSE_BN_FUSED=auto (K9/K10, launches asserted) against
                it; the training entry point with model pointnet and
                phase 11's trainer for S3DIS PointNet, without a launch;
 20b. s3dis pipeline
                four synthetic rooms of about a million points (two in
                Area_5, the test split; one in Area_1 and one in Area_2)
                prepared into windows by the port's preparation
                (data/prepare_s3dis.py:room_windows) and held in an
                in-memory WindowStore (the card's machine has no h5py);
                then for PVCNN2, PVCNN and PointNet at width 1.0 and batch
                32: the training entry point (train.s3dis, one epoch of 4
                steps on the serial loader, setting (a) of 20c, and the
                test split's meters, launches exactly 4 steps' and the
                test forwards', checkpoints, a resumed run
                that only scores; the epoch's wall time split into waiting
                for batches and the steps) and the scene evaluator
                (evaluate.s3dis, one vote, 10 windows a forward: exactly
                the forwards' launches, a prediction for every point a
                window holds and no other, the stats cache; points/s of
                the forward and its wall time split into reading,
                assembling, the forward, the votes and the stats); for
                PVCNN2 and PVCNN the first test room again on the plain
                path (>= 99.99% of its predictions equal, confidences
                within 1e-4);
 20c. host      the host data path (the loader, the host library, the
                trainer's writer, meter and trace): train.s3dis for PVCNN2,
                PVCNN and PointNet at width 1 under each loader setting,
                4 steps at batch 32 from zeroed counters (exactly 4 steps'
                launches; the test split scored only in 20b's serial run
                (a)): (b) prefetch 2, the CLI default, (c) the JAX
                configs' 16 thread workers (clamped to the host's cores),
                (d) a process pool of 2 and of 4; each one's epoch wall time and wait share;
                the training batches of (a) and (b) bitwise equal (crc32
                of every array), and those of the two pools; the S3DIS
                PointNet scene evaluator's recorded votes through the host
                library's reducer and the plain lexsort (exactly equal,
                seconds of each); on a synthetic ShapeNet tree of 96
                shapes, the host library's parser against np.loadtxt
                (equal values, ms), the train split's loader serial and in
                process mode with 2 and 4 workers (ms a batch over two
                epochs, the pools' batches bitwise equal), and
                train.shapenet --profile from zeroed counters (PVCNN's
                kernels launch; the trace names the port's kernels; the
                scalars it wrote and the points/s);
 21. frustum kernels
                as phase 8 at the shapes the Frustum training steps give
                every kernel: K1-K5 at FrustumPVCNNE's PVConvs (R = 16 and
                12, Ci = 4), and on its opt-in path K9 (its dgrad) and K10
                at its fused SharedMLP layers, K11 at its convs, K1/K2/K5
                channel-last; FPS, ball query (sparse frustum clouds),
                three-NN (against the group-all level's one center) and
                K1's sum mode at FrustumPointNet2's;
 22. frustum slice
                each Frustum model's eval forward, as phase 4; the plain
                paths replay the kernel path's foreground draws (a flipped
                mask entry changes the whole draw) and the flips are
                logged;
 23. frustum train
                FrustumPVCNNE, FrustumPointNet2 and FrustumPointNet
                training steps, as phase 6, the plain path replaying each
                kernel-path step's foreground draws (flips logged a step);
                one FrustumPVCNNE step with PVCNN_TPU_CONV_BN_FUSED=0 (the
                unfused rows branch) and one with the three switches on,
                each against the default step 1 (launches asserted,
                ms/step against the default step's in turns, peak memory;
                with --profile their breakdowns too);
 24. frustum trainer
                for each Frustum model from zeroed counters, with its
                recipe: Trainer.train_epoch (4 steps) over synthetic
                frustums through the DataLoader, Trainer.evaluate with the
                configs' four MeterFrustumKitti meters (the sampler draws
                in eval mode too) and a checkpoint round trip: the three
                Frustum main paths;
 25. dml train  ShapeNet PVCNN 1x deep mutual learning steps (DMLTrainer:
                two peers from seeds 0 and 100, one forward each, KL to the
                detached peer) on the kernel path and on the plain path
                from the same two sets of weights, held to phase 6's
                criteria for both peers (step 1 bitwise equal over two
                kernel-path runs, step 1 and steps 2-3 against the plain
                path); launches per step from zeroed counters exactly twice
                phase 6's; ms/step against one single-model step, in turns,
                and peak memory (with --profile its breakdown too);
 26. dml trainer
                the DML entry point (train.dml) from zeroed counters: one
                epoch of 4 steps with the iter schedule on a synthetic tree
                of 64 shapes, the test split scored for both peers, both
                peers' checkpoints, and a resumed run: the DML main path;
 27. kitti      a synthetic KITTI tree (write_synthetic_root: 128 frustums a
                split, label files, image ids), then for each Frustum model
                at its configs' width: the training entry point
                (train.kitti) for one epoch of 4 steps with the four meters
                and its best checkpoints, from zeroed counters; the
                evaluator entry point (evaluate.kitti.frustum) from that
                checkpoint with 2 tests on the rgb-detection split, from
                zeroed counters: exactly the eval forward's kernels launch,
                every AP is finite and in [0, 100], every image has its
                label file; frustums/s of the forward and the evaluator's
                seconds split into data, forward and the host's AP. Then
                the evaluator at the real val split's size (3,769 image
                ids, 11,307 frustums, one test): FrustumPVCNNE 1x from
                zeroed counters (its forward's kernels launch), and perfect
                boxes (the val split's own targets as outputs) through the
                same decode, label files and AP stack, whose every 3-D AP
                must be above 0; the forward's share of a test with the
                model's AP and with the perfect boxes'.
 28. configs    the config-driven entry points (pvcnn_tpu_torch/configs/,
                train/cli.py's prepare and run, python -m
                pvcnn_tpu_torch.train / .evaluate, train_dml, the parity
                tool) at the configs' full width, each main path from
                zeroed counters: ShapeNet PVCNN c1 on a synthetic tree of
                64 shapes, S3DIS PVCNN2 area5/c1 over 20b's rooms (the
                WindowStore set on configs.dataset between prepare and
                run, --configs.train.max_steps=4) and Frustum pvcnne on
                27's tree: one epoch of 4 steps (launches exactly 4 x the
                path's per step plus the scored split's forwards';
                checkpoints bitwise equal to the per-dataset entry point's
                run with the config's seed, and its scalars: the losses
                only for S3DIS, whose test draws follow the prefetch
                thread's early stop), then the evaluator from that run's
                best.pth.tar (ShapeNet 2 votes, S3DIS 1 vote, Frustum 1
                test: exactly the eval forwards' launches, stats or APs
                finite and in range); train_dml for one epoch of ShapeNet
                PVCNN c1 (twice the single path's launches, both peers'
                checkpoints equal to train.dml's); the parity tool's dry
                run of shapenet_pvcnn_c1 on the card (its evaluation in a
                process of its own); --devices 0,1 must raise.

The last two lines are a JSON object with the per-kernel record and
{"ok": true, "device": {...}}. A kernel's `launches` sums its launches in
the trainer phases (7, 11, both runs of 15, 19's two, 20b's, 24's, 26,
27's and 28's training and evaluation runs) and, for K9/K10 on the MSG opt-in path, the
switched step of 18, for FrustumPVCNNE's opt-in path the switched step of
23; its times, bounds and library time are per training step, summed over
the paths' steps (each path's own numbers under "paths"; K1's and K5's
records there also carry glue_ms and kernel_alone_ms, the two parts of
their ms).
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
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
# few fp32 terms in another order (K5 and K1's sum mode: many where a bin
# holds many points, see below); K3 and its dgrad sum 27 * Ci terms in
# another order than cuDNN's fp32 (TF32 off) conv; K9 and its dgrad sum
# Ci (Co) products in another order than cuBLAS; K4, K10 and K11 sum
# B * R^3 (or B * N) products, so their atol is relative to the gradient's
# largest entry; K1's sum mode and K5 are held to an fp64 sum at 1e-6 of
# each output's sum of |terms|, and their atol against the plain version
# is that bound too, at least 1e-5: the order alone moves such a sum by a
# few ulps of its sum of |terms| (PointNet++'s FP1 sums 384 rows into one
# bin; a Frustum object puts hundreds of points into one bin, and a sum of
# under 128 rows of cancelling terms moved by 3.8e-5 there). The index kernels (fps,
# ball_query, three_nn) must equal their plain versions exactly; three_nn's
# d² and weights are held to 1e-5.
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
# three-NN (N, M) at the PointNet++ paths' shapes on ShapeNet-like clouds,
# timed and held to the plain version, not counted per step: ShapeNet
# PointNet2's feature propagation (counted per step in phase 16; (128, 1)
# against the group-all level's single center) and Frustum PointNet2's,
# still to be ported (pvcnn_tpu/models/kitti/frustum/segmentation.py:
# 110-117)
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
# The same per ShapeNet PointNet++ 1x training step (B = 32, N = 2048;
# models/shapenet/pointnetpp.py), from the models' structure: FPS (N, M)
# 2048 -> 512 -> 128 points; ball query (M, N, radius, U) per branch of
# SA1 and SA2 (SA3 groups all); three-NN (N, M) per FP, (128, 1) against
# the group-all level's single center; K1's sum mode (K rows, bins, C) for
# the take_rows backwards of SA2's groupings of SA1's features (SA1 groups
# the input normals, which take no gradient) and of the three FP
# interpolations, (384, 1, 1024) with every row in one bin.
_PN2_SHARED = {
    ("fps", (2048, 512)): 1, ("fps", (512, 128)): 1,
    ("three_nn", (128, 1)): 1, ("three_nn", (512, 128)): 1,
    ("three_nn", (2048, 512)): 1,
    ("scatter_sum", (384, 1, 1024)): 1, ("scatter_sum", (1536, 128, 256)): 1,
    ("scatter_sum", (6144, 512, 128)): 1,
}
CALLS_SSG = {
    **_PN2_SHARED,
    ("ball_query", (512, 2048, 0.2, 64)): 1,
    ("ball_query", (128, 512, 0.4, 64)): 1,
    ("scatter_sum", (8192, 512, 128)): 1,
}
CALLS_MSG = {
    **_PN2_SHARED,
    ("ball_query", (512, 2048, 0.1, 32)): 1,
    ("ball_query", (512, 2048, 0.2, 64)): 1,
    ("ball_query", (512, 2048, 0.4, 128)): 1,
    ("ball_query", (128, 512, 0.4, 64)): 1,
    ("ball_query", (128, 512, 0.8, 128)): 1,
    ("scatter_sum", (8192, 512, 320)): 1,
    ("scatter_sum", (16384, 512, 320)): 1,
}
# MSG with PVCNN_TPU_DENSE_BN_FUSED=auto: every SharedMLP layer given one
# array of rows >= 1024, rows % 256 == 0, runs K9/K10 (rows, Ci, Co,
# prologue): SA1's three branches on B * 512 * U grouped rows of the 3
# normals and 3 offsets, SA2's two on B * 128 * U rows of 320 + 3, the
# group-all SA3 on B * 128 rows of 512 + 3, the FPs on B * 128, B * 512
# and B * 2048 rows (their inputs the interpolated features and the skip),
# and the classifier's first layer; the dgrad (rows, Co, Ci) of each but
# SA1's first layers, whose input is the cloud.
CALLS_MSG_ON = {}
for _rows, _widths in (
        (B * 512 * 32, (6, 32, 32, 64)), (B * 512 * 64, (6, 64, 64, 128)),
        (B * 512 * 128, (6, 64, 96, 128)),
        (B * 128 * 64, (323, 128, 128, 256)),
        (B * 128 * 128, (323, 128, 196, 256)),
        (B * 128, (515, 256, 512, 1024)), (B * 128, (1536, 256, 256)),
        (B * 512, (576, 256, 128)), (B * N, (150, 128, 128, 128)),
        (B * N, (128, 128))):
    for _ci, _co in zip(_widths, _widths[1:]):
        for _k, _c in (("dense_rows_fwd", (_rows, _ci, _co, False)),
                       ("dense_rows_dgrad", (_rows, _co, _ci))):
            if _k == "dense_rows_dgrad" and _ci == 6:
                continue
            CALLS_MSG_ON[(_k, _c)] = CALLS_MSG_ON.get((_k, _c), 0) + 1
        CALLS_MSG_ON[("dense_rows_wgrad", (_rows, _ci, _co, False))] = \
            CALLS_MSG_ON[("dense_rows_fwd", (_rows, _ci, _co, False))]
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
PER_STEP_SSG = {"fps": 2, "ball_query": 2, "three_nn": 3, "scatter_sum": 4}
PER_STEP_MSG = {"fps": 2, "ball_query": 5, "three_nn": 3, "scatter_sum": 5}
_FUSED_MSG = {"dense_rows_fwd": 26, "dense_rows_dgrad": 23,
              "dense_rows_wgrad": 26}
PER_STEP_MSG_ON = {**PER_STEP_MSG, **_FUSED_MSG}
# K9/K10 per training step with PVCNN_TPU_DENSE_BN_FUSED=auto, where the
# default path launches no kernel: ShapeNet PointNet with its T-Nets (the
# T-Nets' three SharedMLPs each, the five point blocks, the classifier's
# second and third layers; its first takes a list and stays unfused; no
# dgrad into the cloud) and S3DIS PointNet (five point blocks and the
# classifier's second layer)
PER_STEP_POINTNET_ON = {"dense_rows_fwd": 13, "dense_rows_dgrad": 12,
                        "dense_rows_wgrad": 13}
PER_STEP_S3DIS_POINTNET_ON = {"dense_rows_fwd": 6, "dense_rows_dgrad": 5,
                              "dense_rows_wgrad": 6}
# KITTI Frustum (models/kitti/frustum): frustums of NF points with one
# extra channel, MF points an object; FrustumPointNet2 trains at batch BF2
NF, MF, BF2 = 1024, 512, 24
# frustums a split of the synthetic KITTI tree of the kitti phase
# (data/kitti/frustum.py:write_synthetic_root; two an image): 4 training
# steps at batch 32, and 128 val and rgb-detection frustums
NUM_KITTI = 128
# the evaluator's AP stack at the size of the real val split: KITTI's val
# image set holds 3,769 image ids; three frustums an image (11,307)
KITTI_VAL_IMAGES, KITTI_PER_IMAGE = 3769, 3
# The same per FrustumPVCNNE 1x training step (B = 32), from the model's
# structure: the instance segmentation's PVConvs (Ci -> Co, R) 4 -> 64 and
# 64 -> 64 at 16, 64 -> 64 and 64 -> 128 at 12, on NF points; the first
# conv0 runs no dgrad (its input is the cloud). The foreground sampler's
# gather carries no gradient (the coordinates are inputs): no K1 sum mode.
# (128, 128, 12) without the prologue is the unfused branch's case
# (PVCNN_TPU_CONV_BN_FUSED=0), checked, not timed.
CALLS_PVCNNE = {
    ("avg_voxelize", (4, 16, NF)): 1, ("avg_voxelize", (64, 16, NF)): 1,
    ("avg_voxelize", (64, 12, NF)): 2,
    ("conv3d_fwd", (4, 64, 16, False)): 1,
    ("conv3d_fwd", (64, 64, 16, False)): 1,
    ("conv3d_fwd", (64, 64, 16, True)): 2,
    ("conv3d_fwd", (64, 64, 12, False)): 1,
    ("conv3d_fwd", (64, 64, 12, True)): 1,
    ("conv3d_fwd", (64, 128, 12, False)): 1,
    ("conv3d_fwd", (128, 128, 12, True)): 1,
    ("conv3d_fwd", (128, 128, 12, False)): 0,
    ("conv3d_dgrad", (64, 64, 16)): 3, ("conv3d_dgrad", (64, 64, 12)): 2,
    ("conv3d_dgrad", (128, 64, 12)): 1, ("conv3d_dgrad", (128, 128, 12)): 1,
}
# FrustumPVCNNE with the three switches on: K1/K2/K5 channel-last, K11 at
# the eight convs, and K9/K10 (rows, Ci, Co, prologue) at every SharedMLP
# layer given one array of >= 1024 rows: the four PVConv point branches,
# 128 -> 1024 and the classifier's second to fourth layers on B * NF rows
# (its first takes a list), the center regression's three and the box
# head's four on B * MF rows; the dgrad (rows, Co, Ci) of each but the
# layers whose input is data (the first point branch's cloud, the center
# regression's sampled coordinates; the box head's coordinates carry the
# center correction's gradient).
CALLS_PVCNNE_ON = {
    ("avg_voxelize", (4, 16, NF)): 1, ("avg_voxelize", (64, 16, NF)): 1,
    ("avg_voxelize", (64, 12, NF)): 2,
    ("conv3d_ndhwc_wgrad", (4, 64, 16)): 1,
    ("conv3d_ndhwc_wgrad", (64, 64, 16)): 3,
    ("conv3d_ndhwc_wgrad", (64, 64, 12)): 2,
    ("conv3d_ndhwc_wgrad", (64, 128, 12)): 1,
    ("conv3d_ndhwc_wgrad", (128, 128, 12)): 1,
}
for _rows, _layers, _data in (
        (B * NF, ((4, 64), (64, 64), (64, 64), (64, 128), (128, 1024),
                  (512, 256), (256, 128), (128, 128)), (4, 64)),
        (B * MF, ((3, 128), (128, 128), (128, 256)), (3, 128)),
        (B * MF, ((3, 128), (128, 128), (128, 256), (256, 512)), None)):
    for _ci, _co in _layers:
        for _k, _c in (("dense_rows_fwd", (_rows, _ci, _co, False)),
                       ("dense_rows_wgrad", (_rows, _ci, _co, False)),
                       ("dense_rows_dgrad", (_rows, _co, _ci))):
            if _k == "dense_rows_dgrad" and (_ci, _co) == _data:
                continue
            CALLS_PVCNNE_ON[(_k, _c)] = CALLS_PVCNNE_ON.get((_k, _c), 0) + 1
for _calls in (CALLS_PVCNNE, CALLS_PVCNNE_ON):
    for _case, _n in (((64, 16, NF), 2), ((64, 12, NF), 1),
                      ((128, 12, NF), 1)):
        _calls[("trilinear_devoxelize", _case)] = _n
        _calls[("devoxelize_bwd", _case)] = _n
for (_k, _c), _n in list(CALLS_PVCNNE.items()):
    if _k == "conv3d_fwd":
        CALLS_PVCNNE[("conv3d_wgrad", _c)] = _n
# The same per FrustumPointNet2 1x training step (B = BF2), from the
# model's structure: the instance segmentation's MSG set abstraction (FPS
# NF -> 128 -> 32; ball query (M, N, radius, U) per branch), its three
# feature propagations (three-NN (N, M), 32 points against the group-all
# level's one center), the box head's set abstraction on MF sampled
# points (FPS 512 -> 128 -> 32); K1's sum mode (K rows, bins, C) for the
# take_rows backwards that carry a gradient: SA2's groupings of SA1's
# features and the three FP interpolations (the first of 1,024 + 3
# channels: the group-all feature and the one-hot vector), and in the box
# head, whose coordinates carry the center correction's gradient, both
# FPS gathers and the groupings of coordinates (and SA2's of SA1's
# features).
CALLS_FPN2 = {
    ("fps", (NF, 128)): 1, ("fps", (128, 32)): 2, ("fps", (MF, 128)): 1,
    ("ball_query", (128, NF, 0.2, 32)): 1,
    ("ball_query", (128, NF, 0.4, 64)): 1,
    ("ball_query", (128, NF, 0.8, 128)): 1,
    ("ball_query", (32, 128, 0.4, 64)): 2,
    ("ball_query", (32, 128, 0.8, 64)): 1,
    ("ball_query", (32, 128, 1.6, 128)): 1,
    ("ball_query", (128, MF, 0.2, 64)): 1,
    ("three_nn", (32, 1)): 1, ("three_nn", (128, 32)): 1,
    ("three_nn", (NF, 128)): 1,
    ("scatter_sum", (2048, 128, 320)): 2,
    ("scatter_sum", (4096, 128, 320)): 1,
    ("scatter_sum", (96, 1, 1027)): 1, ("scatter_sum", (384, 32, 128)): 1,
    ("scatter_sum", (3072, 128, 128)): 1,
    ("scatter_sum", (128, MF, 3)): 1, ("scatter_sum", (8192, MF, 3)): 1,
    ("scatter_sum", (32, 128, 3)): 1, ("scatter_sum", (2048, 128, 3)): 1,
    ("scatter_sum", (2048, 128, 128)): 1,
}
PER_STEP_PVCNNE = {"avg_voxelize": 4, "trilinear_devoxelize": 4,
                   "conv3d_fwd": 8, "conv3d_dgrad": 7, "conv3d_wgrad": 8,
                   "devoxelize_bwd": 4}
PER_STEP_PVCNNE_ON = {"avg_voxelize": 4, "trilinear_devoxelize": 4,
                      "devoxelize_bwd": 4, "conv3d_ndhwc_wgrad": 8,
                      "dense_rows_fwd": 15, "dense_rows_dgrad": 13,
                      "dense_rows_wgrad": 15}
PER_STEP_FPN2 = {"fps": 4, "ball_query": 8, "three_nn": 3,
                 "scatter_sum": 11}


def check_calls() -> None:
    """Each record's calls per step sum to the launches per step that the
    training phases count."""
    for calls, per_step in ((CALLS, PER_STEP), (CALLS2, PER_STEP2),
                            (CALLS3, PER_STEP3), (CALLS3_ON, PER_STEP3_ON),
                            (CALLS_SSG, PER_STEP_SSG),
                            (CALLS_MSG, PER_STEP_MSG),
                            (CALLS_MSG_ON, _FUSED_MSG),
                            (CALLS_PVCNNE, PER_STEP_PVCNNE),
                            (CALLS_PVCNNE_ON, PER_STEP_PVCNNE_ON),
                            (CALLS_FPN2, PER_STEP_FPN2)):
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


# the columns of cloud() that ShapeNet PointNet takes: xyz and the one-hot
# shape id (its config gives no normals)
XYZ_ONE_HOT = [0, 1, 2] + list(range(6, 22))


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


def _compare(kernel, case, got, want, atol_scale=1.0) -> float:
    """got against want at TOL[kernel], its atol times atol_scale (a
    number, or a tensor of one scale an element)."""
    rtol, atol = TOL[kernel]
    atol = atol * atol_scale
    err = (got - want).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{kernel} {case}: non-finite output")
    bad = err > atol + rtol * want.abs()
    big = want.abs() > 1e-3           # relative error where it means something
    rel = (err[big] / want.abs()[big]).max().item() if big.any() else 0.0
    log("kernels", f"{kernel} {case}: max_abs_err {err.max().item():.3e} "
        f"max_rel_err {rel:.3e} where |plain| > 1e-3 (rtol {rtol}, "
        f"atol {float(torch.as_tensor(atol).max()):.3g})")
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
        # each bin's sum of |terms| (a Frustum object crowds hundreds of
        # points into one base bin); held to an fp64 sum at 1e-6 of it,
        # to the plain version at 1e-6 of it where that exceeds 1e-5
        mag = devoxelize._devoxelize_bwd_plain(g.abs(), norm, r, cf)
        exact = devoxelize._devoxelize_bwd_plain(g.double(), norm.double(),
                                                 r, cf)
        e_k = ((got - exact).abs() / mag.clamp(min=1e-30)).max().item()
        e_p = ((want - exact).abs() / mag.clamp(min=1e-30)).max().item()
        log("kernels", f"devoxelize_bwd {case}: max |. - fp64 sum| / "
            f"sum|terms| kernel {e_k:.3e}, plain {e_p:.3e} (<= 1e-6)")
        if e_k > 1e-6:
            raise AssertionError(f"devoxelize_bwd {case}: kernel off the "
                                 "fp64 sum")
        err = _compare("devoxelize_bwd", case, got, want,
                       (mag / 10).clamp(min=1.0))
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


def _fps_case(rec: Record, pts, m):
    """K6 at (N, M) on the points pts [B, N, 3] -> the M centers' indices,
    equal to the plain version's; logs its launch plan, its chain floor
    (the kernel's argmax and exchange alone) and the share of its bound."""
    from pvcnn_tpu_torch.ops import sampling

    b, n = pts.shape[:2]
    case = (n, m)
    run_k = lambda: sampling._fps_cuda(pts, m)
    run_p = lambda: sampling._fps_plain(pts, m)
    idx = _twice("fps", case, run_k)
    _exact("fps", case, idx, run_p())
    timed = rec.add("fps", case, 0.0, run_k, run_p, 10.0 * b * n * (m - 1),
                    4 * (b * n * 3 + b * m), plain_reps=3)
    if timed:
        ms, bound = timed
        chain = time_ms(lambda: sampling._fps_cuda(pts, m, chain_only=True))
        holds = "chain floor" if chain >= bound else "FLOP bound"
        log("kernels", f"fps {case}: {m - 1} dependent steps; (cluster, "
            f"threads, points per thread) {sampling._fps_plan(n)}; chain "
            f"floor {chain:.4f} ms, FLOP bound {bound:.4f} ms: the {holds} "
            f"holds, {max(chain, bound) / ms:.1%} of the kernel's time")
    return idx


def _ball_query_case(rec: Record, pts, ctr, radius, u, sms):
    """K7 at (M, N, radius, U) -> the [B, M, U] indices, equal to the plain
    version's; logs the hits, the points scanned and the launch plan."""
    from pvcnn_tpu_torch.ops import neighbors

    b, n, m = pts.shape[0], pts.shape[1], ctr.shape[1]
    r2 = neighbors._fp32(radius ** 2)
    case = (m, n, radius, u)
    run_k = lambda: neighbors._ball_query_cuda(ctr, pts, r2, u)
    run_p = lambda: neighbors._ball_query_plain(ctr, pts, r2, u)
    got = _twice("ball_query", case, run_k)
    _exact("ball_query", case, got, run_p())
    # the points each center scans: to its U-th hit, or all N (a center
    # with fewer than U hits repeats its first hit in the last slot)
    full = got[..., u - 1] != got[..., 0]
    scanned = torch.where(full, got[..., u - 1].long() + 1, n).sum()
    hits = (neighbors.sq_dist(ctr, pts) < r2).sum(-1)
    log("kernels", f"ball_query {case}: mean hits {hits.float().mean():.2f}"
        f", {float((hits < u).float().mean()):.3f} of the centers take "
        f"the fill; {float(scanned) / (b * m * n):.3f} of the points "
        f"scanned; plan {neighbors._ball_query_plan(b, m, n, u, sms)}")
    rec.add("ball_query", case, 0.0, run_k, run_p, 9.0 * float(scanned),
            4 * (b * m * 3 + b * n * 3 + b * m * u), plain_reps=5)
    return got


def _three_nn_case(rec: Record, pts, ctr, sms):
    """K8 at (N, M) -> the [B, N, 3] indices, equal to the plain version's,
    d² and the weights from them held to TOL; logs the plan and the share
    of the bound."""
    from pvcnn_tpu_torch.ops import interpolate

    case = (pts.shape[1], ctr.shape[1])
    b, (n, m) = pts.shape[0], case
    run_k = lambda: interpolate._three_nn_cuda(pts, ctr)
    run_p = lambda: interpolate._three_nn_plain(pts, ctr)
    idx, d2 = _twice("three_nn", case, run_k)
    want_idx, want_d2 = run_p()
    _exact("three_nn", case, idx, want_idx)
    err = _compare("three_nn", case, interpolate._weights_from_d2(d2),
                   interpolate._weights_from_d2(want_d2))
    # with M < 3 centers the unfilled slots hold d² = inf on both sides
    if not torch.equal(d2[..., m:], want_d2[..., m:]):
        raise AssertionError(f"three_nn {case}: unfilled slots differ")
    err = max(err, _compare("three_nn", case, d2[..., :m], want_d2[..., :m]))
    timed = rec.add("three_nn", case, err, run_k, run_p, 9.0 * b * n * m,
                    4 * (b * n * 3 + b * m * 3 + 2 * b * n * 3),
                    plain_reps=5)
    if timed:
        _three_nn_log(case, run_k, *timed, sms, b)
    return idx


def _scatter_sum_case(rec: Record, idx, bins, c) -> None:
    """K1's sum mode, the take_rows backward, on idx [B, K] into `bins`
    rows of C channels, against the plain version and index_add_; logs
    the longest run (the most rows of one cloud in one bin, which one lane
    group walks serially)."""
    from pvcnn_tpu_torch.ops import voxelize

    dev = idx.device
    b, k = idx.shape
    case = (k, bins, c)
    values = torch.randn(b, k, c, device=dev)
    run_k = lambda: voxelize._scatter_sum_cuda(values, idx, bins)
    run_p = lambda: voxelize._scatter_sum_plain(values, idx, bins)
    flat = (idx.long() + torch.arange(b, device=dev)[:, None] * bins
            ).reshape(-1)
    rows = values.reshape(-1, c)
    run_lib = lambda: values.new_zeros(b * bins, c).index_add_(0, flat, rows)
    got = _twice("scatter_sum", case, run_k)
    want = run_p()
    # each output's sum of |terms|, and the exact sum
    mag = voxelize._scatter_sum_plain(values.abs(), idx, bins)
    err = _compare("scatter_sum", case, got, want, (mag / 10).clamp(min=1.0))
    exact = voxelize._scatter_sum_plain(values.double(), idx, bins)
    e_k = ((got - exact).abs() / mag.clamp(min=1e-30)).max().item()
    e_p = ((want - exact).abs() / mag.clamp(min=1e-30)).max().item()
    log("kernels", f"scatter_sum {case}: max |. - fp64 sum| / sum|terms| "
        f"kernel {e_k:.3e}, plain {e_p:.3e} (<= 1e-6)")
    if e_k > 1e-6:
        raise AssertionError(f"scatter_sum {case}: kernel off the fp64 sum")
    lib_ok = _library_agrees("scatter_sum", case,
                             run_lib().reshape(b, bins, c), want)
    split, longest = _k1_split("scatter_sum", values, idx, bins, False,
                               False)
    log("kernels", f"scatter_sum {case}: longest run {longest} rows")
    rec.add("scatter_sum", case, err, run_k, run_p, b * k * c,
            4 * (b * k * c + b * k + b * bins * c),
            run_lib if lib_ok else None, split=split)


def phase_pvcnn2_kernels() -> dict:
    """Every kernel of the PVCNN2 training step at its shapes there, on
    one batch of synthetic windows: the FPS / ball-query / three-NN
    hierarchy of the model (8192 -> 1024 -> 256 -> 64 -> 16 points), K1's
    sum mode on the take_rows backwards it implies, and K1-K5."""
    dev = torch.device(DEVICE)
    torch.manual_seed(SEED)
    x, _ = windows(np.random.RandomState(SEED + 10), B, N2)
    levels = [torch.from_numpy(x[..., :3]).to(dev)]
    rec = Record(CALLS2)
    for m in (1024, 256, 64, 16):
        pts = levels[-1]
        idx = _fps_case(rec, pts, m)
        levels.append(torch.gather(pts, 1, idx.long()[..., None].expand(
            -1, -1, 3)))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    group_idx, interp_idx = {}, {}
    for level, (radius, u) in enumerate(((0.1, 32), (0.2, 32), (0.4, 32),
                                         (0.8, 32))):
        pts, ctr = levels[level], levels[level + 1]
        got = _ball_query_case(rec, pts, ctr, radius, u, sms)
        group_idx[level] = got.reshape(B, -1)
        idx = _three_nn_case(rec, pts, ctr, sms)
        interp_idx[level] = idx.reshape(B, -1)

    _ball_query_dense(dev)
    _ball_query_many(dev)
    _three_nn_more(dev, sms)

    # the take_rows backwards: SA groupings (B, M*U rows into N bins) and
    # FP interpolations (B, 3N rows into M bins)
    sa_c, fp_c = (32, 64, 128, 256), (128, 256, 256, 512)
    for l in range(4):
        _scatter_sum_case(rec, group_idx[l], levels[l].shape[1], sa_c[l])
    for l in range(4):
        _scatter_sum_case(rec, interp_idx[l], levels[l + 1].shape[1],
                          fp_c[l])

    by_n = {t.shape[1]: t for t in levels}
    _time_pvconv_kernels(rec, lambda n: by_n[n], normalize=True)
    return rec.summary("S3DIS PVCNN2 1x")


def phase_pointnet2_kernels():
    """Every kernel of the ShapeNet PointNet++ SSG and MSG training steps
    at its shapes there, on one batch of ShapeNet-like clouds: FPS 2048 ->
    512 -> 128 points, the ball query of each SA branch, the three-NN of
    each FP (128 points against the group-all level's zero center, 512
    against 128, 2048 against 512), and K1's sum mode on the take_rows
    backwards they imply; then K9, its dgrad and K10 at the MSG step's
    fused SharedMLP layers (PVCNN_TPU_DENSE_BN_FUSED=auto). Returns the
    records (SSG, MSG, MSG opt-in)."""
    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    torch.manual_seed(SEED)
    pts = torch.from_numpy(cloud(np.random.RandomState(SEED + 40), B,
                                 N)[..., :3]).to(dev)
    out = []
    for label, calls in (("ShapeNet PointNet2 SSG 1x", CALLS_SSG),
                         ("ShapeNet PointNet2 MSG 1x", CALLS_MSG)):
        rec = Record(calls)
        cases = lambda kernel: sorted((c for k, c in calls if k == kernel),
                                      reverse=True)
        by_n = {N: pts, 1: torch.zeros(B, 1, 3, device=dev)}
        for n, m in cases("fps"):
            idx = _fps_case(rec, by_n[n], m)
            by_n[m] = torch.gather(by_n[n], 1, idx.long()[..., None].expand(
                -1, -1, 3))
        # the take_rows indices [B, K] into `bins` rows, by (K, bins)
        rows = {}
        for m, n, radius, u in cases("ball_query"):
            got = _ball_query_case(rec, by_n[n], by_n[m], radius, u, sms)
            rows[(m * u, n)] = got.reshape(B, -1)
        for n, m in cases("three_nn"):
            rows[(3 * n, m)] = _three_nn_case(rec, by_n[n], by_n[m],
                                              sms).reshape(B, -1)
        for k, bins, c in cases("scatter_sum"):
            _scatter_sum_case(rec, rows[(k, bins)], bins, c)
        out.append(rec.summary(label))
    on = Record(CALLS_MSG_ON)
    _time_dense_kernels(on)
    out.append(on.summary("ShapeNet PointNet2 MSG 1x opt-in"))
    return tuple(out)


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


def _three_nn_log(case, run_k, ms, bound, sms, b=B) -> None:
    """A K8 case's plan, device time (torch.profiler over 10 calls) and
    share of its bound. Late in a --profile run the profiler has recorded
    part or none of these calls (after four step profiles); with none the
    device time reads "not measured"."""
    import cases_util
    from pvcnn_tpu_torch.ops import interpolate

    own, _ = cases_util.device_ms(run_k, ("three_nn",))
    n, m = case
    device = (f"device {own:.4f} ms ({bound / own:.1%} of the bound)" if own
              else "device time not measured (no kernel in the profile)")
    log("kernels", f"three_nn {case}: plan "
        f"{interpolate._three_nn_plan(b, n, m, sms)}; {device}, {ms:.4f} ms "
        f"by events ({bound / ms:.1%})")


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
    """K8 at the PointNet++ paths' shapes (NN_MORE), 32 clouds each:
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


def _time_dense_kernels(rec: Record, rows: int | None = None) -> None:
    """K9 (forward and dgrad) and K10 at the cases of rec.calls, on random
    [rows, Ci] inputs and [rows, Co] cotangents. Without `rows` each case
    leads with its own: (rows, Ci, Co, prologue) and (rows, Co, Ci)."""
    import torch.nn.functional as F

    from pvcnn_tpu_torch.ops import dense_rows

    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = sorted({(rows,) + c[:2] if rows else c[:3]
                     for k, c in rec.calls if k == "dense_rows_fwd"})
    for n_rows, ci, co in shapes:
        key = (lambda *c: c) if rows else (lambda *c: (n_rows,) + c)
        bound = 1.0 / ci ** 0.5
        x = torch.randn(n_rows, ci, device=dev)
        # the fused SharedMLP's layout: its Conv1d weight [Co, Ci] seen as
        # [Ci, Co], which the kernels read in place
        wt = torch.empty(co, ci, device=dev).uniform_(-bound, bound)
        w = wt.t()
        bias = torch.empty(co, device=dev).uniform_(-bound, bound)
        scale = torch.empty(ci, device=dev).uniform_(0.5, 1.5)
        shift = torch.randn(ci, device=dev) * 0.5
        g = torch.randn(n_rows, co, device=dev)
        flops = 2.0 * n_rows * ci * co
        for pro in (False, True):
            case = key(ci, co, pro)
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
                    4 * (n_rows * ci + ci * co + co + n_rows * co + 2 * co),
                    run_lib if lib_ok else None)

            # K10: dW and d(bias) in one pass, against fp64 too
            log("kernels", f"dense_rows_wgrad {case}: plan "
                f"{dense_rows._plan(ci, co, n_rows, True, sms)}")
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
                    4 * (n_rows * ci + n_rows * co + ci * co + co),
                    run_lib if lib_ok else None)

        # K9 as the dgrad: Co -> Ci channels through W^T
        if ("dense_rows_dgrad", key(co, ci)) in rec.calls:
            case = key(co, ci)
            run_k = lambda: dense_rows._dgrad_cuda(g, w)
            run_p = lambda: dense_rows._dgrad_plain(g, w)
            run_lib = lambda: F.linear(g, w)
            dx = _twice("dense_rows_dgrad", case, run_k)
            want = run_p()
            err = _compare("dense_rows_dgrad", case, dx, want)
            lib_ok = _library_agrees("dense_rows_dgrad", case, run_lib(),
                                     want)
            rec.add("dense_rows_dgrad", case, err, run_k, run_p, flops,
                    4 * (n_rows * co + ci * co + n_rows * ci),
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


def phase_evaluator(model_name: str = "pvcnn",
                    fwd_kernels=("avg_voxelize", "trilinear_devoxelize",
                                 "conv3d_fwd")) -> None:
    """The voting evaluator's entry point for one ShapeNet model, from
    zeroed counters: each of fwd_kernels must launch."""
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.data.shapenet import write_synthetic
    from pvcnn_tpu_torch.evaluate.shapenet.eval import evaluate, mean_iou

    with tempfile.TemporaryDirectory(dir=_scratch_dir()) as root:
        # 2 categories x 2 shapes of 2000-3000 points
        num_items = len(write_synthetic(
            root, [(0, 2417), (0, 2946), (4, 2081), (4, 2590)], seed=SEED))
        kernels.reset_launch_counts()
        start = time.perf_counter()
        stats = evaluate(root, model_name=model_name, width_multiplier=1.0,
                         num_votes=5, batch_size=32, device=DEVICE,
                         seed=SEED)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = kernels.launch_counts()
    if stats.shape != (16, 2) or not np.isfinite(stats).all() \
            or int(stats[:, 1].sum()) != num_items:
        raise AssertionError(f"bad evaluator stats {stats}")
    log("evaluator", f"{model_name}: {num_items} synthetic shapes, 5 votes, "
        f"batch 32: {seconds:.2f} s, mIoU {mean_iou(stats):.4f} (random "
        f"weights, synthetic labels), launches {counts}")
    if min(counts[k] for k in fwd_kernels) == 0:
        raise AssertionError(f"a kernel did not run: {counts}")


def _flat_grads(model) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1) for p in model.parameters()])


def _trainer(base, weight_decay: float, criterion=None):
    """A Trainer (Adam lr 1e-3, seeded dropout and sampler) on a copy of
    base, with CrossEntropyLoss unless a criterion is given."""
    from pvcnn_tpu_torch.nn.loss import CrossEntropyLoss
    from pvcnn_tpu_torch.train.optim import Adam
    from pvcnn_tpu_torch.train.trainer import Trainer

    model = copy.deepcopy(base)
    return Trainer(model, criterion or CrossEntropyLoss(),
                   Adam(model.parameters(), lr=1e-3,
                        weight_decay=weight_decay), torch.device(DEVICE), SEED)


def grads_of(trainer, x, y, seed):
    """Step-1 loss and gradients, without the update."""
    from pvcnn_tpu_torch.train.trainer import SAMPLE_SEED_OFFSET

    trainer.generator.manual_seed(seed)
    trainer.sample_generator.manual_seed(seed + SAMPLE_SEED_OFFSET)
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

    _time_steps(label, kern, plain, *batches[0], b, n)
    if profile:
        _profile_steps(label, kern, *batches[0])
    return loss_k, grads_k


def _time_steps(label, kern, plain, x, y, b, n) -> None:
    """ms/step of the kernel and plain paths' training steps on one batch
    (medians of 3 rounds of 5, in turns) and their peak memory."""
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


def phase_same_function(label: str, off, on, what: str = "switches on",
                        against: str = "off") -> None:
    """Step 1 of the switched-on kernel path against the switched-off one:
    the same function in another order, held to phase 6's criteria."""
    (loss_off, g_off), (loss_on, g_on) = off, on
    rel_loss = abs(loss_on - loss_off) / abs(loss_off)
    g, w = g_on.double(), g_off.double()
    flipped = ((g - w).abs() > 5e-3 * w.abs().max()).double().mean().item()
    rel_l2 = ((g - w).norm() / w.norm()).item()
    log("train", f"{label} step 1, {what} vs {against}: loss {loss_on:.7f} "
        f"vs {loss_off:.7f} (rel {rel_loss:.2e} <= 1e-5); gradients flipped "
        f"fraction {flipped:.2e} (< 2e-3), rel-L2 {rel_l2:.2e} (< 5e-2)")
    if rel_loss > 1e-5 or flipped >= 2e-3 or rel_l2 >= 5e-2:
        raise AssertionError(f"the step with {what} disagrees with the "
                             f"{against} one")


def phase_switched_step(label: str, base, batch, off, on: frozenset,
                        per_step: dict, weight_decay: float = 0.0,
                        profile: bool = False) -> dict:
    """One training step with the switches in `on` set (the others unset):
    its step 1 must agree with the switched-off one (`off`, (loss,
    gradients)), and from zeroed counters it must launch exactly the
    kernels of per_step; ms/step and peak memory (with profile, its
    torch.profiler breakdown too). Returns its launches."""
    from pvcnn_tpu_torch import kernels

    x, y = batch
    what = " + ".join(f"{n.removeprefix('PVCNN_TPU_')}={SWITCHES[n]}"
                      for n in sorted(on))
    with switches(on):
        trainer = _trainer(base, weight_decay)
        phase_same_function(label, off, grads_of(trainer, x, y, SEED), what)
        kernels.reset_launch_counts()
        trainer.train_step(x, y)
        counts = kernels.launch_counts()
        ran = {k: v for k, v in counts.items() if v}
        if ran != per_step:
            raise AssertionError(f"{what}: launches {ran}, expected "
                                 f"{per_step}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: trainer.train_step(x, y), reps=5, warmup=1)
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        log("train", f"{label}, {what}: {ms:.3f} ms/step, peak memory "
            f"{mem:.3f} GiB, launches per step {ran}")
        if profile:
            _profile_steps(f"{label}, {what}", trainer, x, y)
    return counts


def phase_switch_settings(label: str, base, batch, off) -> None:
    """Each of the six mixed settings of the three switches (all off and
    all on run in full in phase 14), as phase_switched_step with the
    launches per_step3 names."""
    from itertools import combinations

    for size in (1, 2):
        for on in map(frozenset, combinations(sorted(SWITCHES), size)):
            phase_switched_step(label, base, batch, off, on, per_step3(on),
                                1e-5)


def phase_pointnet(label: str, base, batch, per_step_on: dict,
                   weight_decay: float = 0.0) -> None:
    """A model whose default path launches no kernel: its eval forward and
    its training step (ms, peak memory) launch none, from zeroed counters;
    then one step with DENSE_BN_FUSED=auto, which runs K9/K10
    (phase_switched_step with per_step_on), against the default one."""
    from pvcnn_tpu_torch import kernels

    x, y = batch
    model = copy.deepcopy(base).to(torch.device(DEVICE)).eval()
    kernels.reset_launch_counts()
    with torch.inference_mode():
        logits = model(x)
        if logits.shape[:2] != y.shape or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
        ms_fwd = time_ms(lambda: model(x), reps=5, warmup=1)
    del model, logits
    trainer = _trainer(base, weight_decay)
    off = grads_of(trainer, x, y, SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: trainer.train_step(x, y), reps=5, warmup=1)
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = kernels.launch_counts()
    del trainer
    log("train", f"{label}, {tuple(x.shape)}: eval forward {ms_fwd:.3f} "
        f"ms/batch, training step {ms:.3f} ms/step, peak memory {mem:.3f} "
        f"GiB; launches {sum(counts.values())}")
    _check_ran(counts, {})
    phase_switched_step(label, base, batch, off,
                        frozenset({"PVCNN_TPU_DENSE_BN_FUSED"}), per_step_on,
                        weight_decay)


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


def phase_trainer(model: str = "pvcnn", per_step: dict = PER_STEP) -> dict:
    """The training entry point of one ShapeNet model, one short epoch,
    from zeroed counters: each kernel of per_step must launch (none where
    it is empty)."""
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.data.shapenet import write_synthetic
    from pvcnn_tpu_torch.models.shapenet import MODELS
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
        meters = train(root, model=model, width_multiplier=1.0,
                       batch_size=32, epochs=1, max_steps=4, save_path=save,
                       device=DEVICE, seed=SEED)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = kernels.launch_counts()
        names = ("latest.pth.tar", "latest/e0.pth.tar", "best.pth.tar")
        missing = [n for n in names
                   if not os.path.exists(os.path.join(save, n))]
        if missing:
            raise AssertionError(f"trainer wrote no {missing}")
        epoch, saved = load_checkpoint(os.path.join(save, "latest.pth.tar"),
                                       MODELS[model].build(50, 16, 1.0))
        again = train(root, model=model, width_multiplier=1.0,
                      batch_size=32, epochs=1, save_path=save, device=DEVICE,
                      seed=SEED)
    iou = meters["acc/iou_test"]
    log("trainer", f"{model}: 64 synthetic shapes, 1 epoch of 4 steps at "
        f"batch 32 + test split: {seconds:.2f} s, acc/iou_test {iou:.4f} "
        f"(random labels), checkpoints {list(names)}, launches {counts}")
    log("trainer", f"{model}: resumed run loaded epoch {epoch} and "
        f"re-evaluated acc/iou_test {again['acc/iou_test']:.4f}")
    if not 0.0 <= iou <= 1.0 or epoch != 0 \
            or saved["acc/iou_test"] != iou \
            or abs(again["acc/iou_test"] - iou) > 1e-6:
        raise AssertionError("trainer checkpoints do not round-trip")
    _check_ran(counts, per_step)
    return counts


def _check_ran(counts: dict, per_step: dict) -> None:
    """Each kernel of per_step launched in the run; with an empty per_step,
    none did."""
    if not per_step and any(counts.values()):
        raise AssertionError(f"a kernel ran on a path without one: {counts}")
    if per_step and min(counts[k] for k in per_step) == 0:
        raise AssertionError(f"a kernel did not run: {counts}")


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
    _check_ran(counts, per_step)
    return counts


# synthetic S3DIS rooms of the s3dis pipeline phase (area, room, points):
# two in the holdout area (the test split), one in each of two others (the
# train split), on the order of an S3DIS room's million points
S3DIS_ROOMS = (("Area_1", "office_1", 1_000_000),
               ("Area_2", "office_1", 950_000),
               ("Area_5", "office_1", 1_050_000),
               ("Area_5", "office_2", 900_000))


def _droppable(xyz, offset: float):
    """Mask of the points the grid resampling may drop at `offset`: those
    in a 3 cm cell of fewer points than its block's mean count, whose
    repeats it cuts short (every other point is kept)."""
    from pvcnn_tpu_torch.data.prepare_s3dis import _blocks, _unique_rows

    mask = np.zeros(len(xyz), dtype=bool)
    for idx in _blocks(xyz, offset, 1.5, N2)[0]:
        if len(idx):
            cells = xyz[idx] - xyz[idx].min(axis=0)
            _, inverse, counts = _unique_rows(
                np.floor(cells / 0.03).astype(np.int64))
            mask[idx] = counts[inverse] < int(np.average(counts))
    return mask


def s3dis_rooms(root: str, seed: int):
    """Prepare S3DIS_ROOMS with the port's preparation (room_windows) from
    synthetic_room's arrays: each room's label.npy under root/<area>/<room>
    and its windows in a WindowStore under the paths the reader walks (no
    h5py on the card's machine). Logs each room's windows, data_num's
    range and the seconds; checks the windows' shapes and indices, and
    that every point no window holds is one the grid resampling may drop
    at both offsets (_droppable: a few hundred of a million points fall
    out so, in the JAX package too). -> (store, {scene: mask of the points
    some window holds})."""
    from pvcnn_tpu_torch.data.prepare_s3dis import (room_windows,
                                                    synthetic_room)
    from pvcnn_tpu_torch.data.s3dis import WindowStore

    rng = np.random.RandomState(seed)
    store, covered = WindowStore(), {}
    for area, room, points in S3DIS_ROOMS:
        start = time.perf_counter()
        xyzrgb, labels = synthetic_room(rng, points)
        drawn = time.perf_counter() - start
        scene = os.path.join(root, area, room)
        os.makedirs(scene)
        np.save(os.path.join(scene, "label.npy"), labels)
        index = sorted(r for a, r, _ in S3DIS_ROOMS if a == area).index(room)
        start = time.perf_counter()
        files = room_windows(xyzrgb, labels, index, rng, max_num_points=N2)
        seconds = time.perf_counter() - start
        mask = np.zeros(points, dtype=bool)
        for offset, k, arrays in files:
            store[os.path.join(scene, f"{offset}_{k}.h5")] = arrays
            nums = arrays["data_num"]
            if arrays["data"].shape[1:] != (N2, 9) or nums.min() < 1 \
                    or nums.max() > N2:
                raise AssertionError(f"bad windows in {scene} {offset}")
            for row, num in zip(arrays["indices_split_to_full"], nums):
                mask[row[:num]] = True
        xyz = xyzrgb[:, :3] - xyzrgb[:, :3].min(axis=0)
        droppable = _droppable(xyz, 0.0) & _droppable(xyz, 0.75)
        lost = points - int(mask.sum())
        log("s3dis", f"{area}/{room}: {points} points, drawn in {drawn:.2f} "
            f"s, prepared in {seconds:.2f} s: "
            + ", ".join(f"{o}_{k} {a['data'].shape[0]} windows, data_num "
                        f"{a['data_num'].min()}-{a['data_num'].max()}"
                        for o, k, a in files)
            + f"; points in no window {lost} ({lost / points:.2e}), of "
            f"{int(droppable.sum())} the resampling may drop at both "
            "offsets")
        if [(o, k) for o, k, _ in files] != [("zero", 0), ("half", 0)] \
                or (~mask & ~droppable).any():
            raise AssertionError(f"bad windows of {scene}: "
                                 f"{int((~mask & ~droppable).sum())} points "
                                 "the resampling keeps are in no window")
        covered[scene] = mask
    return store, covered


def _miou(stats) -> float:
    """The scene evaluator's mIoU (print_stats) of stats [3, 13, scenes]."""
    seen, positive, true = stats.sum(-1)
    return float(np.mean(true / np.maximum(seen + positive - true, 1)))


def phase_s3dis_pipeline(name: str, root: str, store, covered: dict,
                         per_step: dict, fwd_kernels, plain: bool,
                         serial: dict) -> dict:
    """One S3DIS model's entry points at width 1.0 on the prepared rooms,
    through the reader over the in-memory store: train.s3dis for one epoch
    of 4 steps at batch 32 on the serial loader (prefetch 0, the host
    phase's setting (a): serial[name] gets its training batches' digests
    and its timings) and the test split's two meters, from zeroed
    counters: its launches must be 4 x per_step plus the eval forwards'
    (fwd_kernels' counts in per_step, a test batch each); its checkpoints,
    and a second call that resumes and only scores. Then the scene
    evaluator (evaluate.s3dis) from its best.pth.tar, num_votes 1, batch
    10, from zeroed counters: exactly the forwards' launches; every point a
    window holds has a prediction, no other does; the stats cache
    answers a second call. With `plain`, the first test room again under
    plain_on_card(): its predictions on >= 99.99% of the points and its
    confidences within 1e-4 of the kernel path's. Logs the epoch's wall
    time split into waiting for batches and the steps, the forward's
    points/s and the evaluator's time split. -> the launches of the
    training and evaluation runs."""
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.data.s3dis import S3DIS, WindowStore
    from pvcnn_tpu_torch.evaluate.s3dis.eval import evaluate
    from pvcnn_tpu_torch.models.s3dis import MODELS
    from pvcnn_tpu_torch.train.s3dis import METRIC, train
    from pvcnn_tpu_torch.train.trainer import load_checkpoint

    fwd = {k: per_step[k] for k in fwd_kernels}
    test = S3DIS(root, MODELS[name].num_points, split="test",
                 opener=store)["test"]
    test_batches = -(-len(test) // B)
    save = os.path.join(root, f"run.{name}")
    run = dict(model=name, batch_size=B, epochs=1, max_steps=4,
               save_path=save, device=DEVICE, seed=SEED, opener=store)
    spent = {}
    kernels.reset_launch_counts()
    start = time.perf_counter()
    with train_batch_digests([]) as digests:
        scores = train(root, timings=spent, prefetch=0, **run)
    serial[name] = (digests, spent)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = kernels.launch_counts()
    want = {k: 4 * per_step.get(k, 0) + test_batches * fwd.get(k, 0)
            for k in counts}
    checkpoints = ("latest.pth.tar", "latest/e0.pth.tar", "best.pth.tar",
                   "best/best.acc.iou_test.pth.tar")
    missing = [c for c in checkpoints
               if not os.path.exists(os.path.join(save, c))]
    epoch, _ = load_checkpoint(os.path.join(save, "latest.pth.tar"),
                               MODELS[name].build(1.0))
    kernels.reset_launch_counts()
    again = train(root, **run)
    resumed = kernels.launch_counts()
    log("s3dis", f"{name}: train.s3dis (serial loader), 1 epoch of 4 steps "
        f"at batch {B} + {len(test)} test windows: {seconds:.2f} s, "
        f"{scores} (random "
        f"weights, synthetic labels); epoch {spent['train']:.3f} s = "
        f"waiting for batches {spent['train_data']:.3f} s + steps "
        f"{spent['train'] - spent['train_data']:.3f} s; scoring "
        f"{spent['eval']:.3f} s, of it waiting for batches "
        f"{spent['test_data']:.3f} s; launches "
        f"{ {k: v for k, v in counts.items() if v} }; resumed from epoch "
        f"{epoch}: {again}")
    if missing or epoch != 0 or not all(0.0 <= v <= 1.0
                                        for v in scores.values()):
        raise AssertionError(f"bad S3DIS {name} training run: missing "
                             f"{missing}, epoch {epoch}, meters {scores}")
    if counts != want:
        raise AssertionError(f"train.s3dis launches {counts}, expected "
                             f"{want}")
    if resumed != {k: test_batches * fwd.get(k, 0) for k in counts}:
        raise AssertionError(f"the resumed run did not only score: "
                             f"{resumed}")

    best = os.path.join(save, "best.pth.tar")
    spent, outputs = {}, {}
    kernels.reset_launch_counts()
    start = time.perf_counter()
    stats = evaluate(root, model_name=name, checkpoint=best, num_votes=1,
                     batch_size=10, device=DEVICE, seed=SEED, opener=store,
                     timings=spent, scene_outputs=outputs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    ran = kernels.launch_counts()
    forwards = sum(-(-store[f]["data"].shape[0] // 10)
                   for files in test.scene_list.values() for f in files)
    unpredicted = {s: int(((p >= 0) != covered[s]).sum())
                   for s, (_, p) in outputs.items()}
    kernels.reset_launch_counts()
    cached = evaluate(root, model_name=name, checkpoint=best, device=DEVICE,
                      opener=store)
    log("s3dis", f"{name}: scene evaluator, {len(outputs)} rooms of "
        f"{stats[0].sum():.0f} points, {spent['windows']} windows, "
        f"{spent['sub_clouds']} sub-clouds: {seconds:.2f} s = read "
        f"{spent['read']:.3f} + assemble {spent['assemble']:.3f} + forward "
        f"{spent['forward']:.3f} ({spent['points'] / spent['forward']:.0f} "
        f"points/s) + votes {spent['votes']:.3f} + stats "
        f"{spent['stats']:.3f} s; mIoU {_miou(stats):.4f}; "
        f"launches { {k: v for k, v in ran.items() if v} } in {forwards} "
        f"forwards; points without a vote "
        f"{stats[0].sum() - stats[1].sum():.0f}")
    held = sum(int(covered[s].sum()) for s in outputs)
    if stats.shape != (3, 13, 2) or not np.isfinite(stats).all() \
            or any(unpredicted.values()) or stats[1].sum() != held \
            or stats[0].sum() != sum(covered[s].size for s in outputs):
        raise AssertionError(f"bad S3DIS {name} evaluation: points whose "
                             f"prediction disagrees with its windows "
                             f"{unpredicted}")
    if ran != {k: forwards * fwd.get(k, 0) for k in ran}:
        raise AssertionError(f"evaluator launches {ran}, expected "
                             f"{forwards} x {fwd}")
    if not np.array_equal(cached, stats) or any(
            kernels.launch_counts().values()):
        raise AssertionError("the evaluator's stats cache did not answer")
    if plain:
        scene = next(iter(test.scene_list))
        one = os.path.join(root, "plain", name)
        alone = os.path.join(one, os.path.relpath(scene, root))
        os.makedirs(alone)
        shutil.copyfile(os.path.join(scene, "label.npy"),
                        os.path.join(alone, "label.npy"))
        plain_store = WindowStore({f.replace(scene, alone): store[f]
                                   for f in test.scene_list[scene]})
        plain_out = {}
        start = time.perf_counter()
        with plain_on_card():
            evaluate(one, model_name=name, checkpoint=best, num_votes=1,
                     batch_size=10, device=DEVICE, seed=SEED,
                     opener=plain_store,
                     stats_path=os.path.join(save, "plain.eval.npy"),
                     scene_outputs=plain_out)
        seconds = time.perf_counter() - start
        (conf_k, pred_k), (conf_p, pred_p) = outputs[scene], plain_out[alone]
        flips = int((pred_k != pred_p).sum())
        dconf = float(np.abs(conf_k - conf_p).max())
        log("s3dis", f"{name}: {scene} on the plain path ({seconds:.2f} s): "
            f"{flips} of {pred_k.size} predictions flipped (agreement "
            f"{1 - flips / pred_k.size:.6f}, >= 0.9999), max |dconfidence| "
            f"{dconf:.3e} (<= 1e-4)")
        if flips > 1e-4 * pred_k.size or dconf > 1e-4:
            raise AssertionError(f"S3DIS {name}: kernel and plain paths' "
                                 "scene predictions disagree")
    return _add_counts(counts, ran)


@contextlib.contextmanager
def train_batch_digests(out: list):
    """Append (shape, dtype, crc32) of each numpy array the Trainer moves
    to the card while its model is in training mode (the training batches,
    not the test split's) to `out`."""
    from pvcnn_tpu_torch.train.trainer import Trainer

    to_device = Trainer._to_device

    def recording(self, array):
        if self.model.training and isinstance(array, np.ndarray):
            a = np.ascontiguousarray(array)
            out.append((a.shape, a.dtype.str,
                        zlib.crc32(memoryview(a).cast("B"))))
        return to_device(self, array)

    with mock.patch.object(Trainer, "_to_device", recording):
        yield out


# the host phase's loader settings of train.s3dis beside phase 20b's serial
# run (a): (b) prefetch 2, the CLI default; (c) the JAX configs' 16 thread
# workers (clamped to the host's cores, prefetch 2); (d) a process pool of
# 2, then of 4
LOADER_SETTINGS = (
    ("b prefetch 2", dict(prefetch=2)),
    ("c 16 threads", dict(num_workers=16, workers_mode="thread",
                          prefetch=2)),
    ("d process x2", dict(num_workers=2, workers_mode="process",
                          prefetch=2)),
    ("d process x4", dict(num_workers=4, workers_mode="process",
                          prefetch=2)),
)


def phase_host_loader(name: str, root: str, store, per_step: dict,
                      serial: tuple) -> None:
    """train.s3dis for one model under each LOADER_SETTINGS entry, one
    epoch of 4 steps at batch 32 from zeroed counters, the test split not
    scored (Trainer.evaluate stubbed): launches exactly 4 x per_step; the
    wait share (waiting for batches over the epoch) and the epoch's wall
    time beside phase 20b's serial run `serial` = (digests, timings); the
    training batches of (b) bitwise those of (a), and those of the two
    pools bitwise each other's."""
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.train.s3dis import train
    from pvcnn_tpu_torch.train.trainer import Trainer

    runs = {"a serial": serial}
    for label, options in LOADER_SETTINGS:
        digests, spent = [], {}
        kernels.reset_launch_counts()
        with train_batch_digests(digests), mock.patch.object(
                Trainer, "evaluate",
                lambda self, loader, meters: dict.fromkeys(meters, 0.0)):
            train(root, model=name, batch_size=B, epochs=1, max_steps=4,
                  save_path=os.path.join(root, f"host.{name}.{label[0]}"
                                         f"{len(runs)}"),
                  device=DEVICE, seed=SEED, opener=store, timings=spent,
                  **options)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = {k: 4 * per_step.get(k, 0) for k in counts}
        if counts != want:
            raise AssertionError(f"{name} {label}: launches {counts}, "
                                 f"expected {want}")
        runs[label] = (digests, spent)
    for label, (digests, spent) in runs.items():
        log("host", f"S3DIS {name} train.s3dis, 4 steps at batch {B}, "
            f"loader {label}: epoch {spent['train']:.3f} s, waiting for "
            f"batches {spent['train_data']:.3f} s (wait share "
            f"{spent['train_data'] / spent['train']:.4f}); "
            f"{len(digests) // 2} batches hashed")
    a, b = runs["a serial"][0], runs["b prefetch 2"][0]
    d2, d4 = runs["d process x2"][0], runs["d process x4"][0]
    if len(a) != 8 or a != b:
        raise AssertionError(f"{name}: prefetch's batches are not the serial "
                             "loader's")
    if len(d2) != 8 or d2 != d4:
        raise AssertionError(f"{name}: the pools of 2 and 4 workers gave "
                             "other batches")
    log("host", f"S3DIS {name}: batches (a) == (b) and (d x2) == (d x4) "
        "bitwise (crc32 of every array); (c) equals (a): "
        f"{runs['c 16 threads'][0] == a}")


def phase_host_votes(root: str, store) -> None:
    """The scene evaluator (S3DIS PointNet from phase 20b's best.pth.tar,
    one vote, 10 windows a forward) with its vote reductions recorded;
    the recorded votes then go, scene by scene, through the host library's
    reducer and through the plain lexsort: equal confidences and
    predictions exactly, each one's seconds."""
    from pvcnn_tpu_torch.evaluate import votes
    from pvcnn_tpu_torch.evaluate.s3dis import eval as s3dis_eval

    calls = []

    def recording(conf, pred, idx, confidences, predictions):
        calls.append((conf.copy(), pred.copy(), idx.copy(), confidences))
        votes.vote_reduce_max(conf, pred, idx, confidences, predictions)

    outputs = {}
    with mock.patch.object(s3dis_eval, "vote_reduce_max", recording):
        s3dis_eval.evaluate(root, model_name="pointnet",
                            checkpoint=os.path.join(root, "run.pointnet",
                                                    "best.pth.tar"),
                            num_votes=1, batch_size=10, device=DEVICE,
                            seed=SEED, opener=store,
                            stats_path=os.path.join(root, "host.eval.npy"),
                            scene_outputs=outputs)
    kept = {id(conf): (conf, pred) for conf, pred in outputs.values()}
    results, seconds = {}, {}
    for fn in (votes.vote_reduce_max, votes.vote_reduce_max_plain):
        fresh = {k: (np.zeros_like(c), np.full_like(p, -1))
                 for k, (c, p) in kept.items()}
        start = time.perf_counter()
        for conf, pred, idx, target in calls:
            fn(conf, pred, idx, *fresh[id(target)])
        seconds[fn.__name__] = time.perf_counter() - start
        results[fn.__name__] = fresh
    total = sum(len(c[0]) for c in calls)
    for k, (conf, pred) in kept.items():
        for got in results.values():
            if not (np.array_equal(got[k][0], conf)
                    and np.array_equal(got[k][1], pred)):
                raise AssertionError("the reducers kept other votes")
    log("host", f"vote reduction of the scene evaluator's {total} votes in "
        f"{len(calls)} calls over {len(kept)} rooms: host library "
        f"{seconds['vote_reduce_max']:.4f} s, plain lexsort "
        f"{seconds['vote_reduce_max_plain']:.4f} s; kept confidences and "
        "predictions exactly equal")


# ShapeNet tree of the host phase: shapes of 2,000-3,000 points
HOST_SHAPES = 96


def phase_host_shapenet(per_step: dict) -> None:
    """On a synthetic tree of HOST_SHAPES shapes: the host library's
    parser against np.loadtxt on every item file (equal values, ms of
    each); the train split's DataLoader (batch 32) serial and in process
    mode with 2 and 4 workers over two epochs, ms a batch, the two pools'
    batches bitwise equal; then train.shapenet --profile for one epoch of
    4 steps from zeroed counters (each of per_step's kernels launches): the
    trace under <save>/profile names a port kernel, the scalars the run
    wrote and the points/s."""
    import io

    from pvcnn_tpu_torch import kernels, native
    from pvcnn_tpu_torch.data.loader import DataLoader
    from pvcnn_tpu_torch.data.shapenet import (ShapeNetDataset, file_paths,
                                               write_synthetic)
    from pvcnn_tpu_torch.train.shapenet import main as train_main

    rng = np.random.RandomState(SEED + 5)
    items = [(int(s), int(n)) for s, n in
             zip(rng.randint(0, 16, HOST_SHAPES),
                 rng.randint(2000, 3000, HOST_SHAPES))]
    with tempfile.TemporaryDirectory(dir=_scratch_dir()) as root:
        write_synthetic(root, items, seed=SEED)
        paths = [p for p, _ in file_paths(root, "test")]
        times = {}
        # in turns, twice each (the first pass reads the files from disk);
        # the second pass's ms are logged
        for label, parse in 2 * (("native", native.loadtxt),
                                 ("np.loadtxt", lambda p: np.loadtxt(
                                     p, dtype=np.float32, ndmin=2))):
            start = time.perf_counter()
            tables = [parse(p) for p in paths]
            times[label] = (time.perf_counter() - start) * 1e3
            times[label + " tables"] = tables
        if not all(np.array_equal(a, b) for a, b in
                   zip(times["native tables"], times["np.loadtxt tables"])):
            raise AssertionError("the host library parsed other values")
        rows = sum(len(t) for t in times["native tables"])
        log("host", f"parse {len(paths)} ShapeNet item files ({rows} rows): "
            f"host library {times['native']:.1f} ms, np.loadtxt "
            f"{times['np.loadtxt']:.1f} ms, values equal")

        runs = {}
        for label, options in (("serial", dict(prefetch=0)),
                               ("process x2", dict(num_workers=2,
                                                   workers_mode="process")),
                               ("process x4", dict(num_workers=4,
                                                   workers_mode="process"))):
            loader = DataLoader(ShapeNetDataset(root, N, "train", seed=SEED),
                                B, shuffle=True, seed=SEED, **options)
            ms, digests = [], []
            try:
                for epoch in range(2):
                    loader.epoch = epoch
                    start = time.perf_counter()
                    batches = list(loader)
                    ms.append((time.perf_counter() - start) * 1e3
                              / len(batches))
                    digests += [zlib.crc32(memoryview(a).cast("B"))
                                for x, y in batches for a in (x, y)]
            finally:
                loader.close()
            runs[label] = digests
            log("host", f"ShapeNet train split ({2 * HOST_SHAPES} items), "
                f"batch {B}, loader {label}: epoch 0 (parse + resample) "
                f"{ms[0]:.2f} ms a batch, epoch 1 (cached) {ms[1]:.2f} ms "
                "a batch")
        if runs["process x2"] != runs["process x4"]:
            raise AssertionError("ShapeNet process pools of 2 and 4 gave "
                                 "other batches")
        log("host", "ShapeNet process batches of 2 and 4 workers bitwise "
            "equal")

        save = os.path.join(root, "profiled")
        out = io.StringIO()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        with contextlib.redirect_stdout(out):
            train_main(["--root", root, "--epochs", "1", "--max-steps", "4",
                        "--batch-size", str(B), "--num-points", str(N),
                        "--save-path", save, "--device", DEVICE,
                        "--num-workers", "0", "--profile"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = kernels.launch_counts()
        traces = [os.path.join(save, "profile", f)
                  for f in os.listdir(os.path.join(save, "profile"))]
        with open(traces[0]) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        found = sorted({k for _, keys in PROFILE_GROUPS[:14] for k in keys
                        if any(k in n for n in names)})
        with open(os.path.join(save, "scalars.jsonl")) as f:
            tags = sorted({json.loads(line)["tag"] for line in f})
        pps = [line for line in out.getvalue().splitlines()
               if line.startswith("[points/sec]")]
        log("host", f"train.shapenet --profile, 1 epoch of 4 steps + test "
            f"split: {seconds:.2f} s; trace {os.path.basename(traces[0])} "
            f"({os.path.getsize(traces[0])} bytes, {len(names)} event names) "
            f"names the port kernels {found}; scalars.jsonl tags {tags}; "
            f"{pps}")
        if len(traces) != 1 or not found or not pps \
                or "perf/points_per_sec" not in tags:
            raise AssertionError("the profiled epoch wrote no trace of the "
                                 "port's kernels")
        _check_ran(counts, per_step)


def frustum_batches(seed: int, b: int, count: int):
    """`count` synthetic frustum batches (data/kitti/frustum.py) of b x NF
    points: (inputs, targets) dicts of tensors on the card."""
    from pvcnn_tpu_torch.data.kitti.frustum import synthetic_batch

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        out.append(tuple({k: torch.from_numpy(v).to(DEVICE)
                          for k, v in part.items()}
                         for part in synthetic_batch(rng, b, NF)))
    return out


@contextlib.contextmanager
def sampler_record(store: list):
    """Record each foreground draw of the Frustum models (ops.logits_mask):
    the mask and the indices it selected, in call order."""
    from pvcnn_tpu_torch.ops import sampling

    draw = sampling.logits_mask_indices

    def indices(mask, m, generator=None):
        idx = draw(mask, m, generator)
        store.append((mask.clone(), idx.clone()))
        return idx

    with mock.patch.object(sampling, "logits_mask_indices", indices):
        yield


@contextlib.contextmanager
def sampler_replay(store: list, flips: list):
    """Replay recorded foreground draws in call order: each ops.logits_mask
    takes the recorded mask and indices instead of its own. A comparison
    path's logits differ in the last bits, and one flipped mask entry
    changes the candidate count and with it the whole draw. `flips` gets,
    a call each, the mask entries its own logits would have flipped."""
    from pvcnn_tpu_torch.ops import sampling

    select = sampling.logits_mask
    calls = iter(store)

    def logits_mask(coords, logits, m, generator=None):
        mask, idx = (t.to(logits.device) for t in next(calls))
        flips.append(int((mask != (logits[..., 0] < logits[..., 1])).sum()))
        as_logits = torch.stack([~mask, mask], -1).to(logits.dtype)
        with mock.patch.object(sampling, "logits_mask_indices",
                               lambda *a: idx):
            return select(coords, as_logits, m, generator)

    with mock.patch.object(sampling, "logits_mask", logits_mask):
        yield


@contextlib.contextmanager
def environ(values: dict):
    """Set the environment variables of `values`; restore them after."""
    saved = {name: os.environ.get(name) for name in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def phase_frustum_kernels():
    """Every kernel of the Frustum training steps at its shapes there, on
    synthetic frustum batches: K1-K5 at FrustumPVCNNE's PVConvs (R = 16,
    12) on 32 x NF points; on its opt-in path K9 (and its dgrad) and K10 at
    its fused SharedMLP layers, K11 at its convs, K1/K2/K5 channel-last;
    for FrustumPointNet2 (B = BF2) FPS, ball query (sparse frustum clouds:
    most centers take the first-hit fill), three-NN (32 points against the
    group-all level's one center) and K1's sum mode on the take_rows
    backwards, the box head's on MF points drawn by the foreground sampler
    from the object's points. Returns the records (PVCNNE, PVCNNE opt-in,
    PointNet2)."""
    from pvcnn_tpu_torch.data.kitti.frustum import synthetic_batch
    from pvcnn_tpu_torch.ops import sampling

    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    torch.manual_seed(SEED)
    x, _ = synthetic_batch(np.random.RandomState(SEED + 60), B, NF)
    coords = torch.from_numpy(x["features"][..., :3]).to(dev)
    pv = Record(CALLS_PVCNNE)
    _time_pvconv_kernels(pv, lambda n: coords[:, :n], normalize=True)
    on = Record(CALLS_PVCNNE_ON)
    _time_dense_kernels(on)
    _time_ndhwc_wgrad(on)
    _time_pvconv_kernels(on, lambda n: coords[:, :n], normalize=True,
                         cf=False)

    x, y = synthetic_batch(np.random.RandomState(SEED + 61), BF2, NF)
    pts = torch.from_numpy(x["features"][..., :3]).to(dev)
    mask = torch.from_numpy(y["mask_logits"]).to(dev).bool()
    fg, _, _ = sampling.logits_mask(
        pts, torch.stack([~mask, mask], -1).float(), MF,
        torch.Generator(device=dev).manual_seed(SEED))
    rec = Record(CALLS_FPN2)
    again = Record({})               # a case's second call: checked only
    done, rows = set(), {}

    def record(case):
        timed = rec if case not in done else again
        done.add(case)
        return timed

    def set_abstraction(points, m, levels):
        n = points.shape[1]
        idx = _fps_case(record((n, m)), points, m)
        rows[(m, n)] = idx
        centers = torch.gather(points, 1,
                               idx.long()[..., None].expand(-1, -1, 3))
        for radius, u in levels:
            got = _ball_query_case(record((m, n, radius, u)), points,
                                   centers, radius, u, sms)
            rows[(m * u, n)] = got.reshape(BF2, -1)
        return centers

    c1 = set_abstraction(pts, 128, ((0.2, 32), (0.4, 64), (0.8, 128)))
    c2 = set_abstraction(c1, 32, ((0.4, 64), (0.8, 64), (1.6, 128)))
    b1 = set_abstraction(fg.contiguous(), 128, ((0.2, 64),))
    set_abstraction(b1, 32, ((0.4, 64),))
    for queries, centers in ((c2, torch.zeros(BF2, 1, 3, device=dev)),
                             (c1, c2), (pts, c1)):
        idx = _three_nn_case(rec, queries, centers, sms)
        rows[(3 * queries.shape[1], centers.shape[1])] = idx.reshape(BF2, -1)
    for k, bins, c in sorted(c for k, c in CALLS_FPN2 if k == "scatter_sum"):
        _scatter_sum_case(rec, rows[(k, bins)], bins, c)
    return (pv.summary("KITTI FrustumPVCNNE 1x"),
            on.summary("KITTI FrustumPVCNNE 1x opt-in"),
            rec.summary("KITTI FrustumPointNet2 1x"))


def _outputs_agree(label, what, got: dict, want: dict) -> None:
    """Every output of a Frustum model within 1e-3 of the larger of 1 and
    its largest entry, the foreground masks' argmax agreeing on >= 0.999
    of the points."""
    worst = 0.0
    for key, w in want.items():
        g = got[key]
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{label} {key}: bad output "
                                 f"{tuple(g.shape)}")
        worst = max(worst, ((g - w).abs().max() / w.abs().max().clamp(
            min=1.0)).item())
    agree = (got["mask_logits"].argmax(-1) == want["mask_logits"].argmax(-1)
             ).float().mean().item()
    log("slice", f"{label}: {what}: max |d| / max(1, max |output|) "
        f"{worst:.3e} over the outputs (<= 1e-3), mask argmax agreement "
        f"{agree:.6f} (>= 0.999)")
    if worst > 1e-3 or agree < 0.999:
        raise AssertionError(f"{label}: {what} disagree")


def phase_frustum_slice(label: str, model, inputs: dict,
                        fwd_kernels) -> None:
    """A Frustum model's eval forward on the kernel path against the plain
    path on the card and the plain path on the CPU (2 clouds), each
    replaying the kernel path's foreground draws (sampler_replay, with its
    flips logged); ms per batch, kernel and plain paths in turns."""
    from pvcnn_tpu_torch import kernels

    dev = torch.device(DEVICE)
    b, n = inputs["features"].shape[:2]
    model = model.eval().to(dev)
    x = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
    small = {k: torch.from_numpy(v[:2]) for k, v in inputs.items()}
    rec, rec_small, flips, flips_small = [], [], [], []
    with torch.inference_mode():
        kernels.reset_launch_counts()
        with sampler_record(rec):
            out = model(x)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        with plain_on_card(), sampler_replay(rec, flips):
            plain = model(x)
        with sampler_record(rec_small):
            got_small = {k: v.cpu() for k, v in model(
                {k: v.to(dev) for k, v in small.items()}).items()}
        with sampler_replay(rec_small, flips_small):
            want_small = model.cpu()(small)
        model.to(dev)
    log("slice", f"{label}: launches in one forward: "
        f"{ {k: v for k, v in counts.items() if v} }; foreground masks "
        f"flipped on the plain path {flips}, on the CPU {flips_small}")
    _check_ran(counts, {k: 1 for k in fwd_kernels})
    _outputs_agree(label, "kernel vs plain path on the card", out, plain)
    _outputs_agree(label, "kernel path on the card vs plain path on the "
                   "CPU (2 clouds)", got_small, want_small)
    ms_k, ms_p = [], []
    with torch.inference_mode():
        for _ in range(3):                          # in turns: kernel, plain
            ms_k.append(time_ms(lambda: model(x), reps=5, warmup=1))
            with plain_on_card():
                ms_p.append(time_ms(lambda: model(x), reps=5, warmup=1))
    log("slice", f"{label} forward, {b} x {n}: kernel path "
        f"{np.median(ms_k):.3f} ms/batch, plain path {np.median(ms_p):.3f} "
        f"ms/batch (medians of {ms_k} / {ms_p})")


def phase_frustum_train(label: str, base, batches, per_step: dict,
                        profile: bool, traj_rtol: float = 1e-3):
    """phase_train for a Frustum model (FrustumPointNetLoss, dict batches):
    the plain path replays the kernel path's foreground draws of each step
    (sampler_replay), and the mask entries its own logits would have
    flipped are logged a step. Returns the kernel path's step 1 (loss,
    gradients, recorded draws)."""
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.models.kitti import frustum as kitti

    b, n = batches[0][0]["features"].shape[:2]
    make = lambda: _trainer(base, 0.0, kitti.criterion())
    kern, plain = make(), make()
    rec, rec2, flips = [], [], []
    with sampler_record(rec):
        loss_k, grads_k = grads_of(kern, *batches[0], SEED)
    with sampler_record(rec2):
        loss_k2, grads_k2 = grads_of(kern, *batches[0], SEED)
    if loss_k != loss_k2 or not torch.equal(grads_k, grads_k2) or not all(
            torch.equal(a[1], b_[1]) for a, b_ in zip(rec, rec2)):
        raise AssertionError("two kernel-path runs of step 1 differ")
    log("train", f"{label}: step-1 loss, gradients and foreground draws of "
        "two kernel-path runs are bitwise equal")
    with plain_on_card(), sampler_replay(rec, flips):
        loss_p, grads_p = grads_of(plain, *batches[0], SEED)
    log("train", f"{label} step 1: foreground masks the plain path would "
        f"have flipped: {flips}")
    phase_same_function(label, (loss_p, grads_p), (loss_k, grads_k),
                        "the kernel path", "the plain path")

    kern, plain, again = make(), make(), make()
    losses_k, losses_p, losses_p2, step_flips = [], [], [], []
    for i, (x, y) in enumerate(batches):
        rec, flips = [], []
        kernels.reset_launch_counts()
        with sampler_record(rec):
            losses_k.append(kern.train_step(x, y).item())
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        if counts != per_step:
            raise AssertionError(f"step {i + 1} launches {counts}, expected "
                                 f"{per_step}")
        with plain_on_card():
            with sampler_replay(rec, flips):
                losses_p.append(plain.train_step(x, y).item())
            # the plain path's own run-to-run spread (float atomics)
            with sampler_replay(rec, []):
                losses_p2.append(again.train_step(x, y).item())
        step_flips.append(flips)
    del again
    log("train", f"{label}: launches per step: {counts}; foreground masks "
        f"the plain path would have flipped a step: {step_flips}")
    rel = [abs(a - b_) / abs(b_) for a, b_ in zip(losses_k, losses_p)]
    own = [abs(a - b_) / abs(b_) for a, b_ in zip(losses_p2, losses_p)]
    log("train", f"{label}: losses kernel {losses_k} plain {losses_p}: "
        f"relative differences {['%.2e' % r for r in rel]} (step 1 <= 1e-5, "
        f"steps 2-3 <= {traj_rtol:g}); plain against a second plain run "
        f"{['%.2e' % r for r in own]}")
    if not all(np.isfinite(losses_k)) or rel[0] > 1e-5 \
            or max(rel[1:]) > traj_rtol:
        raise AssertionError("training losses disagree")

    _time_steps(label, kern, plain, *batches[0], b, n)
    if profile:
        _profile_steps(label, kern, *batches[0])
    return loss_k, grads_k, rec2


def phase_frustum_switched(label: str, base, batch, ref, env: dict,
                           per_step: dict, what: str,
                           profile: bool = False) -> dict:
    """One Frustum training step with the environment variables of `env`
    set: its step 1, replaying the default kernel path's draws, against
    that path's (`ref`: loss, gradients, draws; phase_same_function), its
    launches from zeroed counters exactly per_step's, its ms/step against
    the default step's (medians of 3 rounds of 5, in turns) and peak
    memory (with profile, its torch.profiler breakdown too). Returns its
    launches."""
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.models.kitti import frustum as kitti

    x, y = batch
    loss_ref, grads_ref, rec = ref
    flips = []
    with environ(env):
        trainer = _trainer(base, 0.0, kitti.criterion())
        with sampler_replay(rec, flips):
            got = grads_of(trainer, x, y, SEED)
        log("train", f"{label}, {what}: foreground masks flipped against "
            f"the default step: {flips}")
        phase_same_function(label, (loss_ref, grads_ref), got, what,
                            "the default")
        kernels.reset_launch_counts()
        trainer.train_step(x, y)
        counts = kernels.launch_counts()
        ran = {k: v for k, v in counts.items() if v}
        if ran != per_step:
            raise AssertionError(f"{what}: launches {ran}, expected "
                                 f"{per_step}")
    default = _trainer(base, 0.0, kitti.criterion())
    ms, ms_default = [], []
    for _ in range(3):                               # in turns
        ms_default.append(time_ms(lambda: default.train_step(x, y), reps=5,
                                  warmup=1))
        with environ(env):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms.append(time_ms(lambda: trainer.train_step(x, y), reps=5,
                              warmup=1))
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
    log("train", f"{label}, {what}: {np.median(ms):.3f} ms/step against "
        f"the default step's {np.median(ms_default):.3f} (medians of {ms} "
        f"/ {ms_default}, in turns), peak memory {mem:.3f} GiB, launches "
        f"per step {ran}")
    if profile:
        with environ(env):
            _profile_steps(f"{label}, {what}", trainer, x, y)
    return counts


def phase_frustum_trainer(name: str, per_step: dict) -> dict:
    """A Frustum main path from zeroed counters, with the model's recipe
    (models/kitti/frustum MODELS: its batch size, Adam lr 1e-3, its
    schedule): Trainer.train_epoch over 4 batches of synthetic frustum
    items through the DataLoader, Trainer.evaluate over one more with the
    configs' four MeterFrustumKitti meters (the sampler draws there too),
    then a checkpoint round trip."""
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.data.kitti.frustum import synthetic_batch
    from pvcnn_tpu_torch.data.loader import DataLoader
    from pvcnn_tpu_torch.models.kitti import frustum as kitti
    from pvcnn_tpu_torch.train.kitti import meters
    from pvcnn_tpu_torch.train.optim import Adam
    from pvcnn_tpu_torch.train.trainer import (Trainer, load_checkpoint,
                                               save_checkpoint)
    from pvcnn_tpu_torch.utils.weights import init_random_

    spec = kitti.MODELS[name]
    b = spec.batch_size
    x, y = synthetic_batch(np.random.RandomState(SEED + 62), 5 * b, NF)
    items = [({k: v[i] for k, v in x.items()},
              {k: v[i] for k, v in y.items()}) for i in range(5 * b)]
    model = init_random_(spec.build(1.0), SEED)
    optimizer = Adam(model.parameters(), lr=kitti.LR)
    scheduler = spec.scheduler(kitti.EPOCHS).bind(kitti.LR)
    trainer = Trainer(model, kitti.criterion(), optimizer, DEVICE, SEED)
    kernels.reset_launch_counts()
    start = time.perf_counter()
    loss = trainer.train_epoch(DataLoader(items[:4 * b], b, shuffle=True,
                                          seed=SEED), 0, scheduler)
    scores = trainer.evaluate(DataLoader(items[4 * b:], b), meters("val"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = kernels.launch_counts()
    with tempfile.TemporaryDirectory(dir=_scratch_dir()) as root:
        path = os.path.join(root, "latest.pth.tar")
        save_checkpoint(path, 0, model, optimizer, scores)
        again = spec.build(1.0)
        epoch, saved = load_checkpoint(path, again)
    same = all(torch.equal(a.cpu(), b_) for a, b_ in zip(
        model.state_dict().values(), again.state_dict().values()))
    log("trainer", f"Frustum {name}: {4 * b} synthetic frustums, 1 epoch "
        f"of 4 steps at batch {b} (lr {scheduler(0):g}) + {b} evaluated: "
        f"{seconds:.2f} s, mean loss {loss:.4f}, {scores} (random "
        f"weights), launches {counts}; checkpoint round trip: epoch {epoch},"
        f" meters {saved}, state_dict equal {same}")
    if not np.isfinite(loss) or len(scores) != 4 \
            or not all(0.0 <= v <= 1.0 for v in scores.values()):
        raise AssertionError(f"bad Frustum {name} trainer result")
    if not same or epoch != 0 or saved != scores:
        raise AssertionError(f"Frustum {name} checkpoint does not "
                             "round-trip")
    _check_ran(counts, per_step)
    return counts


def _dml_trainer(teacher, student):
    """A DMLTrainer (Adam lr 1e-3 for both peers, KLLoss, seeded dropout)
    on copies of the two peers."""
    from pvcnn_tpu_torch.nn.loss import CrossEntropyLoss, KLLoss
    from pvcnn_tpu_torch.train.optim import Adam
    from pvcnn_tpu_torch.train.trainer import DMLTrainer

    t, s = copy.deepcopy(teacher), copy.deepcopy(student)
    return DMLTrainer(t, CrossEntropyLoss(), Adam(t.parameters(), lr=1e-3),
                      s, Adam(s.parameters(), lr=1e-3), KLLoss(),
                      torch.device(DEVICE), SEED)


def dml_grads_of(trainer, x, y, seed):
    """Both peers' step-1 losses and gradients, without the update."""
    from pvcnn_tpu_torch.train.trainer import STUDENT_SEED_OFFSET

    trainer.generator.manual_seed(seed)
    trainer.student.generator.manual_seed(seed + STUDENT_SEED_OFFSET)
    trainer.optimizer.zero_grad(set_to_none=True)
    trainer.student.optimizer.zero_grad(set_to_none=True)
    loss_t, loss_s = trainer.losses(x, y)
    (loss_t + loss_s).backward()
    return ((loss_t.item(), _flat_grads(trainer.model).clone()),
            (loss_s.item(), _flat_grads(trainer.student.model).clone()))


def phase_dml_train(label: str, teacher, student, batches,
                    per_step: dict, profile: bool) -> None:
    """Deep mutual learning steps (DMLTrainer: two peers, one forward
    each, each loss CE + KL to the detached peer) on the kernel path and
    on the plain path from the same two sets of weights, held to phase 6's
    criteria for both peers: two kernel-path runs of step 1 bitwise equal;
    step 1 against the plain path (loss, flipped gradients, rel-L2; the
    same bounds as phase_train); steps 2-3 within 1e-3; launches per step
    from zeroed counters exactly twice the single model's; ms/step against
    one single-model step of the teacher, in turns, and peak memory (with
    profile, a torch.profiler breakdown of 3 DML steps)."""
    from pvcnn_tpu_torch import kernels

    b, n = batches[0][0].shape[:2]
    make = lambda: _dml_trainer(teacher, student)
    kern = make()
    first = dml_grads_of(kern, *batches[0], SEED)
    again = dml_grads_of(kern, *batches[0], SEED)
    if any(a[0] != b_[0] or not torch.equal(a[1], b_[1])
           for a, b_ in zip(first, again)):
        raise AssertionError("two kernel-path DML runs of step 1 differ")
    log("dml train", f"{label}: both peers' step-1 losses and gradients of "
        "two kernel-path runs are bitwise equal")
    with plain_on_card():
        plain = dml_grads_of(make(), *batches[0], SEED)
    for peer, (loss_k, grads_k), (loss_p, grads_p) in zip(
            ("teacher", "student"), first, plain):
        rel_loss = abs(loss_k - loss_p) / abs(loss_p)
        g, w = grads_k.double(), grads_p.double()
        flipped = ((g - w).abs() > 5e-3 * w.abs().max()).double().mean()
        rel_l2 = ((g - w).norm() / w.norm()).item()
        log("dml train", f"{label} step 1, {peer}: loss kernel "
            f"{loss_k:.7f} plain {loss_p:.7f} (rel {rel_loss:.2e} <= 1e-5); "
            f"gradients flipped fraction {flipped.item():.2e} (< 2e-3), "
            f"rel-L2 {rel_l2:.2e} (< 5e-2)")
        if rel_loss > 1e-5 or flipped.item() >= 2e-3 or rel_l2 >= 5e-2:
            raise AssertionError(f"DML step 1 ({peer}): kernel path "
                                 "disagrees with the plain path")

    kern, plain = make(), make()
    steps_k, steps_p = [], []
    want = {k: 2 * v for k, v in per_step.items()}
    for i, (x, y) in enumerate(batches):
        kernels.reset_launch_counts()
        steps_k.append({k: v.item() for k, v in kern.train_step(x, y).items()})
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        if counts != want:
            raise AssertionError(f"DML step {i + 1} launches {counts}, "
                                 f"expected {want}")
        with plain_on_card():
            steps_p.append({k: v.item()
                            for k, v in plain.train_step(x, y).items()})
    log("dml train", f"{label}: launches per DML step: {counts} (twice the "
        "single model's)")
    for tag in sorted(steps_k[0]):
        lk = [s[tag] for s in steps_k]
        lp = [s[tag] for s in steps_p]
        rel = [abs(a - b_) / abs(b_) for a, b_ in zip(lk, lp)]
        log("dml train", f"{label} {tag}: kernel {lk} plain {lp}: relative "
            f"differences {['%.2e' % r for r in rel]} (step 1 <= 1e-5, "
            "steps 2-3 <= 1e-3)")
        if not all(np.isfinite(lk)) or rel[0] > 1e-5 or max(rel[1:]) > 1e-3:
            raise AssertionError(f"DML losses disagree ({tag})")

    x, y = batches[0]
    single = _trainer(teacher, 0.0)
    ms_dml, ms_one, mem = [], [], {}
    for _ in range(3):                               # in turns
        for name, trainer, out in (("dml", kern, ms_dml),
                                   ("single", single, ms_one)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out.append(time_ms(lambda: trainer.train_step(x, y), reps=5,
                               warmup=1))
            mem[name] = torch.cuda.max_memory_allocated() / 2 ** 30
    with plain_on_card():
        ms_plain = time_ms(lambda: plain.train_step(x, y), reps=3, warmup=1)
    log("dml train", f"{label} DML step, {b} x {n}, fp32: kernel path "
        f"{np.median(ms_dml):.3f} ms/step against one single-model step's "
        f"{np.median(ms_one):.3f} (x{np.median(ms_dml) / np.median(ms_one):.3f}"
        f"; medians of {ms_dml} / {ms_one}, in turns), plain path "
        f"{ms_plain:.3f} ms/step; peak memory DML {mem['dml']:.3f} GiB, "
        f"single {mem['single']:.3f} GiB")
    if profile:
        _profile_steps(f"{label} DML", kern, x, y)


def phase_dml_trainer(per_step: dict) -> dict:
    """The DML entry point (train.dml) for ShapeNet PVCNN 1x from zeroed
    counters: one epoch of 4 steps at batch 32 with an iter schedule on a
    synthetic tree of 64 shapes, the test split scored for both peers,
    both peers' checkpoints, then a resumed run that loads both: the DML
    main path. Each kernel of per_step must launch."""
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.data.shapenet import write_synthetic
    from pvcnn_tpu_torch.train.dml import train

    rng = np.random.RandomState(SEED + 4)
    items = [(int(s), int(n)) for s, n in zip(rng.randint(0, 16, 64),
                                              rng.randint(2000, 3000, 64))]
    with tempfile.TemporaryDirectory(dir=_scratch_dir()) as root:
        write_synthetic(root, items, seed=SEED)
        save = os.path.join(root, "run")
        kernels.reset_launch_counts()
        start = time.perf_counter()
        teacher, student = train(root, width_multiplier=1.0, batch_size=32,
                                 epochs=1, max_steps=4, save_path=save,
                                 device=DEVICE, seed=SEED,
                                 scheduler_unit="iter")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = kernels.launch_counts()
        names = ("latest.pth.tar", "latest.pth.tar.student",
                 "latest/e0.pth.tar", "best.pth.tar", "best_student.pth.tar")
        missing = [n for n in names
                   if not os.path.exists(os.path.join(save, n))]
        if missing:
            raise AssertionError(f"DML trainer wrote no {missing}")
        again = train(root, width_multiplier=1.0, batch_size=32, epochs=1,
                      save_path=save, device=DEVICE, seed=SEED)
    scores = [m["acc/iou_test"] for m in (teacher, student)]
    log("dml trainer", f"pvcnn: 64 synthetic shapes, 1 epoch of 4 DML steps "
        f"at batch 32 (iter schedule) + test split for both peers: "
        f"{seconds:.2f} s, acc/iou_test teacher {scores[0]:.4f} student "
        f"{scores[1]:.4f} (random labels), checkpoints {list(names)}, "
        f"launches {counts}")
    resumed = [m["acc/iou_test"] for m in again]
    log("dml trainer", f"pvcnn: resumed run re-evaluated both peers: "
        f"{resumed}")
    if not all(0.0 <= v <= 1.0 for v in scores + resumed) \
            or teacher["acc/iou_test"] != teacher["acc/iou_test_best"]:
        raise AssertionError("bad DML trainer result")
    _check_ran(counts, per_step)
    return counts


def _add_counts(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more.get(k, 0) for k in {*total, *more}}


def phase_kitti(name: str, root: str, paths: dict, per_step: dict,
                fwd_kernels) -> dict:
    """One Frustum model's train and evaluation entry points at the
    configs' full width on the synthetic tree at `root`: train.kitti for
    one epoch of 4 steps (its batch size, 1,024 points a frustum) with the
    four meters and its checkpoints, from zeroed counters (each kernel of
    per_step must launch); then the evaluator (evaluate.kitti.frustum) on
    the rgb-detection split from that run's best checkpoint, num_tests 2,
    from zeroed counters: exactly fwd_kernels launch, every AP is finite
    and in [0, 100], and every image id has a label file in each test's
    folder. Logs the forward's frustums/s and the evaluator's seconds
    split into data, forward (to the outputs on the host) and the host's
    AP. Returns the launches of both runs."""
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.evaluate.kitti.frustum.eval import evaluate
    from pvcnn_tpu_torch.train.kitti import METRICS, train

    save = os.path.join(root, f"run.{name}")
    kernels.reset_launch_counts()
    start = time.perf_counter()
    scores = train(root, model=name, epochs=1, max_steps=4, save_path=save,
                   device=DEVICE, seed=SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = kernels.launch_counts()
    checkpoints = ["latest.pth.tar", "latest/e0.pth.tar", "best.pth.tar"] + [
        os.path.join("best", "best.{}.pth.tar".format(m.replace("/", ".")))
        for m in METRICS]
    missing = [c for c in checkpoints
               if not os.path.exists(os.path.join(save, c))]
    log("kitti", f"{name}: train.kitti, 1 epoch of 4 steps + the val split: "
        f"{seconds:.2f} s, {scores} (random weights), launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if missing or len(scores) != 6 \
            or not all(0.0 <= v <= 1.0 for v in scores.values()):
        raise AssertionError(f"bad Frustum {name} training run: missing "
                             f"{missing}, meters {scores}")
    _check_ran(counts, per_step)

    timings = []
    kernels.reset_launch_counts()
    start = time.perf_counter()
    results = evaluate(root, model_name=name,
                       checkpoint=os.path.join(save, "best.pth.tar"),
                       num_tests=2, device=DEVICE, seed=SEED,
                       output=os.path.join(save, "best"), timings=timings,
                       **paths)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    ran = {k: v for k, v in kernels.launch_counts().items() if v}
    aps = np.array([r for v in results.values() for rs in v.values()
                    for r in rs])
    with open(paths["image_ids"]) as f:
        ids = [line.strip() for line in f]
    unwritten = [(t, i) for t in range(2) for i in ids
                 if not os.path.exists(os.path.join(
                     save, "best.predictions.t", f"best.predictions.t{t}",
                     f"{i}.txt"))]
    frustums = timings[0]["frustums"]
    log("kitti", f"{name}: evaluator, 2 tests of {frustums} rgb-detection "
        f"frustums: {seconds:.2f} s; per test "
        + "; ".join(f"forward {t['forward']:.3f} s "
                    f"({t['frustums'] / t['forward']:.1f} frustums/s), "
                    f"data {t['data']:.3f} s, host AP {t['ap']:.3f} s"
                    for t in timings)
        + f"; launches {ran}; 3-D AP (easy, moderate, hard) "
        + str({c: np.mean(v["3d"], 0).round(2).tolist()
               for c, v in results.items()}))
    if aps.shape != (3 * 3 * 2, 3) or not np.isfinite(aps).all() \
            or aps.min() < 0 or aps.max() > 100 or unwritten:
        raise AssertionError(f"bad Frustum {name} evaluation: AP {aps}, "
                             f"label files missing {unwritten[:5]}")
    if set(ran) != set(fwd_kernels):
        raise AssertionError(f"evaluator launches {ran}, expected the eval "
                             f"forward's {fwd_kernels}")
    return _add_counts(counts, kernels.launch_counts())


class _BoxOracle(torch.nn.Module):
    """Stands in for a Frustum model in the evaluator: it gives, batch by
    batch in the split's order (which the synthetic rgb-detection split
    shares with the val split), outputs that decode to the val split's own
    boxes: one-hot heading and size bins, their residuals and the center
    in the frustum frame. Every box it predicts is a true positive of the
    AP stack."""

    KEYS = ("center", "heading_scores", "heading_residuals", "size_scores",
            "size_residuals")

    def __init__(self, root: str):
        from pvcnn_tpu_torch.data.kitti import attributes
        from pvcnn_tpu_torch.data.kitti.frustum import FrustumKitti
        from pvcnn_tpu_torch.models.kitti import frustum as kitti

        super().__init__()
        nh, templates = (kitti.NUM_HEADING_ANGLE_BINS,
                         attributes.size_templates())
        val = FrustumKitti(root, 1, split="val", classes=kitti.CLASSES,
                           num_heading_angle_bins=nh,
                           frustum_rotate=True)["val"]
        targets = [val[i][1] for i in range(len(val))]
        col = lambda key: np.array([t[key] for t in targets])
        rows = np.arange(len(targets))
        heading_bin, size_bin = col("heading_bin_id"), col("size_template_id")
        outputs = {"center": col("center"),
                   "heading_scores": np.zeros((len(rows), nh)),
                   "heading_residuals": np.zeros((len(rows), nh)),
                   "size_scores": np.zeros((len(rows), len(templates))),
                   "size_residuals": np.zeros((len(rows), len(templates),
                                               3))}
        outputs["heading_scores"][rows, heading_bin] = 1.0
        outputs["heading_residuals"][rows, heading_bin] = col(
            "heading_residual")
        outputs["size_scores"][rows, size_bin] = 1.0
        outputs["size_residuals"][rows, size_bin] = col("size_residual")
        self.register_buffer("size_templates",
                             torch.from_numpy(templates).float())
        for key in self.KEYS:
            self.register_buffer(key, torch.from_numpy(outputs[key]).float())
        self.next = 0

    def forward(self, inputs: dict) -> dict:
        b = inputs["features"].shape[0]
        outputs = {k: getattr(self, k)[self.next:self.next + b]
                   for k in self.KEYS}
        self.next += b
        return outputs


def phase_kitti_ap(fwd_kernels) -> None:
    """The evaluator entry point at the size of the real val split: a
    synthetic tree of KITTI_VAL_IMAGES image ids with KITTI_PER_IMAGE
    frustums each, one test. First FrustumPVCNNE 1x with random weights,
    from zeroed counters: exactly fwd_kernels launch, every AP is finite
    and in [0, 100] (its BEV and 3-D APs are 0: with no true positive the
    AP stack skips its loops over score thresholds). Then _BoxOracle's
    perfect boxes through the same entry point (decode, label files, AP
    stack): every class's 3-D AP at each difficulty must be above 0, and
    its host AP is what the stack costs with true positives. Logs each
    run's seconds split into data, forward and the host's AP, and the
    forward's share of a test with either AP."""
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.data.kitti.frustum import write_synthetic_root
    from pvcnn_tpu_torch.evaluate.kitti.frustum.eval import evaluate
    from pvcnn_tpu_torch.models.kitti import frustum as kitti
    from pvcnn_tpu_torch.utils.weights import init_random_

    n = KITTI_VAL_IMAGES * KITTI_PER_IMAGE
    with tempfile.TemporaryDirectory(dir=_scratch_dir()) as root:
        start = time.perf_counter()
        paths = write_synthetic_root(root, np.random.RandomState(SEED + 81),
                                     n, KITTI_PER_IMAGE)
        log("kitti AP", f"synthetic tree of {n} frustums a split, "
            f"{KITTI_VAL_IMAGES} image ids: written in "
            f"{time.perf_counter() - start:.2f} s")
        spent = {}
        for label, make in (
                ("FrustumPVCNNE 1x", lambda: init_random_(
                    kitti.MODELS["pvcnne"].build(1.0), SEED)),
                ("perfect boxes", lambda: _BoxOracle(root))):
            model = make()
            timings = []
            kernels.reset_launch_counts()
            start = time.perf_counter()
            results = evaluate(root, model, num_tests=1, device=DEVICE,
                               seed=SEED, timings=timings,
                               output=os.path.join(root, label.split()[0]),
                               **paths)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            ran = {k: v for k, v in kernels.launch_counts().items() if v}
            t = spent[label] = timings[0]
            aps = np.array([r for v in results.values() for r in v.values()])
            ap_3d = {c: v["3d"].round(2).tolist() for c, v in results.items()}
            log("kitti AP", f"{label}: evaluator, 1 test of {t['frustums']} "
                f"rgb-detection frustums: {seconds:.2f} s; data "
                f"{t['data']:.3f} s, forward {t['forward']:.3f} s "
                f"({t['frustums'] / t['forward']:.1f} frustums/s), host AP "
                f"{t['ap']:.3f} s; launches {ran}; 3-D AP (easy, moderate, "
                f"hard) {ap_3d}")
            if aps.shape != (3 * 3, 3) or not np.isfinite(aps).all() \
                    or aps.min() < 0 or aps.max() > 100:
                raise AssertionError(f"bad {label} evaluation: AP {aps}")
            want = set(fwd_kernels) if label.startswith("Frustum") else set()
            if set(ran) != want:
                raise AssertionError(f"{label}: launches {ran}, expected "
                                     f"{sorted(want)}")
            if label == "perfect boxes" and min(
                    min(v) for v in ap_3d.values()) <= 0:
                raise AssertionError(f"perfect boxes score a 3-D AP of 0: "
                                     f"{ap_3d}")
            del model
    model_run, perfect = spent["FrustumPVCNNE 1x"], spent["perfect boxes"]
    for label, ap in (("its own (no true positive)", model_run["ap"]),
                      ("the perfect boxes'", perfect["ap"])):
        total = model_run["data"] + model_run["forward"] + ap
        log("kitti AP", f"FrustumPVCNNE 1x forward share of a test with "
            f"{label} AP: {model_run['forward'] / total:.3f} (data "
            f"{model_run['data'] / total:.3f}, host AP {ap / total:.3f})")


# the port's config tree, beside this script
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "pvcnn_tpu_torch", "configs")


def _counted(fn):
    """fn() from zeroed launch counters -> (its result, the launches,
    seconds to the card's last work)."""
    from pvcnn_tpu_torch import kernels

    kernels.reset_launch_counts()
    start = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, kernels.launch_counts(), time.perf_counter() - start


def _expected(counts: dict, per_step: dict, fwd_kernels, steps: int,
              forwards: int) -> dict:
    """Launches of `steps` training steps and `forwards` eval forwards
    (fwd_kernels' per-step counts a forward), for every kernel."""
    return {k: steps * per_step.get(k, 0)
            + forwards * (per_step.get(k, 0) if k in fwd_kernels else 0)
            for k in counts}


def _checkpoint_tensors(path: str) -> dict:
    """The model's and the optimizer's tensors of a checkpoint, by name,
    and its epoch under "epoch"."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    out = {f"model/{k}": v for k, v in ckpt["model"].items()}
    for i, state in ckpt["optimizer"]["state"].items():
        out.update({f"optimizer/{i}/{k}": v for k, v in state.items()
                    if isinstance(v, torch.Tensor)})
    out["epoch"] = torch.tensor(ckpt["epoch"])
    return out


def _scalars(save: str, prefix: str = "") -> list:
    """(tag, step, value) of the run's scalars whose tag starts with
    `prefix`, but the points/s timings."""
    with open(os.path.join(save, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [(r["tag"], r["step"], r["value"]) for r in rows
            if r["tag"].startswith(prefix)
            and not r["tag"].startswith("perf/")]


def _same_run(label: str, got: str, want: str, names, prefix: str = ""):
    """The config-driven run at `got` against the per-dataset entry point's
    at `want`: each named checkpoint's model and optimizer tensors bitwise
    equal, and the same scalars (those starting with `prefix`)."""
    differ = []
    for name in names:
        a, b = (_checkpoint_tensors(os.path.join(d, name))
                for d in (got, want))
        if a.keys() != b.keys():
            differ.append(f"{name}: keys")
            continue
        differ += [f"{name}: {k}" for k in a if not torch.equal(a[k], b[k])]
    scalars = _scalars(got, prefix)
    same = scalars == _scalars(want, prefix)
    log("configs", f"{label}: checkpoints {list(names)} bitwise equal to "
        f"the per-dataset entry point's: {not differ}; {len(scalars)} "
        f"scalars equal: {same}")
    if differ or not same or not scalars:
        raise AssertionError(f"{label}: the config-driven run differs from "
                             f"the per-dataset one: {differ[:5]}, scalars "
                             f"equal {same}")


def _check_launches(label: str, counts: dict, want: dict) -> None:
    log("configs", f"{label}: launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")


def phase_configs(s3dis_root: str, store, kitti_root: str,
                  kitti_paths: dict, fwd, fwd2) -> dict:
    """The config-driven entry points (train/cli.py, train/__main__.py,
    train_dml.py, evaluate/__main__.py, tools/parity.py) on the card at
    the configs' full width, each main path from zeroed counters: for
    ShapeNet PVCNN c1 (a synthetic tree of 64 shapes: 4 training
    batches), S3DIS PVCNN2 area5/c1 (20b's rooms, its WindowStore set on
    configs.dataset between prepare and run, 4 steps) and Frustum
    pvcnne (27's tree), prepare(<config> --devices 0 ...) and run for
    one epoch: launches exactly 4 x the path's per-step ones plus the
    scored split's forwards', checkpoints bitwise equal to the
    per-dataset entry point's run with the config's seed; then the
    evaluator from that run's best.pth.tar (2 votes, 1 vote, 1 test):
    exactly the eval forwards' launches, results finite and in range.
    Then train_dml for one epoch of ShapeNet PVCNN c1 (both peers
    against train.dml's), the parity tool's dry run of shapenet_pvcnn_c1
    on the card, and --devices 0,1, which must raise. -> each path's
    launches."""
    from pvcnn_tpu_torch.data.kitti.frustum import FrustumKitti
    from pvcnn_tpu_torch.data.s3dis import S3DIS
    from pvcnn_tpu_torch.data.shapenet import write_synthetic
    from pvcnn_tpu_torch.evaluate.__main__ import main as evaluate_main
    from pvcnn_tpu_torch.tools import parity
    from pvcnn_tpu_torch.train import dml, kitti, s3dis, shapenet
    from pvcnn_tpu_torch.train.cli import prepare, run
    from pvcnn_tpu_torch.train_dml import main as train_dml_main

    totals = {}
    # ShapeNet PVCNN c1: train, evaluate, train_dml
    config = os.path.join(CONFIGS, "shapenet", "pvcnn", "c1.py")
    rng = np.random.RandomState(SEED + 3)
    items = [(int(s), int(n)) for s, n in zip(rng.randint(0, 16, 64),
                                              rng.randint(2000, 3000, 64))]
    with tempfile.TemporaryDirectory(dir=_scratch_dir()) as root:
        write_synthetic(root, items, seed=SEED)
        args = [config, "--devices", "0", f"--configs.dataset.root={root}",
                "--configs.train.num_epochs=1"]
        save = f"--configs.train.save_path={root}/cli"
        configs = prepare(args + [save])
        seed = configs.seed
        shapenet.train(root, epochs=1, save_path=f"{root}/ref",
                       device=DEVICE, seed=seed)
        meters, counts, seconds = _counted(lambda: run(configs))
        log("configs", f"shapenet pvcnn c1: prepare + run, 1 epoch of 4 "
            f"steps at batch 32 + 64 test shapes (seed {seed}): "
            f"{seconds:.2f} s, {meters}")
        _check_launches("shapenet train", counts,
                        _expected(counts, PER_STEP, fwd, 4, 2))
        _same_run("shapenet pvcnn c1", f"{root}/cli", f"{root}/ref",
                  ("latest.pth.tar", "best.pth.tar"))
        totals["ShapeNet PVCNN 1x"] = counts

        stats, ran, seconds = _counted(lambda: evaluate_main(
            args + [save, "--configs.evaluate.num_votes=2"]))
        forwards = sum(-(-2 * -(-n // N) // B) for _, n in items)
        iou = float(stats[:, 0].sum() / max(stats[:, 1].sum(), 1))
        log("configs", f"shapenet pvcnn c1: python -m "
            f"pvcnn_tpu_torch.evaluate (2 votes, batch 32): {seconds:.2f} "
            f"s, mIoU {iou:.4f} over {stats[:, 1].sum():.0f} shapes in "
            f"{forwards} forwards")
        if stats.shape != (16, 2) or not np.isfinite(stats).all() \
                or stats[:, 1].sum() != len(items) or not 0 <= iou <= 1:
            raise AssertionError(f"bad evaluation stats {stats}")
        _check_launches("shapenet evaluate", ran,
                        _expected(ran, PER_STEP, fwd, 0, forwards))
        totals["ShapeNet PVCNN 1x"] = _add_counts(totals["ShapeNet PVCNN 1x"],
                                                  ran)

        dml.train(root, epochs=1, save_path=f"{root}/ref_dml",
                  device=DEVICE, seed=seed)
        (teacher, student), counts, seconds = _counted(
            lambda: train_dml_main(
                args + [f"--configs.train.save_path={root}/dml"]))
        log("configs", f"shapenet pvcnn c1: train_dml, 1 epoch of 4 DML "
            f"steps + the test split for both peers: {seconds:.2f} s, "
            f"acc/iou_test teacher {teacher['acc/iou_test']:.4f}, student "
            f"{student['acc/iou_test']:.4f}")
        _check_launches("shapenet train_dml", counts,
                        _expected(counts, PER_STEP, fwd, 8, 4))
        _same_run("shapenet pvcnn c1 train_dml", f"{root}/dml",
                  f"{root}/ref_dml",
                  ("latest.pth.tar", "latest.pth.tar.student"))
        totals["ShapeNet PVCNN 1x"] = _add_counts(totals["ShapeNet PVCNN 1x"],
                                                  counts)

    start = time.perf_counter()
    got = parity.main(["shapenet_pvcnn_c1", "--dry-run", "--devices", "0"])
    log("configs", f"parity dry run shapenet_pvcnn_c1 on the card: "
        f"{time.perf_counter() - start:.2f} s, mIoU {got:.2f} (synthetic)")
    if not 0.0 <= got <= 100.0:
        raise AssertionError(f"parity dry run gave {got}")
    try:
        prepare([config, "--devices", "0,1"])
    except ValueError as e:
        log("configs", f"--devices 0,1 refused: {e}")
    else:
        raise AssertionError("--devices 0,1 was not refused")

    # S3DIS PVCNN2 area5/c1 over 20b's store
    config = os.path.join(CONFIGS, "s3dis", "pvcnn2", "area5", "c1.py")
    args = [config, "--devices", "0", f"--configs.dataset.root={s3dis_root}",
            "--configs.train.num_epochs=1", "--configs.train.max_steps=4"]
    save = f"--configs.train.save_path={s3dis_root}/cli.pvcnn2"
    configs = prepare(args + [save])
    configs.dataset.opener = store
    seed = configs.seed
    s3dis.train(s3dis_root, model="pvcnn2", epochs=1, max_steps=4,
                save_path=f"{s3dis_root}/ref.pvcnn2", device=DEVICE,
                seed=seed, opener=store)
    meters, counts, seconds = _counted(lambda: run(configs))
    test = S3DIS(s3dis_root, N2, split="test", opener=store)["test"]
    log("configs", f"s3dis pvcnn2 area5/c1: prepare, the store, run: 1 "
        f"epoch of 4 steps at batch 32 + {len(test)} test windows: "
        f"{seconds:.2f} s, {meters}")
    _check_launches("s3dis train", counts, _expected(
        counts, PER_STEP2, fwd2, 4, -(-len(test) // B)))
    # the test split's draws follow the prefetch thread's early stop: the
    # losses and checkpoints are compared, not the meters
    _same_run("s3dis pvcnn2 area5/c1", f"{s3dis_root}/cli.pvcnn2",
              f"{s3dis_root}/ref.pvcnn2", ("latest.pth.tar",), "loss/")
    totals["S3DIS PVCNN2 1x"] = counts

    configs = prepare(args + [save, "--evaluate"])
    configs.dataset.opener = store
    stats, ran, seconds = _counted(lambda: configs.evaluate.fn(configs))
    forwards = sum(-(-store[f]["data"].shape[0] // 10)
                   for files in test.scene_list.values() for f in files)
    log("configs", f"s3dis pvcnn2 area5/c1: the evaluator (1 vote, 10 "
        f"windows a forward): {seconds:.2f} s, mIoU {_miou(stats):.4f} in "
        f"{forwards} forwards")
    if stats.shape != (3, 13, 2) or not np.isfinite(stats).all() \
            or stats[1].sum() == 0 or not 0 <= _miou(stats) <= 1:
        raise AssertionError(f"bad S3DIS evaluation stats {stats}")
    _check_launches("s3dis evaluate", ran,
                    _expected(ran, PER_STEP2, fwd2, 0, forwards))
    totals["S3DIS PVCNN2 1x"] = _add_counts(totals["S3DIS PVCNN2 1x"], ran)

    # Frustum pvcnne over 27's tree
    config = os.path.join(CONFIGS, "kitti", "frustum", "pvcnne.py")
    args = [config, "--devices", "0", f"--configs.dataset.root={kitti_root}",
            "--configs.train.num_epochs=1",
            f"--configs.train.save_path={kitti_root}/cli.pvcnne"]
    configs = prepare(args)
    seed = configs.seed
    kitti.train(kitti_root, epochs=1, save_path=f"{kitti_root}/ref.pvcnne",
                device=DEVICE, seed=seed)
    meters, counts, seconds = _counted(lambda: run(configs))
    log("configs", f"kitti frustum pvcnne: prepare + run, 1 epoch of 4 "
        f"steps at batch 32 + {NUM_KITTI} val frustums: {seconds:.2f} s, "
        f"{meters}")
    _check_launches("kitti train", counts, _expected(
        counts, PER_STEP_PVCNNE, fwd, 4, -(-NUM_KITTI // B)))
    _same_run("kitti frustum pvcnne", f"{kitti_root}/cli.pvcnne",
              f"{kitti_root}/ref.pvcnne", ("latest.pth.tar", "best.pth.tar"))
    totals["KITTI FrustumPVCNNE 1x"] = counts

    frustums = len(FrustumKitti(kitti_root, NF, split="val",
                                from_rgb_detection=True)["val"])
    results, ran, seconds = _counted(lambda: evaluate_main(args + [
        "--configs.evaluate.num_tests=1",
        f"--configs.evaluate.ground_truth_path={kitti_paths['ground_truth']}",
        f"--configs.evaluate.image_id_file_path={kitti_paths['image_ids']}"]))
    aps = np.array([r for v in results.values() for r in v.values()])
    log("configs", f"kitti frustum pvcnne: python -m "
        f"pvcnn_tpu_torch.evaluate (1 test of {frustums} rgb-detection "
        f"frustums): {seconds:.2f} s, 3-D AP "
        + str({c: np.round(v["3d"], 2).tolist() for c, v in results.items()}))
    if aps.shape != (9, 3) or not np.isfinite(aps).all() or aps.min() < 0 \
            or aps.max() > 100:
        raise AssertionError(f"bad Frustum evaluation: AP {aps}")
    _check_launches("kitti evaluate", ran, _expected(
        ran, PER_STEP_PVCNNE, fwd, 0, -(-frustums // B)))
    totals["KITTI FrustumPVCNNE 1x"] = _add_counts(
        totals["KITTI FrustumPVCNNE 1x"], ran)
    return totals


def _stopwatch():
    """lap(phase) logs the seconds since the previous lap (or the start)."""
    last = [time.perf_counter()]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        log(phase, f"took {now - last[0]:.1f} s")
        last[0] = now
    return lap


def main() -> None:
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.data.kitti.frustum import (synthetic_batch,
                                                    write_synthetic_root)
    from pvcnn_tpu_torch.models.kitti import frustum as kitti
    from pvcnn_tpu_torch.models.s3dis import PVCNN as S3DISPVCNN
    from pvcnn_tpu_torch.models.s3dis import PVCNN2
    from pvcnn_tpu_torch.models.s3dis import PointNet as S3DISPointNet
    from pvcnn_tpu_torch.models.shapenet import (PVCNN, PointNet,
                                                 pointnet2_msg, pointnet2_ssg)
    from pvcnn_tpu_torch.train.trainer import STUDENT_SEED_OFFSET
    from pvcnn_tpu_torch.utils.weights import init_random_

    profile = "--profile" in sys.argv[1:]
    lap = _stopwatch()
    device_name = phase_device()
    check_calls()
    phase_build()
    lap("build")
    dev = torch.device(DEVICE)

    rec = {"ShapeNet PVCNN 1x": phase_kernels()}
    lap("kernels")
    fwd = ("avg_voxelize", "trilinear_devoxelize", "conv3d_fwd")
    phase_slice("PVCNN 1x", init_random_(PVCNN(50, 16, 3), SEED),
                cloud(np.random.RandomState(SEED + 1), B, N), fwd)
    lap("slice")
    phase_evaluator()
    lap("evaluator")
    rng = np.random.RandomState(SEED + 2)
    batches = [(torch.from_numpy(cloud(rng, B, N)).to(dev),
                torch.from_numpy(rng.randint(0, 50, (B, N))).to(dev))
               for _ in range(3)]
    phase_train("PVCNN 1x", init_random_(PVCNN(50, 16, 3), SEED), batches,
                PER_STEP, profile)
    lap("train")
    counts = {"ShapeNet PVCNN 1x": phase_trainer()}
    lap("trainer")

    rec["S3DIS PVCNN2 1x"] = phase_pvcnn2_kernels()
    lap("pvcnn2 kernels")
    fwd2 = fwd + ("fps", "ball_query", "three_nn")
    phase_slice("PVCNN2 1x", init_random_(PVCNN2(13, 6), SEED),
                windows(np.random.RandomState(SEED + 11), B, N2)[0], fwd2)
    lap("pvcnn2 slice")
    rng = np.random.RandomState(SEED + 12)
    batches = [tuple(torch.from_numpy(a).to(dev) for a in windows(rng, B, N2))
               for _ in range(3)]
    # PVCNN2's plain path differs from itself by more than 1e-3 at step 3
    # in some runs (the phase logs that spread; its step-1 gradients sit
    # 1.3e-2 from the kernel path's, against 5e-3 for ShapeNet): hold its
    # steps 2-3 to 5e-3
    phase_train("PVCNN2 1x", init_random_(PVCNN2(13, 6), SEED), batches,
                PER_STEP2, profile, weight_decay=1e-5, traj_rtol=5e-3)
    lap("pvcnn2 train")
    counts["S3DIS PVCNN2 1x"] = phase_s3dis_trainer(
        "PVCNN2", lambda: PVCNN2(13, 6), N2, PER_STEP2)
    lap("pvcnn2 trainer")

    rec["S3DIS PVCNN 1x"], rec["S3DIS PVCNN 1x opt-in"] = \
        phase_pvcnn_s3dis_kernels()
    lap("pvcnn kernels")
    phase_slice("S3DIS PVCNN 1x", init_random_(S3DISPVCNN(13, 6), SEED),
                windows(np.random.RandomState(SEED + 21), B, N3)[0], fwd)
    lap("pvcnn slice")
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
    lap("pvcnn train")
    counts["S3DIS PVCNN 1x"] = phase_s3dis_trainer(
        "S3DIS PVCNN", lambda: S3DISPVCNN(13, 6), N3, PER_STEP3)
    with switches():
        counts["S3DIS PVCNN 1x opt-in"] = phase_s3dis_trainer(
            "S3DIS PVCNN, switches on", lambda: S3DISPVCNN(13, 6), N3,
            PER_STEP3_ON)
    lap("pvcnn trainer")

    ssg, msg = "ShapeNet PointNet2 SSG 1x", "ShapeNet PointNet2 MSG 1x"
    rec[ssg], rec[msg], rec[msg + " opt-in"] = phase_pointnet2_kernels()
    lap("pointnet2 kernels")
    fwd_pn2 = ("fps", "ball_query", "three_nn")
    x = cloud(np.random.RandomState(SEED + 41), B, N)
    phase_slice("PointNet2 MSG 1x", init_random_(pointnet2_msg(50, 16),
                                                 SEED), x, fwd_pn2)
    phase_slice("PointNet2 SSG 1x", init_random_(pointnet2_ssg(50, 16),
                                                 SEED), x[..., :6], fwd_pn2)
    lap("pointnet2 slice")
    rng = np.random.RandomState(SEED + 42)
    batches = [(torch.from_numpy(cloud(rng, B, N)).to(dev),
                torch.from_numpy(rng.randint(0, 50, (B, N))).to(dev))
               for _ in range(3)]
    base = init_random_(pointnet2_msg(50, 16), SEED)
    off = phase_train("PointNet2 MSG 1x", base, batches, PER_STEP_MSG,
                      profile)
    fused = phase_switched_step(
        "PointNet2 MSG 1x", base, batches[0], off,
        frozenset({"PVCNN_TPU_DENSE_BN_FUSED"}), PER_STEP_MSG_ON,
        profile=profile)
    counts[msg + " opt-in"] = {k: (v if k in _FUSED_MSG else 0)
                               for k, v in fused.items()}
    del base
    phase_train("PointNet2 SSG 1x", init_random_(pointnet2_ssg(50, 16), SEED),
                [(x[..., :6].contiguous(), y) for x, y in batches],
                PER_STEP_SSG, profile)
    lap("pointnet2 train")
    counts[msg] = phase_trainer("pointnet2msg", PER_STEP_MSG)
    counts[ssg] = phase_trainer("pointnet2ssg", PER_STEP_SSG)
    phase_evaluator("pointnet2ssg", fwd_pn2)
    lap("pointnet2 trainer")

    x = cloud(np.random.RandomState(SEED + 50), B, N)
    y = np.random.RandomState(SEED + 51).randint(0, 50, (B, N))
    phase_pointnet("ShapeNet PointNet 1x with T-Nets", init_random_(
        PointNet(50, 16, with_transformer=True), SEED),
        (torch.from_numpy(np.ascontiguousarray(x[..., XYZ_ONE_HOT])).to(dev),
         torch.from_numpy(y).to(dev)), PER_STEP_POINTNET_ON)
    phase_trainer("pointnet", {})
    phase_pointnet("S3DIS PointNet 1x", init_random_(S3DISPointNet(13, 6),
                                                     SEED),
                   tuple(torch.from_numpy(a).to(dev) for a in windows(
                       np.random.RandomState(SEED + 52), B, N3)),
                   PER_STEP_S3DIS_POINTNET_ON, weight_decay=1e-5)
    phase_s3dis_trainer("S3DIS PointNet", lambda: S3DISPointNet(13, 6), N3,
                        {})
    lap("pointnet")
    # 20b's rooms stay for the configs phase
    s3dis_dir = tempfile.TemporaryDirectory(dir=_scratch_dir())
    root = s3dis_dir.name
    store, covered = s3dis_rooms(root, SEED + 90)
    lap("s3dis rooms")
    serial = {}
    for m, path, per_step, fwd_kernels in (
            ("pvcnn2", "S3DIS PVCNN2 1x", PER_STEP2, fwd2),
            ("pvcnn", "S3DIS PVCNN 1x", PER_STEP3, fwd),
            ("pointnet", None, {}, ())):
        more = phase_s3dis_pipeline(m, root, store, covered, per_step,
                                    fwd_kernels, plain=path is not None,
                                    serial=serial)
        if path is not None:
            counts[path] = _add_counts(counts[path], more)
    lap("s3dis pipeline")
    for m, per_step in (("pvcnn2", PER_STEP2), ("pvcnn", PER_STEP3),
                        ("pointnet", {})):
        phase_host_loader(m, root, store, per_step, serial[m])
    phase_host_votes(root, store)
    lap("host s3dis")
    phase_host_shapenet(PER_STEP)
    lap("host shapenet")

    pvcnne, pvcnne_on, fpn2 = ("KITTI FrustumPVCNNE 1x",
                               "KITTI FrustumPVCNNE 1x opt-in",
                               "KITTI FrustumPointNet2 1x")
    rec[pvcnne], rec[pvcnne_on], rec[fpn2] = phase_frustum_kernels()
    lap("frustum kernels")
    models = {m: init_random_(kitti.MODELS[m].build(1.0), SEED)
              for m in kitti.MODELS}
    for m, b, fwd_kernels in (("pvcnne", B, fwd), ("pointnet2", BF2,
                                                   fwd_pn2),
                              ("pointnet", B, ())):
        inputs, _ = synthetic_batch(np.random.RandomState(SEED + 63), b, NF)
        phase_frustum_slice(f"Frustum {m} 1x", copy.deepcopy(models[m]),
                            inputs, fwd_kernels)
    lap("frustum slice")
    batches = frustum_batches(SEED + 64, B, 3)
    ref = phase_frustum_train("FrustumPVCNNE 1x", models["pvcnne"], batches,
                              PER_STEP_PVCNNE, profile)
    phase_frustum_switched("FrustumPVCNNE 1x", models["pvcnne"], batches[0],
                           ref, {"PVCNN_TPU_CONV_BN_FUSED": "0"},
                           PER_STEP_PVCNNE, "CONV_BN_FUSED=0", profile)
    counts[pvcnne_on] = phase_frustum_switched(
        "FrustumPVCNNE 1x", models["pvcnne"], batches[0], ref, SWITCHES,
        PER_STEP_PVCNNE_ON, "switches on", profile)
    # FrustumPointNet2's plain path moves by 5.5e-4 against itself at step
    # 3 (scatter_add_ atomics in its groupings' and interpolations'
    # gradients; PVCNNE's by 7.1e-5): its steps 2-3 are held to 5e-3, as
    # PVCNN2's are
    phase_frustum_train("FrustumPointNet2 1x", models["pointnet2"],
                        frustum_batches(SEED + 65, BF2, 3), PER_STEP_FPN2,
                        profile, traj_rtol=5e-3)
    phase_frustum_train("FrustumPointNet 1x", models["pointnet"], batches,
                        {}, profile)
    del models
    lap("frustum train")
    counts[pvcnne] = phase_frustum_trainer("pvcnne", PER_STEP_PVCNNE)
    counts[fpn2] = phase_frustum_trainer("pointnet2", PER_STEP_FPN2)
    phase_frustum_trainer("pointnet", {})
    lap("frustum trainer")

    rng = np.random.RandomState(SEED + 70)
    batches = [(torch.from_numpy(cloud(rng, B, N)).to(dev),
                torch.from_numpy(rng.randint(0, 50, (B, N))).to(dev))
               for _ in range(3)]
    phase_dml_train("PVCNN 1x", init_random_(PVCNN(50, 16, 3), SEED),
                    init_random_(PVCNN(50, 16, 3), SEED + STUDENT_SEED_OFFSET),
                    batches, PER_STEP, profile)
    del batches
    lap("dml train")
    counts["ShapeNet PVCNN 1x"] = _add_counts(counts["ShapeNet PVCNN 1x"],
                                              phase_dml_trainer(PER_STEP))
    lap("dml trainer")
    # 27's tree stays for the configs phase
    kitti_dir = tempfile.TemporaryDirectory(dir=_scratch_dir())
    root = kitti_dir.name
    kitti_paths = write_synthetic_root(root, np.random.RandomState(SEED + 80),
                                       NUM_KITTI)
    for m, path, per_step, fwd_kernels in (
            ("pvcnne", pvcnne, PER_STEP_PVCNNE, fwd),
            ("pointnet2", fpn2, PER_STEP_FPN2, fwd_pn2),
            ("pointnet", None, {}, ())):
        more = phase_kitti(m, root, kitti_paths, per_step, fwd_kernels)
        if path is not None:
            counts[path] = _add_counts(counts[path], more)
    lap("kitti")
    phase_kitti_ap(fwd)
    lap("kitti AP")
    more = phase_configs(s3dis_dir.name, store, kitti_dir.name, kitti_paths,
                         fwd, fwd2)
    for path, c in more.items():
        counts[path] = _add_counts(counts[path], c)
    del store
    s3dis_dir.cleanup()
    kitti_dir.cleanup()
    lap("configs")

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
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
