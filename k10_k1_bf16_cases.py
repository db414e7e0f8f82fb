#!/usr/bin/env python3
"""K10 in bf16 (the fused dense layer's weight gradient, pvcnn_tpu_torch/
csrc/dense_rows.cu) and K1 in bf16 (the scatter-mean and its sum mode,
pvcnn_tpu_torch/csrc/voxelize.cu), case by case on one NVIDIA GPU.

    python3 k10_k1_bf16_cases.py [--tree DIR] [--save FILE] [--against FILE]
                                 [--ptxas] [--sass FILE] [--steps]

The cases are chip_smoke.py's: K10's bf16 mode (Ci, Co, prologue) at
every call of the S3DIS PVCNN 1x bf16 opt-in step (CALLS3_ON_BF16,
131,072 rows) and of PointNet++ MSG 1x with PVCNN_TPU_DENSE_BN_FUSED=auto
(CALLS_MSG_ON_BF16, each layer's rows); K1's bf16 mean (C, R, N) at the
bf16 steps of ShapeNet PVCNN 1x, S3DIS PVCNN2 1x and S3DIS PVCNN 1x
(channel-major) and of the opt-in step (channel-last), and its bf16 sum
mode (K, bins, C) at PVCNN2's, SSG's and MSG's take_rows backwards, on
the indices their FPS, ball-query and three-NN levels give (as chip_smoke
makes them); and each K1 case once more in fp32, whose outputs and sort
must not move. bf16 values from a generator seeded per case. Per case it
prints the ms per call on the host clock (median of single calls, each
ended by a synchronize) and on the device (median of CUDA events, as
chip_smoke.py times it), the device time split by torch.profiler over 10
calls into the kernel's own launches, K1's sort (the glue) and the rest,
the bound (bytes over 3.35 TB/s, or bf16 operations over 989 TFLOP/s,
the larger) and the share of it reached, the library call's ms
(torch.mm into f32 and the sum; scatter_reduce_ mean; index_add_ on the
values widened to f32: timed here only, never called by the port) and
the ratio to it; K1's longest run; every output twice bitwise equal (the
fp32 cases are not timed). Then the ms per training step of each kernel
and path.

--tree DIR imports pvcnn_tpu_torch from DIR (another checkout, such as a
parent commit unpacked with `git archive`) instead of this one; its
kernels are built under DIR/build/, and the case tables still come from
this checkout's chip_smoke.py. --save FILE writes the SHA-256 of every
output (and of K1's sort: its permutation and bounds) to FILE (JSON);
--against FILE compares this tree's outputs with such a file bit for bit.
--sort-sweep also times K1's sort alone at each bf16 case with 1, 2, 3, 5
and 8 blocks a cloud forced (this checkout's plan, `_sort_plan`, with
its parts replaced). --ptxas builds the kernels with `-Xptxas -v` and
prints the registers,
shared memory and spills of K10's and K1's kernels. --sass FILE writes, as
JSON, the nvcc release and the SASS digests (`cases_util.sass_digests`)
of the fp32 K9 / K10 (and its fold), K9's bf16 kernels and the fp32 K1
bin walks, to compare two trees' sets. --steps then times the S3DIS
PVCNN 1x bf16 opt-in step (the three switches on), PointNet++ MSG 1x's
bf16 step with PVCNN_TPU_DENSE_BN_FUSED=auto, and the bf16 steps of S3DIS
PVCNN2 1x and PointNet++ SSG / MSG 1x, seeded random weights and one
synthetic batch each: 3 rounds of 5 steps (median of CUDA events), the
median and spread of the rounds, and the peak device memory of a step.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import statistics
import sys
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))


def _args():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=None)
    p.add_argument("--save", default=None)
    p.add_argument("--against", default=None)
    p.add_argument("--ptxas", action="store_true")
    p.add_argument("--sass", default=None)
    p.add_argument("--steps", action="store_true")
    p.add_argument("--sort-sweep", action="store_true")
    return p.parse_args()


ARGS = _args()
if ARGS.tree is not None:
    sys.path.insert(0, os.path.abspath(ARGS.tree))


def _here(name):
    """Module `name` from this checkout, whatever --tree names."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

cases_util = _here("cases_util")
chip_smoke = _here("chip_smoke")   # the case tables, bounds and the timer

B, SEED = chip_smoke.B, chip_smoke.SEED
PEAK = chip_smoke.PEAK_BF16_FLOPS
K10, MEAN, SUM = ("dense_rows_wgrad_bf16", "avg_voxelize_bf16",
                  "scatter_sum_bf16")
# device-time groups: the kernel's own launches (both trees' names), K1's
# sort, the rest
OWN = {K10: ("dense_rows",), MEAN: ("avg_voxelize_bins",),
       SUM: ("avg_voxelize_bins",), "avg_voxelize": ("avg_voxelize_bins",),
       "scatter_sum": ("avg_voxelize_bins",)}
SORT = ("avg_voxelize_sort",)
SASS_KEYS = ("dense_rows_fwd_kernel", "dense_rows_wgrad_kernel",
             "dense_rows_fold_kernel", "dense_rows_wgmma_kernel",
             "dense_rows_bf16_weights_kernel",
             "avg_voxelize_bins_kernel<float")


def _gen(*key):
    return torch.Generator(device="cuda").manual_seed(
        zlib.crc32(" ".join(map(str, key)).encode()))


def _k10_jobs(dense_rows, path, calls, rows):
    """(kernel, path, case, calls, run, library, flops, bytes, sort) of
    every K10 bf16 case of `calls`: (Ci, Co, prologue) on `rows` rows, or,
    without rows, (rows, Ci, Co, prologue)."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    jobs = []
    for case in sorted(c for k, c in calls if k == K10):
        n_rows, ci, co, pro = (rows,) + case if rows else case
        gen = _gen(path, case)
        x = torch.randn(n_rows, ci, device=dev, generator=gen).to(bf)
        g = torch.randn(n_rows, co, device=dev, generator=gen).to(bf)
        scale = torch.rand(ci, device=dev, generator=gen) + 0.5
        shift = torch.randn(ci, device=dev, generator=gen) * 0.5
        xa = (dense_rows._activated(x, scale, shift, 0.0, True).to(bf)
              if pro else x)
        jobs.append((K10, path, case, calls[(K10, case)],
                     lambda x=x, g=g, s=scale, h=shift, pro=pro:
                     dense_rows._wgrad_cuda(x, g, s, h, 0.0, pro),
                     lambda xa=xa, g=g: (torch.mm(xa.t(), g,
                                                  out_dtype=torch.float32),
                                         g.float().sum(0)),
                     2.0 * n_rows * ci * co,
                     2 * n_rows * (ci + co) + 4 * (ci * co + co), None))
    return jobs


def _k1_mean_jobs(voxelize, ops, path, calls, coords_of, cf, fp32=False):
    """The K1 mean cases (C, R, N) of `calls` (bf16, or with fp32 the same
    cases in fp32) on clouds coords_of(n), normalized as the PVConvs
    normalize, channel-major grids with cf, else channel-last."""
    dev = torch.device("cuda")
    kernel = "avg_voxelize" if fp32 else MEAN
    jobs = []
    for c, r, n in sorted(c for k, c in calls if k == MEAN):
        case = (c, r, n)
        vox, _ = ops.normalize_coords(coords_of(n), r, normalize=True)
        flat = ops.flat_voxel_index(vox, r)
        feats = torch.randn(B, n, c, device=dev, generator=_gen(path, case))
        if not fp32:
            feats = feats.to(torch.bfloat16)
        idx = flat.long()[..., None].expand(-1, -1, c)
        jobs.append((kernel, path + (" cf" if cf else " last"), case,
                     calls[(MEAN, case)],
                     lambda f=feats, i=flat, r=r: voxelize._scatter_mean_cuda(
                         f, i, r ** 3, cf)[0],
                     lambda f=feats, i=idx, r=r, c=c: f.new_zeros(
                         B, r ** 3, c).scatter_reduce_(1, i, f, "mean",
                                                      include_self=False),
                     B * n * c,
                     feats.element_size() * (B * n * c + B * r ** 3 * c)
                     + 4 * B * n,
                     (flat, r ** 3)))
    return jobs


def _k1_sum_jobs(voxelize, path, calls, rows, fp32=False):
    """The K1 sum-mode cases (K, bins, C) of `calls` on the take_rows
    indices `rows` {(K, bins): idx [B, K]}."""
    dev = torch.device("cuda")
    kernel = "scatter_sum" if fp32 else SUM
    jobs = []
    for k, bins, c in sorted(c for kk, c in calls if kk == SUM):
        case = (k, bins, c)
        idx = rows[(k, bins)]
        values = torch.randn(B, k, c, device=dev, generator=_gen(path, case))
        if not fp32:
            values = values.to(torch.bfloat16)
        flat = (idx.long() + torch.arange(B, device=dev)[:, None] * bins
                ).reshape(-1)
        wide = values.float().reshape(-1, c)
        jobs.append((kernel, path, case, calls[(SUM, case)],
                     lambda v=values, i=idx, n=bins:
                     voxelize._scatter_sum_cuda(v, i, n),
                     lambda w=wide, f=flat, n=bins, c=c: w.new_zeros(
                         B * n, c).index_add_(0, f, w),
                     B * k * c,
                     values.element_size() * (B * k * c + B * bins * c)
                     + 4 * B * k,
                     (idx.to(torch.int32), bins)))
    return jobs


def _sum_indices(calls):
    """{(K, bins): idx} of a PointNet++ path's take_rows backwards on
    ShapeNet-like or S3DIS-like clouds (chip_smoke's phase 30 inputs)."""
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if calls is chip_smoke.CALLS2_BF16:
        x, _ = chip_smoke.windows(np.random.RandomState(SEED + 111), B,
                                  chip_smoke.N2)
    else:
        x = chip_smoke.cloud(np.random.RandomState(SEED + 113), B,
                             chip_smoke.N)
    pts = torch.from_numpy(np.ascontiguousarray(x[..., :3])).to(dev)
    return chip_smoke._take_rows_indices(pts, calls, sms)


def _jobs(dense_rows, voxelize, ops):
    dev = torch.device("cuda")
    jobs = (_k10_jobs(dense_rows, "S3DIS opt-in", chip_smoke.CALLS3_ON_BF16,
                      B * chip_smoke.N3)
            + _k10_jobs(dense_rows, "MSG fused",
                        chip_smoke.CALLS_MSG_ON_BF16, None))
    shapenet = torch.from_numpy(chip_smoke.cloud(
        np.random.RandomState(SEED + 113), B, chip_smoke.N)[..., :3]).to(dev)
    x3, _ = chip_smoke.windows(np.random.RandomState(SEED + 112), B,
                               chip_smoke.N3)
    s3dis = torch.from_numpy(np.ascontiguousarray(x3[..., :3])).to(dev)
    rows2, by_n = _sum_indices(chip_smoke.CALLS2_BF16)
    for fp32 in (False, True):
        jobs += _k1_mean_jobs(voxelize, ops, "ShapeNet PVCNN",
                              chip_smoke.CALLS_BF16,
                              lambda n: shapenet[:, :n], True, fp32)
        jobs += _k1_mean_jobs(voxelize, ops, "PVCNN2",
                              chip_smoke.CALLS2_BF16, lambda n: by_n[n],
                              True, fp32)
        jobs += _k1_mean_jobs(voxelize, ops, "S3DIS PVCNN",
                              chip_smoke.CALLS3_BF16,
                              lambda n: s3dis[:, :n], True, fp32)
        jobs += _k1_mean_jobs(voxelize, ops, "S3DIS opt-in",
                              chip_smoke.CALLS3_ON_BF16,
                              lambda n: s3dis[:, :n], False, fp32)
        jobs += _k1_sum_jobs(voxelize, "PVCNN2", chip_smoke.CALLS2_BF16,
                             rows2, fp32)
        for path, calls in (("SSG", chip_smoke.CALLS_SSG_BF16),
                            ("MSG", chip_smoke.CALLS_MSG_BF16)):
            jobs += _k1_sum_jobs(voxelize, path, calls,
                                 _sum_indices(calls)[0], fp32)
    return jobs


def _sort_sweep(voxelize, ids, bins) -> str:
    """The sort's device ms at 1, 2, 3, 5 and 8 blocks a cloud, and the
    plan's choice."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = voxelize._sort_plan(B, ids.shape[1], bins, sms)
    run = lambda: voxelize._sort_bins(ids, bins)  # noqa: E731
    got = []
    real = voxelize._sort_plan
    try:
        for parts in (1, 2, 3, 5, 8):
            voxelize._sort_plan = lambda *a, p=plan._replace(parts=parts): p
            got.append(f"{parts}: {cases_util.device_ms(run)[0]:.4f}")
    finally:
        voxelize._sort_plan = real
    return (f"; sort ms by blocks a cloud {{{', '.join(got)}}} (plan "
            f"{plan.parts})")


def _sass(path) -> None:
    from pvcnn_tpu_torch import kernels

    lib_path, _, _ = kernels.build()
    record = {"nvcc": cases_util.nvcc_version(),
              "digests": cases_util.sass_digests(lib_path, SASS_KEYS)}
    with open(path, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    print(f"[sass] {len(record['digests'])} kernels' SASS digests "
          f"({record['nvcc']}) written to {path}", flush=True)


def main() -> None:
    from pvcnn_tpu_torch import kernels, ops
    from pvcnn_tpu_torch.ops import dense_rows, voxelize

    if not torch.cuda.is_available():
        print("k10_k1_bf16_cases: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    print(cases_util.smi(), flush=True)
    print(f"[cases] pvcnn_tpu_torch from {os.path.dirname(kernels.__file__)}")
    if ARGS.ptxas:
        cases_util.ptxas(kernels, "dense_rows_wgrad", "dense_rows_bf16",
                         "avg_voxelize")
    kernels.library()
    if ARGS.sass:
        _sass(ARGS.sass)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    digests = cases_util.Digests(ARGS.save, ARGS.against, "cases")
    per_step = {}
    for kernel, path, case, n, run, lib, flops, nbytes, sort in _jobs(
            dense_rows, voxelize, ops):
        out = run()
        out = out if isinstance(out, tuple) else (out,)
        again = run()
        again = again if isinstance(again, tuple) else (again,)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"{kernel} {path} {case}: two runs differ")
        tag = digests.add(f"{kernel} {path} {case}", *out)
        extra = ""
        if sort is not None:
            perm, bounds = voxelize._sort_bins(*sort)
            runs = bounds[:, 1:] - bounds[:, :-1]
            tag += digests.add(f"{kernel} {path} {case} sort",
                               bounds, *[perm[i, :int(bounds[i, -1])]
                                         for i in range(B)])
            extra = f"; longest run {int(runs.max())} rows"
            if ARGS.sort_sweep and kernel.endswith("_bf16"):
                extra += _sort_sweep(voxelize, *sort)
        del out, again
        if not kernel.endswith("_bf16"):         # fp32: its bits alone
            print(f"[{kernel}] {path} {case}: two runs bitwise equal{extra}"
                  f"{tag}", flush=True)
            continue
        ms, host = chip_smoke.time_ms(run), cases_util.host_ms(run)
        lib_ms = chip_smoke.time_ms(lib)
        own, glue, rest = cases_util.device_ms(run, OWN[kernel], SORT)
        bound, ops_ms, bytes_ms = chip_smoke._bound_ms(flops, nbytes, PEAK)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        print(f"[{kernel}] {path} {case} x{n}: {ms:.4f} ms device "
              f"({host:.4f} host; kernel {own:.4f}, sort {glue:.4f}, rest "
              f"{rest:.4f}), bound {bound:.4f} ({by}): {bound / ms:.1%} by "
              f"ms, {bound / max(own, 1e-9):.1%} by the kernel; library "
              f"{lib_ms:.4f} ({ms / lib_ms:.2f}x){extra}{tag}", flush=True)
        acc = per_step.setdefault(f"{path.split(' cf')[0].split(' last')[0]}"
                                  f" {kernel}", [0.0] * 7)
        for i, v in enumerate((ms, host, own, glue, rest, bound, lib_ms)):
            acc[i] += n * v
    for name, (ms, host, own, glue, rest, bound, lib_ms) in \
            per_step.items():
        print(f"[step] {name}: {ms:.4f} ms per step ({host:.4f} host; "
              f"kernel {own:.4f}, sort {glue:.4f}, rest {rest:.4f}), bound "
              f"{bound:.4f}: {bound / ms:.1%}; library {lib_ms:.4f} "
              f"({ms / lib_ms:.2f}x)", flush=True)
    digests.finish()
    if ARGS.steps:
        _steps()


def _steps() -> None:
    from pvcnn_tpu_torch.models.s3dis import PVCNN as S3DISPVCNN
    from pvcnn_tpu_torch.models.s3dis import PVCNN2
    from pvcnn_tpu_torch.models.shapenet import pointnet2_msg, pointnet2_ssg
    from pvcnn_tpu_torch.utils.weights import init_random_

    dev = torch.device("cuda")

    def batch(kind, seed, cols=22):
        rng = np.random.RandomState(seed)
        if kind == "s3dis":
            n = chip_smoke.N2 if seed == SEED + 121 else chip_smoke.N3
            return tuple(torch.from_numpy(a).to(dev)
                         for a in chip_smoke.windows(rng, B, n))
        x = np.ascontiguousarray(chip_smoke.cloud(rng, B, chip_smoke.N)
                                 [..., :cols])
        return (torch.from_numpy(x).to(dev),
                torch.from_numpy(rng.randint(0, 50, (B, chip_smoke.N))).to(
                    dev))
    settings = (
        ("S3DIS PVCNN 1x bf16 opt-in", lambda dt: S3DISPVCNN(13, 6, dtype=dt),
         batch("s3dis", SEED + 132), frozenset(chip_smoke.SWITCHES), 1e-5),
        ("PointNet++ MSG 1x bf16, DENSE_BN_FUSED=auto",
         lambda dt: pointnet2_msg(50, 16, dtype=dt),
         batch("shapenet", SEED + 133),
         frozenset({"PVCNN_TPU_DENSE_BN_FUSED"}), 0.0),
        ("S3DIS PVCNN2 1x bf16", lambda dt: PVCNN2(13, 6, dtype=dt),
         batch("s3dis", SEED + 121), frozenset(), 1e-5),
        ("PointNet++ SSG 1x bf16", lambda dt: pointnet2_ssg(50, 16, dtype=dt),
         batch("shapenet", SEED + 123, 6), frozenset(), 0.0),
        ("PointNet++ MSG 1x bf16", lambda dt: pointnet2_msg(50, 16, dtype=dt),
         batch("shapenet", SEED + 124), frozenset(), 0.0))
    for label, make, (x, y), on, decay in settings:
        base = init_random_(make(None), SEED)
        trainer = chip_smoke._trainer(chip_smoke._bf16_twin(make, base),
                                      decay)
        with chip_smoke.switches(on):
            rounds = [chip_smoke.time_ms(lambda: trainer.train_step(x, y),
                                         reps=5, warmup=1)
                      for _ in range(3)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            trainer.train_step(x, y)
            torch.cuda.synchronize()
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[steps] {label}: median {statistics.median(rounds):.3f} ms, "
              f"spread {max(rounds) - min(rounds):.3f} (rounds "
              f"{', '.join(f'{v:.3f}' for v in rounds)}); peak memory "
              f"{mem:.3f} GiB", flush=True)
        del trainer, base


if __name__ == "__main__":
    main()
