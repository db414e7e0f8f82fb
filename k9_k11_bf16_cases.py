#!/usr/bin/env python3
"""K9 in bf16 (the fused dense layer's forward and dgrad, pvcnn_tpu_torch/
csrc/dense_rows.cu) and K11 in bf16 (the NDHWC conv's weight gradient,
pvcnn_tpu_torch/csrc/conv3d_bf16.cu), case by case on one NVIDIA GPU.

    python3 k9_k11_bf16_cases.py [--tree DIR] [--save FILE] [--against FILE]
                                 [--ptxas] [--sass FILE] [--steps]

The cases are chip_smoke.py's: K9's bf16 forward (Ci, Co, prologue) with
its statistics and its dgrad (Co, Ci) at every call of the S3DIS PVCNN 1x
bf16 opt-in step (CALLS3_ON_BF16, 131,072 rows) and of PointNet++ MSG 1x
with PVCNN_TPU_DENSE_BN_FUSED=auto (CALLS_MSG_ON_BF16, each layer's rows),
and K11's bf16 mode (Ci, Co, R) at the opt-in step's convs (B = 32); bf16
rows, grids and cotangents from a generator seeded per case, the weight
the fused SharedMLP's float32 [Ci, Co] view (the dgrad reads the forward's
bf16 copy where the tree has one). Per case it prints the ms per call on
the host clock (median of single calls, each ended by a synchronize) and on
the device (median of CUDA events, as chip_smoke.py times it), the device
time split by torch.profiler over 10 calls into the kernel's own launches,
K11's channel-last staging pass and the rest, the bound (bf16 operations
over 989 TFLOP/s or bytes over 3.35 TB/s, the larger) and the share of it
reached, the library call's ms (F.linear and the two sums, F.linear,
conv3d_weight: timed here only, never called by the port) and the ratio
to it; every output twice bitwise equal. Then the ms per training step of
each kernel and path.

--tree DIR imports pvcnn_tpu_torch from DIR (another checkout, such as a
parent commit unpacked with `git archive`) instead of this one; its
kernels are built under DIR/build/, and the case tables still come from
this checkout's chip_smoke.py. --save FILE writes the SHA-256 of every
output to FILE (JSON); --against FILE compares this tree's outputs with
such a file bit for bit. --ptxas builds the kernels with `-Xptxas -v` and
prints the registers, shared memory and spills of K9's, K10's and K3 / K4
/ K11's bf16 kernels. --sass FILE writes, as JSON, the nvcc release and the
SASS digests (`cases_util.sass_digests`) of every kernel of
csrc/conv3d_bf16.cu and of K10's bf16 kernel, to compare two trees' sets.
--steps then times the S3DIS PVCNN 1x bf16 opt-in training step (the
three switches on) and PointNet++ MSG 1x's bf16 step with
PVCNN_TPU_DENSE_BN_FUSED=auto, seeded random weights and one synthetic
batch each: 3 rounds of 5 steps (median of CUDA events), the median and
spread of the rounds, and the peak device memory of a step.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
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


import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

cases_util = _here("cases_util")
chip_smoke = _here("chip_smoke")   # the case tables, bounds and the timer

B, SEED = chip_smoke.B, chip_smoke.SEED
PEAK = chip_smoke.PEAK_BF16_FLOPS
K9, DGRAD, K11 = ("dense_rows_fwd_bf16", "dense_rows_dgrad_bf16",
                  "conv3d_ndhwc_wgrad_bf16")
# device-time groups: the kernel's own launches (both trees' names), K11's
# staging pass, the rest
OWN = {K9: ("dense_rows",), DGRAD: ("dense_rows",),
       K11: ("conv3d_bf16_wgrad",)}
SASS_KEYS = ("conv3d_bf16_", "dense_rows_wgrad_wgmma_kernel")


def _takes_staged(fn) -> bool:
    return "staged" in inspect.signature(fn).parameters


def _dense_jobs(dense_rows, path, calls, rows):
    """(kernel, path, case, calls, run, library, flops, bytes) of every K9
    bf16 forward and dgrad case of `calls`: cases (Ci, Co, prologue) and
    (Co, Ci) on `rows` rows, or, without rows, (rows, Ci, Co, prologue) and
    (rows, Co, Ci)."""
    shapes = sorted({(rows,) + c[:2] if rows else c[:3]
                     for k, c in calls if k == K9})
    return [job for n_rows, ci, co in shapes
            for job in _dense_shape(dense_rows, path, calls, n_rows, ci, co,
                                    () if rows else (n_rows,))]


def _dense_shape(dense_rows, path, calls, n_rows, ci, co, prefix):
    """The jobs of one shape, its cases prefix + (Ci, Co, prologue) and
    prefix + (Co, Ci) (their tensors live in this call's scope)."""
    key = lambda *c: prefix + c  # noqa: E731
    dev, bf = torch.device("cuda"), torch.bfloat16
    staged_ok = _takes_staged(dense_rows._forward_cuda)
    jobs = []
    gen = torch.Generator(device=dev).manual_seed(
        zlib.crc32(f"{path} {n_rows} {ci} {co}".encode()))
    bound = 1.0 / ci ** 0.5
    x = torch.randn(n_rows, ci, device=dev, generator=gen).to(bf)
    wt = (torch.rand(co, ci, device=dev, generator=gen) * 2 - 1) * bound
    w, w16 = wt.t(), wt.to(bf)
    bias = (torch.rand(co, device=dev, generator=gen) * 2 - 1) * bound
    scale = torch.rand(ci, device=dev, generator=gen) + 0.5
    shift = torch.randn(ci, device=dev, generator=gen) * 0.5
    g = torch.randn(n_rows, co, device=dev, generator=gen).to(bf)
    staged = {}
    extra = (staged,) if staged_ok else ()
    flops = 2.0 * n_rows * ci * co
    for pro in (False, True):
        case = key(ci, co, pro)
        if (K9, case) not in calls:
            continue
        xa = (dense_rows._activated(x, scale, shift, 0.0, True).to(bf)
              if pro else x)

        def lib(xa=xa):
            y = F.linear(xa, w16, bias.to(bf))
            yf = y.float()
            return y, yf.sum(0), (yf * yf).sum(0)

        jobs.append((K9, path, case, calls[(K9, case)],
                     lambda pro=pro: dense_rows._forward_cuda(
                         x, w, bias, scale, shift, 0.0, pro, True,
                         *extra),
                     lib, flops, 2 * (n_rows * ci + n_rows * co)
                     + 4 * (ci * co + 3 * co)))
    case = key(co, ci)
    if (DGRAD, case) in calls:
        if staged_ok and "w16" not in staged:
            dense_rows._forward_cuda(x, w, bias, scale, shift, 0.0,
                                     False, False, staged)
        jobs.append((DGRAD, path, case, calls[(DGRAD, case)],
                     lambda: dense_rows._dgrad_cuda(g, w, *extra),
                     lambda: F.linear(g, w16.t()), flops,
                     2 * (n_rows * co + n_rows * ci) + 4 * ci * co))
    return jobs


def _k11_jobs(conv3d, calls):
    dev, bf = torch.device("cuda"), torch.bfloat16
    jobs = []
    for ci, co, r in sorted(c for k, c in calls if k == K11):
        case = (ci, co, r)
        gen = torch.Generator(device=dev).manual_seed(
            zlib.crc32(f"K11 {case}".encode()))
        x = torch.randn(B, r, r, r, ci, device=dev, generator=gen).to(bf)
        g = torch.randn(B, r, r, r, co, device=dev, generator=gen).to(bf)
        xp, gp = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
        jobs.append((K11, "S3DIS opt-in", case, calls[(K11, case)],
                     lambda x=x, g=g: conv3d._ndhwc_wgrad_cuda(x, g, 3),
                     lambda xp=xp, gp=gp, ci=ci, co=co:
                     torch.nn.grad.conv3d_weight(xp, (co, ci, 3, 3, 3), gp,
                                                 padding=1),
                     2.0 * 27 * ci * co * B * r ** 3,
                     2 * (B * r ** 3 * (ci + co) + 27 * ci * co)))
    return jobs


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
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.ops import conv3d, dense_rows

    if not torch.cuda.is_available():
        print("k9_k11_bf16_cases: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    print(cases_util.smi(), flush=True)
    print(f"[cases] pvcnn_tpu_torch from {os.path.dirname(kernels.__file__)}")
    if ARGS.ptxas:
        cases_util.ptxas(kernels, "dense_rows_wgmma", "dense_rows_bf16",
                         "conv3d_bf16_wgrad")
    kernels.library()
    if ARGS.sass:
        _sass(ARGS.sass)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    digests = cases_util.Digests(ARGS.save, ARGS.against, "cases")
    jobs = (_dense_jobs(dense_rows, "S3DIS opt-in", chip_smoke.CALLS3_ON_BF16,
                        B * chip_smoke.N3)
            + _k11_jobs(conv3d, chip_smoke.CALLS3_ON_BF16)
            + _dense_jobs(dense_rows, "MSG fused",
                          chip_smoke.CALLS_MSG_ON_BF16, None))
    per_step = {}
    for kernel, path, case, n, run, lib, flops, nbytes in jobs:
        out = run()
        out = out if isinstance(out, tuple) else (out,)
        again = run()
        again = again if isinstance(again, tuple) else (again,)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"{kernel} {path} {case}: two runs differ")
        tag = digests.add(f"{kernel} {path} {case}", *out)
        del out, again
        ms, host = chip_smoke.time_ms(run), cases_util.host_ms(run)
        lib_ms = chip_smoke.time_ms(lib)
        own, staging, rest = cases_util.device_ms(run, OWN[kernel],
                                                  ("stage_last",))
        bound, ops_ms, bytes_ms = chip_smoke._bound_ms(flops, nbytes, PEAK)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        print(f"[{kernel}] {path} {case} x{n}: {ms:.4f} ms device "
              f"({host:.4f} host; kernel {own:.4f}, staging {staging:.4f}, "
              f"rest {rest:.4f}), bound {bound:.4f} ({by}): {bound / ms:.1%}"
              f" by ms, {bound / max(own, 1e-9):.1%} by the kernel; library "
              f"{lib_ms:.4f} ({ms / lib_ms:.2f}x){tag}", flush=True)
        acc = per_step.setdefault(f"{path} {kernel}", [0.0] * 7)
        for i, v in enumerate((ms, host, own, staging, rest, bound, lib_ms)):
            acc[i] += n * v
    for name, (ms, host, own, staging, rest, bound, lib_ms) in \
            per_step.items():
        print(f"[step] {name}: {ms:.4f} ms per step ({host:.4f} host; "
              f"kernel {own:.4f}, staging {staging:.4f}, rest {rest:.4f}), "
              f"bound {bound:.4f}: {bound / ms:.1%}; library {lib_ms:.4f} "
              f"({ms / lib_ms:.2f}x)", flush=True)
    digests.finish()
    if ARGS.steps:
        _steps()


def _steps() -> None:
    from pvcnn_tpu_torch.models.s3dis import PVCNN as S3DISPVCNN
    from pvcnn_tpu_torch.models.shapenet import pointnet2_msg
    from pvcnn_tpu_torch.utils.weights import init_random_

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 132)
    s3dis = tuple(torch.from_numpy(a).to(dev)
                  for a in chip_smoke.windows(rng, B, chip_smoke.N3))
    rng = np.random.RandomState(SEED + 133)
    msg = (torch.from_numpy(chip_smoke.cloud(rng, B, chip_smoke.N)).to(dev),
           torch.from_numpy(rng.randint(0, 50, (B, chip_smoke.N))).to(dev))
    settings = (
        ("S3DIS PVCNN 1x bf16 opt-in", lambda dt: S3DISPVCNN(13, 6, dtype=dt),
         s3dis, frozenset(chip_smoke.SWITCHES), 1e-5),
        ("PointNet++ MSG 1x bf16, DENSE_BN_FUSED=auto",
         lambda dt: pointnet2_msg(50, 16, dtype=dt), msg,
         frozenset({"PVCNN_TPU_DENSE_BN_FUSED"}), 0.0))
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
