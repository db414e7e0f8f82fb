#!/usr/bin/env python3
"""K9 (the fused dense layer, forward and dgrad) and K10 (its weight
gradient), pvcnn_tpu_torch/csrc/dense_rows.cu, case by case on one NVIDIA
GPU.

    python3 k9_k10_cases.py [--tree DIR] [--ptxas] [--save FILE]
                            [--against FILE] [--define NAME=VALUE ...]
                            [--steps]

The cases are chip_smoke.py's CALLS3_ON (the S3DIS PVCNN 1x opt-in training
step: B * N = 32 * 4096 = 131,072 rows): K9's forward (Ci, Co, prologue)
with its statistics epilogue, the dgrad (Co, Ci) and K10 (Ci, Co,
prologue), each with its calls per step. The weight is laid out as the
fused SharedMLP passes it: the [Co, Ci] Conv1d weight's transposed view.
Per case it prints the ms per call on the host clock (median of single
calls, each ended by a synchronize) and on the device (median of CUDA
events, as chip_smoke.py times it), the device time split into the
kernel's own launches and the rest the wrapper launches (torch.profiler
over 10 calls), the least time the card could take (bound) and the share
of it reached, the library call's ms (F.linear and the two sums for the
forward, g @ w.t() for the dgrad, x.t() @ g and g.sum(0) for K10: timed
here only, never called by the port), the plan where the tree has one,
and the largest difference from an fp64 plain version relative to the
largest entry of the exact output. Then the ms per training step.

--tree DIR imports pvcnn_tpu_torch from DIR (another checkout, such as a
parent commit unpacked with `git archive`) instead of this one; its kernels
are built under DIR/build/. --ptxas builds the kernels with `-Xptxas -v`
and prints the registers, shared memory and spills of K9's and K10's
kernels. --save FILE writes the SHA-256 of every output (K9, the dgrad
and K10) to FILE (JSON); --against FILE says for each whether this tree's
output equals it bit for bit (K11's are k7_k11_cases.py's). --define
NAME=VALUE adds -DNAME=VALUE to the kernels' build (a separate build
directory entry: the flags are part of its hash), for sweeps of the
compile-time tile constants. --steps then times the S3DIS PVCNN 1x
training step (B = 32 x 4096, seeded random weights, one batch of synthetic
windows) under four settings of the JAX package's switches, in turns: the
default path, PVCNN_TPU_DENSE_BN_FUSED=auto alone (the rows conv branch at
its default), the opt-in path (all three switches) and the opt-in path with
PVCNN_TPU_DENSE_BN_FUSED=0; 3 rounds of 5 steps each (median of CUDA
events), with the median and spread of the rounds.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys


def _args():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=None)
    p.add_argument("--ptxas", action="store_true")
    p.add_argument("--save", default=None)
    p.add_argument("--against", default=None)
    p.add_argument("--define", action="append", default=[])
    p.add_argument("--steps", action="store_true")
    return p.parse_args()


ARGS = _args()
if ARGS.tree is not None:
    sys.path.insert(0, os.path.abspath(ARGS.tree))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import cases_util  # noqa: E402
import chip_smoke  # noqa: E402  (the case tables, bounds and the timer)

ROWS = chip_smoke.B * chip_smoke.N3
OWN = ("dense_rows",)                  # K9's and K10's kernel names


def _err(got, exact) -> float:
    return ((got.double() - exact).abs().max()
            / exact.abs().max().clamp_min(1e-30)).item()


def _plan(dense_rows, kind, rows, ci, co, sms) -> str:
    if not hasattr(dense_rows, "_plan"):
        return "parent: 128x64 tile, K10 split by _WGRAD_BLOCKS"
    m, n, k = {"fwd": (rows, co, ci), "dgrad": (rows, ci, co),
               "wgrad": (ci, co, rows)}[kind]
    return str(dense_rows._plan(m, n, k, kind == "wgrad", sms))


def main() -> None:
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.ops import dense_rows

    if not torch.cuda.is_available():
        print("k9_k10_cases: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    print(cases_util.smi(), flush=True)
    print(f"[k9] pvcnn_tpu_torch from {os.path.dirname(kernels.__file__)}")
    if ARGS.define:
        kernels.NVCC_FLAGS = kernels.NVCC_FLAGS + tuple(
            f"-D{d}" for d in ARGS.define)
        print(f"[k9] build defines {ARGS.define}")
        # the plan's mirror of the slice and the ring
        for d in ARGS.define:
            name, _, value = d.partition("=")
            attr = {"PVCNN_DENSE_BK": "_BK",
                    "PVCNN_DENSE_STAGES": "_STAGES"}.get(name)
            if attr and hasattr(dense_rows, attr):
                setattr(dense_rows, attr, int(value))
                dense_rows._plan.cache_clear()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if ARGS.ptxas:
        cases_util.ptxas(kernels, "dense_rows")
    kernels.library()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    calls = chip_smoke.CALLS3_ON
    digests = cases_util.Digests(ARGS.save, ARGS.against, "k9")
    per_step = {}
    torch.manual_seed(chip_smoke.SEED)
    for ci, co in sorted({c[:2] for k, c in calls
                          if k == "dense_rows_fwd"}):
        bound = 1.0 / ci ** 0.5
        x = torch.randn(ROWS, ci, device=dev)
        # the fused SharedMLP's layout: the Conv1d weight [Co, Ci] seen as
        # [Ci, Co]
        w = torch.empty(co, ci, device=dev).uniform_(-bound, bound).t()
        bias = torch.empty(co, device=dev).uniform_(-bound, bound)
        scale = torch.empty(ci, device=dev).uniform_(0.5, 1.5)
        shift = torch.randn(ci, device=dev) * 0.5
        g = torch.randn(ROWS, co, device=dev)
        xd, wd, bd, gd = x.double(), w.double(), bias.double(), g.double()
        sd, hd = scale.double(), shift.double()
        flops = 2.0 * ROWS * ci * co
        jobs = []
        for pro in (False, True):
            if ("dense_rows_fwd", (ci, co, pro)) not in calls:
                continue
            xa = dense_rows._act_plain(x, scale, shift, 0.0) if pro else x
            xad = dense_rows._act_plain(xd, sd, hd, 0.0) if pro else xd
            wt = w.t()

            def lib_fwd(xa=xa, wt=wt):
                y = F.linear(xa, wt, bias)
                return y, y.sum(0), (y * y).sum(0)

            yd = xad @ wd + bd
            jobs.append((
                "dense_rows_fwd", (ci, co, pro), "fwd",
                lambda pro=pro: dense_rows._forward_cuda(
                    x, w, bias, scale, shift, 0.0, pro, True),
                lib_fwd, (yd, yd.sum(0), (yd * yd).sum(0)),
                4 * (ROWS * ci + ci * co + co + ROWS * co + 2 * co)))
            jobs.append((
                "dense_rows_wgrad", (ci, co, pro), "wgrad",
                lambda pro=pro: dense_rows._wgrad_cuda(
                    x, g, scale, shift, 0.0, pro),
                lambda xa=xa: (xa.t() @ g, g.sum(0)),
                (xad.t() @ gd, gd.sum(0)),
                4 * (ROWS * ci + ROWS * co + ci * co + co)))
        if ("dense_rows_dgrad", (co, ci)) in calls:
            jobs.append((
                "dense_rows_dgrad", (co, ci), "dgrad",
                lambda: dense_rows._dgrad_cuda(g, w), lambda: g @ w.t(),
                (gd @ wd.t(),), 4 * (ROWS * co + ci * co + ROWS * ci)))
        for name, case, kind, run, lib, exact, nbytes in jobs:
            n = calls.get((name, case), 0)
            out = run()
            out = out if isinstance(out, tuple) else (out,)
            again = run()
            again = again if isinstance(again, tuple) else (again,)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(out, again))
            errs = [_err(o, e) for o, e in zip(out, exact)]
            tag = digests.add(f"{name} {case}", *out)
            del out, again
            ms, host = chip_smoke.time_ms(run), cases_util.host_ms(run)
            lib_ms = chip_smoke.time_ms(lib)
            own, rest = cases_util.device_ms(run, OWN)
            bnd, ops_ms, bytes_ms = chip_smoke._bound_ms(flops, nbytes)
            by = "ops" if ops_ms >= bytes_ms else "bytes"
            print(f"[k9] {name} {case} calls {n}: {ms:.4f} ms device "
                  f"({host:.4f} host; kernel {own:.4f}, rest {rest:.4f}), "
                  f"library {lib_ms:.4f}, bound {bnd:.4f} ({by}; "
                  f"{bnd / ms:.1%}); plan "
                  f"{_plan(dense_rows, kind, ROWS, ci, co, sms)}; max |. - "
                  f"fp64| / max|exact| {', '.join(f'{e:.3e}' for e in errs)}"
                  f"; two runs {'bitwise equal' if same else 'DIFFER'}{tag}",
                  flush=True)
            acc = per_step.setdefault(name, [0.0, 0.0, 0.0, 0.0, 0.0])
            for i, v in enumerate((ms, host, own, bnd, lib_ms)):
                acc[i] += n * v
        del x, g, xd, gd
    for name, (ms, host, own, bnd, lib_ms) in per_step.items():
        print(f"[k9] {name}: {ms:.3f} ms per step ({host:.3f} host, kernel "
              f"{own:.3f}), bound {bnd:.3f} ({bnd / ms:.1%}), library "
              f"{lib_ms:.3f}")
    digests.finish()
    if ARGS.steps:
        _switch_steps()


def _switch_steps() -> None:
    import numpy as np

    from pvcnn_tpu_torch.models.s3dis import PVCNN
    from pvcnn_tpu_torch.utils.weights import init_random_

    rng = np.random.RandomState(chip_smoke.SEED + 22)
    x, y = (torch.from_numpy(a).to("cuda")
            for a in chip_smoke.windows(rng, chip_smoke.B, chip_smoke.N3))
    base = init_random_(PVCNN(13, 6), chip_smoke.SEED)
    fused = "PVCNN_TPU_DENSE_BN_FUSED"
    every = frozenset(chip_smoke.SWITCHES)
    settings = (("default", frozenset()), (f"{fused}=auto", {fused}),
                ("opt-in", every), (f"opt-in, {fused}=0", every - {fused}))
    trainers = {name: chip_smoke._trainer(base, 1e-5) for name, _ in settings}
    ms = {name: [] for name, _ in settings}
    for _ in range(3):
        for name, on in settings:
            with chip_smoke.switches(frozenset(on)):
                ms[name].append(chip_smoke.time_ms(
                    lambda: trainers[name].train_step(x, y), reps=5,
                    warmup=1))
    for name, rounds in ms.items():
        print(f"[k9] S3DIS PVCNN 1x step, {name}: median "
              f"{statistics.median(rounds):.3f} ms, spread "
              f"{max(rounds) - min(rounds):.3f} (rounds "
              f"{', '.join(f'{v:.3f}' for v in rounds)})", flush=True)


if __name__ == "__main__":
    main()
