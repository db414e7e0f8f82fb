#!/usr/bin/env python3
"""K4 (the conv3d weight gradient, pvcnn_tpu_torch/csrc/conv3d_wgrad.cu) case
by case on one NVIDIA GPU.

    python3 k4_cases.py [--tree DIR] [--ptxas] [--sass] [--clocks]
                        [--save FILE] [--against FILE]

The cases are K4's in chip_smoke.py's CALLS, CALLS2 and CALLS3 (ShapeNet
PVCNN, S3DIS PVCNN2 and S3DIS PVCNN default training steps at B = 32), each
(Ci, Co, R, prologue) once, with its calls per step on each path. Per case
it prints the ms per call of `_wgrad_cuda` (median of CUDA events, as
chip_smoke.py times it), the device time of the call split by kernel name
(torch.profiler over 10 calls: K4's own kernels with its prologue pass,
and everything else the wrapper launches, such as a torch sum of split
partials or a layout copy),
the least time the card could take (bound), `conv3d_weight`'s ms, the
plan (tile, splits and partial-buffer bytes), and the largest difference of
K4 and of the plain version from an fp64 plain version, relative to the
largest entry of dW. Then the ms per training step
of each path.

--tree DIR imports pvcnn_tpu_torch from DIR (another checkout, such as a
parent commit unpacked with `git archive`) instead of this one; its kernels
are built under DIR/build/. --save FILE writes the SHA-256 of K4's output
at every case to FILE (JSON); --against FILE compares this tree's outputs
with such a file bit for bit. --ptxas builds the kernels with `-Xptxas -v`
and prints the registers, shared memory and spills of K4's kernels. --sass
prints the instruction mix of each K4 kernel (cuobjdump -sass of the built
library). --clocks samples the card's SM clock and power draw (nvidia-smi,
every 100 ms) while K4 runs its largest case for 2 s, and while a float32
torch.mm of 8192^3 (cuBLAS, TF32 off) runs, with that product's TFLOP/s:
the fp32 rate a tuned library reaches on this card at its power limit.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys


def _args():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=None)
    p.add_argument("--ptxas", action="store_true")
    p.add_argument("--sass", action="store_true")
    p.add_argument("--clocks", action="store_true")
    p.add_argument("--save", default=None)
    p.add_argument("--against", default=None)
    return p.parse_args()


ARGS = _args()
if ARGS.tree is not None:
    sys.path.insert(0, os.path.abspath(ARGS.tree))

import torch  # noqa: E402

import cases_util  # noqa: E402
import chip_smoke  # noqa: E402  (the case tables and the timer)


def _clocks(label, fn, seconds=2.0) -> None:
    """nvidia-smi's SM clock and power draw while fn runs back to back."""
    import time

    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    start, calls = time.perf_counter(), 0
    while time.perf_counter() - start < seconds:
        fn()
        calls += 1
        if calls % 4 == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    smi.terminate()
    rows = [tuple(float(v) for v in line.split(","))
            for line in smi.communicate()[0].splitlines() if "," in line]
    rows = rows[2:] or rows            # the first samples may predate fn
    mhz = sorted(r[0] for r in rows)
    watts = sorted(r[1] for r in rows)
    print(f"[clocks] {label}: SM clock median {mhz[len(mhz) // 2]:.0f} MHz "
          f"(min {mhz[0]:.0f}), power median {watts[len(watts) // 2]:.1f} W "
          f"over {len(rows)} samples", flush=True)


def _sgemm() -> float:
    """TFLOP/s of one float32 torch.mm at 8192^3 (TF32 off)."""
    a = torch.randn(8192, 8192, device="cuda")
    b = torch.randn(8192, 8192, device="cuda")
    ms = chip_smoke.time_ms(lambda: torch.mm(a, b), reps=10)
    _clocks("torch.mm fp32 8192^3", lambda: torch.mm(a, b))
    return 2 * 8192 ** 3 / ms / 1e9


def _parent_plan(b, ci, co, r):
    """The plan of a K4 without `_wgrad_plan` (a checkout from before it,
    run with --tree): a 128 x 64 tile and one cloud per slice of the
    partial buffer -> (tile, splits, partial bytes)."""
    tiles = math.ceil(27 * ci / 128) * math.ceil(co / 64)
    per_cloud = max(1, math.ceil(2048 / (tiles * b)))
    chunk = 16 * math.ceil(r ** 3 / per_cloud / 16)
    splits = b * math.ceil(r ** 3 / chunk)
    return "128x64", splits, 4 * splits * 27 * ci * co


def _plan(conv3d, b, ci, co, r, sms):
    if not hasattr(conv3d, "_wgrad_plan"):
        return _parent_plan(b, ci, co, r)
    plan = conv3d._wgrad_plan(b, ci, co, r, sms)
    return plan.tile, plan.splits, plan.partial_bytes


def main() -> None:
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.ops import conv3d

    if not torch.cuda.is_available():
        print("k4_cases: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    print(cases_util.smi(), flush=True)
    print(f"[k4] pvcnn_tpu_torch from {os.path.dirname(kernels.__file__)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if ARGS.ptxas:
        cases_util.ptxas(kernels, "conv3d_wgrad")
    kernels.library()
    if ARGS.sass:
        cases_util.sass(kernels, "conv3d_wgrad")
    if ARGS.clocks:
        print(f"[clocks] torch.mm fp32 8192^3: {_sgemm():.2f} TFLOP/s",
              flush=True)
    paths = (("ShapeNet", chip_smoke.CALLS), ("PVCNN2", chip_smoke.CALLS2),
             ("S3DIS", chip_smoke.CALLS3))
    cases = sorted({c for _, calls in paths for (k, c), n in calls.items()
                    if k == "conv3d_wgrad" and n})
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b = chip_smoke.B
    per_step = {name: [0.0, 0.0, 0.0] for name, _ in paths}
    digests = cases_util.Digests(ARGS.save, ARGS.against, "k4")
    torch.manual_seed(chip_smoke.SEED)
    for ci, co, r, pro in cases:
        x = torch.randn(b, ci, r ** 3, device=dev)
        gy = torch.randn(b, co, r ** 3, device=dev)
        scale = torch.empty(ci, device=dev).uniform_(0.5, 1.5)
        shift = torch.randn(ci, device=dev) * 0.5
        run = lambda: conv3d._wgrad_cuda(x, gy, scale, shift, r, pro)
        xa = conv3d.leaky_affine(x, scale, shift) if pro else x
        x5, g5 = xa.reshape(b, ci, r, r, r), gy.reshape(b, co, r, r, r)
        lib = lambda: torch.nn.grad.conv3d_weight(x5, (co, ci, 3, 3, 3), g5,
                                                  padding=1)
        dw, want = run(), conv3d._wgrad_plain(x, gy, scale, shift, r, pro)
        tag = digests.add(f"conv3d_wgrad {(ci, co, r, pro)}", dw)
        exact = conv3d._wgrad_plain(x.double(), gy.double(), scale.double(),
                                    shift.double(), r, pro)
        top = exact.abs().max().item()
        errs = ((dw - exact).abs().max().item() / top,
                (want - exact).abs().max().item() / top)
        ms, lib_ms = chip_smoke.time_ms(run), chip_smoke.time_ms(lib)
        # K4's kernels with its prologue pass, and the rest
        own, rest = cases_util.device_ms(
            run, ("conv3d_wgrad", "conv3d_prologue"))
        bound, _, _ = chip_smoke._bound_ms(
            2.0 * b * r ** 3 * 27 * ci * co,
            4 * (b * ci * r ** 3 + b * co * r ** 3 + 27 * ci * co))
        tile, splits, nbytes = _plan(conv3d, b, ci, co, r, sms)
        calls = [calls.get(("conv3d_wgrad", (ci, co, r, pro)), 0)
                 for _, calls in paths]
        print(f"[k4] ({ci}, {co}, {r}, {pro}) calls {'/'.join(map(str, calls))}"
              f": {ms:.4f} ms (device: K4 {own:.4f}, rest {rest:.4f}), "
              f"conv3d_weight {lib_ms:.4f}, bound {bound:.4f} "
              f"({bound / ms:.1%}); tile {tile}, splits {splits}, partial "
              f"{nbytes / 2 ** 20:.1f} MiB; max |. - fp64| / max|dW| K4 "
              f"{errs[0]:.3e}, plain {errs[1]:.3e}{tag}", flush=True)
        if ARGS.clocks and (ci, co, r, pro) == (64, 64, 32, False):
            _clocks(f"K4 {(ci, co, r, pro)}", run)
        for (name, _), n in zip(paths, calls):
            for i, v in enumerate((ms, bound, lib_ms)):
                per_step[name][i] += n * v
    for name, (ms, bound, lib_ms) in per_step.items():
        print(f"[k4] {name}: {ms:.3f} ms per step, bound {bound:.3f} "
              f"({bound / ms:.1%}), conv3d_weight {lib_ms:.3f}")
    digests.finish()


if __name__ == "__main__":
    main()
