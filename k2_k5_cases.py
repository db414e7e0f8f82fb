#!/usr/bin/env python3
"""K2 (the trilinear gather, pvcnn_tpu_torch/csrc/devoxelize.cu) and K5 (its
grid gradient, pvcnn_tpu_torch/csrc/devoxelize_bwd.cu) in bf16, case by
case on one NVIDIA GPU.

    python3 k2_k5_cases.py [--tree DIR] [--save FILE] [--against FILE]
                           [--ptxas] [--sass FILE]

The cases are chip_smoke.py's: the (C, R, N) of K2's and K5's bf16 modes
in CALLS_BF16 (ShapeNet PVCNN 1x, B = 32), CALLS_BF16_QUARTER (0.25x, B =
64), CALLS2_BF16 (S3DIS PVCNN2 1x, on its FPS levels), CALLS3_BF16 (S3DIS
PVCNN 1x) and CALLS3_ON_BF16 (S3DIS PVCNN 1x's opt-in step, on phase 31's
clouds), on chip_smoke.py's clouds normalized as the PVConvs normalize
them, each on a channel-major grid [B, C, R^3] (the rows branch) and on a
channel-last one [B, R^3, C] (the NDHWC branch); the opt-in step runs the
channel-last modes alone, so only those are timed there (the
channel-major outputs are computed for the comparisons). Grids and
cotangents from a generator seeded per case. Per case it prints the ms
per call of the op (median of CUDA events, as chip_smoke.py times it),
K5's glue (the sort) and the kernel alone, timed apart, the device time
per call (torch.profiler over 10 calls: glue, kernel, rest), the bound
(bf16 operations over 989 TFLOP/s or bytes over 3.35 TB/s, the larger;
K2's bytes count only the grid rows its points' corners touch,
chip_smoke._k2_bytes)
and the share of it reached, by the call's ms and by the kernel's device
time; every output twice bitwise equal, and the two layouts bitwise equal
to each other (transposed). Then the ms per training step of each path,
layout and kernel: by the host clock, K5's glue and kernel alone, the
device time, and the bound with the share of it reached by each.

--tree DIR imports pvcnn_tpu_torch from DIR (another checkout, such as a
parent commit unpacked with `git archive`) instead of this one; its
kernels are built under DIR/build/, and the case tables and inputs still
come from this checkout's chip_smoke.py. --save FILE writes the SHA-256 of
every output to FILE (JSON); --against FILE compares this tree's outputs
with such a file bit for bit. --ptxas builds the kernels with `-Xptxas -v`
and prints the registers, shared memory and spills of K2's and K5's
kernels. --sass FILE writes, as JSON, the nvcc release and the digests of
the SASS of the kernels whose names hold one of chip_smoke.DEVOX_KEEP
(`cases_util.sass_digests`, named by chip_smoke._sass_name), which
chip_smoke.py holds to the digests it records (DEVOX_SASS): the fp32 K2 /
K5 kernels, K5's sort, the bf16 brick kernels of K2 and K5 and the
channel-last bf16 K2's lanes-over-groups kernel.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
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

cases_util = _here("cases_util")
chip_smoke = _here("chip_smoke")   # the case tables, clouds and the timer

B, SEED = chip_smoke.B, chip_smoke.SEED
# (path, calls, clouds, the layouts its step runs and that are timed)
BOTH = (True, False)
PATHS = (("ShapeNet 1x", chip_smoke.CALLS_BF16, B, BOTH),
         ("ShapeNet 0.25x", chip_smoke.CALLS_BF16_QUARTER, 2 * B, BOTH),
         ("PVCNN2", chip_smoke.CALLS2_BF16, B, BOTH),
         ("S3DIS", chip_smoke.CALLS3_BF16, B, BOTH),
         ("S3DIS opt-in", chip_smoke.CALLS3_ON_BF16, B, (False,)))
K2, K5 = "trilinear_devoxelize_bf16", "devoxelize_bwd_bf16"


def _clouds(dev):
    """{path: (coords of n points -> [b, n, 3], normalize)} as
    chip_smoke.py's phases 29, 30 and 31 make them."""
    shapenet = {}
    rng = np.random.RandomState(SEED + 100)
    for label, b in (("ShapeNet 1x", B), ("ShapeNet 0.25x", 2 * B)):
        shapenet[label] = torch.from_numpy(chip_smoke.cloud(
            rng, b, chip_smoke.N)[..., :3]).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x, _ = chip_smoke.windows(np.random.RandomState(SEED + 111), B,
                              chip_smoke.N2)
    _, by_n = chip_smoke._take_rows_indices(
        torch.from_numpy(x[..., :3]).to(dev), chip_smoke.CALLS2_BF16, sms)
    x, _ = chip_smoke.windows(np.random.RandomState(SEED + 112), B,
                              chip_smoke.N3)
    s3dis = torch.from_numpy(x[..., :3]).to(dev)
    x, _ = chip_smoke.windows(np.random.RandomState(SEED + 131), B,
                              chip_smoke.N3)
    optin = torch.from_numpy(x[..., :3]).to(dev)
    return {"ShapeNet 1x": (lambda n: shapenet["ShapeNet 1x"][:, :n], False),
            "ShapeNet 0.25x": (lambda n: shapenet["ShapeNet 0.25x"][:, :n],
                               False),
            "PVCNN2": (lambda n: by_n[n], True),
            "S3DIS": (lambda n: s3dis[:, :n], True),
            "S3DIS opt-in": (lambda n: optin[:, :n], True)}


def _device(fn):
    """(glue, kernel, rest) ms of device time per call: the sort, K2's or
    K5's own kernel, anything else."""
    return cases_util.device_ms(fn, ("sort",), ("devoxelize",))


def _sass(path) -> None:
    from pvcnn_tpu_torch import kernels

    lib_path, _, _ = kernels.build()
    record = {"nvcc": cases_util.nvcc_version(),
              "digests": {chip_smoke._sass_name(n): d for n, d in
                          cases_util.sass_digests(
                              lib_path, chip_smoke.DEVOX_KEEP).items()}}
    with open(path, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    print(f"[sass] {len(record['digests'])} kernels' SASS digests "
          f"({record['nvcc']}) written to {path}", flush=True)


def main() -> None:
    from pvcnn_tpu_torch import kernels, ops
    from pvcnn_tpu_torch.ops import devoxelize

    if not torch.cuda.is_available():
        print("k2_k5_cases: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    print(cases_util.smi(), flush=True)
    print(f"[cases] pvcnn_tpu_torch from {os.path.dirname(kernels.__file__)}")
    if ARGS.ptxas:
        cases_util.ptxas(kernels, "devoxelize")
    kernels.library()
    if ARGS.sass:
        _sass(ARGS.sass)
    dev, bf = torch.device("cuda"), torch.bfloat16
    clouds = _clouds(dev)
    digests = cases_util.Digests(ARGS.save, ARGS.against, "cases")
    per_step = {}
    peak = chip_smoke.PEAK_BF16_FLOPS

    def add(key, calls, values):
        acc = per_step.setdefault(key, [0.0] * len(values))
        for i, v in enumerate(values):
            acc[i] += calls * v

    for path, calls, b, timed in PATHS:
        coords_of, normalize = clouds[path]
        for c, r, n in sorted({case for k, case in calls if k == K2}):
            case = (c, r, n)
            _, norm = ops.normalize_coords(coords_of(n), r,
                                           normalize=normalize)
            gen = torch.Generator(device=dev).manual_seed(
                zlib.crc32(f"{path} {case}".encode()))
            grid = torch.randn(b, c, r ** 3, device=dev, generator=gen).to(bf)
            g = torch.randn(b, n, c, device=dev, generator=gen).to(bf)
            # K5 writes the whole grid; K2 reads only the rows its points'
            # corners touch
            bounds_ms = {
                K2: chip_smoke._bound_ms(
                    16 * b * n * c, chip_smoke._k2_bytes(norm, r, c, 2),
                    peak)[0],
                K5: chip_smoke._bound_ms(
                    16 * b * n * c,
                    2 * b * c * r ** 3 + 12 * b * n + 2 * b * n * c,
                    peak)[0]}
            points, bounds = devoxelize._sort_points(norm, r)
            outs = {}
            for cf in (True, False):
                layout = "channel-major" if cf else "channel-last"
                grid_l = grid if cf else grid.transpose(1, 2).contiguous()
                for kernel, run, alone in (
                        (K2, lambda: devoxelize._devoxelize_cuda(
                            grid_l, norm, r, cf), None),
                        (K5, lambda: devoxelize._devoxelize_bwd_cuda(
                            g, norm, r, cf),
                         lambda: devoxelize._launch_k5_sorted(
                             g, points, bounds, r, cf))):
                    got, again = run(), run()
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(f"{path} {layout} {kernel} "
                                             f"{case}: two runs differ")
                    outs[kernel, cf] = got
                    same = digests.add(f"{path} {layout} {kernel} {case}",
                                       got)
                    if cf not in timed:
                        print(f"[{kernel}] {path} {layout} {case}: not "
                              f"timed (the step runs the other layout)"
                              f"{same}", flush=True)
                        continue
                    ms = chip_smoke.time_ms(run)
                    bound = bounds_ms[kernel]
                    glue, own, rest = _device(run)
                    split = ""
                    glue_ms = alone_ms = 0.0
                    if alone is not None:
                        glue_ms = chip_smoke.time_ms(
                            lambda: devoxelize._sort_points(norm, r))
                        alone_ms = chip_smoke.time_ms(alone)
                        split = (f" (glue {glue_ms:.4f}, kernel alone "
                                 f"{alone_ms:.4f}: {bound / alone_ms:.1%})")
                    n_calls = calls.get((kernel, case), 0)
                    print(f"[{kernel}] {path} {layout} {case} x{n_calls}: "
                          f"{ms:.4f} ms{split} (device: glue {glue:.4f}, "
                          f"kernel {own:.4f}, rest {rest:.4f}), bound "
                          f"{bound:.4f}: {bound / ms:.1%} by ms, "
                          f"{bound / max(own, 1e-9):.1%} by device{same}",
                          flush=True)
                    add(f"{path} {layout} {kernel}", n_calls,
                        (ms, glue_ms, alone_ms, glue, own, bound))
            for kernel, dims in ((K2, None), (K5, (0, 2, 1))):
                last = outs[kernel, False]
                last = last if dims is None else last.permute(*dims)
                if not torch.equal(outs[kernel, True], last):
                    raise AssertionError(f"{path} {kernel} {case}: the "
                                         "layouts differ")

    for name, (ms, glue_ms, alone_ms, glue, own, bound) in per_step.items():
        split = (f" (glue {glue_ms:.4f}, kernel alone {alone_ms:.4f}: "
                 f"{bound / alone_ms:.1%})" if alone_ms else "")
        print(f"[step] {name}: {ms:.4f} ms per step{split} (device: glue "
              f"{glue:.4f}, kernel {own:.4f}: {bound / max(own, 1e-9):.1%}),"
              f" bound {bound:.4f}: {bound / ms:.1%} by ms", flush=True)
    digests.finish()


if __name__ == "__main__":
    main()
