#!/usr/bin/env python3
"""K11 (the NDHWC conv3d weight gradient, pvcnn_tpu_torch/csrc/
conv3d_ndhwc_wgrad.cu), K7 (ball query) and K8 (three nearest neighbours,
both pvcnn_tpu_torch/csrc/select.cu) case by case on one NVIDIA GPU.

    python3 k7_k11_cases.py [--tree DIR] [--ptxas] [--save FILE]
                            [--against FILE] [--sweep] [--sass FILE]
                            [--only k7|k8|k11]

The cases are chip_smoke.py's: K11 (Ci, Co, R) in CALLS3_ON (the S3DIS
PVCNN opt-in step, B = 32) and K7 (M, N, radius, U) in CALLS2 (the S3DIS
PVCNN2 step, on PVCNN2's FPS levels of synthetic windows, as chip_smoke.py
makes them), plus a dense cloud where every center stops at its U-th hit
(not counted per step), and K8 (N, M) in CALLS2 on the same levels and in
NN_MORE (the coming PointNet++ paths' shapes, on chip_smoke.py's clouds,
not counted per step). Per case it prints the ms per call (median of CUDA
events, as chip_smoke.py times it, and the host clock of a call ended by a
synchronize), the device time split into the kernel's own launches and
the rest (torch.profiler over 10 calls), the bound, the plan, and for K11
`conv3d_weight`'s ms, K4's ms at the same (Ci, Co, R) on channel-major
rows, and the largest difference of K11 and of the plain version from an
fp64 plain version, relative to the largest entry of dW; for K7 and K8
whether the indices (and K8's d²) equal the plain version's. Then the ms
per training step.

--tree DIR imports pvcnn_tpu_torch from DIR (another checkout, such as a
parent commit unpacked with `git archive`) instead of this one; its kernels
are built under DIR/build/. --save FILE writes the SHA-256 of the outputs
of K11, K7 and K8 (at every case) to FILE (JSON); --against FILE
compares this tree's outputs with such a file bit for bit (K4's are
k4_cases.py's). --ptxas builds the kernels with `-Xptxas -v` and prints
the registers, shared memory and spills of K11's, K7's and K8's kernels.
--sweep times K7's large case under other plans (centers per block,
splits), and every K8 case under other plans (runs of centers, threads a
block, both scans) by device time, each held to the plain version.
--sass FILE writes the SASS of K8's kernels to FILE and prints each one's
instruction mix; --only runs the named kernels' cases (repeatable; all
three by default).
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys


def _args():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=None)
    p.add_argument("--ptxas", action="store_true")
    p.add_argument("--save", default=None)
    p.add_argument("--against", default=None)
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--sass", default=None)
    p.add_argument("--only", action="append", default=[],
                   choices=("k7", "k8", "k11"))
    return p.parse_args()


ARGS = _args()
# this checkout's case tables, inputs and timer, whichever tree --tree names
import cases_util  # noqa: E402
import chip_smoke  # noqa: E402

if ARGS.tree is not None:
    sys.path.insert(0, os.path.abspath(ARGS.tree))

import numpy as np  # noqa: E402
import torch  # noqa: E402

B = chip_smoke.B


def _randn(shape, seed, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev)


def _k11(conv3d, dev, sms, digests) -> None:
    calls = chip_smoke.CALLS3_ON
    step = [0.0] * 6
    for ci, co, r in sorted(c for k, c in calls if k == "conv3d_ndhwc_wgrad"):
        n = calls[("conv3d_ndhwc_wgrad", (ci, co, r))]
        seed = 1000 * ci + 10 * co + r
        x = _randn((B, r, r, r, ci), seed, dev)
        g = _randn((B, r, r, r, co), seed + 1, dev)
        run = lambda: conv3d._ndhwc_wgrad_cuda(x, g, 3)
        dw, again = run(), run()
        same = torch.equal(dw, again)
        exact = conv3d._ndhwc_wgrad_plain(x.double(), g.double(), 3)
        want = conv3d._ndhwc_wgrad_plain(x, g, 3)
        top = exact.abs().max().item()
        e_k = (dw - exact).abs().max().item() / top
        e_p = (want - exact).abs().max().item() / top
        del exact, want, again
        tag = digests.add(f"conv3d_ndhwc_wgrad {(ci, co, r)}", dw)
        xp, gp = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
        lib = lambda: torch.nn.grad.conv3d_weight(xp, (co, ci, 3, 3, 3), gp,
                                                  padding=1)
        ms, host, lib_ms = (chip_smoke.time_ms(run), cases_util.host_ms(run),
                            chip_smoke.time_ms(lib))
        own, rest = cases_util.device_ms(run, ("conv3d_ndhwc_wgrad",))
        # K4 on the same sums, channel-major rows, no prologue
        xr = x.permute(0, 4, 1, 2, 3).reshape(B, ci, r ** 3).contiguous()
        gr = g.permute(0, 4, 1, 2, 3).reshape(B, co, r ** 3).contiguous()
        k4_ms = chip_smoke.time_ms(
            lambda: conv3d._wgrad_cuda(xr, gr, None, None, r, False))
        del xr, gr
        bound, _, _ = chip_smoke._bound_ms(
            2.0 * 27 * ci * co * B * r ** 3,
            4 * (B * r ** 3 * (ci + co) + 27 * ci * co))
        if hasattr(conv3d, "_WGRAD_BLOCKS"):
            plan = "parent: 128x64 tile, chunks of one cloud"
        else:
            p = conv3d._wgrad_plan(B, ci, co, r, sms)
            plan = (f"tile {p.tile}, z-segments of {p.seg}, {p.splits} "
                    f"split(s) of {p.per_split} slices, partial "
                    f"{p.partial_bytes} bytes, x in "
                    f"{conv3d._ndhwc_layout(ci, p)}")
        print(f"[k11] {(ci, co, r)} calls {n}: {ms:.4f} ms ({host:.4f} host;"
              f" device K11 {own:.4f}, rest {rest:.4f}), bound {bound:.4f} "
              f"({bound / ms:.1%}), K4 same shape {k4_ms:.4f}, conv3d_weight "
              f"{lib_ms:.4f}; {plan}; max |. - fp64| / max|dW| K11 "
              f"{e_k:.3e}, plain {e_p:.3e}; two runs "
              f"{'bitwise equal' if same else 'DIFFER'}{tag}", flush=True)
        for i, v in enumerate((ms, host, own, bound, k4_ms, lib_ms)):
            step[i] += n * v
        del x, g, dw
    ms, host, own, bound, k4_ms, lib_ms = step
    print(f"[k11] per S3DIS PVCNN opt-in step: {ms:.3f} ms ({host:.3f} host,"
          f" device {own:.3f}), bound {bound:.3f} ({bound / ms:.1%}), K4 "
          f"same shapes {k4_ms:.3f}, conv3d_weight {lib_ms:.3f}", flush=True)


def _levels(dev):
    """PVCNN2's point hierarchy on chip_smoke.py's windows: 8192 -> 1024
    -> 256 -> 64 -> 16 points by FPS."""
    from pvcnn_tpu_torch.ops import sampling

    x, _ = chip_smoke.windows(np.random.RandomState(chip_smoke.SEED + 10), B,
                              chip_smoke.N2)
    levels = [torch.from_numpy(x[..., :3]).to(dev)]
    for m in (1024, 256, 64, 16):
        idx = sampling._fps_cuda(levels[-1], m)
        levels.append(torch.gather(levels[-1], 1, idx.long()[..., None]
                                   .expand(-1, -1, 3)))
    return levels


def _k7_plan(neighbors, b, m, n, u, sms) -> str:
    if not hasattr(neighbors, "_ball_query_plan"):
        return "parent: a warp per center"
    return str(neighbors._ball_query_plan(b, m, n, u, sms))


def _k7(neighbors, levels, dev, sms, digests) -> None:
    calls = chip_smoke.CALLS2
    step = [0.0] * 4
    cases = []
    for level, (radius, u) in enumerate(((0.1, 32), (0.2, 32), (0.4, 32),
                                         (0.8, 32))):
        cases.append((levels[level + 1], levels[level], radius, u, False))
    # a dense cloud: every center has all N points within the radius
    pts = 0.5 + 0.01 * np.random.RandomState(chip_smoke.SEED).rand(
        B, chip_smoke.N2, 3)
    pts = torch.from_numpy(pts.astype(np.float32)).to(dev)
    cases.append((pts[:, :1024].contiguous(), pts, 0.1, 32, True))
    for ctr, pts, radius, u, dense in cases:
        m, n = ctr.shape[1], pts.shape[1]
        case = (m, n, radius, u)
        r2 = neighbors._fp32(radius ** 2)
        run = lambda: neighbors._ball_query_cuda(ctr, pts, r2, u)
        got = run()
        exact = torch.equal(got, neighbors._ball_query_plain(ctr, pts, r2, u))
        same = torch.equal(got, run())
        name = f"ball_query {case}{' dense' if dense else ''}"
        tag = digests.add(name, got)
        full = got[..., u - 1] != got[..., 0]
        scanned = float(torch.where(full, got[..., u - 1].long() + 1, n).sum())
        bound, _, _ = chip_smoke._bound_ms(
            9.0 * scanned, 4 * (B * m * 3 + B * n * 3 + B * m * u))
        ms, host = chip_smoke.time_ms(run), cases_util.host_ms(run)
        own, rest = cases_util.device_ms(run, ("ball_query",))
        calls_n = 0 if dense else calls[("ball_query", case)]
        print(f"[k7] {name} calls {calls_n}: {ms:.4f} ms ({host:.4f} host; "
              f"device K7 {own:.4f}, rest {rest:.4f}), bound {bound:.4f} "
              f"({bound / ms:.1%}; {scanned / (B * m * n):.3f} of the "
              f"points scanned); plan "
              f"{_k7_plan(neighbors, B, m, n, u, sms)}; indices "
              f"{'equal' if exact else 'DIFFER FROM'} the plain version's; "
              f"two runs {'bitwise equal' if same else 'DIFFER'}{tag}",
              flush=True)
        for i, v in enumerate((ms, host, own, bound)):
            step[i] += calls_n * v
    ms, host, own, bound = step
    print(f"[k7] per S3DIS PVCNN2 step: {ms:.3f} ms ({host:.3f} host, device"
          f" {own:.3f}), bound {bound:.3f}", flush=True)
    if ARGS.sweep:
        ctr, pts = levels[1], levels[0]
        r2 = neighbors._fp32(0.01)
        want = neighbors._ball_query_plain(ctr, pts, r2, 32)
        chosen = neighbors._ball_query_plan
        run = lambda: neighbors._ball_query_cuda(ctr, pts, r2, 32)
        for threads in (32, 64, 128, 256):
            for per_split in (256, 512, 1024, 1792, 2048, 4096, 8192):
                splits = -(-8192 // per_split)
                plan = neighbors.BallQueryPlan(threads, splits, per_split)
                neighbors._ball_query_plan = lambda *a: plan
                ok = torch.equal(run(), want)
                own, _ = cases_util.device_ms(run, ("ball_query",))
                print(f"[k7 sweep] {plan}: {chip_smoke.time_ms(run):.4f} ms"
                      f" (device {own:.4f}); indices "
                      f"{'equal' if ok else 'DIFFER'}", flush=True)
        neighbors._ball_query_plan = chosen


def _k8_cases(levels, dev):
    """(N, M, queries, centers, calls per PVCNN2 step): PVCNN2's four
    levels, then chip_smoke.py's NN_MORE inputs."""
    cases = [(levels[i].shape[1], levels[i + 1].shape[1], levels[i],
              levels[i + 1], 1) for i in range(4)]
    cases += [(n, m, pts, ctr, 0)
              for (n, m), pts, ctr in chip_smoke.nn_more_inputs(dev)]
    return cases


def _k8_plan(interpolate, n, m, sms) -> str:
    if not hasattr(interpolate, "_three_nn_plan"):
        return "parent: a thread per query, 256 a block"
    return str(interpolate._three_nn_plan(B, n, m, sms))


def _k8(interpolate, levels, dev, sms, digests) -> None:
    step = [0.0] * 4
    for n, m, pts, ctr, calls_n in _k8_cases(levels, dev):
        run = lambda: interpolate._three_nn_cuda(pts, ctr)
        idx, d2 = run()
        want_idx, want_d2 = interpolate._three_nn_plain(pts, ctr)
        exact = torch.equal(idx, want_idx) and torch.equal(d2, want_d2)
        again = run()
        same = torch.equal(idx, again[0]) and torch.equal(d2, again[1])
        name = f"three_nn {(n, m)}" + ("" if calls_n else " more")
        tag = digests.add(name, idx, d2)
        bound, _, _ = chip_smoke._bound_ms(
            9.0 * B * n * m, 4 * (B * n * 3 + B * m * 3 + 2 * B * n * 3))
        ms, host = chip_smoke.time_ms(run), cases_util.host_ms(run)
        own, rest = cases_util.device_ms(run, ("three_nn",))
        print(f"[k8] {name} calls {calls_n}: {ms:.4f} ms ({host:.4f} host; "
              f"device K8 {own:.4f}, rest {rest:.4f}), bound {bound:.4f} "
              f"({bound / own:.1%} by device, {bound / ms:.1%} by events); "
              f"plan {_k8_plan(interpolate, n, m, sms)}; indices and d² "
              f"{'equal' if exact else 'DIFFER FROM'} the plain version's; "
              f"two runs {'bitwise equal' if same else 'DIFFER'}{tag}",
              flush=True)
        for i, v in enumerate((ms, host, own, bound)):
            step[i] += calls_n * v
        if ARGS.sweep and hasattr(interpolate, "_three_nn_plan"):
            _k8_sweep(interpolate, n, m, run, want_idx, want_d2)
    ms, host, own, bound = step
    print(f"[k8] per S3DIS PVCNN2 step: {ms:.3f} ms ({host:.3f} host, device"
          f" {own:.3f}), bound {bound:.3f} ({bound / own:.1%} by device)",
          flush=True)


def _k8_sweep(interpolate, n, m, run, want_idx, want_d2) -> None:
    """K8 at (N, M) under every plan the kernel takes with 1-8 runs, 64-256
    threads a block and both scans (a branch a pair, hit masks), by device
    time."""
    chosen = interpolate._three_nn_plan
    for runs, masks in itertools.product((1, 2, 4, 8), (False, True)):
        per_run = max(1, -(-m // runs))
        if (runs - 1) * per_run >= max(m, 1):
            continue
        for threads in sorted({64, 128, 256, 32 * runs}):
            if threads < 32 * runs:
                continue
            plan = interpolate.ThreeNNPlan(runs, per_run, threads, masks)
            interpolate._three_nn_plan = lambda *a: plan
            idx, d2 = run()
            ok = torch.equal(idx, want_idx) and torch.equal(d2, want_d2)
            own, _ = cases_util.device_ms(run, ("three_nn",))
            print(f"[k8 sweep] {(n, m)} {plan}: device {own:.4f} ms; "
                  f"{'equal' if ok else 'DIFFER'}", flush=True)
    interpolate._three_nn_plan = chosen


def main() -> None:
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.ops import conv3d, interpolate, neighbors

    if not torch.cuda.is_available():
        print("k7_k11_cases: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    print(cases_util.smi(), flush=True)
    print(f"[k7k11] pvcnn_tpu_torch from {os.path.dirname(kernels.__file__)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if ARGS.ptxas:
        cases_util.ptxas(kernels, "conv3d_wgrad", "conv3d_ndhwc_wgrad",
                         "ball_query", "three_nn")
    if ARGS.sass:
        cases_util.sass(kernels, "three_nn", path=ARGS.sass)
    kernels.library()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    digests = cases_util.Digests(ARGS.save, ARGS.against, "k7k11")
    only = set(ARGS.only) or {"k7", "k8", "k11"}
    levels = _levels(dev)
    if "k7" in only:
        _k7(neighbors, levels, dev, sms, digests)
    if "k8" in only:
        _k8(interpolate, levels, dev, sms, digests)
    if "k11" in only:
        _k11(conv3d, dev, sms, digests)
    digests.finish()


if __name__ == "__main__":
    main()
