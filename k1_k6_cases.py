#!/usr/bin/env python3
"""K1 (the scatter-mean and its sum mode, pvcnn_tpu_torch/csrc/voxelize.cu)
and K6 (FPS, pvcnn_tpu_torch/csrc/fps.cu) case by case on one NVIDIA GPU.

    python3 k1_k6_cases.py [--tree DIR] [--save FILE] [--against FILE]
                           [--ptxas] [--sweep]

The cases are chip_smoke.py's: K1 channel-major (C, R, N) in CALLS, CALLS2
and CALLS3 (ShapeNet PVCNN, S3DIS PVCNN2, S3DIS PVCNN default training
steps at B = 32), K1 channel-last in CALLS3_ON (the opt-in path), K1's sum
mode (K rows, bins, C) and K6 (N, M) in CALLS2, on inputs made from seeds
(PVCNN2's levels, groupings and interpolations by its own FPS, ball-query
and three-NN kernels, as chip_smoke.py makes them). Per case it prints the
ms per call of the public op (median of CUDA events, as chip_smoke.py
times it; K1's mean with a features tensor that requires grad, as in
training, so that the counts it saves are timed too), its device time split
into the sort glue, the kernel and the rest (torch.profiler over 10 calls),
the bound, and K1's longest run; then the ms per training step of each path.

--tree DIR imports pvcnn_tpu_torch from DIR (another checkout, such as a
parent commit unpacked with `git archive`) instead of this one; its kernels
are built under DIR/build/. --save FILE writes the SHA-256 of every K1
output and of K6's indices to FILE (JSON); --against FILE compares this
tree's outputs with such a file bit for bit. --ptxas builds the kernels
with `-Xptxas -v` and prints the registers, shared memory and spills of
K1's and K6's kernels. --sweep times K6 under each plan (cluster, threads, points per
thread) that holds the case's cloud, with its chain floor (the kernel's
argmax and exchange alone, `_fps_cuda(..., chain_only=True)`) and its
indices held to the plain version's.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def _args():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=None)
    p.add_argument("--save", default=None)
    p.add_argument("--against", default=None)
    p.add_argument("--ptxas", action="store_true")
    p.add_argument("--sweep", action="store_true")
    return p.parse_args()


ARGS = _args()
if ARGS.tree is not None:
    sys.path.insert(0, os.path.abspath(ARGS.tree))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402  (the case tables, inputs and the timer)

B, SEED = chip_smoke.B, chip_smoke.SEED
PATHS = (("ShapeNet", chip_smoke.CALLS), ("PVCNN2", chip_smoke.CALLS2),
         ("S3DIS", chip_smoke.CALLS3), ("S3DIS opt-in", chip_smoke.CALLS3_ON))
# K6's plans for --sweep: (cluster, threads, points per thread)
SWEEP = [(cs, t, p) for cs in (1, 2, 4, 8)
         for t in (32, 64, 128, 256, 512, 1024) for p in (0, 1, 2, 4, 8, 16)
         if t <= (512 if p == 16 else 1024)]


def _ptxas(kernels) -> None:
    _, _, log = kernels.build(("-Xptxas", "-v"))
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and (
                "voxelize" in line or "fps" in line):
            print("[ptxas]", line.strip())
            for nxt in lines[i + 1:i + 5]:
                if "Compiling entry" in nxt:
                    break
                print("[ptxas]   ", nxt.strip())


def _device(fn, reps=10):
    """(sort glue, kernel, rest) in ms of device time per call: glue is any
    kernel with "sort" or "radix" in its name, kernel K1's or K6's own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    glue = own = rest = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3 / reps
        key = evt.key.lower()
        if "sort" in key or "radix" in key:
            glue += ms
        elif "avg_voxelize" in key or "fps_kernel" in key:
            own += ms
        else:
            rest += ms
    return glue, own, rest


def _levels(dev):
    """PVCNN2's FPS levels of one batch of windows (8192 -> 16 points), and
    the take_rows index sets of its 4 SA groupings and 4 FP
    interpolations, as chip_smoke.phase_pvcnn2_kernels makes them."""
    from pvcnn_tpu_torch.ops import interpolate, neighbors, sampling

    x, _ = chip_smoke.windows(np.random.RandomState(SEED + 10), B,
                              chip_smoke.N2)
    levels = [torch.from_numpy(x[..., :3]).to(dev)]
    for m in (1024, 256, 64, 16):
        idx = sampling.furthest_point_sample_indices(levels[-1], m)
        levels.append(torch.gather(levels[-1], 1, idx.long()[..., None]
                                   .expand(-1, -1, 3)))
    sa_c, fp_c = (32, 64, 128, 256), (128, 256, 256, 512)
    sources = []
    for level, radius in enumerate((0.1, 0.2, 0.4, 0.8)):
        pts, ctr = levels[level], levels[level + 1]
        r2 = neighbors._fp32(radius ** 2)
        got = neighbors._ball_query_cuda(ctr, pts, r2, 32)
        sources.append((got.reshape(B, -1), pts.shape[1], sa_c[level]))
    for level in range(4):
        pts, ctr = levels[level], levels[level + 1]
        idx, _ = interpolate._three_nn_cuda(pts, ctr)
        sources.append((idx.reshape(B, -1), ctr.shape[1], fp_c[level]))
    return levels, sources


def _k1_cases(dev, levels, sources):
    """-> [(label, case, path, ids, bins, C, rows, run)] of every K1
    case."""
    from pvcnn_tpu_torch import ops
    from pvcnn_tpu_torch.ops import voxelize

    shapenet = torch.from_numpy(chip_smoke.cloud(
        np.random.RandomState(SEED), B, chip_smoke.N)[..., :3]).to(dev)
    x, _ = chip_smoke.windows(np.random.RandomState(SEED + 20), B,
                              chip_smoke.N3)
    s3dis = torch.from_numpy(x[..., :3]).to(dev)
    by_n = {t.shape[1]: t for t in levels}
    coords = {"ShapeNet": (lambda n: shapenet[:, :n], False),
              "PVCNN2": (lambda n: by_n[n], True),
              "S3DIS": (lambda n: s3dis[:, :n], True),
              "S3DIS opt-in": (lambda n: s3dis[:, :n], True)}
    out = []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for name, calls in PATHS:
        coords_of, normalize = coords[name]
        cf = name != "S3DIS opt-in"
        for c, r, n in sorted(case for k, case in calls
                              if k == "avg_voxelize"):
            vox, _ = ops.normalize_coords(coords_of(n), r,
                                          normalize=normalize)
            flat = ops.flat_voxel_index(vox, r)
            feats = torch.randn(B, n, c, device=dev, generator=gen)
            feats.requires_grad_(True)
            run = (lambda f=feats, i=flat, bins=r ** 3, cf=cf:
                   voxelize.scatter_mean(f, i, bins, cf).detach())
            label = ("avg_voxelize channel-major" if cf
                     else "avg_voxelize channel-last")
            out.append((label, (c, r, n), name, flat, r ** 3, c, n, run))
    for idx, bins, c in sources:
        k = idx.shape[1]
        values = torch.randn(B, k, c, device=dev, generator=gen)
        run = (lambda v=values, i=idx, bins=bins:
               voxelize.scatter_sum(v, i, bins))
        out.append(("scatter_sum", (k, bins, c), "PVCNN2", idx, bins, c, k,
                    run))
    return out


def _digest(saved, against, key, out) -> str:
    """Record out's SHA-256 under key; -> how it compares with `against`."""
    saved[key] = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
    if against is None:
        return ""
    same = against.get(key) == saved[key]
    return f"; {'bitwise equal to' if same else 'DIFFERS from'} {ARGS.against}"


def _sweep(sampling, pts, m) -> None:
    """K6 under each plan that holds the cloud (registers at most twice
    what it needs, or streaming above 8,192 points): ms, device time,
    chain floor, indices against the plain version's."""
    n = pts.shape[1]
    want = sampling._fps_plain(pts, m)
    print(f"[sweep] ({n}, {m}) plan {sampling._fps_plan(n)}", flush=True)
    for plan in SWEEP:
        cs, t, p = plan
        if not (n <= cs * t * p < 2 * max(n, 32)
                or (p == 0 and n > 8192 and t >= 512)):
            continue
        k_run = lambda: sampling._fps_cuda(pts, m, plan)
        c_run = lambda: sampling._fps_cuda(pts, m, plan, chain_only=True)
        try:
            ok = torch.equal(k_run(), want)
        except RuntimeError as err:          # a launch the card refused
            print(f"[sweep] ({n}, {m}) {plan}: {err}", flush=True)
            continue
        k_ms, c_ms = chip_smoke.time_ms(k_run), chip_smoke.time_ms(c_run)
        _, k_dev, _ = _device(k_run)
        _, c_dev, _ = _device(c_run)
        print(f"[sweep] ({n}, {m}) {plan}: {k_ms:.4f} ms (device "
              f"{k_dev:.4f}), chain floor {c_ms:.4f} ms (device "
              f"{c_dev:.4f}){'' if ok else ', INDICES DIFFER'}", flush=True)


def _calls(label, case, path):
    kernel = "scatter_sum" if label == "scatter_sum" else "avg_voxelize"
    return dict(PATHS)[path].get((kernel, case), 0)


def main() -> None:
    from pvcnn_tpu_torch import kernels
    from pvcnn_tpu_torch.ops import sampling

    if not torch.cuda.is_available():
        print("k1_k6_cases: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"[cases] pvcnn_tpu_torch from {os.path.dirname(kernels.__file__)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if ARGS.ptxas:
        _ptxas(kernels)
    kernels.library()
    dev = torch.device("cuda")
    levels, sources = _levels(dev)
    saved = {}
    against = None
    if ARGS.against:
        with open(ARGS.against) as f:
            against = json.load(f)
    per_step = {}

    for label, case, path, idx, bins, c, n, run in _k1_cases(dev, levels,
                                                             sources):
        got, again = run(), run()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{label} {case}: two runs differ")
        same = _digest(saved, against, f"{path} {label} {case}", got)
        ms = chip_smoke.time_ms(run)
        glue, own, rest = _device(run)
        bound, _, _ = chip_smoke._bound_ms(B * n * c, 4 * (
            B * n * c + B * n + B * bins * c))
        offset = torch.arange(B, device=dev)[:, None] * bins
        longest = int(torch.bincount((idx.long() + offset).reshape(-1)).max())
        calls = _calls(label, case, path)
        print(f"[k1] {path} {label} {case} x{calls}: {ms:.4f} ms (device: "
              f"glue {glue:.4f}, kernel {own:.4f}, rest {rest:.4f}), bound "
              f"{bound:.4f}; longest run {longest}{same}", flush=True)
        acc = per_step.setdefault(f"{path} {label}", [0.0] * 5)
        for i, v in enumerate((ms, glue, own, rest, bound)):
            acc[i] += calls * v

    for n, m in ((8192, 1024), (1024, 256), (256, 64), (64, 16)):
        pts = next(t for t in levels if t.shape[1] == n)
        run = lambda: sampling.furthest_point_sample_indices(pts, m)
        same = _digest(saved, against, f"fps {(n, m)}", run())
        ms = chip_smoke.time_ms(run)
        _, own, rest = _device(run)
        bound, _, _ = chip_smoke._bound_ms(10.0 * B * n * (m - 1),
                                           4 * (B * n * 3 + B * m))
        print(f"[k6] ({n}, {m}): {ms:.4f} ms (device: kernel {own:.4f}, rest "
              f"{rest:.4f}), FLOP bound {bound:.4f}{same}", flush=True)
        acc = per_step.setdefault("PVCNN2 fps", [0.0] * 5)
        for i, v in enumerate((ms, 0.0, own, rest, bound)):
            acc[i] += v
        if ARGS.sweep:
            _sweep(sampling, pts, m)
    if ARGS.sweep:
        # clouds above one block's registers: clusters, or streaming
        x, _ = chip_smoke.windows(np.random.RandomState(SEED + 30), B, 70000)
        for n in (16384, 40000, 70000):
            _sweep(sampling, torch.from_numpy(x[:, :n, :3]).to(dev), 128)

    for name, (ms, glue, own, rest, bound) in per_step.items():
        print(f"[step] {name}: {ms:.4f} ms per step (device: glue "
              f"{glue:.4f}, kernel {own:.4f}, rest {rest:.4f}), bound "
              f"{bound:.4f}", flush=True)
    if ARGS.save:
        with open(ARGS.save, "w") as f:
            json.dump(saved, f, indent=0)


if __name__ == "__main__":
    main()
