"""What the per-case scripts (k1_k6_cases.py, k2_k5_cases.py, k4_cases.py,
k7_k11_cases.py, k9_k10_cases.py, k9_k11_bf16_cases.py,
k10_k1_bf16_cases.py) share: the card's name and power limit,
ptxas's log, the SASS instruction mix of chosen kernels and digests of
their SASS, host-clock and profiler timings of one call, and output
digests that compare two trees bit for bit.

Each script imports this module after its `--tree` has put another
checkout first on sys.path; this module imports nothing of the package.

Run as a script, it compares the SASS of every kernel of two built kernel
libraries (addresses and encodings stripped, names demangled without
their parameter lists):

    python3 cases_util.py --sass-diff NEW.so OLD.so

or builds this checkout's kernel sources at two paths of different names
and depths under build/ and compares what each compile gives, source by
source: the PTX (nvcc -ptx), then the objects' SASS kernel by kernel and
their ELF sections (cuobjdump -elf), each as kernels/__init__.py's build
compiles it and as the same compile from the source's own directory with
relative names, and the same compile twice at one path; or compiles each
source to PTX RUNS times at one path and counts the distinct texts:

    python3 cases_util.py --build-paths
    python3 cases_util.py --build-repeat RUNS

(The path reaches a compile only through the anonymous namespace's tag
in mangled names, which --sass-diff's demangling drops; nvcc's PTX of a
few sources differs from one compile to the next at one path, so one
kernel's SASS may differ between two builds of one tree: PERF.md,
section 7.) The two build experiments import the package's kernels
module for nvcc and its flags.
"""

from __future__ import annotations

import collections
import hashlib
import os
import json
import statistics
import subprocess
import time

import torch


def smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas(kernels, *keys) -> None:
    """Build the kernels with `-Xptxas -v` and print the registers, shared
    memory and spills of each kernel whose name holds one of keys."""
    _, _, log = kernels.build(("-Xptxas", "-v"))
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and any(k in line
                                                      for k in keys):
            print("[ptxas]", line.strip())
            for nxt in lines[i + 1:i + 5]:
                if "Compiling entry" in nxt:
                    break
                print("[ptxas]   ", nxt.strip())


def sass(kernels, *keys, path=None) -> None:
    """Print the instruction mix (cuobjdump -sass of the built library) of
    each kernel whose name holds one of keys: its count, its most common
    opcodes, its local loads and stores (spills) and, where it has FFMAs,
    the mix from its first FFMA to its last. path, if given, receives
    those kernels' SASS."""
    from torch.utils.cpp_extension import CUDA_HOME

    lib_path, _, _ = kernels.build()
    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                          "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True).stdout
    keep, name, ops = [], None, []

    def mix(seq):
        return ", ".join(f"{op} {n}" for op, n in
                         collections.Counter(seq).most_common(10))

    def report():
        if name is None or not any(k in name for k in keys):
            return
        print(f"[sass] {name[:90]}: {len(ops)} instructions: {mix(ops)}; "
              f"LDL {ops.count('LDL')}, STL {ops.count('STL')}", flush=True)
        if "FFMA" in ops:
            first = ops.index("FFMA")
            last = len(ops) - 1 - ops[::-1].index("FFMA")
            span = ops[first:last + 1]
            print(f"[sass]   first to last FFMA: {len(span)} instructions: "
                  f"{mix(span)}", flush=True)

    for line in out.splitlines():
        if "Function :" in line:
            report()
            name, ops = line.split("Function :")[1].strip(), []
        if name is None or not any(k in name for k in keys):
            continue
        keep.append(line)
        if "/*" in line and ";" in line and "*/" in line:
            body = line.split("*/", 1)[1].strip()
            if body.startswith("@"):
                body = body.split(None, 1)[1]
            ops.append(body.split()[0].split(".")[0].rstrip(";"))
    report()
    if path is not None:
        with open(path, "w") as f:
            f.write("\n".join(keep))


def host_ms(fn, reps=20) -> float:
    """Median host-clock ms of one call ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def device_ms(fn, *groups, reps=10) -> list:
    """ms of device time per call by kernel name (torch.profiler over reps
    calls): one sum for each group of name parts (a kernel counts under the
    first group one of whose parts its lower-cased name holds), then the
    rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    sums = [0.0] * (len(groups) + 1)
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        key = evt.key.lower()
        at = next((i for i, parts in enumerate(groups)
                   if any(p in key for p in parts)), len(groups))
        sums[at] += evt.self_device_time_total / 1e3 / reps
    return sums


class Digests:
    """SHA-256 of each output; --save writes them to a JSON file, --against
    compares this tree's with such a file."""

    def __init__(self, save=None, against=None, label="cases"):
        self.save, self.label, self.saved = save, label, {}
        self.theirs = None
        if against:
            with open(against) as f:
                self.theirs = json.load(f)

    def add(self, key, *tensors) -> str:
        """Record the outputs' digest under key; -> how it compares with
        the saved tree's ("" without one)."""
        h = hashlib.sha256()
        for t in tensors:
            if t.dtype == torch.bfloat16:       # numpy has no bf16: its bits
                t = t.view(torch.int16)
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        self.saved[key] = h.hexdigest()
        if self.theirs is None:
            return ""
        same = self.theirs.get(key) == self.saved[key]
        return ("; bitwise equal against the saved tree" if same
                else "; DIFFERS against the saved tree")

    def finish(self) -> None:
        if self.save:
            with open(self.save, "w") as f:
                json.dump(self.saved, f, indent=1)
            print(f"[{self.label}] {len(self.saved)} output digests written "
                  f"to {self.save}")
        if self.theirs is not None:
            same = sum(self.theirs.get(k) == v for k, v in self.saved.items())
            print(f"[{self.label}] {same} of {len(self.saved)} outputs "
                  "bitwise equal against the saved tree")


def sass_functions(lib_path) -> dict:
    """{demangled kernel name without its parameters: its SASS lines, with
    addresses and encodings stripped} of a built kernel library."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                          "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name and "/*" in line and ";" in line:
            body = re.sub(r"^\s*/\*[0-9a-f]+\*/\s*", "", line)
            funcs[name].append(body.split(";")[0].strip())
    names = list(funcs)
    demangled = subprocess.run([os.path.join(CUDA_HOME, "bin", "cu++filt")],
                               input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    out = {}
    for mangled, full in zip(names, demangled):
        depth, cut = 0, len(full)
        for i, ch in enumerate(full):          # the parameter list's "("
            depth += ch == "<"
            depth -= ch == ">"
            if (ch == "(" and depth == 0 and i > 0 and full[i - 1] != "<"
                    and not full[i:].startswith("(anonymous")):
                cut = i
                break
        out.setdefault(full[:cut], funcs[mangled])
    return out


def sass_digests(lib_path, keys) -> dict:
    """{demangled kernel name: SHA-256 (16 hex digits) of its stripped
    SASS} of each kernel of a built library whose name holds one of
    keys."""
    return {name: hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]
            for name, lines in sass_functions(lib_path).items()
            if any(k in name for k in keys)}


def nvcc_version() -> str:
    """The last line of `nvcc --version` (its release and build)."""
    from torch.utils.cpp_extension import CUDA_HOME

    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"),
                          "--version"], capture_output=True, text=True,
                         check=True).stdout
    return out.strip().splitlines()[-1]


def sass_diff(new_lib, old_lib) -> None:
    """Print which kernels of old_lib have the same SASS in new_lib, which
    differ or are gone, and which are new."""
    new, old = sass_functions(new_lib), sass_functions(old_lib)
    same = 0
    for name in sorted(old):
        if name not in new:
            print(f"[sass-diff] gone: {name}")
        elif new[name] == old[name]:
            same += 1
        else:
            print(f"[sass-diff] differs: {name} ({len(old[name])} -> "
                  f"{len(new[name])} instructions)")
    added = sorted(n for n in new if n not in old)
    print(f"[sass-diff] {same} of {len(old)} kernels identical; "
          f"{len(added)} new: " + "; ".join(added), flush=True)


def _cuobjdump(flag, path) -> list:
    from torch.utils.cpp_extension import CUDA_HOME

    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), flag,
                          str(path)], capture_output=True, text=True,
                         check=True).stdout
    return [line for line in out.splitlines()
            if not line.startswith("Fatbin") and "code for sm_" not in line
            and not line.startswith("arch =") and "filename" not in line]


# the anonymous namespace's per-compile tag in mangled names
# (_GLOBAL__N__<8 hex>_<length>_<file>_<8 hex>)
_ANON = r"_GLOBAL__N__[0-9a-f]{8}_"


def _kernels_of(lines) -> dict:
    """cuobjdump -sass lines -> {kernel name: instruction lines}, the
    addresses and encodings stripped."""
    import re

    funcs, name = {}, None
    for line in lines:
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name and "/*" in line and ";" in line:
            funcs[name].append(re.sub(r"^\s*/\*[0-9a-f]+\*/\s*", "", line)
                               .split(";")[0].strip())
    return funcs


def build_paths() -> None:
    """Compile every csrc/*.cu of this checkout at two paths (copies under
    build/paths/a and build/paths/deeper/by/far/b) with the kernel build's
    flags, and compare the two: the PTX (nvcc -ptx), then each object's
    SASS kernel by kernel and its ELF sections (cuobjdump -sass / -elf),
    for objects compiled as kernels/__init__.py compiles them (absolute
    source and object paths) and from the sources' directory with
    relative names; and, at one path, two compiles of the same command
    ("twice"). Each comparison is printed raw and with the anonymous
    namespace's tag in mangled names (_GLOBAL__N__<8 hex>_) masked; the
    kernels whose SASS still differs are counted. Writes the full diffs
    under build/paths/diffs/."""
    import difflib
    import re
    import shutil

    repo = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(repo, "pvcnn_tpu_torch", "csrc")
    import importlib

    kernels = importlib.import_module("pvcnn_tpu_torch.kernels")
    nvcc, flags = kernels._nvcc(), list(kernels.NVCC_FLAGS)
    report = os.path.join(repo, "build", "paths", "diffs")
    os.makedirs(report, exist_ok=True)
    roots = [os.path.join(repo, "build", "paths", "a"),
             os.path.join(repo, "build", "paths", "deeper", "by", "far",
                          "b")]
    for root in roots:
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(src, os.path.join(root, "csrc"))
    names = sorted(n for n in os.listdir(src) if n.endswith(".cu"))

    def compile_all(root, mode, sub):
        """-> {source: output path}; mode ptx, obj (absolute paths) or rel
        (from the sources' directory, relative names)"""
        csrc, out, procs = os.path.join(root, "csrc"), {}, []
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for name in names:
            stem = name[:-3]
            target = os.path.join(root, sub, stem + (
                ".ptx" if mode == "ptx" else ".o"))
            own = flags
            if mode == "rel":
                cmd = [nvcc, *own, "-c", "-o",
                       os.path.join("..", sub, stem + ".o"), name]
                cwd = csrc
            else:
                cmd = [nvcc, *own, "-ptx" if mode == "ptx" else "-c",
                       "-o", target, os.path.join(csrc, name)]
                cwd = repo
            if mode == "ptx":
                at = cmd.index("-gencode")
                cmd[at:at + 2] = ["-arch=sm_90a"]
                cmd = [c for c in cmd if c not in ("-Xcompiler", "-fPIC")]
            out[name] = target
            procs.append((name, subprocess.Popen(
                cmd, cwd=cwd, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        for name, proc in procs:
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"{name}: nvcc failed\n{log}")
        return out

    mask = lambda lines: [re.sub(_ANON, "_GLOBAL__N__*_", x) for x in lines]

    def compare(label, name, a, b):
        """a, b: lists of lines; -> one summary field, full diff to file"""
        if a == b:
            return f"{label} equal"
        with open(os.path.join(report, f"{name}.{label}.diff"), "a") as f:
            f.writelines(line + "\n" for line in difflib.unified_diff(
                a, b, lineterm="", n=1))
        where = ("only the anonymous tag" if mask(a) == mask(b)
                 else "beyond the anonymous tag")
        return f"{label} differs ({where})"

    pairs = [("ptx", compile_all(roots[0], "ptx", "ptx"),
              compile_all(roots[1], "ptx", "ptx")),
             ("obj", compile_all(roots[0], "obj", "obj"),
              compile_all(roots[1], "obj", "obj")),
             ("rel", compile_all(roots[0], "rel", "rel"),
              compile_all(roots[1], "rel", "rel"))]
    pairs.append(("twice", pairs[1][1], compile_all(roots[0], "obj",
                                                    "obj2")))
    for mode, a, b in pairs:
        totals = collections.Counter()
        for name in names:
            if mode == "ptx":
                fields = [compare("ptx", name, *(
                    open(p[name]).read().splitlines() for p in (a, b)))]
            else:
                sa, sb = (_cuobjdump("-sass", p[name]) for p in (a, b))
                ka, kb = (_kernels_of(mask(x)) for x in (sa, sb))
                differ = [k for k in ka if ka[k] != kb.get(k)]
                totals["kernels"] += len(ka)
                totals["differ"] += len(differ)
                fields = [compare(f"{mode}.sass", name, sa, sb),
                          f"{len(differ)} of {len(ka)} kernels' SASS "
                          "differs with the tag masked",
                          compare(f"{mode}.elf", name, *(
                              _cuobjdump("-elf", p[name]) for p in (a, b)))]
            print(f"[build-paths] {mode} {name}: " + "; ".join(fields),
                  flush=True)
        if mode != "ptx":
            print(f"[build-paths] {mode}: {totals['differ']} of "
                  f"{totals['kernels']} kernels' SASS differs with the "
                  "tag masked", flush=True)


def build_repeat(runs: int) -> None:
    """Compile every csrc/*.cu of this checkout to PTX `runs` times at one
    path with the kernel build's flags, all sources of a round at once as
    the build runs them, and print how many distinct PTX texts each source
    gave."""
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(repo, "pvcnn_tpu_torch", "csrc")
    import importlib

    kernels = importlib.import_module("pvcnn_tpu_torch.kernels")
    nvcc, flags = kernels._nvcc(), list(kernels.NVCC_FLAGS)
    at = flags.index("-gencode")
    flags[at:at + 2] = ["-arch=sm_90a"]
    flags = [f for f in flags if f not in ("-Xcompiler", "-fPIC")]
    names = sorted(n for n in os.listdir(src) if n.endswith(".cu"))
    texts = collections.defaultdict(set)
    with tempfile.TemporaryDirectory(dir=os.path.join(repo, "build")) as out:
        for run in range(runs):
            procs = []
            for name in names:
                target = os.path.join(out, f"{name}.{run}.ptx")
                procs.append((name, target, subprocess.Popen(
                    [nvcc, *flags, "-ptx", "-o", target,
                     os.path.join(src, name)], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)))
            for name, target, proc in procs:
                log = proc.communicate()[0]
                if proc.returncode:
                    raise RuntimeError(f"{name}: nvcc failed\n{log}")
                with open(target, "rb") as f:
                    texts[name].add(hashlib.sha256(f.read()).hexdigest())
    print(f"[build-repeat] {runs} compiles a source at one path: distinct "
          "PTX " + ", ".join(f"{n} {len(texts[n])}" for n in names),
          flush=True)


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["--build-paths"]:
        build_paths()
    elif len(sys.argv) == 3 and sys.argv[1] == "--build-repeat":
        build_repeat(int(sys.argv[2]))
    elif len(sys.argv) == 4 and sys.argv[1] == "--sass-diff":
        sass_diff(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit("usage: python3 cases_util.py --sass-diff NEW.so "
                         "OLD.so | --build-paths | --build-repeat RUNS")
