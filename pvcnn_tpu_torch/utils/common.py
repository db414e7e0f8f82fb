"""Run directory of a set of config paths (counterpart of
pvcnn_tpu/utils/common.py; reference utils/common.py):
`pvcnn_tpu_torch/configs/shapenet/pvcnn/c1.py` -> `runs/shapenet.pvcnn.c1`,
several config paths merged into a bracketed tree string.

Everything up to and including the last `configs/` of a path is dropped,
so the port's config tree gives the JAX package's run directories."""

from __future__ import annotations

import os

__all__ = ["get_save_path"]


def _config_name(path: str) -> str:
    """`.../configs/a/b.py` -> `a/b` (the path without `.py` where it has
    no `configs/`)."""
    head, sep, tail = path.rpartition("configs/")
    if sep and (not head or head.endswith("/")):
        path = tail
    return path.replace(".py", "")


def get_save_path(*config_paths: str, prefix: str = "runs") -> str:
    memo: dict = {}
    for c in config_paths:
        node = memo
        for part in _config_name(c).split("/"):
            node = node.setdefault(part, {})

    def render(m: dict, out: str) -> str:
        n = len(m)
        if n > 1:
            out += "["
        for i, (k, v) in enumerate(m.items()):
            out += k
            if v:
                out += "."
            out = render(v, out)
            if n > 1 and i < n - 1:
                out += "+"
        if n > 1:
            out += "]"
        return out

    return os.path.join(prefix, render(memo, ""))
