"""Device selection: `--devices` names the card a run uses (counterpart of
pvcnn_tpu/utils/device.py; reference utils/device.py).

`parse_device_spec` is the JAX package's grammar: '0,2-3' -> [0, 2, 3],
'cpu' -> [], with 'gpu0' / 'tpu0' prefixes accepted. `select_device`
turns a spec into the one torch.device the port's entry points run on:
no spec (or an empty one) means cuda:0, 'cpu' the CPU, one index that
card. CUDA is required for any card; several indices are refused, since
multi-GPU data parallelism (DDP, which would replace the JAX data mesh)
is not ported yet (ROADMAP.md, Queue 1, item 5).
"""

from __future__ import annotations

import torch

__all__ = ["parse_device_spec", "select_device"]


def parse_device_spec(spec: str):
    """'0,2-3' -> [0, 2, 3]; 'cpu' -> []. Accepts 'gpu0'/'tpu0' prefixes
    (the reference grammar, utils/device.py:10-18)."""
    ids: list[int] = []
    for dev in spec.split(","):
        dev = dev.strip().lower()
        if not dev or dev == "cpu":
            continue
        for prefix in ("gpu", "tpu"):
            if dev.startswith(prefix):
                dev = dev[len(prefix):]
        if "-" in dev:
            lo, hi = map(int, dev.split("-"))
            ids.extend(range(lo, hi + 1))
        else:
            ids.append(int(dev))
    return ids


def select_device(spec: str | None) -> torch.device:
    """A --devices spec -> the torch.device to run on: cuda:0 without a
    spec, the CPU for 'cpu', else the one card it names. Raises where CUDA
    is not available for a card, where the index is out of range, and
    where the spec names more than one card."""
    from pvcnn_tpu_torch.train.trainer import check_device

    if spec is not None and spec.strip().lower() == "cpu":
        return torch.device("cpu")
    ids = parse_device_spec(spec) if spec is not None else []
    if len(ids) > 1:
        raise ValueError(
            f"--devices {spec!r} names {len(ids)} cards: multi-GPU data "
            "parallelism (DDP) is not ported yet (ROADMAP.md, Queue 1, "
            "item 5); name one card")
    device = check_device(f"cuda:{ids[0] if ids else 0}")
    count = torch.cuda.device_count()
    if device.index >= count:
        raise ValueError(f"--devices {spec!r}: card {device.index} out of "
                         f"range for {count} visible card(s)")
    return device
