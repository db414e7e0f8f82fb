"""Scalar logging (counterpart of pvcnn_tpu/utils/logging.py; reference
train.py:114,244-246): `ScalarWriter(save_path)` appends JSON lines to
`<save_path>/scalars.jsonl`, with tensorboard's add_scalar and close. It
imports nothing, so a run pays no tensorboard import and writes the same
format on every host.
"""

from __future__ import annotations

import json
import os
import time

__all__ = ["ScalarWriter"]


class ScalarWriter:
    """One JSON object a scalar, {"tag", "value", "step", "wall_time"},
    appended to <save_path>/scalars.jsonl, line-buffered."""

    def __init__(self, save_path: str):
        os.makedirs(save_path, exist_ok=True)
        self.path = os.path.join(save_path, "scalars.jsonl")
        self._f = open(self.path, "a", buffering=1)

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step),
                                  "wall_time": time.time()}) + "\n")

    def close(self) -> None:
        self._f.close()
