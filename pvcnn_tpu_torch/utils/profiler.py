"""Tracing and throughput (counterpart of pvcnn_tpu/utils/profiler.py):
`trace(log_dir)` records host and device activity with torch.profiler
(CPU, and CUDA where it is available) and writes a Chrome trace
(`trace_<pid>_<ns>.json`) into `log_dir`; `ThroughputMeter` counts
points/s over a sliding window of steps.

    with trace_if("runs/x/profile", enabled=step < 5):
        trainer.train_step(x, y)

    meter = ThroughputMeter()
    meter.tick(points=batch * num_points)
    print(meter.points_per_sec())
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["ThroughputMeter", "trace", "trace_if"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block into a Chrome trace under `log_dir`; the card is
    synchronized before the profiler stops, so the trace holds every
    kernel the block launched. Yields the torch.profiler.profile."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def trace_if(log_dir: str, enabled: bool):
    if not enabled:
        yield None
        return
    with trace(log_dir) as prof:
        yield prof


class ThroughputMeter:
    """Sliding-window points/sec counter; call tick() once per completed
    step."""

    def __init__(self, window: int = 50):
        self.window = window
        self._events: list[tuple[float, int]] = []

    def tick(self, points: int):
        now = time.perf_counter()
        self._events.append((now, points))
        if len(self._events) > self.window:
            self._events.pop(0)

    def points_per_sec(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        pts = sum(p for _, p in self._events[1:])
        return pts / dt if dt > 0 else 0.0
