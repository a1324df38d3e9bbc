"""Tracing / profiling utilities (SURVEY.md §5 tracing row — absent in the
reference, which only wraps time.time() around the stuck-wait delta).

- `device_trace(logdir)`: context manager around jax.profiler.trace for
  TensorBoard-viewable device traces of the solve step.
- `Timer` / `RateTracker`: lightweight host-side phase timers exporting the
  solves/s and p50/p99 latency counters the benchmarks and the serving layer
  report.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Deque, Dict

import numpy as np

__all__ = ["device_trace", "device_module_durations_ms", "Timer",
           "RateTracker"]


@contextlib.contextmanager
def device_trace(logdir: str):
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_module_durations_ms(logdir: str) -> Dict[str, list]:
    """Extract per-execution DEVICE durations of jitted modules from a
    jax.profiler trace directory (written by `device_trace`).

    Why: every host-side timing includes the host's dispatch and sync
    costs; the profiler's device lane records what the device itself
    spends per step. Used by bench.py to report `device_p99_ms` alongside
    the blocking host round trip.

    Returns {module_name: [duration_ms, ...]} for every event named `jit_*`
    found on a device-side lane (pid whose process_name mentions the device),
    durations in chronological order. Empty dict if the trace has no device
    lane (e.g. CPU backend) or no jit module events.
    """
    import glob
    import gzip
    import json

    paths = glob.glob(f"{logdir}/plugins/profile/*/*.trace.json.gz")
    if not paths:
        return {}
    with gzip.open(sorted(paths)[-1]) as f:
        tr = json.load(f)
    events = tr.get("traceEvents", [])
    device_pids = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pname = str(e.get("args", {}).get("name", ""))
            if "/device:" in pname or "GPU" in pname:
                device_pids.add(e.get("pid"))
    out: Dict[str, list] = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("pid") in device_pids
                and str(e.get("name", "")).startswith("jit_")):
            out.setdefault(e["name"], []).append(
                (float(e.get("ts", 0.0)), float(e.get("dur", 0.0)) / 1e3))
    return {k: [d for _, d in sorted(v)] for k, v in out.items()}


class Timer:
    """Accumulating per-phase wall timers: Timer.phase('solve') context."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": v, "count": self.counts[k],
                "mean_ms": 1e3 * v / max(self.counts[k], 1)}
            for k, v in self.totals.items()
        }


class RateTracker:
    """Sliding-window latency/rate stats (p50/p99/Hz) for the control loop."""

    def __init__(self, window: int = 512):
        self.samples: Deque[float] = deque(maxlen=window)

    def record(self, seconds: float) -> None:
        self.samples.append(seconds)

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(time.perf_counter() - t0)

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return {"count": 0}
        a = np.array(self.samples)
        return {
            "count": len(a),
            "p50_ms": float(np.percentile(a, 50) * 1e3),
            "p99_ms": float(np.percentile(a, 99) * 1e3),
            "mean_ms": float(a.mean() * 1e3),
            "rate_hz": float(1.0 / a.mean()) if a.mean() > 0 else float("inf"),
        }
