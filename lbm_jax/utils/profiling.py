"""Throughput metering + profiler tracing.

The reference's only observability is cudaEvent wall-clock pairs printed
at save cadence (ldc.cu:622-689); MLUPS is derived offline (thesis §4.9.1).
Here: a steps/sec -> MLUPS meter usable around any chunk, and a context
manager around jax.profiler for device traces (view with TensorBoard or
xprof).
"""

from __future__ import annotations

import contextlib
import time


class Meter:
    """Accumulating lattice-update throughput meter."""

    def __init__(self, n_sites: int):
        self.n_sites = int(n_sites)
        self.steps = 0
        self.seconds = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds += time.perf_counter() - self._t0
        self._t0 = None

    def add_steps(self, n: int):
        self.steps += n

    @property
    def mlups(self) -> float:
        if self.seconds == 0:
            return 0.0
        return self.n_sites * self.steps / self.seconds / 1e6

    def report(self) -> str:
        return (
            f"{self.steps} steps, {self.seconds*1e3:.1f} ms total, "
            f"{self.mlups:.1f} MLUPS"
        )


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler device trace around a block."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_op_times(trace_dir: str, plane_prefix: str = "/device:GPU:"):
    """Reduce the newest jax.profiler trace under trace_dir to device
    operation times: returns (ops, busy_ns, window_ns) with ops a list
    of (name, total_ns, count) sorted by total time, busy_ns the union
    of the op intervals and window_ns first start to last end, over
    every plane whose name starts with plane_prefix. On a GPU plane
    only the per-op line ("XLA Ops") is read, so module and step spans
    are not counted twice."""
    import glob
    import os

    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    pd = ProfileData.from_file(max(paths, key=os.path.getmtime))
    totals: dict[str, list] = {}
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        lines = list(plane.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or lines
        for line in ops:
            for ev in line.events:
                t = totals.setdefault(ev.name, [0.0, 0])
                t[0] += ev.duration_ns
                t[1] += 1
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy = 0.0
    end = None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (max(b for _, b in spans) - min(a for a, _ in spans)
              if spans else 0.0)
    ops = sorted(((k, v[0], v[1]) for k, v in totals.items()),
                 key=lambda r: -r[1])
    return ops, busy, window


__all__ = ["Meter", "trace", "device_op_times"]
