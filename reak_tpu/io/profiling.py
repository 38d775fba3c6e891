"""Tracing/profiling: section timers + device trace capture.

JAX-native equivalent of the reference's observability hooks (SURVEY.md §5.1):
exec_time_profiler (ref: core/base/exec_time_profiler.hpp:37-80 — markTime
IDs → per-interval microsecond rows to a file) and the planner timing
reporters.  Device-side work is profiled with the JAX profiler (XLA traces
viewable in TensorBoard/Perfetto), host-side sections with a wall-clock
section timer that streams rows through the recorder data plane.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


class ExecTimeProfiler:
    """Named-section wall-clock profiler.

    with prof.section("fk"):
        ...
    prof.summary()  →  {"fk": {"count", "total_s", "mean_s", "max_s"}}

    Rows stream to ``recorder`` (any io.recorder sink) as they close, giving
    the same row-per-interval file the reference's profiler writes.
    """

    def __init__(self, recorder=None, enabled: bool = True):
        self.enabled = enabled
        self.recorder = recorder
        self._acc: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._acc.setdefault(name, []).append(dt)
            if self.recorder is not None:
                self.recorder.record({"t": time.time(), "section_us": dt * 1e6,
                                      "section": hash(name) % 10**9})

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._acc.items():
            out[name] = {
                "count": len(xs),
                "total_s": sum(xs),
                "mean_s": sum(xs) / len(xs),
                "max_s": max(xs),
            }
        return out

    def report(self) -> str:
        lines = [f"{'section':<24}{'count':>8}{'total ms':>12}{'mean ms':>12}"]
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{name:<24}{s['count']:>8}"
                         f"{s['total_s']*1e3:>12.2f}{s['mean_s']*1e3:>12.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture an XLA device trace (jax.profiler) for TensorBoard/Perfetto —
    the device-side replacement for the reference's host-only profiler."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def block_timed(fn, *args, **kwargs):
    """Run ``fn`` and block on its outputs; returns (result, seconds) — the
    correct way to wall-clock a jitted function on an async backend."""
    import jax

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0
