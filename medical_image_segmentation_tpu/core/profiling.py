"""Profiling hooks (SURVEY §5.1 — the reference has none; we add the
JAX versions: `jax.profiler` traces + per-stage wall timers).

Usage:
    with trace_if("/tmp/jax-trace", enabled=args.profile):
        ... training steps ...

    timers = StageTimers()
    with timers.stage("decode"): ...
    with timers.stage("h2d"): ...
    print(timers.report())
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict


@contextlib.contextmanager
def trace_if(log_dir: str, enabled: bool = True):
    """jax.profiler trace context (viewable in XProf/TensorBoard)."""
    if not enabled:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StageTimers:
    """Accumulating wall-clock timers for input-pipeline stages."""

    def __init__(self):
        # the prefetch thread writes ('decode') while the main thread
        # reads/resets each epoch — all access goes through this lock
        self._lock = threading.Lock()
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def snapshot(self) -> Dict[str, tuple]:
        """Consistent {stage: (total_s, count)} view (lock-guarded copy)."""
        with self._lock:
            return {k: (self.totals[k], self.counts[k]) for k in self.totals}

    def report(self, reset: bool = False) -> str:
        with self._lock:
            items = sorted((k, self.totals[k], self.counts[k]) for k in self.totals)
            if reset:
                self.totals = defaultdict(float)
                self.counts = defaultdict(int)
        lines = []
        for name, tot, n in items:
            lines.append(f"{name}: {tot:.3f}s total, {tot/max(n,1)*1e3:.2f} ms/call × {n}")
        return "\n".join(lines)

    def reset(self) -> None:
        """Zero the accumulators — per-epoch reports must not blend epochs."""
        with self._lock:
            self.totals = defaultdict(float)
            self.counts = defaultdict(int)


class StepProfiler:
    """jax.profiler trace of the first N steps, flushed from EVERY exit path
    (a run shorter than N steps, or one stopped by preemption, must still
    write the artifact). Shared by both trainer entry points."""

    def __init__(self, n_steps: int, log_dir: str):
        import os
        import sys

        self.left = n_steps
        self.on = False
        if n_steps:
            import jax

            self.trace_dir = os.path.join(log_dir, "trace")
            jax.profiler.start_trace(self.trace_dir)
            self.on = True
            print(f"profiling {n_steps} steps → {self.trace_dir}", file=sys.stderr)

    def tick(self, fence=None) -> None:
        """Count one step; stops the trace when the budget is spent."""
        if self.on:
            self.left -= 1
            if self.left <= 0:
                self.stop(fence)

    def stop(self, fence=None) -> None:
        if self.on:
            import sys

            import jax

            if fence is not None:
                jax.block_until_ready(fence)  # the trace captures the work
            jax.profiler.stop_trace()
            self.on = False
            print("profiler trace written", file=sys.stderr)
