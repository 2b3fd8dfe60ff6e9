"""Profiling harness: JAX device traces + stage timers.

The reference's only observability is GNU-time wrappers per pipeline
stage (ntedit_run_pipeline.smk:78-81) and coarse timestamps
(ntedit.cpp:2376,2589-2598).  This module provides the device-side
equivalents:

* ``trace(logdir)`` — a context manager around ``jax.profiler`` capturing
  a device trace viewable in TensorBoard/Perfetto (set
  ``NTEDIT_TPU_TRACE=<dir>`` to wrap any CLI run);
* ``StageTimer`` — named wall-clock + throughput accounting, printed in
  the engine's per-run summary line.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Capture a JAX device trace into ``logdir`` (or the
    NTEDIT_TPU_TRACE env var).  No-op when neither is set; a trace that
    was asked for and cannot start raises."""
    logdir = logdir or os.environ.get("NTEDIT_TPU_TRACE")
    if not logdir:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Named stage wall-clock accounting with bases/sec rates."""

    def __init__(self):
        self.stages = {}  # name -> [seconds, units]

    @contextlib.contextmanager
    def stage(self, name: str, units: int = 0):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            acc = self.stages.setdefault(name, [0.0, 0])
            acc[0] += dt
            acc[1] += units

    def summary(self) -> str:
        parts = []
        for name, (sec, units) in self.stages.items():
            rate = f" ({units / sec:,.0f}/s)" if units and sec > 0 else ""
            parts.append(f"{name} {sec:.2f}s{rate}")
        return "; ".join(parts)
