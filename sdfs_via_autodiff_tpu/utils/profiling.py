"""Profiling and timing utilities.

The reference's only instrumentation is wall-clock pairs and ``%%time``
magics (SURVEY.md §5).  Here: a ``jax.profiler`` trace context for device
traces, and a timing wrapper emitting the BASELINE metrics
(time-to-tolerance, iterations, grid-point updates per second).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import jax
import numpy as np

__all__ = ["trace", "timed_solve", "TimedSolve"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``jax.profiler`` trace (viewable in TensorBoard/Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class TimedSolve:
    result: "object"            # SolveResult
    wall_seconds: float
    compile_seconds: Optional[float]
    points_per_second: float    # grid-point updates / second

    def __str__(self):
        c = (f", compile {self.compile_seconds:.2f}s"
             if self.compile_seconds is not None else "")
        return (f"{self.result} in {self.wall_seconds:.3f}s{c} "
                f"({self.points_per_second:,.0f} point-updates/s)")


def timed_solve(solve_fn: Callable, T: Callable, x0, *,
                warm_up: bool = True, **solve_kwargs) -> TimedSolve:
    """Run ``solve_fn(T, x0, **kwargs)`` with timing.

    ``warm_up=True`` runs the solve twice and reports the second (cached)
    wall time plus the first-minus-second as compile time; pass False to
    time a single cold run.
    """
    compile_s = None
    if warm_up:
        t0 = time.perf_counter()
        res = solve_fn(T, x0, **solve_kwargs)
        jax.block_until_ready(res.x)
        cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solve_fn(T, x0, **solve_kwargs)
    jax.block_until_ready(res.x)
    wall = time.perf_counter() - t0
    if warm_up:
        compile_s = max(0.0, cold - wall)
    n_points = int(np.prod(np.shape(x0)))
    iters = max(1, int(res.iterations))
    return TimedSolve(result=res, wall_seconds=wall,
                      compile_seconds=compile_s,
                      points_per_second=n_points * iters / wall)
