"""Structured timing / throughput instrumentation.

Replaces the reference's ad-hoc ``std::clock`` "Time Cost" print and the
window-title FPS counter (``main.cu:469-476``, ``main.cu:342-360``) with:

- :class:`PhaseTimer` — named phase timers (scene build / bvh / render /
  readback) with a report table,
- :func:`mrays_per_s` — the canonical throughput derivation (pixels x spp x
  depth closest-hit queries per wall-second),
- :func:`trace_context` — a ``jax.profiler`` trace scope for device profiling
  (replacing "cudaDeviceReset for Nsight", SURVEY §5).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional


class PhaseTimer:
    """Accumulating named wall-clock phases.

    >>> t = PhaseTimer()
    >>> with t.phase("render"): ...
    >>> t.report()
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = ["phase                 total_s   calls    mean_s"]
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<20} {total:>8.4f} {n:>7} "
                         f"{total / n:>9.5f}")
        return "\n".join(lines)


def mrays_per_s(num_pixels: int, spp: int, max_depth: int,
                seconds: float) -> float:
    """Closest-hit queries per wall-second, in millions.

    This is the *nominal-workload* throughput (pixels x spp x depth; the
    reference's fixed workload is 800x450 x 100 x 50,
    global_variables.h:28-31). With the early-exit bounce loop fewer
    queries actually execute, so this number is an UPPER bound on the
    achieved per-query rate — use it for apples-to-apples workload
    comparisons across rounds, and the executed-query count
    (integrator.trace(with_stats=True), reported by bench.py) for honest
    per-query speed.
    """
    if seconds <= 0:
        return float("inf")
    return num_pixels * spp * max_depth / seconds / 1e6


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]) -> Iterator[None]:
    """``jax.profiler.trace`` scope when ``log_dir`` is set; no-op otherwise.

    View with tensorboard or xprof. Usage:
        with trace_context("/tmp/pt-trace"):
            img = render(...).block_until_ready()
    """
    if not log_dir:
        yield
        return
    import jax
    with jax.profiler.trace(log_dir):
        yield
