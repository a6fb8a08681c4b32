"""Profiling & observability: JAX profiler traces + throughput counters.

The reference's observability is timestamped stderr logging plus
microsecond timers around the query loop reporting us/query with and
without I/O (src/CLI/sbwt_search.cpp:48-63, 255-256; include/sbwt/
globals.hh:83-112 Progress_printer).  The equivalents here:

* ``trace(dir)`` — context manager around jax.profiler.trace; the dumped
  trace opens in TensorBoard / Perfetto and shows per-op device time for
  the gather chains.
* ``annotate(name)`` — TraceAnnotation wrapper so engine phases (chain,
  patch, ...) show as named spans inside a device trace.
* ``ThroughputMeter`` — queries/s + us/query counters with the same two
  views the reference logs (excluding and including I/O).
* ``ProgressPrinter`` — percent ticker for long host-side loops
  (construction streaming), same operator experience as globals.hh:83-112.
"""
from __future__ import annotations

import contextlib
import sys
import time

from .logging import write_log


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace of the enclosed block into `log_dir`."""
    import jax

    jax.profiler.start_trace(log_dir, create_perfetto_trace=False)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        write_log(f"profiler trace written to {log_dir}")


def annotate(name: str):
    """Named span inside a device trace (wraps jax.profiler.TraceAnnotation)."""
    import jax

    return jax.profiler.TraceAnnotation(name)


class ThroughputMeter:
    """Queries/s and us/query, split into device time and end-to-end time.

    Mirrors the reference's two log lines (us/query excluding I/O,
    sbwt_search.cpp:63; us/query including I/O, sbwt_search.cpp:255-256).
    """

    def __init__(self):
        self.n_queries = 0
        self.device_s = 0.0
        self._t_start = time.perf_counter()

    @contextlib.contextmanager
    def measure(self, n_queries: int):
        """Time a device-side batch (call with the answers blocked-on)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.device_s += time.perf_counter() - t0
            self.n_queries += n_queries

    def us_per_query_device(self) -> float:
        return self.device_s * 1e6 / max(1, self.n_queries)

    def us_per_query_total(self) -> float:
        return (time.perf_counter() - self._t_start) * 1e6 / max(1, self.n_queries)

    def queries_per_sec_device(self) -> float:
        return self.n_queries / self.device_s if self.device_s else 0.0

    def log(self):
        write_log(f"us/query excluding I/O: {self.us_per_query_device()}")
        write_log(f"us/query including I/O: {self.us_per_query_total()}")
        write_log(f"queries/s (device): {self.queries_per_sec_device():.0f}")


class ProgressPrinter:
    """Percent ticker for host-side streaming loops (globals.hh:83-112)."""

    def __init__(self, n_jobs: int, n_steps: int = 100, stream=sys.stderr):
        self.n_jobs = max(1, n_jobs)
        self.n_steps = n_steps
        self.processed = 0
        self.next_tick = 0
        self.stream = stream

    def job_done(self, n: int = 1):
        self.processed += n
        while self.next_tick <= self.n_steps * self.processed // self.n_jobs:
            self.stream.write(f"\r{100 * self.next_tick // self.n_steps}%")
            self.stream.flush()
            self.next_tick += 1
        if self.processed >= self.n_jobs:
            self.stream.write("\r")
            self.stream.flush()
