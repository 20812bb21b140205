"""Device tracing / profiling hooks, on torch.profiler.

Three tools:

- ``trace(dir)``: context manager around ``torch.profiler`` with CPU and (on
  a machine with a CUDA device) CUDA activity; it yields the profiler, so
  the caller can read its events, and writes a Chrome/Perfetto trace into
  ``dir`` when the block ends.
- ``annotate(name)``: a named region in that trace (``record_function``).
- ``kernel_report()``: summarize the in-process metrics registry into a
  human-readable table (spans + counters), for quick CLI inspection.

Usage:
    from xelis_he_tpu_torch.utils.profiling import trace, kernel_report
    with trace("/tmp/xhe-trace"):
        verify_batch(txs, state, accel=accel)
    print(kernel_report())
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch

from ..metrics import metrics


@contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Profile the block with torch.profiler (CPU activity, and CUDA activity
    where a CUDA device is present) and write its Chrome trace, which
    Perfetto and chrome://tracing open, to ``log_dir``.  Yields the
    profiler.  ``create_perfetto_link`` prints the trace file's path."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    if create_perfetto_link:
        print(f"trace written to {path}: open it in Perfetto", flush=True)


@contextmanager
def annotate(name: str):
    """Named region that shows up inside the trace (record_function)."""
    with torch.profiler.record_function(name):
        yield


def kernel_report(reset: bool = False) -> str:
    """Render the metrics registry as an aligned text table."""
    snap = metrics.snapshot()
    lines = []
    spans = snap["span_seconds"]
    counts = snap["span_counts"]
    if spans:
        lines.append("spans (total ms / calls):")
        width = max(len(k) for k in spans)
        for k in sorted(spans):
            lines.append(f"  {k:<{width}}  {spans[k] * 1000:9.2f}  {counts.get(k, 0):6d}")
    if snap["counters"]:
        lines.append("counters:")
        width = max(len(k) for k in snap["counters"])
        for k, v in sorted(snap["counters"].items()):
            lines.append(f"  {k:<{width}}  {v:12.0f}")
    if reset:
        metrics.reset()
    return "\n".join(lines) or "(no metrics recorded)"
