"""Structured metrics/observability for batch verification and kernels.

The reference has no metrics subsystem (SURVEY.md §5); production-scale
block verification needs them.  Lightweight: counters + wall-clock spans
collected into a thread-local registry, exported as a dict/JSON line.

Usage:
    from xelis_he_tpu_torch.metrics import metrics, span
    with span("verify_batch"):
        ...
    metrics.incr("msm.points", n)
    print(metrics.snapshot())
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from contextlib import contextmanager


class Metrics:
    def __init__(self):
        self._local = threading.local()

    def _state(self):
        if not hasattr(self._local, "counters"):
            self._local.counters = defaultdict(float)
            self._local.spans = defaultdict(float)
            self._local.span_counts = defaultdict(int)
        return self._local

    def incr(self, name: str, value: float = 1.0) -> None:
        self._state().counters[name] += value

    def record_span(self, name: str, seconds: float) -> None:
        st = self._state()
        st.spans[name] += seconds
        st.span_counts[name] += 1

    def reset(self) -> None:
        st = self._state()
        st.counters.clear()
        st.spans.clear()
        st.span_counts.clear()

    def snapshot(self) -> dict:
        st = self._state()
        return {
            "counters": dict(st.counters),
            "span_seconds": dict(st.spans),
            "span_counts": dict(st.span_counts),
        }

    def json_line(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


metrics = Metrics()


@contextmanager
def span(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        metrics.record_span(name, time.perf_counter() - t0)
