"""The port's profiling hooks (xelis_he_tpu_torch.utils.profiling): ``trace``
writes a Chrome trace that holds an ``annotate`` span, and ``kernel_report``
renders the metrics registry as the JAX package's does."""

import json
import pathlib

import numpy as np
import torch

from xelis_he_tpu.metrics import metrics as jax_metrics
from xelis_he_tpu.utils.profiling import kernel_report as jax_kernel_report
from xelis_he_tpu_torch.metrics import metrics
from xelis_he_tpu_torch.utils.profiling import annotate, kernel_report, trace

torch.set_num_threads(1)


def test_trace_writes_a_trace_with_the_annotated_span(tmp_path):
    with trace(str(tmp_path / "trace")) as prof:
        with annotate("xhe.test_region"):
            torch.ones(64).cumsum(0)
    names = {e.name for e in prof.events()}
    assert "xhe.test_region" in names
    files = list(pathlib.Path(tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "xhe.test_region" for e in events)


def test_kernel_report_matches_jax_package_on_a_seeded_registry():
    rng = np.random.default_rng(11)
    for m in (metrics, jax_metrics):
        m.reset()
    assert kernel_report() == jax_kernel_report() == "(no metrics recorded)"
    for i in range(12):
        name = f"verify_batch.span_{int(rng.integers(0, 6))}"
        seconds = float(rng.random())
        counter = f"counter.{'ab'[i % 2]}{int(rng.integers(0, 3))}"
        value = float(rng.integers(1, 1000))
        for m in (metrics, jax_metrics):
            m.record_span(name, seconds)
            m.incr(counter, value)
    text = kernel_report()
    assert text == jax_kernel_report()
    assert text.startswith("spans (total ms / calls):") and "counters:" in text
    assert kernel_report(reset=True) == jax_kernel_report(reset=True) == text
    assert kernel_report() == jax_kernel_report() == "(no metrics recorded)"
