"""The port's Pippenger engine (xelis_he_tpu_torch.ops.msm: MsmEngine.msm,
msm_points, _window_sum, decompose_digits) against the JAX package's numpy
engine and pyref, on identical inputs.  On CPU tensors the engine runs the
plain versions of K9 (bucket sums) and K10 (window sums and Horner).  The two
engines sort lanes differently (the JAX package's argsort is not stable), so
projective results are compared by encoding; digits compare exactly."""

import numpy as np
import pytest
import torch

from torch_carry import plain_calls

from xelis_he_tpu.ops.curve import numpy_curve
from xelis_he_tpu.ops.msm import MsmEngine as JaxMsmEngine
from xelis_he_tpu.ops.msm import decompose_digits as jax_decompose_digits
from xelis_he_tpu.pyref.ristretto import IDENTITY, L, mul_base, multiscalar_mul
from xelis_he_tpu_torch.ops.curve import Curve
from xelis_he_tpu_torch.ops.fe import Field
from xelis_he_tpu_torch.ops.msm import DEFAULT_WINDOW, MsmEngine, decompose_digits

torch.set_num_threads(1)
RNG = np.random.default_rng(813)
NC = numpy_curve()
CURVE = Curve(Field("cpu"))


def _rand_scalars(n):
    raw = RNG.integers(0, 256, size=(n, 40), dtype=np.uint8)
    return [int.from_bytes(r.tobytes(), "little") % L for r in raw]


def _case(n):
    """n lanes over mul_base(i + 3) with scalars 0 and L - 1 and an identity
    point among them (where n allows)."""
    pts = [mul_base(i + 3) for i in range(n)]
    scal = _rand_scalars(n)
    scal[0] = L - 1
    if n >= 2:
        scal[1] = 0
    if n >= 7:
        pts[4] = IDENTITY
        scal[5] = L - 1
    return scal, pts


@pytest.mark.parametrize("c", [8, 13])
def test_decompose_digits_matches_jax_package(c):
    scal = [0, 1, L - 1, (1 << 253) - 1] + _rand_scalars(28)
    want = jax_decompose_digits(scal, c)
    assert want.shape == ((256 + c - 1) // c, len(scal))
    assert np.array_equal(decompose_digits(scal, c), want)
    raw = np.frombuffer(b"".join(s.to_bytes(32, "little") for s in scal), np.uint8).reshape(-1, 32)
    assert np.array_equal(decompose_digits(raw, c), want)


def test_engine_defaults_to_the_jax_packages_window():
    assert MsmEngine(CURVE).window == DEFAULT_WINDOW == JaxMsmEngine(NC).window == 13


@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_msm_points_matches_numpy_engine_and_pyref(n):
    scal, pts = _case(n)
    with plain_calls() as calls:
        got = MsmEngine(CURVE, window=8).msm_points(scal, pts)
    assert calls["bucket_sums"] == 1 and calls["window_sums"] == 1  # every window in one call each
    want = JaxMsmEngine(NC, window=8).msm_points(scal, pts)
    assert got.compress() == want.compress() == multiscalar_mul(scal, pts).compress()


def test_msm_points_records_a_span_for_each_phase():
    """msm_points's phases are metrics spans, one each a call, and the rest
    of the call is Python glue (the spans cover most of its time)."""
    import time

    from xelis_he_tpu_torch.metrics import metrics

    scal, pts = _case(7)
    metrics.reset()
    t0 = time.perf_counter()
    MsmEngine(CURVE, window=8).msm_points(scal, pts)
    wall = time.perf_counter() - t0
    snap = metrics.snapshot()
    names = [f"msm.{k}" for k in ("digits", "points", "bucket_runs", "k9", "k10", "pull")]
    assert {k: snap["span_counts"].get(k) for k in names} == dict.fromkeys(names, 1)
    assert 0.5 * wall < sum(snap["span_seconds"][k] for k in names) <= wall


def test_msm_points_of_nothing_is_the_identity():
    assert MsmEngine(CURVE, window=8).msm_points([], []).compress() == IDENTITY.compress()


def test_window_sum_matches_numpy_engine():
    """K9's and K10's plain versions on one window (digits 0 .. 255, the top
    bucket and repeated digits among them) against the JAX _window_sum."""
    scal, pts = _case(64)
    d = decompose_digits(scal, 8)[3].copy()
    d[:4] = [0, 255, 255, 1]
    got = MsmEngine(CURVE, window=8)._window_sum(CURVE.from_points(pts), d)
    want = JaxMsmEngine(NC, window=8)._window_sum(NC.from_points(pts), d)
    enc = [CURVE.to_points(tuple(c[None] for c in got))[0].compress(),
           NC.to_points(tuple(c[None] for c in want))[0].compress()]
    weighted = multiscalar_mul([int(x) for x in d], pts)
    assert enc == [weighted.compress()] * 2


@pytest.mark.parametrize("skew", [False, True])
def test_bucket_pass_plan_of_the_engines_windows(skew):
    """K9's plan (ops.kernels.bucket_passes) on the engine's own runs at 600
    lanes, window 8, with one scalar on all lanes but two when ``skew``:
    pass 1 reads every lane of digits 1.. once; each later pass reads the
    block sums the one before it wrote for the runs it split, and the last
    pass splits nothing."""
    from xelis_he_tpu_torch.ops import kernels as K
    from xelis_he_tpu_torch.ops.msm import bucket_runs

    scal, _ = _case(600)
    if skew:
        scal = [scal[3]] * 598 + [0, L - 1]
    digits = decompose_digits(scal, 8)
    _, offsets = bucket_runs(digits, 8, "cpu")
    plan = list(K.bucket_passes(offsets, 600))
    assert len(plan) == K.k9_passes(600)
    start, length, first = plan[0]
    assert int(length.sum()) == int((torch.from_numpy(digits) != 0).sum())
    assert bool((first[1:] - first[:-1] >= 1).all())  # every bucket has a thread in pass 1
    for (_, _, first_before), (start, length, first) in zip(plan, plan[1:]):
        made = first_before[1:] - first_before[:-1]
        split = made >= 2
        assert torch.equal(length, torch.where(split, made, 0)) and torch.equal(start, first_before[:-1])
    assert int((plan[-1][2][1:] - plan[-1][2][:-1]).max()) <= 1
    if skew:
        assert len(plan) >= 2 and int(plan[1][1].max()) >= 2
