"""The port's MsmEngine (xelis_he_tpu_torch.ops.msm) against the JAX package's
numpy engine and pyref, on identical inputs; comparisons are exact.  On CPU
tensors ``msm_daa_lanes`` and ``msm_daa`` run K7's and K3's plain versions."""

import numpy as np
import torch

from torch_carry import plain_calls

from xelis_he_tpu.ops.curve import numpy_curve
from xelis_he_tpu.ops.fe import numpy_field
from xelis_he_tpu.ops.msm import MsmEngine as JaxMsmEngine
from xelis_he_tpu.ops.msm import decompose_bits as jax_decompose_bits
from xelis_he_tpu.pyref.ristretto import IDENTITY, L, mul_base, multiscalar_mul
from xelis_he_tpu_torch.ops.curve import Curve
from xelis_he_tpu_torch.ops.fe import Field
from xelis_he_tpu_torch.ops.msm import MsmEngine, decompose_bits

torch.set_num_threads(1)
RNG = np.random.default_rng(253)
NC, NF = numpy_curve(), numpy_field()
CURVE = Curve(Field("cpu"))
N = 16


def _rand_scalars(n):
    raw = RNG.integers(0, 256, size=(n, 40), dtype=np.uint8)
    return [int.from_bytes(r.tobytes(), "little") % L for r in raw]


PTS = [mul_base(s) for s in _rand_scalars(N - 1)] + [IDENTITY]
SCAL = [0, 1, L - 1] + _rand_scalars(N - 3)


def _canon(coords):
    """numpy or torch (X, Y, Z, T) -> canonical (..., 4, 18) int64 array."""
    return np.stack([NF.canon(np.asarray(c).astype(np.uint32)) for c in coords], axis=-2).astype(np.int64)


def _enc(points):
    """Encodings: the port's and the JAX package's point classes compare as bytes."""
    return [p.compress() for p in points]


def _batch():
    jax_batch = NC.from_points(PTS)
    return jax_batch, tuple(torch.from_numpy(np.asarray(c).astype(np.int64)) for c in jax_batch)


def test_decompose_bits_matches_jax_package():
    want = jax_decompose_bits(SCAL)
    assert np.array_equal(decompose_bits(SCAL), want)
    raw = np.frombuffer(b"".join(s.to_bytes(32, "little") for s in SCAL), np.uint8).reshape(-1, 32)
    assert np.array_equal(decompose_bits(raw), want)
    assert np.array_equal(decompose_bits(SCAL, 64), jax_decompose_bits(SCAL, 64))


def test_msm_daa_lanes_matches_numpy_engine():
    jax_batch, batch = _batch()
    bits = decompose_bits(SCAL)
    with plain_calls() as calls:
        got = MsmEngine(CURVE).msm_daa_lanes(batch, bits)
    assert calls["daa_lanes"] == 1
    want = JaxMsmEngine(NC, use_jax=False).msm_daa_lanes(jax_batch, bits)
    assert np.array_equal(_canon([c.numpy() for c in got]), _canon(want))
    assert _enc(CURVE.to_points(got)) == _enc(multiscalar_mul([s], [p]) for s, p in zip(SCAL, PTS))


def test_msm_daa_matches_numpy_engine_and_pyref():
    jax_batch, batch = _batch()
    bits = decompose_bits(SCAL)
    got = MsmEngine(CURVE).msm_daa(batch, torch.from_numpy(bits.astype(np.int64)))
    want = JaxMsmEngine(NC, use_jax=False).msm_daa(jax_batch, bits)
    # one sum, two trees: the same point, compared as a point
    got_pt = CURVE.to_points(tuple(c[None] for c in got))[0]
    want_pt = NC.to_points(tuple(c[None] for c in want))[0]
    assert got_pt.compress() == want_pt.compress() == multiscalar_mul(SCAL, PTS).compress()


def test_msm_daa_lanes_takes_fewer_bit_rows():
    _, batch = _batch()
    small = [s & ((1 << 64) - 1) for s in SCAL]
    got = MsmEngine(CURVE).msm_daa_lanes(batch, decompose_bits(small, 64))
    assert _enc(CURVE.to_points(got)) == _enc(multiscalar_mul([s], [p]) for s, p in zip(small, PTS))


def test_batch_dual_mul_matches_numpy_engine():
    """r_i = a_i Q + b_i P_i over 32-bit scalars, Q's doubles precomputed."""
    n_bits = 32
    jax_batch, batch = _batch()
    a = [int(x) for x in RNG.integers(0, 1 << n_bits, N)]
    b = [int(x) for x in RNG.integers(0, 1 << n_bits, N)]
    a[0], b[0], a[1], b[1] = 0, 0, (1 << n_bits) - 1, (1 << n_bits) - 1
    q = mul_base(77)
    doubles = [q]
    for _ in range(n_bits - 1):
        doubles.append(doubles[-1].double())
    q_np = NC.from_points(doubles)
    q_t = tuple(torch.from_numpy(np.asarray(c).astype(np.int64)) for c in q_np)
    bits_a, bits_b = decompose_bits(a, n_bits), decompose_bits(b, n_bits)
    got = MsmEngine(CURVE).batch_dual_mul(batch, bits_a, bits_b, q_t)
    want = JaxMsmEngine(NC, use_jax=False).batch_dual_mul(jax_batch, bits_a, bits_b, q_np)
    assert np.array_equal(_canon([c.numpy() for c in got]), _canon(want))
    assert _enc(CURVE.to_points(got)) == _enc(multiscalar_mul([x, y], [q, p]) for x, y, p in zip(a, b, PTS))
