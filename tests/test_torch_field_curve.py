"""The port's plain field and curve (xelis_he_tpu_torch.ops.fe / ops.curve)
against the JAX package's numpy engine, limb for limb, and against pyref.

Both engines run the same algebra on 18x15-bit relaxed limbs, so every
intermediate result must have identical limbs, not only the same value."""

import numpy as np
import pytest
import torch

from xelis_he_tpu.ops.curve import numpy_curve
from xelis_he_tpu.ops.fe import Field as JaxField, numpy_field
from xelis_he_tpu.pyref import field as pf
from xelis_he_tpu.pyref.ristretto import BASEPOINT, IDENTITY, L, mul_base
from xelis_he_tpu_torch.ops.curve import Curve, point_to_rows, rows_to_point
from xelis_he_tpu_torch.ops.fe import Field, from_ints_np, limbs_to_bytes

P = pf.P
# small tensor ops: one intra-op thread, so parallel test workers keep their cores
torch.set_num_threads(1)
# tests/test_fe13.py's edge values
VALS = [0, 1, 2, P - 1, P - 19, 3**100 % P, pf.SQRT_M1, 2**252 + 1,
        (1 << 255) % P, 0x1234567890ABCDEF * 7 % P]
RFC9496_SMALL_MULTIPLES = [  # tests/test_field_ristretto.py
    "0000000000000000000000000000000000000000000000000000000000000000",
    "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76",
    "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919",
    "94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259",
    "da80862773358b466ffadfe0b3293ab3d9fd53c5ea6c955358f568322daf6a57",
    "e882b131016b52c1d3337080187cf768423efccbb517bb495ab812c4160ff44e",
    "f64746d3c92b13050ed8d80236a7f0007c3b3f962f5ba793d19a601ebb1df403",
    "44f53520926ec81fbd5a387845beb7df85a96a24ece18738bdcfa6a7822a176d",
]

NF = numpy_field()
TF = Field("cpu")
NC = numpy_curve()
TC = Curve(TF)
RNG = np.random.default_rng(20261016)


def _rand_ints(n, bound=P):
    raw = RNG.integers(0, 256, size=(n, 40), dtype=np.uint8)
    return [int.from_bytes(r.tobytes(), "little") % bound for r in raw]


A = VALS + _rand_ints(22)
B = list(reversed(VALS)) + _rand_ints(22)


def _pair(vals):
    a = NF.from_ints(vals)
    return a, torch.from_numpy(a.astype(np.int64))


def _same(np_limbs, torch_limbs):
    assert np.array_equal(np.asarray(np_limbs).astype(np.int64), torch_limbs.numpy())


def _ints(t):
    return Field.to_ints(TF.canon(t))


def _enc(points):
    """Encodings: the two packages' RistrettoPoint classes never compare equal."""
    return [p.compress() for p in points]


PYREF_BINARY = {
    "add": lambda x, y: (x + y) % P,
    "sub": lambda x, y: (x - y) % P,
    "mul": lambda x, y: x * y % P,
}


@pytest.mark.parametrize("op", sorted(PYREF_BINARY))
def test_binary_op_matches_numpy_field_and_pyref(op):
    a_np, a_t = _pair(A)
    b_np, b_t = _pair(B)
    x_np, x_t = getattr(NF, op)(a_np, b_np), getattr(TF, op)(a_t, b_t)
    _same(x_np, x_t)
    # again on relaxed (non-canonical) limbs, as inside the point formulas
    y_np, y_t = getattr(NF, op)(x_np, a_np), getattr(TF, op)(x_t, a_t)
    _same(y_np, y_t)
    f = PYREF_BINARY[op]
    assert _ints(y_t) == [f(f(x, y), x) for x, y in zip(A, B)]


PYREF_UNARY = {
    "neg": lambda x: -x % P,
    "square": lambda x: x * x % P,
    "canon": lambda x: x,
    "invert": pf.invert,
    "pow_p58": pf.pow_p58,
}


@pytest.mark.parametrize("op", sorted(PYREF_UNARY))
def test_unary_op_matches_numpy_field_and_pyref(op):
    a_np, a_t = _pair(A)
    # relaxed input: a sum of two elements
    a_np, a_t = NF.add(a_np, a_np), TF.add(a_t, a_t)
    x_np, x_t = getattr(NF, op)(a_np), getattr(TF, op)(a_t)
    _same(x_np, x_t)
    assert _ints(x_t) == [PYREF_UNARY[op](2 * x % P) for x in A]


def test_sqrt_ratio_m1_matches_numpy_field_and_pyref():
    u_np, u_t = _pair(A)
    v_np, v_t = _pair(B)
    ok_np, r_np = NF.sqrt_ratio_m1(u_np, v_np)
    ok_t, r_t = TF.sqrt_ratio_m1(u_t, v_t)
    assert ok_t.tolist() == ok_np.tolist()
    _same(r_np, r_t)
    want = [pf.sqrt_ratio_m1(u, v) for u, v in zip(A, B)]
    assert ok_t.tolist() == [w[0] for w in want]
    assert _ints(r_t) == [w[1] for w in want]
    ok1, r1 = TF.inv_sqrt(v_t)
    assert (ok1.tolist(), _ints(r1)) == ([pf.inv_sqrt(v)[0] for v in B], [pf.inv_sqrt(v)[1] for v in B])


@pytest.mark.parametrize("pred", ["is_negative", "is_zero"])
def test_predicates_match_numpy_field(pred):
    a_np, a_t = _pair(A)
    a_np, a_t = NF.sub(a_np, a_np[::-1]), TF.sub(a_t, a_t.flip(0))
    assert getattr(TF, pred)(a_t).tolist() == getattr(NF, pred)(a_np).tolist()


def test_eq_matches_numpy_field():
    a_np, a_t = _pair(A)
    b_np, b_t = _pair(A[:5] + B[5:])
    # equal values with different limbs: x + 0 - 0 versus x
    c_np, c_t = NF.sub(NF.add(a_np, b_np), b_np), TF.sub(TF.add(a_t, b_t), b_t)
    assert TF.eq(c_t, a_t).all()
    assert TF.eq(a_t, b_t).tolist() == NF.eq(a_np, b_np).tolist()


def test_bytes_round_trip_matches_numpy_field():
    raw = RNG.integers(0, 256, size=(24, 32), dtype=np.uint8)
    raw[0] = 0xFF  # bit 255 set and value >= p: masked, then reduced
    raw[1, :] = np.frombuffer(P.to_bytes(32, "little"), np.uint8)
    _same(NF.from_bytes_le(raw), TF.from_bytes_le(torch.from_numpy(raw)))
    a_np, a_t = _pair(A)
    out = TF.to_bytes_le(TF.mul(a_t, a_t))
    assert np.array_equal(out.numpy(), NF.to_bytes_le(NF.mul(a_np, a_np)))
    assert [bytes(r) for r in out.numpy()] == [pf.fe_to_bytes(x * x % P) for x in A]
    assert np.array_equal(limbs_to_bytes(TF.canon(a_t)).numpy(), NF.to_bytes_le(a_np))


def test_host_row_packing_matches_numpy_field():
    assert np.array_equal(from_ints_np(A + [P + 5]), NF.from_ints(A + [P + 5]))
    assert Field.to_ints(NF.from_ints(A)) == JaxField.to_ints(NF.from_ints(A)) == A


def test_u32_bounds_are_asserted():
    """The JAX field computes in uint32; the port's int64 plain version
    must not let an overflow the TPU would have hit pass silently."""
    big = torch.full((1, 18), 1 << 17, dtype=torch.int64)
    with pytest.raises(AssertionError, match="uint32"):
        TF.mul(big, big)
    neg = torch.full((1, 18), -1, dtype=torch.int64)
    with pytest.raises(AssertionError, match="uint32"):
        TF.add(neg, neg)


# -- curve ------------------------------------------------------------------


def _points(n):
    return [mul_base(s) for s in _rand_ints(n, L)] + [IDENTITY, BASEPOINT, 2 * BASEPOINT]


PTS = _points(9)
QTS = list(reversed(PTS))


def _batch(points):
    np_b = NC.from_points(points)
    return np_b, tuple(torch.from_numpy(c.astype(np.int64)) for c in np_b)


@pytest.mark.parametrize("op", ["add", "double", "neg"])
def test_curve_group_op_matches_numpy_curve_and_pyref(op):
    p_np, p_t = _batch(PTS)
    q_np, q_t = _batch(QTS)
    if op == "add":
        got_np, got_t, want = NC.add(p_np, q_np), TC.add(p_t, q_t), [p + q for p, q in zip(PTS, QTS)]
    elif op == "double":
        got_np, got_t, want = NC.double(p_np), TC.double(p_t), [p.double() for p in PTS]
    else:
        got_np, got_t, want = NC.neg(p_np), TC.neg(p_t), [-p for p in PTS]
    for a, b in zip(got_np, got_t):
        _same(a, b)
    assert _enc(TC.to_points(got_t)) == _enc(want)
    assert TC.is_identity(got_t).tolist() == [w.is_identity() for w in want]


def test_curve_niels_add_matches_extended_add():
    p_np, p_t = _batch(PTS)
    q_np, q_t = _batch(QTS)
    neg = torch.tensor([i % 3 == 0 for i in range(len(PTS))])
    got = TC.add_niels(p_t, TC.to_niels(q_t), neg)
    want = [p - q if n else p + q for p, q, n in zip(PTS, QTS, neg.tolist())]
    assert _enc(TC.to_points(got)) == _enc(want)


def test_curve_compress_matches_numpy_curve_and_rfc9496():
    pts = [IDENTITY]
    for _ in range(len(RFC9496_SMALL_MULTIPLES) - 1):
        pts.append(pts[-1] + BASEPOINT)
    pts += PTS
    p_np, p_t = _batch(pts)
    enc = TC.compress(p_t)
    assert np.array_equal(enc.numpy(), NC.compress(p_np))
    assert [bytes(r).hex() for r in enc.numpy()[: len(RFC9496_SMALL_MULTIPLES)]] == RFC9496_SMALL_MULTIPLES
    assert [bytes(r) for r in enc.numpy()] == [p.compress() for p in pts]


def test_curve_decompress_matches_numpy_curve_and_rejects_invalid():
    good = [bytes.fromhex(h) for h in RFC9496_SMALL_MULTIPLES] + [p.compress() for p in PTS]
    bad = [
        (P + 3).to_bytes(32, "little"),  # non-canonical field element
        b"\x01" + bytes(31),  # negative s
        bytes(31) + b"\x80",  # bit 255 set
        b"\xff" * 32,
    ]
    flipped = bytearray(good[3])
    flipped[5] ^= 0xFF
    bad.append(bytes(flipped))
    data = np.frombuffer(b"".join(good + bad), np.uint8).reshape(-1, 32)
    pt_np, ok_np = NC.decompress(data)
    pt_t, ok_t = TC.decompress(torch.from_numpy(data.copy()))
    assert ok_t.tolist() == ok_np.tolist()
    assert ok_t.tolist()[: len(good) + 4] == [True] * len(good) + [False] * 4
    for a, b in zip(pt_np, pt_t):
        _same(a, b)
    assert [bytes(r) for r in TC.compress(pt_t).numpy()[: len(good)]] == good
    rows = point_to_rows(pt_t, TF)
    assert rows.shape == (data.shape[0], 4, 18)
    assert _enc(TC.to_points(rows_to_point(rows))) == _enc(TC.to_points(pt_t))
