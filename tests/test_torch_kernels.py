"""The plain versions of the port's seven kernels (xelis_he_tpu_torch.ops.kernels)
against the JAX package, on identical numpy inputs, and the CUDA kernels'
shared arithmetic (csrc/ed25519.cuh) built for the host with g++.

The JAX references are the plain ones, not the Pallas kernels in interpret
mode (minutes per call on a CPU): ``jax_curve()`` for K1/K4, the transposed
helpers of ``pallas_msm`` composed as each kernel composes them for K2 (the
13-bit tier), K5, K6 and K7 (the 15-bit tier; they take their array module as
an argument, so numpy runs them without a compile), ``msm._tree_reduce`` for
K3, and pyref throughout.  Every comparison is exact.  K2 and K6 add in
another order than the TPU kernels (a slot is split over several threads),
so they meet the TPU helpers and each other as encodings, and their plain
versions and host builds as rows; K6's body at one thread a slot, the TPU
kernel's order, meets the helpers by rows.  The CUDA kernels themselves run
only on the card (chip_smoke.py)."""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_carry import plain_calls
from xelis_he_tpu.ops import pallas_msm as pm
from xelis_he_tpu.ops.curve import jax_curve, numpy_curve
from xelis_he_tpu.ops.fe import numpy_field
from xelis_he_tpu.ops.msm import _tree_reduce
from xelis_he_tpu.pyref import field as pf
from xelis_he_tpu.pyref.ristretto import IDENTITY, L, mul_base, multiscalar_mul
from xelis_he_tpu_torch.ops import _build
from xelis_he_tpu_torch.ops import kernels as K
from xelis_he_tpu_torch.scripts import bench_k8_k9 as BK

P = pf.P
# small tensor ops: one intra-op thread, so parallel test workers keep their cores
torch.set_num_threads(1)
NF = numpy_field()
RNG = np.random.default_rng(1016)
EDGE_SCALARS = [0, 1, L - 1, 2**252 + 27742317777372353535851937790883648493 - 1,
                (1 << 253) - 1, 2, L - 2, 1 << 128]  # tests/test_fe13.py


def _rand_scalars(n):
    raw = RNG.integers(0, 256, size=(n, 40), dtype=np.uint8)
    return [int.from_bytes(r.tobytes(), "little") % L for r in raw]


def _rows(points):
    """Host points -> (n, 4, 18) uint32 limb rows (Z != 1 in general)."""
    return np.stack([NF.from_ints([getattr(p, a) for p in points]) for a in "XYZT"], axis=1)


def _canon_rows(coords):
    """numpy (X, Y, Z, T) limbs -> canonical (n, 4, 18) int32 rows."""
    return np.stack([NF.canon(np.asarray(c)) for c in coords], axis=1).astype(np.int32)


def _enc(points):
    return [p.compress() for p in points]


def _row_enc(rows):
    """(n, 4, 18) rows -> their encodings (K4's plain version)."""
    return [bytes(r) for r in K.compress(torch.from_numpy(np.ascontiguousarray(rows).view(np.int32))).numpy()]


def _encodings():
    """64 encodings: valid points (the identity among them) and the invalid
    cases of tests/test_ops.py, plus bit 255 set on a valid encoding."""
    pts = [mul_base(s) for s in _rand_scalars(56)] + [IDENTITY]
    top = bytearray(pts[0].compress())
    top[31] |= 0x80
    bad = [(P + 5).to_bytes(32, "little"), b"\x01" + bytes(31), bytes(31) + b"\x80",
           b"\xff" * 32, bytes(top), P.to_bytes(32, "little"), (9).to_bytes(32, "little")]
    blobs = _enc(pts) + bad
    return np.frombuffer(b"".join(blobs), np.uint8).reshape(-1, 32).copy(), pts


ENC, ENC_PTS = _encodings()
N_GOOD = len(ENC_PTS)
HOST_PTS = [mul_base(s) for s in _rand_scalars(8)] + [IDENTITY]


@pytest.fixture(scope="module")
def jax_decoded():
    """K1's JAX reference, eager: jax_curve().decompress plus the bit-255
    rule of decompress_pallas."""
    pt, valid = jax_curve().decompress(jnp.asarray(ENC))
    top_clear = (ENC[:, 31] >> 7) == 0
    return _canon_rows(pt), np.asarray(valid) & top_clear


@pytest.fixture(scope="module")
def k4_input(jax_decoded):
    rows, _ = jax_decoded
    return np.concatenate([rows.astype(np.uint32), _rows(HOST_PTS)])


@pytest.fixture(scope="module")
def jax_encoded(k4_input):
    coords = tuple(jnp.asarray(k4_input[:, c, :]) for c in range(4))
    return np.asarray(jax_curve().compress(coords))


def test_decompress_plain_matches_jax_curve(jax_decoded):
    rows, valid = K.decompress(torch.from_numpy(ENC))
    want_rows, want_valid = jax_decoded
    assert valid.tolist() == want_valid.astype(np.uint8).tolist()
    assert valid.tolist() == [1] * N_GOOD + [0] * (ENC.shape[0] - N_GOOD)
    assert np.array_equal(rows.numpy(), want_rows)


def test_compress_plain_matches_jax_curve(k4_input, jax_encoded):
    out = K.compress(torch.from_numpy(k4_input.view(np.int32)))
    assert np.array_equal(out.numpy(), jax_encoded)
    want = _enc(ENC_PTS) + [bytes(32)] * (ENC.shape[0] - N_GOOD) + _enc(HOST_PTS)
    assert [bytes(r) for r in out.numpy()] == want


# -- K2 -----------------------------------------------------------------------

S_SLOTS = 8


def _k2_inputs():
    """8 slots x 8 subs: edge scalars, a zero-digit sub slot, and a
    signature-style slot (s*H, -e*P, subs 2-7 H with zero digits)."""
    n = K.K_PACK * S_SLOTS
    pts = [mul_base(s) for s in _rand_scalars(n)]
    scal = _rand_scalars(n)
    for k in range(K.K_PACK):
        scal[k * S_SLOTS] = EDGE_SCALARS[k]  # slot 0: one edge scalar per sub
        scal[k * S_SLOTS + 1] = EDGE_SCALARS[(k + 3) % len(EDGE_SCALARS)]
        if k >= 3:
            scal[k * S_SLOTS + 2] = 0  # slot 2: zero-digit subs
        if k >= 2:
            scal[k * S_SLOTS + 3] = 0  # slot 3: a signature pair
            pts[k * S_SLOTS + 3] = pts[3]
    pts[3 * S_SLOTS + 4] = IDENTITY
    # sub k of slot s is lane k * S + s
    rows = _rows(pts).reshape(K.K_PACK, S_SLOTS, 4, 18)
    digits = pm.recode_signed4(scal).reshape(64, K.K_PACK, S_SLOTS).transpose(1, 0, 2)
    return pts, scal, rows, np.ascontiguousarray(digits).astype(np.uint8)


K2_PTS, K2_SCAL, K2_ROWS, K2_DIGITS = _k2_inputs()


def _fe13_slots(rows, digits):
    """_windowed_kernel_k4_fe13's algebra on numpy: per-sub 1P..8P niels
    tables, then 64 windows of 4 shared doublings and 8 signed-digit adds,
    all on the 20x13-bit tier; returns canonical (S, 4, 18) rows."""
    S = rows.shape[1]
    c13 = pm._consts13_array()
    consts = (c13[0 : pm.NL13], c13[pm.NL13 : 2 * pm.NL13], c13[2 * pm.NL13 : 3 * pm.NL13])
    tables = []
    for k in range(K.K_PACK):
        t1 = tuple(pm._to13_t(np.ascontiguousarray(rows[k, :, c, :].T), np) for c in range(4))
        t2 = pm._point_double13(t1, np, consts)
        t3 = pm._point_add13(t2, t1, np, consts)
        t4 = pm._point_double13(t2, np, consts)
        t5 = pm._point_add13(t4, t1, np, consts)
        t6 = pm._point_double13(t3, np, consts)
        t7 = pm._point_add13(t6, t1, np, consts)
        t8 = pm._point_double13(t4, np, consts)
        tables.append([pm._to_niels13(t, np, consts) for t in (t1, t2, t3, t4, t5, t6, t7, t8)])
    acc = pm._identity13_cols(S, np)
    ident_n = pm._identity_niels13_cols(S, np)
    for w in range(pm.N_WINDOWS - 1, -1, -1):
        for want_t in (False, False, False, True):
            acc = pm._point_double13(acc, np, consts, want_t=want_t)
        for k in range(K.K_PACK):
            val = digits[k, w][None, :].astype(np.int32) - 8
            neg = (val < 0).astype(np.uint32)
            k_abs = np.abs(val).astype(np.uint32)
            sel = ident_n
            for idx, entry in enumerate(tables[k]):
                sel = pm._point_select_t(k_abs == idx + 1, entry, sel, np)
            ypx, ymx, t2d, z2 = sel
            sel = (pm._select_t(neg, ymx, ypx, np), pm._select_t(neg, ypx, ymx, np),
                   pm._select_t(neg, pm._neg13(t2d, np, consts), t2d, np), z2)
            acc = pm._point_add_niels13(acc, sel, np, consts)
    return _canon_rows(tuple(pm._from13_t(c, np).T for c in acc))


@pytest.fixture(scope="module")
def fe13_reference():
    return _fe13_slots(K2_ROWS, K2_DIGITS)


@pytest.fixture(scope="module")
def k2_plain_rows():
    """K2's wrapper on CPU tensors, i.e. its plain version, on K2's inputs."""
    return K.windowed_lanes_k8(torch.from_numpy(K2_ROWS.view(np.int32)), torch.from_numpy(K2_DIGITS)).numpy()


def _pyref_slots():
    out = []
    for s in range(S_SLOTS):
        lanes = [k * S_SLOTS + s for k in range(K.K_PACK)]
        out.append(multiscalar_mul([K2_SCAL[i] for i in lanes], [K2_PTS[i] for i in lanes]).compress())
    return out


def test_windowed_lanes_plain_matches_fe13_helpers_and_pyref(fe13_reference, k2_plain_rows):
    # K2 splits a slot over K2_SPLIT accumulators, the TPU kernel keeps one:
    # the same slot sums in other projective coordinates, so compared encoded
    assert _row_enc(k2_plain_rows) == _row_enc(fe13_reference) == _pyref_slots()


def test_recode_signed4_matches_pallas_msm():
    scal = EDGE_SCALARS + _rand_scalars(56)
    want = pm.recode_signed4(scal)
    assert np.array_equal(K.recode_signed4(scal), want)
    raw = np.frombuffer(b"".join(s.to_bytes(32, "little") for s in scal), np.uint8).reshape(-1, 32)
    assert np.array_equal(K.recode_signed4(raw), want)
    assert np.array_equal(K.recode_signed4_torch(torch.from_numpy(raw.copy())).numpy(), want)
    assert np.array_equal(pm.recode_signed4_xp(raw, np), want)


# -- K5, K6, K7: the 15-bit tier's helpers, composed as the kernels compose them --


def _consts15():
    c = pm._consts_array()
    return c[0:18], c[18:36], c[36:54]


def _cols(rows):
    """(n, 4, 18) rows -> the transposed (X, Y, Z, T), each (18, n) uint32."""
    return tuple(np.ascontiguousarray(rows[:, c, :].T).astype(np.uint32) for c in range(4))


def _table_1_to_8(t1, consts):
    t2 = pm._point_double_t(t1, np, consts)
    t3 = pm._point_add_t(t2, t1, np, consts)
    t4 = pm._point_double_t(t2, np, consts)
    t5 = pm._point_add_t(t4, t1, np, consts)
    t6 = pm._point_double_t(t3, np, consts)
    t7 = pm._point_add_t(t6, t1, np, consts)
    t8 = pm._point_double_t(t4, np, consts)
    return (t1, t2, t3, t4, t5, t6, t7, t8)


def _four_doublings(acc, consts):
    for want_t in (False, False, False, True):
        acc = pm._point_double_t(acc, np, consts, want_t=want_t)
    return acc


def _signed_digit(row):
    val = row[None, :].astype(np.int32) - 8
    return (val < 0).astype(np.uint32), np.abs(val).astype(np.uint32)


def _windowed_kernel_lanes(rows, digits):
    """_windowed_kernel's algebra on numpy -> canonical (N, 4, 18) rows."""
    consts = _consts15()
    table = _table_1_to_8(_cols(rows), consts)
    ident = pm._identity_cols(rows.shape[0], np)
    acc = ident
    for w in range(pm.N_WINDOWS - 1, -1, -1):
        acc = _four_doublings(acc, consts)
        neg, k_abs = _signed_digit(digits[w])
        sel = ident
        for idx, entry in enumerate(table):
            sel = pm._point_select_t(k_abs == idx + 1, entry, sel, np)
        sx, sy, sz, st = sel
        sel = (pm._select_t(neg, pm._neg_t(sx, np, consts), sx, np), sy, sz,
               pm._select_t(neg, pm._neg_t(st, np, consts), st, np))
        acc = pm._point_add_t(acc, sel, np, consts)
    return _canon_rows(tuple(c.T for c in acc))


def _windowed_kernel_k4_slots(rows, digits):
    """_windowed_kernel_k4's algebra on numpy (the 18x15-bit tier of the packed
    lanes) -> canonical (S, 4, 18) rows."""
    S = rows.shape[1]
    consts = _consts15()
    tables = [[pm._to_niels_t(t, np, consts) for t in _table_1_to_8(_cols(rows[k]), consts)]
              for k in range(K.K_PACK)]
    acc = pm._identity_cols(S, np)
    ident_n = pm._identity_niels_cols(S, np)
    for w in range(pm.N_WINDOWS - 1, -1, -1):
        acc = _four_doublings(acc, consts)
        for k in range(K.K_PACK):
            neg, k_abs = _signed_digit(digits[k, w])
            sel = ident_n
            for idx, entry in enumerate(tables[k]):
                sel = pm._point_select_t(k_abs == idx + 1, entry, sel, np)
            ypx, ymx, t2d, z2 = sel
            sel = (pm._select_t(neg, ymx, ypx, np), pm._select_t(neg, ypx, ymx, np),
                   pm._select_t(neg, pm._neg_t(t2d, np, consts), t2d, np), z2)
            acc = pm._point_add_niels_t(acc, sel, np, consts)
    return _canon_rows(tuple(c.T for c in acc))


def _daa_kernel_lanes(rows, words):
    """_daa_kernel's algebra on numpy -> canonical (N, 4, 18) rows."""
    consts = _consts15()
    acc, base = pm._identity_cols(rows.shape[0], np), _cols(rows)
    for word in range(pm.N_WORDS):
        row = words[word : word + 1]
        for k in range(min(32, pm.N_BITS - 32 * word)):
            bit = (row >> np.uint32(k)) & np.uint32(1)
            acc = pm._point_select_t(bit, pm._point_add_t(acc, base, np, consts), acc, np)
            base = pm._point_double_t(base, np, consts)
    return _canon_rows(tuple(c.T for c in acc))


def _lane_inputs():
    """24 lanes: the edge scalars, 0, 1 and L - 1 among them, a lane holding
    the identity, host points with Z != 1."""
    n = 24
    pts = [mul_base(s) for s in _rand_scalars(n)]
    scal = EDGE_SCALARS + _rand_scalars(n - len(EDGE_SCALARS))
    pts[9] = IDENTITY
    pts[10] = pts[11]  # a lane adding a point to itself on the way
    scal[10] = 3
    return pts, scal, _rows(pts)


LANE_PTS, LANE_SCAL, LANE_ROWS = _lane_inputs()
LANE_DIGITS = pm.recode_signed4(LANE_SCAL).astype(np.uint8)
# K7 also takes scalars with bits 253-255 set, and ignores those bits
DAA_SCAL = LANE_SCAL[:-2] + [(1 << 253) + 0x1234567, (1 << 256) - 1]
DAA_WORDS = pm.pack_bits(DAA_SCAL)


def _lane_encodings(scal, mask=None):
    return [multiscalar_mul([s if mask is None else s & mask], [p]).compress() for s, p in zip(scal, LANE_PTS)]


@pytest.fixture(scope="module")
def k5_reference():
    return _windowed_kernel_lanes(LANE_ROWS, LANE_DIGITS)


@pytest.fixture(scope="module")
def k6_reference():
    return _windowed_kernel_k4_slots(K2_ROWS, K2_DIGITS)


@pytest.fixture(scope="module")
def k7_reference():
    return _daa_kernel_lanes(LANE_ROWS, DAA_WORDS)


def test_windowed_lane_plain_matches_pallas_helpers_and_pyref(k5_reference):
    with plain_calls() as calls:
        out = K.windowed_lanes(torch.from_numpy(LANE_ROWS.view(np.int32)), torch.from_numpy(LANE_DIGITS))
    assert calls["windowed_lanes"] == 1
    assert np.array_equal(out.numpy(), k5_reference)
    assert [bytes(r) for r in K.compress(out).numpy()] == _lane_encodings(LANE_SCAL)


@pytest.fixture(scope="module")
def k6_plain_rows():
    """K6's wrapper on CPU tensors, i.e. its plain version, on K2's inputs."""
    with plain_calls() as calls:
        out = K.windowed_lanes_k8_fe15(torch.from_numpy(K2_ROWS.view(np.int32)), torch.from_numpy(K2_DIGITS))
    assert calls["windowed_lanes_k8_fe15"] == 1
    return out.numpy()


def test_windowed_lanes_fe15_plain_matches_pallas_helpers_k2_and_pyref(k6_reference, fe13_reference,
                                                                         k2_plain_rows, k6_plain_rows):
    # K6 splits a slot over K6_SPLIT accumulators, the TPU kernel keeps one:
    # equal slot sums in other projective coordinates, so compared encoded,
    # with K2 too (two field tiers, one answer)
    assert _row_enc(k6_plain_rows) == _row_enc(k6_reference) == _row_enc(k2_plain_rows) == _pyref_slots()
    assert np.array_equal(k6_reference, fe13_reference)
    # at one thread a slot the plain version keeps the TPU kernel's order: rows
    pts, dig = torch.from_numpy(K2_ROWS.view(np.int32)), torch.from_numpy(K2_DIGITS)
    assert np.array_equal(K.packed_slots_plain(pts, dig, 1).numpy(), k6_reference)


def test_daa_lanes_plain_matches_pallas_helpers_and_pyref(k7_reference):
    words = torch.from_numpy(DAA_WORDS.view(np.int32))
    out = K.daa_lanes(torch.from_numpy(LANE_ROWS.view(np.int32)), words)
    assert np.array_equal(out.numpy(), k7_reference)
    assert [bytes(r) for r in K.compress(out).numpy()] == _lane_encodings(DAA_SCAL, (1 << 253) - 1)


def test_pack_bits_matches_pallas_msm():
    want = pm.pack_bits(DAA_SCAL)
    assert np.array_equal(K.pack_bits(DAA_SCAL), want)
    raw = np.frombuffer(b"".join(s.to_bytes(32, "little") for s in DAA_SCAL), np.uint8).reshape(-1, 32)
    assert np.array_equal(K.pack_bits(raw), want)
    got = K.pack_bits_torch(torch.from_numpy(raw.copy()))
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert np.array_equal(got.numpy().view(np.uint32), want)


# -- K3 -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def k3_points():
    """256 host points, the identity among them, and their rows."""
    pts = [mul_base(s) for s in _rand_scalars(250)] + [IDENTITY] * 6
    return pts, _rows(pts)


def test_tile_sums_plain_matches_tree_reduce(k3_points):
    """Tile 8 is one sub-tile; tile 128 is two sub-tiles of K3_SUB rows,
    whose partial sums meet in a second tree."""
    nc = numpy_curve()
    for tile, n_tiles in ((8, 4), (128, 2)):
        pts = k3_points[0][-tile * n_tiles :]
        rows = k3_points[1][-tile * n_tiles :]
        out = K.tile_sums(torch.from_numpy(np.ascontiguousarray(rows).view(np.int32)), tile)
        sub = min(tile, K.K3_SUB)
        for t in range(n_tiles):
            parts = []
            for u in range(t * tile, (t + 1) * tile, sub):
                coords = tuple(rows[u : u + sub, c, :] for c in range(4))
                parts.append(_tree_reduce(nc, coords, sub))  # lane i + half onto lane i, as K3
            want = _tree_reduce(nc, tuple(np.stack(c) for c in zip(*parts)), tile // sub)
            assert np.array_equal(out.numpy()[t], _canon_rows(tuple(c[None] for c in want))[0])
        sums = [multiscalar_mul([1] * tile, pts[t * tile : (t + 1) * tile]) for t in range(n_tiles)]
        assert [bytes(r) for r in K.compress(out).numpy()] == _enc(sums)


@pytest.mark.parametrize("counts", [(1, 1), (3, 9), (17, 2)])
def test_sum_points_matches_pyref(counts):
    """Group sums through K3 alone, each group padded with identities."""
    n = max(counts)
    groups = [[mul_base(s) for s in _rand_scalars(c)] + [IDENTITY] * (n - c) for c in counts]
    rows = np.stack([_rows(g) for g in groups])
    out = K.sum_points(torch.from_numpy(rows.view(np.int32)))
    want = [multiscalar_mul([1] * len(g), g) for g in groups]
    assert [bytes(r) for r in K.compress(out).numpy()] == _enc(want)


def test_wrappers_check_shapes_and_devices():
    with pytest.raises(ValueError):
        K.decompress(torch.zeros((4, 31), dtype=torch.uint8))
    with pytest.raises(ValueError):
        K.tile_sums(torch.zeros((12, 4, 18), dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        K.compress(torch.zeros((4, 4, 18), dtype=torch.int64))
    with pytest.raises(ValueError):
        K.windowed_lanes(torch.zeros((4, 4, 18), dtype=torch.int32), torch.zeros((64, 5), dtype=torch.uint8))
    with pytest.raises(ValueError):
        K.daa_lanes(torch.zeros((4, 4, 18), dtype=torch.int32), torch.zeros((8, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        K.windowed_lanes_k8_fe15(torch.zeros((8, 4, 4, 18), dtype=torch.int32),
                                 torch.zeros((8, 64, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        K.add_compress(torch.zeros((3, 4, 18), dtype=torch.int32), torch.zeros((2, 4, 17), dtype=torch.int32))
    with pytest.raises(ValueError):
        K.add_compress(torch.zeros((3, 4, 18), dtype=torch.int32), torch.zeros((1, 4, 18), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        K.bucket_sums(torch.zeros((4, 4, 18), dtype=torch.int32), torch.zeros((2, 4), dtype=torch.int32),
                      torch.zeros((2, 7), dtype=torch.int32))
    with pytest.raises(ValueError):
        K.window_sums(torch.zeros((2, 6, 4, 18), dtype=torch.int32))
    assert K.launches == {"decompress": 0, "windowed_lanes_k8": 0, "tile_sums": 0, "compress": 0,
                          "windowed_lanes": 0, "windowed_lanes_k8_fe15": 0, "daa_lanes": 0, "add_compress": 0,
                          "bucket_sums": 0, "window_sums": 0,
                          "probe_imad": 0, "probe_mul15": 0, "probe_mul13": 0, "probe_fe": 0}


# -- csrc/ed25519.cuh built for the host ----------------------------------------


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """The kernels' per-thread bodies, compiled by g++ from the same header."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    import pathlib

    repo = pathlib.Path(__file__).resolve().parents[1]
    out = tmp_path_factory.mktemp("shim") / "libshim.so"
    subprocess.run(
        ["g++", "-x", "c++", "-DXHE_HD=", "-DXHE_NOINLINE=", "-DXHE_COUNT_MULS", "-O2", "-shared", "-fPIC",
         "-I", str(repo / "xelis_he_tpu_torch" / "csrc"), "-o", str(out),
         str(repo / "tests" / "torch_ed25519_shim.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.shim_decompress.argtypes = [vp, vp, vp, i]
    lib.shim_compress.argtypes = [vp, vp, i]
    lib.shim_windowed_lanes_k8.argtypes = [vp, vp, vp, i]
    lib.shim_tile_sums.argtypes = [vp, vp, i, i]
    lib.shim_windowed_lanes_k8_fe15.argtypes = [vp, vp, vp, i, i]
    lib.shim_windowed_lanes_k8_fe15.restype = i
    lib.shim_windowed_lanes.argtypes = [vp, vp, vp, i]
    lib.shim_daa_lanes.argtypes = [vp, vp, vp, i]
    lib.shim_fe15.argtypes = [vp, vp, vp, vp, vp, i]
    lib.shim_square.argtypes = [vp, vp, vp, i]
    lib.shim_reduce64.argtypes = [vp, vp, i]
    lib.shim_add_compress.argtypes = [vp, vp, vp, vp, i, i, i]
    lib.shim_bucket_pass.argtypes = [vp, vp, vp, vp, vp, vp, i, vp, vp]
    lib.shim_window_sums.argtypes = [vp, vp, i, i, i, i]
    lib.shim_k10_rounds.argtypes = [vp, vp, i, i]
    lib.shim_k9_k.restype = i
    lib.shim_k10_max_threads.restype = i
    lib.shim_k2_split.restype = i
    lib.shim_k3_sub.restype = i
    lib.shim_k6_split.restype = i
    lib.shim_k7_quad.restype = i
    lib.shim_mul_count.restype = ctypes.c_ulonglong
    lib.shim_wide_products.argtypes = [i, i]
    lib.shim_wide_products.restype = ctypes.c_ulonglong
    lib.shim_sq_count.restype = ctypes.c_ulonglong
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _counts(shim):
    return shim.shim_mul_count(), shim.shim_sq_count()


def test_cuh_wide_products_set_the_muladd_counts(shim):
    """The 32-bit multiply-adds the bounds charge a field operation
    (MULADDS_PER_FIELD_*) are its 32 x 32 -> 64-bit products, counted in the
    host build, at WIDE_SLOTS each (K11's wide form, PERF.md), and its
    multiplies by 19: 10 and 5 on the radix-2^25.5 tier, 17 on fe15."""
    wide = {(t, sq): shim.shim_wide_products(t, sq) for t in (0, 1) for sq in (0, 1)}
    assert wide == {(0, 0): 100, (0, 1): 55, (1, 0): 324, (1, 1): 171}
    assert K.WIDE_SLOTS == 2
    assert K.MULADDS_PER_FIELD_MUL == wide[0, 0] * K.WIDE_SLOTS + 10
    assert K.MULADDS_PER_FIELD_SQ == wide[0, 1] * K.WIDE_SLOTS + 5
    assert K.MULADDS_PER_FIELD_MUL15 == wide[1, 0] * K.WIDE_SLOTS + 17
    assert K.MULADDS_PER_FIELD_SQ15 == wide[1, 1] * K.WIDE_SLOTS + 17


def test_cuh_square_equals_mul_by_itself(shim):
    """fe_sq's 55 products give fe_mul(f, f)'s limbs bit for bit, up to the
    header's carried-limb bound of 2^w + 2^17."""
    width = np.array([26, 25] * 5, dtype=np.uint64)
    top = (np.uint64(1) << width) + np.uint64(1 << 17)
    f = np.random.default_rng(7).integers(0, 1 << 62, (2048, 10), dtype=np.uint64) % top
    f[0], f[1] = top - np.uint64(1), 0
    f = np.ascontiguousarray(f.astype(np.uint32))
    by_mul, by_sq = np.zeros_like(f), np.zeros_like(f)
    shim.shim_square(_ptr(f), _ptr(by_mul), _ptr(by_sq), f.shape[0])
    assert np.array_equal(by_sq, by_mul)
    ints = [sum(int(v) << (26 * ((k + 1) // 2) + 25 * (k // 2)) for k, v in enumerate(r)) for r in f[:64]]
    outs = [sum(int(v) << (26 * ((k + 1) // 2) + 25 * (k // 2)) for k, v in enumerate(r)) for r in by_sq[:64]]
    assert [o % P for o in outs] == [x * x % P for x in ints]


def test_cuh_decompress_matches_jax_curve(shim, jax_decoded):
    n = ENC.shape[0]
    rows = np.zeros((n, 4, 18), np.int32)
    valid = np.zeros(n, np.uint8)
    shim.shim_reset_mul_count()
    shim.shim_decompress(_ptr(ENC), _ptr(rows), _ptr(valid), n)
    want_rows, want_valid = jax_decoded
    assert valid.tolist() == want_valid.astype(np.uint8).tolist()
    assert np.array_equal(rows, want_rows)
    # what K1 executes: the function's work and the values it recomputes
    muls, sqs = K.k1_executed()
    assert _counts(shim) == (muls * n, sqs * n)


def test_cuh_compress_matches_jax_curve(shim, k4_input, jax_encoded):
    n = k4_input.shape[0]
    out = np.zeros((n, 32), np.uint8)
    shim.shim_reset_mul_count()
    shim.shim_compress(_ptr(np.ascontiguousarray(k4_input.view(np.int32))), _ptr(out), n)
    assert np.array_equal(out, jax_encoded)
    assert _counts(shim) == (K.FIELD_MULS["compress"] * n, K.FIELD_SQS["compress"] * n)


WIDTHS = [26, 25] * 5
OFFSETS = [26 * ((k + 1) // 2) + 25 * (k // 2) for k in range(10)]


def _max_columns():
    """fe_mul's ten column sums with both operands' limbs at 2^w + 2^17 - 1,
    the most a carried limb may hold: the largest columns the carry meets."""
    top = [(1 << w) + (1 << 17) - 1 for w in WIDTHS]
    cols = [0] * 10
    for i in range(10):
        for j in range(10):
            cols[(i + j) % 10] += top[i] * (2 if i & j & 1 else 1) * top[j] * (19 if i + j >= 10 else 1)
    return cols


def test_cuh_carry_matches_python_integers(shim):
    """fe_reduce64 against Python integers: the value mod p is kept, limbs 0
    and 2-9 end exact and limb 1 below 2^25 + 2^17 (the header's carried-limb
    bound, on which fe_mul's column bound rests), on random columns below
    2^62 and on the largest columns fe_mul can make."""
    rng = np.random.default_rng(64)
    cols = rng.integers(0, 1 << 62, (1024, 10), dtype=np.uint64)
    cols[0] = np.array(_max_columns(), dtype=np.uint64)
    cols[1] = (1 << 62) - 1
    cols[2] = 0
    cols[3] = [(1 << w) - 1 for w in WIDTHS]
    out = np.zeros((cols.shape[0], 10), np.uint32)
    shim.shim_reduce64(_ptr(np.ascontiguousarray(cols)), _ptr(out), cols.shape[0])
    for c, h in zip(cols.tolist(), out.tolist()):
        assert sum(v << o for v, o in zip(c, OFFSETS)) % P == sum(v << o for v, o in zip(h, OFFSETS)) % P
    excess = out.astype(np.int64) - (np.int64(1) << np.array(WIDTHS, np.int64))
    assert excess[:, [0, *range(2, 10)]].max() < 0 and excess[:, 1].max() < 1 << 17
    assert np.array_equal(out[3], cols[3].astype(np.uint32))  # exact limbs pass unchanged


def _torsion_rows():
    """K4's edge points: each of four host points (Z != 1) plus each of the
    four 4-torsion points (0, 1), (0, -1), (i, 0), (-i, 0), and the identity's
    coset itself, every one with its coordinates scaled by a random Z.
    P + (0, -1) = (-X, -Y, Z, T), P + (+-i, 0) = (+-iY, +-iX, Z, -T).
    Returns (rows, the points whose encodings they must give)."""
    rng = np.random.default_rng(4)
    i = pf.SQRT_M1
    pts, want = [], []
    for q in HOST_PTS[:4] + [IDENTITY]:
        X, Y, Z, T = q.X, q.Y, q.Z, q.T
        for c in ((X, Y, Z, T), (-X, -Y, Z, T), (i * Y, i * X, Z, -T), (-i * Y, -i * X, Z, -T)):
            lam = int(rng.integers(2, 1 << 62))
            pts.append(tuple(v * lam % P for v in c))
            want.append(q)
    rows = np.stack([NF.from_ints([c[k] for c in pts]) for k in range(4)], axis=1)
    return np.ascontiguousarray(rows.astype(np.int32)), want


def _encode_branches(rows):
    """(rotate, sign flip) of RFC 9496 ENCODE on each row, in Python integers."""
    out = []
    for r in rows.astype(np.int64):
        X, Y, Z, T = (sum(int(v) << (15 * k) for k, v in enumerate(c)) for c in r)
        u1, u2 = (Z + Y) * (Z - Y) % P, X * Y % P
        _, inv = pf.sqrt_ratio_m1(1, u1 * u2 * u2 % P)
        z_inv = inv * u1 % P * (inv * u2 % P) % P * T % P
        rotate = pf.is_negative(T * z_inv)
        x = Y * pf.SQRT_M1 if rotate else X
        out.append((rotate, pf.is_negative(x * z_inv)))
    return out


@pytest.mark.parametrize("torsion", range(4))
def test_cuh_compress_encodes_4_torsion_cosets_alike(shim, torsion):
    """K4's body on each host point plus the 4-torsion point ``torsion``
    (coordinates scaled by a random Z): the coset encodes as its point, the
    identity's as zero.  The edge set as a whole takes both branches of
    rotate and of the sign flip."""
    tors, tors_pts = _torsion_rows()
    assert {b for b in _encode_branches(tors)} == {(r, f) for r in (False, True) for f in (False, True)}
    rows = np.ascontiguousarray(tors[torsion::4])
    out = np.zeros((rows.shape[0], 32), np.uint8)
    shim.shim_compress(_ptr(rows), _ptr(out), rows.shape[0])
    assert [bytes(r) for r in out] == _enc(tors_pts[torsion::4])


def test_cuh_windowed_lanes_matches_fe13_helpers_and_pyref(shim, fe13_reference, k2_plain_rows):
    pts = np.ascontiguousarray(K2_ROWS.view(np.int32))
    out = np.zeros((S_SLOTS, 4, 18), np.int32)
    shim.shim_reset_mul_count()
    shim.shim_windowed_lanes_k8(_ptr(pts), _ptr(K2_DIGITS), _ptr(out), S_SLOTS)
    assert shim.shim_k2_split() == K.K2_SPLIT
    # what the split executes: the function's work and the split's extra doublings
    muls, sqs = K.k2_executed()
    assert _counts(shim) == (muls * S_SLOTS, sqs * S_SLOTS)
    assert np.array_equal(out, k2_plain_rows)
    enc = np.zeros((S_SLOTS, 32), np.uint8)
    shim.shim_compress(_ptr(out), _ptr(enc), S_SLOTS)
    assert [bytes(r) for r in enc] == _row_enc(fe13_reference) == _pyref_slots()


def test_cuh_tile_sums_matches_plain(shim, k3_points):
    assert shim.shim_k3_sub() == K.K3_SUB
    for tile, n_tiles in ((16, 4), (256, 1)):  # one sub-tile; four, reduced again
        rows = np.ascontiguousarray(k3_points[1][-tile * n_tiles :].view(np.int32))
        out = np.zeros((n_tiles, 4, 18), np.int32)
        shim.shim_reset_mul_count()
        shim.shim_tile_sums(_ptr(rows), _ptr(out), n_tiles, tile)
        assert _counts(shim) == (K.FIELD_MULS["tile_sums"] * (tile - 1) * n_tiles, 0)
        assert np.array_equal(out, K.tile_sums(torch.from_numpy(rows), tile).numpy())


def test_cuh_windowed_lane_matches_pallas_helpers_and_plain(shim, k5_reference):
    n = LANE_ROWS.shape[0]
    out = np.zeros((n, 4, 18), np.int32)
    shim.shim_reset_mul_count()
    shim.shim_windowed_lanes(_ptr(np.ascontiguousarray(LANE_ROWS.view(np.int32))), _ptr(LANE_DIGITS), _ptr(out), n)
    assert _counts(shim) == (K.FIELD_MULS["windowed_lanes"] * n, K.FIELD_SQS["windowed_lanes"] * n)
    assert np.array_equal(out, k5_reference)
    enc = np.zeros((n, 32), np.uint8)
    shim.shim_compress(_ptr(out), _ptr(enc), n)
    assert [bytes(r) for r in enc] == _lane_encodings(LANE_SCAL)


def _shim_k6(shim, split):
    out = np.zeros((S_SLOTS, 4, 18), np.int32)
    shim.shim_reset_mul_count()
    assert shim.shim_windowed_lanes_k8_fe15(_ptr(np.ascontiguousarray(K2_ROWS.view(np.int32))), _ptr(K2_DIGITS),
                                            _ptr(out), S_SLOTS, split) == 0
    return out, _counts(shim)


def test_cuh_windowed_lanes_fe15_matches_pallas_helpers_and_k2(shim, k6_reference, k6_plain_rows, k2_plain_rows):
    """K6's body as the kernel runs it, at K6_SPLIT threads a slot."""
    assert shim.shim_k6_split() == K.K6_SPLIT
    out, counts = _shim_k6(shim, K.K6_SPLIT)
    # what the split executes: the function's work and the split's extra doublings
    muls, sqs = K.k6_executed()
    assert counts == (muls * S_SLOTS, sqs * S_SLOTS)
    assert np.array_equal(out, k6_plain_rows)
    assert _row_enc(out) == _row_enc(k6_reference) == _row_enc(k2_plain_rows)  # two tiers, one answer


def test_cuh_windowed_lanes_fe15_unsplit_matches_pallas_helpers_by_rows(shim, k6_reference):
    """K6's body at one thread a slot keeps the TPU kernel's order of
    addition, so it meets _windowed_kernel_k4's algebra row for row, with
    the function's own counts."""
    out, counts = _shim_k6(shim, 1)
    name = "windowed_lanes_k8_fe15"
    assert counts == (K.FIELD_MULS[name] * S_SLOTS, K.FIELD_SQS[name] * S_SLOTS)
    assert K.k6_executed(1) == (K.FIELD_MULS[name], K.FIELD_SQS[name])
    assert np.array_equal(out, k6_reference)


def test_cuh_daa_lanes_matches_pallas_helpers_and_plain(shim, k7_reference):
    """K7's quad body, the four roles of a lane in lockstep: bit for bit the
    JAX kernel's rows and the plain version's."""
    assert shim.shim_k7_quad() == 4
    n = LANE_ROWS.shape[0]
    out = np.zeros((n, 4, 18), np.int32)
    shim.shim_reset_mul_count()
    shim.shim_daa_lanes(_ptr(np.ascontiguousarray(LANE_ROWS.view(np.int32))),
                        _ptr(np.ascontiguousarray(DAA_WORDS.view(np.int32))), _ptr(out), n)
    # what the select executes: an addition on every step
    muls, sqs = K.k7_executed()
    assert _counts(shim) == (muls * n, sqs * n)
    assert np.array_equal(out, k7_reference)
    words = torch.from_numpy(DAA_WORDS.view(np.int32))
    assert np.array_equal(out, K.daa_lanes(torch.from_numpy(LANE_ROWS.view(np.int32)), words).numpy())


def test_cuh_fe15_tier_matches_pyref_field(shim):
    """The 15-bit tier's mul, squaring and subtraction against big-int
    arithmetic, on rows up to the boundary's bound (limbs < 2^17), p - 1, p,
    0 and all-ones among them."""
    rng = np.random.default_rng(15)
    n = 512
    f = rng.integers(0, 1 << 17, (n, 18), dtype=np.int64)
    g = rng.integers(0, 1 << 15, (n, 18), dtype=np.int64)
    f[0], g[0] = (1 << 17) - 1, (1 << 17) - 1
    f[1], g[1] = NF.from_ints([P - 1])[0], NF.from_ints([P - 1])[0]
    f[2], g[2] = NF.from_ints([P])[0], 0
    f[3], g[3] = 0, NF.from_ints([1])[0]
    f, g = np.ascontiguousarray(f.astype(np.int32)), np.ascontiguousarray(g.astype(np.int32))
    outs = [np.zeros((n, 18), np.int32) for _ in range(3)]
    shim.shim_fe15(_ptr(f), _ptr(g), *(_ptr(o) for o in outs), n)

    def ints(rows):
        return [sum(int(v) << (15 * k) for k, v in enumerate(r)) for r in rows]

    fi, gi = ints(f), ints(g)
    for got, want in zip(outs, ([a * b % P for a, b in zip(fi, gi)], [a * a % P for a in fi],
                                [(a - b) % P for a, b in zip(fi, gi)])):
        assert ints(got) == want  # canonical rows: the value itself, below p
        assert got.max() < (1 << 15) and got.min() >= 0


# -- K8 -----------------------------------------------------------------------


def _k8_cases():
    """K8's addends: host points (Z != 1), the identity and the 4-torsion
    cosets of the K4 edge set (Z scaled) as the columns b, the same reversed
    as the rows a; an R x n grid (11 rows of them against all 29), one row
    against every column (1 x n) and every row against one column (R x 1).
    Yields (a rows, b rows, a points, b points) with the points the rows
    encode as."""
    tors, tors_pts = _torsion_rows()
    rows = np.concatenate([_rows(HOST_PTS).astype(np.int32), tors])
    pts = HOST_PTS + tors_pts
    rev_rows, rev_pts = np.ascontiguousarray(rows[::-1]), pts[::-1]
    yield np.ascontiguousarray(rev_rows[5:16]), rows, rev_pts[5:16], pts
    yield rev_rows[3:4].copy(), rows, rev_pts[3:4], pts
    yield rev_rows, rows[-1:].copy(), rev_pts, pts[-1:]


@pytest.mark.parametrize("case", range(3))
def test_add_compress_plain_matches_numpy_curve_and_pyref(case):
    """K8's plain version on its R x n grid against the numpy curve's add and
    compress (the JAX package's ECDLP rounds) over the same lanes and
    pyref, with every column's sums kept, only the last column's and
    none."""
    a, b, a_pts, b_pts = list(_k8_cases())[case]
    R, n = a.shape[0], b.shape[0]
    nc = numpy_curve()
    lanes = [np.repeat(a, n, axis=0), np.tile(b, (R, 1, 1))]  # lane r n + j: a[r], b[j]
    want_sum = nc.add(*(tuple(x.view(np.uint32)[:, c, :] for c in range(4)) for x in lanes))
    want_enc = np.asarray(nc.compress(want_sum))
    assert [bytes(r) for r in want_enc] == _enc([p + q for p in a_pts for q in b_pts])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want_rows = _canon_rows(want_sum).reshape(R, n, 4, 18)
    for sums_from in (0, n - 1, None):
        enc, sums = K.add_compress(ta, tb, sums_from)
        assert np.array_equal(enc.numpy(), want_enc.reshape(R, n, 32))
        if sums_from is None:
            assert sums is None
        else:
            assert np.array_equal(sums.numpy(), want_rows[:, sums_from:])


def test_cuh_add_compress_matches_plain(shim):
    """K8's body and lane indexing built for the host against its plain
    version, rows and encodings, on each grid with the sums of the columns
    from 1 on; its field operations a lane are FIELD_MULS /
    FIELD_SQS["add_compress"]."""
    for a, b, _, _ in _k8_cases():
        R, n = a.shape[0], b.shape[0]
        sums_from = min(1, n - 1)
        enc, sums = np.zeros((R, n, 32), np.uint8), np.zeros((R, n - sums_from, 4, 18), np.int32)
        shim.shim_reset_mul_count()
        shim.shim_add_compress(_ptr(a), _ptr(b), _ptr(enc), _ptr(sums), R, n, sums_from)
        assert _counts(shim) == (K.FIELD_MULS["add_compress"] * R * n, K.FIELD_SQS["add_compress"] * R * n)
        want_enc, want_sums = K.add_compress_plain(torch.from_numpy(a), torch.from_numpy(b), sums_from)
        assert np.array_equal(enc, want_enc.numpy())
        assert np.array_equal(sums, want_sums.numpy())


# -- K9, K10 --------------------------------------------------------------------

PIP_WINDOW = 10  # 26 windows of 1,023 buckets: K10 at 8 pieces of 64 quads, 2 buckets a chunk


def _pippenger_cases():
    """(scalars, points) of 24 lanes: the edge scalars and random ones, an
    identity point and repeated points; then the same lanes with one scalar
    repeated on all but two, so that in each window one bucket holds most
    of the lanes."""
    pts = LANE_PTS
    yield LANE_SCAL, pts
    skew = [LANE_SCAL[5]] * (len(pts) - 2) + [0, L - 1]
    yield skew, pts


def _k9_inputs(scalars, points, c=PIP_WINDOW):
    from xelis_he_tpu_torch.ops.msm import bucket_runs, decompose_digits

    order, offsets = bucket_runs(decompose_digits(scalars, c), c, "cpu")
    return np.ascontiguousarray(_rows(points).view(np.int32)), order, offsets


@pytest.mark.parametrize("case", range(2))
def test_bucket_sums_plain_is_the_jax_packages_scan(case):
    """K9's plain version, window by window, against the JAX package's
    segmented scan (numpy) over the same sorted lanes: the buckets' last
    elements, row for row."""
    from xelis_he_tpu.ops.msm import _inclusive_scan as jax_scan

    rows, order, offsets = _k9_inputs(*list(_pippenger_cases())[case])
    got = K.bucket_sums(torch.from_numpy(rows), order, offsets).numpy()
    nc, nb = numpy_curve(), (1 << PIP_WINDOW)
    for w in range(order.shape[0]):
        off = offsets[w].numpy().astype(np.int64)
        ds = np.repeat(np.arange(nb), np.diff(off))
        flags = ds != np.concatenate([ds[:1] - 1, ds[:-1]])
        lanes = order[w].numpy()
        _, scanned = jax_scan(nc, flags, tuple(rows.view(np.uint32)[lanes, c, :] for c in range(4)), False)
        want = np.tile(K.identity_rows(1, "cpu").numpy(), (nb - 1, 1, 1))
        for b in range(1, nb):
            if off[b + 1] > off[b]:
                want[b - 1] = _canon_rows(tuple(c[off[b + 1] - 1][None] for c in scanned))[0]
        assert np.array_equal(got[w], want)


def _shim_k9(shim, rows, order, offsets):
    """K9's passes through the host build, on the plan of K.bucket_passes:
    (the bucket sums, each pass's threads).  The last pass splits no run."""
    W, nb, n = order.shape[0], offsets.shape[1] - 1, rows.shape[0]
    out = np.zeros((W, nb - 1, 4, 18), np.int32)
    plan = list(K.bucket_passes(offsets, n))
    assert len(plan) == K.k9_passes(n)
    assert int((plan[-1][2][1:] - plan[-1][2][:-1]).max()) <= 1
    src, threads = None, []
    for p, (start, length, first) in enumerate(plan):
        threads.append(int(first[-1]))
        dst = np.zeros((max(threads[-1], 1), K.GE_WORDS), np.int32)
        arrays = [np.ascontiguousarray(t.numpy()) for t in (start, length, first)]
        shim.shim_bucket_pass(_ptr(rows), _ptr(order.numpy()) if p == 0 else None, None if p == 0 else _ptr(src),
                              *(_ptr(a) for a in arrays), W * (nb - 1), _ptr(out), _ptr(dst))
        src = dst
    return out, threads


@pytest.mark.parametrize("case", range(2))
def test_cuh_bucket_sums_matches_plain(shim, case):
    """K9's passes built for the host, thread by thread: the plain
    version's rows, and the run's length - 1 additions a bucket."""
    assert shim.shim_k9_k() == K.K9_K
    rows, order, offsets = _k9_inputs(*list(_pippenger_cases())[case])
    shim.shim_reset_mul_count()
    out, _ = _shim_k9(shim, rows, order, offsets)
    assert _counts(shim) == (K.FIELD_MULS["bucket_sums"] * K.bucket_additions(offsets), 0)
    assert np.array_equal(out, K.bucket_sums(torch.from_numpy(rows), order, offsets).numpy())


K9_BLOCK = 1 << K.K9_K
K9_RUNS = [1, 2, K9_BLOCK - 1, K9_BLOCK, K9_BLOCK + 1, 3 * K9_BLOCK + 5]


def _k9_runs(runs, c=3):
    """One window of 2^c buckets whose buckets 1.. hold ``runs`` lanes (two
    lanes of digit 0 first, the rest empty), over points mul_base(i + 5) in
    a shuffled order: (rows, order, offsets)."""
    counts = [2, *runs] + [0] * ((1 << c) - 1 - len(runs))
    n = sum(counts)
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)[None])
    order = torch.from_numpy(np.random.default_rng(n).permutation(n).astype(np.int32)[None])
    rows = np.ascontiguousarray(_rows([mul_base(i + 5) for i in range(n)]).view(np.int32))
    return rows, order, offsets


@pytest.mark.parametrize("runs", [[r] for r in K9_RUNS] + [[1, 0, K9_BLOCK + 1, 2], [8 * K9_BLOCK * K9_BLOCK]],
                         ids=[f"run{r}" for r in K9_RUNS] + ["mixed", "all-but-two"])
def test_cuh_bucket_passes_match_plain_at_run_lengths(shim, runs):
    """K9's passes built for the host against the plain version on runs of
    1, 2, 2^k - 1, 2^k, 2^k + 1 and 3 2^k + 5 lanes (each beside an empty
    bucket and digit 0's two lanes), a mix, and one bucket that holds every
    lane but two (three passes or more): rows, the additions
    (``bucket_additions``: a run's length - 1), and in every pass no run
    longer than 2^k left to one thread."""
    rows, order, offsets = _k9_runs(runs)
    shim.shim_reset_mul_count()
    out, threads = _shim_k9(shim, rows, order, offsets)
    assert K.bucket_additions(offsets) == sum(max(r - 1, 0) for r in runs)
    assert _counts(shim) == (K.FIELD_MULS["bucket_sums"] * K.bucket_additions(offsets), 0)
    assert np.array_equal(out, K.bucket_sums(torch.from_numpy(rows), order, offsets).numpy())
    for _, length, first in K.bucket_passes(offsets, rows.shape[0]):
        blocks = first[1:] - first[:-1]
        assert bool((length[blocks == 1] <= K9_BLOCK).all())  # a run one thread walks whole
        assert bool((blocks[length > K9_BLOCK] >= 2).all())  # a longer one is split into blocks
    if max(runs) > K9_BLOCK * K9_BLOCK:
        assert len(threads) >= 3 and threads[1] > 1 and threads[2] >= 1


@pytest.mark.parametrize("file, values", [("add_compress.cu", {"K8_THREADS": t, "K8_REGISTERS": r})
                                          for t, r in BK.K8_SHAPES] + [("ed25519.cuh", {"K9_K": k}) for k in BK.K9_KS],
                         ids=[f"k8-{t}x{r}" for t, r in BK.K8_SHAPES] + [f"k9-k{k}" for k in BK.K9_KS])
def test_variant_sources_change_only_their_constants(file, values):
    """The block-shape script's variants (``scripts/bench_k8_k9``): each is
    the kernel's source with only its constants' definitions changed, and a
    constant the source does not define exactly once is refused."""
    src = (_build.CSRC / file).read_text()
    out = BK.substitute(src, values)
    assert len(out.splitlines()) == len(src.splitlines())
    for a, b in zip(src.splitlines(), out.splitlines()):
        const = next((c for c in values if a.startswith(f"constexpr int {c} = ")), None)
        assert b == a if const is None else b.startswith(f"constexpr int {const} = {values[const]};")
    assert all(sum(line.startswith(f"constexpr int {c} = ") for line in src.splitlines()) == 1 for c in values)
    with pytest.raises(RuntimeError, match="0 definitions of K8_MISSING"):
        BK.substitute(src, {"K8_MISSING": 1})


# K10's cases: (lanes of _pippenger_cases, c, shape or None for k10_shape,
# one window only): the window of the tests above (8 pieces of 64 quads),
# several pieces a window at c = 8 given by hand, one window (the engine's
# _window_sum, on scalars below 2^c) and c = 2 (one piece of 2 quads)
K10_CASES = {"0": (0, PIP_WINDOW, None, False), "1": (1, PIP_WINDOW, None, False),
             "c8-g2-q64": (0, 8, (2, 64), False), "c8-g4-q16": (1, 8, (4, 16), False),
             "c8-one-window": (0, 8, None, True), "c2": (1, 2, None, False)}


@pytest.mark.parametrize("case", list(K10_CASES))
def test_cuh_window_sums_matches_plain_and_pyref(shim, case):
    """K10's body built for the host (each piece's quads stepped between
    barriers, each window's combine of its pieces, the Horner chain; every
    quad's roles one after the other): the plain version's rows at the same
    shape, its executed
    work, and the MSM's encoding as pyref computes it (and, at several pieces
    a window, the JAX package's numpy engine)."""
    from xelis_he_tpu.ops.msm import MsmEngine as JaxMsmEngine

    assert shim.shim_k10_max_threads() == K.K10_MAX_THREADS
    lanes, c, shape, one_window = K10_CASES[case]
    scalars, points = list(_pippenger_cases())[lanes]
    if one_window:
        scalars = [s % (1 << c) for s in scalars]
    buckets = K.bucket_sums(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                              for a in _k9_inputs(scalars, points, c)))
    if one_window:
        buckets = buckets[:1].contiguous()
    W = buckets.shape[0]
    G, Q = shape or K.k10_shape(W, c)
    out = np.zeros((1, 4, 18), np.int32)
    shim.shim_reset_mul_count()
    shim.shim_window_sums(_ptr(np.ascontiguousarray(buckets.numpy())), _ptr(out), W, c, G, Q)
    adds, dbls_t, dbls = K.k10_executed(W, c, shape)
    assert _counts(shim) == (adds * K.FIELD_MULS["window_sums"] + dbls_t * K.DBL_MULS + dbls * K.DBL_NO_T_MULS,
                             (dbls_t + dbls) * K.DBL_SQS)
    with plain_calls() as calls:
        want = K.window_sums(buckets, shape).numpy()
    assert calls["window_sums"] == 1
    assert np.array_equal(out, want)
    assert _row_enc(out) == [multiscalar_mul(scalars, points).compress()]
    if case == "c8-g4-q16":  # the JAX package's numpy engine too (~10 s a call here)
        assert _row_enc(out) == [JaxMsmEngine(numpy_curve(), window=c).msm_points(scalars, points).compress()]
    # the bound's work: the running-sum method's additions and Horner's
    # doublings, under what the pieces execute
    work_adds, work_dbls = K.window_sums_work(W, c)
    assert work_adds <= adds and work_dbls <= dbls_t + dbls


@pytest.mark.parametrize("c,n", [(2, 3), (13, 2)])
def test_cuh_k10_rounds_match_plain_and_pyref(shim, c, n):
    """K10's chain-rounds aid (window_sums.cu k10_rounds_kernel, the floor
    of its Horner chain) built for the host, the quad's roles one after the
    other: the plain version's rows, n c doublings (n of them with T) and n
    additions, and pyref's point: p times Horner's sum of n + 1 ones in base
    2^c.  The wrapper refuses a malformed point, c outside 1..24 and n < 1."""
    p = mul_base(0x5EED + c)
    rows = torch.from_numpy(np.ascontiguousarray(_rows([p]).view(np.int32)))
    out = np.zeros((1, 4, 18), np.int32)
    shim.shim_reset_mul_count()
    shim.shim_k10_rounds(_ptr(rows.numpy()), _ptr(out), c, n)
    assert _counts(shim) == (n * (K.FIELD_MULS["window_sums"] + K.DBL_MULS + (c - 1) * K.DBL_NO_T_MULS),
                             n * c * K.DBL_SQS)
    assert np.array_equal(out, K.k10_rounds(rows, c, n).numpy())
    s = 1
    for _ in range(n):
        s = (s << c) + 1
    assert _row_enc(out) == [multiscalar_mul([s], [p]).compress()]
    for bad in ((rows[0], c, n), (rows, 0, n), (rows, 25, n), (rows, c, 0)):
        with pytest.raises(ValueError):
            K.k10_rounds(*bad)


def test_k10_shape_fills_the_card_within_its_limits():
    """k10_shape: the main shape (c = 13, 20 windows) in 320 blocks of 64
    quads, 8 buckets a quad; one window in 64 pieces; every c from 1 to 24
    and W from 1 to 256 within what the kernel takes (powers of two, G <= Q,
    4 Q <= K10_MAX_THREADS, 2 G Q <= 2^c), with W G blocks filling the card
    twice wherever the limits allow."""
    assert K.k10_shape(20, 13) == (16, 64) and K.k10_shape(1, 13) == (64, 64)
    for c in range(1, 25):
        for W in (1, 2, 20, 26, 256):
            G, Q = K.k10_shape(W, c)
            K._check_k10_shape(c, (G, Q))
            assert W * G >= K.K10_FILL_BLOCKS or 2 * G > Q or 4 * G * Q > 1 << c
    for bad in ((3, 64), (128, 64), (16, 512), (1, 128), (64, 64)):
        with pytest.raises(ValueError):
            K.window_sums(torch.zeros((1, 255, 4, 18), dtype=torch.int32), bad)
    for part in ("phase1", "serial", "chain"):  # the parts time the card
        with pytest.raises(ValueError):
            K.window_sums(torch.zeros((1, 255, 4, 18), dtype=torch.int32), part=part)
