"""The plain versions of the port's four kernels (xelis_he_tpu_torch.ops.kernels)
against the JAX package, on identical numpy inputs, and the CUDA kernels'
shared arithmetic (csrc/ed25519.cuh) built for the host with g++.

The JAX references are the plain ones, not the Pallas kernels in interpret
mode (minutes per call on a CPU): ``jax_curve()`` for K1/K4, the 13-bit
helpers of ``pallas_msm`` composed as ``_windowed_kernel_k4_fe13`` composes
them for K2 (they take their array module as an argument; numpy runs them
without a compile), ``msm._tree_reduce`` for K3, and pyref throughout.  The
CUDA kernels themselves run only on the card (chip_smoke.py)."""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xelis_he_tpu.ops import pallas_msm as pm
from xelis_he_tpu.ops.curve import jax_curve, numpy_curve
from xelis_he_tpu.ops.fe import numpy_field
from xelis_he_tpu.ops.msm import _tree_reduce
from xelis_he_tpu.pyref import field as pf
from xelis_he_tpu.pyref.ristretto import IDENTITY, L, mul_base, multiscalar_mul
from xelis_he_tpu_torch.ops import kernels as K

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


def _pyref_slots():
    out = []
    for s in range(S_SLOTS):
        lanes = [k * S_SLOTS + s for k in range(K.K_PACK)]
        out.append(multiscalar_mul([K2_SCAL[i] for i in lanes], [K2_PTS[i] for i in lanes]).compress())
    return out


def test_windowed_lanes_plain_matches_fe13_helpers_and_pyref(fe13_reference):
    out = K.windowed_lanes_k8(torch.from_numpy(K2_ROWS.view(np.int32)), torch.from_numpy(K2_DIGITS))
    # the same point formulas on both tiers: identical projective points
    assert np.array_equal(out.numpy(), fe13_reference)
    assert [bytes(r) for r in K.compress(out).numpy()] == _pyref_slots()


def test_recode_signed4_matches_pallas_msm():
    scal = EDGE_SCALARS + _rand_scalars(56)
    want = pm.recode_signed4(scal)
    assert np.array_equal(K.recode_signed4(scal), want)
    raw = np.frombuffer(b"".join(s.to_bytes(32, "little") for s in scal), np.uint8).reshape(-1, 32)
    assert np.array_equal(K.recode_signed4(raw), want)
    assert np.array_equal(K.recode_signed4_torch(torch.from_numpy(raw.copy())).numpy(), want)
    assert np.array_equal(pm.recode_signed4_xp(raw, np), want)


# -- K3 -----------------------------------------------------------------------


def test_tile_sums_plain_matches_tree_reduce():
    tile, n_tiles = 8, 4
    pts = [mul_base(s) for s in _rand_scalars(tile * n_tiles - 6)] + [IDENTITY] * 6
    rows = _rows(pts)
    out = K.tile_sums(torch.from_numpy(rows.view(np.int32)), tile)
    nc = numpy_curve()
    for t in range(n_tiles):
        coords = tuple(rows[t * tile : (t + 1) * tile, c, :] for c in range(4))
        want = _tree_reduce(nc, coords, tile)  # lane i + half onto lane i, as K3
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
    assert K.launches == {"decompress": 0, "windowed_lanes_k8": 0, "tile_sums": 0, "compress": 0}


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
        ["g++", "-x", "c++", "-DXHE_HD=", "-DXHE_COUNT_MULS", "-O2", "-shared", "-fPIC",
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
    lib.shim_square.argtypes = [vp, vp, vp, i]
    lib.shim_mul_count.restype = ctypes.c_ulonglong
    lib.shim_sq_count.restype = ctypes.c_ulonglong
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _counts(shim):
    return shim.shim_mul_count(), shim.shim_sq_count()


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
    assert _counts(shim) == (K.FIELD_MULS["decompress"] * n, K.FIELD_SQS["decompress"] * n)


def test_cuh_compress_matches_jax_curve(shim, k4_input, jax_encoded):
    n = k4_input.shape[0]
    out = np.zeros((n, 32), np.uint8)
    shim.shim_reset_mul_count()
    shim.shim_compress(_ptr(np.ascontiguousarray(k4_input.view(np.int32))), _ptr(out), n)
    assert np.array_equal(out, jax_encoded)
    assert _counts(shim) == (K.FIELD_MULS["compress"] * n, K.FIELD_SQS["compress"] * n)


def test_cuh_windowed_lanes_matches_fe13_helpers_and_pyref(shim, fe13_reference):
    out = np.zeros((S_SLOTS, 4, 18), np.int32)
    shim.shim_reset_mul_count()
    shim.shim_windowed_lanes_k8(_ptr(np.ascontiguousarray(K2_ROWS.view(np.int32))), _ptr(K2_DIGITS),
                                _ptr(out), S_SLOTS)
    assert _counts(shim) == (K.FIELD_MULS["windowed_lanes_k8"] * S_SLOTS, K.FIELD_SQS["windowed_lanes_k8"] * S_SLOTS)
    assert np.array_equal(out, fe13_reference)
    enc = np.zeros((S_SLOTS, 32), np.uint8)
    shim.shim_compress(_ptr(out), _ptr(enc), S_SLOTS)
    assert [bytes(r) for r in enc] == _pyref_slots()


def test_cuh_tile_sums_matches_plain(shim):
    tile, n_tiles = 16, 4
    rows = _rows([mul_base(s) for s in _rand_scalars(tile * n_tiles - 3)] + [IDENTITY] * 3)
    rows = np.ascontiguousarray(rows.view(np.int32))
    out = np.zeros((n_tiles, 4, 18), np.int32)
    shim.shim_reset_mul_count()
    shim.shim_tile_sums(_ptr(rows), _ptr(out), n_tiles, tile)
    assert _counts(shim) == (K.FIELD_MULS["tile_sums"] * (tile - 1) * n_tiles, 0)
    assert np.array_equal(out, K.tile_sums(torch.from_numpy(rows), tile).numpy())
