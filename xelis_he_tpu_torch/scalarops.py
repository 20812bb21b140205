"""Batched host scalar arithmetic mod L (C++ engine, numpy byte-array API).

The proof-verification fold (bulletproofs ``verify_batch``, inner-product
``verification_scalars``) does thousands of 255-bit modular multiplies per
block; in Python ints that is the single biggest host cost.  This module
routes those as BATCHED operations over (n, 32) little-endian uint8 numpy
arrays into ``csrc/scalarops.cpp`` (4x64-limb Montgomery).

Falls back to pure Python (xelis_he_tpu_torch.scalars) when the native library
is unavailable; the API is identical.
"""

from __future__ import annotations

import numpy as np

from . import scalars as _sc

L = _sc.L

try:
    from .hashcore.scalarops_native import lib as _lib
except Exception:  # pragma: no cover
    _lib = None

HAVE_NATIVE = _lib is not None


# -- conversions -------------------------------------------------------------


def ints_to_array(vals) -> np.ndarray:
    """list[int] -> (n, 32) uint8 little-endian canonical array."""
    raw = b"".join((v % L).to_bytes(32, "little") for v in vals)
    return np.frombuffer(raw, dtype=np.uint8).reshape(len(vals), 32).copy()


def array_to_ints(arr: np.ndarray) -> list[int]:
    data = arr.astype(np.uint8, copy=False).tobytes()
    return [int.from_bytes(data[i * 32 : i * 32 + 32], "little") for i in range(arr.shape[0])]


def int_to_bytes32(v: int) -> bytes:
    return (v % L).to_bytes(32, "little")


def _as_arr(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(x, dtype=np.uint8)
    return ints_to_array(x)


def _one(v: int) -> np.ndarray:
    """Single scalar as a (1, 32) array without list/join overhead."""
    return np.frombuffer((v % L).to_bytes(32, "little"), dtype=np.uint8).reshape(1, 32)


def _ptr(a: np.ndarray) -> int:
    # raw address int: the native argtypes are c_void_p, so no per-call
    # ctypes cast object is allocated
    return a.ctypes.data


# -- batched ops --------------------------------------------------------------


def mul(a, b) -> np.ndarray:
    a, b = _as_arr(a), _as_arr(b)
    n = a.shape[0]
    if _lib is None:
        return ints_to_array([x * y % L for x, y in zip(array_to_ints(a), array_to_ints(b))])
    out = np.empty_like(a)
    _lib.xhe_sc_mul(_ptr(a), _ptr(b), _ptr(out), n)
    return out


def muls(a, s: int) -> np.ndarray:
    """out[i] = a[i] * s."""
    a = _as_arr(a)
    n = a.shape[0]
    if _lib is None:
        return ints_to_array([x * s % L for x in array_to_ints(a)])
    sb = _one(s)
    out = np.empty_like(a)
    _lib.xhe_sc_muls(_ptr(a), _ptr(sb), _ptr(out), n)
    return out


def add(a, b) -> np.ndarray:
    a, b = _as_arr(a), _as_arr(b)
    if _lib is None:
        return ints_to_array([(x + y) % L for x, y in zip(array_to_ints(a), array_to_ints(b))])
    out = np.empty_like(a)
    _lib.xhe_sc_add(_ptr(a), _ptr(b), _ptr(out), a.shape[0])
    return out


def sub(a, b) -> np.ndarray:
    a, b = _as_arr(a), _as_arr(b)
    if _lib is None:
        return ints_to_array([(x - y) % L for x, y in zip(array_to_ints(a), array_to_ints(b))])
    out = np.empty_like(a)
    _lib.xhe_sc_sub(_ptr(a), _ptr(b), _ptr(out), a.shape[0])
    return out


def axpy_(acc: np.ndarray, a, s: int) -> np.ndarray:
    """acc[i] = acc[i] + a[i]*s, in place on ``acc`` (the fold primitive)."""
    a = _as_arr(a)
    assert acc.shape == a.shape and acc.dtype == np.uint8
    if _lib is None:
        res = ints_to_array(
            [(x + y * s) % L for x, y in zip(array_to_ints(acc), array_to_ints(a))]
        )
        acc[:] = res
        return acc
    sb = _one(s)
    _lib.xhe_sc_axpy(_ptr(acc), _ptr(a), _ptr(sb), acc.shape[0])
    return acc


def affine(a, m: int, c: int) -> np.ndarray:
    """out[i] = a[i]*m + c."""
    a = _as_arr(a)
    if _lib is None:
        return ints_to_array([(x * m + c) % L for x in array_to_ints(a)])
    out = muls(a, m)
    cb = np.tile(_one(c), (a.shape[0], 1))
    return add(out, cb)


def powers(x: int, n: int) -> np.ndarray:
    """[1, x, x^2, ..., x^(n-1)]."""
    if _lib is None:
        return ints_to_array(_exp_iter_py(x, n))
    xb = _one(x)
    out = np.empty((n, 32), dtype=np.uint8)
    _lib.xhe_sc_powers(_ptr(xb), _ptr(out), n)
    return out


def _exp_iter_py(x: int, n: int) -> list[int]:
    out = [1]
    for _ in range(n - 1):
        out.append(out[-1] * x % L)
    return out


def inner(a, b) -> int:
    a, b = _as_arr(a), _as_arr(b)
    if _lib is None:
        return sum(x * y for x, y in zip(array_to_ints(a), array_to_ints(b))) % L
    out = np.empty((1, 32), dtype=np.uint8)
    _lib.xhe_sc_inner(_ptr(a), _ptr(b), _ptr(out), a.shape[0])
    return int.from_bytes(out.tobytes(), "little")


def batch_invert(a) -> np.ndarray:
    """out[i] = a[i]^-1 (zero -> zero)."""
    a = _as_arr(a)
    if _lib is None:
        vals = array_to_ints(a)
        return ints_to_array([pow(v, L - 2, L) if v else 0 for v in vals])
    out = np.empty_like(a)
    _lib.xhe_sc_invert(_ptr(a), _ptr(out), a.shape[0])
    return out


def invert(x: int) -> int:
    if _lib is None:
        return pow(x, L - 2, L)
    return array_to_ints(batch_invert([x]))[0]


def ipp_s_vector(u_sq: list[int], u_inv: list[int], n: int) -> np.ndarray:
    """Inner-product-argument s vector: s[0] = prod(u_inv); for i>0 with
    highest set bit 2^k: s[i] = s[i - 2^k] * u_sq[lg_n - 1 - k]."""
    lg_n = len(u_sq)
    assert n == 1 << lg_n
    if _lib is None:
        s = [1]
        for u in u_inv:
            s[0] = s[0] * u % L
        for i in range(1, n):
            k = i.bit_length() - 1
            s.append(s[i - (1 << k)] * u_sq[lg_n - 1 - k] % L)
        return ints_to_array(s)
    usq = ints_to_array(u_sq)
    uin = ints_to_array(u_inv)
    out = np.empty((n, 32), dtype=np.uint8)
    _lib.xhe_sc_ipp_s(_ptr(usq), _ptr(uin), lg_n, _ptr(out), n)
    return out


def bp_h_vector(
    y_inv_pow: np.ndarray, z_pow: np.ndarray, s: np.ndarray, z: int, zz: int, b: int, n_bits: int, m: int
) -> np.ndarray:
    """h[i] = z + y_inv_pow[i]*(zz*z_pow[i//n]*2^(i%n) - b*s_inv[i])."""
    nm = n_bits * m
    if _lib is None:
        yi = array_to_ints(_as_arr(y_inv_pow))
        zp = array_to_ints(_as_arr(z_pow))
        sv = array_to_ints(_as_arr(s))
        out = [
            (z + yi[i] * ((zz * zp[i // n_bits] % L * ((1 << (i % n_bits)) % L) - b * sv[nm - 1 - i]) % L)) % L
            for i in range(nm)
        ]
        return ints_to_array(out)
    yp, zp, sa = _as_arr(y_inv_pow), _as_arr(z_pow), _as_arr(s)
    zb, zzb, bb = _one(z), _one(zz), _one(b)
    out = np.empty((nm, 32), dtype=np.uint8)
    _lib.xhe_sc_bp_h(
        _ptr(yp), _ptr(zp), _ptr(sa), _ptr(zb), _ptr(zzb), _ptr(bb), n_bits, m, _ptr(out)
    )
    return out
