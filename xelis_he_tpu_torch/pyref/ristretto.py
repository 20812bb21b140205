"""Exact host-side Ristretto group (Python ints).

Ground truth for the batched TPU engine (``xelis_he_tpu_torch.ops.curve``) and the
workhorse for small one-off host operations (keygen, signing, transcripts).
Independent implementation of ristretto255 per RFC 9496; capability parity
with the reference's curve25519-dalek fork (SURVEY.md D3/D4): point ops,
compress/decompress with validation, Elligator2 ``from_uniform_bytes``,
variable-base and fixed-base scalar multiplication, and multiscalar mul.

Points are immutable extended-Edwards coordinate tuples handled by the
``RistrettoPoint`` class.  Scalars are Python ints (callers reduce mod L).
"""

from __future__ import annotations

from .field import (
    P,
    D,
    SQRT_M1,
    INVSQRT_A_MINUS_D,
    ONE_MINUS_D_SQ,
    D_MINUS_ONE_SQ,
    SQRT_AD_MINUS_ONE,
    fe_abs,
    fe_from_bytes,
    fe_to_bytes,
    invert,
    is_negative,
    sqrt_ratio_m1,
)

# Group order (same L as the scalar field; re-declared here to avoid a cycle)
L = 2**252 + 27742317777372353535851937790883648493

# Optional host C++ engine (hashcore/csrc/curve25519.cpp): mirrors these
# exact formulas at ~20-100x the speed.  The pure-Python path below remains
# the ground truth (RFC 9496 vectors + cross-checks in tests) and the
# fallback; set XELIS_HE_TPU_NO_CURVE_NATIVE=1 to force it.
try:  # pragma: no cover - exercised via the public API either way
    from ..hashcore.curve_native import lib as _clib
except Exception:  # pragma: no cover
    _clib = None


def _pack_pt(p: "RistrettoPoint") -> bytes:
    return (
        (p.X % P).to_bytes(32, "little")
        + (p.Y % P).to_bytes(32, "little")
        + (p.Z % P).to_bytes(32, "little")
        + (p.T % P).to_bytes(32, "little")
    )


def _unpack_pt(b: bytes) -> "RistrettoPoint":
    return RistrettoPoint(
        int.from_bytes(b[0:32], "little"),
        int.from_bytes(b[32:64], "little"),
        int.from_bytes(b[64:96], "little"),
        int.from_bytes(b[96:128], "little"),
    )


class RistrettoPoint:
    """A ristretto255 group element in extended Edwards coordinates (X:Y:Z:T),
    with x*y = T*Z, -x^2 + y^2 = 1 + d*x^2*y^2."""

    __slots__ = ("X", "Y", "Z", "T")

    def __init__(self, X: int, Y: int, Z: int, T: int):
        self.X = X
        self.Y = Y
        self.Z = Z
        self.T = T

    # -- group operations ---------------------------------------------------

    def __add__(self, other: "RistrettoPoint") -> "RistrettoPoint":
        # Extended coordinates addition (add-2008-hwcd-3), a = -1.
        if _clib is not None:
            out = bytes(128)
            _clib.xhe_pt_add(_pack_pt(self), _pack_pt(other), out)
            return _unpack_pt(out)
        X1, Y1, Z1, T1 = self.X, self.Y, self.Z, self.T
        X2, Y2, Z2, T2 = other.X, other.Y, other.Z, other.T
        A = (Y1 - X1) * (Y2 - X2) % P
        B = (Y1 + X1) * (Y2 + X2) % P
        C = T1 * (2 * D) % P * T2 % P
        Dd = 2 * Z1 * Z2 % P
        E = B - A
        F = Dd - C
        G = Dd + C
        H = B + A
        return RistrettoPoint(E * F % P, G * H % P, F * G % P, E * H % P)

    def __sub__(self, other: "RistrettoPoint") -> "RistrettoPoint":
        return self + (-other)

    def __neg__(self) -> "RistrettoPoint":
        return RistrettoPoint((-self.X) % P, self.Y, self.Z, (-self.T) % P)

    def double(self) -> "RistrettoPoint":
        # dbl-2008-hwcd, a = -1.
        if _clib is not None:
            out = bytes(128)
            _clib.xhe_pt_dbl(_pack_pt(self), out)
            return _unpack_pt(out)
        X1, Y1, Z1 = self.X, self.Y, self.Z
        A = X1 * X1 % P
        B = Y1 * Y1 % P
        C = 2 * Z1 * Z1 % P
        H = A + B
        E = (H - (X1 + Y1) * (X1 + Y1)) % P
        G = A - B
        F = C + G
        return RistrettoPoint(E * F % P, G * H % P, F * G % P, E * H % P)

    def __rmul__(self, scalar: int) -> "RistrettoPoint":
        return self.scalar_mul(scalar)

    def scalar_mul(self, scalar: int) -> "RistrettoPoint":
        k = scalar % L
        if _clib is not None:
            out = bytes(128)
            _clib.xhe_pt_mul(k.to_bytes(32, "little"), _pack_pt(self), out)
            return _unpack_pt(out)
        acc = IDENTITY
        add = self
        while k:
            if k & 1:
                acc = acc + add
            add = add.double()
            k >>= 1
        return acc

    # -- equality (coordinate-ratio test; Ristretto torquing-safe) ----------

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, RistrettoPoint):
            return NotImplemented
        if _clib is not None:
            return bool(_clib.xhe_pt_eq(_pack_pt(self), _pack_pt(other)))
        # ristretto equality: X1*Y2 == Y1*X2 or X1*X2 == Y1*Y2
        a = (self.X * other.Y - self.Y * other.X) % P == 0
        b = (self.X * other.X - self.Y * other.Y) % P == 0
        return a or b

    def __hash__(self):
        return hash(self.compress())

    def is_identity(self) -> bool:
        return self == IDENTITY

    # -- encoding -----------------------------------------------------------

    def compress(self) -> bytes:
        """Ristretto ENCODE (RFC 9496 §4.3.2)."""
        if _clib is not None:
            out = bytes(32)
            _clib.xhe_pt_compress(_pack_pt(self), out)
            return out
        X, Y, Z, T = self.X, self.Y, self.Z, self.T
        u1 = (Z + Y) * (Z - Y) % P
        u2 = X * Y % P
        _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
        den1 = invsqrt * u1 % P
        den2 = invsqrt * u2 % P
        z_inv = den1 * den2 % P * T % P
        ix0 = X * SQRT_M1 % P
        iy0 = Y * SQRT_M1 % P
        enchanted_denominator = den1 * INVSQRT_A_MINUS_D % P
        rotate = is_negative(T * z_inv % P)
        if rotate:
            X, Y = iy0, ix0
            den_inv = enchanted_denominator
        else:
            den_inv = den2
        if is_negative(X * z_inv % P):
            Y = (-Y) % P
        s = fe_abs(den_inv * ((Z - Y) % P) % P)
        return fe_to_bytes(s)

    @staticmethod
    def decompress(data: bytes) -> "RistrettoPoint | None":
        """Ristretto DECODE (RFC 9496 §4.3.1). Returns None for invalid encodings."""
        if len(data) != 32:
            return None
        if _clib is not None:
            out = bytes(128)
            if not _clib.xhe_pt_decompress(bytes(data), out):
                return None
            return _unpack_pt(out)
        s = int.from_bytes(data, "little")
        # must be canonical and non-negative
        if s >= P or s & 1:
            return None
        ss = s * s % P
        u1 = (1 - ss) % P
        u2 = (1 + ss) % P
        u2_sqr = u2 * u2 % P
        v = ((-D * u1 % P) * u1 - u2_sqr) % P
        was_square, invsqrt = sqrt_ratio_m1(1, v * u2_sqr % P)
        den_x = invsqrt * u2 % P
        den_y = invsqrt * den_x % P * v % P
        x = fe_abs(2 * s * den_x % P)
        y = u1 * den_y % P
        t = x * y % P
        if (not was_square) or is_negative(t) or y == 0:
            return None
        return RistrettoPoint(x, y, 1, t)

    @staticmethod
    def from_uniform_bytes(data: bytes) -> "RistrettoPoint":
        """Hash-to-group: Elligator2 map of two 32-byte halves, summed
        (RFC 9496 §4.3.4; dalek RistrettoPoint::from_uniform_bytes)."""
        assert len(data) == 64
        r1 = fe_from_bytes(data[:32])
        r2 = fe_from_bytes(data[32:])
        return elligator_map(r1) + elligator_map(r2)

    def __repr__(self):
        return f"RistrettoPoint({self.compress().hex()})"


def elligator_map(r0: int) -> RistrettoPoint:
    """MAP function from RFC 9496 §4.3.4."""
    r = SQRT_M1 * r0 % P * r0 % P
    u = (r + 1) * ONE_MINUS_D_SQ % P
    v = ((-1 - r * D) % P) * ((r + D) % P) % P
    was_square, s = sqrt_ratio_m1(u, v)
    s_prime = (-fe_abs(s * r0 % P)) % P
    if not was_square:
        s = s_prime
        c = r
    else:
        c = (-1) % P
    n = (c * ((r - 1) % P) % P * D_MINUS_ONE_SQ - v) % P
    w0 = 2 * s * v % P
    w1 = n * SQRT_AD_MINUS_ONE % P
    w2 = (1 - s * s) % P
    w3 = (1 + s * s) % P
    return RistrettoPoint(w0 * w3 % P, w2 * w1 % P, w1 * w3 % P, w0 * w2 % P)


IDENTITY = RistrettoPoint(0, 1, 1, 0)

# Ed25519 basepoint (y = 4/5, x positive-even per ed25519; ristretto basepoint).
_BY = (4 * invert(5)) % P
_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
BASEPOINT = RistrettoPoint(_BX, _BY, 1, _BX * _BY % P)

RISTRETTO_BASEPOINT_BYTES = BASEPOINT.compress()


class _FixedBaseTable:
    """4-bit window table for fast fixed-base scalar multiplication."""

    def __init__(self, point: RistrettoPoint, windows: int = 64):
        self.tables = []
        base = point
        for _ in range(windows):
            row = [IDENTITY]
            for _ in range(15):
                row.append(row[-1] + base)
            self.tables.append(row)
            base = row[1] + row[15]  # 16 * base

    def mul(self, scalar: int) -> RistrettoPoint:
        k = scalar % L
        acc = IDENTITY
        i = 0
        while k:
            nib = k & 15
            if nib:
                acc = acc + self.tables[i][nib]
            k >>= 4
            i += 1
        return acc


_G_TABLE: _FixedBaseTable | None = None


def mul_base(scalar: int) -> RistrettoPoint:
    """scalar * G with a precomputed window table."""
    global _G_TABLE
    if _G_TABLE is None:
        _G_TABLE = _FixedBaseTable(BASEPOINT)
    return _G_TABLE.mul(scalar)


def multiscalar_mul(scalars, points) -> RistrettoPoint:
    """Straus/Pippenger-style MSM on host ints.  Used for small host-side MSMs;
    big verification MSMs go through the batched engine (ops.msm)."""
    scalars = [s % L for s in scalars]
    points = list(points)
    assert len(scalars) == len(points)
    n = len(points)
    if n == 0:
        return IDENTITY
    if _clib is not None:
        sc = b"".join(s.to_bytes(32, "little") for s in scalars)
        pb = b"".join(_pack_pt(p) for p in points)
        out = bytes(128)
        _clib.xhe_pt_msm(sc, pb, n, out)
        return _unpack_pt(out)
    # Pippenger with window size c
    c = 1
    while (1 << (c + 1)) < n and c < 16:
        c += 1
    c = max(c, 4)
    mask = (1 << c) - 1
    windows = (253 + c - 1) // c
    acc = IDENTITY
    for w in reversed(range(windows)):
        if acc is not IDENTITY:
            for _ in range(c):
                acc = acc.double()
        buckets = [None] * (1 << c)
        for s, pt in zip(scalars, points):
            digit = (s >> (w * c)) & mask
            if digit:
                buckets[digit] = pt if buckets[digit] is None else buckets[digit] + pt
        running = IDENTITY
        window_sum = IDENTITY
        for b in reversed(range(1, 1 << c)):
            if buckets[b] is not None:
                running = running + buckets[b]
            window_sum = window_sum + running
        acc = acc + window_sum
    return acc
