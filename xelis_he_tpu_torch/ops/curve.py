"""Batched ristretto255 / extended-Edwards point operations on torch tensors.

The plain PyTorch counterpart of ``xelis_he_tpu.ops.curve.Curve``.  A point
batch is a tuple ``(X, Y, Z, T)`` of (..., 18) int64 limb tensors (ops.fe);
at the kernels' boundary points travel as (..., 4, 18) rows
(``rows_to_point`` / ``point_to_rows``).  The formulas are the ones the CUDA
kernels use (csrc/ed25519.cuh), so projective results agree exactly.
"""

from __future__ import annotations

import torch

from ..pyref.ristretto import RistrettoPoint
from .fe import Field, NLIMBS


def rows_to_point(rows: torch.Tensor):
    """(..., 4, 18) rows (any integer type) -> (X, Y, Z, T) int64 tuple."""
    rows = rows.to(torch.int64)
    return tuple(rows[..., c, :] for c in range(4))


def point_to_rows(p, canon_fe: Field | None = None) -> torch.Tensor:
    """(X, Y, Z, T) -> (..., 4, 18) rows, canonicalized when ``canon_fe``."""
    if canon_fe is not None:
        p = tuple(canon_fe.canon(c) for c in p)
    return torch.stack(p, dim=-2)


class Curve:
    def __init__(self, fe: Field):
        self.fe = fe

    # -- constructors -------------------------------------------------------

    def identity(self, shape=()):
        zero = self.fe.ZERO.expand(*shape, NLIMBS)
        one = self.fe.ONE.expand(*shape, NLIMBS)
        return (zero, one, one, zero)

    def from_points(self, points: list[RistrettoPoint]):
        fe = self.fe
        return tuple(fe.from_ints([getattr(p, a) for p in points]) for a in "XYZT")

    def to_points(self, batch) -> list[RistrettoPoint]:
        coords = [Field.to_ints(self.fe.canon(c)) for c in batch]
        return [RistrettoPoint(*xyzt) for xyzt in zip(*coords)]

    # -- group ops ----------------------------------------------------------

    def add(self, p, q):
        """Unified extended addition (add-2008-hwcd-3, a=-1, complete)."""
        fe = self.fe
        X1, Y1, Z1, T1 = p
        X2, Y2, Z2, T2 = q
        A = fe.mul(fe.sub(Y1, X1), fe.sub(Y2, X2))
        B = fe.mul(fe.add(Y1, X1), fe.add(Y2, X2))
        C = fe.mul(fe.mul(T1, fe.D2), T2)
        D = fe.mul(fe.add(Z1, Z1), Z2)
        E = fe.sub(B, A)
        F = fe.sub(D, C)
        G = fe.add(D, C)
        H = fe.add(B, A)
        return (fe.mul(E, F), fe.mul(G, H), fe.mul(F, G), fe.mul(E, H))

    def double(self, p, want_t: bool = True):
        """Dedicated doubling (dbl-2008-hwcd, a=-1).  Without ``want_t`` the
        T output is left at E (valid only as input to another doubling)."""
        fe = self.fe
        X1, Y1, Z1, _ = p
        A = fe.square(X1)
        B = fe.square(Y1)
        Zsq = fe.square(Z1)
        C = fe.add(Zsq, Zsq)
        H = fe.add(A, B)
        E = fe.sub(H, fe.square(fe.add(X1, Y1)))
        G = fe.sub(A, B)
        F = fe.add(C, G)
        return (fe.mul(E, F), fe.mul(G, H), fe.mul(F, G), fe.mul(E, H) if want_t else E)

    def neg(self, p):
        fe = self.fe
        X, Y, Z, T = p
        return (fe.neg(X), Y, Z, fe.neg(T))

    def select(self, cond, p, q):
        """cond ? p : q elementwise over the batch."""
        return tuple(self.fe.select(cond, a, b) for a, b in zip(p, q))

    def is_identity(self, p):
        fe = self.fe
        return fe.is_zero(p[0]) | fe.is_zero(p[1])

    # -- niels form (the table entries of the windowed lanes) -----------------

    def to_niels(self, p):
        """(Y+X, Y-X, 2d*T, 2Z)."""
        fe = self.fe
        X, Y, Z, T = p
        return (fe.add(Y, X), fe.sub(Y, X), fe.mul(T, fe.D2), fe.add(Z, Z))

    def add_niels(self, p, q, neg):
        """p + q (``neg``: p - q) for q in niels form; ``neg`` is a bool
        mask over the batch (swap Y+-X and negate 2dT)."""
        fe = self.fe
        X1, Y1, Z1, T1 = p
        YpX, YmX, T2d, Z2 = q
        A = fe.mul(fe.sub(Y1, X1), fe.select(neg, YpX, YmX))
        B = fe.mul(fe.add(Y1, X1), fe.select(neg, YmX, YpX))
        C = fe.mul(T1, fe.cneg(neg, T2d))
        D = fe.mul(Z1, Z2)
        E = fe.sub(B, A)
        F = fe.sub(D, C)
        G = fe.add(D, C)
        H = fe.add(B, A)
        return (fe.mul(E, F), fe.mul(G, H), fe.mul(F, G), fe.mul(E, H))

    # -- ristretto encoding (RFC 9496), batched -----------------------------

    def compress(self, p):
        """Batched ENCODE -> (..., 32) uint8."""
        fe = self.fe
        X, Y, Z, T = p
        u1 = fe.mul(fe.add(Z, Y), fe.sub(Z, Y))
        u2 = fe.mul(X, Y)
        _, invsqrt = fe.inv_sqrt(fe.mul(u1, fe.square(u2)))
        den1 = fe.mul(invsqrt, u1)
        den2 = fe.mul(invsqrt, u2)
        z_inv = fe.mul(fe.mul(den1, den2), T)
        ix0 = fe.mul(X, fe.SQRT_M1)
        iy0 = fe.mul(Y, fe.SQRT_M1)
        enchanted = fe.mul(den1, fe.INVSQRT_A_MINUS_D)
        rotate = fe.is_negative(fe.mul(T, z_inv))
        x = fe.select(rotate, iy0, X)
        y = fe.select(rotate, ix0, Y)
        den_inv = fe.select(rotate, enchanted, den2)
        y = fe.cneg(fe.is_negative(fe.mul(x, z_inv)), y)
        s = fe.abs(fe.mul(den_inv, fe.sub(Z, y)))
        return fe.to_bytes_le(s)

    def decompress(self, data: torch.Tensor):
        """Batched validating DECODE of (..., 32) uint8.  Returns (point,
        valid); invalid lanes (bit 255 set included) hold the identity."""
        fe = self.fe
        s = fe.from_bytes_le(data)
        # canonical: round-trip the bytes; also catches the masked top bit
        canonical = (fe.to_bytes_le(s) == data).all(dim=-1)
        nonneg = ~fe.is_negative(s)
        ss = fe.square(s)
        one = fe.ONE.expand_as(ss)
        u1 = fe.sub(one, ss)
        u2 = fe.add(one, ss)
        u2_sqr = fe.square(u2)
        v = fe.sub(fe.neg(fe.mul(fe.mul(fe.D, u1), u1)), u2_sqr)
        was_square, invsqrt = fe.inv_sqrt(fe.mul(v, u2_sqr))
        den_x = fe.mul(invsqrt, u2)
        den_y = fe.mul(fe.mul(invsqrt, den_x), v)
        x = fe.abs(fe.mul(fe.add(s, s), den_x))
        y = fe.mul(u1, den_y)
        t = fe.mul(x, y)
        valid = canonical & nonneg & was_square & ~fe.is_negative(t) & ~fe.is_zero(y)
        pt = self.select(valid, (x, y, one, t), self.identity(valid.shape))
        return pt, valid
