"""Twisted ElGamal encryption, Pedersen commitments, and Schnorr signatures.

Mirrors xelis-he/src/elgamal.rs semantics exactly:

- second generator ``H = from_uniform_bytes(SHA3-512(compress(G)))``
  (elgamal.rs:16-24)
- public key P = s^-1 * H (elgamal.rs:102-107)
- ciphertext of amount x with opening r: commitment C = x*G + r*H,
  decrypt handle D = r*P (elgamal.rs:109-129, 266-271, 228-230)
- decrypt: x*G = C - s*D (elgamal.rs:140-145)
- signature: k random, r = k*H, e = SHA3-512(pk || msg || compress(r)) mod L,
  s_sig = sk^-1 * e + k; verify r' = s_sig*H - e*P (elgamal.rs:26-65,194-200)

Homomorphic Add/Sub on handles/commitments/ciphertexts and ciphertext±scalar
(plaintext, non-hiding; elgamal.rs:353-377) are Python operators here.

Secrets (scalars, openings, nonces) live host-side only and come from the OS
CSPRNG; the accelerator only ever sees public data (SURVEY.md §5).
"""

from __future__ import annotations

import hashlib

from . import scalars
from .pyref.ristretto import (
    BASEPOINT as G,
    IDENTITY,
    RISTRETTO_BASEPOINT_BYTES,
    RistrettoPoint,
    mul_base,
    multiscalar_mul,
)
from .types import CompressedCiphertext, CompressedCommitment, CompressedHandle, CompressedPubkey

# Second generator for Pedersen openings (elgamal.rs:16-24).  Equals dalek's
# bulletproofs B_blinding: 8c9240b456a9e6dc65c377a1048d745f94a08cdb7f44cbcd7b46f34048871134
H: RistrettoPoint = RistrettoPoint.from_uniform_bytes(
    hashlib.sha3_512(RISTRETTO_BASEPOINT_BYTES).digest()
)


def hash_and_point_to_scalar(key: CompressedPubkey, message: bytes, point: RistrettoPoint) -> int:
    """e = SHA3-512(pk || msg || compress(point)) reduced wide (elgamal.rs:53-65)."""
    h = hashlib.sha3_512()
    h.update(key.data)
    h.update(message)
    h.update(point.compress())
    return scalars.from_bytes_mod_order_wide(h.digest())


class Signature:
    __slots__ = ("s", "e")

    def __init__(self, s: int, e: int):
        self.s = s % scalars.L
        self.e = e % scalars.L

    def verify(self, message: bytes, key: "ElGamalPubkey") -> bool:
        r = multiscalar_mul([self.s, (-self.e) % scalars.L], [H, key.point])
        return self.e == hash_and_point_to_scalar(key.compress(), message, r)

    def to_bytes(self) -> bytes:
        return scalars.to_bytes(self.s) + scalars.to_bytes(self.e)

    @staticmethod
    def from_bytes(data: bytes) -> "Signature":
        assert len(data) == 64
        return Signature(
            int.from_bytes(data[:32], "little"), int.from_bytes(data[32:], "little")
        )

    def __eq__(self, other):
        return isinstance(other, Signature) and self.s == other.s and self.e == other.e


class PedersenOpening:
    __slots__ = ("scalar",)

    def __init__(self, scalar: int):
        self.scalar = scalar % scalars.L

    @staticmethod
    def generate_new() -> "PedersenOpening":
        return PedersenOpening(scalars.random_scalar())


class PointExpr:
    """Symbolic linear combination of points:  sum(coeff_i * atom_i) + g*G.

    Atoms are 32-byte Ristretto encodings (gathered on-device from the
    block's fused decompression on the accelerator path) or host
    ``RistrettoPoint`` objects.  Homomorphic ciphertext algebra on the
    verification hot path builds these instead of evaluating field
    arithmetic; sigma verification expands them directly into the batch
    collector's MSM, so the combination is *never* evaluated at all.

    Add/sub are O(1): they build an immutable expression DAG (concat nodes
    with an optional subtree negation) and ``terms`` flattens lazily with
    caching.  This matters for hot accounts — a receiver credited by every
    tx of a 10k-tx block accumulates ~20k terms, and eager tuple concat
    made block verification quadratic in block size (the round-3
    2500-to-10k curve bend, root-caused in round 4)."""

    __slots__ = ("_terms", "_l", "_r", "_neg", "g_coeff")

    def __init__(self, terms: tuple = (), g_coeff: int = 0, _l=None, _r=None,
                 _neg: bool = False):
        self._terms = tuple(terms) if _l is None else None
        self._l = _l
        self._r = _r
        self._neg = _neg
        self.g_coeff = g_coeff

    @property
    def terms(self) -> tuple:
        t = self._terms
        if t is None:
            segs = []
            stack = [(self, False)]
            while stack:
                n, neg = stack.pop()
                neg = neg != n._neg
                if n._terms is not None:
                    segs.append(
                        n._terms if not neg
                        else tuple((-c, a) for c, a in n._terms)
                    )
                else:
                    # push right first so left flattens first (pop order)
                    stack.append((n._r, neg))
                    stack.append((n._l, neg))
            flat: list = []
            for s in segs:
                flat.extend(s)
            # cache only (chain kept: a concurrent reader may still be
            # walking it — the transition is benign either way)
            self._terms = t = tuple(flat)
        return t

    def __add__(self, other: "PointExpr") -> "PointExpr":
        return PointExpr((), self.g_coeff + other.g_coeff, _l=self, _r=other)

    def __sub__(self, other: "PointExpr") -> "PointExpr":
        neg = PointExpr((), 0, _l=other, _r=_EMPTY_EXPR, _neg=True)
        return PointExpr((), self.g_coeff - other.g_coeff, _l=self, _r=neg)

    def add_g(self, x: int) -> "PointExpr":
        if self._terms is not None:
            return PointExpr(self._terms, self.g_coeff + x)
        return PointExpr((), self.g_coeff + x, _l=self, _r=_EMPTY_EXPR)

    def evaluate(self) -> RistrettoPoint:
        """Host evaluation (off the hot path: decrypt, compress, equality).
        Raises DecompressionError on invalid encoded atoms."""
        from .types import _decompress_point

        sc = [c % scalars.L for c, _ in self.terms]
        pts = [
            _decompress_point(a) if isinstance(a, (bytes, bytearray)) else a
            for _, a in self.terms
        ]
        if self.g_coeff % scalars.L:
            sc.append(self.g_coeff % scalars.L)
            pts.append(G)
        if not sc:
            return IDENTITY
        return multiscalar_mul(sc, pts)


_EMPTY_EXPR = PointExpr()


class _LazyPointMixin:
    """Deferred decompression + symbolic algebra: wrappers created from a
    32-byte encoding materialize their host point object only on first
    ``.point`` access, and wrappers produced by homomorphic add/sub carry a
    :class:`PointExpr` instead of a point.  On the batched verification
    path most wrapped points are pure MSM inputs gathered on-device by
    encoding, so the Python point is never built at all."""

    __slots__ = ()

    @property
    def point(self) -> RistrettoPoint:
        pt = self._point
        if pt is None:
            expr = self._expr
            if expr is not None:
                pt = self._point = expr.evaluate()
            else:
                from .types import _decompress_point

                pt = self._point = _decompress_point(self.compressed)
        return pt

    def as_expr(self) -> PointExpr:
        """Cheapest symbolic form of this wrapper (never evaluates)."""
        if self._expr is not None and self._point is None:
            return self._expr
        if self._point is not None:
            return PointExpr(((1, self._point),))
        return PointExpr(((1, self.compressed),))

    def _lazy_compress(self) -> bytes:
        """32-byte encoding without materializing the point if possible."""
        return self.compressed if self.compressed is not None else self.point.compress()


class PedersenCommitment(_LazyPointMixin):
    # ``compressed`` carries the 32-byte origin encoding when this object
    # came from a validated decompression (types.py) — the accelerator uses
    # it to gather the point's limbs on-device instead of re-uploading.
    # ``_expr`` (mutually exclusive with a materialized ``_point``) carries
    # the symbolic combination built by homomorphic add/sub.
    __slots__ = ("_point", "compressed", "_expr")

    def __init__(
        self,
        point: RistrettoPoint | None,
        compressed: bytes | None = None,
        expr: PointExpr | None = None,
    ):
        self._point = point
        self.compressed = compressed
        self._expr = expr

    @staticmethod
    def new(amount: int) -> tuple["PedersenCommitment", PedersenOpening]:
        opening = PedersenOpening.generate_new()
        return PedersenCommitment.new_with_opening(amount, opening), opening

    @staticmethod
    def new_with_opening(amount: int, opening: PedersenOpening) -> "PedersenCommitment":
        return PedersenCommitment(
            multiscalar_mul([amount % scalars.L, opening.scalar], [G, H])
        )

    def compress(self) -> CompressedCommitment:
        return CompressedCommitment(self._lazy_compress())

    def __add__(self, other: "PedersenCommitment") -> "PedersenCommitment":
        return PedersenCommitment(None, expr=self.as_expr() + other.as_expr())

    def __sub__(self, other: "PedersenCommitment") -> "PedersenCommitment":
        return PedersenCommitment(None, expr=self.as_expr() - other.as_expr())

    def __eq__(self, other):
        return isinstance(other, PedersenCommitment) and self.point == other.point


class DecryptHandle(_LazyPointMixin):
    __slots__ = ("_point", "compressed", "_expr")

    def __init__(
        self,
        point: RistrettoPoint | None,
        compressed: bytes | None = None,
        expr: PointExpr | None = None,
    ):
        self._point = point
        self.compressed = compressed
        self._expr = expr

    @staticmethod
    def new(public: "ElGamalPubkey", opening: PedersenOpening) -> "DecryptHandle":
        return DecryptHandle(opening.scalar * public.point)

    def compress(self) -> CompressedHandle:
        return CompressedHandle(self._lazy_compress())

    def __add__(self, other: "DecryptHandle") -> "DecryptHandle":
        return DecryptHandle(None, expr=self.as_expr() + other.as_expr())

    def __sub__(self, other: "DecryptHandle") -> "DecryptHandle":
        return DecryptHandle(None, expr=self.as_expr() - other.as_expr())

    def __eq__(self, other):
        return isinstance(other, DecryptHandle) and self.point == other.point


class ElGamalCiphertext:
    __slots__ = ("commitment", "handle")

    def __init__(self, commitment: PedersenCommitment, handle: DecryptHandle):
        self.commitment = commitment
        self.handle = handle

    @staticmethod
    def zero() -> "ElGamalCiphertext":
        """Universal zero ciphertext, decryptable by any key (elgamal.rs:176-183).
        Symbolic (empty expression) so homomorphic sums stay unevaluated."""
        return ElGamalCiphertext(
            PedersenCommitment(None, expr=PointExpr()),
            DecryptHandle(None, expr=PointExpr()),
        )

    def compress(self) -> CompressedCiphertext:
        return CompressedCiphertext(self.commitment.compress(), self.handle.compress())

    def __add__(self, other):
        if isinstance(other, ElGamalCiphertext):
            return ElGamalCiphertext(
                self.commitment + other.commitment, self.handle + other.handle
            )
        if isinstance(other, int):
            # plaintext add: C + x*G, handle unchanged (elgamal.rs:356-364)
            return ElGamalCiphertext(
                PedersenCommitment(None, expr=self.commitment.as_expr().add_g(other)),
                self.handle,
            )
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, ElGamalCiphertext):
            return ElGamalCiphertext(
                self.commitment - other.commitment, self.handle - other.handle
            )
        if isinstance(other, int):
            return ElGamalCiphertext(
                PedersenCommitment(None, expr=self.commitment.as_expr().add_g(-other)),
                self.handle,
            )
        return NotImplemented

    def __eq__(self, other):
        return (
            isinstance(other, ElGamalCiphertext)
            and self.commitment == other.commitment
            and self.handle == other.handle
        )


class ECDLPInstance:
    """Decrypted point wrapper; decode small integers via the ECDLP tables
    (elgamal.rs:67-92).  See :mod:`xelis_he_tpu_torch.ecdlp`."""

    __slots__ = ("point",)

    def __init__(self, point: RistrettoPoint):
        self.point = point

    def as_point(self) -> RistrettoPoint:
        return self.point

    def decode(self, tables, args=None):
        from .ecdlp import decode

        return decode(tables, self.point, args)

    def par_decode(self, tables, args=None):
        from .ecdlp import par_decode

        return par_decode(tables, self.point, args)


class ElGamalPubkey(_LazyPointMixin):
    __slots__ = ("_point", "compressed", "_expr")

    def __init__(self, point: RistrettoPoint | None, compressed: bytes | None = None):
        self._point = point
        self.compressed = compressed
        self._expr = None

    @staticmethod
    def from_secret(secret: "ElGamalSecretKey") -> "ElGamalPubkey":
        assert secret.scalar % scalars.L != 0
        return ElGamalPubkey(scalars.invert(secret.scalar) * H)

    def encrypt(self, amount: int) -> ElGamalCiphertext:
        commitment, opening = PedersenCommitment.new(amount)
        return ElGamalCiphertext(commitment, self.decrypt_handle(opening))

    def encrypt_with_opening(self, amount: int, opening: PedersenOpening) -> ElGamalCiphertext:
        return ElGamalCiphertext(
            PedersenCommitment.new_with_opening(amount, opening), self.decrypt_handle(opening)
        )

    def decrypt_handle(self, opening: PedersenOpening) -> DecryptHandle:
        return DecryptHandle.new(self, opening)

    def compress(self) -> CompressedPubkey:
        return CompressedPubkey(self._lazy_compress())

    def __eq__(self, other):
        return isinstance(other, ElGamalPubkey) and self.point == other.point


class ElGamalSecretKey:
    __slots__ = ("scalar",)

    def __init__(self, scalar: int):
        self.scalar = scalar % scalars.L

    def decrypt(self, ciphertext: ElGamalCiphertext) -> ECDLPInstance:
        # m*G = C - s*D (elgamal.rs:140-145)
        return ECDLPInstance(
            ciphertext.commitment.point - self.scalar * ciphertext.handle.point
        )


class ElGamalKeypair:
    __slots__ = ("pk", "sk")

    def __init__(self, pk: ElGamalPubkey, sk: ElGamalSecretKey):
        self.pk = pk
        self.sk = sk

    @staticmethod
    def keygen() -> "ElGamalKeypair":
        return ElGamalKeypair.keygen_with_secret(scalars.random_scalar())

    @staticmethod
    def keygen_with_secret(s: int) -> "ElGamalKeypair":
        sk = ElGamalSecretKey(s)
        return ElGamalKeypair(ElGamalPubkey.from_secret(sk), sk)

    def pubkey(self) -> ElGamalPubkey:
        return self.pk

    def secret(self) -> ElGamalSecretKey:
        return self.sk

    def sign(self, message: bytes) -> Signature:
        k = scalars.random_scalar()
        r = k * H
        e = hash_and_point_to_scalar(self.pk.compress(), message, r)
        s = (scalars.invert(self.sk.scalar) * e + k) % scalars.L
        return Signature(s, e)
