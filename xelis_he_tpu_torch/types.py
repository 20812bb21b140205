"""Compressed 32-byte wire types and common enums.

Mirrors xelis-he/src/compressed.rs (CompressedCommitment /
CompressedCiphertext / CompressedPubkey / CompressedHandle as transparent
[u8;32] Pod types) and lib.rs:26-46 (Hash) / lib.rs:91-95 (Role).

All compressed types are immutable bytes wrappers; ``decompress`` validates
the Ristretto encoding and raises :class:`DecompressionError` on failure.
"""

from __future__ import annotations

import enum
from typing import TYPE_CHECKING

from .errors import DecompressionError
from .pyref.ristretto import RistrettoPoint

if TYPE_CHECKING:  # pragma: no cover
    from .elgamal import DecryptHandle, ElGamalCiphertext, ElGamalPubkey, PedersenCommitment


class Role(enum.Enum):
    SENDER = "sender"
    RECEIVER = "receiver"


class Hash:
    """32-byte transaction/asset hash (lib.rs:40-46).  The all-zero hash is
    the native asset."""

    __slots__ = ("data",)

    def __init__(self, data: bytes = b"\x00" * 32):
        assert len(data) == 32
        self.data = bytes(data)

    def is_zeros(self) -> bool:
        return self.data == b"\x00" * 32

    def __eq__(self, other):
        return isinstance(other, Hash) and self.data == other.data

    def __hash__(self):
        return hash(self.data)

    def __repr__(self):
        return f"Hash({self.data.hex()})"


NATIVE_ASSET = Hash()


# Block-level decompression cache: batch verification pre-decompresses every
# encoding of a block in one fused device call (ops.accel) and seeds this map;
# per-item decompression then becomes a lookup.  Invalid encodings are never
# cached, so the host path still raises at the exact reference-equivalent
# point.
#
# The cache, the lazy tier, and the block-lazy flag are all THREAD-LOCAL so
# concurrent ``verify_batch`` calls in different threads are isolated (the
# reference is &mut-single-threaded by construction; this rebuild's batch
# verifier is explicitly parallel-safe).
import threading as _threading

_TLS = _threading.local()


def _tls_state():
    if not hasattr(_TLS, "cache"):
        _TLS.cache = {}
        _TLS.lazy = {}
        _TLS.block_lazy = False
    return _TLS


def seed_decompress_cache(mapping: dict[bytes, RistrettoPoint]) -> None:
    _tls_state().cache.update(mapping)


def seed_decompress_cache_lazy(mapping: dict[bytes, object]) -> None:
    """mapping: encoding -> (4, NLIMBS) canonical uint32 limb row."""
    _tls_state().lazy.update(mapping)


def clear_decompress_cache() -> None:
    st = _tls_state()
    st.cache.clear()
    st.lazy.clear()


def is_cached_valid(data: bytes) -> bool:
    """True iff ``data`` was validated by the block's batched device
    decompression (invalid encodings are never cached)."""
    st = _tls_state()
    return data in st.cache or data in st.lazy


# Block-lazy mode: while a batched verification with an accelerator is in
# flight, every ``decompress()`` defers BOTH the point build AND validity
# checking — the block's fused device decompression validates all encodings
# and its valid flags are folded into the single device-side accept/reject
# predicate.  Host access to ``.point`` still decompresses (and raises)
# eagerly, preserving reference error behavior off the hot path.


def set_block_lazy(on: bool) -> None:
    _tls_state().block_lazy = on


def _defer_decompression(data: bytes) -> bool:
    st = _tls_state()
    return st.block_lazy or data in st.cache or data in st.lazy


def _decompress_point(data: bytes) -> RistrettoPoint:
    st = _tls_state()
    pt = st.cache.get(data)
    if pt is not None:
        return pt
    row = st.lazy.get(data)
    if row is not None:
        coords = []
        for limbs in row.tolist():
            v = 0
            for x in reversed(limbs):
                v = (v << 15) | x
            coords.append(v)
        pt = RistrettoPoint(*coords)
        st.cache[data] = pt
        return pt
    pt = RistrettoPoint.decompress(data)
    if pt is None:
        raise DecompressionError(f"invalid encoding {data.hex()}")
    return pt


class _Compressed32:
    __slots__ = ("data",)

    def __init__(self, data: bytes):
        assert len(data) == 32, f"expected 32 bytes, got {len(data)}"
        self.data = bytes(data)

    def __eq__(self, other):
        return type(other) is type(self) and self.data == other.data

    def __hash__(self):
        return hash((type(self).__name__, self.data))

    def __repr__(self):
        return f"{type(self).__name__}({self.data.hex()})"


class CompressedCommitment(_Compressed32):
    def decompress(self) -> "PedersenCommitment":
        from .elgamal import PedersenCommitment

        if _defer_decompression(self.data):
            # validated by the block's fused device decompression (or will
            # be, in block-lazy mode): defer the host point build — most
            # wrapped points are device MSM inputs
            return PedersenCommitment(None, compressed=self.data)
        return PedersenCommitment(_decompress_point(self.data), compressed=self.data)


class CompressedHandle(_Compressed32):
    def decompress(self) -> "DecryptHandle":
        from .elgamal import DecryptHandle

        if _defer_decompression(self.data):
            return DecryptHandle(None, compressed=self.data)
        return DecryptHandle(_decompress_point(self.data), compressed=self.data)


class CompressedPubkey(_Compressed32):
    def decompress(self) -> "ElGamalPubkey":
        from .elgamal import ElGamalPubkey

        if _defer_decompression(self.data):
            return ElGamalPubkey(None, compressed=self.data)
        return ElGamalPubkey(_decompress_point(self.data), compressed=self.data)


class CompressedCiphertext:
    """commitment ‖ handle, 64 bytes on the wire (compressed.rs:37-63)."""

    __slots__ = ("commitment", "handle")

    def __init__(self, commitment: CompressedCommitment, handle: CompressedHandle):
        self.commitment = commitment
        self.handle = handle

    @property
    def data(self) -> bytes:
        return self.commitment.data + self.handle.data

    @staticmethod
    def from_bytes(data: bytes) -> "CompressedCiphertext":
        assert len(data) == 64
        return CompressedCiphertext(CompressedCommitment(data[:32]), CompressedHandle(data[32:]))

    def decompress(self) -> "ElGamalCiphertext":
        from .elgamal import ElGamalCiphertext

        return ElGamalCiphertext(self.commitment.decompress(), self.handle.decompress())

    def __eq__(self, other):
        return (
            isinstance(other, CompressedCiphertext)
            and self.commitment == other.commitment
            and self.handle == other.handle
        )

    def __hash__(self):
        return hash((self.commitment, self.handle))

    def __repr__(self):
        return f"CompressedCiphertext({self.data.hex()})"
