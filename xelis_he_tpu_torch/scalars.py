"""Scalar arithmetic mod the Ristretto group order L (host, Python ints).

Mirrors the capabilities the reference consumes from curve25519-dalek's
``Scalar`` (SURVEY.md D2; xelis-he/src/elgamal.rs:104,196-199,
xelis-he/src/transcript.rs:50): wide 512-bit reduction, inversion,
batch inversion, random generation from a host CSPRNG.

Scalars are plain ints in [0, L).  Secrets never touch the accelerator
(SURVEY.md §5 constant-time note): generation uses the OS CSPRNG.
"""

from __future__ import annotations

import secrets

L = 2**252 + 27742317777372353535851937790883648493


def from_bytes_mod_order_wide(b: bytes) -> int:
    assert len(b) == 64
    return int.from_bytes(b, "little") % L


def from_bytes_mod_order(b: bytes) -> int:
    assert len(b) == 32
    return int.from_bytes(b, "little") % L


def from_canonical_bytes(b: bytes) -> int | None:
    """Strict deserialization: reject non-canonical encodings."""
    assert len(b) == 32
    v = int.from_bytes(b, "little")
    if v >= L:
        return None
    return v


def to_bytes(s: int) -> bytes:
    return (s % L).to_bytes(32, "little")


import threading as _threading

_rng_tls = _threading.local()
_POOL_SCALARS = 256  # one urandom syscall refills 256 draws


def random_scalar() -> int:
    """Uniform scalar from the OS CSPRNG (dalek Scalar::random semantics:
    64 uniform bytes reduced mod L).

    Draws are served from a per-thread pool refilled with one
    ``secrets.token_bytes`` syscall per 256 scalars: batch verification
    consumes 4 randomizers per tx and the per-call urandom syscall was a
    measurable slice of the host hot path.  Pool bytes are CSPRNG output,
    used exactly once, never shared across threads."""
    off = getattr(_rng_tls, "off", None)
    if off is None or off + 64 > len(_rng_tls.pool):
        _rng_tls.pool = secrets.token_bytes(64 * _POOL_SCALARS)
        off = 0
    _rng_tls.off = off + 64
    return from_bytes_mod_order_wide(_rng_tls.pool[off : off + 64])


def invert(s: int) -> int:
    return pow(s, L - 2, L)


def batch_invert(scalars: list[int]) -> list[int]:
    """Montgomery batch inversion; zero entries are not allowed."""
    n = len(scalars)
    if n == 0:
        return []
    prefix = [1] * (n + 1)
    for i, s in enumerate(scalars):
        prefix[i + 1] = prefix[i] * s % L
    inv_all = invert(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % L
        inv_all = inv_all * scalars[i] % L
    return out
