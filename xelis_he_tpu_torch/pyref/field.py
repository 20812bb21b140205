"""Exact host-side fe25519 arithmetic (Python ints).

This is the ground-truth layer for the TPU-native batched engine in
``xelis_he_tpu_torch.ops``: every batched limb kernel is cross-checked against these
functions.  It mirrors the capabilities of the reference's curve dependency
(curve25519-dalek fork; see xelis-he/Cargo.toml:10 and SURVEY.md D1/D3)
but is an independent implementation derived from RFC 9496 (ristretto255) and
RFC 7748 field conventions.

All functions operate on Python ints in [0, P).
"""

from __future__ import annotations

P = 2**255 - 19

# Edwards curve: -x^2 + y^2 = 1 + d x^2 y^2
D = (-121665 * pow(121666, P - 2, P)) % P

# sqrt(-1) mod p, the canonical (even / "non-negative") root.
SQRT_M1 = pow(2, (P - 1) // 4, P)
if SQRT_M1 & 1:
    SQRT_M1 = P - SQRT_M1
assert (SQRT_M1 * SQRT_M1) % P == P - 1


def is_negative(x: int) -> bool:
    """Ristretto "negative" predicate: LSB of the canonical encoding."""
    return (x % P) & 1 == 1


def fe_abs(x: int) -> int:
    x %= P
    return P - x if x & 1 else x


def invert(x: int) -> int:
    return pow(x, P - 2, P)


def pow_p58(x: int) -> int:
    """x^((p-5)/8), the core exponentiation for sqrt_ratio."""
    return pow(x, (P - 5) // 8, P)


def sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    """Compute sqrt(u/v) per RFC 9496 SQRT_RATIO_M1.

    Returns (was_square, r) where r = abs(sqrt(u/v)) when u/v is square,
    r = abs(sqrt(i*u/v)) otherwise.  For u=1, v=0 returns (False, 0);
    for u=0 returns (True, 0).
    """
    u %= P
    v %= P
    v3 = (v * v % P) * v % P
    v7 = (v3 * v3 % P) * v % P
    r = (u * v3 % P) * pow_p58(u * v7 % P) % P
    check = v * (r * r % P) % P

    correct_sign = check == u
    flipped_sign = check == (P - u) % P
    flipped_sign_i = check == (P - u) % P * SQRT_M1 % P

    if flipped_sign or flipped_sign_i:
        r = r * SQRT_M1 % P

    r = fe_abs(r)
    return (correct_sign or flipped_sign), r


def inv_sqrt(v: int) -> tuple[bool, int]:
    """(was_square, 1/sqrt(v))."""
    return sqrt_ratio_m1(1, v)


# Derived Ristretto constants (match curve25519-dalek's literals; asserted below)
ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = ((D - 1) * (D - 1)) % P

_ok, INVSQRT_A_MINUS_D = inv_sqrt((-1 - D) % P)
assert _ok, "a-d must be a QR mod p"
# sqrt(a*d - 1) with a = -1:  a*d - 1 = -(d+1)  (same field element as a-d).
# curve25519-dalek/RFC 9496 use the ODD root here (unlike the abs convention
# elsewhere); the Elligator map output depends on this sign.
SQRT_AD_MINUS_ONE = (INVSQRT_A_MINUS_D * ((-1 - D) % P)) % P
if SQRT_AD_MINUS_ONE & 1 == 0:
    SQRT_AD_MINUS_ONE = P - SQRT_AD_MINUS_ONE
assert (SQRT_AD_MINUS_ONE * SQRT_AD_MINUS_ONE) % P == (-1 - D) % P


def fe_to_bytes(x: int) -> bytes:
    return (x % P).to_bytes(32, "little")


def fe_from_bytes(b: bytes) -> int:
    """Load a field element, masking the high bit (dalek FieldElement::from_bytes)."""
    assert len(b) == 32
    return (int.from_bytes(b, "little") & ((1 << 255) - 1)) % P
