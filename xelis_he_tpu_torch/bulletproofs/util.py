"""Scalar-vector helpers for the Bulletproofs implementation (mod L)."""

from __future__ import annotations

from .. import scalars

L = scalars.L


def exp_iter(x: int, count: int) -> list[int]:
    """[1, x, x^2, ..., x^(count-1)] mod L."""
    out = [1] * count
    for i in range(1, count):
        out[i] = out[i - 1] * x % L
    return out


def inner_product(a: list[int], b: list[int]) -> int:
    assert len(a) == len(b)
    return sum(x * y for x, y in zip(a, b)) % L


def sum_of_powers(x: int, n: int) -> int:
    """x^0 + ... + x^(n-1) mod L (closed form: (x^n - 1) / (x - 1))."""
    x %= L
    if x == 1:
        return n % L
    return (pow(x, n, L) - 1) * pow(x - 1, L - 2, L) % L


def delta(n: int, m: int, y: int, z: int) -> int:
    """delta(y, z) from the Bulletproofs paper for m aggregated n-bit values:
    (z - z^2) * <1, y^(nm)> - sum_{j=0}^{m-1} z^(j+3) * (2^n - 1)."""
    zz = z * z % L
    sum_y = sum_of_powers(y, n * m)
    sum_2 = (1 << n) - 1
    sum_z = sum_of_powers(z, m)
    return ((z - zz) * sum_y - (zz * z % L) * sum_2 % L * sum_z) % L


def bits_le(value: int, n: int) -> list[int]:
    return [(value >> i) & 1 for i in range(n)]
