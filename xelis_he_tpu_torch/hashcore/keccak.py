"""Keccak-f[1600] permutation and STROBE-128 (pure-Python fallback).

The merlin-compatible Fiat-Shamir transcript (SURVEY.md D8; reference uses the
xelis merlin fork, xelis-he/Cargo.toml:11) is STROBE-128 over
Keccak-f[1600] with rate 166.  A C++ implementation lives in
``hashcore/csrc`` and is preferred at runtime; this module is the exact,
dependency-free fallback and the unit-test ground truth.

The keccak-f implementation is validated against hashlib's SHA3 (same
permutation) in tests/test_hashes.py.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rol(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte little-endian state."""
    lanes = [[int.from_bytes(state[8 * (x + 5 * y): 8 * (x + 5 * y) + 8], "little")
              for y in range(5)] for x in range(5)]
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3] ^ lanes[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                lanes[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(lanes[x][y], _ROTATIONS[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                lanes[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _MASK)
        # iota
        lanes[0][0] ^= rc
    for x in range(5):
        for y in range(5):
            state[8 * (x + 5 * y): 8 * (x + 5 * y) + 8] = lanes[x][y].to_bytes(8, "little")


# ---------------------------------------------------------------------------
# STROBE-128 (merlin's mini-STROBE; strobe-rs compatible subset)
# ---------------------------------------------------------------------------

STROBE_R = 166  # rate in bytes: 200 - 2*security/8 - 2 with security=128

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    """STROBE-128 duplex, exactly mirroring merlin's strobe.rs subset
    (meta_ad / ad / prf / key)."""

    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- internal -----------------------------------------------------------

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            assert self.cur_flags == flags, "cannot continue op with different flags"
            return
        assert flags & FLAG_T == 0, "transport flags not supported"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = (flags & (FLAG_C | FLAG_K)) != 0
        if force_f and self.pos != 0:
            self._run_f()

    def copy(self) -> "Strobe128":
        new = object.__new__(Strobe128)
        new.state = bytearray(self.state)
        new.pos = self.pos
        new.pos_begin = self.pos_begin
        new.cur_flags = self.cur_flags
        return new

    # -- public (merlin subset) --------------------------------------------

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)

    def run_batch(self, blob: bytes, out_len: int) -> bytes:
        """Execute a serialized op list (merlin.py record format); pure-
        Python mirror of the native ``xhe_strobe_batch``."""
        out = bytearray()
        i = 0
        n = len(blob)
        while i + 6 <= n:
            op = blob[i]
            more = bool(blob[i + 1])
            ln = int.from_bytes(blob[i + 2 : i + 6], "little")
            i += 6
            if op == 0:
                self.meta_ad(blob[i : i + ln], more)
                i += ln
            elif op == 1:
                self.ad(blob[i : i + ln], more)
                i += ln
            elif op == 2:
                out += self.prf(ln, more)
            elif op == 3:
                self.key(blob[i : i + ln], more)
                i += ln
            else:  # pragma: no cover
                break
        return bytes(out)
