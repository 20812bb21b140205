"""Bulletproofs generator derivation (bit-exact with the dalek/xelis fork).

- ``PedersenGens``: B = Ristretto basepoint, B_blinding =
  from_uniform_bytes(SHA3-512(compress(B))) — identical to the reference's
  ElGamal H (proofs.rs:19-22 uses PedersenGens::default alongside H).
- ``BulletproofGens``: per-party SHAKE-256 chains seeded with
  "GeneratorsChain" || label where label = b"G"/b"H" || u32le(party index);
  each generator consumes 64 XOF bytes mapped with from_uniform_bytes.

Generation is lazy per party and disk-cached (extended coordinates, raw
128-byte records) because deriving all 512*64*2 generators costs seconds.
"""

from __future__ import annotations

import hashlib
import os
import pathlib

from ..elgamal import H as _ELGAMAL_H
from ..pyref.ristretto import BASEPOINT, RistrettoPoint
from ..pyref.field import P


class PedersenGens:
    """pc_gens: B (value base) and B_blinding (opening base)."""

    def __init__(self):
        self.B = BASEPOINT
        self.B_blinding = _ELGAMAL_H


def _chain(label: bytes, count: int):
    """GeneratorsChain::new(label).take(count)."""
    shake = hashlib.shake_256()
    shake.update(b"GeneratorsChain")
    shake.update(label)
    stream = shake.digest(64 * count)
    return [
        RistrettoPoint.from_uniform_bytes(stream[64 * i: 64 * i + 64])
        for i in range(count)
    ]


def _cache_dir() -> pathlib.Path:
    from ..utils.cachedir import cache_root

    root = os.environ.get("XELIS_HE_TPU_CACHE", str(cache_root()))
    path = pathlib.Path(root)
    path.mkdir(parents=True, exist_ok=True)
    return path


def _point_to_rec(pt: RistrettoPoint) -> bytes:
    return b"".join(v.to_bytes(32, "little") for v in (pt.X, pt.Y, pt.Z, pt.T))


def _rec_to_point(rec: bytes) -> RistrettoPoint:
    vals = [int.from_bytes(rec[i: i + 32], "little") for i in (0, 32, 64, 96)]
    return RistrettoPoint(*vals)


class BulletproofGens:
    """Generators for up to ``party_capacity`` parties of ``gens_capacity``-bit
    range proofs.  The reference pins BulletproofGens::new(64, 512)
    (proofs.rs:20)."""

    def __init__(self, gens_capacity: int, party_capacity: int, use_disk_cache: bool = True):
        self.gens_capacity = gens_capacity
        self.party_capacity = party_capacity
        self._g: dict[int, list[RistrettoPoint]] = {}
        self._h: dict[int, list[RistrettoPoint]] = {}
        self._use_disk_cache = use_disk_cache

    def _party_label(self, kind: bytes, j: int) -> bytes:
        return kind + j.to_bytes(4, "little")

    def _load_party(self, j: int) -> None:
        if j in self._g:
            return
        assert j < self.party_capacity, f"party {j} exceeds capacity {self.party_capacity}"
        cache = None
        if self._use_disk_cache:
            cache = _cache_dir() / f"bpgens_{self.gens_capacity}_{j}.bin"
            if cache.exists():
                raw = cache.read_bytes()
                if len(raw) == 2 * self.gens_capacity * 128:
                    pts = [_rec_to_point(raw[i: i + 128]) for i in range(0, len(raw), 128)]
                    self._g[j] = pts[: self.gens_capacity]
                    self._h[j] = pts[self.gens_capacity:]
                    return
        self._g[j] = _chain(self._party_label(b"G", j), self.gens_capacity)
        self._h[j] = _chain(self._party_label(b"H", j), self.gens_capacity)
        if cache is not None:
            cache.write_bytes(b"".join(_point_to_rec(p) for p in self._g[j] + self._h[j]))

    def share_G(self, j: int, n: int) -> list[RistrettoPoint]:
        self._load_party(j)
        return self._g[j][:n]

    def share_H(self, j: int, n: int) -> list[RistrettoPoint]:
        self._load_party(j)
        return self._h[j][:n]

    def G(self, n: int, m: int) -> list[RistrettoPoint]:
        """Aggregated iteration order: party 0 gens 0..n, party 1 gens 0..n, ...
        (dalek AggregatedGensIter)."""
        out = []
        for j in range(m):
            out.extend(self.share_G(j, n))
        return out

    def H(self, n: int, m: int) -> list[RistrettoPoint]:
        out = []
        for j in range(m):
            out.extend(self.share_H(j, n))
        return out


# Protocol-pinned global generators (proofs.rs:19-22)
BP_GENS = BulletproofGens(64, 512)
PC_GENS = PedersenGens()
