"""The four CUDA kernels of the block-verification path, with their wrappers,
plain versions and launch counts.

=====  ========================  =============================================
 id     kernel (csrc/)            replaces (xelis_he_tpu/ops/pallas_msm.py)
=====  ========================  =============================================
 K1     decompress.cu             _decompress_kernel + decompress_pallas
 K2     windowed_lanes.cu         _windowed_kernel_k4_fe13 (K_PACK = 8)
 K3     tile_sums.cu              _tile_reduce_kernel + tile_sums_pallas
 K4     compress.cu               _compress_kernel + compress_pallas
=====  ========================  =============================================

Each wrapper takes and returns torch tensors in the port's boundary formats:
points are (n, 4, 18) int32 rows of 15-bit limbs (X, Y, Z, T), canonical on
every kernel output; encodings and scalars are uint8.  On a CUDA tensor the
wrapper launches its kernel on the current stream (or raises); on a CPU
tensor it runs the kernel's plain version, built from ops.fe / ops.curve
with the same formulas, so the two agree bit for bit.  ``launches`` counts
kernel launches only.

Why each kernel is bound by operations, not bytes, and what its design does
about it, is noted at the top of its .cu file.
"""

from __future__ import annotations

import functools

import numpy as _np
import torch

from ._build import kernel_fn
from .curve import Curve, point_to_rows, rows_to_point
from .fe import Field, NLIMBS
from .msm import _tree_reduce

K_PACK = 8  # scalar-muls packed into one slot of K2
TILE = 512  # lanes per tile of K3
QTILE = 256  # slot granule of the signature lanes
N_WINDOWS = 64  # signed 4-bit windows of a scalar < 2^253

launches = {"decompress": 0, "windowed_lanes_k8": 0, "tile_sums": 0, "compress": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# field multiplications and squarings each kernel performs (counted by the
# host build of csrc/ed25519.cuh in tests/test_torch_kernels.py), for bounds
# on the card; the counts are per encoding, slot, point addition (tile - 1
# per tile) and point
FIELD_MULS = {"decompress": 28, "windowed_lanes_k8": 5336, "tile_sums": 9, "compress": 32}
FIELD_SQS = {"decompress": 256, "windowed_lanes_k8": 1152, "tile_sums": 0, "compress": 255}
# 32-bit multiply-adds of one radix-2^25.5 field multiplication: 100
# 32x32->64 products (two 32-bit halves each) and 10 multiplies by 19; of a
# squaring: 55 products and the 5 multiplies by 19 of the wrapped limbs
MULADDS_PER_FIELD_MUL = 210
MULADDS_PER_FIELD_SQ = 115


def muladds(name: str, items: int) -> int:
    """32-bit multiply-adds of kernel ``name`` over ``items`` work items."""
    return items * (FIELD_MULS[name] * MULADDS_PER_FIELD_MUL + FIELD_SQS[name] * MULADDS_PER_FIELD_SQ)


@functools.lru_cache(maxsize=None)
def _curve(device: torch.device) -> Curve:
    return Curve(Field(device))


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------


def recode_signed4(scalars) -> _np.ndarray:
    """Canonical scalars (list[int] or (N, 32) uint8) -> (64, N) uint32
    signed base-16 digits stored as e_w + 8 with e_w in [-7, 8]:
    s = sum_w e_w * 16^w."""
    if not isinstance(scalars, _np.ndarray):
        raw = b"".join(s.to_bytes(32, "little") for s in scalars)
        scalars = _np.frombuffer(raw, dtype=_np.uint8).reshape(-1, 32)
    n = scalars.shape[0]
    nibs = _np.zeros((n, N_WINDOWS), dtype=_np.int32)
    nibs[:, 0::2] = scalars & 0xF
    nibs[:, 1::2] = scalars >> 4
    out = _np.zeros((N_WINDOWS, n), dtype=_np.uint32)
    carry = _np.zeros(n, dtype=_np.int32)
    for w in range(N_WINDOWS):
        t = nibs[:, w] + carry
        over = (t > 8).astype(_np.int32)
        out[w] = (t - 16 * over + 8).astype(_np.uint32)
        carry = over
    assert not carry.any(), "scalar exceeded 2^255 - 8 in signed recoding"
    return out


def recode_signed4_torch(scalars: torch.Tensor) -> torch.Tensor:
    """Device recode: (N, 32) uint8 canonical scalars -> (64, N) uint8
    digits, equal to ``recode_signed4``.

    The carry of the signed recoding into window w is exactly the carry of
    adding 7 to every nibble (t = nibble + carry exceeds 8 iff nibble + 7 +
    carry reaches 16), so the digits are the nibbles of s + 0x77...7, plus 1:
    one 256-bit addition over eight 32-bit words instead of a 64-step chain.
    """
    s = scalars.to(torch.int64)
    words = s[:, 0::4] | (s[:, 1::4] << 8) | (s[:, 2::4] << 16) | (s[:, 3::4] << 24)
    carry = torch.zeros_like(words[:, 0])
    sums = []
    for j in range(8):
        t = words[:, j] + 0x77777777 + carry
        sums.append(t & 0xFFFFFFFF)
        carry = t >> 32
    a = torch.stack(sums, dim=1)  # (N, 8); scalars < 2^253 leave no carry out
    shifts = torch.arange(0, 32, 4, device=s.device)
    nibs = (a[:, :, None] >> shifts) & 0xF  # (N, 8 words, 8 nibbles)
    return (nibs.reshape(-1, N_WINDOWS) + 1).T.to(torch.uint8).contiguous()


# ---------------------------------------------------------------------------
# plain versions (torch Field / Curve, same formulas as the kernels)
# ---------------------------------------------------------------------------


def decompress_plain(enc: torch.Tensor):
    c = _curve(enc.device)
    pt, valid = c.decompress(enc)
    return point_to_rows(pt, c.fe).to(torch.int32), valid.to(torch.uint8)


def compress_plain(rows: torch.Tensor) -> torch.Tensor:
    return _curve(rows.device).compress(rows_to_point(rows))


def tile_sums_plain(rows: torch.Tensor, tile: int) -> torch.Tensor:
    """The tree of K3 per tile: lane i + tile/2 onto lane i, then halving."""
    c = _curve(rows.device)
    n = rows.shape[0]
    lanes = rows.reshape(n // tile, tile, 4, NLIMBS).transpose(0, 1)  # tile lanes first
    return point_to_rows(_tree_reduce(c, rows_to_point(lanes), tile), c.fe).to(torch.int32)


def windowed_lanes_k8_plain(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """slot s = sum_k s_k P_k, as K2: per-sub 1P..8P niels tables, then 64
    windows of 4 doublings and 8 signed-digit adds."""
    c = _curve(points.device)
    fe = c.fe
    S = points.shape[1]
    t1 = rows_to_point(points)  # (8, S, 18) each
    t2 = c.double(t1)
    t3 = c.add(t2, t1)
    t4 = c.double(t2)
    t5 = c.add(t4, t1)
    t6 = c.double(t3)
    t7 = c.add(t6, t1)
    t8 = c.double(t4)
    ones, zeros = fe.ONE.expand(K_PACK, S, NLIMBS), fe.ZERO.expand(K_PACK, S, NLIMBS)
    ident = (ones, ones, zeros, 2 * ones)
    entries = [ident] + [c.to_niels(t) for t in (t1, t2, t3, t4, t5, t6, t7, t8)]
    table = tuple(torch.stack([e[i] for e in entries]) for i in range(4))  # (9, 8, S, 18)
    d = digits.to(torch.int64) - 8
    slots = torch.arange(S, device=points.device)
    acc = c.identity((S,))
    for w in range(N_WINDOWS - 1, -1, -1):
        for want_t in (False, False, False, True):
            acc = c.double(acc, want_t)
        for k in range(K_PACK):
            e = d[k, w]
            q = tuple(t[e.abs(), k, slots] for t in table)
            acc = c.add_niels(acc, q, e < 0)
    return point_to_rows(acc, fe).to(torch.int32)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _expect(t: torch.Tensor, dtype, shape, what: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what}: want contiguous {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _launch(name: str, fn_name: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = kernel_fn(fn_name)(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    launches[name] += 1


def decompress(enc: torch.Tensor):
    """K1: (n, 32) uint8 encodings -> ((n, 4, 18) int32 canonical rows,
    (n,) uint8 valid).  Invalid encodings (bit 255 set included) give the
    identity rows."""
    n = enc.shape[0]
    _expect(enc, torch.uint8, (n, 32), "decompress encodings")
    if not _on_card(enc):
        return decompress_plain(enc)
    rows = torch.empty((n, 4, NLIMBS), dtype=torch.int32, device=enc.device)
    valid = torch.empty((n,), dtype=torch.uint8, device=enc.device)
    if n:
        _launch("decompress", "decompress", enc, rows, valid, n)
    return rows, valid


def windowed_lanes_k8(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """K2: points (8, S, 4, 18) int32, digits (8, 64, S) uint8 (e + 8) ->
    (S, 4, 18) int32 canonical slot sums."""
    S = points.shape[1]
    _expect(points, torch.int32, (K_PACK, S, 4, NLIMBS), "lane points")
    _expect(digits, torch.uint8, (K_PACK, N_WINDOWS, S), "lane digits")
    if not _on_card(points):
        return windowed_lanes_k8_plain(points, digits)
    out = torch.empty((S, 4, NLIMBS), dtype=torch.int32, device=points.device)
    if S:
        _launch("windowed_lanes_k8", "windowed_lanes", points, digits, out, S)
    return out


def tile_sums(rows: torch.Tensor, tile: int) -> torch.Tensor:
    """K3: (N, 4, 18) int32 rows -> (N / tile, 4, 18) canonical per-tile sums
    (tile a power of two <= 1024)."""
    n = rows.shape[0]
    _expect(rows, torch.int32, (n, 4, NLIMBS), "tile rows")
    if tile < 1 or tile > 1024 or tile & (tile - 1) or n % tile:
        raise ValueError(f"tile {tile} must be a power of two <= 1024 dividing {n}")
    if not _on_card(rows):
        return tile_sums_plain(rows, tile)
    out = torch.empty((n // tile, 4, NLIMBS), dtype=torch.int32, device=rows.device)
    if n:
        _launch("tile_sums", "tile_sums", rows, out, n // tile, tile)
    return out


def compress(rows: torch.Tensor) -> torch.Tensor:
    """K4: (n, 4, 18) int32 rows -> (n, 32) uint8 encodings (all-zero
    exactly for the identity)."""
    n = rows.shape[0]
    _expect(rows, torch.int32, (n, 4, NLIMBS), "compress rows")
    if not _on_card(rows):
        return compress_plain(rows)
    out = torch.empty((n, 32), dtype=torch.uint8, device=rows.device)
    if n:
        _launch("compress", "compress", rows, out, n)
    return out


def sum_points(rows: torch.Tensor) -> torch.Tensor:
    """(G, n, 4, 18) groups of rows -> (G, 4, 18) group sums through K3 alone:
    groups are padded with identities to a power-of-two width and reduced by
    tiles of at most 1024."""
    g, n = rows.shape[0], rows.shape[1]
    while n > 1:
        width = 1 << (n - 1).bit_length()
        if width > n:
            pad = identity_rows(g * (width - n), rows.device).reshape(g, width - n, 4, NLIMBS)
            rows = torch.cat([rows, pad], dim=1)
        tile = min(width, 1024)
        rows = tile_sums(rows.reshape(g * width, 4, NLIMBS), tile).reshape(g, width // tile, 4, NLIMBS)
        n = width // tile
    if n == 0:
        return identity_rows(g, rows.device)
    return rows[:, 0].contiguous()


def identity_rows(n: int, device) -> torch.Tensor:
    rows = torch.zeros((n, 4, NLIMBS), dtype=torch.int32, device=device)
    rows[:, 1:3, 0] = 1
    return rows
