"""The ten CUDA kernels, with their wrappers, plain versions and launch
counts.

=====  ========================  =============================================
 id     kernel (csrc/)            replaces (xelis_he_tpu/ops/pallas_msm.py)
=====  ========================  =============================================
 K1     decompress.cu             _decompress_kernel + decompress_pallas
 K2     windowed_lanes.cu         _windowed_kernel_k4_fe13 (K_PACK = 8)
 K3     tile_sums.cu              _tile_reduce_kernel + tile_sums_pallas
 K4     compress.cu               _compress_kernel + compress_pallas
 K5     windowed_lane.cu          _windowed_kernel + msm_windowed_lanes_pallas
 K6     windowed_lanes_fe15.cu    _windowed_kernel_k4 (the 18x15-bit tier)
 K7     daa_lanes.cu              _daa_kernel + msm_daa_lanes_pallas
 K8     add_compress.cu           no Pallas kernel: ECDLP's XLA curve.add and
                                  compress (xelis_he_tpu/ecdlp.py)
 K9     bucket_sums.cu            no Pallas kernel: Pippenger's bucket sums,
                                  the XLA scan of MsmEngine._window_sum
                                  (xelis_he_tpu/ops/msm.py)
 K10    window_sums.cu            no Pallas kernel: _window_sum's weighted
                                  bucket sum and MsmEngine.msm's Horner loop
=====  ========================  =============================================

Each wrapper takes and returns torch tensors in the port's boundary formats:
points are (n, 4, 18) int32 rows of 15-bit limbs (X, Y, Z, T), canonical on
every kernel output; encodings and scalars are uint8.  On a CUDA tensor the
wrapper launches its kernel on the current stream (or raises); on a CPU
tensor it runs the kernel's plain version, built from ops.fe / ops.curve
with the same formulas in the same order, so the two agree bit for bit.
``launches`` counts kernel launches only.

Why each kernel is bound by operations, not bytes, and what its design does
about it, is noted at the top of its .cu file.  The roofline probes K11-K14
(csrc/probe_*.cu) have their wrappers in ops/probes.py and their launch
counts in ``launches``.
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
K2_SPLIT = 2  # threads a slot of K2 (csrc/ed25519.cuh K2_SPLIT)
K6_SPLIT = 4  # threads a slot of K6 (csrc/ed25519.cuh K6_SPLIT)
K2_TABLE = 9  # niels entries a sub of K2, 0P..8P (its scratch: K_PACK x K2_TABLE a slot)
TILE = 512  # lanes per tile of K3
K3_SUB = 64  # rows a block of K3 reduces (csrc/ed25519.cuh K3_SUB)
GE_WORDS = 40  # 32-bit words of a point or niels entry in the kernels' radix 2^25.5
GE15_WORDS = 72  # the same on K6's 15-bit tier
QTILE = 256  # slot granule of the signature lanes
N_WINDOWS = 64  # signed 4-bit windows of a scalar < 2^253

N_BITS = 253  # ristretto scalars are below 2^253: the bits K7 walks
N_WORDS = 8  # 32-bit words of a packed scalar

launches = {"decompress": 0, "windowed_lanes_k8": 0, "tile_sums": 0, "compress": 0,
            "windowed_lanes": 0, "windowed_lanes_k8_fe15": 0, "daa_lanes": 0, "add_compress": 0,
            "bucket_sums": 0, "window_sums": 0,
            # the roofline probes K11-K14 (ops/probes.py), which no block path runs
            "probe_imad": 0, "probe_mul15": 0, "probe_mul13": 0, "probe_fe": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# field multiplications and squarings each kernel performs (counted by the
# host build of csrc/ed25519.cuh in tests/test_torch_kernels.py), for bounds
# on the card; the counts are per encoding, slot, point addition (tile - 1
# per tile), point, lane and sum.  K7's work depends on its scalars: the entry is
# the 253 doublings of a lane, and every set bit adds DAA_MULS_PER_SET_BIT.
# K9's and K10's items are point additions (``bucket_additions``,
# ``window_sums_work``); K10's doublings add DBL_MULS / DBL_SQS each (a
# doubling that another doubling follows skips T: DBL_NO_T_MULS).
FIELD_MULS = {"decompress": 28, "windowed_lanes_k8": 5336, "tile_sums": 9, "compress": 32,
              "windowed_lanes": 1451, "windowed_lanes_k8_fe15": 5336, "daa_lanes": 1012, "add_compress": 41,
              "bucket_sums": 9, "window_sums": 9}
FIELD_SQS = {"decompress": 256, "windowed_lanes_k8": 1152, "tile_sums": 0, "compress": 255,
             "windowed_lanes": 1040, "windowed_lanes_k8_fe15": 1152, "daa_lanes": 1012, "add_compress": 255,
             "bucket_sums": 0, "window_sums": 0}
DAA_MULS_PER_SET_BIT = 9
DBL_MULS, DBL_SQS = 4, 4  # a doubling with T (ge_dbl)
DBL_NO_T_MULS = 3  # a doubling without T
# lanes of a K8 launch that keep every SM of the card busy (csrc/add_compress.cu):
# a par_decode group runs this many lanes' worth of rounds
K8_FILL_LANES = 1 << 17
K9_K = 4  # log2 of the positions a thread of K9 walks in a pass (csrc/ed25519.cuh K9_K)
# K10's shape (k10_shape): quads of threads a piece at most, the kernel's
# launch bound in threads (csrc/ed25519.cuh K10_MAX_THREADS), and the
# blocks that fill the 132 SMs of an H100 twice
K10_QUADS = 64
K10_MAX_THREADS = 256
K10_FILL_BLOCKS = 2 * 132
# Issue slots of a 32 x 32 -> 64-bit multiply-add (IMAD.WIDE.U32 and the
# additions of its 64-bit sum) in 32-bit multiply-adds: K11's wide form, an
# IMAD.WIDE.U32 and an IADD3 a step, runs at 1/2.55 of its u32 form's rate
# on an H100 80GB HBM3 at 700 W (PERF.md section 6, the probe scripts' run),
# so every 64-bit column product of either tier is charged two.
WIDE_SLOTS = 2
# 32-bit multiply-adds of one radix-2^25.5 field multiplication: 100 wide
# products and 10 multiplies by 19; of a squaring: 55 products and the 5
# multiplies by 19 of the wrapped limbs
MULADDS_PER_FIELD_MUL = 100 * WIDE_SLOTS + 10
MULADDS_PER_FIELD_SQ = 55 * WIDE_SLOTS + 5
# on K6's 15-bit tier: 324 wide products (171 in a squaring) summed in 64-bit
# columns, and the 17 multiplies by 19 of the folded columns; the additions
# of the carries are left out on both tiers
MULADDS_PER_FIELD_MUL15 = 324 * WIDE_SLOTS + 17
MULADDS_PER_FIELD_SQ15 = 171 * WIDE_SLOTS + 17


# What K2 and K6 execute a slot when the slot is split over ``split``
# threads: each thread doubles its own accumulator (the 256 doublings of a
# slot are 832 multiplications and 1,024 squarings), and the partial sums
# meet in split - 1 unified additions of 9 multiplications.  The bound keeps
# FIELD_MULS / FIELD_SQS, the work of the function: the extra doublings are
# the cost of the design.
SLOT_DOUBLING_MULS, SLOT_DOUBLING_SQS = 832, 1024


def _split_executed(name: str, split: int) -> tuple[int, int]:
    extra = split - 1
    return (FIELD_MULS[name] + extra * (SLOT_DOUBLING_MULS + FIELD_MULS["tile_sums"]),
            FIELD_SQS[name] + extra * SLOT_DOUBLING_SQS)


def k2_executed(split: int = K2_SPLIT) -> tuple[int, int]:
    """(field multiplications, squarings) K2 executes a slot at ``split``."""
    return _split_executed("windowed_lanes_k8", split)


def k6_executed(split: int = K6_SPLIT) -> tuple[int, int]:
    """(field multiplications, squarings) K6 executes a slot at ``split``."""
    return _split_executed("windowed_lanes_k8_fe15", split)


def k7_executed() -> tuple[int, int]:
    """(field multiplications, squarings) K7 executes a lane: the addition
    is computed on every one of the 253 steps and selected by the bit.  The
    bound counts an addition only where a bit is set."""
    return FIELD_MULS["daa_lanes"] + N_BITS * DAA_MULS_PER_SET_BIT, FIELD_SQS["daa_lanes"]


# What K1 executes an encoding: the function's work, and the values it
# recomputes instead of holding them in registers: s^2, u2^2, d u1^2, the
# ratio's denominator t and t^3 after the inverse square root's chain, and
# s^2, u2^2 and d u1^2 again after the square root's checks (5 squarings
# and 6 multiplications; csrc/ed25519.cuh decompress_one).  The bound keeps
# the function's count.
K1_RECOMPUTED_MULS, K1_RECOMPUTED_SQS = 6, 5


def k1_executed() -> tuple[int, int]:
    """(field multiplications, squarings) K1 executes an encoding."""
    return FIELD_MULS["decompress"] + K1_RECOMPUTED_MULS, FIELD_SQS["decompress"] + K1_RECOMPUTED_SQS


def bucket_additions(offsets: torch.Tensor) -> int:
    """K9's work on (W, 2^c + 1) run offsets: a bucket of n >= 1 lanes takes
    n - 1 additions (bucket 0, digit 0, is not summed)."""
    counts = (offsets[:, 2:] - offsets[:, 1:-1]).to(torch.int64)
    return int((counts - 1).clamp(min=0).sum())


def k9_passes(n: int) -> int:
    """K9's launches on n lanes: passes until a run of n lanes is one block
    of 2^K9_K positions (a pass leaves a run of L at most ceil(L / 2^K9_K)
    block sums)."""
    passes, run = 1, n
    while run > 1 << K9_K:
        run, passes = -(-run // (1 << K9_K)), passes + 1
    return passes


def _k9_blocks(length: torch.Tensor, first_pass: bool) -> torch.Tensor:
    """Threads a K9 pass gives each run of ``length`` points: its blocks of
    2^K9_K positions in the tree of 2^levels >= length positions whose first
    pad = 2^levels - length are empty; one for a run of at most 2^K9_K; one
    for an empty bucket in the first pass (it writes the identity), none
    after."""
    levels = torch.frexp((length - 1).clamp(min=0).to(torch.float64)).exponent.to(torch.int64)
    pad = (torch.ones_like(length) << levels) - length
    split = (torch.ones_like(length) << (levels - K9_K).clamp(min=0)) - (pad >> K9_K)
    blocks = torch.where(levels <= K9_K, 1, split)
    return torch.where(length == 0, int(first_pass), blocks)


def bucket_passes(offsets: torch.Tensor, n: int):
    """K9's plan for (W, 2^c + 1) run offsets over n lanes, on their device:
    yields, for each of the ``k9_passes(n)`` passes in turn (so the card
    runs one pass while the host makes the next one's), each bucket's run
    in that pass's input as (start, length) and the first thread of each
    bucket's blocks (a prefix sum, one more entry: the pass's threads),
    int64 tensors.  Bucket
    b >= 1 of window w is bucket w (2^c - 1) + b - 1.  Pass 1 reads the
    lanes order[w][offsets[w][b]:...] (start w n + offsets[w][b] of the
    flat order); a later pass reads the previous pass's block sums of the
    runs it split, which lie at the first thread of their bucket."""
    W = offsets.shape[0]
    off = offsets.to(torch.int64)
    start = (off[:, 1:-1] + n * torch.arange(W, device=off.device)[:, None]).reshape(-1)
    length = (off[:, 2:] - off[:, 1:-1]).reshape(-1)
    for p in range(k9_passes(n)):
        blocks = _k9_blocks(length, p == 0)
        first = torch.zeros(blocks.shape[0] + 1, dtype=torch.int64, device=off.device)
        torch.cumsum(blocks, 0, out=first[1:])
        yield start, length, first
        start, length = first[:-1], torch.where(blocks >= 2, blocks, 0)


def window_sums_work(windows: int, c: int) -> tuple[int, int]:
    """(additions, doublings) of K10's function: the running-sum method's
    2 (2^c - 2) additions a window for sum_b b S_b, and Horner's c doublings
    and one addition a window after the first."""
    return windows * 2 * ((1 << c) - 2) + windows - 1, (windows - 1) * c


def k10_shape(windows: int, c: int) -> tuple[int, int]:
    """K10's (pieces a window G, quads a piece Q), powers of two: Q =
    K10_QUADS (fewer at small c), a chunk of buckets a quad, and G doubled
    from 1 until W G blocks fill the card twice, while G <= Q (the pieces'
    combine takes a quad a piece) and each chunk keeps at least 2 buckets (2
    G Q <= 2^c).  At c = 13: (16, 64) for W = 20, (64, 64) for W = 1."""
    nb = 1 << c
    Q = min(K10_QUADS, nb // 2)
    G = 1
    while windows * G < K10_FILL_BLOCKS and 2 * G <= Q and 4 * G * Q <= nb:
        G *= 2
    return G, Q


def _check_k10_shape(c: int, shape: tuple[int, int]) -> None:
    G, Q = shape
    if G < 1 or G & (G - 1) or Q < G or Q & (Q - 1) or 4 * Q > K10_MAX_THREADS or 2 * G * Q > 1 << c:
        raise ValueError(f"K10 shape {shape} at c = {c}: want powers of two G <= Q <= {K10_MAX_THREADS // 4}, "
                         f"2 G Q <= 2^c")


def _weighted_adds(n: int) -> int:
    """Additions of K10's weighted sum over n items: the suffix scan, the
    tree of its sums (slot 0 the identity), the tree of the acc, one more."""
    return sum(n - s for s in (1 << i for i in range(n.bit_length() - 1))) + 2 * (n - 1) + 1


def k10_executed(windows: int, c: int, shape: tuple[int, int] | None = None) -> tuple[int, int, int]:
    """(additions, doublings with T, doublings without T) K10 executes at
    ``shape`` (default ``k10_shape``): G Q chunks of m buckets a window (2
    (m - 2) additions each and one more for the chunk's bottom bucket after
    the window's chunk 0), each piece's weighted sum over its Q chunks with
    log2 m doublings, the window's over its G pieces with log2 (2^c / G)
    (none at G = 1); then Horner, c doublings and one addition a window
    after the first.  Only a doubling that an addition follows computes T."""
    G, Q = shape or k10_shape(windows, c)
    n, log_p = G * Q, c - (G.bit_length() - 1)
    log_m = log_p - (Q.bit_length() - 1)
    adds = n * 2 * ((1 << log_m) - 2) + n - 1 + G * _weighted_adds(Q)
    dbls = [G, G * (log_m - 1)]
    if G > 1:
        adds += _weighted_adds(G)
        dbls = [dbls[0] + 1, dbls[1] + log_p - 1]
    return (windows * adds + windows - 1, windows * dbls[0] + windows - 1,
            windows * dbls[1] + (windows - 1) * (c - 1))


def muladds(name: str, items: int, set_bits: int = 0, doublings: int = 0) -> int:
    """32-bit multiply-adds of kernel ``name`` over ``items`` work items
    (``set_bits``: the set bits among K7's scalars, bits 0-252;
    ``doublings``: K10's)."""
    if name == "windowed_lanes_k8_fe15":
        per_mul, per_sq = MULADDS_PER_FIELD_MUL15, MULADDS_PER_FIELD_SQ15
    else:
        per_mul, per_sq = MULADDS_PER_FIELD_MUL, MULADDS_PER_FIELD_SQ
    muls = items * FIELD_MULS[name] + set_bits * DAA_MULS_PER_SET_BIT + doublings * DBL_MULS
    return muls * per_mul + (items * FIELD_SQS[name] + doublings * DBL_SQS) * per_sq


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


def pack_bits(scalars) -> _np.ndarray:
    """list[int] or (N, 32) uint8 canonical little-endian scalars -> (8, N)
    uint32: bit k of scalar i is bit k % 32 of word k // 32."""
    if not isinstance(scalars, _np.ndarray):
        raw = b"".join(s.to_bytes(32, "little") for s in scalars)
        scalars = _np.frombuffer(raw, dtype=_np.uint8).reshape(-1, 32)
    words = _np.ascontiguousarray(scalars, dtype=_np.uint8).view("<u4")  # (N, 8)
    return _np.ascontiguousarray(words.T)


def pack_bits_torch(scalars: torch.Tensor) -> torch.Tensor:
    """Device form of ``pack_bits``: (N, 32) uint8 -> (8, N) int32 words (the
    same bits; K7 reads them as unsigned).  The little-endian bytes viewed as
    words and transposed."""
    return scalars.contiguous().view(torch.int32).T.contiguous()


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
    """K3's order: each tile cut into sub-tiles of K3_SUB rows (the whole
    tile when it is smaller), each reduced by ``_tree_reduce`` (lane i + h
    onto lane i, h halving), then the sub-tiles' partial sums by
    ``_tree_reduce`` again."""
    c = _curve(rows.device)
    n = rows.shape[0]
    sub = min(tile, K3_SUB)
    lanes = rows.reshape(n // tile, tile // sub, sub, 4, NLIMBS).permute(2, 0, 1, 3, 4)  # sub-tile lanes first
    parts = _tree_reduce(c, rows_to_point(lanes), sub)  # (n_tiles, tile / sub) each
    parts = tuple(p.transpose(0, 1) for p in parts)  # partials first
    return point_to_rows(_tree_reduce(c, parts, tile // sub), c.fe).to(torch.int32)


def packed_slots_plain(points: torch.Tensor, digits: torch.Tensor, split: int) -> torch.Tensor:
    """slot s = sum_k s_k P_k with the slot split over ``split`` threads, as
    the packed-lanes body of csrc/ed25519.cuh: per-sub 1P..8P niels tables;
    thread j owns subs [j 8/split, (j+1) 8/split) and runs its own
    accumulator over 64 windows of 4 doublings and 8/split signed-digit adds;
    then ``_tree_reduce`` adds the partial sums."""
    c = _curve(points.device)
    fe = c.fe
    S = points.shape[1]
    per = K_PACK // split
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
    # (9, split, per, S, 18): sub k = j per + kk of thread j
    table = tuple(torch.stack([e[i] for e in entries]).reshape(9, split, per, S, NLIMBS) for i in range(4))
    d = (digits.to(torch.int64) - 8).reshape(split, per, N_WINDOWS, S)
    threads = torch.arange(split, device=points.device)[:, None]
    slots = torch.arange(S, device=points.device)[None, :]
    acc = c.identity((split, S))
    for w in range(N_WINDOWS - 1, -1, -1):
        for want_t in (False, False, False, True):
            acc = c.double(acc, want_t)
        for kk in range(per):
            e = d[:, kk, w]  # (split, S)
            q = tuple(t[e.abs(), threads, kk, slots] for t in table)
            acc = c.add_niels(acc, q, e < 0)
    return point_to_rows(_tree_reduce(c, acc, split), fe).to(torch.int32)


def windowed_lanes_k8_plain(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """K2's order: the slot split over K2_SPLIT threads."""
    return packed_slots_plain(points, digits, K2_SPLIT)


def windowed_lanes_k8_fe15_plain(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """K6's order: the slot split over K6_SPLIT threads (the torch Field is
    itself an 18 x 15-bit tier, so this is K6's arithmetic in tensor form)."""
    return packed_slots_plain(points, digits, K6_SPLIT)


def windowed_lanes_plain(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """lane i = s_i P_i, as K5: an extended table 1P..8P, then 64 windows of
    4 doublings, a signed table pick (stored 8 picks the identity) and one
    unified addition."""
    c = _curve(points.device)
    fe = c.fe
    n = points.shape[0]
    t1 = rows_to_point(points)  # (N, 18) each
    t2 = c.double(t1)
    t3 = c.add(t2, t1)
    t4 = c.double(t2)
    t5 = c.add(t4, t1)
    t6 = c.double(t3)
    t7 = c.add(t6, t1)
    t8 = c.double(t4)
    entries = [c.identity((n,)), t1, t2, t3, t4, t5, t6, t7, t8]
    table = tuple(torch.stack([e[i] for e in entries]) for i in range(4))  # (9, N, 18)
    d = digits.to(torch.int64) - 8
    lanes = torch.arange(n, device=points.device)
    acc = c.identity((n,))
    for w in range(N_WINDOWS - 1, -1, -1):
        for want_t in (False, False, False, True):
            acc = c.double(acc, want_t)
        e = d[w]
        x, y, z, t = (tab[e.abs(), lanes] for tab in table)
        neg = e < 0
        acc = c.add(acc, (fe.cneg(neg, x), y, z, fe.cneg(neg, t)))
    return point_to_rows(acc, fe).to(torch.int32)


def add_compress_plain(a: torch.Tensor, b: torch.Tensor, sums_from: int | None = None):
    """K8's function: lane (r, j) = a[r] + b[j] by ``Curve.add`` over the
    broadcast (R, n) grid, then ``compress_plain`` of the canonical sums;
    the sums of the columns from ``sums_from`` on (None: no sums)."""
    c = _curve(a.device)
    R, n = a.shape[0], b.shape[0]
    p = tuple(x[:, None].expand(R, n, NLIMBS) for x in rows_to_point(a))
    q = tuple(x[None].expand(R, n, NLIMBS) for x in rows_to_point(b))
    rows = point_to_rows(c.add(p, q), c.fe).to(torch.int32)
    return compress_plain(rows), None if sums_from is None else rows[:, sums_from:].contiguous()


def daa_lanes_plain(points: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """lane i = s_i P_i, as K7: 253 steps, LSB first, of an addition of the
    running base where the bit is set and a doubling of the base."""
    c = _curve(points.device)
    n = points.shape[0]
    acc, base = c.identity((n,)), rows_to_point(points)
    for k in range(N_BITS):
        bit = (bits[k // 32].to(torch.int64) >> (k % 32)) & 1
        acc = c.select(bit.bool(), c.add(acc, base), acc)
        base = c.double(base)
    return point_to_rows(acc, c.fe).to(torch.int32)


def bucket_sums_plain(rows: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """K9's function in the JAX package's order: each window's lanes taken in
    ``order``, a segment head wherever the digit changes, the segmented
    Hillis-Steele scan (ops.msm._inclusive_scan), and each bucket's last
    element; empty buckets hold the identity."""
    from .msm import _inclusive_scan

    c = _curve(rows.device)
    W, nb = order.shape[0], offsets.shape[1] - 1
    out = identity_rows(W * (nb - 1), rows.device).reshape(W, nb - 1, 4, NLIMBS)
    pts = rows_to_point(rows)
    digit = torch.arange(nb, device=rows.device)
    for w in range(W):
        off = offsets[w].to(torch.int64)
        counts = off[1:] - off[:-1]
        ds = torch.repeat_interleave(digit, counts)
        if ds.numel() == 0:
            continue
        flags = ds != torch.cat([ds[:1] - 1, ds[:-1]])
        lanes = order[w].to(torch.int64)
        _, scanned = _inclusive_scan(c, flags, tuple(p[lanes] for p in pts))
        b = torch.nonzero(counts[1:]).flatten() + 1  # the buckets that hold lanes
        last = off[b + 1] - 1
        out[w, b - 1] = point_to_rows(tuple(s[last] for s in scanned), c.fe).to(torch.int32)
    return out


def _weighted_plain(cv: Curve, tot, acc, log_s: int):
    """K10's weighted sum over the n items of the leading axis, each of
    2^log_s buckets with total tot_k and local weighted sum acc_k: (sum_k
    acc_k + 2^log_s sum_k k tot_k, sum_k tot_k), by the steps of
    csrc/window_sums.cu block_weighted: the suffix scan of the totals (its
    slot 0 the total), their tree with slot 0 the identity, log2 s
    doublings, the tree of the acc and one addition."""
    n, s = tot[0].shape[0], 1
    while s < n:
        head = cv.add(tuple(x[: n - s] for x in tot), tuple(x[s:] for x in tot))
        tot = tuple(torch.cat([h, x[n - s :]]) for h, x in zip(head, tot))
        s *= 2
    total = tuple(x[0] for x in tot)
    ident = cv.identity((1, *total[0].shape[:-1]))
    x = _tree_reduce(cv, tuple(torch.cat([i, t[1:]]) for i, t in zip(ident, tot)), n)
    for i in range(log_s):
        x = cv.double(x, want_t=i == log_s - 1)
    return cv.add(_tree_reduce(cv, acc, n), x), total


def window_sums_plain(buckets: torch.Tensor, shape: tuple[int, int] | None = None) -> torch.Tensor:
    """K10's function in its order at ``shape`` (G pieces a window, Q quads
    a piece; default ``k10_shape``): per window, G Q chunks of m buckets
    walked from the top (suffix sums r, their sum acc), each piece's
    weighted sum over its Q chunks and the window's over its G pieces
    (``_weighted_plain``); then Horner over the windows from the top, c
    doublings (T on the last) and one addition each.  (W, 2^c - 1, 4, 18)
    -> (1, 4, 18)."""
    cv = _curve(buckets.device)
    W, nb = buckets.shape[0], buckets.shape[1] + 1
    c = nb.bit_length() - 1
    G, Q = shape or k10_shape(W, c)
    _check_k10_shape(c, (G, Q))
    n = G * Q
    m = nb // n
    ident = cv.identity((W, 1))
    # bucket b of chunk k = b // m at [:, k, b % m]; bucket 0 (the identity) is never read
    full = tuple(torch.cat([i, s], dim=1).reshape(W, n, m, NLIMBS) for i, s in zip(ident, rows_to_point(buckets)))

    def bucket(j):
        return tuple(f[:, :, j] for f in full)

    r = bucket(m - 1)
    acc = r
    for j in range(m - 2, 0, -1):
        r = cv.add(r, bucket(j))
        acc = cv.add(acc, r)
    not_first = (torch.arange(n, device=buckets.device) > 0)[None, :].expand(W, n)
    r = cv.select(not_first, cv.add(r, bucket(0)), r)

    def chunks_first(p):  # (W, G, Q) chunks -> Q leading: a piece's chunks are the items
        return tuple(x.reshape(W, G, Q, NLIMBS).permute(2, 0, 1, 3) for x in p)

    log_p = c - (G.bit_length() - 1)
    wsum, total = _weighted_plain(cv, chunks_first(r), chunks_first(acc), log_p - (Q.bit_length() - 1))
    if G > 1:  # the pieces are the items: (G, W)
        wsum, _ = _weighted_plain(cv, tuple(x.transpose(0, 1) for x in total),
                                  tuple(x.transpose(0, 1) for x in wsum), log_p)
    else:
        wsum = tuple(x[:, 0] for x in wsum)
    out = tuple(v[W - 1] for v in wsum)
    for w in range(W - 2, -1, -1):
        for i in range(c):
            out = cv.double(out, want_t=i == c - 1)
        out = cv.add(out, tuple(v[w] for v in wsum))
    return point_to_rows(out, cv.fe).to(torch.int32)[None]


def k10_rounds_plain(point: torch.Tensor, c: int, n: int) -> torch.Tensor:
    """K10's chain-rounds aid: from the point p of (1, 4, 18) rows, n times
    c doublings (T on the last) and one addition of p; (1, 4, 18) rows of
    (Horner's sum of n + 1 ones in base 2^c) p."""
    cv = _curve(point.device)
    p = rows_to_point(point)
    out = p
    for _ in range(n):
        for i in range(c):
            out = cv.double(out, want_t=i == c - 1)
        out = cv.add(out, p)
    return point_to_rows(out, cv.fe).to(torch.int32)


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
    """Launch on the device of the first tensor argument, on its current
    stream (a mesh's shards may lie on different cards)."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    fn = kernel_fn(fn_name)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        rc = fn(*ptrs, torch.cuda.current_stream(device).cuda_stream)
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
    (S, 4, 18) int32 canonical slot sums.  The kernel builds its niels
    tables in a scratch the wrapper allocates (``slot_tables``)."""
    S = points.shape[1]
    _expect(points, torch.int32, (K_PACK, S, 4, NLIMBS), "lane points")
    _expect(digits, torch.uint8, (K_PACK, N_WINDOWS, S), "lane digits")
    if not _on_card(points):
        return windowed_lanes_k8_plain(points, digits)
    out = torch.empty((S, 4, NLIMBS), dtype=torch.int32, device=points.device)
    if S:
        tables = slot_tables(S, GE_WORDS, points.device)
        _launch("windowed_lanes_k8", "windowed_lanes", points, digits, out, tables, S)
    return out


def slot_tables(S: int, words: int, device) -> torch.Tensor:
    """K2's and K6's scratch: the niels tables of S slots (8 subs x 9
    entries of ``words`` 32-bit words each)."""
    return torch.empty((K_PACK * K2_TABLE * S, words), dtype=torch.int32, device=device)


def windowed_lanes_k8_fe15(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """K6: K2's function and shapes on the 15-bit field tier, its niels
    tables in a scratch of ``slot_tables``."""
    S = points.shape[1]
    _expect(points, torch.int32, (K_PACK, S, 4, NLIMBS), "lane points")
    _expect(digits, torch.uint8, (K_PACK, N_WINDOWS, S), "lane digits")
    if not _on_card(points):
        return windowed_lanes_k8_fe15_plain(points, digits)
    out = torch.empty((S, 4, NLIMBS), dtype=torch.int32, device=points.device)
    if S:
        tables = slot_tables(S, GE15_WORDS, points.device)
        _launch("windowed_lanes_k8_fe15", "windowed_lanes_fe15", points, digits, out, tables, S)
    return out


def windowed_lanes(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """K5: points (N, 4, 18) int32, digits (64, N) uint8 (e + 8) ->
    (N, 4, 18) int32 canonical lanes s_i P_i."""
    n = points.shape[0]
    _expect(points, torch.int32, (n, 4, NLIMBS), "lane points")
    _expect(digits, torch.uint8, (N_WINDOWS, n), "lane digits")
    if not _on_card(points):
        return windowed_lanes_plain(points, digits)
    out = torch.empty((n, 4, NLIMBS), dtype=torch.int32, device=points.device)
    if n:
        _launch("windowed_lanes", "windowed_lane", points, digits, out, n)
    return out


def daa_lanes(points: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """K7: points (N, 4, 18) int32, bits (8, N) int32 words (``pack_bits``)
    -> (N, 4, 18) int32 canonical lanes s_i P_i over bits 0-252."""
    n = points.shape[0]
    _expect(points, torch.int32, (n, 4, NLIMBS), "lane points")
    _expect(bits, torch.int32, (N_WORDS, n), "lane bit words")
    if not _on_card(points):
        return daa_lanes_plain(points, bits)
    out = torch.empty((n, 4, NLIMBS), dtype=torch.int32, device=points.device)
    if n:
        _launch("daa_lanes", "daa_lanes", points, bits, out, n)
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
    n_tiles = n // tile
    out = torch.empty((n_tiles, 4, NLIMBS), dtype=torch.int32, device=rows.device)
    if n:
        partials, counters = _k3_scratch(n, n_tiles, rows.device) if tile > K3_SUB else (None, None)
        _launch("tile_sums", "tile_sums", rows, out, partials, counters, n_tiles, tile)
    return out


# K3's scratch for tiles above K3_SUB rows, one per (device, stream): the
# sub-tiles' partial sums and a counter a tile.  The counters are zeroed when
# the scratch is made or grown, and the last block of each tile sets its
# counter back to zero, so a call adds no fill launch.  Launches on one
# stream run in order, so no two use the scratch at once.
_k3_scratches: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def _k3_scratch(n: int, n_tiles: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    have = _k3_scratches.get(key)
    if have is None or have[0].shape[0] < n // K3_SUB or have[1].shape[0] < n_tiles:
        rows = max(n // K3_SUB, have[0].shape[0] if have else 0)
        tiles = max(n_tiles, have[1].shape[0] if have else 0)
        have = (torch.empty((rows, GE_WORDS), dtype=torch.int32, device=device),
                torch.zeros((tiles,), dtype=torch.int32, device=device))
        _k3_scratches[key] = have
    return have


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


def add_compress(a: torch.Tensor, b: torch.Tensor, sums_from: int | None = None):
    """K8: a (R, 4, 18) and b (n, 4, 18) int32 rows -> ((R, n, 32) uint8
    encodings of the sums a[r] + b[j], the (R, n - sums_from, 4, 18) int32
    canonical sums of the columns sums_from.. or None when ``sums_from`` is
    None)."""
    R, n = a.shape[0], b.shape[0]
    _expect(a, torch.int32, (R, 4, NLIMBS), "addend rows a")
    _expect(b, torch.int32, (n, 4, NLIMBS), "addend rows b")
    if a.device != b.device:
        raise ValueError(f"addends on {a.device} and {b.device}: want one device")
    if sums_from is not None and not 0 <= sums_from <= n:
        raise ValueError(f"sums_from {sums_from} outside [0, {n}]")
    if not _on_card(a):
        return add_compress_plain(a, b, sums_from)
    enc = torch.empty((R, n, 32), dtype=torch.uint8, device=a.device)
    sums = None if sums_from is None else torch.empty((R, n - sums_from, 4, NLIMBS), dtype=torch.int32,
                                                        device=a.device)
    if R and n:
        _launch("add_compress", "add_compress", a, b, enc, sums, R, n, n if sums_from is None else sums_from)
    return enc, sums


def bucket_sums(rows: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """K9: rows (N, 4, 18) int32, order (W, N) int32 (each window's lane
    indices sorted by digit), offsets (W, 2^c + 1) int32 (bucket b of window
    w is order[w][offsets[w][b] : offsets[w][b + 1]]) -> (W, 2^c - 1, 4, 18)
    int32 canonical sums of buckets 1 .. 2^c - 1."""
    n, W, nb = rows.shape[0], order.shape[0], offsets.shape[1] - 1
    _expect(rows, torch.int32, (n, 4, NLIMBS), "lane points")
    _expect(order, torch.int32, (W, n), "sorted lane order")
    _expect(offsets, torch.int32, (W, nb + 1), "bucket offsets")
    if nb < 2 or nb & (nb - 1) or nb > 1 << 24:
        raise ValueError(f"{nb} buckets: want a power of two, 2 to 2^24")
    if not _on_card(rows):
        return bucket_sums_plain(rows, order, offsets)
    if n >= 1 << 31:  # the kernel's lane indices are int32
        raise ValueError(f"{n} lanes: K9 takes fewer than 2^31")
    out = torch.empty((W, nb - 1, 4, NLIMBS), dtype=torch.int32, device=rows.device)
    if W:
        nbk, passes = W * (nb - 1), k9_passes(n)
        # threads of a pass at most: in pass 1 a run of L > 0 lanes makes at
        # most ceil(L / 2^K9_K) blocks; a later pass has at most a thread for
        # each block sum it reads, fewer than the pass before it had threads
        cap = nbk + ((W * n) >> K9_K)
        scratch = [torch.empty((cap, GE_WORDS), dtype=torch.int32, device=rows.device)
                   for _ in range(min(2, passes - 1))]
        src = None
        for p, (start, length, first) in enumerate(bucket_passes(offsets, n)):
            dst = scratch[p % 2] if p + 1 < passes else None
            _launch("bucket_sums", "bucket_sums", rows, order if p == 0 else None, src, start, length, first,
                    nbk, cap, out, dst)
            src = dst
    return out


K10_MODES = {"phase1": 0, "whole": 1, "serial": 2}  # csrc/window_sums.cu k10_mode


def window_sums(buckets: torch.Tensor, shape: tuple[int, int] | None = None, part: str = "whole"):
    """K10: (W, 2^c - 1, 4, 18) int32 bucket sums -> (1, 4, 18) int32
    canonical rows of sum_w 2^(c w) sum_b b S_{w,b}, at ``shape`` (G pieces
    a window, Q quads a piece; default ``k10_shape``).  ``part`` times the
    card's launch, and no entry point sets it: "phase1" launches the window
    sums without the Horner chain and returns None; "serial" starts the
    chain only once every window's sum is ready (no overlap)."""
    W, nb = buckets.shape[0], buckets.shape[1] + 1
    _expect(buckets, torch.int32, (W, nb - 1, 4, NLIMBS), "bucket sums")
    if nb < 2 or nb & (nb - 1) or nb > 1 << 24 or W < 1:
        raise ValueError(f"{W} windows of {nb - 1} buckets: want at least one window of 2^c - 1, c in 1..24")
    c = nb.bit_length() - 1
    G, Q = shape or k10_shape(W, c)
    _check_k10_shape(c, (G, Q))
    if part not in K10_MODES:
        raise ValueError(f"K10 part {part!r}: want one of {list(K10_MODES)}")
    if not _on_card(buckets):
        if part != "whole":
            raise ValueError("K10's parts time the card's launch; its plain version is whole")
        return window_sums_plain(buckets, (G, Q))
    out = torch.empty((1, 4, NLIMBS), dtype=torch.int32, device=buckets.device)
    scratch = torch.empty(((2 * G + 1) * W, GE_WORDS), dtype=torch.int32, device=buckets.device)
    sync = torch.zeros((1 + 2 * W,), dtype=torch.int32, device=buckets.device)
    _launch("window_sums", "window_sums", buckets, scratch, scratch[2 * G * W :], sync, out, W, c, G, Q,
            K10_MODES[part])
    return None if part == "phase1" else out


def k10_rounds(point: torch.Tensor, c: int, n: int) -> torch.Tensor:
    """K10's Horner steps alone on one quad of threads (k10_rounds_plain's
    function): 2 n (c + 1) dependent rounds with nothing to wait on, which
    time the latency floor of K10's chain.  No entry point calls it; on the
    card it counts as a K10 launch."""
    _expect(point, torch.int32, (1, 4, NLIMBS), "K10 rounds' point")
    if not 1 <= c <= 24 or n < 1:
        raise ValueError(f"K10 rounds at c = {c}, n = {n}: want c in 1..24 and n >= 1")
    if not _on_card(point):
        return k10_rounds_plain(point, c, n)
    out = torch.empty((1, 4, NLIMBS), dtype=torch.int32, device=point.device)
    _launch("window_sums", "k10_rounds", point, out, c, n)
    return out


def identity_rows(n: int, device) -> torch.Tensor:
    rows = torch.zeros((n, 4, NLIMBS), dtype=torch.int32, device=device)
    rows[:, 1:3, 0] = 1
    return rows
