"""The roofline probes K11-K14, with their wrappers, plain versions and
multiply-add counts; their launch counts are in ``kernels.launches``.

=====  ================  ======================================================
 id     kernel (csrc/)    replaces
=====  ================  ======================================================
 K11    probe_imad.cu     scripts/bench_roofline.py lane_call(make_raw): the
                          u32 multiply-add x = x y + 1, 81 steps a rep on 4
                          chains; the same chain as a 32 x 32 -> 64-bit
                          multiply-add (``wide``) and as the high word's
                          multiply-add x = hi32(x y) + x (``hi``)
 K12    probe_mul15.cu    bench_roofline.py lane_call(make_fm), bench_fe13.py
                          k15, bench_qtile.py's tiles: _mul_t on 4 chains,
                          as column sums
 K13    probe_mul13.cu    bench_roofline.py lane_call13(make_fm13),
                          bench_fe13.py k_full, k_def, k_def2: _mul13 and the
                          2-pass form with and without the consumer's carry
 K14    probe_fe.cu       no Pallas kernel: the port's own fe_mul / fe_sq
                          (csrc/ed25519.cuh) on the radix-2^25.5 tier and fe15
=====  ================  ======================================================

Arrays are (rows, T) int32 holding the probes' u32 values bit for bit; a
lane is a column (K11: an element).  Chain k of a lane starts from x with k
added to every limb, as the JAX kernels' ``x_ref[:] + k``.  K11-K13 return
the XOR of the 4 chains, as the JAX kernels do; K14 returns the chains,
(4, limbs, T), so that a chain's value can be held to x_k y^reps mod p.

On a CUDA tensor a wrapper launches its kernel on the current stream (or
raises); on a CPU tensor it runs the plain version, which computes in int64
and asserts the u32 bounds the JAX helpers rely on.
"""

from __future__ import annotations

import torch

from . import kernels as K

P = 2**255 - 19
M32 = (1 << 32) - 1
CHAINS = 4
IMAD_STEPS = 81
NL15, NL13 = 18, 20
MASK15, MASK13 = (1 << 15) - 1, (1 << 13) - 1
FOLD13 = 608  # 2^(13 * 20 - 255) * 19
MUL15_BLOCKS = (128, 256, 512)
MUL13_MODES = ("3pass", "2pass_consumer", "2pass")  # csrc/probes.cuh MUL13_*
FE_TIERS = {"fe": 10, "fe15": 18}  # limbs a field element
FE_WIDTHS = (26, 25) * 5  # the radix-2^25.5 limbs' widths

# 32-bit multiply-adds of one work item: K11's a rep of an element (4 chains
# of 81); a _mul_t (324 products, 17 times 19 and one times 361 in the fold,
# one times 19 in each of its two carries); a _mul13 (400 products, 38 times
# 608 in the fold, 2 in the wide carry, 1 in the simple one, 1 more in the
# consumer's carry).  K14's come from ops/kernels.py.
MULADDS_IMAD = CHAINS * IMAD_STEPS
MULADDS_MUL_T = 324 + 17 + 1 + 2
MULADDS_MUL13 = {"3pass": 400 + 41, "2pass_consumer": 400 + 42, "2pass": 400 + 41}


def fe_muladds(tier: str, square: bool) -> int:
    if tier == "fe15":
        return K.MULADDS_PER_FIELD_SQ15 if square else K.MULADDS_PER_FIELD_MUL15
    return K.MULADDS_PER_FIELD_SQ if square else K.MULADDS_PER_FIELD_MUL


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return t.to(torch.int64) & M32


def _i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 bit patterns."""
    return torch.where(v > 0x7FFFFFFF, v - (1 << 32), v).to(torch.int32)


def _fits(v: torch.Tensor, what: str, bits: int = 32) -> torch.Tensor:
    """Assert (on CPU tensors: no sync on the card) that ``v`` stays below
    2^bits, as the u32 (or u64) arithmetic it stands for needs."""
    if v.device.type == "cpu" and v.numel():
        assert int(v.max()) >> bits == 0, f"{what} leaves {bits} bits"
    return v


def _chains(x: torch.Tensor) -> torch.Tensor:
    """(rows, T) int32 -> (4, rows, T) int64: chain k is x + k in u32."""
    v = _u32(x)
    return torch.stack([(v + k) & M32 for k in range(CHAINS)])


def _xor4(c: torch.Tensor) -> torch.Tensor:
    return _i32(c[0] ^ c[1] ^ c[2] ^ c[3])


def _mulmod32(a: torch.Tensor, b_lo: torch.Tensor, b_hi: torch.Tensor) -> torch.Tensor:
    """a b mod 2^32 for a < 2^32 and b = b_hi 2^16 + b_lo (16-bit halves):
    each partial product stays below 2^48."""
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & M32


def _hi32(a: torch.Tensor, b_lo: torch.Tensor, b_hi: torch.Tensor) -> torch.Tensor:
    """floor(a b / 2^32) for a < 2^32 and b = b_hi 2^16 + b_lo (16-bit
    halves): each partial product stays below 2^48."""
    return (a * b_hi + ((a * b_lo) >> 16)) >> 16


def probe_imad_plain(x: torch.Tensor, y: torch.Tensor, reps: int, wide: bool = False,
                     hi: bool = False) -> torch.Tensor:
    """K11's function.  u32: each chain takes 81 reps steps of c = c y + 1
    mod 2^32, computed a rep at a time as the 81 steps' composed map
    c = A c + B (A = y^81, B = 1 + y + ... + y^80, mod 2^32).  wide: each
    step acc = lo(acc) y + acc mod 2^64, i.e. lo = lo (y + 1) mod 2^32 and
    hi = hi + floor(lo (y + 1) / 2^32) mod 2^32; out is the XOR over the
    chains of lo ^ hi.  hi: each step c = floor(c y / 2^32) + c mod 2^32."""
    c, yv = _chains(x), _u32(y)
    if wide and hi:
        raise ValueError("probe_imad: one form, wide or hi")
    if hi:
        y_lo, y_hi = yv & 0xFFFF, yv >> 16
        for _ in range(reps * IMAD_STEPS):
            c = (_hi32(c, y_lo, y_hi) + c) & M32
        return _xor4(c)
    if not wide:
        a, b = torch.ones_like(yv), torch.zeros_like(yv)
        y_lo, y_hi = yv & 0xFFFF, yv >> 16
        for _ in range(IMAD_STEPS):
            a, b = _mulmod32(a, y_lo, y_hi), (_mulmod32(b, y_lo, y_hi) + 1) & M32
        a_lo, a_hi = a & 0xFFFF, a >> 16
        for _ in range(reps):
            c = (_mulmod32(c, a_lo, a_hi) + b) & M32
        return _xor4(c)
    y1 = yv + 1  # up to 2^32: its high half is below 2^17
    y_lo, y_hi = y1 & 0xFFFF, y1 >> 16
    lo, hi = c, torch.zeros_like(c)
    for _ in range(reps * IMAD_STEPS):
        p = lo * y_lo
        q = lo * y_hi
        s = p + ((q & 0xFFFF) << 16)  # lo (y + 1) = s + (q >> 16) 2^32
        hi = (hi + (s >> 32) + (q >> 16)) & M32
        lo = s & M32
    return _xor4(lo ^ hi)


def _carry_t(t: torch.Tensor) -> torch.Tensor:
    """pallas_msm._carry_t on (C, 18, n)."""
    hi = t >> 15
    out = t & MASK15
    out[:, 1:] += hi[:, :-1]
    out[:, 1] += hi[:, NL15 - 1] * 19
    return _fits(out, "_carry_t")


def _mul_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """pallas_msm._mul_t on (C, 18, n) by (18, n).  Every limb is below
    2^16, as K12's column-sum form needs (the relaxed limbs are at most
    2^15 + 2^11)."""
    _fits(a, "_mul_t limb of a", 16)
    _fits(b, "_mul_t limb of b", 16)
    acc = torch.zeros(a.shape[0], 2 * NL15, a.shape[2], dtype=torch.int64, device=a.device)
    for j in range(NL15):
        p = _fits(a * b[j], "_mul_t product")
        acc[:, j : j + NL15] += p & MASK15
        acc[:, j + 1 : j + NL15 + 1] += p >> 15
    _fits(acc, "_mul_t column")
    folded = acc[:, :NL15].clone()
    folded[:, 1:] += acc[:, NL15 : 2 * NL15 - 1] * 19
    folded[:, 1] += acc[:, 2 * NL15 - 1] * 361
    return _carry_t(_carry_t(_fits(folded, "_mul_t fold")))


def probe_mul15_plain(x: torch.Tensor, y: torch.Tensor, reps: int) -> torch.Tensor:
    """K12's function: ``reps`` _mul_t by y on each of the 4 chains of every
    lane, the XOR of the chains."""
    c, b = _chains(x), _u32(y)
    for _ in range(reps):
        c = _mul_t(c, b)
    return _xor4(c)


def _carry13(t: torch.Tensor) -> torch.Tensor:
    """pallas_msm._carry13 on (C, 20, n)."""
    cy = t >> 13
    out = t & MASK13
    out[:, 1:] += cy[:, :-1]
    out[:, 0] += cy[:, NL13 - 1] * FOLD13
    return _fits(out, "_carry13")


def _carry13_wide(t: torch.Tensor) -> torch.Tensor:
    """pallas_msm._carry13_wide on (C, 20, n)."""
    cy = t >> 13
    out = t & MASK13
    out[:, 1:] += cy[:, :-1]
    top = cy[:, NL13 - 1]
    out[:, 0] += (top & MASK13) * FOLD13
    out[:, 1] += (top >> 13) * FOLD13
    return _fits(out, "_carry13_wide")


def _mul13(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """_mul13 (mode 3pass), bench_fe13.py's _mul13_2pass (2pass), or
    _carry13 of it (2pass_consumer), on (C, 20, n) by (20, n)."""
    acc = torch.zeros(a.shape[0], 2 * NL13 - 1, a.shape[2], dtype=torch.int64, device=a.device)
    for j in range(NL13):
        acc[:, j : j + NL13] += _fits(a * b[j], "_mul13 product")
    _fits(acc, "_mul13 column")
    hi = acc[:, NL13:]
    low = acc[:, :NL13].clone()
    low[:, : NL13 - 1] += (hi & MASK13) * FOLD13
    low[:, 1:] += (hi >> 13) * FOLD13
    t = _carry13(_carry13_wide(_fits(low, "_mul13 fold")))
    if mode == "3pass":
        t[:, 1] += t[:, 0] >> 13
        t[:, 0] &= MASK13
    elif mode == "2pass_consumer":
        t = _carry13(t)
    return t


def probe_mul13_plain(x: torch.Tensor, y: torch.Tensor, reps: int, mode: str) -> torch.Tensor:
    """K13's function in ``mode`` (MUL13_MODES)."""
    c, b = _chains(x), _u32(y)
    for _ in range(reps):
        c = _mul13(c, b, mode)
    return _xor4(c)


def _index(n: int, cols: int, wrap: bool) -> torch.Tensor:
    return torch.tensor([(i + j) % cols if wrap else i + j for i in range(n) for j in range(n)])


_FE_COL = _index(10, 10, True)
_FE_ODD = torch.tensor([[2 if i & j & 1 else 1 for j in range(10)] for i in range(10)])
_FE_WRAP = torch.tensor([[i + j >= 10 for j in range(10)] for i in range(10)])
_FE15_COL = _index(18, 0, False)


def _fe_mul(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """ed25519.cuh fe_mul on (C, 10, n) by g of f's shape (fe_sq's columns
    are fe_mul(f, f)'s, so it serves both): products of two odd limbs
    doubled, columns >= 10 wrapped with 19 g_j, then fe_reduce64."""
    dev = f.device
    _fits(2 * f, "fe_mul 2 f")
    g19 = _fits(19 * g, "fe_mul 19 g")
    a = f[:, :, None, :] * _FE_ODD.to(dev)[None, :, :, None]
    b = torch.where(_FE_WRAP.to(dev)[None, :, :, None], g19[:, None, :, :], g[:, None, :, :])
    t = torch.zeros_like(f).index_add_(1, _FE_COL.to(dev), (a * b).reshape(f.shape[0], 100, -1))
    _fits(t, "fe_mul column", 63)
    for i in range(9):
        w = FE_WIDTHS[i]
        t[:, i + 1] += t[:, i] >> w
        t[:, i] &= (1 << w) - 1
    t[:, 0] += 19 * (t[:, 9] >> 25)
    t[:, 9] &= (1 << 25) - 1
    t[:, 1] += t[:, 0] >> 26
    t[:, 0] &= (1 << 26) - 1
    return _fits(t, "fe_reduce64 limb")


def _fe15_mul(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """ed25519.cuh fe_mul on fe15 (and fe_sq's equal columns): 35 column
    sums, columns 18-34 folded into 1-17 with 19, a carry, limb 17's carry
    wrapped into limb 1 with 19 and carried once more (fe15_reduce)."""
    C, n = f.shape[0], f.shape[2]
    prod = f[:, :, None, :] * g[:, None, :, :]
    t = torch.zeros(C, 2 * NL15 - 1, n, dtype=torch.int64, device=f.device)
    t.index_add_(1, _FE15_COL.to(f.device), prod.reshape(C, NL15 * NL15, n))
    _fits(t, "fe15 column", 63)
    t[:, 1:NL15] += 19 * t[:, NL15:]
    h = torch.empty(C, NL15, n, dtype=torch.int64, device=f.device)
    c = torch.zeros_like(t[:, 0])
    for i in range(NL15):
        v = t[:, i] + c
        c = v >> 15
        h[:, i] = v & MASK15
    w = h[:, 1] + 19 * c
    h[:, 1] = w & MASK15
    c = w >> 15
    for i in range(2, NL15):
        v = h[:, i] + c
        c = v >> 15
        h[:, i] = v & MASK15
    h[:, 1] += 19 * c
    return _fits(h, "fe15_reduce limb")


def probe_fe_plain(x: torch.Tensor, y: torch.Tensor, reps: int, tier: str = "fe",
                   square: bool = False) -> torch.Tensor:
    """K14's function: ``reps`` fe_mul by y (or fe_sq) on each of the 4
    chains of every lane on ``tier``; the chains' limbs, (4, limbs, T)."""
    c = _chains(x)
    b = _u32(y).expand_as(c)
    mul = _fe15_mul if tier == "fe15" else _fe_mul
    for _ in range(reps):
        c = mul(c, c if square else b)
    return _i32(c)


def fe_value(limbs, tier: str) -> int:
    """A lane's limbs (a sequence of ints) on ``tier`` -> its value mod p."""
    shifts = [15 * i for i in range(NL15)] if tier == "fe15" else [
        26 * ((i + 1) >> 1) + 25 * (i >> 1) for i in range(10)]
    return sum((int(v) & M32) << s for v, s in zip(limbs, shifts)) % P


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _operands(x: torch.Tensor, y: torch.Tensor, rows, reps: int, what: str) -> int:
    """Check x and y (contiguous int32 (rows, T) on one device) and reps;
    returns T."""
    if x.dim() != 2 or (rows is not None and x.shape[0] != rows):
        raise ValueError(f"{what}: want ({rows or 'rows'}, T), got {tuple(x.shape)}")
    K._expect(x, torch.int32, x.shape, f"{what} x")
    K._expect(y, torch.int32, x.shape, f"{what} y")
    if x.device != y.device:
        raise ValueError(f"{what}: x on {x.device}, y on {y.device}")
    if not 0 <= reps < 1 << 31:
        raise ValueError(f"{what}: reps {reps} out of range")
    return x.shape[1]


def probe_imad(x: torch.Tensor, y: torch.Tensor, reps: int, wide: bool = False, hi: bool = False) -> torch.Tensor:
    """K11: (rows, T) int32 x, y -> (rows, T), every element a lane; the
    u32 chain, or the ``wide`` or the ``hi`` one."""
    _operands(x, y, None, reps, "probe_imad")
    if wide and hi:
        raise ValueError("probe_imad: one form, wide or hi")
    if not K._on_card(x):
        return probe_imad_plain(x, y, reps, wide, hi)
    out = torch.empty_like(x)
    if out.numel():
        K._launch("probe_imad", "probe_imad", x, y, out, out.numel(), reps, 2 if hi else int(wide))
    return out


def probe_mul15(x: torch.Tensor, y: torch.Tensor, reps: int, block: int = 256) -> torch.Tensor:
    """K12: (18, T) int32 x, y -> (18, T); ``block`` threads a block
    (MUL15_BLOCKS)."""
    T = _operands(x, y, NL15, reps, "probe_mul15")
    if block not in MUL15_BLOCKS:
        raise ValueError(f"probe_mul15: block {block} not in {MUL15_BLOCKS}")
    if not K._on_card(x):
        return probe_mul15_plain(x, y, reps)
    out = torch.empty_like(x)
    if T:
        K._launch("probe_mul15", "probe_mul15", x, y, out, T, reps, block)
    return out


def probe_mul13(x: torch.Tensor, y: torch.Tensor, reps: int, mode: str = "3pass") -> torch.Tensor:
    """K13: (20, T) int32 x, y -> (20, T) in ``mode`` (MUL13_MODES)."""
    T = _operands(x, y, NL13, reps, "probe_mul13")
    if mode not in MUL13_MODES:
        raise ValueError(f"probe_mul13: mode {mode!r} not in {MUL13_MODES}")
    if not K._on_card(x):
        return probe_mul13_plain(x, y, reps, mode)
    out = torch.empty_like(x)
    if T:
        K._launch("probe_mul13", "probe_mul13", x, y, out, T, reps, MUL13_MODES.index(mode))
    return out


def probe_fe(x: torch.Tensor, y: torch.Tensor, reps: int, tier: str = "fe", square: bool = False) -> torch.Tensor:
    """K14: (limbs, T) int32 x, y on ``tier`` (FE_TIERS) -> (4, limbs, T),
    the chains."""
    if tier not in FE_TIERS:
        raise ValueError(f"probe_fe: tier {tier!r} not in {tuple(FE_TIERS)}")
    T = _operands(x, y, FE_TIERS[tier], reps, "probe_fe")
    if not K._on_card(x):
        return probe_fe_plain(x, y, reps, tier, square)
    out = torch.empty((CHAINS, *x.shape), dtype=torch.int32, device=x.device)
    if T:
        K._launch("probe_fe", "probe_fe", x, y, out, T, reps, int(tier == "fe15"), int(square))
    return out
