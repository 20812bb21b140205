"""Batched fe25519 arithmetic on torch tensors, 18x15-bit relaxed limbs.

The plain PyTorch counterpart of ``xelis_he_tpu.ops.fe.Field``: field
elements are int64 tensors of shape (..., 18), eighteen 15-bit limbs
little-endian with slack (limbs up to 2^15 + 2^11), and every operation runs
the same algebra as the JAX package's numpy/jnp field, so the limbs of every
result equal ``numpy_field()``'s limbs exactly.

The JAX field computes in uint32 and relies on its bounds (products < 2^31,
column sums < 2^26).  Here the arithmetic runs in int64, where an overflow
the TPU would have hit would pass silently; on CPU tensors each step asserts
the u32 range instead (a check reads the tensor back to the host, so CUDA
tensors skip it).

This module holds the plain versions' arithmetic; the CUDA kernels use their
own radix-2^25.5 field (csrc/ed25519.cuh) and agree on canonical values.
"""

from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as F

from ..pyref import field as _pf

NLIMBS = 18
LIMB_BITS = 15
MASK = (1 << LIMB_BITS) - 1
SLACK_BOUND = (1 << LIMB_BITS) + (1 << 11)
U32 = 1 << 32

P_INT = _pf.P


def _int_to_limbs_list(v: int, n: int = NLIMBS) -> list[int]:
    return [(v >> (LIMB_BITS * k)) & MASK for k in range(n)]


def _pad_limbs() -> list[int]:
    """A multiple of p in NLIMBS limbs, every limb in [0x8800, 2^17), for
    borrow-free subtraction of any relaxed-limb operand."""
    m = (1 << LIMB_BITS) + (1 << 11) + 2
    v = m * P_INT
    limbs = [(v >> (LIMB_BITS * k)) & MASK for k in range(NLIMBS)]
    limbs.append(v >> (LIMB_BITS * NLIMBS))
    for k in range(NLIMBS):
        while limbs[k] < SLACK_BOUND:
            limbs[k] += 1 << LIMB_BITS
            limbs[k + 1] -= 1
    assert all(SLACK_BOUND <= l < (1 << 17) + (1 << 16) for l in limbs[:NLIMBS])
    assert limbs[NLIMBS] >= 0
    assert sum(l << (LIMB_BITS * k) for k, l in enumerate(limbs)) == m * P_INT
    return limbs


_PAD = _pad_limbs()


def _b16_to_limbs_np(b16: _np.ndarray) -> _np.ndarray:
    """(N, 17) 16-bit words -> (N, 18) 15-bit limbs (uint32)."""
    out = _np.zeros((b16.shape[0], NLIMBS), dtype=_np.uint32)
    for k in range(NLIMBS):
        bit = 15 * k
        a, s = bit // 16, bit % 16
        v = b16[:, a] >> s
        if s > 1 and a + 1 < b16.shape[1]:
            v = v | (b16[:, a + 1] << (16 - s))
        out[:, k] = v & MASK
    return out


def from_ints_np(vs) -> _np.ndarray:
    """Python ints -> (N, 18) uint32 canonical limbs (host row packing)."""
    raw = b"".join((v % P_INT).to_bytes(34, "little") for v in vs)
    b16 = _np.frombuffer(raw, dtype="<u2").reshape(len(vs), 17).astype(_np.uint32)
    return _b16_to_limbs_np(b16)


def to_ints(a) -> list[int]:
    """Canonical limbs (tensor or array, (..., 18)) -> python ints."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    arr = _np.asarray(a, dtype=_np.uint64).reshape(-1, NLIMBS)
    buf = _np.zeros((arr.shape[0], 40), dtype=_np.uint64)
    for k in range(NLIMBS):
        byte, sh = (LIMB_BITS * k) // 8, (LIMB_BITS * k) % 8
        v = arr[:, k] << sh
        buf[:, byte] += v & 0xFF
        buf[:, byte + 1] += (v >> 8) & 0xFF
        buf[:, byte + 2] += (v >> 16) & 0xFF
    acc = _np.zeros((arr.shape[0], 40), dtype=_np.uint8)
    carry = _np.zeros(arr.shape[0], dtype=_np.uint64)
    for j in range(40):
        t = buf[:, j] + carry
        acc[:, j] = t & 0xFF
        carry = t >> 8
    data = acc.tobytes()
    return [int.from_bytes(data[40 * i : 40 * i + 40], "little") for i in range(arr.shape[0])]


def limbs_to_bytes(a: torch.Tensor) -> torch.Tensor:
    """CANONICAL (..., 18) limbs -> (..., 32) uint8 little-endian."""
    words = []
    for j in range(16):
        k, s = (16 * j) // 15, (16 * j) % 15
        v = a[..., k] >> s
        if k + 1 < NLIMBS:
            v = v | (a[..., k + 1] << (15 - s))
        if k + 2 < NLIMBS and (15 - s) + 15 < 16:
            v = v | (a[..., k + 2] << (30 - s))
        words.append(v & 0xFFFF)
    w = torch.stack(words, dim=-1)
    out = torch.stack([w & 0xFF, (w >> 8) & 0xFF], dim=-1)
    return out.reshape(*a.shape[:-1], 32).to(torch.uint8)


def _diag_sums(m: torch.Tensor) -> torch.Tensor:
    """(..., 18, 18) -> (..., 36) with out[k] = sum_i m[i, k - i].

    Each row is padded to 37 and the flat buffer re-read in rows of 36, which
    shifts row i right by i; a sum over rows then adds the anti-diagonals.
    Shifted sums only: integer matmul does not exist on CUDA."""
    w = F.pad(m, (0, 2 * NLIMBS + 1 - NLIMBS)).flatten(-2)[..., : NLIMBS * 2 * NLIMBS]
    return w.reshape(*m.shape[:-2], NLIMBS, 2 * NLIMBS).sum(-2)


class Field:
    """fe25519 over int64 tensors of shape (..., 18) on ``device``: the card
    unless the caller names another (``device="cpu"`` for the kernels' plain
    versions)."""

    def __init__(self, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Field() runs on a CUDA device and none is available; "
                    "pass device='cpu' for the kernels' plain versions"
                )
            device = "cuda"
        self.device = torch.device(device)
        # a check reads the tensor back to the host: CPU tensors only
        self.check = self.device.type == "cpu"
        t = lambda limbs: torch.tensor(limbs, dtype=torch.int64, device=self.device)
        self.P_LIMBS = _int_to_limbs_list(P_INT)
        self.PAD = t(_PAD[:NLIMBS])
        # the implicit top limb of PAD (weight 2^270 = 19 * 2^15) rides in limb 1
        self.PAD_BUMP = t([0, _PAD[NLIMBS] * 19] + [0] * (NLIMBS - 2))
        self.ZERO = t([0] * NLIMBS)
        self.ONE = t(_int_to_limbs_list(1))
        self.SQRT_M1 = self.from_int(_pf.SQRT_M1)
        self.D = self.from_int(_pf.D)
        self.D2 = self.from_int(2 * _pf.D % P_INT)
        self.ONE_MINUS_D_SQ = self.from_int(_pf.ONE_MINUS_D_SQ)
        self.D_MINUS_ONE_SQ = self.from_int(_pf.D_MINUS_ONE_SQ)
        self.SQRT_AD_MINUS_ONE = self.from_int(_pf.SQRT_AD_MINUS_ONE)
        self.INVSQRT_A_MINUS_D = self.from_int(_pf.INVSQRT_A_MINUS_D)
        self.NEG_ONE = self.from_int(P_INT - 1)

    # -- conversions --------------------------------------------------------

    def from_int(self, v: int) -> torch.Tensor:
        return torch.tensor(_int_to_limbs_list(v % P_INT), dtype=torch.int64, device=self.device)

    def from_ints(self, vs) -> torch.Tensor:
        return torch.from_numpy(from_ints_np(vs).astype(_np.int64)).to(self.device)

    to_ints = staticmethod(to_ints)

    def from_bytes_le(self, b: torch.Tensor) -> torch.Tensor:
        """(..., 32) uint8 -> limbs, masking bit 255 (dalek from_bytes)."""
        b = b.to(torch.int64)
        w16 = b[..., 0::2] | (b[..., 1::2] << 8)
        w16 = torch.cat([w16[..., :15], w16[..., 15:] & 0x7FFF], dim=-1)
        limbs = []
        for k in range(NLIMBS):
            bit = 15 * k
            a, s = bit // 16, bit % 16
            if bit >= 256:
                limbs.append(torch.zeros_like(w16[..., 0]))
                continue
            v = w16[..., a] >> s
            if a + 1 < 16:
                v = v | (w16[..., a + 1] << (16 - s))
            limbs.append(v & MASK)
        return torch.stack(limbs, dim=-1)

    def to_bytes_le(self, a: torch.Tensor) -> torch.Tensor:
        """Limbs -> (..., 32) uint8 of the canonical value."""
        return limbs_to_bytes(self.canon(a))

    # -- u32 bounds of the JAX field ------------------------------------------

    def _u32(self, t: torch.Tensor, what: str) -> torch.Tensor:
        if self.check and t.numel():
            lo, hi = torch.aminmax(t)
            assert 0 <= int(lo) and int(hi) < U32, f"{what} leaves uint32: [{int(lo)}, {int(hi)}]"
        return t

    # -- carry machinery ----------------------------------------------------

    def _partial_carry(self, t):
        """Each limb keeps its low 15 bits and absorbs its neighbour's high
        bits; limb-17 carries wrap into limb 1 with weight 19."""
        hi = t >> LIMB_BITS
        out = t & MASK
        out[..., 1:] += hi[..., :-1]
        out[..., 1] += hi[..., -1] * 19
        return out

    def _exact_carry(self, t):
        """Full sequential normalization to limbs < 2^15 (canon only)."""
        for _ in range(2):
            cols = list(t.unbind(-1))
            carry = torch.zeros_like(cols[0])
            for k in range(NLIMBS):
                v = cols[k] + carry
                cols[k] = v & MASK
                carry = v >> LIMB_BITS
            cols[1] = cols[1] + carry * 19
            t = torch.stack(cols, dim=-1)
        return t

    # -- ring ops -----------------------------------------------------------

    def add(self, a, b):
        return self._partial_carry(self._u32(a + b, "add"))

    def sub(self, a, b):
        t = self._u32(a + self.PAD - b, "sub")
        return self._partial_carry(t + self.PAD_BUMP)

    def neg(self, a):
        return self.sub(self.ZERO.expand_as(a), a)

    def mul(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        prods = self._u32(a[..., :, None] * b[..., None, :], "mul products")  # (..., 18, 18)
        # lo of a_i * b_j lands in column i + j, hi in column i + j + 1
        cols = _diag_sums(prods & MASK)  # (..., 36)
        cols[..., 1:] += _diag_sums(prods >> LIMB_BITS)[..., :-1]
        # columns k >= 18 weigh 2^270 * 2^15(k-18) = 19 * 2^15(k-17): add 19 c_k
        # into column k - 17; column 35 wraps twice: 19^2 into column 1
        folded = cols[..., :NLIMBS].clone()
        folded[..., 1:] += cols[..., NLIMBS : 2 * NLIMBS - 1] * 19
        folded[..., 1] += cols[..., 2 * NLIMBS - 1] * 361
        self._u32(folded, "mul columns")
        return self._partial_carry(self._partial_carry(folded))

    def square(self, a):
        return self.mul(a, a)

    # -- canonical form & predicates ----------------------------------------

    def canon(self, a):
        """Reduce to [0, p): exact digits, fold bits >= 255, subtract p twice."""
        t = self._exact_carry(self._partial_carry(a))
        b_top = t[..., NLIMBS - 1 :]
        t = self._exact_carry(F.pad(t[..., : NLIMBS - 1], (0, 1)) + F.pad(b_top * 19, (0, NLIMBS - 1)))
        for _ in range(2):
            t = self._cond_sub_p(t)
        return t

    def _cond_sub_p(self, a):
        borrow = torch.zeros_like(a[..., 0])
        diffs = []
        for k in range(NLIMBS):
            need = self.P_LIMBS[k] + borrow
            diffs.append((a[..., k] - need) & MASK)
            borrow = (a[..., k] < need).to(torch.int64)
        diff = torch.stack(diffs, dim=-1)
        return torch.where((borrow == 0)[..., None], diff, a)

    def eq(self, a, b):
        return (self.canon(a) == self.canon(b)).all(dim=-1)

    def is_zero(self, a):
        return (self.canon(a) == 0).all(dim=-1)

    def is_negative(self, a):
        """Ristretto negativity: LSB of the canonical encoding."""
        return (self.canon(a)[..., 0] & 1).to(torch.bool)

    def select(self, cond, a, b):
        """cond ? a : b, broadcasting cond over the limb axis."""
        return torch.where(cond[..., None], a, b)

    def abs(self, a):
        return self.select(self.is_negative(a), self.neg(a), a)

    def cneg(self, cond, a):
        return self.select(cond, self.neg(a), a)

    # -- exponentiation chains ----------------------------------------------

    def _sqn(self, a, n: int):
        for _ in range(n):
            a = self.square(a)
        return a

    def _pow22501(self, x):
        """(x^(2^250 - 1), x^11): shared prefix of invert/pow_p58."""
        t0 = self.square(x)
        t1 = self.mul(x, self._sqn(t0, 2))
        t0 = self.mul(t0, t1)
        t2 = self.mul(t1, self.square(t0))
        t3 = self.mul(self._sqn(t2, 5), t2)
        t4 = self.mul(self._sqn(t3, 10), t3)
        t5 = self.mul(self._sqn(t4, 20), t4)
        t5 = self.mul(self._sqn(t5, 10), t3)
        t6 = self.mul(self._sqn(t5, 50), t5)
        t7 = self.mul(self._sqn(t6, 100), t6)
        t7 = self.mul(self._sqn(t7, 50), t5)
        return t7, t0

    def invert(self, x):
        """x^(p-2); 0 -> 0."""
        t7, t0 = self._pow22501(x)
        return self.mul(self._sqn(t7, 5), t0)

    def pow_p58(self, x):
        """x^((p-5)/8) = x^(2^252 - 3)."""
        t7, _ = self._pow22501(x)
        return self.mul(self._sqn(t7, 2), x)

    # -- sqrt ratio (RFC 9496 SQRT_RATIO_M1), batched -----------------------

    def sqrt_ratio_m1(self, u, v):
        """Returns (was_square bool mask, r)."""
        v3 = self.mul(self.square(v), v)
        v7 = self.mul(self.square(v3), v)
        r = self.mul(self.mul(u, v3), self.pow_p58(self.mul(u, v7)))
        check = self.mul(v, self.square(r))
        neg_u = self.neg(u)
        correct = self.eq(check, u)
        flipped = self.eq(check, neg_u)
        flipped_i = self.eq(check, self.mul(neg_u, self.SQRT_M1))
        r = self.select(flipped | flipped_i, self.mul(r, self.SQRT_M1), r)
        return correct | flipped, self.abs(r)

    def inv_sqrt(self, v):
        return self.sqrt_ratio_m1(self.ONE.expand_as(v), v)
