"""Point reductions and the two MSM engines.

The port's counterpart of ``xelis_he_tpu.ops.msm``: ``_tree_reduce`` (the
plain version of K3's tree), the scalar decompositions and ``MsmEngine``,
bound to a torch ``Curve``:

- Pippenger (``msm``, ``msm_points``, ``_window_sum``): the scalars'
  unsigned c-bit window digits (``decompose_digits``, on the host); per
  window a stable sort of the lanes by digit and the digit counts (torch
  glue); the bucket sums (K9) and the windows' weighted sums with Horner's
  c doublings between them (K10).  On CPU tensors the kernels' plain
  versions run: K9's is the JAX package's segmented Hillis-Steele scan
  (``_combine_seg``, ``_inclusive_scan``) on the torch Curve.  Each phase
  of ``msm_points`` is a ``metrics`` span: ``msm.digits``, ``msm.points``
  (the points' limbs), ``msm.bucket_runs``, ``msm.k9``, ``msm.k10`` and
  ``msm.pull``.  They do not synchronise: the kernels' spans hold the host's
  plan and launches, and ``msm.pull`` the wait for the card.
- double-and-add (``msm_daa_lanes``, ``msm_daa``): K7, then K3's tree.
  ``batch_dual_mul`` is plain tensor code, as it is in the JAX package.

Scalar digits and bits are public data only (verification scalars); secrets
never take this path.
"""

from __future__ import annotations

import numpy as _np
import torch

from ..metrics import span
from ..pyref.ristretto import RistrettoPoint
from .curve import Curve, point_to_rows, rows_to_point

DEFAULT_WINDOW = 13
SCALAR_BITS = 256
N_BITS = 253  # ristretto scalars are below 2^253


def _scalar_bytes(scalars) -> _np.ndarray:
    """list[int] or (N, 32) uint8 array -> (N, 32) uint8 array."""
    if isinstance(scalars, _np.ndarray):
        return _np.ascontiguousarray(scalars, dtype=_np.uint8)
    raw = b"".join(s.to_bytes(32, "little") for s in scalars)
    return _np.frombuffer(raw, dtype=_np.uint8).reshape(len(scalars), 32)


def decompose_bits(scalars, n_bits: int = 253) -> _np.ndarray:
    """(n_bits, N) uint32 bit rows, LSB first (vectorized via unpackbits).
    ``scalars``: list[int] or (N, 32)-byte canonical array."""
    bits = _np.unpackbits(_scalar_bytes(scalars), axis=1, bitorder="little")
    return _np.ascontiguousarray(bits[:, :n_bits].T).astype(_np.uint32)


def decompose_digits(scalars: list[int], c: int = DEFAULT_WINDOW) -> _np.ndarray:
    """(W, N) int32 unsigned c-bit digits, least-significant window first."""
    n_windows = (SCALAR_BITS + c - 1) // c
    bits = _np.unpackbits(_scalar_bytes(scalars), axis=1, bitorder="little")
    pad = n_windows * c - SCALAR_BITS
    if pad:
        bits = _np.concatenate(
            [bits, _np.zeros((bits.shape[0], pad), dtype=bits.dtype)], axis=1
        )
    weights = (1 << _np.arange(c, dtype=_np.int64)).astype(_np.int64)
    digits = bits.reshape(len(scalars), n_windows, c).astype(_np.int64) @ weights
    return _np.ascontiguousarray(digits.T).astype(_np.int32)


def _combine_seg(curve: Curve, a, b):
    """Segmented-scan combine of (flag, point) pairs, the flag marking a
    segment head: b's point where b holds a head, else a's plus b's."""
    f1, p1 = a
    f2, p2 = b
    return (f1 | f2, curve.select(f2, p2, curve.add(p1, p2)))


def _inclusive_scan(curve: Curve, flags: torch.Tensor, pts):
    """Hillis-Steele segmented inclusive scan over the leading axis: at
    shift s, element j >= s becomes element j - s combined with element j.
    K9's plain version; the kernel makes the same additions for each
    segment's last element, block by aligned block (csrc/ed25519.cuh
    bucket_block)."""
    n = int(flags.shape[0])
    shift = 1
    while shift < n:
        tail = _combine_seg(
            curve,
            (flags[:-shift], tuple(c[:-shift] for c in pts)),
            (flags[shift:], tuple(c[shift:] for c in pts)),
        )
        flags = torch.cat([flags[:shift], tail[0]])
        pts = tuple(torch.cat([c[:shift], t], dim=0) for c, t in zip(pts, tail[1]))
        shift *= 2
    return flags, pts


def _tree_reduce(curve: Curve, pts, n: int):
    """Pairwise-add reduction of the leading axis of ``pts`` (X, Y, Z, T):
    identity-padded to a power of two, then lane i + half is added onto
    lane i until one lane is left."""
    size = 1
    while size < n:
        size *= 2
    if size != n:
        pad = curve.identity((size - n, *pts[0].shape[1:-1]))
        pts = tuple(torch.cat([c, p], dim=0) for c, p in zip(pts, pad))
    while size > 1:
        half = size // 2
        pts = curve.add(tuple(c[:half] for c in pts), tuple(c[half:size] for c in pts))
        size = half
    return tuple(c[0] for c in pts)


def bucket_runs(digits, c: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """K9's inputs from (W, N) c-bit digits (numpy or tensor): each window's
    lane indices sorted by digit (a stable sort) and the digits' counts as
    run offsets, so bucket b of window w is order[w][offsets[w][b] :
    offsets[w][b + 1]].  Returns ((W, N) int32, (W, 2^c + 1) int32) on
    ``device``."""
    d = torch.as_tensor(digits).to(device=device, dtype=torch.int64)
    counts = torch.zeros((d.shape[0], 1 << c), dtype=torch.int64, device=device)
    counts.scatter_add_(1, d, torch.ones_like(d))
    offsets = torch.zeros((d.shape[0], (1 << c) + 1), dtype=torch.int64, device=device)
    offsets[:, 1:] = torch.cumsum(counts, dim=1)
    order = torch.sort(d, dim=1, stable=True).indices
    return order.to(torch.int32).contiguous(), offsets.to(torch.int32).contiguous()


def _bit_words(bits: torch.Tensor) -> torch.Tensor:
    """(n_bits <= 253, N) bit rows, LSB first -> K7's (8, N) int32 words."""
    n_bits, n = bits.shape
    if n_bits > N_BITS:
        raise ValueError(f"{n_bits} bit rows: the double-and-add lanes walk {N_BITS}")
    padded = torch.zeros((256, n), dtype=torch.int64, device=bits.device)
    padded[:n_bits] = bits
    shifts = torch.arange(32, device=bits.device)[None, :, None]
    words = (padded.reshape(8, 32, n) << shifts).sum(dim=1)  # < 2^32
    return words.to(torch.int32)  # keeps the low 32 bits: bit 31 becomes the sign


class MsmEngine:
    """Pippenger and bit-serial MSMs bound to a Curve.  Points are (X, Y, Z,
    T) tuples of (N, 18) limb tensors; ``digits`` are (W, N) c-bit window
    digits (``decompose_digits``) and ``bits`` (n_bits, N) rows, LSB first
    (``decompose_bits``), each as a tensor on the curve's device or a numpy
    array."""

    def __init__(self, curve: Curve, window: int = DEFAULT_WINDOW):
        self.curve = curve
        self.window = window

    # -- Pippenger: K9 (bucket sums) and K10 (window sums, Horner) ------------

    def _buckets(self, points, digits) -> torch.Tensor:
        """K9 over every window: the (W, 2^c - 1, 4, 18) bucket sums."""
        from . import kernels as K

        with span("msm.bucket_runs"):
            order, offsets = bucket_runs(digits, self.window, self.curve.fe.device)
        with span("msm.k9"):
            return K.bucket_sums(point_to_rows(points).to(torch.int32).contiguous(), order, offsets)

    def _window_sum(self, points, d):
        """sum_b b S_b of one window's digits ``d`` (N,) over ``points``: the
        MSM of that window alone (Horner over one window is its sum).
        Returns a single point."""
        return self.msm(points, torch.as_tensor(d)[None])

    def msm(self, points, digits):
        """points: batched point tuple (N lanes); digits: (W, N) int32.
        Returns a single (unbatched) point tuple: K9 over every window, then
        K10 (each window's sum_b b S_b and Horner from the top window)."""
        from . import kernels as K

        buckets = self._buckets(points, digits)
        with span("msm.k10"):
            total = K.window_sums(buckets)
        return tuple(c[0] for c in rows_to_point(total))

    def msm_points(self, scalars: list[int], points: list[RistrettoPoint]) -> RistrettoPoint:
        if not scalars:
            from ..pyref.ristretto import IDENTITY

            return IDENTITY
        with span("msm.digits"):
            digits = decompose_digits(scalars, self.window)
        with span("msm.points"):
            batch = self.curve.from_points(points)
        result = self.msm(batch, digits)
        with span("msm.pull"):
            return self.curve.to_points(tuple(c[None] for c in result))[0]

    # -- bit-serial double-and-add: K7 and K3 --------------------------------

    def _bits(self, bits) -> torch.Tensor:
        if isinstance(bits, _np.ndarray):
            bits = torch.from_numpy(bits.astype(_np.int64))
        return bits.to(self.curve.fe.device)

    def _daa_rows(self, points, bits) -> torch.Tensor:
        """K7 over the batch: canonical (N, 4, 18) int32 rows s_i * P_i."""
        from . import kernels as K

        rows = point_to_rows(points).to(torch.int32).contiguous()
        return K.daa_lanes(rows, _bit_words(self._bits(bits)))

    def msm_daa_lanes(self, points, bits):
        """Per-lane double-and-add without the final reduction: the batch
        acc_i = s_i * P_i."""
        return rows_to_point(self._daa_rows(points, bits))

    def msm_daa(self, points, bits):
        """MSM by per-lane double-and-add (K7) and one reduction through K3;
        returns a single (unbatched) point."""
        from . import kernels as K

        total = K.sum_points(self._daa_rows(points, bits)[None])
        return tuple(c[0] for c in rows_to_point(total))

    def batch_dual_mul(self, P_batch, bits_a, bits_b, q_table):
        """Per-lane r_i = a_i*Q + b_i*P_i with a shared base Q whose doubles
        2^k Q are precomputed (``q_table``: a point tuple of (n_bits, 18)
        tensors): each step costs two selected additions and one doubling.
        Returns an (N,)-batch of points."""
        curve = self.curve
        bits_a, bits_b = self._bits(bits_a), self._bits(bits_b)
        acc, base = curve.identity((bits_a.shape[1],)), P_batch
        for k in range(bits_a.shape[0]):
            q_row = tuple(c[k] for c in q_table)
            acc = curve.select(bits_a[k].bool(), curve.add(acc, q_row), acc)
            acc = curve.select(bits_b[k].bool(), curve.add(acc, base), acc)
            base = curve.double(base)
        return acc
