"""Point reductions and the bit-serial MSM engine.

The port's counterpart of ``xelis_he_tpu.ops.msm``: ``_tree_reduce`` (the
plain version of K3's tree), ``decompose_bits`` and the double-and-add half
of ``MsmEngine``.  On CUDA tensors ``msm_daa_lanes`` is K7 and ``msm_daa`` is
K7 followed by K3 (ops.kernels); on CPU tensors both run the kernels' plain
versions.  ``batch_dual_mul`` is plain tensor code, as it is in the JAX
package.  The Pippenger half (``msm``, ``_window_sum``, ``msm_points``,
``decompose_digits``) is not ported yet.

Scalar bits are public data only (verification scalars); secrets never take
this path.
"""

from __future__ import annotations

import numpy as _np
import torch

from .curve import Curve, point_to_rows, rows_to_point

N_BITS = 253  # ristretto scalars are below 2^253


def _scalar_bytes(scalars) -> _np.ndarray:
    """list[int] or (N, 32) uint8 array -> (N, 32) uint8 array."""
    if isinstance(scalars, _np.ndarray):
        return _np.ascontiguousarray(scalars, dtype=_np.uint8)
    raw = b"".join(s.to_bytes(32, "little") for s in scalars)
    return _np.frombuffer(raw, dtype=_np.uint8).reshape(len(scalars), 32)


def decompose_bits(scalars, n_bits: int = N_BITS) -> _np.ndarray:
    """(n_bits, N) uint32 bit rows, LSB first.  ``scalars``: list[int] or
    (N, 32)-byte canonical array."""
    bits = _np.unpackbits(_scalar_bytes(scalars), axis=1, bitorder="little")
    return _np.ascontiguousarray(bits[:, :n_bits].T).astype(_np.uint32)


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
    """Bit-serial MSM bound to a Curve.  Points are (X, Y, Z, T) tuples of
    (N, 18) limb tensors; ``bits`` are (n_bits, N) rows, LSB first, as a
    tensor on the curve's device or a numpy array (``decompose_bits``)."""

    def __init__(self, curve: Curve):
        self.curve = curve

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
