"""Point reductions of the plain path.

The port's counterpart of ``xelis_he_tpu.ops.msm._tree_reduce`` (numpy
branch): on the card every point reduction runs through K3 (ops.kernels),
whose plain version is this tree.
"""

from __future__ import annotations

import torch

from .curve import Curve


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
