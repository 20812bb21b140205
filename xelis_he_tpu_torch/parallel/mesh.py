"""MSM lane sharding over a 1-D mesh of torch devices.

The verification workload is one large MSM; its lanes are cut into
contiguous shards, one per mesh entry, each shard's partial MSM runs on its
device, and the D partial sums are copied to the mesh's first device (the
counterpart of the JAX package's ``lax.all_gather``) and added there by K3's
tree.  Partials are a few hundred bytes: one copy per shard per MSM.

A mesh lists torch devices in order.  It may name one card more than once:
two shards on one card run as two launches on it, which is how a machine
with one card runs a two-shard mesh.  ``backend="cpu"`` gives CPU entries,
on which the kernels' plain versions run (the counterpart of the JAX
package's emulated CPU mesh).
"""

from __future__ import annotations

import numpy as _np
import torch

from ..carry import to_device
from ..ops import kernels as K
from ..ops.curve import Curve, point_to_rows, rows_to_point
from ..ops.fe import Field
from ..ops.msm import MsmEngine, decompose_bits

AXIS = "shards"


class Mesh:
    """An ordered 1-D mesh of torch devices with the axis ``AXIS``."""

    axis_names = (AXIS,)

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None, devices=None, backend: str | None = None) -> Mesh:
    """1-D mesh over ``n_devices`` (all of them when None) of ``devices``,
    by default every CUDA device, or ``n_devices`` CPU entries with
    ``backend="cpu"``.  Raises ``ValueError`` when there are too few
    devices: no silent switch to the CPU."""
    if devices is None:
        if backend == "cpu":
            devices = [torch.device("cpu")] * (n_devices or 1)
        elif backend in (None, "cuda", "gpu"):
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            devices = [torch.device("cuda", i) for i in range(count)]
        else:
            raise ValueError(f"unknown backend {backend!r}: want 'cuda' or 'cpu'")
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices)


def _padded(scalars, points, multiple: int):
    """Scalars and points padded with zero scalars and identity points to a
    multiple of ``multiple`` lanes."""
    from ..pyref.ristretto import IDENTITY

    pad = (-len(scalars)) % multiple
    return list(scalars) + [0] * pad, list(points) + [IDENTITY] * pad


def _engines(devices) -> dict:
    return {d: MsmEngine(Curve(Field(d))) for d in set(devices)}


def _shard_partials(engines, devices, points, bits):
    """``msm_daa`` (K7, then K3) of each contiguous shard of the lanes on its
    device: every shard uploaded, then every shard launched, before any
    result is read.  One (18,)-limb point tuple a shard, on its device.
    ``points``: host (N, 18) limb tensors; ``bits``: (n_bits, N) numpy rows."""
    chunk = -(-bits.shape[1] // len(devices))
    shards = []
    for i, dev in enumerate(devices):
        sl = slice(i * chunk, (i + 1) * chunk)
        shards.append((tuple(to_device(c[sl].numpy(), dev) for c in points),
                       to_device(bits[:, sl].astype(_np.int64), dev)))
    return [engines[dev].msm_daa(*shard) for dev, shard in zip(devices, shards)]


class ShardedMsm:
    """MSM sharded over the lanes of a 1-D mesh: each device runs
    ``MsmEngine.msm_daa`` (K7, then K3) on its shard; the partial sums are
    copied to the mesh's first device and added there (K3 on a card, its
    plain tree on the CPU)."""

    def __init__(self, mesh: Mesh, curve: Curve | None = None):
        self.mesh = mesh
        self.n_devices = mesh.size
        self.curve = curve or Curve(Field(mesh.devices[0]))
        self.engines = _engines(mesh.devices)

    def msm_device(self, points, bits):
        """points: tuple of (N, 18) host limb tensors; bits: (n_bits, N)
        numpy rows; N a multiple of the mesh size (pad with identity lanes
        and zero scalars).  Returns the sum as a point tuple of (18,) tensors
        on the mesh's first device."""
        if bits.shape[1] % self.n_devices:
            raise ValueError(f"{bits.shape[1]} lanes do not split into {self.n_devices} equal shards")
        parts = _shard_partials(self.engines, self.mesh.devices, points, bits)
        first = self.mesh.devices[0]
        gathered = torch.stack([point_to_rows(p).to(torch.int32).to(first) for p in parts])
        total = K.sum_points(gathered[None].contiguous())
        return tuple(c[0] for c in rows_to_point(total))

    def msm_points(self, scalars, points):
        """Host API mirroring MsmEngine.msm_points."""
        from ..pyref.ristretto import IDENTITY

        if not scalars:
            return IDENTITY
        scalars, points = _padded(scalars, points, self.n_devices)
        batch = Curve(Field("cpu")).from_points(points)
        res = self.msm_device(batch, decompose_bits(scalars))
        return self.curve.to_points(tuple(c[None] for c in res))[0]


class MultiDeviceMsm:
    """Data-parallel MSM by explicit dispatch per device: each device runs
    the same ``msm_daa`` (K7, then K3) on its chunk of ceil(n / d) lanes,
    every launch enqueued before any result is read, and the d partial sums
    are added on the host as points.  ``ShardedMsm`` is the same computation
    with the partials added on the mesh's first device."""

    def __init__(self, devices=None, curve: Curve | None = None):
        self.devices = list(make_mesh(devices=devices).devices)  # every CUDA device when None
        self.curve = curve or Curve(Field(self.devices[0]))
        self.engines = _engines(self.devices)

    def msm_points(self, scalars, points):
        from ..pyref.ristretto import IDENTITY

        if not scalars:
            return IDENTITY
        scalars, points = _padded(scalars, points, len(self.devices))
        batch = Curve(Field("cpu")).from_points(points)
        parts = _shard_partials(self.engines, self.devices, batch, decompose_bits(scalars))
        total = IDENTITY
        for dev, part in zip(self.devices, parts):
            total = total + self.engines[dev].curve.to_points(tuple(c[None] for c in part))[0]
        return total
