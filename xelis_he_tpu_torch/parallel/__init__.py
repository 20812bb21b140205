"""Parallelism layers: lane sharding over a 1-D device mesh, and block
verification across processes.

- :mod:`.mesh` — MSM lane sharding over a list of torch devices: each shard
  runs on its own device and the partial sums are copied to the first one;
  the Accelerator shards its lane kernels the same way when constructed
  with ``mesh=``.
- :mod:`.dcn` — multi-process shard-nothing batch verification with one
  integer all-reduce over torch.distributed deciding the block.
"""

from .mesh import AXIS, MultiDeviceMsm, ShardedMsm, make_mesh  # noqa: F401

__all__ = ["AXIS", "MultiDeviceMsm", "ShardedMsm", "make_mesh"]
