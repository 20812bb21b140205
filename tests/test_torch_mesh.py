"""The port's parallel layer on a CPU mesh (xelis_he_tpu_torch.parallel.mesh
and ``Accelerator(mesh=...)``), against pyref and the JAX package's numpy
engine, on identical inputs.  A CPU mesh lists the CPU more than once, as a
one-card machine lists its card: each shard runs the kernels' plain
versions, and the partial sums meet on the mesh's first entry."""

import numpy as np
import pytest
import torch

from torch_carry import balances, carry, plain_calls, transfer_block

from xelis_he_tpu.ops.curve import numpy_curve
from xelis_he_tpu.ops.msm import MsmEngine as JaxMsmEngine
from xelis_he_tpu.pyref.ristretto import IDENTITY, L, mul_base, multiscalar_mul
from xelis_he_tpu_torch import verify_batch
from xelis_he_tpu_torch.ops import msm as port_msm
from xelis_he_tpu_torch.ops.accel import Accelerator
from xelis_he_tpu_torch.parallel import AXIS, MultiDeviceMsm, ShardedMsm, make_mesh

torch.set_num_threads(1)
RNG = np.random.default_rng(2024)
NC = numpy_curve()
LANE_KERNELS = ("windowed_lanes_k8", "windowed_lanes_k8_fe15", "windowed_lanes")


def _rand_scalars(n):
    raw = RNG.integers(0, 256, size=(n, 40), dtype=np.uint8)
    return [int.from_bytes(r.tobytes(), "little") % L for r in raw]


def _lanes(n):
    pts = [mul_base(s) for s in _rand_scalars(n)]
    scal = _rand_scalars(n)
    scal[0], scal[1] = 0, L - 1
    pts[2] = IDENTITY
    return scal, pts


def test_make_mesh_on_cpu_entries_and_too_few_devices():
    mesh = make_mesh(2, backend="cpu")
    assert mesh.size == 2 and mesh.axis_names == (AXIS,) == ("shards",)
    assert mesh.devices == (torch.device("cpu"), torch.device("cpu"))
    assert make_mesh(devices=["cpu", "cpu", "cpu"]).size == 3
    if torch.cuda.device_count() < 3:
        with pytest.raises(ValueError):
            make_mesh(3)
    with pytest.raises(ValueError):
        make_mesh(3, devices=["cpu", "cpu"])


@pytest.fixture
def shard_partials(monkeypatch):
    """Records each shard's msm_daa: (points, bits, partial)."""
    seen = []
    daa = port_msm.MsmEngine.msm_daa

    def spy(self, points, bits):
        out = daa(self, points, bits)
        seen.append((points, bits, out))
        return out

    monkeypatch.setattr(port_msm.MsmEngine, "msm_daa", spy)
    return seen


def _enc_port(point_tuple):
    rows = torch.stack([c.to(torch.int64) for c in point_tuple])[None]
    from xelis_he_tpu_torch.ops.kernels import compress

    return bytes(compress(rows.to(torch.int32).contiguous()).numpy()[0])


@pytest.mark.parametrize("n", [16, 13, 15])
@pytest.mark.parametrize("kind", ["sharded", "multi_device"])
def test_mesh_msm_matches_pyref_and_numpy_engine_per_shard(n, kind, shard_partials):
    scal, pts = _lanes(n)
    mesh = make_mesh(2, backend="cpu")
    engine = ShardedMsm(mesh) if kind == "sharded" else MultiDeviceMsm(mesh.devices)
    got = engine.msm_points(scal, pts)
    assert got.compress() == multiscalar_mul(scal, pts).compress()
    # two shards of ceil(n / 2) lanes (the last padded with identities and
    # zero scalars); at 15 lanes each is held to the JAX package's engine on
    # the same shard (a numpy double-and-add costs seconds a shard here)
    assert [p[0][0].shape[0] for p in shard_partials] == [-(-n // 2)] * 2
    for points, bits, partial in shard_partials if n == 15 else ():
        np_points = tuple(c.numpy().astype(np.uint32) for c in points)
        want = JaxMsmEngine(NC, use_jax=False).msm_daa(np_points, bits.numpy().astype(np.uint32))
        assert _enc_port(partial) == NC.to_points(tuple(c[None] for c in want))[0].compress()


def _verify(accel, txs, ledger):
    with plain_calls() as calls:
        verify_batch(txs, ledger, accel=accel)
    return sum(calls[k] for k in LANE_KERNELS), calls


@pytest.mark.parametrize("quad_lanes", [True, False])
def test_sharded_accelerator_verifies_a_block_as_the_unsharded_one(quad_lanes):
    """A 2-tx block on two CPU shards: the unsharded accelerator's balances,
    and two lane calls (one a shard) for every lane launch."""
    txs, ledger, _ = transfer_block()
    port_txs, port_ledger = carry(txs, ledger)
    state = port_ledger.clone()
    plain, plain_seen = _verify(Accelerator(device="cpu", tile=8, qtile=8, quad_lanes=quad_lanes), port_txs, state)
    sharded_state = port_ledger.clone()
    mesh = make_mesh(2, backend="cpu")
    sharded, seen = _verify(Accelerator(tile=8, qtile=8, quad_lanes=quad_lanes, mesh=mesh), port_txs, sharded_state)
    assert balances(sharded_state) == balances(state)
    assert plain > 0 and sharded == 2 * plain
    lane = "windowed_lanes_k8" if quad_lanes else "windowed_lanes"
    assert seen[lane] == 2 * plain_seen[lane] > 0


def test_accelerator_takes_the_mesh_device_and_grows_its_granules():
    mesh = make_mesh(2, backend="cpu")
    accel = Accelerator(tile=8, qtile=8, mesh=mesh)
    assert accel.device == torch.device("cpu") and accel.mesh is mesh
    assert accel._lane_granules() == (2 * 8 * 8, 2 * 8)
    assert Accelerator(tile=8, qtile=8, quad_lanes=False, mesh=mesh)._lane_granules() == (16, 8)
    assert Accelerator(device="cpu", tile=8, qtile=8).mesh is None
    with pytest.raises(ValueError):
        Accelerator(device="cuda", mesh=mesh)
