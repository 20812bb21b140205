"""The lane-kernel switches of the port's Accelerator on a 2-tx block: quad
lanes off (every lane through the single-lane kernel K5) and the tier switch
off (the packed lanes on the 15-bit tier, K6), by constructor argument and by
the JAX package's environment variables.  Each run must accept the block and
leave the default run's balances; ``torch_carry.plain_calls`` (the CPU
route's call count) shows the branch it took."""

import pytest

from torch_carry import balances, carry, plain_calls, transfer_block
from xelis_he_tpu_torch import NATIVE_ASSET, verify_batch
from xelis_he_tpu_torch.metrics import metrics
from xelis_he_tpu_torch.ops import kernels as K
from xelis_he_tpu_torch.ops.accel import Accelerator
from xelis_he_tpu_torch.pyref.ristretto import mul_base
from xelis_he_tpu_torch.types import CompressedPubkey

LANE_KERNELS = ("windowed_lanes_k8", "windowed_lanes", "windowed_lanes_k8_fe15")


@pytest.fixture(scope="module")
def block():
    txs, ledger, pk_r = transfer_block()
    return (*carry(txs, ledger), pk_r)


def _verify(block, **kwargs):
    port_txs, port_ledger, _ = block
    metrics.reset()
    state = port_ledger.clone()
    with plain_calls() as calls:
        verify_batch(port_txs, state, accel=Accelerator(device="cpu", tile=8, qtile=8, **kwargs))
    snap = metrics.snapshot()
    assert "verify_batch.host_path_blocks" not in snap["counters"]
    assert snap["span_counts"]["fused_check.pull"] == 1
    return balances(state), {k: calls[k] for k in LANE_KERNELS}, state


@pytest.fixture(scope="module")
def default_run(block):
    return _verify(block)


def test_default_block_takes_the_packed_lanes(block, default_run):
    bal, calls, state = default_run
    assert calls == {"windowed_lanes_k8": 2, "windowed_lanes": 0, "windowed_lanes_k8_fe15": 0}
    assert state.get_bal_decrypted(CompressedPubkey(block[2].data), NATIVE_ASSET) == mul_base(21)


def test_quad_lanes_off_takes_the_single_lane_kernel(block, default_run):
    bal, calls, _ = _verify(block, quad_lanes=False)
    assert calls == {"windowed_lanes_k8": 0, "windowed_lanes": 2, "windowed_lanes_k8_fe15": 0}
    assert bal == default_run[0]


def test_tier_switch_off_takes_the_15_bit_tier(block, default_run):
    bal, calls, _ = _verify(block, fe15=True)
    assert calls == {"windowed_lanes_k8": 0, "windowed_lanes": 0, "windowed_lanes_k8_fe15": 2}
    assert bal == default_run[0]


def test_switches_default_to_the_environment(monkeypatch):
    acc = Accelerator(device="cpu")
    assert (acc.use_quad, acc.use_fe15) == (True, False)
    assert acc._lane_granules() == (K.K_PACK * K.TILE, K.QTILE)
    monkeypatch.setenv("XELIS_QUAD_LANES", "0")
    monkeypatch.setenv("XELIS_FE13", "0")
    assert (acc.use_quad, acc.use_fe15) == (False, True)
    assert acc._lane_granules() == (K.TILE, K.TILE // 2)
    pinned = Accelerator(device="cpu", quad_lanes=True, fe15=False)
    assert (pinned.use_quad, pinned.use_fe15) == (True, False)


def test_environment_switch_runs_the_block_through_k5(block, default_run, monkeypatch):
    monkeypatch.setenv("XELIS_QUAD_LANES", "0")
    monkeypatch.setenv("XELIS_NATIVE_PREVERIFY", "0")  # the Python block path, single-lane
    bal, calls, _ = _verify(block)
    assert calls == {"windowed_lanes_k8": 0, "windowed_lanes": 2, "windowed_lanes_k8_fe15": 0}
    assert bal == default_run[0]
