"""Block verification through the port against the JAX package: a 2-tx
transfer block, carried across and verified by both (tests/torch_carry.py).
Both must accept and leave the same balances."""

import pytest
import torch

from torch_carry import balances, carry, transfer_block
from xelis_he_tpu import verify_batch as jax_verify_batch
from xelis_he_tpu.ops.accel import Accelerator as JaxAccelerator
from xelis_he_tpu.tx.wire import encode_transaction
from xelis_he_tpu_torch import NATIVE_ASSET, verify_batch
from xelis_he_tpu_torch.metrics import metrics
from xelis_he_tpu_torch.ops import kernels as K
from xelis_he_tpu_torch.ops.accel import Accelerator
from xelis_he_tpu_torch.pyref.ristretto import mul_base
from xelis_he_tpu_torch.tx.wire import encode_transaction as port_encode_transaction
from xelis_he_tpu_torch.types import CompressedPubkey


@pytest.fixture(scope="module")
def block():
    return transfer_block()


@pytest.fixture(scope="module")
def accel():
    return Accelerator(device="cpu", tile=8, qtile=8)


def test_carry_round_trips_block_and_ledger(block):
    txs, ledger, _ = block
    port_txs, port_ledger = carry(txs, ledger)
    assert [encode_transaction(tx) for tx in txs] == [port_encode_transaction(tx) for tx in port_txs]
    assert balances(port_ledger) == balances(ledger)


def test_block_verifies_like_jax(block, accel):
    txs, ledger, pk_r = block
    port_txs, port_ledger = carry(txs, ledger)
    jax_state = ledger.clone()
    jax_verify_batch(txs, jax_state, accel=JaxAccelerator("numpy"))
    metrics.reset()
    state = port_ledger.clone()
    verify_batch(port_txs, state, accel=accel)
    snap = metrics.snapshot()
    assert "verify_batch.host_path_blocks" not in snap["counters"]
    assert snap["span_counts"]["fused_check.pull"] == 1  # the device path ran
    assert balances(state) == balances(jax_state)
    assert state.get_bal_decrypted(CompressedPubkey(pk_r.data), NATIVE_ASSET) == mul_base(21)
    assert K.launches == {k: 0 for k in K.launches}  # CPU tensors: plain versions only


def test_declined_block_verifies_on_host(block, accel, monkeypatch, caplog):
    """A block the native engine does not take is verified on the host (the
    port has no Python fused path yet), counted and logged."""
    txs, ledger, pk_r = block
    port_txs, port_ledger = carry(txs, ledger)
    monkeypatch.setenv("XELIS_NATIVE_PREVERIFY", "0")
    metrics.reset()
    state = port_ledger.clone()
    verify_batch(port_txs, state, accel=accel)
    assert metrics.snapshot()["counters"]["verify_batch.host_path_blocks"] == 1
    assert "verifying on the host" in caplog.text
    assert state.get_bal_decrypted(CompressedPubkey(pk_r.data), NATIVE_ASSET) == mul_base(21)


def test_accelerator_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Accelerator()
    with pytest.raises(RuntimeError, match="CUDA"):
        Accelerator(device="cuda")
    acc = Accelerator(device="cpu")
    assert (acc.backend, acc.mesh, acc.device.type) == ("torch", None, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        acc.msm([1], [mul_base(1)])


def test_rows_cross_as_int32_with_the_same_bits():
    from xelis_he_tpu.ops.fe import numpy_field
    from xelis_he_tpu_torch.carry import rows_to_device, rows_to_numpy

    rows = numpy_field().from_ints(list(range(1, 4 * 18 * 3 + 1))).reshape(-1, 4, 18)
    t = rows_to_device(rows, "cpu")
    assert t.dtype == torch.int32 and t.shape == rows.shape
    rows[0, 0, 0] += 1  # the device copy does not alias the host rows
    assert int(t[0, 0, 0]) == int(rows[0, 0, 0]) - 1
    rows[0, 0, 0] -= 1
    back = rows_to_numpy(t)
    assert back.dtype == rows.dtype and (back == rows).all()
