"""The Python block path of the port against the JAX package's: a 2-tx block
with ``XELIS_NATIVE_PREVERIFY=0``, so that neither package's native engine
takes it, verified by the JAX package on ``Accelerator("numpy")`` and by the
port on ``Accelerator(device="cpu")`` (the kernels' plain versions).  Both go
through ``_fused_deferred``: begin_block_async, chunk_lanes_begin per chunk,
fused_chunks_finish hashing the signature entries itself.  Both must accept
and leave the same balances."""

import copy

import pytest

from torch_carry import TAMPERS, balances, carry, outcome, transfer_block
from xelis_he_tpu import verify_batch as jax_verify_batch
from xelis_he_tpu.ops.accel import Accelerator as JaxAccelerator
from xelis_he_tpu_torch import NATIVE_ASSET, verify_batch
from xelis_he_tpu_torch.metrics import metrics
from xelis_he_tpu_torch.ops import kernels as K
from xelis_he_tpu_torch.ops.accel import Accelerator
from xelis_he_tpu_torch.pyref.ristretto import mul_base
from xelis_he_tpu_torch.types import CompressedPubkey


@pytest.fixture()
def python_path(monkeypatch):
    monkeypatch.setenv("XELIS_NATIVE_PREVERIFY", "0")
    # the JAX package sends small blocks to the host; keep this one on its accelerator
    monkeypatch.setenv("XELIS_HOST_VERIFY_MAX", "0")


def test_python_path_block_verifies_like_jax(python_path):
    txs, ledger, pk_r = transfer_block()
    port_txs, port_ledger = carry(txs, ledger)
    jax_state = ledger.clone()
    jax_verify_batch(txs, jax_state, accel=JaxAccelerator("numpy"))
    metrics.reset()
    K.reset_launches()
    state = port_ledger.clone()
    verify_batch(port_txs, state, accel=Accelerator(device="cpu", tile=8, qtile=8))
    snap = metrics.snapshot()
    assert "verify_batch.host_path_blocks" not in snap["counters"]
    assert snap["span_counts"]["fused_check.pull"] == 1
    assert snap["span_counts"]["verify_batch.pre_verify"] == 1  # one chunk through _fused_deferred
    assert "verify_batch.collect" not in snap["span_counts"]
    assert balances(state) == balances(jax_state)
    assert state.get_bal_decrypted(CompressedPubkey(pk_r.data), NATIVE_ASSET) == mul_base(21)
    assert K.launches == {k: 0 for k in K.launches}  # CPU tensors: plain versions only


@pytest.mark.parametrize("what", ["signature", "fee", "range_proof"])
def test_python_path_rejects_tampered_block_like_the_native_path(monkeypatch, what):
    """The port alone (tests/test_torch_reject_*.py hold the native path's
    rejections to the JAX package's): each tamper raises the same error on
    the Python path as on the native one."""
    txs, ledger, _ = transfer_block()
    bad = copy.deepcopy(txs)
    TAMPERS[what](bad)
    port_txs, port_ledger = carry(bad, ledger)
    port_accel = Accelerator(device="cpu", tile=8, qtile=8)
    native = outcome(lambda: verify_batch(port_txs, port_ledger.clone(), accel=port_accel))
    monkeypatch.setenv("XELIS_NATIVE_PREVERIFY", "0")
    python = outcome(lambda: verify_batch(port_txs, port_ledger.clone(), accel=port_accel))
    assert python == native and native is not None
