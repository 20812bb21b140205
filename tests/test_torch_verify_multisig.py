"""A native-path payload case through the port against the JAX package:
tests/test_accel_payloads.py's multisig spend (tests/torch_carry.py)."""

from torch_carry import balances, carry, multisig_spend
from xelis_he_tpu import verify_batch as jax_verify_batch
from xelis_he_tpu.ops.accel import Accelerator as JaxAccelerator
from xelis_he_tpu_torch import verify_batch
from xelis_he_tpu_torch.metrics import metrics
from xelis_he_tpu_torch.ops.accel import Accelerator
from xelis_he_tpu_torch.types import CompressedPubkey


def test_multisig_spend_verifies_like_jax():
    txs, ledger = multisig_spend()
    port_txs, port_ledger = carry(txs, ledger)
    assert port_ledger.multisig_accounts.keys() == {CompressedPubkey(pk.data) for pk in ledger.multisig_accounts}
    jax_state = ledger.clone()
    jax_verify_batch(txs, jax_state, accel=JaxAccelerator("numpy"))
    metrics.reset()
    state = port_ledger.clone()
    verify_batch(port_txs, state, accel=Accelerator(device="cpu", tile=8, qtile=8))
    assert "verify_batch.host_path_blocks" not in metrics.snapshot()["counters"]
    assert balances(state) == balances(jax_state)
