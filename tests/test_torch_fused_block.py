"""The fused block check without the fold library: with each package's
``hashcore.verifyfold_native`` made to fail its import and
``XELIS_NATIVE_PREVERIFY=0``, ``verify_batch`` takes the branch that runs
pre_verify and the range-proof fold in Python and the device in two phases
(``fused_block_begin`` / ``fused_block_finish``) behind one pull.  The JAX
package on ``Accelerator("numpy")`` and the port on
``Accelerator(device="cpu")`` (the kernels' plain versions) verify the same
2-tx block (tests/torch_carry.py) and must leave the same balances; the
tampered blocks must raise what the port's native path raises, and
``fused_block_check`` must give begin/finish's flags."""

import copy
import sys

import pytest

from torch_carry import TAMPERS, balances, carry, outcome, plain_calls, transfer_block
from xelis_he_tpu import verify_batch as jax_verify_batch
from xelis_he_tpu.metrics import metrics as jax_metrics
from xelis_he_tpu.ops.accel import Accelerator as JaxAccelerator
from xelis_he_tpu_torch import NATIVE_ASSET, verify_batch
from xelis_he_tpu_torch.metrics import metrics
from xelis_he_tpu_torch.ops.accel import Accelerator
from xelis_he_tpu_torch.pyref.ristretto import mul_base
from xelis_he_tpu_torch.types import CompressedPubkey

FOLD_LIBRARIES = ("xelis_he_tpu.hashcore.verifyfold_native", "xelis_he_tpu_torch.hashcore.verifyfold_native")


@pytest.fixture()
def no_fold_library(monkeypatch):
    """Both packages' fold library fails its import (a None entry in
    sys.modules), and neither native engine takes the block."""
    for name in FOLD_LIBRARIES:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setenv("XELIS_NATIVE_PREVERIFY", "0")
    # the JAX package sends small blocks to the host; keep this one on its accelerator
    monkeypatch.setenv("XELIS_HOST_VERIFY_MAX", "0")


def _accel():
    return Accelerator(device="cpu", tile=8, qtile=8)


def test_fused_block_verifies_like_jax(no_fold_library):
    txs, ledger, pk_r = transfer_block()
    port_txs, port_ledger = carry(txs, ledger)
    jax_state = ledger.clone()
    jax_metrics.reset()
    jax_verify_batch(txs, jax_state, accel=JaxAccelerator("numpy"))
    assert jax_metrics.snapshot()["span_counts"]["verify_batch.range_fold"] == 1  # its fused block check ran
    metrics.reset()
    state = port_ledger.clone()
    with plain_calls() as calls:
        verify_batch(port_txs, state, accel=_accel())
    snap = metrics.snapshot()
    assert "verify_batch.host_path_blocks" not in snap["counters"]
    assert snap["span_counts"]["fused_check.pull"] == 1
    for name in ("verify_batch.sigma_dispatch", "verify_batch.range_fold", "fused_check.prep_a",
                 "fused_check.prep_b", "verify_batch.device_checks"):
        assert snap["span_counts"][name] == 1, name
    assert snap["counters"]["verify_batch.range_msm_points"] > 0
    assert {k for k, n in calls.items() if n} == {"decompress", "windowed_lanes", "tile_sums", "compress"}
    assert calls["windowed_lanes"] == 2 and calls["compress"] == 1  # one K5 launch a phase, one K4
    assert balances(state) == balances(jax_state)
    assert state.get_bal_decrypted(CompressedPubkey(pk_r.data), NATIVE_ASSET) == mul_base(21)


@pytest.mark.parametrize("what", sorted(TAMPERS))
def test_fused_block_rejects_tampered_block_like_the_native_path(monkeypatch, what):
    txs, ledger, _ = transfer_block()
    bad = copy.deepcopy(txs)
    TAMPERS[what](bad)
    port_txs, port_ledger = carry(bad, ledger)
    accel = _accel()
    native = outcome(lambda: verify_batch(port_txs, port_ledger.clone(), accel=accel))
    monkeypatch.setitem(sys.modules, FOLD_LIBRARIES[1], None)
    monkeypatch.setenv("XELIS_NATIVE_PREVERIFY", "0")
    metrics.reset()
    fused = outcome(lambda: verify_batch(port_txs, port_ledger.clone(), accel=accel))
    assert fused == native and native is not None
    assert metrics.snapshot()["span_counts"].get("verify_batch.pre_verify") == 1  # the fused branch ran


@pytest.mark.parametrize("what", [None, "signature"])
def test_fused_block_check_gives_begin_finish_flags(no_fold_library, monkeypatch, what):
    """Inside the block's context, ``fused_block_check`` on the inputs that
    begin and finish were given computes the same three flags in one
    dispatch: (True, True, True) for the accepted block, the signature flag
    down for a tampered one."""
    txs, ledger, _ = transfer_block()
    if what is not None:
        txs = copy.deepcopy(txs)
        TAMPERS[what](txs)
    port_txs, port_ledger = carry(txs, ledger)
    accel = _accel()
    seen = {}
    begin, finish = accel.fused_block_begin, accel.fused_block_finish

    def spy_begin(sigma, sig_entries):
        seen["sigma"], seen["sig_entries"] = sigma, sig_entries
        return begin(sigma, sig_entries)

    def spy_finish(state, range_):
        seen["phases"] = finish(state, range_)
        seen["check"] = accel.fused_block_check(seen["sigma"], range_, seen["sig_entries"])
        return seen["phases"]

    monkeypatch.setattr(accel, "fused_block_begin", spy_begin)
    monkeypatch.setattr(accel, "fused_block_finish", spy_finish)
    outcome(lambda: verify_batch(port_txs, port_ledger.clone(), accel=accel))
    assert seen["check"] == seen["phases"] == ((True, True, True) if what is None else (True, True, False))
