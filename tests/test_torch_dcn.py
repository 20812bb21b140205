"""Two processes of the port verify one block over torch.distributed (gloo on
the CPU), shaped like tests/test_dcn.py: each verifies its round-robin share
against its own ledger replica on the kernels' plain versions, and one
integer all-reduce decides the block, so both must print the same verdict.
The block is built with the JAX package and carried across as wire bytes
and a ledger snapshot."""

import json
import os
import pickle
import socket
import subprocess
import sys

import pytest

from torch_carry import snapshot
from xelis_he_tpu import NATIVE_ASSET, TransactionBuilder, TransferBuilder, TransfersBuilder
from xelis_he_tpu.mock import Account, GenerationBalance, Ledger
from xelis_he_tpu.tx.wire import encode_transaction

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _build_block(n_txs: int):
    ledger = Ledger()
    pk_r = ledger.add_account(Account([(NATIVE_ASSET, 0)]))
    txs = []
    for i in range(n_txs):
        sender = Account([(NATIVE_ASSET, 100)])
        pk_s = ledger.add_account(sender)
        builder = TransactionBuilder(
            version=1, source=pk_s, fee=1, nonce=0,
            data=TransfersBuilder([TransferBuilder(asset=NATIVE_ASSET, amount=10 + i, dest_pubkey=pk_r)]),
        )
        txs.append(builder.build(GenerationBalance({NATIVE_ASSET: 100}, sender), sender.keypair))
    return txs, ledger


def _run_workers(block_path: str) -> list[tuple[str, dict | None]]:
    """(verdict, the error that rejected the worker's own share) of each rank."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "xelis_he_tpu_torch.parallel._dcn_worker", block_path, coord, "2", str(i),
             "--device", "cpu", "--tile", "8", "--qtile", "8"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
        )
        for i in range(2)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed: {err[-2000:]}"
        lines = out.strip().splitlines()
        results.append((lines[-1], json.loads(lines[-2])["error"]))
    return results


@pytest.mark.parametrize("tamper", [False, True])
def test_two_process_block_verification(tmp_path, tamper):
    txs, ledger = _build_block(4)
    if tamper:
        # break a tx on process 1's shard (round-robin index 1)
        txs[1].fee = 7
    path = tmp_path / "block.pkl"
    path.write_bytes(pickle.dumps({"txs": [encode_transaction(tx) for tx in txs], "ledger": snapshot(ledger)}))
    expected = "REJECT" if tamper else "ACCEPT"
    (verdict0, err0), (verdict1, err1) = _run_workers(str(path))
    assert [verdict0, verdict1] == [expected, expected]
    # a worker that crashed would reject as well: only rank 1's share holds the tampered fee
    assert err0 is None
    if tamper:
        assert err1 is not None and err1["class"] == "ProofVerificationError", err1
    else:
        assert err1 is None


def test_verify_batch_distributed_rejects_a_share_that_raises():
    """One gloo process: an empty share is accepted, and a share whose
    verification raises is rejected (the JAX package's semantics)."""
    import torch.distributed as dist

    from xelis_he_tpu_torch.mock import Ledger as TorchLedger
    from xelis_he_tpu_torch.ops.accel import Accelerator
    from xelis_he_tpu_torch.parallel.dcn import init_process, verify_batch_distributed, verify_share

    accel = Accelerator(device="cpu", tile=8, qtile=8)
    init_process(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        assert dist.get_backend() == "gloo"
        assert verify_batch_distributed([], TorchLedger(), accel=accel)
        assert not verify_batch_distributed([object()], TorchLedger(), accel=accel)
        assert isinstance(verify_share([object()], TorchLedger(), accel=accel), Exception)
    finally:
        dist.destroy_process_group()
