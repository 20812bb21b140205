"""Shared cases of the port's block-verification tests (tests/test_torch_verify*.py,
tests/test_torch_reject_*.py).

Blocks and ledgers are built with ``xelis_he_tpu``, carried across with
``xelis_he_tpu_torch.carry`` (wire bytes, secret scalars, compressed
ciphertexts), and verified by both packages: the JAX package's
``Accelerator("numpy")`` and the port's ``Accelerator(device="cpu")``, which
runs the kernels' plain versions.  One verify through the JAX package's
numpy accelerator takes some 40 s on one CPU core, so each test file makes
at most one of them."""

import contextlib
import copy

import torch

from xelis_he_tpu import NATIVE_ASSET, TransactionBuilder, TransferBuilder, TransfersBuilder
from xelis_he_tpu.bulletproofs.range_proof import RangeProof
from xelis_he_tpu.mock import Account, GenerationBalance, Ledger
from xelis_he_tpu.pyref.ristretto import L
from xelis_he_tpu.tx.wire import encode_transaction
from xelis_he_tpu_torch.carry import ledger_from_snapshot, txs_from_wire

# The plain versions run many small tensor ops; PyTorch's intra-op thread
# pool gains nothing on them and, with one pool per test worker, starves the
# other workers' cores.
torch.set_num_threads(1)


@contextlib.contextmanager
def plain_calls():
    """Counts, per kernel, the calls its wrapper makes to its plain version
    while the block runs (the route of CPU tensors), so a test can show which
    branch a call took.  Yields the dict of counts."""
    from xelis_he_tpu_torch.ops import kernels as K

    # the roofline probes (ops/probes.py) run on no block path
    calls = {name: 0 for name in K.launches if not name.startswith("probe_")}
    saved = {name: getattr(K, f"{name}_plain") for name in calls}

    def counting(name):
        def run(*args):
            calls[name] += 1
            return saved[name](*args)

        return run

    for name in calls:
        setattr(K, f"{name}_plain", counting(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(K, f"{name}_plain", fn)


def snapshot(ledger: Ledger) -> dict:
    """A JAX-package ledger as plain bytes and ints (carry.py's format)."""
    return {
        "accounts": [
            {
                "secret": acc.keypair.secret().scalar.to_bytes(32, "little"),
                "balances": {a.data: ct.compress().data for a, ct in acc.balances.items()},
                "nonce": acc.nonce,
            }
            for acc in ledger.accounts.values()
        ],
        "multisig": {
            pk.data: (thr, [s.data for s in signers])
            for pk, (signers, thr) in ledger.multisig_accounts.items()
        },
    }


def balances(ledger) -> dict:
    """Every balance as compressed bytes, with each account's nonce."""
    return {
        pk.data: ({a.data: ct.compress().data for a, ct in acc.balances.items()}, acc.nonce)
        for pk, acc in ledger.accounts.items()
    }


def carry(txs, ledger):
    return txs_from_wire([encode_transaction(tx) for tx in txs]), ledger_from_snapshot(snapshot(ledger))


def outcome(fn):
    """None when ``fn`` accepts, else (error class name, proof error kind)."""
    try:
        fn()
    except Exception as e:  # the comparison is the point: both sides raise alike
        return type(e).__name__, getattr(e, "kind", None)
    return None


def transfer_block():
    """tests/test_accel_verify.py's block: two senders pay one receiver."""
    ledger = Ledger()
    receiver = Account([(NATIVE_ASSET, 0)])
    pk_r = ledger.add_account(receiver)
    txs = []
    for i in range(2):
        sender = Account([(NATIVE_ASSET, 100)])
        pk_s = ledger.add_account(sender)
        builder = TransactionBuilder(
            version=1, source=pk_s,
            data=TransfersBuilder([TransferBuilder(asset=NATIVE_ASSET, amount=10 + i, dest_pubkey=pk_r)]),
            fee=1, nonce=0,
        )
        txs.append(builder.build(GenerationBalance({NATIVE_ASSET: 100}, sender), sender.keypair))
    return txs, ledger, pk_r


def multisig_spend():
    """tests/test_accel_payloads.py's multisig spend: a 1-of-1 cosigned
    transfer, which the native block engine handles with its bulk state."""
    alice = Account([(NATIVE_ASSET, 100)])
    bob = Account([(NATIVE_ASSET, 0)])
    charlie = Account([(NATIVE_ASSET, 0)])
    ledger = Ledger()
    pk_a = ledger.add_account(alice)
    pk_b = ledger.add_account(bob)
    pk_c = ledger.add_account(charlie)
    ledger.set_multisig_for_account(pk_a, [pk_c], 1)
    unsigned = TransactionBuilder(
        version=1, source=pk_a,
        data=TransfersBuilder([TransferBuilder(asset=NATIVE_ASSET, amount=10, dest_pubkey=pk_b)]),
        fee=1, nonce=0,
    ).build_unsigned(GenerationBalance({NATIVE_ASSET: 100}, alice), alice.keypair)
    unsigned.set_multisig([(0, charlie.keypair.sign(unsigned.hash().data))])
    return [unsigned.sign(alice.keypair)], ledger


def _tamper_signature(txs):
    txs[1].signature.s = (txs[1].signature.s + 1) % L


def _tamper_fee(txs):
    txs[0].fee = 2


def _tamper_range_proof(txs):
    rb = bytearray(txs[0].range_proof.to_bytes())
    rb[33] ^= 1
    txs[0].range_proof = RangeProof.from_bytes(bytes(rb))


# tests/test_accel_verify.py's tampers
TAMPERS = {"signature": _tamper_signature, "fee": _tamper_fee, "range_proof": _tamper_range_proof}


def rejected_alike(what: str, jax_verify_batch, jax_accel, port_verify_batch, port_accel):
    """(JAX outcome, port outcome) of the transfer block tampered by ``what``."""
    txs, ledger, _ = transfer_block()
    bad = copy.deepcopy(txs)
    TAMPERS[what](bad)
    port_txs, port_ledger = carry(bad, ledger)
    want = outcome(lambda: jax_verify_batch(bad, ledger.clone(), accel=jax_accel))
    got = outcome(lambda: port_verify_batch(port_txs, port_ledger.clone(), accel=port_accel))
    return want, got
