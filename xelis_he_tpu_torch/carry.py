"""State carried into the port: ledgers, blocks and device rows.

This system has no weights.  What crosses between the JAX package and the
port (or between two processes of the port) is the ledger and the block, in
plain bytes, ints and numpy arrays:

- a ledger snapshot: per account its 32-byte secret scalar, its balances as
  {asset: 64-byte compressed ciphertext}, its nonce, and the multisig config
  (threshold and 32-byte signer keys) of the accounts that have one;
- a block: the wire encoding of each transaction;
- device rows: (n, 4, 18) uint32 limb rows of points, as the verifier's
  native path packs them.
"""

from __future__ import annotations

import numpy as _np
import torch

from .elgamal import ElGamalKeypair
from .mock import Account, Ledger
from .types import CompressedCiphertext, CompressedPubkey, Hash


def ledger_from_snapshot(snap: dict) -> Ledger:
    """``snap``: {"accounts": [{"secret": 32 bytes, "balances": {32-byte
    asset: 64-byte ciphertext}, "nonce": int}], "multisig": {32-byte pubkey:
    (threshold, [32-byte signer keys])}} -> the port's mock Ledger."""
    ledger = Ledger()
    for acc in snap["accounts"]:
        account = object.__new__(Account)
        account.keypair = ElGamalKeypair.keygen_with_secret(int.from_bytes(acc["secret"], "little"))
        account.balances = {
            Hash(asset): CompressedCiphertext.from_bytes(ct).decompress()
            for asset, ct in acc["balances"].items()
        }
        account.nonce = int(acc["nonce"])
        ledger.add_account(account)
    for pk, (threshold, signers) in snap.get("multisig", {}).items():
        ledger.set_multisig_for_account(
            CompressedPubkey(pk), [CompressedPubkey(s) for s in signers], int(threshold)
        )
    return ledger


def ledger_snapshot(ledger: Ledger) -> dict:
    """The port's Ledger as ``ledger_from_snapshot`` takes it: plain bytes
    and ints, which another process can load."""
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


def txs_from_wire(blobs) -> list:
    """Wire-encoded transactions -> the port's Transaction objects."""
    from .tx.wire import decode_transaction

    return [decode_transaction(bytes(b)) for b in blobs]


def rows_to_device(np_rows: _np.ndarray, device) -> torch.Tensor:
    """(n, 4, 18) uint32 rows -> int32 tensor on ``device`` (same bits: limbs
    are below 2^17).  A CUDA upload goes from pinned memory without blocking
    the host."""
    arr = _np.ascontiguousarray(np_rows).view(_np.int32)
    return to_device(arr, device)


def rows_to_numpy(t: torch.Tensor) -> _np.ndarray:
    """Device rows -> (n, 4, 18) uint32 numpy rows (one device pull)."""
    return t.detach().to("cpu").numpy().astype(_np.uint32)


def to_device(arr: _np.ndarray, device) -> torch.Tensor:
    """numpy array -> tensor on ``device``, copied (the caller may reuse
    ``arr``); CUDA uploads are staged in pinned memory and do not sync."""
    t = torch.from_numpy(_np.ascontiguousarray(arr))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()
