"""Transactional state overlay for batch verification.

The reference interleaves state writes with proof collection, so a failing
batch leaves the caller's state partially mutated (verify.rs:294-341,
343-395 — receiver balances are credited BEFORE the proofs are checked) and
callers must clone the whole ledger per attempt (lib.rs:296,
benches/tx.rs:187).  SURVEY.md §5 asks this rebuild to do better:
``verify_batch(..., transactional=True)`` buffers every write in an overlay
and flushes to the underlying state only after ALL proofs verified — no
clone, no partial mutation on failure.

The overlay is read-through: later transactions in the batch observe
earlier transactions' buffered writes exactly as they would the real
state's.  Balance keys are (account, asset) — the reference ledger keys
balances the same way; the Role argument selects echo/final ciphertext
semantics upstream, not separate storage (mock ledger lib.rs:130-201).
"""

from __future__ import annotations

_MISS = object()


class TransactionalState:
    """Write-buffering proxy implementing BlockchainVerificationState over
    another BlockchainVerificationState."""

    __slots__ = ("inner", "_balances", "_nonces", "_outputs", "_multisig")

    def __init__(self, inner):
        self.inner = inner
        self._balances: dict = {}
        self._nonces: dict = {}
        self._outputs: dict = {}
        self._multisig: dict = {}

    # -- reads (overlay first) -------------------------------------------

    def get_account_balance(self, account, asset, role):
        ct = self._balances.get((account, asset), _MISS)
        if ct is not _MISS:
            return ct
        return self.inner.get_account_balance(account, asset, role)

    def get_account_nonce(self, account):
        nonce = self._nonces.get(account, _MISS)
        if nonce is not _MISS:
            return nonce
        return self.inner.get_account_nonce(account)

    def get_multisig_for_account(self, account):
        cfg = self._multisig.get(account, _MISS)
        if cfg is not _MISS:
            return cfg
        return self.inner.get_multisig_for_account(account)

    # -- writes (buffered) -----------------------------------------------

    def update_account_balance(self, account, asset, new_ct, role):
        self._balances[(account, asset)] = new_ct

    def update_account_nonce(self, account, new_nonce):
        self._nonces[account] = new_nonce

    def set_output_ciphertext(self, account, asset, ct):
        self._outputs[(account, asset)] = ct

    def set_multisig_for_account(self, account, signers, threshold):
        self._multisig[account] = (signers, threshold)

    # -- lifecycle ---------------------------------------------------------

    def commit(self) -> None:
        """Flush all buffered writes to the underlying state."""
        from ..types import Role

        for (account, asset), ct in self._balances.items():
            # role is storage-irrelevant (see module docstring); SENDER is
            # passed for protocol compatibility
            self.inner.update_account_balance(account, asset, ct, Role.SENDER)
        for account, nonce in self._nonces.items():
            self.inner.update_account_nonce(account, nonce)
        for (account, asset), ct in self._outputs.items():
            self.inner.set_output_ciphertext(account, asset, ct)
        for account, (signers, threshold) in self._multisig.items():
            self.inner.set_multisig_for_account(account, signers, threshold)
        self.rollback()

    def rollback(self) -> None:
        """Drop all buffered writes (failure path: underlying untouched)."""
        self._balances.clear()
        self._nonces.clear()
        self._outputs.clear()
        self._multisig.clear()
