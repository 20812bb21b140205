"""Mock blockchain state for tests and benchmarks.

Mirrors xelis-he/src/lib.rs:97-242 (mock::Ledger / Account /
GenerationBalance): in-memory account maps implementing both state
protocols.
"""

from __future__ import annotations

import copy

from .elgamal import ElGamalCiphertext, ElGamalKeypair
from .pyref.ristretto import RistrettoPoint
from .types import CompressedPubkey, Hash, Role


class Account:
    def __init__(self, balances):
        """balances: iterable of (Hash, int) pairs; each is encrypted with a
        fresh keypair (lib.rs:228-241).

        Balances are stored DECOMPRESSED (ElGamalCiphertext), mirroring the
        reference ledger's HashMap<_, Ciphertext> — the verifier state trait
        passes decompressed ciphertexts both ways (verify.rs:30-44), so no
        compress/decompress round-trips happen per transaction."""
        self.keypair = ElGamalKeypair.keygen()
        self.balances: dict[Hash, ElGamalCiphertext] = {
            asset: self.keypair.pubkey().encrypt(balance)
            for asset, balance in balances
        }
        self.nonce = 0

    def clone(self) -> "Account":
        new = object.__new__(Account)
        new.keypair = self.keypair
        new.balances = dict(self.balances)
        new.nonce = self.nonce
        return new


class Ledger:
    """Implements BlockchainVerificationState over dicts (lib.rs:130-201).

    ``supports_bulk_block`` opts into the native bulk state pass
    (tx/verify._bulk_state_setup): balances are plain role-independent
    map entries and ``set_output_ciphertext`` is a no-op, so the verifier
    may fetch each touched (account, asset) pair once and write the final
    balance back once instead of calling per transaction."""

    supports_bulk_block = True

    def __init__(self, accounts: dict[CompressedPubkey, Account] | None = None):
        self.accounts = accounts or {}
        self.multisig_accounts: dict[CompressedPubkey, tuple[list, int]] = {}

    def clone(self) -> "Ledger":
        new = Ledger({pk: acc.clone() for pk, acc in self.accounts.items()})
        new.multisig_accounts = {k: (list(v[0]), v[1]) for k, v in self.multisig_accounts.items()}
        return new

    def add_account(self, account: Account) -> CompressedPubkey:
        pk = account.keypair.pubkey().compress()
        self.accounts[pk] = account
        return pk

    def get_account(self, account: CompressedPubkey) -> Account:
        return self.accounts[account]

    def get_bal_decrypted(self, account: CompressedPubkey, asset: Hash) -> RistrettoPoint:
        acc = self.accounts[account]
        return acc.keypair.secret().decrypt(acc.balances[asset]).as_point()

    # -- BlockchainVerificationState ----------------------------------------

    def get_account_balance(self, account, asset, role):
        return self.accounts[account].balances[asset]

    def update_account_balance(self, account, asset, new_ct, role):
        self.accounts[account].balances[asset] = new_ct

    def get_account_nonce(self, account):
        return self.accounts[account].nonce

    def update_account_nonce(self, account, new_nonce):
        self.accounts[account].nonce = new_nonce

    def set_output_ciphertext(self, account, asset, ct):
        pass

    def set_multisig_for_account(self, account, signers, threshold):
        if not signers:
            self.multisig_accounts.pop(account, None)
        else:
            self.multisig_accounts[account] = (list(signers), threshold)

    def get_multisig_for_account(self, account):
        return self.multisig_accounts.get(account)


class GenerationBalance:
    """Prover-side state (lib.rs:203-219)."""

    def __init__(self, balances: dict[Hash, int], account: Account):
        self.balances = balances
        self.account = account

    def get_account_balance(self, asset: Hash) -> int:
        return self.balances[asset]

    def get_account_ct(self, asset: Hash) -> ElGamalCiphertext:
        return self.account.balances[asset]
