"""Transaction wire model.  Mirrors xelis-he/src/tx/mod.rs.

``Transaction.to_bytes()`` reproduces the reference's canonical serialization
(tx/verify.rs:621-688) including the ``(bytes, multisig_offset)`` split used
for multisig signing.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..elgamal import ElGamalSecretKey, Signature
from ..errors import DecompressionError
from ..extra_data import ExtraData, PlaintextData
from ..sigma import CiphertextValidityProof, CommitmentEqProof
from ..types import (
    CompressedCiphertext,
    CompressedCommitment,
    CompressedHandle,
    CompressedPubkey,
    Hash,
    Role,
)

# MultiSig: list of (signer index, signature) (tx/mod.rs:17)
MultiSig = list


@dataclass
class Transfer:
    """One confidential transfer: a single commitment with sender and
    receiver decrypt handles sharing the same opening (tx/mod.rs:19-32)."""

    asset: Hash
    dest_pubkey: CompressedPubkey
    amount_commitment: CompressedCommitment
    amount_sender_handle: CompressedHandle
    amount_receiver_handle: CompressedHandle
    ct_validity_proof: CiphertextValidityProof
    extra_data: ExtraData | None = None

    def get_ciphertext(self, role: Role) -> CompressedCiphertext:
        handle = (
            self.amount_receiver_handle if role == Role.RECEIVER else self.amount_sender_handle
        )
        return CompressedCiphertext(self.amount_commitment, handle)

    def decrypt_amount(self, sk: ElGamalSecretKey, role: Role):
        """Returns an ECDLPInstance (tx/mod.rs:45-51)."""
        return sk.decrypt(self.get_ciphertext(role).decompress())

    def decrypt_extra_data(self, sk: ElGamalSecretKey, role: Role) -> PlaintextData | None:
        if self.extra_data is None:
            return None
        return self.extra_data.decrypt(sk, role)


@dataclass
class SmartContractCall:
    contract: Hash
    assets: dict  # Hash -> int
    params: dict  # str -> str


@dataclass
class BurnPayload:
    asset: Hash
    amount: int


@dataclass
class MultiSigPayload:
    signers: list  # list[CompressedPubkey]
    threshold: int


@dataclass
class DeployContractPayload:
    code: str


# TransactionType (tx/mod.rs:83-93): one of
#   list[Transfer] | BurnPayload | SmartContractCall | DeployContractPayload
#   | MultiSigPayload
TransactionData = object


@dataclass
class NewSourceCommitment:
    """One per asset spent: commitment to the sender's NEW balance plus the
    equality proof binding it to the homomorphically-updated ciphertext
    (tx/mod.rs:95-100)."""

    new_source_commitment: CompressedCommitment
    new_commitment_eq_proof: CommitmentEqProof
    asset: Hash


@dataclass
class Transaction:
    version: int
    source: CompressedPubkey
    data: TransactionData
    fee: int
    nonce: int
    new_source_commitments: list  # list[NewSourceCommitment]
    range_proof: object  # bulletproofs RangeProof
    signature: Signature
    multisig: MultiSig | None = None

    # -- getters (tx/mod.rs:121-148) ---------------------------------------

    def get_version(self) -> int:
        return self.version

    def get_source(self) -> CompressedPubkey:
        return self.source

    def get_data(self):
        return self.data

    def get_fee(self) -> int:
        return self.fee

    def get_nonce(self) -> int:
        return self.nonce

    def get_multisig(self):
        return self.multisig

    # -- canonical serialization (tx/verify.rs:621-688) ---------------------

    def to_bytes(self) -> tuple[bytes, int]:
        """Returns (bytes, multisig_offset): the canonical byte encoding and
        the length of the prefix that multisig signatures sign."""
        out = bytearray()
        out += self.version.to_bytes(1, "big")
        out += self.source.data
        out += self.fee.to_bytes(8, "big")
        out += self.nonce.to_bytes(8, "big")

        data = self.data
        if isinstance(data, list):  # Transfers
            for t in data:
                out += t.asset.data
                out += t.dest_pubkey.data
                out += t.amount_commitment.data
                out += t.amount_sender_handle.data
                out += t.amount_receiver_handle.data
                if t.extra_data is not None:
                    out += t.extra_data.to_bytes()
                out += t.ct_validity_proof.to_bytes()
        elif isinstance(data, BurnPayload):
            out += data.asset.data
            out += data.amount.to_bytes(8, "big")
        elif isinstance(data, SmartContractCall):
            out += data.contract.data
            for asset, amount in data.assets.items():
                out += asset.data
                out += amount.to_bytes(8, "big")
            for key, value in data.params.items():
                out += key.encode()
                out += value.encode()
        elif isinstance(data, DeployContractPayload):
            out += data.code.encode()
        elif isinstance(data, MultiSigPayload):
            out += data.threshold.to_bytes(1, "big")
            for signer in data.signers:
                out += signer.data
        else:  # pragma: no cover
            raise TypeError(f"unknown transaction data {type(data)}")

        out += self.range_proof.to_bytes()

        for commitment in self.new_source_commitments:
            out += commitment.asset.data
            out += commitment.new_source_commitment.data
            out += commitment.new_commitment_eq_proof.to_bytes()

        n_bytes = len(out)
        if self.multisig is not None:
            for sig_id, sig in self.multisig:
                out += bytes([sig_id])
                out += sig.to_bytes()

        return bytes(out), n_bytes
