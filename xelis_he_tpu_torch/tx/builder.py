"""Transaction builder (prover pipeline).

Mirrors xelis-he/src/tx/builder.rs: the
``GetBlockchainAccountBalance`` state protocol, transfer commitment creation,
per-asset CommitmentEqProofs, per-transfer CiphertextValidityProofs, dud
commitment padding to a power of two, and the aggregated range proof — with
the exact transcript choreography of the reference (builder.rs:320-545).

TPU note: every group operation here routes through the ``msm`` callable so
the prover can run against the batched numpy/TPU engine.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol

from ..bulletproofs.generators import BP_GENS, PC_GENS
from ..bulletproofs.range_proof import RangeProof
from ..elgamal import (
    DecryptHandle,
    ElGamalCiphertext,
    ElGamalKeypair,
    ElGamalPubkey,
    PedersenCommitment,
    PedersenOpening,
)
from ..errors import FormatError, InsufficientFundsError
from ..extra_data import ExtraData, PlaintextData
from ..hashcore.blake3 import blake3
from ..pyref.ristretto import multiscalar_mul
from ..sigma import CiphertextValidityProof, CommitmentEqProof
from ..transcript import ProtocolTranscript
from ..types import CompressedPubkey, Hash, NATIVE_ASSET, Role
from .model import (
    BurnPayload,
    DeployContractPayload,
    MultiSigPayload,
    NewSourceCommitment,
    SmartContractCall,
    Transaction,
    Transfer,
)


class GetBlockchainAccountBalance(Protocol):
    """Prover-side state abstraction (builder.rs:41-49)."""

    def get_account_balance(self, asset: Hash) -> int: ...

    def get_account_ct(self, asset: Hash): ...  # -> ElGamalCiphertext (decompressed)


@dataclass
class TransferBuilder:
    asset: Hash
    amount: int
    dest_pubkey: CompressedPubkey
    extra_data: PlaintextData | None = None


@dataclass
class SmartContractCallBuilder:
    contract: Hash
    assets: dict
    params: dict


@dataclass
class TransfersBuilder:
    transfers: list  # list[TransferBuilder]


@dataclass
class BurnBuilder:
    asset: Hash
    amount: int


@dataclass
class MultiSigBuilder:
    signers: list  # list[CompressedPubkey]
    threshold: int


@dataclass
class DeployContractBuilder:
    code: str


@dataclass
class _TransferWithCommitment:
    inner: TransferBuilder
    amount_commitment: PedersenCommitment
    amount_sender_handle: DecryptHandle
    amount_receiver_handle: DecryptHandle
    dest_pubkey: ElGamalPubkey
    amount_opening: PedersenOpening

    def get_ciphertext(self, role: Role) -> ElGamalCiphertext:
        handle = (
            self.amount_receiver_handle if role == Role.RECEIVER else self.amount_sender_handle
        )
        return ElGamalCiphertext(self.amount_commitment, handle)


class TransactionUnsigned:
    """Built transaction awaiting (multisig) signatures (builder.rs:107-219)."""

    def __init__(self, version, source, data, fee, nonce, source_commitments, range_proof):
        self.version = version
        self.source = source
        self.data = data
        self.fee = fee
        self.nonce = nonce
        self.source_commitments = source_commitments
        self.range_proof = range_proof
        self.multisig = None

    def _core(self) -> Transaction:
        return Transaction(
            version=self.version,
            source=self.source,
            data=self.data,
            fee=self.fee,
            nonce=self.nonce,
            new_source_commitments=self.source_commitments,
            range_proof=self.range_proof,
            signature=None,
            multisig=self.multisig,
        )

    def to_bytes(self) -> bytes:
        return self._core().to_bytes()[0]

    def hash(self) -> Hash:
        """blake3 tx hash for multisig signing; must be computed before any
        multisig is attached (builder.rs:190-195)."""
        assert self.multisig is None
        return Hash(blake3(self.to_bytes()))

    def set_multisig(self, multisig) -> None:
        self.multisig = multisig

    def sign(self, keypair: ElGamalKeypair) -> Transaction:
        signature = keypair.sign(self.to_bytes())
        tx = self._core()
        tx.signature = signature
        return tx


@dataclass
class TransactionBuilder:
    """builder.rs:77-84; ``data`` is one of the *Builder payload types."""

    version: int
    source: CompressedPubkey
    data: object
    fee: int
    nonce: int

    # -- cost accounting (builder.rs:221-318) -------------------------------

    def get_new_source_ct(self, ct: ElGamalCiphertext, asset: Hash, transfers) -> ElGamalCiphertext:
        if asset.is_zeros():
            # Fees apply to the native asset only (builder.rs:228-231)
            ct = ct - self.fee
        if isinstance(self.data, TransfersBuilder):
            for transfer in transfers:
                if transfer.inner.asset == asset:
                    ct = ct - transfer.get_ciphertext(Role.SENDER)
        elif isinstance(self.data, BurnBuilder):
            if asset == self.data.asset:
                ct = ct - self.data.amount
        elif isinstance(self.data, SmartContractCallBuilder):
            amount = self.data.assets.get(asset)
            if amount is not None:
                ct = ct - amount
        return ct

    def get_transaction_cost(self, asset: Hash) -> int:
        cost = 0
        if asset.is_zeros():
            cost += self.fee
        if isinstance(self.data, TransfersBuilder):
            for transfer in self.data.transfers:
                if transfer.asset == asset:
                    cost += transfer.amount
        elif isinstance(self.data, BurnBuilder):
            if self.data.asset == asset:
                cost += self.data.amount
        elif isinstance(self.data, SmartContractCallBuilder):
            cost += self.data.assets.get(asset, 0)
        return cost

    def used_assets(self) -> list[Hash]:
        """Deterministic insertion-ordered asset set; native always included
        (builder.rs:296-318)."""
        consumed: dict[Hash, None] = {NATIVE_ASSET: None}
        if isinstance(self.data, TransfersBuilder):
            for transfer in self.data.transfers:
                consumed.setdefault(transfer.asset, None)
        elif isinstance(self.data, BurnBuilder):
            consumed.setdefault(self.data.asset, None)
        elif isinstance(self.data, SmartContractCallBuilder):
            for asset in self.data.assets:
                consumed.setdefault(asset, None)
        return list(consumed)

    # -- build pipeline (builder.rs:320-545) --------------------------------

    def build_unsigned(
        self, state: GetBlockchainAccountBalance, source_keypair: ElGamalKeypair, msm=multiscalar_mul
    ) -> TransactionUnsigned:
        used_assets = self.used_assets()

        transfers: list[_TransferWithCommitment] = []
        if isinstance(self.data, TransfersBuilder):
            for transfer in self.data.transfers:
                dest_pubkey = transfer.dest_pubkey.decompress()
                amount_opening = PedersenOpening.generate_new()
                amount_commitment = PedersenCommitment.new_with_opening(
                    transfer.amount, amount_opening
                )
                transfers.append(
                    _TransferWithCommitment(
                        inner=transfer,
                        amount_commitment=amount_commitment,
                        amount_sender_handle=source_keypair.pubkey().decrypt_handle(amount_opening),
                        amount_receiver_handle=dest_pubkey.decrypt_handle(amount_opening),
                        dest_pubkey=dest_pubkey,
                        amount_opening=amount_opening,
                    )
                )

        transcript = prepare_transcript(self.version, self.source, self.fee, self.nonce)

        range_proof_openings = [PedersenOpening.generate_new().scalar for _ in used_assets]
        range_proof_values: list[int] = []
        for asset in used_assets:
            cost = self.get_transaction_cost(asset)
            balance = state.get_account_balance(asset)
            if balance < cost:
                raise InsufficientFundsError(f"asset {asset!r}: balance {balance} < cost {cost}")
            range_proof_values.append(balance - cost)

        source_commitments: list[NewSourceCommitment] = []
        for asset, new_source_opening_scalar, source_new_balance in zip(
            used_assets, range_proof_openings, range_proof_values
        ):
            new_source_opening = PedersenOpening(new_source_opening_scalar)

            source_current_ciphertext = state.get_account_ct(asset)

            new_source_commitment = PedersenCommitment.new_with_opening(
                source_new_balance, new_source_opening
            )
            compressed_commitment = new_source_commitment.compress()

            new_source_ciphertext = self.get_new_source_ct(
                source_current_ciphertext, asset, transfers
            )

            transcript.new_commitment_eq_proof_domain_separator()
            transcript.append_hash(b"new_source_commitment_asset", asset)
            transcript.append_commitment(b"new_source_commitment", compressed_commitment)

            new_commitment_eq_proof = CommitmentEqProof.new(
                source_keypair,
                new_source_ciphertext,
                new_source_opening,
                source_new_balance,
                transcript,
            )

            source_commitments.append(
                NewSourceCommitment(
                    asset=asset,
                    new_source_commitment=compressed_commitment,
                    new_commitment_eq_proof=new_commitment_eq_proof,
                )
            )

        if isinstance(self.data, TransfersBuilder):
            wire_transfers: list[Transfer] = []
            for transfer in transfers:
                amount_commitment = transfer.amount_commitment.compress()
                amount_sender_handle = transfer.amount_sender_handle.compress()
                amount_receiver_handle = transfer.amount_receiver_handle.compress()

                transcript.transfer_proof_domain_separator()
                transcript.append_pubkey(b"dest_pubkey", transfer.inner.dest_pubkey)
                transcript.append_commitment(b"amount_commitment", amount_commitment)
                transcript.append_handle(b"amount_sender_handle", amount_sender_handle)
                transcript.append_handle(b"amount_receiver_handle", amount_receiver_handle)

                ct_validity_proof = CiphertextValidityProof.new(
                    transfer.dest_pubkey,
                    source_keypair.pubkey(),
                    transfer.inner.amount,
                    transfer.amount_opening,
                    transcript,
                )

                range_proof_values.append(transfer.inner.amount)
                range_proof_openings.append(transfer.amount_opening.scalar)

                extra_data = None
                if transfer.inner.extra_data is not None:
                    extra_data = ExtraData.new(
                        transfer.inner.extra_data,
                        source_keypair.pubkey(),
                        transfer.dest_pubkey,
                    )

                wire_transfers.append(
                    Transfer(
                        asset=transfer.inner.asset,
                        dest_pubkey=transfer.inner.dest_pubkey,
                        amount_commitment=amount_commitment,
                        amount_sender_handle=amount_sender_handle,
                        amount_receiver_handle=amount_receiver_handle,
                        ct_validity_proof=ct_validity_proof,
                        extra_data=extra_data,
                    )
                )
            data = wire_transfers
        elif isinstance(self.data, BurnBuilder):
            transcript.burn_proof_domain_separator()
            transcript.append_hash(b"asset", self.data.asset)
            transcript.append_u64(b"amount", self.data.amount)
            data = BurnPayload(asset=self.data.asset, amount=self.data.amount)
        elif isinstance(self.data, SmartContractCallBuilder):
            data = SmartContractCall(
                contract=self.data.contract, assets=self.data.assets, params=self.data.params
            )
        elif isinstance(self.data, DeployContractBuilder):
            data = DeployContractPayload(code=self.data.code)
        elif isinstance(self.data, MultiSigBuilder):
            signers, threshold = self.data.signers, self.data.threshold
            if threshold > len(signers) or (signers and threshold == 0):
                raise FormatError("invalid multisig threshold")
            transcript.multisig_proof_domain_separator()
            transcript.append_u64(b"threshold", threshold)
            seen = set()
            for signer in signers:
                if signer == self.source:
                    raise FormatError("multisig signer cannot be the source")
                if signer.data in seen:
                    raise FormatError("duplicate multisig signer")
                seen.add(signer.data)
                transcript.append_pubkey(b"signer", signer)
            data = MultiSigPayload(signers=list(signers), threshold=threshold)
        else:
            raise FormatError(f"unknown builder payload {type(self.data)}")

        # Pad with dud commitments so the aggregation size is a power of two
        # (builder.rs:512-521)
        n_commitments = len(range_proof_values)
        next_pow2 = 1 << (n_commitments - 1).bit_length() if n_commitments > 1 else 1
        for _ in range(next_pow2 - n_commitments):
            range_proof_values.append(0)
            range_proof_openings.append(0)

        range_proof, _commitments = RangeProof.prove_multiple(
            BP_GENS, PC_GENS, transcript, range_proof_values, range_proof_openings, 64, msm=msm
        )

        return TransactionUnsigned(
            version=self.version,
            source=self.source,
            data=data,
            fee=self.fee,
            nonce=self.nonce,
            source_commitments=source_commitments,
            range_proof=range_proof,
        )

    def build(
        self, state: GetBlockchainAccountBalance, source_keypair: ElGamalKeypair, msm=multiscalar_mul
    ) -> Transaction:
        return self.build_unsigned(state, source_keypair, msm=msm).sign(source_keypair)


def build_batch(jobs, n_threads: int | None = None) -> list[Transaction]:
    """Thread-parallel block building: ``jobs`` is a list of
    (TransactionBuilder, state, keypair) tuples; returns the built
    transactions in order.

    The reference prover is single-threaded per tx and its bench scales by
    OS threads (benches/tx.rs:252-343); here the per-tx prover hot path is
    GIL-releasing C++ (IPP session + table MSMs), so independent builds
    scale across host cores inside one process.  The first job runs alone
    to warm the process-global generator-table registry."""
    import concurrent.futures
    import os

    if n_threads is None:
        n_threads = max(1, int(os.environ.get("XELIS_BUILD_THREADS",
                                              os.cpu_count() or 2)))
    jobs = list(jobs)
    if n_threads <= 1 or len(jobs) < 2:
        return [b.build(s, k) for b, s, k in jobs]
    # per-tx workers saturate the cores: turn off the IPP session's inner
    # L/R-side threading for the duration (process-global toggle)
    try:
        from ..hashcore.prover_native import lib as _plib
    except Exception:  # pragma: no cover - native build unavailable
        _plib = None
    if _plib is not None:
        _plib.xhe_ipp_set_threads(1)
    try:
        first = jobs[0][0].build(jobs[0][1], jobs[0][2])
        with concurrent.futures.ThreadPoolExecutor(n_threads) as ex:
            rest = list(ex.map(lambda j: j[0].build(j[1], j[2]), jobs[1:]))
    finally:
        if _plib is not None:
            _plib.xhe_ipp_set_threads(2)
    return [first, *rest]


import threading as _threading

_transcript_tls = _threading.local()


def prepare_transcript(
    version: int, source_pubkey: CompressedPubkey, fee: int, nonce: int
) -> ProtocolTranscript:
    """tx/verify.rs:146-158.

    The post-dom-sep STROBE state is identical for every transaction, so a
    per-thread template is built once and CLONED per tx (a native state
    memcpy) instead of re-running the Keccak init + dom-sep absorb — this
    runs once per transaction on the batch-verify host hot path."""
    template = getattr(_transcript_tls, "template", None)
    if template is None:
        template = _transcript_tls.template = ProtocolTranscript(b"transaction-proof")
        template._flush()
    transcript = template.clone()
    transcript.append_u64(b"version", version)
    transcript.append_pubkey(b"source_pubkey", source_pubkey)
    transcript.append_u64(b"fee", fee)
    transcript.append_u64(b"nonce", nonce)
    return transcript
