"""Self-delimiting binary wire codec for transactions.

The reference's ``to_bytes`` (tx/verify.rs:621-688) is a signing/hashing
preimage, not a reversible encoding; real (de)serialization there goes
through serde derives.  This module is the framework's serde equivalent: a
deterministic, versioned, length-delimited binary format with full
round-trip (``encode_transaction`` / ``decode_transaction``), so wallets and
nodes can exchange transactions without a Rust-style serde layer.

Proof fields reuse the protocol serializations (sigma proofs 192/160 bytes,
dalek-layout range proofs), so decoding validates scalar canonicity
exactly like the reference's deserializers.
"""

from __future__ import annotations

import struct

from ..bulletproofs.range_proof import RangeProof
from ..elgamal import Signature
from ..errors import FormatError
from ..extra_data import AeCipher, ExtraData
from ..sigma import CiphertextValidityProof, CommitmentEqProof
from ..types import CompressedCommitment, CompressedHandle, CompressedPubkey, Hash
from .model import (
    BurnPayload,
    DeployContractPayload,
    MultiSigPayload,
    NewSourceCommitment,
    SmartContractCall,
    Transaction,
    Transfer,
)

WIRE_VERSION = 1

_KIND_TRANSFERS = 0
_KIND_BURN = 1
_KIND_CALL = 2
_KIND_DEPLOY = 3
_KIND_MULTISIG = 4


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise FormatError("truncated transaction")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def done(self) -> bool:
        return self.pos == len(self.data)


def _u16(v: int) -> bytes:
    return struct.pack("<H", v)


def _u32(v: int) -> bytes:
    return struct.pack("<I", v)


def _u64(v: int) -> bytes:
    return struct.pack("<Q", v)


def encode_transaction(tx: Transaction) -> bytes:
    out = bytearray()
    out += bytes([WIRE_VERSION, tx.version])
    out += tx.source.data
    out += _u64(tx.fee)
    out += _u64(tx.nonce)

    data = tx.data
    if isinstance(data, list):
        out += bytes([_KIND_TRANSFERS])
        out += _u16(len(data))
        for t in data:
            out += t.asset.data
            out += t.dest_pubkey.data
            out += t.amount_commitment.data
            out += t.amount_sender_handle.data
            out += t.amount_receiver_handle.data
            if t.extra_data is not None:
                out += b"\x01"
                out += _u32(len(t.extra_data.cipher.data))
                out += t.extra_data.cipher.data
                out += t.extra_data.sender_handle.data
                out += t.extra_data.receiver_handle.data
            else:
                out += b"\x00"
            out += t.ct_validity_proof.to_bytes()
    elif isinstance(data, BurnPayload):
        out += bytes([_KIND_BURN])
        out += data.asset.data
        out += _u64(data.amount)
    elif isinstance(data, SmartContractCall):
        out += bytes([_KIND_CALL])
        out += data.contract.data
        out += _u16(len(data.assets))
        for asset, amount in data.assets.items():
            out += asset.data
            out += _u64(amount)
        out += _u16(len(data.params))
        for key, value in data.params.items():
            kb, vb = key.encode(), value.encode()
            out += _u16(len(kb)) + kb + _u16(len(vb)) + vb
    elif isinstance(data, DeployContractPayload):
        out += bytes([_KIND_DEPLOY])
        cb = data.code.encode()
        out += _u32(len(cb)) + cb
    elif isinstance(data, MultiSigPayload):
        out += bytes([_KIND_MULTISIG])
        out += bytes([data.threshold, len(data.signers)])
        for signer in data.signers:
            out += signer.data
    else:  # pragma: no cover
        raise FormatError(f"unknown payload {type(data)}")

    out += bytes([len(tx.new_source_commitments)])
    for c in tx.new_source_commitments:
        out += c.asset.data
        out += c.new_source_commitment.data
        out += c.new_commitment_eq_proof.to_bytes()

    rp = tx.range_proof.to_bytes()
    out += _u32(len(rp)) + rp

    if tx.multisig is not None:
        out += bytes([1, len(tx.multisig)])
        for sig_id, sig in tx.multisig:
            out += bytes([sig_id]) + sig.to_bytes()
    else:
        out += b"\x00"

    out += tx.signature.to_bytes()
    return bytes(out)


def decode_transaction(raw: bytes) -> Transaction:
    r = _Reader(raw)
    wire_version = r.u8()
    if wire_version != WIRE_VERSION:
        raise FormatError(f"unsupported wire version {wire_version}")
    version = r.u8()
    source = CompressedPubkey(r.take(32))
    fee = r.u64()
    nonce = r.u64()

    kind = r.u8()
    if kind == _KIND_TRANSFERS:
        count = r.u16()
        transfers = []
        for _ in range(count):
            asset = Hash(r.take(32))
            dest = CompressedPubkey(r.take(32))
            commitment = CompressedCommitment(r.take(32))
            sender_handle = CompressedHandle(r.take(32))
            receiver_handle = CompressedHandle(r.take(32))
            extra = None
            if r.u8():
                clen = r.u32()
                cipher = r.take(clen)
                eh_s = CompressedHandle(r.take(32))
                eh_r = CompressedHandle(r.take(32))
                extra = ExtraData(AeCipher(cipher), eh_s, eh_r)
            proof = CiphertextValidityProof.from_bytes(r.take(160))
            transfers.append(
                Transfer(
                    asset=asset,
                    dest_pubkey=dest,
                    amount_commitment=commitment,
                    amount_sender_handle=sender_handle,
                    amount_receiver_handle=receiver_handle,
                    ct_validity_proof=proof,
                    extra_data=extra,
                )
            )
        data = transfers
    elif kind == _KIND_BURN:
        data = BurnPayload(asset=Hash(r.take(32)), amount=r.u64())
    elif kind == _KIND_CALL:
        contract = Hash(r.take(32))
        assets = {}
        for _ in range(r.u16()):
            a = Hash(r.take(32))
            assets[a] = r.u64()
        params = {}
        for _ in range(r.u16()):
            k = r.take(r.u16()).decode()
            params[k] = r.take(r.u16()).decode()
        data = SmartContractCall(contract=contract, assets=assets, params=params)
    elif kind == _KIND_DEPLOY:
        data = DeployContractPayload(code=r.take(r.u32()).decode())
    elif kind == _KIND_MULTISIG:
        threshold = r.u8()
        signers = [CompressedPubkey(r.take(32)) for _ in range(r.u8())]
        data = MultiSigPayload(signers=signers, threshold=threshold)
    else:
        raise FormatError(f"unknown payload kind {kind}")

    commitments = []
    for _ in range(r.u8()):
        asset = Hash(r.take(32))
        comm = CompressedCommitment(r.take(32))
        proof = CommitmentEqProof.from_bytes(r.take(192))
        commitments.append(
            NewSourceCommitment(
                asset=asset, new_source_commitment=comm, new_commitment_eq_proof=proof
            )
        )

    range_proof = RangeProof.from_bytes(r.take(r.u32()))

    multisig = None
    if r.u8():
        multisig = []
        for _ in range(r.u8()):
            sig_id = r.u8()
            multisig.append((sig_id, Signature.from_bytes(r.take(64))))

    signature = Signature.from_bytes(r.take(64))
    if not r.done():
        raise FormatError("trailing bytes after transaction")

    return Transaction(
        version=version,
        source=source,
        data=data,
        fee=fee,
        nonce=nonce,
        new_source_commitments=commitments,
        range_proof=range_proof,
        signature=signature,
        multisig=multisig,
    )
