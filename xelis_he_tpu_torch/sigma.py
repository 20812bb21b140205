"""Sigma proofs (CommitmentEqProof, CiphertextValidityProof) + BatchCollector.

Bit-exact mirror of xelis-he/src/proofs.rs: transcript choreography,
challenge weights (1, w, w^2), per-proof random batch factors, and the shared
G/H scalar slots.  The BatchCollector accumulates every sigma proof of a batch
of transactions into ONE multiscalar multiplication (proofs.rs:40-68) — on
TPU this is executed as a single fused MSM kernel (ops.msm); the host
fallback uses pyref Pippenger.
"""

from __future__ import annotations

from . import scalars
from .errors import TranscriptError

try:  # native verification-fold engine (one FFI call per proof)
    from .hashcore.verifyfold_native import lib as _fold_lib
except Exception:  # pragma: no cover - native build unavailable
    _fold_lib = None

from .elgamal import (
    DecryptHandle,
    ElGamalCiphertext,
    ElGamalKeypair,
    ElGamalPubkey,
    H,
    PedersenCommitment,
    PedersenOpening,
)
from .errors import ProofVerificationError
from .pyref.ristretto import BASEPOINT as G, RistrettoPoint, multiscalar_mul
from .transcript import ProtocolTranscript


class DeferredTxFold:
    """One transaction's native fold script (csrc xhe_tx_fold): transcript
    op segments and proof descriptors accumulate here during pre_verify and
    execute later in ONE C++ call — many transactions' scripts run in
    parallel across a thread pool (each is serial internally, preserving
    Fiat-Shamir byte-exactness)."""

    __slots__ = ("parts", "n_out", "transcript")

    def __init__(self, transcript=None):
        self.parts: list[bytes] = []
        self.n_out = 0  # 32-byte scalars the script will emit
        self.transcript = transcript

    def drain_ops(self, transcript) -> None:
        self.transcript = transcript
        blob = transcript.take_pending()
        if blob:
            self.parts.append(b"\x00" + len(blob).to_bytes(4, "little") + blob)

    def add_eq(self, Y: bytes, zs3: bytes, bf: bytes) -> int:
        self.parts.append(b"\x01" + Y + zs3 + bf)
        base = self.n_out
        self.n_out += 9
        return base

    def add_val(self, Y: bytes, zs2: bytes, bf: bytes) -> int:
        self.parts.append(b"\x02" + Y + zs2 + bf)
        base = self.n_out
        self.n_out += 10
        return base

    def add_bp(self, m, n_bits, lg, V, pts, lr, sc3, ab, rho, c) -> int:
        self.parts.append(
            b"\x03"
            + m.to_bytes(4, "little") + n_bits.to_bytes(4, "little")
            + lg.to_bytes(4, "little")
            + V + pts + lr + sc3 + ab + rho + c
        )
        base = self.n_out
        self.n_out += 4 + 2 * lg + m
        return base

    def script(self) -> bytes:
        return b"".join(self.parts)


class BatchCollector:
    """Deferred-MSM accumulator for sigma proof verification (proofs.rs:40-68).

    ``verify()`` computes  sum(dynamic) + g_scalar*G + h_scalar*H  and accepts
    iff it is the identity.  ``msm_fn`` may be swapped for the TPU engine's
    fused MSM (signature: (scalars, points) -> RistrettoPoint).

    In DEFERRED mode (set_deferred, batched verification), scalars are not
    computed inline: points are appended with a (tx, output-slot, coeff)
    plan entry, and the native per-tx fold scripts later fill the values.
    """

    def __init__(self, msm_fn=None, wants_bytes: bool = False):
        self.dynamic_scalars: list[int] = []
        # entries are RistrettoPoint objects, or (with ``wants_bytes``)
        # 32-byte encodings already validated by the block's fused device
        # decompression — the accelerator gathers those rows on-device
        # without ever materializing host point objects
        self.dynamic_points: list = []
        self.g_scalar = 0
        self.h_scalar = 0
        self.wants_bytes = wants_bytes
        # optional encoding -> device-row resolver (the accelerator's block
        # index); when set, deferred pushes store int row indices instead of
        # bytes so the chunk dispatch resolves lanes with one vectorized
        # gather instead of a per-lane dict walk
        self.row_of = None
        self._msm = msm_fn or multiscalar_mul
        # deferred-fold state: (tx_index, DeferredTxFold) while a tx's
        # pre_verify runs; plan/plan_g/plan_h record how to resolve scalars
        # from the fold outputs
        self.deferred: tuple[int, DeferredTxFold] | None = None
        self.plan: list = []    # (tx_i, out_idx, coeff) per dynamic point
        self.plan_g: list = []  # (tx_i, out_idx, coeff) -> g_scalar
        self.plan_h: list = []

    def set_deferred(self, tx_i: int, fold: "DeferredTxFold") -> None:
        self.deferred = (tx_i, fold)

    def push_deferred(self, point, tx_i: int, out_idx: int, coeff: int) -> None:
        row_of = self.row_of
        if row_of is not None and type(point) is bytes:
            row = row_of(point)
            if row is not None:
                point = row
        self.dynamic_points.append(point)
        self.plan.append((tx_i, out_idx, coeff))

    def resolve_deferred(self, outs: list) -> None:
        """Fill dynamic_scalars / g_scalar / h_scalar from the executed fold
        outputs (outs[tx_i] = (n_out, 32) uint8 array of that tx's scalars).

        Scalars stay as a BYTE ARRAY (no int round trips): dynamic plan
        coefficients are always ±1 (homomorphic-expression terms), so the
        resolution is one gather plus a vectorized negation of the minus
        rows; g/h contributions (a few per proof) resolve as ints."""
        import numpy as _np

        from . import scalarops

        offsets = []
        total = 0
        for o in outs:
            offsets.append(total)
            total += o.shape[0]
        all_outs = _np.concatenate(outs) if outs else _np.zeros((0, 32), _np.uint8)

        idx = _np.fromiter(
            (offsets[t] + i for t, i, _ in self.plan), dtype=_np.int64,
            count=len(self.plan),
        )
        gathered = all_outs[idx]
        # expression coefficients are always ±1 (homomorphic-expression
        # terms); checked once in debug runs, not per-lane on the hot path
        assert all(c in (1, -1) for _, _, c in self.plan[:4])
        neg_rows = _np.fromiter(
            (j for j, (_, _, c) in enumerate(self.plan) if c == -1),
            dtype=_np.int64,
        )
        if neg_rows.size:
            sub = gathered[neg_rows]
            gathered[neg_rows] = scalarops.sub(
                _np.zeros_like(sub), sub
            )
        self.dynamic_scalars = gathered

        def val(t, i):
            o = outs[t]
            return int.from_bytes(o[i].tobytes(), "little")

        for t, i, c in self.plan_g:
            self.g_scalar += val(t, i) * c
        for t, i, c in self.plan_h:
            self.h_scalar += val(t, i) * c

    def resolve_deferred_chunk(
        self, outs: list, tx_lo: int, tx_hi: int, plan_lo: int, g_lo: int, h_lo: int
    ):
        """Chunked resolve_deferred (the pipelined verifier resolves and
        dispatches each tx chunk while later chunks still pre_verify).

        Processes plan[plan_lo:], plan_g[g_lo:], plan_h[h_lo:] — whose
        entries all reference txs in [tx_lo, tx_hi) — against the chunk's
        fold outputs, ACCUMULATING g/h and returning the chunk's dynamic
        scalar byte array (matching dynamic_points[plan_lo:])."""
        import numpy as _np

        from . import scalarops

        entries = self.plan[plan_lo:]
        offsets = {}
        total = 0
        for t in range(tx_lo, tx_hi):
            offsets[t] = total
            total += outs[t].shape[0]
        chunk_outs = (
            _np.concatenate([outs[t] for t in range(tx_lo, tx_hi)])
            if tx_hi > tx_lo
            else _np.zeros((0, 32), _np.uint8)
        )
        idx = _np.fromiter(
            (offsets[t] + i for t, i, _ in entries), dtype=_np.int64,
            count=len(entries),
        )
        gathered = chunk_outs[idx]
        neg_rows = _np.fromiter(
            (j for j, (_, _, c) in enumerate(entries) if c == -1), dtype=_np.int64
        )
        if neg_rows.size:
            sub = gathered[neg_rows]
            gathered[neg_rows] = scalarops.sub(_np.zeros_like(sub), sub)

        def val(t, i):
            return int.from_bytes(outs[t][i].tobytes(), "little")

        for t, i, c in self.plan_g[g_lo:]:
            self.g_scalar += val(t, i) * c
        for t, i, c in self.plan_h[h_lo:]:
            self.h_scalar += val(t, i) * c
        return gathered

    def extend(self, scalar_point_pairs) -> None:
        for s, p in scalar_point_pairs:
            self.dynamic_scalars.append(s % scalars.L)
            self.dynamic_points.append(p)

    @staticmethod
    def _resolve(p) -> RistrettoPoint:
        if isinstance(p, (bytes, bytearray)):
            from .types import _decompress_point

            return _decompress_point(bytes(p))
        return p

    def verify(self) -> bool:
        mega = self._msm(
            self.dynamic_scalars + [self.g_scalar % scalars.L, self.h_scalar % scalars.L],
            [self._resolve(p) for p in self.dynamic_points] + [G, H],
        )
        return mega.is_identity()

    def verify_deferred(self, msm_check):
        """Dispatch the identity check via ``msm_check`` (e.g. the
        accelerator's device-side predicate) without blocking."""
        return msm_check(*self.msm_inputs())

    def msm_inputs(self):
        """The collector's full (scalars, points) MSM input including the
        shared G/H slots.  Scalars may be a list[int] or an (n, 32) uint8
        array (deferred mode) — consumers accept both."""
        gh = [self.g_scalar % scalars.L, self.h_scalar % scalars.L]
        if not isinstance(self.dynamic_scalars, list):
            import numpy as _np

            from . import scalarops

            return (
                _np.concatenate([self.dynamic_scalars, scalarops.ints_to_array(gh)]),
                self.dynamic_points + [G, H],
            )
        return (
            self.dynamic_scalars + gh,
            self.dynamic_points + [G, H],
        )


def _decompress_or_fail(b: bytes, kind: str) -> RistrettoPoint:
    from .types import _decompress_point
    from .errors import DecompressionError

    try:
        return _decompress_point(b)
    except DecompressionError:
        raise ProofVerificationError(kind) from None


def _entry(b: bytes, kind: str, collector: "BatchCollector"):
    """Collector entry for a compressed encoding: the raw bytes when the
    accelerator path is active (no host point construction — the block's
    fused device decompression validates every encoding and its valid
    flags gate the single accept predicate), else a decompressed host
    point.  Invalid encodings fail verification either way (reference
    parity: decompression errors surface as proof verification errors)."""
    if collector.wants_bytes:
        return b
    return _decompress_or_fail(b, kind)


def _obj_entry(obj, collector: "BatchCollector"):
    """Collector entry for an already-decompressed wrapper object: prefer
    its compressed origin bytes when the accelerator path is active
    (validity of every block encoding is folded into the device-side
    accept predicate)."""
    if collector.wants_bytes:
        comp = getattr(obj, "compressed", None)
        if comp is not None:
            return comp
    return obj.point


def _fold_obj(obj, scale: int, collector: "BatchCollector") -> None:
    """Append ``scale * obj`` to the collector, expanding symbolic
    homomorphic combinations (elgamal.PointExpr) term-by-term so the
    combination itself is never evaluated — each atom rides the MSM as its
    own lane with coefficient ``coeff * scale``."""
    expr = getattr(obj, "_expr", None)
    if expr is not None and obj._point is None:
        if expr.g_coeff:
            collector.g_scalar += scale * expr.g_coeff
        collector.extend((c * scale, a) for c, a in expr.terms)
        return
    collector.extend(((scale, _obj_entry(obj, collector)),))


def _fold_obj_deferred(obj, tx_i: int, out_idx: int, collector: "BatchCollector") -> None:
    """Deferred-mode _fold_obj: the scale is fold output slot ``out_idx``,
    known only after the native script runs."""
    expr = getattr(obj, "_expr", None)
    if expr is not None and obj._point is None:
        if expr.g_coeff:
            collector.plan_g.append((tx_i, out_idx, expr.g_coeff))
        for c, a in expr.terms:
            collector.push_deferred(a, tx_i, out_idx, c)
        return
    collector.push_deferred(_obj_entry(obj, collector), tx_i, out_idx, 1)


class CommitmentEqProof:
    """Proves that a ciphertext (under the prover's key) and a Pedersen
    commitment commit to the same value (proofs.rs:24-223; algebra in
    SURVEY.md §2.3)."""

    __slots__ = ("Y_0", "Y_1", "Y_2", "z_s", "z_x", "z_r")

    def __init__(self, Y_0: bytes, Y_1: bytes, Y_2: bytes, z_s: int, z_x: int, z_r: int):
        self.Y_0, self.Y_1, self.Y_2 = Y_0, Y_1, Y_2
        self.z_s, self.z_x, self.z_r = z_s % scalars.L, z_x % scalars.L, z_r % scalars.L

    @staticmethod
    def new(
        source_keypair: ElGamalKeypair,
        source_ciphertext: ElGamalCiphertext,
        opening: PedersenOpening,
        amount: int,
        transcript: ProtocolTranscript,
    ) -> "CommitmentEqProof":
        transcript.equality_proof_domain_separator()

        P_source = source_keypair.pubkey().point
        D_source = source_ciphertext.handle.point

        s = source_keypair.secret().scalar
        x = amount % scalars.L
        r = opening.scalar

        y_s = scalars.random_scalar()
        y_x = scalars.random_scalar()
        y_r = scalars.random_scalar()

        Y_0 = (y_s * P_source).compress()
        Y_1 = multiscalar_mul([y_x, y_s], [G, D_source]).compress()
        Y_2 = multiscalar_mul([y_x, y_r], [G, H]).compress()

        transcript.append_point(b"Y_0", Y_0)
        transcript.append_point(b"Y_1", Y_1)
        transcript.append_point(b"Y_2", Y_2)

        c = transcript.challenge_scalar(b"c")

        z_s = (c * s + y_s) % scalars.L
        z_x = (c * x + y_x) % scalars.L
        z_r = (c * r + y_r) % scalars.L

        transcript.append_scalar(b"z_s", z_s)
        transcript.append_scalar(b"z_x", z_x)
        transcript.append_scalar(b"z_r", z_r)

        # squeeze (and discard) w to keep transcript state aligned with the
        # verifier (proofs.rs:117)
        transcript.challenge_scalar(b"w")

        return CommitmentEqProof(Y_0, Y_1, Y_2, z_s, z_x, z_r)

    def pre_verify(
        self,
        source_pubkey: ElGamalPubkey,
        source_ciphertext: ElGamalCiphertext,
        destination_commitment: PedersenCommitment,
        transcript: ProtocolTranscript,
        batch_collector: BatchCollector,
    ) -> None:
        transcript.equality_proof_domain_separator()

        # C/D of the new-balance ciphertext are symbolic homomorphic
        # combinations (state balance − fee·G − transfer terms); they are
        # expanded term-by-term into the collector below, so neither the
        # combination nor any host point is ever evaluated.  P and C_dst
        # stay as encodings on the accelerator path.
        C_source = source_ciphertext.commitment
        D_source = source_ciphertext.handle

        batch_factor = scalars.random_scalar()
        from . import scalarops

        zs3 = (
            scalarops.int_to_bytes32(self.z_s)
            + scalarops.int_to_bytes32(self.z_x)
            + scalarops.int_to_bytes32(self.z_r)
        )
        if batch_collector.deferred is not None:
            # queue into the tx's native fold script (executes later, in
            # parallel across txs); points + resolution plan recorded now
            tx_i, fold = batch_collector.deferred
            fold.drain_ops(transcript)
            base = fold.add_eq(
                self.Y_0 + self.Y_1 + self.Y_2, zs3,
                scalarops.int_to_bytes32(batch_factor),
            )
            Y_0 = _entry(self.Y_0, "commitment_eq_proof", batch_collector)
            Y_1 = _entry(self.Y_1, "commitment_eq_proof", batch_collector)
            Y_2 = _entry(self.Y_2, "commitment_eq_proof", batch_collector)
            P_entry = _obj_entry(source_pubkey, batch_collector)
            C_dst_entry = _obj_entry(destination_commitment, batch_collector)
            for off, p in zip((0, 1, 4, 5, 6), (P_entry, Y_0, Y_1, C_dst_entry, Y_2)):
                batch_collector.push_deferred(p, tx_i, base + off, 1)
            _fold_obj_deferred(D_source, tx_i, base + 2, batch_collector)
            _fold_obj_deferred(C_source, tx_i, base + 3, batch_collector)
            batch_collector.plan_g.append((tx_i, base + 7, 1))
            batch_collector.plan_h.append((tx_i, base + 8, 1))
            return

        nh = transcript.native_handle() if _fold_lib is not None else None
        if nh is not None:
            # one FFI call: transcript replay + all nine fold scalars
            import numpy as _np

            pend = transcript.take_pending()
            out = _np.empty((9, 32), dtype=_np.uint8)
            rc = _fold_lib.xhe_eq_fold(
                nh, pend, len(pend),
                self.Y_0 + self.Y_1 + self.Y_2,
                zs3,
                scalarops.int_to_bytes32(batch_factor),
                out.ctypes.data,
            )
            if rc != 0:
                raise TranscriptError("point should not be the identity")
            raw = out.tobytes()
            s = [int.from_bytes(raw[i * 32 : i * 32 + 32], "little") for i in range(9)]
            batch_collector.g_scalar += s[7]
            batch_collector.h_scalar += s[8]
        else:
            transcript.validate_and_append_point(b"Y_0", self.Y_0)
            transcript.validate_and_append_point(b"Y_1", self.Y_1)
            transcript.validate_and_append_point(b"Y_2", self.Y_2)

            c = transcript.challenge_scalar(b"c")

            transcript.append_scalar(b"z_s", self.z_s)
            transcript.append_scalar(b"z_x", self.z_x)
            transcript.append_scalar(b"z_r", self.z_r)

            w = transcript.challenge_scalar(b"w")
            ww = w * w % scalars.L

            # w*z_x*G + ww*z_x*G ; -c*H + ww*z_r*H
            batch_collector.g_scalar += (w * self.z_x + ww * self.z_x) * batch_factor
            batch_collector.h_scalar += (-c + ww * self.z_r) * batch_factor
            s = [
                self.z_s * batch_factor,
                -batch_factor,
                w * self.z_s * batch_factor,
                -w * c * batch_factor,
                -w * batch_factor,
                -ww * c * batch_factor,
                -ww * batch_factor,
            ]

        Y_0 = _entry(self.Y_0, "commitment_eq_proof", batch_collector)
        Y_1 = _entry(self.Y_1, "commitment_eq_proof", batch_collector)
        Y_2 = _entry(self.Y_2, "commitment_eq_proof", batch_collector)
        P_entry = _obj_entry(source_pubkey, batch_collector)
        C_dst_entry = _obj_entry(destination_commitment, batch_collector)

        batch_collector.extend(
            zip(
                [s[0], s[1], s[4], s[5], s[6]],
                [P_entry, Y_0, Y_1, C_dst_entry, Y_2],
            )
        )
        _fold_obj(D_source, s[2], batch_collector)
        _fold_obj(C_source, s[3], batch_collector)

    def to_bytes(self) -> bytes:
        return (
            self.Y_0 + self.Y_1 + self.Y_2
            + scalars.to_bytes(self.z_s) + scalars.to_bytes(self.z_x) + scalars.to_bytes(self.z_r)
        )

    @staticmethod
    def from_bytes(data: bytes) -> "CommitmentEqProof":
        assert len(data) == 192
        zs = [scalars.from_canonical_bytes(data[i:i + 32]) for i in (96, 128, 160)]
        if any(z is None for z in zs):
            raise ProofVerificationError("format", "non-canonical scalar")
        return CommitmentEqProof(data[0:32], data[32:64], data[64:96], *zs)


class CiphertextValidityProof:
    """Proves a transfer ciphertext is well-formed for both sender and
    receiver keys (proofs.rs:225-372)."""

    __slots__ = ("Y_0", "Y_1", "Y_2", "z_r", "z_x")

    def __init__(self, Y_0: bytes, Y_1: bytes, Y_2: bytes, z_r: int, z_x: int):
        self.Y_0, self.Y_1, self.Y_2 = Y_0, Y_1, Y_2
        self.z_r, self.z_x = z_r % scalars.L, z_x % scalars.L

    @staticmethod
    def new(
        destination_pubkey: ElGamalPubkey,
        source_pubkey: ElGamalPubkey,
        amount: int,
        opening: PedersenOpening,
        transcript: ProtocolTranscript,
    ) -> "CiphertextValidityProof":
        transcript.ciphertext_validity_proof_domain_separator()

        P_dest = destination_pubkey.point
        P_source = source_pubkey.point

        x = amount % scalars.L
        r = opening.scalar

        y_r = scalars.random_scalar()
        y_x = scalars.random_scalar()

        Y_0 = multiscalar_mul([y_r, y_x], [H, G]).compress()
        Y_1 = (y_r * P_dest).compress()
        Y_2 = (y_r * P_source).compress()

        transcript.append_point(b"Y_0", Y_0)
        transcript.append_point(b"Y_1", Y_1)
        transcript.append_point(b"Y_2", Y_2)

        c = transcript.challenge_scalar(b"c")

        z_r = (c * r + y_r) % scalars.L
        z_x = (c * x + y_x) % scalars.L

        transcript.append_scalar(b"z_r", z_r)
        transcript.append_scalar(b"z_x", z_x)

        transcript.challenge_scalar(b"w")

        return CiphertextValidityProof(Y_0, Y_1, Y_2, z_r, z_x)

    def pre_verify(
        self,
        commitment: PedersenCommitment,
        dest_pubkey: ElGamalPubkey,
        source_pubkey: ElGamalPubkey,
        dest_handle: DecryptHandle,
        source_handle: DecryptHandle,
        transcript: ProtocolTranscript,
        batch_collector: BatchCollector,
    ) -> None:
        transcript.ciphertext_validity_proof_domain_separator()

        batch_factor = scalars.random_scalar()
        from . import scalarops

        if batch_collector.deferred is not None:
            tx_i, fold = batch_collector.deferred
            fold.drain_ops(transcript)
            base = fold.add_val(
                self.Y_0 + self.Y_1 + self.Y_2,
                scalarops.int_to_bytes32(self.z_r)
                + scalarops.int_to_bytes32(self.z_x),
                scalarops.int_to_bytes32(batch_factor),
            )
            pts = [
                _obj_entry(commitment, batch_collector),
                _entry(self.Y_0, "ciphertext_validity_proof", batch_collector),
                _obj_entry(dest_pubkey, batch_collector),
                _obj_entry(dest_handle, batch_collector),
                _entry(self.Y_1, "ciphertext_validity_proof", batch_collector),
                _obj_entry(source_pubkey, batch_collector),
                _obj_entry(source_handle, batch_collector),
                _entry(self.Y_2, "ciphertext_validity_proof", batch_collector),
            ]
            for off, p in enumerate(pts):
                batch_collector.push_deferred(p, tx_i, base + off, 1)
            batch_collector.plan_g.append((tx_i, base + 8, 1))
            batch_collector.plan_h.append((tx_i, base + 9, 1))
            return

        nh = transcript.native_handle() if _fold_lib is not None else None
        if nh is not None:
            import numpy as _np

            pend = transcript.take_pending()
            out = _np.empty((10, 32), dtype=_np.uint8)
            rc = _fold_lib.xhe_validity_fold(
                nh, pend, len(pend),
                self.Y_0 + self.Y_1 + self.Y_2,
                scalarops.int_to_bytes32(self.z_r)
                + scalarops.int_to_bytes32(self.z_x),
                scalarops.int_to_bytes32(batch_factor),
                out.ctypes.data,
            )
            if rc != 0:
                raise TranscriptError("point should not be the identity")
            raw = out.tobytes()
            s = [int.from_bytes(raw[i * 32 : i * 32 + 32], "little") for i in range(10)]
            batch_collector.g_scalar += s[8]
            batch_collector.h_scalar += s[9]
        else:
            transcript.validate_and_append_point(b"Y_0", self.Y_0)
            transcript.validate_and_append_point(b"Y_1", self.Y_1)
            transcript.validate_and_append_point(b"Y_2", self.Y_2)

            c = transcript.challenge_scalar(b"c")

            transcript.append_scalar(b"z_r", self.z_r)
            transcript.append_scalar(b"z_x", self.z_x)

            w = transcript.challenge_scalar(b"w")

            batch_collector.g_scalar += self.z_x * batch_factor
            batch_collector.h_scalar += self.z_r * batch_factor

            w_z_r = w * self.z_r % scalars.L
            w_neg_c = -w * c % scalars.L
            s = [
                -c * batch_factor,
                -batch_factor,
                w_z_r * batch_factor,
                w_neg_c * batch_factor,
                -w * batch_factor,
                w * w_z_r * batch_factor,
                w * w_neg_c * batch_factor,
                -w * w * batch_factor,
            ]

        Y_0 = _entry(self.Y_0, "ciphertext_validity_proof", batch_collector)
        Y_1 = _entry(self.Y_1, "ciphertext_validity_proof", batch_collector)
        Y_2 = _entry(self.Y_2, "ciphertext_validity_proof", batch_collector)

        batch_collector.extend(
            zip(
                s[:8],
                [
                    _obj_entry(commitment, batch_collector),
                    Y_0,
                    _obj_entry(dest_pubkey, batch_collector),
                    _obj_entry(dest_handle, batch_collector),
                    Y_1,
                    _obj_entry(source_pubkey, batch_collector),
                    _obj_entry(source_handle, batch_collector),
                    Y_2,
                ],
            )
        )

    def to_bytes(self) -> bytes:
        return (
            self.Y_0 + self.Y_1 + self.Y_2
            + scalars.to_bytes(self.z_r) + scalars.to_bytes(self.z_x)
        )

    @staticmethod
    def from_bytes(data: bytes) -> "CiphertextValidityProof":
        assert len(data) == 160
        zs = [scalars.from_canonical_bytes(data[i:i + 32]) for i in (96, 128)]
        if any(z is None for z in zs):
            raise ProofVerificationError("format", "non-canonical scalar")
        return CiphertextValidityProof(data[0:32], data[32:64], data[64:96], *zs)
