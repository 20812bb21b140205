"""Aggregated 64-bit range proofs with cross-proof batch verification.

Bit-exact re-derivation of the dalek bulletproofs protocol as used by the
xelis fork (SURVEY.md D6/D7; call sites xelis-he/src/tx/builder.rs:
525-533 and tx/verify.rs:504-539):

- ``prove_multiple``: aggregated proof over m values (m a power of two),
  single-party equivalent of the dealer/party MPC with byte-identical
  transcript choreography (labels V/A/S/y/z/T_1/T_2/x/t_x/t_x_blinding/
  e_blinding/w, then the inner-product argument).
- ``verify_multiple``: ONE multiscalar multiplication.
- ``verification_view`` + ``verify_batch``: the xelis fork's addition —
  folds N independent aggregated proofs into ONE random-linear-combination
  mega-MSM with shared generator slots.  This is the verification hot path
  that the TPU engine executes as a single fused MSM per block.

All group arithmetic flows through a pluggable ``msm`` callable.
"""

from __future__ import annotations

from .. import scalars
from ..errors import ProofVerificationError
from ..pyref.ristretto import RistrettoPoint, multiscalar_mul
from ..transcript import ProtocolTranscript
from .generators import BulletproofGens, PedersenGens
from .inner_product import InnerProductProof
from .util import delta, exp_iter, inner_product

L = scalars.L


def _decompress_cached(pb: bytes) -> RistrettoPoint:
    """Decompress via the block-level cache (seeded by batch verification)."""
    from ..errors import DecompressionError
    from ..types import _decompress_point

    try:
        return _decompress_point(pb)
    except DecompressionError:
        raise ProofVerificationError("range_proof", "point decompression") from None


class RangeProof:
    __slots__ = ("A", "S", "T_1", "T_2", "t_x", "t_x_blinding", "e_blinding", "ipp_proof")

    def __init__(self, A, S, T_1, T_2, t_x, t_x_blinding, e_blinding, ipp_proof):
        self.A, self.S, self.T_1, self.T_2 = A, S, T_1, T_2
        self.t_x = t_x % L
        self.t_x_blinding = t_x_blinding % L
        self.e_blinding = e_blinding % L
        self.ipp_proof = ipp_proof

    # ------------------------------------------------------------------
    # Prover
    # ------------------------------------------------------------------

    @staticmethod
    def prove_multiple(
        bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
        transcript: ProtocolTranscript,
        values: list[int],
        blindings: list[int],
        n: int,
        msm=multiscalar_mul,
    ) -> tuple["RangeProof", list[bytes]]:
        m = len(values)
        if n not in (8, 16, 32, 64):
            raise ProofVerificationError("format", "invalid bitsize")
        if m == 0 or (m & (m - 1)) != 0 or len(blindings) != m:
            raise ProofVerificationError("format", "invalid aggregation size")
        if m > bp_gens.party_capacity:
            raise ProofVerificationError("format", "exceeds generator capacity")
        for v in values:
            if not (0 <= v < (1 << n)):
                raise ProofVerificationError("format", "value out of range")

        nm = n * m
        B, B_blinding = pc_gens.B, pc_gens.B_blinding
        G_all = bp_gens.G(n, m)
        H_all = bp_gens.H(n, m)

        transcript.rangeproof_domain_separator(n, m)

        # Per-party value commitments V_j = v*B + blinding*B_blinding
        V_compressed: list[bytes] = []
        for v, b in zip(values, blindings):
            V_j = msm([v % L, b % L], [B, B_blinding]).compress()
            transcript.append_point(b"V", V_j)
            V_compressed.append(V_j)

        # Bit commitments: A = <a_L,G> + <a_R,H> + a_blinding*B_blinding
        a_L = [(values[i // n] >> (i % n)) & 1 for i in range(nm)]
        a_blinding = scalars.random_scalar()
        s_blinding = scalars.random_scalar()
        s_L = [scalars.random_scalar() for _ in range(nm)]
        s_R = [scalars.random_scalar() for _ in range(nm)]

        from .inner_product import _gens_registry_id, _packed_points, _prover_lib

        gens_id = -1
        if _prover_lib is not None:
            gens_id = _gens_registry_id(
                nm, _packed_points(G_all), _packed_points(H_all)
            )
        if gens_id >= 0:
            # A/S over the registered basis via the 8-bit table MSM
            import numpy as np

            from .. import scalarops
            from ..pyref.ristretto import _pack_pt

            bb_packed = _pack_pt(B_blinding)
            idx_a = np.fromiter(
                (i if a_L[i] else nm + i for i in range(nm)),
                dtype=np.uint32, count=nm,
            )
            sc_a = scalarops.ints_to_array(
                [1 if a_L[i] else L - 1 for i in range(nm)]
            )
            out = np.empty(32, dtype=np.uint8)
            rc = _prover_lib.xhe_gens_msm(
                gens_id, idx_a.ctypes.data, sc_a.ctypes.data, nm,
                scalarops.int_to_bytes32(a_blinding), bb_packed, 1,
                out.ctypes.data,
            )
            if rc != 0:
                raise ProofVerificationError("format", "gens msm")
            A = out.tobytes()
            idx_s = np.arange(2 * nm, dtype=np.uint32)
            sc_s = scalarops.ints_to_array(s_L + s_R)
            rc = _prover_lib.xhe_gens_msm(
                gens_id, idx_s.ctypes.data, sc_s.ctypes.data, 2 * nm,
                scalarops.int_to_bytes32(s_blinding), bb_packed, 1,
                out.ctypes.data,
            )
            if rc != 0:
                raise ProofVerificationError("format", "gens msm")
            S = out.tobytes()
        elif _prover_lib is not None and msm is multiscalar_mul:
            # basis too large for the table registry (m > 16): still native
            # Pippenger, with the packed basis blobs CACHED per (n, m) —
            # per-call _pack_pt of 2nm points dominated large-m builds
            import numpy as np

            from .. import scalarops
            from ..hashcore.curve_native import lib as _clib
            from ..pyref.ristretto import _pack_pt, _unpack_pt

            gp = np.frombuffer(
                _packed_points(G_all), dtype=np.uint8
            ).reshape(nm, 128)
            hp = np.frombuffer(
                _packed_points(H_all), dtype=np.uint8
            ).reshape(nm, 128)
            bb = np.frombuffer(_pack_pt(B_blinding), dtype=np.uint8)
            bits = np.fromiter(a_L, dtype=bool, count=nm)
            pts_a = np.empty((nm + 1, 128), dtype=np.uint8)
            pts_a[0] = bb
            pts_a[1:] = np.where(bits[:, None], gp, hp)
            sc_a = np.empty((nm + 1, 32), dtype=np.uint8)
            sc_a[0] = np.frombuffer(
                scalarops.int_to_bytes32(a_blinding), dtype=np.uint8
            )
            sc_a[1:] = np.where(
                bits[:, None],
                np.frombuffer(scalarops.int_to_bytes32(1), dtype=np.uint8),
                np.frombuffer(scalarops.int_to_bytes32(L - 1), dtype=np.uint8),
            )
            out = np.empty(128, dtype=np.uint8)
            _clib.xhe_pt_msm(
                sc_a.ctypes.data, pts_a.ctypes.data, nm + 1, out.ctypes.data
            )
            A = _unpack_pt(out.tobytes()).compress()
            pts_s = np.empty((2 * nm + 1, 128), dtype=np.uint8)
            pts_s[0] = bb
            pts_s[1 : nm + 1] = gp
            pts_s[nm + 1 :] = hp
            sc_s = np.frombuffer(
                scalarops.ints_to_array([s_blinding] + s_L + s_R), dtype=np.uint8
            ).reshape(2 * nm + 1, 32)
            _clib.xhe_pt_msm(
                sc_s.ctypes.data, pts_s.ctypes.data, 2 * nm + 1, out.ctypes.data
            )
            S = _unpack_pt(out.tobytes()).compress()
        else:
            A_sc = [a_blinding]
            A_pt = [B_blinding]
            for i in range(nm):
                if a_L[i]:
                    A_sc.append(1)
                    A_pt.append(G_all[i])
                else:
                    A_sc.append(L - 1)  # a_R[i] = -1
                    A_pt.append(H_all[i])
            A = msm(A_sc, A_pt).compress()
            S = msm([s_blinding] + s_L + s_R, [B_blinding] + G_all + H_all).compress()

        transcript.append_point(b"A", A)
        transcript.append_point(b"S", S)

        y = transcript.challenge_scalar(b"y")
        z = transcript.challenge_scalar(b"z")
        zz = z * z % L

        # l(X) and r(X) polynomial vectors — batched mod-L array ops (one
        # GIL-releasing C++ call each): the Python int comprehensions here
        # were ~100 ms/tx GIL-HELD at nm=16384, serializing build_batch's
        # workers (the round-4 16x255 build profile)
        from .. import scalarops as so
        import numpy as np

        y_pow = so.powers(y, nm)
        z_pow = so.powers(z, m)
        bits_arr = so.ints_to_array(a_L)
        sL_arr = so.ints_to_array(s_L)
        sR_arr = so.ints_to_array(s_R)
        l0 = so.sub(bits_arr, so.ints_to_array([z] * nm))
        # r0 = y^i * (a_L[i] - 1 + z) + zz * z^(i//n) * 2^(i%n)
        r0 = so.mul(y_pow, so.ints_to_array([(z - 1) % L] * nm))
        r0 = so.add(r0, so.mul(y_pow, bits_arr))
        pow2_term = so.ints_to_array(
            [zz * (1 << k) % L for k in range(n)]
        )  # one period; tile by party with z_pow factors
        zz_col = np.repeat(so.muls(z_pow, 1), n, axis=0)  # z^j per slot
        r0 = so.add(r0, so.mul(zz_col, np.tile(pow2_term, (m, 1))))
        r1 = so.mul(y_pow, sR_arr)

        t0 = so.inner(l0, r0)
        t1 = (so.inner(l0, r1) + so.inner(sL_arr, r0)) % L
        t2 = so.inner(sL_arr, r1)

        t_1_blinding = scalars.random_scalar()
        t_2_blinding = scalars.random_scalar()
        T_1 = msm([t1, t_1_blinding], [B, B_blinding]).compress()
        T_2 = msm([t2, t_2_blinding], [B, B_blinding]).compress()

        transcript.append_point(b"T_1", T_1)
        transcript.append_point(b"T_2", T_2)

        x = transcript.challenge_scalar(b"x")

        t_x = (t0 + t1 * x + t2 * x * x) % L
        t_0_blinding = so.inner(
            so.muls(z_pow, zz), so.ints_to_array([b % L for b in blindings])
        )
        t_x_blinding = (t_0_blinding + x * t_1_blinding + x * x * t_2_blinding) % L
        e_blinding = (a_blinding + x * s_blinding) % L

        transcript.append_scalar(b"t_x", t_x)
        transcript.append_scalar(b"t_x_blinding", t_x_blinding)
        transcript.append_scalar(b"e_blinding", e_blinding)

        w = transcript.challenge_scalar(b"w")
        Q = w * B

        l_vec = so.axpy_(l0.copy(), sL_arr, x)
        r_vec = so.axpy_(r0.copy(), r1, x)

        y_inv = scalars.invert(y)
        H_factors = so.powers(y_inv, nm)
        G_factors = so.ints_to_array([1] * nm)

        ipp = InnerProductProof.create(
            transcript, Q, G_factors, H_factors, G_all, H_all, l_vec, r_vec, msm=msm
        )

        proof = RangeProof(A, S, T_1, T_2, t_x, t_x_blinding, e_blinding, ipp)
        return proof, V_compressed

    # ------------------------------------------------------------------
    # Verifier
    # ------------------------------------------------------------------

    def _verification_scalars(
        self,
        transcript: ProtocolTranscript,
        value_commitments: list[bytes],
        n: int,
        bp_gens: BulletproofGens,
    ):
        """Replay the transcript and compute all MSM scalars for this proof.

        Returns (dynamic_scalars, dynamic_compressed_points, g_coeffs,
        h_coeffs, b_scalar, b_blinding_scalar) where dynamic pairs cover
        A, S, T_1, T_2, L_j, R_j, V_j and g/h cover the shared generators.
        """
        m = len(value_commitments)
        if m == 0 or (m & (m - 1)) != 0:
            raise ProofVerificationError("range_proof", "invalid aggregation size")
        if n not in (8, 16, 32, 64):
            raise ProofVerificationError("range_proof", "invalid bitsize")
        if m > bp_gens.party_capacity:
            raise ProofVerificationError("range_proof", "exceeds generator capacity")
        nm = n * m

        transcript.rangeproof_domain_separator(n, m)
        for V in value_commitments:
            # identity (dud) commitments are allowed here
            transcript.append_point(b"V", V)

        transcript.validate_and_append_point(b"A", self.A)
        transcript.validate_and_append_point(b"S", self.S)
        y = transcript.challenge_scalar(b"y")
        z = transcript.challenge_scalar(b"z")
        transcript.validate_and_append_point(b"T_1", self.T_1)
        transcript.validate_and_append_point(b"T_2", self.T_2)
        x = transcript.challenge_scalar(b"x")
        transcript.append_scalar(b"t_x", self.t_x)
        transcript.append_scalar(b"t_x_blinding", self.t_x_blinding)
        transcript.append_scalar(b"e_blinding", self.e_blinding)
        w = transcript.challenge_scalar(b"w")

        # random folding scalar (dalek uses a random c per proof)
        c = scalars.random_scalar()

        from .. import scalarops

        u_sq, u_inv_sq, s = self.ipp_proof.verification_scalars(nm, transcript)
        a, b = self.ipp_proof.a, self.ipp_proof.b

        y_inv = scalarops.invert(y)
        y_inv_pow = scalarops.powers(y_inv, nm)
        z_pow_l = exp_iter(z, m)
        zz = z * z % L
        minus_z = (-z) % L

        # g[i] = -z - a*s[i];  h[i] = z + y_inv^i*(zz*z^(i//n)*2^(i%n)
        #                                          - b*s_inv[i])
        g = scalarops.affine(s, (-a) % L, minus_z)
        h = scalarops.bp_h_vector(
            y_inv_pow, scalarops.ints_to_array(z_pow_l), s, z, zz, b, n, m
        )

        value_scalars = [c * zz % L * z_pow_l[j] % L for j in range(m)]
        basepoint_scalar = (w * (self.t_x - a * b) + c * (delta(n, m, y, z) - self.t_x)) % L
        b_blinding_scalar = (-self.e_blinding - c * self.t_x_blinding) % L

        dynamic_scalars = (
            [1, x, c * x % L, c * x % L * x % L] + u_sq + u_inv_sq + value_scalars
        )
        dynamic_points = (
            [self.A, self.S, self.T_1, self.T_2]
            + list(self.ipp_proof.L_vec)
            + list(self.ipp_proof.R_vec)
            + list(value_commitments)
        )
        return dynamic_scalars, dynamic_points, g, h, basepoint_scalar, b_blinding_scalar

    def verify_multiple(
        self,
        bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
        transcript: ProtocolTranscript,
        value_commitments: list[bytes],
        n: int,
        msm=multiscalar_mul,
    ) -> None:
        """Single-proof verification: one MSM must equal the identity."""
        from .. import scalarops

        m = len(value_commitments)
        dyn_sc, dyn_pts_b, g, h, b_sc, bb_sc = self._verification_scalars(
            transcript, value_commitments, n, bp_gens
        )
        points = [_decompress_cached(pb) for pb in dyn_pts_b]
        scalars_all = (
            dyn_sc + [b_sc, bb_sc] + scalarops.array_to_ints(g) + scalarops.array_to_ints(h)
        )
        points_all = points + [pc_gens.B, pc_gens.B_blinding] + bp_gens.G(n, m) + bp_gens.H(n, m)
        if not msm(scalars_all, points_all).is_identity():
            raise ProofVerificationError("range_proof", "verification equation")

    def verification_view(
        self, transcript: ProtocolTranscript, value_commitments: list[bytes], n: int
    ) -> "RangeProofVerificationView":
        """Capture this proof's contribution for cross-proof batching
        (xelis fork verification_view, tx/verify.rs:504-514)."""
        return RangeProofVerificationView(self, transcript, value_commitments, n)

    def _fold_native(self, transcript, value_commitments, n, bp_gens, rho, c,
                     dyn_out, g_acc, h_acc, b_acc, bb_acc) -> bool:
        """One-FFI-call transcript replay + batch-fold via the C++ engine
        (csrc/verifyfold.cpp).  Returns False if unavailable for this
        transcript (pure-Python STROBE).  Raises like the Python path on
        identity points; structural validation happens here first."""
        from ..hashcore import verifyfold_native as _vf
        from ..errors import TranscriptError

        handle = transcript.native_handle()
        if handle is None:
            return False
        m = len(value_commitments)
        if m == 0 or (m & (m - 1)) != 0:
            raise ProofVerificationError("range_proof", "invalid aggregation size")
        if n not in (8, 16, 32, 64):
            raise ProofVerificationError("range_proof", "invalid bitsize")
        if m > bp_gens.party_capacity:
            raise ProofVerificationError("range_proof", "exceeds generator capacity")
        ipp = self.ipp_proof
        lg = len(ipp.L_vec)
        if n * m == 0 or lg >= 32 or n * m != (1 << lg):
            raise ProofVerificationError("range_proof", "ipp length mismatch")

        from .. import scalarops

        pend = transcript.take_pending()
        pts = self.A + self.S + self.T_1 + self.T_2
        lr = b"".join(ipp.L_vec) + b"".join(ipp.R_vec)
        sc3 = (
            scalarops.int_to_bytes32(self.t_x)
            + scalarops.int_to_bytes32(self.t_x_blinding)
            + scalarops.int_to_bytes32(self.e_blinding)
        )
        ab = scalarops.int_to_bytes32(ipp.a) + scalarops.int_to_bytes32(ipp.b)
        V = b"".join(value_commitments)
        rc = _vf.lib.xhe_bp_fold(
            handle,
            pend, len(pend),
            pts,
            lr, lg,
            sc3,
            ab,
            V, m,
            n,
            scalarops.int_to_bytes32(rho),
            scalarops.int_to_bytes32(c),
            dyn_out.ctypes.data,
            g_acc.ctypes.data,
            h_acc.ctypes.data,
            b_acc.ctypes.data,
            bb_acc.ctypes.data,
        )
        if rc != 0:
            raise TranscriptError("point should not be the identity")
        return True

    def queue_batch_fold(self, fold, transcript, value_commitments, n, bp_gens, rho, c):
        """Deferred-mode fold: validate structure, drain the transcript's
        pending ops into the tx's native fold script, and append the BP
        record.  Returns (dyn_base, dyn_count, dyn_point_bytes).

        The drain is load-bearing: payload appends recorded AFTER the tx's
        last sigma record (burn amount/asset, multisig threshold+signers,
        contract fields — verify.rs:396-428) sit in the transcript's pending
        buffer and must enter the fold script BEFORE the BP replay, or the
        C++ engine's Fiat-Shamir state diverges and valid blocks are
        rejected."""
        from .. import scalarops

        fold.drain_ops(transcript)

        m = len(value_commitments)
        if m == 0 or (m & (m - 1)) != 0:
            raise ProofVerificationError("range_proof", "invalid aggregation size")
        if n not in (8, 16, 32, 64):
            raise ProofVerificationError("range_proof", "invalid bitsize")
        if m > bp_gens.party_capacity:
            raise ProofVerificationError("range_proof", "exceeds generator capacity")
        ipp = self.ipp_proof
        lg = len(ipp.L_vec)
        if n * m == 0 or lg >= 32 or n * m != (1 << lg):
            raise ProofVerificationError("range_proof", "ipp length mismatch")

        base = fold.add_bp(
            m, n, lg,
            b"".join(value_commitments),
            self.A + self.S + self.T_1 + self.T_2,
            b"".join(ipp.L_vec) + b"".join(ipp.R_vec),
            scalarops.int_to_bytes32(self.t_x)
            + scalarops.int_to_bytes32(self.t_x_blinding)
            + scalarops.int_to_bytes32(self.e_blinding),
            scalarops.int_to_bytes32(ipp.a) + scalarops.int_to_bytes32(ipp.b),
            scalarops.int_to_bytes32(rho),
            scalarops.int_to_bytes32(c),
        )
        pts = (
            [self.A, self.S, self.T_1, self.T_2]
            + list(ipp.L_vec)
            + list(ipp.R_vec)
            + list(value_commitments)
        )
        return base, 4 + 2 * lg + m, pts

    @staticmethod
    def verify_batch(
        views: "list[RangeProofVerificationView]",
        bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
        msm=multiscalar_mul,
        msm_check=None,
    ) -> None:
        """Fold N aggregated proofs into ONE random-linear-combination MSM.

        With ``msm_check`` (device-side identity predicate), returns the
        unevaluated check value instead of raising — the caller evaluates it
        together with other deferred checks (one host sync for the block).
        The per-proof transcript replay + scalar fold runs in the C++
        verification engine (one FFI call per proof) when available."""
        import numpy as np

        from .. import scalarops

        views = list(views)
        if not views:
            return True if msm_check is not None else None
        device = msm_check is not None

        try:
            from ..hashcore import verifyfold_native  # noqa: F401

            have_native = scalarops.HAVE_NATIVE
        except Exception:  # pragma: no cover
            have_native = False

        max_nm = max(v.n * len(v.value_commitments) for v in views)
        dyn_chunks: list[np.ndarray] = []
        dyn_scalars: list[int] = []
        dyn_points: list = []
        g_acc = np.zeros((max_nm, 32), dtype=np.uint8)
        h_acc = np.zeros((max_nm, 32), dtype=np.uint8)
        b_buf = np.zeros((1, 32), dtype=np.uint8)
        bb_buf = np.zeros((1, 32), dtype=np.uint8)
        b_acc = 0
        bb_acc = 0
        for view in views:
            m = len(view.value_commitments)
            nm = view.n * m
            rho = scalars.random_scalar()
            lg = len(view.proof.ipp_proof.L_vec)
            used_native = False
            if have_native:
                dyn = np.empty((4 + 2 * lg + m, 32), dtype=np.uint8)
                used_native = view.proof._fold_native(
                    view.transcript, view.value_commitments, view.n, bp_gens,
                    rho, scalars.random_scalar(),
                    dyn, g_acc[:nm], h_acc[:nm], b_buf, bb_buf,
                )
                if used_native:
                    dyn_chunks.append(dyn)
            if not used_native:
                dyn_sc, dyn_pts_b, g, h, b_sc, bb_sc = view.proof._verification_scalars(
                    view.transcript, view.value_commitments, view.n, bp_gens
                )
                dyn_chunks.append(
                    scalarops.muls(scalarops.ints_to_array(dyn_sc), rho)
                )
                scalarops.axpy_(g_acc[:nm], g, rho)
                scalarops.axpy_(h_acc[:nm], h, rho)
                b_acc = (b_acc + b_sc * rho) % L
                bb_acc = (bb_acc + bb_sc * rho) % L
            # dynamic point order matches the dyn scalar layout:
            # A, S, T_1, T_2, L_vec, R_vec, V_j
            proof = view.proof
            pts_b = (
                [proof.A, proof.S, proof.T_1, proof.T_2]
                + list(proof.ipp_proof.L_vec)
                + list(proof.ipp_proof.R_vec)
                + list(view.value_commitments)
            )
            if device:
                # device path: keep encodings as bytes — the accelerator
                # gathers their limbs from the block's fused decompression
                # (whose valid flags gate the accept predicate) without
                # host point construction
                dyn_points.extend(pts_b)
            else:
                dyn_points.extend(_decompress_cached(pb) for pb in pts_b)

        if b_acc or bb_acc:  # python-path contributions
            b_buf[:] = scalarops.add(b_buf, scalarops.ints_to_array([b_acc]))
            bb_buf[:] = scalarops.add(bb_buf, scalarops.ints_to_array([bb_acc]))

        n = views[0].n
        scalars_all = np.concatenate(dyn_chunks + [b_buf, bb_buf, g_acc, h_acc])
        if msm_check is not None:
            # shared generators ride a marker the accelerator expands from
            # its device-resident generator cache
            points_all = (
                dyn_points
                + [pc_gens.B, pc_gens.B_blinding]
                + [("__bp_gens__", n, max_nm // n)]
            )
            return msm_check(scalars_all, points_all)
        points_all = (
            dyn_points
            + [pc_gens.B, pc_gens.B_blinding]
            + bp_gens.G(n, max_nm // n)
            + bp_gens.H(n, max_nm // n)
        )
        if not msm(scalarops.array_to_ints(scalars_all), points_all).is_identity():
            raise ProofVerificationError("range_proof", "batch verification equation")

    # ------------------------------------------------------------------
    # Serialization (dalek RangeProof::to_bytes layout)
    # ------------------------------------------------------------------

    def to_bytes(self) -> bytes:
        return (
            self.A + self.S + self.T_1 + self.T_2
            + scalars.to_bytes(self.t_x)
            + scalars.to_bytes(self.t_x_blinding)
            + scalars.to_bytes(self.e_blinding)
            + self.ipp_proof.to_bytes()
        )

    @staticmethod
    def from_bytes(data: bytes) -> "RangeProof":
        if len(data) < 7 * 32 + 64 or (len(data) - 7 * 32 - 64) % 64 != 0:
            raise ProofVerificationError("format", "range proof length")
        t_x = scalars.from_canonical_bytes(data[128:160])
        t_x_blinding = scalars.from_canonical_bytes(data[160:192])
        e_blinding = scalars.from_canonical_bytes(data[192:224])
        if t_x is None or t_x_blinding is None or e_blinding is None:
            raise ProofVerificationError("format", "non-canonical scalar")
        return RangeProof(
            data[0:32], data[32:64], data[64:96], data[96:128],
            t_x, t_x_blinding, e_blinding,
            InnerProductProof.from_bytes(data[224:]),
        )

    def __eq__(self, other):
        return isinstance(other, RangeProof) and self.to_bytes() == other.to_bytes()


class RangeProofVerificationView:
    """A proof plus its transcript (already advanced past the tx's sigma
    appends) and commitment list, ready for verify_batch."""

    __slots__ = ("proof", "transcript", "value_commitments", "n")

    def __init__(self, proof, transcript, value_commitments, n):
        self.proof = proof
        self.transcript = transcript
        self.value_commitments = value_commitments
        self.n = n
