"""Accelerator: the device half of block verification, on PyTorch and CUDA.

``tx/verify.py``'s native path (``_fused_native``) calls four steps of it:

1. ``begin_block_async_rows`` decompresses every encoding of the block once
   (K1); the canonical rows and valid flags stay on the device;
2. ``chunk_lanes_begin_rows`` runs once per chunk of transactions: the
   scalars are recoded to signed 4-bit digits, the lane points gathered by
   row index and packed 8 to a slot (K2), each 512-slot tile summed (K3) and
   the tiles reduced to one sigma and one range partial (K3); signature
   slots yield their R points directly;
3. ``fused_chunks_finish`` runs the shared lanes, folds in every chunk's
   partials (K2, K3), encodes the two sums and all R points (K4; a sum is
   the identity exactly when its encoding is zero) and makes the block's
   single device-to-host pull: (1 + n_sigs, 32) bytes;
4. ``block_valid_flags`` (failure diagnostics only) and ``end_block``.

Tensors live on ``device``: CUDA (the kernels) unless the caller passes
``device="cpu"``, which runs the kernels' plain versions.  Launches are
asynchronous on the current stream; uploads go from pinned memory without
blocking, so the device works on chunk k while the host folds chunk k+1.

Boundary formats (shared with verify.py): points are (n, 4, 18) limb rows
(uint32 on the host, int32 on the device), scalars (n, 32) uint8 canonical
little-endian, lane indices int32 absolute rows into [block rows | gens
rows | extras rows]; extras row 0 is the identity (lane padding), row 1 is
the Schnorr base H.
"""

from __future__ import annotations

import threading

import numpy as _np
import torch

from ..carry import rows_to_device, to_device
from ..pyref.ristretto import IDENTITY, RistrettoPoint
from . import kernels as K
from .fe import NLIMBS, from_ints_np


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _gather_rows(tables, idx: torch.Tensor) -> torch.Tensor:
    """Gather (n, 4, NLIMBS) rows addressed by ``idx`` from the logical
    concatenation of ``tables`` without materializing the concatenation:
    one clamped gather per table and a select by index range."""
    tables = [t for t in tables if t.shape[0]]
    if not tables:
        return torch.zeros((idx.shape[0], 4, NLIMBS), dtype=torch.int32, device=idx.device)
    idx = idx.to(torch.int64)
    base = 0
    out = None
    for t in tables:
        rows = t[(idx - base).clamp(0, t.shape[0] - 1)]
        out = rows if out is None else torch.where((idx >= base)[:, None, None], rows, out)
        base += t.shape[0]
    return out


def _not_in_slice(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, {item})")


class Accelerator:
    """Block-verification executor: hand-written CUDA kernels K1-K4 on the
    card, or their plain versions with ``device="cpu"``.

    ``tile`` (K3 lanes per tile) and ``qtile`` (signature slot granule) set
    the padding of the lane groups; small values keep CPU runs small."""

    backend = "torch"
    mesh = None  # as the JAX Accelerator's attribute: no sharded path in the port yet

    def __init__(self, device=None, tile: int = K.TILE, qtile: int = K.QTILE):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Accelerator() runs on a CUDA device and none is available; "
                    "pass device='cpu' for the kernels' plain versions"
                )
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for {self.device}")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.tile = tile
        self.qtile = qtile
        # per-thread block context: concurrent verify_batch calls in
        # different threads share the generator cache, not block state
        self._blk = threading.local()
        self._gens_cache: dict = {}

    # -- padding rules -----------------------------------------------------------

    def _lane_granules(self):
        """(group granule, signature granule): lane groups fill whole K3
        tiles of 8-lane slots; signature slots come in ``qtile`` steps."""
        return K.K_PACK * self.tile, self.qtile

    def _lane_granule(self, n: int) -> int:
        """Padded decompression lane count (zero encodings = the identity,
        valid): power-of-two buckets with a 3/4 step."""
        if n <= 128:
            return 128
        p2 = max(self.tile, _next_pow2(n))
        p34 = (p2 // 4) * 3
        if n <= p34 and p34 % self.tile == 0:
            return p34
        return p2

    @staticmethod
    def _round_up(n: int, granule: int = 256) -> int:
        return max(granule, ((n + granule - 1) // granule) * granule)

    @staticmethod
    def _pad_scalar_bytes(vals, n):
        if isinstance(vals, _np.ndarray):
            out = _np.zeros((n, 32), dtype=_np.uint8)
            out[: vals.shape[0]] = vals
            return out
        from .. import scalarops
        from .. import scalars as sc

        out = _np.zeros((n, 32), dtype=_np.uint8)
        if vals:
            arr = scalarops.ints_to_array([v % sc.L for v in vals])
            out[: arr.shape[0]] = arr
        return out

    # -- block context: device-resident decompressed rows ---------------------

    def _block_state(self):
        blk = self._blk
        if not hasattr(blk, "rows"):
            blk.rows = None
            blk.valid = None
            blk.n = 0
        return blk

    def begin_block_async_rows(self, enc_rows: _np.ndarray) -> None:
        """Upload the block's (n, 32) uint8 encodings and decompress them
        (K1) without waiting; rows and valid flags stay on the device."""
        blk = self._block_state()
        n = int(enc_rows.shape[0])
        padded = self._lane_granule(n) if n else 0
        data = _np.zeros((padded, 32), dtype=_np.uint8)
        data[:n] = enc_rows
        blk.rows, blk.valid = K.decompress(to_device(data, self.device))
        blk.n = n

    def block_row_base(self) -> int:
        """Device row count of the block table (where extra rows begin)."""
        blk = self._block_state()
        return int(blk.rows.shape[0]) if blk.rows is not None else 0

    def block_valid_flags(self) -> list[bool]:
        """Pull the block's valid flags (failure diagnostics only)."""
        blk = self._block_state()
        if blk.valid is None:
            return []
        return [bool(v) for v in blk.valid[: blk.n].cpu().numpy()]

    def end_block(self):
        blk = self._block_state()
        blk.rows = None
        blk.valid = None
        blk.n = 0

    # -- host rows ------------------------------------------------------------

    def _points_to_rows(self, points: list[RistrettoPoint]) -> _np.ndarray:
        """(len, 4, NLIMBS) uint32 limb rows from host point objects."""
        coords = []
        for p in points:
            coords.extend((p.X, p.Y, p.Z, p.T))
        return from_ints_np(coords).reshape(len(points), 4, NLIMBS)

    def _gens_rows(self, n_bits: int, m: int) -> torch.Tensor:
        """Device rows of the Bulletproof generators G_vec || H_vec (built
        once per aggregation size)."""
        key = (n_bits, m)
        rows = self._gens_cache.get(key)
        if rows is None:
            from ..bulletproofs.generators import BP_GENS

            pts = BP_GENS.G(n_bits, m) + BP_GENS.H(n_bits, m)
            rows = self._gens_cache[key] = rows_to_device(self._points_to_rows(pts), self.device)
        return rows

    def _resolve_lane_points(
        self, pts, lane_total: int, m_block: int, k_gens: int, extras,
        extra_ids: dict | None = None,
    ) -> _np.ndarray:
        """Mixed point list -> (lane_total,) int32 row-index array.

        Entries: int block-row indices, ("__bp_gens__", n, m) markers (the
        generator rows), or host RistrettoPoint objects (appended to
        ``extras``, deduplicated through ``extra_ids``).  ``extras`` starts
        with the identity, which pads the group."""
        extra_base = m_block + k_gens
        out = _np.empty(lane_total, dtype=_np.int32)
        w = 0
        for p in pts:
            if type(p) is int:
                out[w] = p
                w += 1
            elif isinstance(p, tuple) and p and p[0] == "__bp_gens__":
                _, nb, m = p
                k = 2 * nb * m
                out[w : w + k] = _np.arange(m_block, m_block + k, dtype=_np.int32)
                w += k
            else:
                row = extra_ids.get(id(p)) if extra_ids is not None else None
                if row is None:
                    extras.append(p)
                    row = extra_base + len(extras) - 1
                    if extra_ids is not None:
                        extra_ids[id(p)] = row
                out[w] = row
                w += 1
        assert w <= lane_total, f"{w} lanes > {lane_total}"
        out[w:] = extra_base  # identity padding
        return out

    # -- the lanes: K2 + K3 ---------------------------------------------------

    def _group_lanes(self, rows, digits, n_lanes):
        """The first ``n_lanes`` lanes (a multiple of 8) as K2 slots: sub k
        of slot s is lane 8s + k.  Returns (points (8, S, 4, 18), digits
        (8, 64, S))."""
        s = n_lanes // K.K_PACK
        pts = rows[:n_lanes].reshape(s, K.K_PACK, 4, NLIMBS).permute(1, 0, 2, 3)
        dig = digits[:, :n_lanes].reshape(K.N_WINDOWS, s, K.K_PACK).permute(2, 0, 1)
        return pts, dig

    def _two_group_sums(self, sigma_rows, range_rows):
        """Sums of two groups of rows, both padded with identities to one
        width, reduced together through K3 -> (2, 4, 18)."""
        n = max(sigma_rows.shape[0], range_rows.shape[0], 1)
        groups = []
        for r in (sigma_rows, range_rows):
            if r.shape[0] < n:
                r = torch.cat([r, K.identity_rows(n - r.shape[0], self.device)])
            groups.append(r)
        return K.sum_points(torch.stack(groups))

    def _run_chunk(self, tables, idx, scal, ns, nr, nk):
        """One chunk: [sigma | range | sig_s | sig_e] lanes -> sigma and
        range partials (4, 18) and the chunk's (nk, 4, 18) R points."""
        digits = K.recode_signed4_torch(scal)
        rows = _gather_rows(tables, idx)
        gr = ns + nr
        pts, dig = self._group_lanes(rows, digits, gr)
        if nk:
            # each signature's (s*H, -e*P) pair packs into ONE slot whose sum
            # is its R point; subs 2-7 carry zero digits (stored 8)
            h, pk = rows[gr : gr + nk], rows[gr + nk : gr + 2 * nk]
            d_zero = torch.full_like(digits[:, :nk], 8)
            pts = torch.cat([pts, torch.stack([h, pk] + [h] * (K.K_PACK - 2))], dim=1)
            dig = torch.cat(
                [dig, torch.stack([digits[:, gr : gr + nk], digits[:, gr + nk : gr + 2 * nk]]
                                  + [d_zero] * (K.K_PACK - 2))],
                dim=2,
            )
        acc = K.windowed_lanes_k8(pts.contiguous(), dig.contiguous())
        s1, s2 = ns // K.K_PACK, nr // K.K_PACK
        sums = K.tile_sums(acc[: s1 + s2], self.tile)
        t1 = s1 // self.tile
        part = self._two_group_sums(sums[:t1], sums[t1:])
        return part[0], part[1], acc[s1 + s2 :]

    def chunk_lanes_begin_rows(
        self, sigma, range_, sigs, extras_rows, floors=None
    ):
        """Dispatch one chunk's dynamic lanes without waiting.

        sigma/range_: ((n, 32) uint8 scalars, (n,) int32 absolute rows);
        sigs: (s, e_neg, pk_rows, n_sigs); extras_rows: (n_e, 4, NLIMBS)
        rows, a device tensor uploaded once per block or a numpy array,
        with row 0 the identity and row 1 the Schnorr base H.  ``floors``
        (ns, nr, nk, e_pad) are the first chunk's padded sizes."""
        from ..metrics import span

        sigma_sc, sigma_rows = sigma
        range_sc, range_rows = range_
        sig_s, sig_e, sig_rows, n_sigs = sigs
        g1, g2 = self._lane_granules()
        f_ns, f_nr, f_nk, _ = floors or (0, 0, 0, 0)
        ns = self._round_up(max(sigma_sc.shape[0], f_ns), g1)
        nr = self._round_up(max(range_sc.shape[0], f_nr), g1)
        nk = self._round_up(max(n_sigs, f_nk), g2) if (n_sigs or f_nk) else 0

        with span("fused_check.prep_chunk"):
            extra_base = self.block_row_base()  # extras_rows[0] is the identity

            def _pad_rows(rows, total):
                out = _np.full(total, extra_base, dtype=_np.int32)
                out[: rows.shape[0]] = rows
                return out

            all_scalars = _np.concatenate(
                [
                    self._pad_scalar_bytes(sigma_sc, ns),
                    self._pad_scalar_bytes(range_sc, nr),
                    self._pad_scalar_bytes(sig_s, nk),
                    self._pad_scalar_bytes(sig_e, nk),
                ]
            )
            h_rows = _np.full(nk, extra_base, dtype=_np.int32)
            h_rows[:n_sigs] = extra_base + 1  # extras_rows[1] = H
            idx_arr = _np.concatenate(
                [_pad_rows(sigma_rows, ns), _pad_rows(range_rows, nr), h_rows, _pad_rows(sig_rows, nk)]
            )
            if isinstance(extras_rows, _np.ndarray):
                extras_rows = rows_to_device(extras_rows, self.device)
            blk = self._block_state()
            tables = (blk.rows, extras_rows) if blk.rows is not None else (extras_rows,)
            sigma_acc, rng_acc, r_acc = self._run_chunk(
                tables, to_device(idx_arr, self.device), to_device(all_scalars, self.device),
                ns, nr, nk,
            )
        return {
            "sigma": sigma_acc,
            "range": rng_acc,
            "r_acc": r_acc,
            "ns": ns,
            "nr": nr,
            "nk": nk,
            "e_pad": int(extras_rows.shape[0]),
            "n_sigs": n_sigs,
        }

    def fused_chunks_finish(self, chunk_states, shared_sigma, shared_range,
                            sig_entries, sig_hash_fn=None, pre_pull_fn=None):
        """Dispatch the shared lanes, fold in every chunk's partials, encode
        the sums and R points, and pull the packed result: the block's single
        host sync.

        ``sig_hash_fn`` is called once with the concatenated real R rows
        ((total_sigs, 32) uint8) and returns bool; ``pre_pull_fn`` is host
        work overlapped with the device before the pull."""
        from ..metrics import span

        if sig_hash_fn is None:
            _not_in_slice("fused_chunks_finish without sig_hash_fn", "item 8, the Python fused path")
        sigma_sc, sigma_pts = shared_sigma
        range_sc, range_pts = shared_range
        g1, _ = self._lane_granules()
        ns_s = self._round_up(len(sigma_sc), g1)
        nr_s = self._round_up(len(range_sc), g1)

        with span("fused_check.prep_final"):
            k_gens = 0
            gens_rows = None
            for p in range_pts:
                if isinstance(p, tuple) and p and p[0] == "__bp_gens__":
                    _, nb, m = p
                    gens_rows = self._gens_rows(nb, m)
                    k_gens = int(gens_rows.shape[0])
                    break
            scal = _np.concatenate(
                [self._pad_scalar_bytes(sigma_sc, ns_s), self._pad_scalar_bytes(range_sc, nr_s)]
            )
            blk = self._block_state()
            m_block = self.block_row_base()
            extras: list[RistrettoPoint] = [IDENTITY]
            extra_ids: dict = {}
            idx_arr = _np.concatenate(
                [
                    self._resolve_lane_points(list(sigma_pts), ns_s, m_block, k_gens, extras, extra_ids),
                    self._resolve_lane_points(list(range_pts), nr_s, m_block, k_gens, extras, extra_ids),
                ]
            )
            extra_rows = rows_to_device(self._points_to_rows(extras), self.device)
            tables = [t for t in (blk.rows, gens_rows, extra_rows) if t is not None]

            digits = K.recode_signed4_torch(to_device(scal, self.device))
            rows = _gather_rows(tables, to_device(idx_arr, self.device))
            pts, dig = self._group_lanes(rows, digits, ns_s + nr_s)
            acc = K.windowed_lanes_k8(pts.contiguous(), dig.contiguous())
            sums = K.tile_sums(acc, self.tile)
            t1 = ns_s // K.K_PACK // self.tile
            # shared tiles + the chunk partials, per group
            sums2 = self._two_group_sums(
                torch.cat([sums[:t1]] + [st["sigma"][None] for st in chunk_states]),
                torch.cat([sums[t1:]] + [st["range"][None] for st in chunk_states]),
            )
            r_all = [st["r_acc"] for st in chunk_states if st["nk"]]
            enc = K.compress(torch.cat([sums2, *r_all]).contiguous())
            # flags row: sigma sum, range sum identity; every encoding valid
            ok = [(enc[0] == 0).all(), (enc[1] == 0).all()]
            if blk.valid is not None and blk.valid.numel():
                ok.append(blk.valid.min() != 0)
            else:
                ok.append(torch.ones((), dtype=torch.bool, device=self.device))
            flags = torch.zeros((1, 32), dtype=torch.uint8, device=self.device)
            flags[0, :3] = torch.stack(ok).to(torch.uint8)
            pending = torch.cat([flags, enc[2:]])
        if pre_pull_fn is not None:
            pre_pull_fn()
        with span("fused_check.pull"):
            out = pending.cpu().numpy()  # the single host sync
        all_valid = bool(out[0, 2])
        sigma_ok = bool(out[0, 0]) and all_valid
        range_ok = bool(out[0, 1]) and all_valid
        r_bytes = out[1:]
        sig_ok = all_valid
        if sig_ok:
            real = []
            row = 0
            for st in chunk_states:
                if not st["nk"]:
                    continue
                real.append(r_bytes[row : row + st["n_sigs"]])
                row += st["nk"]
            sig_ok = bool(
                sig_hash_fn(_np.concatenate(real) if real else _np.zeros((0, 32), dtype=_np.uint8))
            )
        return sigma_ok, range_ok, sig_ok

    # -- outside this slice of the port ----------------------------------------

    def msm(self, scalars, points):
        _not_in_slice("Accelerator.msm", "item 7, generic MSM with K5")

    def msm_check(self, scalars, points):
        _not_in_slice("Accelerator.msm_check", "item 7, generic MSM with K5")

    def verify_signatures(self, entries):
        _not_in_slice("Accelerator.verify_signatures", "item 9, signatures and conversions")

    def begin_block_async(self, encodings):
        _not_in_slice("Accelerator.begin_block_async", "item 8, the Python fused path")

    def begin_block_wait(self):
        _not_in_slice("Accelerator.begin_block_wait", "item 8, the Python fused path")

    def begin_block(self, encodings):
        _not_in_slice("Accelerator.begin_block", "item 8, the Python fused path")

    def chunk_lanes_begin(self, sigma, range_, sig_entries, floors=None):
        _not_in_slice("Accelerator.chunk_lanes_begin", "item 8, the Python fused path")

    def fused_block_begin(self, sigma, sig_entries):
        _not_in_slice("Accelerator.fused_block_begin", "item 8, the Python fused path")

    def fused_block_finish(self, state, range_):
        _not_in_slice("Accelerator.fused_block_finish", "item 8, the Python fused path")

    def fused_block_check(self, sigma, range_, sig_entries):
        _not_in_slice("Accelerator.fused_block_check", "item 8, the Python fused path")

    def decompress_many(self, encodings):
        _not_in_slice("Accelerator.decompress_many", "item 9, signatures and conversions")

    def decompress_many_lazy(self, encodings):
        _not_in_slice("Accelerator.decompress_many_lazy", "item 9, signatures and conversions")

    def compress_many(self, points):
        _not_in_slice("Accelerator.compress_many", "item 9, signatures and conversions")
