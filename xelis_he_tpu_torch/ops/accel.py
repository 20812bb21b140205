"""Accelerator: the device half of verification, on PyTorch and CUDA.

Block verification.  ``tx/verify.py`` drives it in four steps, from its
native path (``_fused_native``, lanes as ready arrays: the ``*_rows`` entry
points) or its Python path (``_fused_deferred``, lanes as scalars and point
lists):

1. ``begin_block_async[_rows]`` decompresses every encoding of the block once
   (K1); the canonical rows and valid flags stay on the device;
2. ``chunk_lanes_begin[_rows]`` runs once per chunk of transactions: the
   scalars are recoded to signed 4-bit digits, the lane points gathered by
   row index and packed 8 to a slot (K2), each 512-slot tile summed (K3) and
   the tiles reduced to one sigma and one range partial (K3); signature
   slots yield their R points directly;
3. ``fused_chunks_finish`` runs the shared lanes, folds in every chunk's
   partials (K2, K3), encodes the two sums and all R points (K4; a sum is
   the identity exactly when its encoding is zero) and makes the block's
   single device-to-host pull: (1 + n_sigs, 32) bytes;
4. ``block_valid_flags`` (failure diagnostics only) and ``end_block``.

Where the fold library (hashcore/verifyfold_native) does not load,
``verify_batch`` takes the fused block check instead of steps 2-3:
``fused_block_begin`` dispatches the sigma and signature lanes (K5) while the
host folds the range proofs, and ``fused_block_finish`` dispatches the range
lanes (K5), sums the groups and each signature's two lanes (K3), encodes the
sums and R points (K4) and makes the block's one pull; ``fused_block_check``
is the two in one dispatch.

Two switches change the lane kernel of steps 2 and 3, as in the JAX package:
``quad_lanes=False`` (``XELIS_QUAD_LANES=0``) runs every lane through the
single-lane kernel K5, each signature's R point being its s-lane plus its
e-lane (K3 at tile 2); ``fe15=True`` (``XELIS_FE13=0``) runs the packed
lanes on the 15-bit field tier (K6 in K2's place).

Outside a block: ``msm`` / ``msm_check`` (a drop-in for pyref's
``multiscalar_mul``: K2 when the padded lane count fills whole packed tiles,
else K5; then K3), ``verify_signatures`` (the signature slots, K4, one pull),
``compress_many`` (K4) and ``decompress_many[_lazy]`` (K1).

Tensors live on ``device``: CUDA (the kernels) unless the caller passes
``device="cpu"``, which runs the kernels' plain versions.  With ``mesh=``
(parallel.mesh.make_mesh) every lane-kernel launch (K2, K6, K5) is split
along its slot or lane axis into one contiguous shard per mesh entry, each
launched on its own device; the outputs are concatenated on the first
device, where K3, K4 and the one pull run as without a mesh.  Launches are
asynchronous on the current stream; uploads go from pinned memory without
blocking, so the device works on chunk k while the host folds chunk k+1.

Boundary formats (shared with verify.py): points are (n, 4, 18) limb rows
(uint32 on the host, int32 on the device), scalars (n, 32) uint8 canonical
little-endian, lane indices int32 absolute rows into [block rows | gens
rows | extras rows]; extras row 0 is the identity (lane padding), row 1 is
the Schnorr base H on the native path.
"""

from __future__ import annotations

import hashlib
import os
import threading

import numpy as _np
import torch

from ..carry import rows_to_device, to_device
from ..pyref.ristretto import IDENTITY, RistrettoPoint
from . import kernels as K
from .fe import NLIMBS, from_ints_np, to_ints


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


class _LazyEncodings:
    """len()-able stand-in for the block's encoding list on the native path:
    the (n, 32) array is kept, and bytes objects are made only if a consumer
    iterates."""

    __slots__ = ("rows",)

    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return int(self.rows.shape[0])

    def __iter__(self):
        return (r.tobytes() for r in self.rows)


def _as_point(p):
    """A signature entry's public key (32-byte encoding, compressed key or
    point) as a host point."""
    if isinstance(p, (bytes, bytearray)):
        from ..types import _decompress_point

        return _decompress_point(bytes(p))
    return p.point if hasattr(p, "point") else p


def _challenge_matches(entry, r_bytes) -> bool:
    """The Schnorr check on the host: e == H(pubkey || message || R)."""
    from .. import scalars as sc

    sig, _pt, pk_compressed, message = entry
    h = hashlib.sha3_512()
    h.update(pk_compressed.data)
    h.update(message)
    h.update(bytes(r_bytes))
    return sc.from_bytes_mod_order_wide(h.digest()) == sig.e


class Accelerator:
    """Verification executor: the hand-written CUDA kernels K1-K7 on the
    card (K8 serves ``ecdlp``), or their plain versions with
    ``device="cpu"``.

    ``tile`` (K3 lanes per tile) and ``qtile`` (signature slot granule) set
    the padding of the lane groups; small values keep CPU runs small.
    ``quad_lanes`` and ``fe15`` pick the lane kernel (module docstring); left
    at None they read ``XELIS_QUAD_LANES`` and ``XELIS_FE13`` at each use, as
    the JAX package's ``use_quad`` and ``use_fe13`` do.  ``mesh`` shards the
    lane kernels (module docstring); the accelerator's device is then the
    mesh's first, and the lane granules grow by the mesh's size."""

    backend = "torch"

    def __init__(self, device=None, tile: int = K.TILE, qtile: int = K.QTILE,
                 quad_lanes: bool | None = None, fe15: bool | None = None, mesh=None):
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first device {mesh.devices[0]}")
            device = mesh.devices[0]
        self.mesh = mesh
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
        self._quad_lanes = quad_lanes
        self._fe15 = fe15
        # per-thread block context: concurrent verify_batch calls in
        # different threads share the generator cache, not block state
        self._blk = threading.local()
        self._gens_cache: dict = {}

    # -- the lane-kernel switches ----------------------------------------------

    @property
    def use_quad(self) -> bool:
        """Packed lanes (8 scalar-muls share one accumulator's doubling
        chain): on by default, ``XELIS_QUAD_LANES=0`` reverts to the
        single-lane kernel K5."""
        if self._quad_lanes is not None:
            return self._quad_lanes
        return os.environ.get("XELIS_QUAD_LANES", "1") != "0"

    @property
    def use_fe15(self) -> bool:
        """Packed lanes on the 15-bit field tier (K6): off by default,
        ``XELIS_FE13=0`` turns it on."""
        if self._fe15 is not None:
            return self._fe15
        return os.environ.get("XELIS_FE13", "1") != "1"

    def _packed_lanes(self, pts: torch.Tensor, dig: torch.Tensor) -> torch.Tensor:
        """(8, S, 4, 18) points and (8, 64, S) digits -> (S, 4, 18) slot sums
        through K2, or K6 under ``use_fe15``; sharded over the slots with a
        mesh."""
        lanes = K.windowed_lanes_k8_fe15 if self.use_fe15 else K.windowed_lanes_k8
        return self._sharded(lanes, pts, dig, 1, 2)

    def _single_lane_sums(self, rows: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
        """(N, 4, 18) points and (64, N) digits -> (N, 4, 18) lanes s_i P_i
        through K5; sharded over the lanes with a mesh."""
        return self._sharded(K.windowed_lanes, rows, digits, 0, 1)

    @property
    def _shards(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    def _sharded(self, kernel, pts: torch.Tensor, dig: torch.Tensor, pts_axis: int, dig_axis: int):
        """``kernel(pts, dig)`` without a mesh; with one, on mesh.size
        contiguous shards of the slot or lane axis (``pts_axis`` of the
        points, ``dig_axis`` of the digits), each launched on its own mesh
        device before any output is gathered, the outputs concatenated on
        this accelerator's device in shard order (the counterpart of the JAX
        package's shard_map with an all_gather, pallas_msm.py
        make_sharded_lanes_fn)."""
        if self.mesh is None:
            return kernel(pts.contiguous(), dig.contiguous())
        n, d = pts.shape[pts_axis], self.mesh.size
        if n % d:
            raise ValueError(f"{n} lanes do not split into {d} equal shards: the lane granules keep them whole")
        step = n // d
        outs = [
            kernel(pts.narrow(pts_axis, i * step, step).to(dev).contiguous(),
                   dig.narrow(dig_axis, i * step, step).to(dev).contiguous())
            for i, dev in enumerate(self.mesh.devices)
        ]
        return torch.cat([o.to(self.device) for o in outs])

    # -- padding rules -----------------------------------------------------------

    def _lane_granules(self):
        """(group granule, signature granule).  Packed: lane groups fill
        whole K3 tiles of 8-lane slots and signature slots come in ``qtile``
        steps.  Single-lane: groups fill whole tiles of lanes, and the two
        lanes of each signature fill a tile together."""
        if self.use_quad:
            return self._shards * K.K_PACK * self.tile, self._shards * self.qtile
        return self._single_lane_granules()

    def _single_lane_granules(self):
        """Both grow by the mesh's size, as the JAX package's
        ``_pallas_lane_granules``: every shard holds whole tiles."""
        d = self._shards
        return d * self.tile, max(1, d * self.tile // 2)

    def _lane_granule(self, n: int) -> int:
        """Padded lane count of a generic MSM (``_msm_rows``; pad lanes hold
        the identity with zero scalars): power-of-two buckets with a 3/4
        step, so that large counts fill whole packed tiles, then a multiple
        of the mesh's size."""
        if n <= 128:
            padded = 128
        else:
            p2 = max(self.tile, _next_pow2(n))
            p34 = (p2 // 4) * 3
            padded = p34 if n <= p34 and p34 % self.tile == 0 else p2
        return -(-padded // self._shards) * self._shards

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
        """Per-thread block context: device rows and valid flags, the count
        of real encodings, whether a pull is still owed (``pending``), the
        encodings and the encoding -> row map of the Python path."""
        blk = self._blk
        if not hasattr(blk, "rows"):
            self._clear_block(blk)
        return blk

    @staticmethod
    def _clear_block(blk) -> None:
        blk.rows = None
        blk.valid = None
        blk.n = 0
        blk.pending = False
        blk.encodings = []
        blk.index = {}

    def _decompress(self, enc_rows: _np.ndarray):
        """(n, 32) uint8 encodings -> K1's device (rows, valid), launched on
        exactly the n encodings (the kernel masks its ragged edge)."""
        return K.decompress(to_device(enc_rows, self.device))

    @staticmethod
    def _encoding_rows(encodings) -> _np.ndarray:
        # writable (bytearray): torch.from_numpy warns on a read-only buffer
        return _np.frombuffer(bytearray(b"".join(encodings)), dtype=_np.uint8).reshape(len(encodings), 32)

    def begin_block_async_rows(self, enc_rows: _np.ndarray) -> None:
        """Upload the block's (n, 32) uint8 encodings and decompress them
        (K1) without waiting; rows and valid flags stay on the device.  The
        native path resolves lanes to row indices itself, so no encoding ->
        row map is built."""
        blk = self._block_state()
        n = int(enc_rows.shape[0])
        if n == 0:
            self._clear_block(blk)
            return
        blk.rows, blk.valid = self._decompress(enc_rows)
        blk.n = n
        blk.pending = True
        blk.encodings = _LazyEncodings(enc_rows)
        blk.index = None

    def begin_block_async(self, encodings: list[bytes]) -> None:
        """Upload the block's encodings and decompress them (K1) without
        waiting: the device computes while the caller does host work, and
        ``begin_block_wait`` then costs one pull.  The encoding -> row map is
        known at dispatch time; rows of invalid encodings hold the identity
        and the valid flags reject the block."""
        blk = self._block_state()
        if not encodings:
            self._clear_block(blk)
            return
        blk.rows, blk.valid = self._decompress(self._encoding_rows(encodings))
        blk.n = len(encodings)
        blk.pending = True
        blk.encodings = encodings
        blk.index = {e: i for i, e in enumerate(encodings)}

    def begin_block_wait(self):
        """Pull the block's decompression (one host sync: rows and valid
        flags packed into one tensor) and rebuild the encoding -> row map
        from the valid encodings.  Returns ((n, 4, 18) uint32 rows, valid
        flags) for host-side cache seeding."""
        blk = self._block_state()
        if not blk.pending:
            return _np.zeros((0, 4, NLIMBS), dtype=_np.uint32), []
        blk.pending = False
        rows_np, valid_np = self._pull_decompressed(blk.rows, blk.valid, blk.n)
        blk.index = {e: i for i, (e, ok) in enumerate(zip(blk.encodings, valid_np)) if ok}
        return rows_np, valid_np

    def begin_block(self, encodings: list[bytes]):
        """Decompress every encoding of a block in one device call and keep
        the rows on the device; MSM point inputs are later gathered from them
        by index.  Returns (rows, valid) like ``decompress_many_lazy``."""
        self.begin_block_async(encodings)
        return self.begin_block_wait()

    @staticmethod
    def _pull_decompressed(rows: torch.Tensor, valid: torch.Tensor, n: int):
        """One device-to-host pull of K1's first ``n`` rows with their valid
        flags as a 73rd column."""
        packed = torch.cat([rows[:n].reshape(n, 4 * NLIMBS), valid[:n, None].to(torch.int32)], dim=1)
        out = packed.cpu().numpy()
        rows_np = out[:, : 4 * NLIMBS].reshape(n, 4, NLIMBS).astype(_np.uint32)
        return rows_np, [bool(v) for v in out[:, 4 * NLIMBS]]

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
        self._clear_block(self._block_state())

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

        Entries: int block-row indices (the common case, resolved at push
        time by the deferred collector: one vectorized ``np.fromiter``),
        32-byte encodings (looked up in the block index, else decompressed on
        the host into ``extras``: raising on invalid data keeps the
        reference's error behaviour), ("__bp_gens__", n, m) markers (the
        generator rows), or host RistrettoPoint objects (appended to
        ``extras``, deduplicated through ``extra_ids``).  ``extras`` starts
        with the identity, which pads the group."""
        from ..types import _decompress_point

        extra_base = m_block + k_gens
        n = len(pts)
        out = _np.empty(lane_total, dtype=_np.int32)
        if n:
            try:
                out[:n] = _np.fromiter(pts, dtype=_np.int32, count=n)
                out[n:] = extra_base  # identity padding (extras[0])
                return out
            except (TypeError, ValueError):
                pass
        block_index = self._block_state().index or {}
        w = 0
        for p in pts:
            if type(p) is int:
                out[w] = p
                w += 1
            elif isinstance(p, (bytes, bytearray)):
                i = block_index.get(bytes(p))
                if i is not None:
                    out[w] = i
                elif bytes(p) == bytes(32):
                    out[w] = extra_base  # extras[0] is the identity
                else:
                    extras.append(_decompress_point(bytes(p)))
                    out[w] = extra_base + len(extras) - 1
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

    # -- the lanes: K2 (or K6, or K5) + K3 ------------------------------------------

    def _group_lanes(self, rows, digits, n_lanes):
        """The first ``n_lanes`` lanes (a multiple of 8) as packed slots: sub
        k of slot s is lane 8s + k.  Returns (points (8, S, 4, 18), digits
        (8, 64, S))."""
        s = n_lanes // K.K_PACK
        pts = rows[:n_lanes].reshape(s, K.K_PACK, 4, NLIMBS).permute(1, 0, 2, 3)
        dig = digits[:, :n_lanes].reshape(K.N_WINDOWS, s, K.K_PACK).permute(2, 0, 1)
        return pts, dig

    @staticmethod
    def _sig_slots(h, pk, d_s, d_e):
        """Each signature's (s*H, -e*P) pair as ONE packed slot whose sum is
        its R point; subs 2-7 carry zero digits (stored 8).  ``h``, ``pk``:
        (nk, 4, 18) rows; ``d_s``, ``d_e``: (64, nk) digits."""
        d_zero = torch.full_like(d_s, 8)
        pts = torch.stack([h, pk] + [h] * (K.K_PACK - 2))
        dig = torch.stack([d_s, d_e] + [d_zero] * (K.K_PACK - 2))
        return pts, dig

    @staticmethod
    def _pair_sums(s_lanes, e_lanes):
        """R = s-lane + e-lane per signature, through K3 at tile 2."""
        nk = s_lanes.shape[0]
        if nk == 0:
            return s_lanes
        pairs = torch.stack([s_lanes, e_lanes], dim=1).reshape(2 * nk, 4, NLIMBS)
        return K.tile_sums(pairs.contiguous(), 2)

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

    def _run_lanes(self, tables, idx, scal, ns, nr, nk):
        """[sigma | range | sig_s | sig_e] lanes (ns + nr + 2 nk of them) ->
        the sigma and range sums (2, 4, 18) and the (nk, 4, 18) R points.

        Packed (``use_quad``): the groups as 8-lane slots and each
        signature's pair as one slot, in one launch of K2 (or K6); K3 sums
        the slot tiles.  Single-lane: one launch of K5 over every lane; K3
        sums the lane tiles and adds each signature's two lanes."""
        digits = K.recode_signed4_torch(scal)
        rows = _gather_rows(tables, idx)
        if not self.use_quad:
            return self._lane_sums(self._single_lane_sums(rows, digits), ns, nr, nk)
        gr = ns + nr
        pts, dig = self._group_lanes(rows, digits, gr)
        if nk:
            s_pts, s_dig = self._sig_slots(rows[gr : gr + nk], rows[gr + nk :],
                                           digits[:, gr : gr + nk], digits[:, gr + nk :])
            pts, dig = torch.cat([pts, s_pts], dim=1), torch.cat([dig, s_dig], dim=2)
        acc = self._packed_lanes(pts, dig)
        sums = K.tile_sums(acc[: gr // K.K_PACK], self.tile)
        t1 = ns // K.K_PACK // self.tile
        return self._two_group_sums(sums[:t1], sums[t1:]), acc[gr // K.K_PACK :]

    def _lane_sums(self, acc, ns, nr, nk):
        """Single-lane accumulators [sigma | range | sig_s | sig_e] -> the
        sigma and range sums (2, 4, 18) (K3 over the lane tiles, then the
        group sums) and the (nk, 4, 18) R points (K3 at tile 2)."""
        gr = ns + nr
        sums = K.tile_sums(acc[:gr], self.tile)
        t1 = ns // self.tile
        return self._two_group_sums(sums[:t1], sums[t1:]), self._pair_sums(acc[gr : gr + nk], acc[gr + nk :])

    def _dispatch_chunk(self, idx_arr, all_scalars, extras_rows, ns, nr, nk, n_sigs):
        """Upload one chunk's lane indices and scalars, run its lanes, and
        return the handle ``fused_chunks_finish`` takes."""
        blk = self._block_state()
        tables = (blk.rows, extras_rows) if blk.rows is not None else (extras_rows,)
        part, r_acc = self._run_lanes(
            tables, to_device(idx_arr, self.device), to_device(all_scalars, self.device), ns, nr, nk
        )
        return {
            "sigma": part[0],
            "range": part[1],
            "r_acc": r_acc,
            "ns": ns,
            "nr": nr,
            "nk": nk,
            "e_pad": int(extras_rows.shape[0]),
            "n_sigs": n_sigs,
        }

    def _chunk_sizes(self, n_sigma, n_range, n_sigs, floors):
        """Padded lane counts (ns, nr, nk) of a chunk; ``floors`` (ns, nr,
        nk, e_pad) are the first chunk's, which later chunks do not go
        below."""
        g1, g2 = self._lane_granules()
        f_ns, f_nr, f_nk, _ = floors or (0, 0, 0, 0)
        ns = self._round_up(max(n_sigma, f_ns), g1)
        nr = self._round_up(max(n_range, f_nr), g1)
        nk = self._round_up(max(n_sigs, f_nk), g2) if (n_sigs or f_nk) else 0
        return ns, nr, nk

    def chunk_lanes_begin(self, sigma, range_, sig_entries, floors=None):
        """Dispatch one chunk's dynamic lanes without waiting.  Returns an
        opaque handle for ``fused_chunks_finish``.

        sigma/range_: (scalars, points) with points as block-row indices,
        32-byte encodings or host points (no generator markers: shared lanes
        go in the final combine); sig_entries: this chunk's (signature,
        pubkey, compressed, message) tuples."""
        from ..metrics import span

        sigma_sc, sigma_pts = sigma
        range_sc, range_pts = range_
        n_sigs = len(sig_entries)
        ns, nr, nk = self._chunk_sizes(len(sigma_sc), len(range_sc), n_sigs, floors)
        with span("fused_check.prep_chunk"):
            tables, idx_arr, all_scalars = self._lane_layout(
                [(sigma_pts, ns, sigma_sc), (range_pts, nr, range_sc), *self._sig_groups(sig_entries, nk)]
            )
            return self._dispatch_chunk(idx_arr, all_scalars, tables[-1], ns, nr, nk, n_sigs)

    def chunk_lanes_begin_rows(
        self, sigma, range_, sigs, extras_rows, floors=None
    ):
        """``chunk_lanes_begin`` for the native path: lanes arrive as ready
        arrays in final lane order, with no per-lane Python resolution.

        sigma/range_: ((n, 32) uint8 scalars, (n,) int32 absolute rows);
        sigs: (s, e_neg, pk_rows, n_sigs); extras_rows: (n_e, 4, NLIMBS)
        rows, a device tensor uploaded once per block or a numpy array,
        with row 0 the identity and row 1 the Schnorr base H."""
        from ..metrics import span

        sigma_sc, sigma_rows = sigma
        range_sc, range_rows = range_
        sig_s, sig_e, sig_rows, n_sigs = sigs
        ns, nr, nk = self._chunk_sizes(sigma_sc.shape[0], range_sc.shape[0], n_sigs, floors)

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
            return self._dispatch_chunk(idx_arr, all_scalars, extras_rows, ns, nr, nk, n_sigs)

    def fused_chunks_finish(self, chunk_states, shared_sigma, shared_range,
                            sig_entries, sig_hash_fn=None, pre_pull_fn=None):
        """Dispatch the shared lanes, fold in every chunk's partials, encode
        the sums and R points, and pull the packed result: the block's single
        host sync.

        The signatures' challenges are then hashed on the host: by
        ``sig_hash_fn`` (the native path), called once with the concatenated
        real R rows ((total_sigs, 32) uint8) and returning bool, or else one
        by one from ``sig_entries``.  ``pre_pull_fn`` is host work overlapped
        with the device before the pull."""
        from ..metrics import span

        sigma_sc, sigma_pts = shared_sigma
        range_sc, range_pts = shared_range
        g1, _ = self._lane_granules()
        ns_s = self._round_up(len(sigma_sc), g1)
        nr_s = self._round_up(len(range_sc), g1)

        with span("fused_check.prep_final"):
            tables, idx_arr, scal = self._lane_layout(
                [(sigma_pts, ns_s, sigma_sc), (range_pts, nr_s, range_sc)], self._gens_of(range_pts)
            )

            shared, _ = self._run_lanes(
                tables, to_device(idx_arr, self.device), to_device(scal, self.device), ns_s, nr_s, 0
            )
            # the shared sums + the chunk partials, per group
            sums2 = self._two_group_sums(
                torch.cat([shared[:1]] + [st["sigma"][None] for st in chunk_states]),
                torch.cat([shared[1:]] + [st["range"][None] for st in chunk_states]),
            )
            pending = self._packed_result(sums2, [st["r_acc"] for st in chunk_states if st["nk"]])
        if pre_pull_fn is not None:
            pre_pull_fn()
        sigma_ok, range_ok, sig_ok, r_bytes = self._pull_result(pending)
        if sig_ok:
            real = []
            row = 0
            for st in chunk_states:
                if not st["nk"]:
                    continue
                real.append(r_bytes[row : row + st["n_sigs"]])
                row += st["nk"]
            real = _np.concatenate(real) if real else _np.zeros((0, 32), dtype=_np.uint8)
            if sig_hash_fn is not None:
                sig_ok = bool(sig_hash_fn(real))
            else:
                sig_ok = all(_challenge_matches(e, r) for e, r in zip(sig_entries, real))
        return sigma_ok, range_ok, sig_ok

    def _packed_result(self, sums2, r_points) -> torch.Tensor:
        """K4 on the two group sums and the R points -> the block's result,
        still on the device: a flags row (sigma sum identity, range sum
        identity, every block encoding valid), then the R encodings."""
        blk = self._block_state()
        enc = K.compress(torch.cat([sums2, *r_points]).contiguous())
        ok = [(enc[0] == 0).all(), (enc[1] == 0).all()]
        if blk.valid is not None and blk.valid.numel():
            ok.append(blk.valid.min() != 0)
        else:
            ok.append(torch.ones((), dtype=torch.bool, device=self.device))
        flags = torch.zeros((1, 32), dtype=torch.uint8, device=self.device)
        flags[0, :3] = torch.stack(ok).to(torch.uint8)
        return torch.cat([flags, enc[2:]])

    @staticmethod
    def _pull_result(pending: torch.Tensor):
        """The block's single host sync: pull ``_packed_result``'s rows.
        Returns (sigma_ok, range_ok, all encodings valid, R encodings)."""
        from ..metrics import span

        with span("fused_check.pull"):
            out = pending.cpu().numpy()
        all_valid = bool(out[0, 2])
        return bool(out[0, 0]) and all_valid, bool(out[0, 1]) and all_valid, all_valid, out[1:]

    # -- the fused block check without the fold library ------------------------
    #
    # The Python block path of builds where hashcore/verifyfold_native does
    # not load: ``fused_block_begin`` dispatches the sigma and signature
    # lanes right after pre_verify, so the device runs them while the host
    # folds the range proofs; ``fused_block_finish`` dispatches the range
    # lanes, combines them with the first phase's lanes on the device and
    # makes the block's one pull.  ``fused_block_check`` does both in one
    # dispatch.  Every lane goes through the single-lane kernel K5 (the
    # reference's ``_lanes_fn``, whatever ``use_quad`` says), each group
    # padded to whole K3 tiles of ``tile`` lanes and the signatures to half
    # a tile; K3 sums the tiles and the groups and adds each signature's two
    # lanes; K4 encodes the sums and the R points.

    @staticmethod
    def _sig_lanes(sig_entries):
        """Signature scalars (s, (-e) mod L) and public-key points of
        ``sig_entries``."""
        from .. import scalars as sc

        sig_s = [e[0].s for e in sig_entries]
        sig_e = [(-e[0].e) % sc.L for e in sig_entries]
        sig_pts = [
            e[1] if isinstance(e[1], (bytes, bytearray)) or not hasattr(e[1], "point") else e[1].point
            for e in sig_entries
        ]
        return sig_s, sig_e, sig_pts

    def _sig_groups(self, sig_entries, nk):
        """The signature lanes as two ``_lane_layout`` groups of ``nk`` lanes:
        (H, s) and (public key, (-e) mod L)."""
        from ..elgamal import H as _H

        sig_s, sig_e, sig_pts = self._sig_lanes(sig_entries)
        return [([_H] * len(sig_entries), nk, sig_s), (sig_pts, nk, sig_e)]

    def _gens_of(self, range_pts):
        """The generator rows a ``("__bp_gens__", n, m)`` marker among the
        range points stands for (None without one)."""
        for p in range_pts:
            if isinstance(p, tuple) and p and p[0] == "__bp_gens__":
                _, nb, m = p
                return self._gens_rows(nb, m)
        return None

    def _lane_layout(self, groups, gens_rows=None):
        """The lanes of ``groups`` [(points, lanes, scalars), ...] one group
        after another, each padded to its lane count with the identity and
        zero scalars.  Points are gathered from [block | gens | extras]; the
        extras start with the identity.  Returns (tables, (n,) int32 row
        indices, (n, 32) uint8 scalars)."""
        k_gens = int(gens_rows.shape[0]) if gens_rows is not None else 0
        m_block = self.block_row_base()
        extras: list[RistrettoPoint] = [IDENTITY]
        extra_ids: dict = {}
        idx_arr = _np.concatenate(
            [self._resolve_lane_points(list(pts), total, m_block, k_gens, extras, extra_ids)
             for pts, total, _ in groups]
        )
        scal = _np.concatenate([self._pad_scalar_bytes(sc, total) for _, total, sc in groups])
        extra_rows = rows_to_device(self._points_to_rows(extras), self.device)
        tables = [t for t in (self._block_state().rows, gens_rows, extra_rows) if t is not None]
        return tables, idx_arr, scal

    def _single_lanes(self, tables, idx_arr, scal):
        """K5 over lanes gathered by ``idx_arr`` from ``tables``, with their
        (n, 32) uint8 scalars: the (n, 4, 18) accumulators."""
        digits = K.recode_signed4_torch(to_device(scal, self.device))
        rows = _gather_rows(tables, to_device(idx_arr, self.device))
        return self._single_lane_sums(rows, digits)

    def _signatures_ok(self, sig_ok, sig_entries, r_bytes) -> bool:
        return sig_ok and all(_challenge_matches(e, r) for e, r in zip(sig_entries, r_bytes))

    def _sig_lane_count(self, sig_entries) -> int:
        return self._round_up(len(sig_entries), self._single_lane_granules()[1]) if sig_entries else 0

    def fused_block_begin(self, sigma, sig_entries):
        """Dispatch the sigma and signature lanes WITHOUT waiting (K5); the
        device computes them while the caller folds the range proofs on the
        host.  Returns an opaque phase-A handle for ``fused_block_finish``.

        sigma: (scalars, points) with points as block-row indices, 32-byte
        encodings or host points; sig_entries: (signature, public key point
        or encoding, compressed key, message) tuples."""
        from ..metrics import span

        sigma_sc, sigma_pts = sigma
        ns = self._round_up(len(sigma_sc), self._single_lane_granules()[0])
        nk = self._sig_lane_count(sig_entries)
        with span("fused_check.prep_a"):
            layout = self._lane_layout([(sigma_pts, ns, sigma_sc), *self._sig_groups(sig_entries, nk)])
            acc_a = self._single_lanes(*layout)  # no sync
        return {"acc_a": acc_a, "ns": ns, "nk": nk, "sig_entries": sig_entries}

    def fused_block_finish(self, state, range_):
        """Dispatch the range lanes (K5), combine them with phase A on the
        device (K3, K4) with the block's valid flags, and pull the packed
        result: the block's single host sync.  The signatures' challenges
        are then hashed on the host.  Returns (sigma_ok, range_ok, sig_ok).

        range_: (scalars, points); the points may hold one
        ("__bp_gens__", n, m) marker for the generator rows."""
        from ..metrics import span

        range_sc, range_pts = range_
        ns, nk, acc_a = state["ns"], state["nk"], state["acc_a"]
        nr = self._round_up(len(range_sc), self._single_lane_granules()[0])
        with span("fused_check.prep_b"):
            acc_r = self._single_lanes(*self._lane_layout([(range_pts, nr, range_sc)], self._gens_of(range_pts)))
            sums2, r = self._lane_sums(torch.cat([acc_a[:ns], acc_r, acc_a[ns:]]), ns, nr, nk)
            pending = self._packed_result(sums2, [r])
        sigma_ok, range_ok, sig_ok, r_bytes = self._pull_result(pending)
        return sigma_ok, range_ok, self._signatures_ok(sig_ok, state["sig_entries"], r_bytes)

    def fused_block_check(self, sigma, range_, sig_entries):
        """``fused_block_begin`` and ``fused_block_finish`` in one dispatch:
        the lanes [sigma | range | sig_s | sig_e] in one launch of K5, points
        gathered from [block | gens | extras].  Returns (sigma_ok, range_ok,
        sig_ok) with one host sync."""
        from ..metrics import span

        sigma_sc, sigma_pts = sigma
        range_sc, range_pts = range_
        g1 = self._single_lane_granules()[0]
        ns, nr = self._round_up(len(sigma_sc), g1), self._round_up(len(range_sc), g1)
        nk = self._sig_lane_count(sig_entries)
        with span("fused_check.prep"):
            layout = self._lane_layout(
                [(sigma_pts, ns, sigma_sc), (range_pts, nr, range_sc), *self._sig_groups(sig_entries, nk)],
                self._gens_of(range_pts),
            )
            sums2, r = self._lane_sums(self._single_lanes(*layout), ns, nr, nk)
            pending = self._packed_result(sums2, [r])
        sigma_ok, range_ok, sig_ok, r_bytes = self._pull_result(pending)
        return sigma_ok, range_ok, self._signatures_ok(sig_ok, sig_entries, r_bytes)

    # -- generic MSM -----------------------------------------------------------------

    def _to_device_points(self, points: list[RistrettoPoint], padded: int | None = None) -> torch.Tensor:
        """Host points -> (padded, 4, 18) int32 device rows, identity-padded."""
        rows = rows_to_device(self._points_to_rows(points), self.device)
        if padded is not None and padded > len(points):
            rows = torch.cat([rows, K.identity_rows(padded - len(points), self.device)])
        return rows

    def _bits_for(self, scalars, padded: int) -> torch.Tensor:
        """list[int] or (n, 32) uint8 scalars, canonicalized and zero-padded
        to ``padded`` lanes -> the lane kernels' (64, padded) uint8 signed
        digits, recoded on the device from the uploaded 32-byte scalars."""
        return K.recode_signed4_torch(to_device(self._pad_scalar_bytes(scalars, padded), self.device))

    def _msm_rows(self, scalars, points) -> torch.Tensor:
        """sum s_i P_i as (1, 4, 18) canonical device rows, without a sync.
        A padded lane count that fills whole packed tiles (on every shard)
        goes through K2 (or K6), any other through K5; K3 sums the lanes."""
        padded = self._lane_granule(len(scalars))
        digits = self._bits_for(scalars, padded)
        rows = self._to_device_points(points, padded)
        if self.use_quad and padded % (self._shards * K.K_PACK * self.tile) == 0:
            acc = self._packed_lanes(*self._group_lanes(rows, digits, padded))
        else:
            acc = self._single_lane_sums(rows, digits)
        return K.sum_points(acc[None])

    def msm(self, scalars, points: list[RistrettoPoint]) -> RistrettoPoint:
        """Drop-in for pyref.multiscalar_mul, executed on the device however
        few the points.  One device-to-host pull."""
        n = len(scalars)
        if n != len(points):
            raise ValueError(f"{n} scalars for {len(points)} points")
        if n == 0:
            return IDENTITY
        return self._point_from_device(self._msm_rows(scalars, points))

    def msm_check(self, scalars, points: list[RistrettoPoint]):
        """MSM and identity predicate on the device.  Returns a 0-d device
        bool without blocking (True for no points at all), so several
        checks can be dispatched before any pull.  The sum is the identity
        exactly when its encoding (K4) is zero."""
        n = len(scalars)
        if n != len(points):
            raise ValueError(f"{n} scalars for {len(points)} points")
        if n == 0:
            return True
        return (K.compress(self._msm_rows(scalars, points)) == 0).all()

    @staticmethod
    def _point_from_device(rows: torch.Tensor) -> RistrettoPoint:
        """One point's canonical (1, 4, 18) device rows -> a host point: one
        pull."""
        return RistrettoPoint(*to_ints(rows.reshape(4, NLIMBS).cpu().numpy()))

    # -- batched Schnorr verification and conversions ------------------------------

    def verify_signatures(self, entries) -> list[bool]:
        """Batch-verify Schnorr signatures (elgamal.rs:38-42 semantics).

        entries: list of (signature, pubkey point or encoding, compressed
        pubkey, message bytes).  R_i = s_i*H - e_i*P_i for the whole batch on
        the device (a signature slot of the packed lanes each, or two K5
        lanes and K3 with ``use_quad`` off), encoded by K4 and pulled once;
        the challenges are then hashed on the host."""
        from .. import scalars as sc
        from ..elgamal import H as _H

        if not entries:
            return []
        n = len(entries)
        nk = self._round_up(n, self._lane_granules()[1])
        # table rows: 0 the identity (padding), 1 H, 2.. the public keys
        table = self._to_device_points([IDENTITY, _H] + [_as_point(e[1]) for e in entries])
        idx = _np.zeros(2 * nk, dtype=_np.int32)
        idx[:n] = 1
        idx[nk : nk + n] = _np.arange(2, n + 2, dtype=_np.int32)
        rows = table[to_device(idx, self.device).to(torch.int64)]
        scal = _np.concatenate(
            [
                self._pad_scalar_bytes([e[0].s for e in entries], nk),
                self._pad_scalar_bytes([(-e[0].e) % sc.L for e in entries], nk),
            ]
        )
        digits = K.recode_signed4_torch(to_device(scal, self.device))
        if self.use_quad:
            r = self._packed_lanes(*self._sig_slots(rows[:nk], rows[nk:], digits[:, :nk], digits[:, nk:]))
        else:
            acc = self._single_lane_sums(rows, digits)
            r = self._pair_sums(acc[:nk], acc[nk:])
        r_bytes = K.compress(r).cpu().numpy()  # the one pull
        return [_challenge_matches(e, r_bytes[i]) for i, e in enumerate(entries)]

    def decompress_many_lazy(self, encodings: list[bytes]):
        """Batched validating decompression (K1) without host point objects:
        ((n, 4, 18) canonical uint32 limb rows, valid flags), one pull.
        Rows of invalid encodings hold the identity."""
        if not encodings:
            return _np.zeros((0, 4, NLIMBS), dtype=_np.uint32), []
        rows, valid = self._decompress(self._encoding_rows(encodings))
        return self._pull_decompressed(rows, valid, len(encodings))

    def decompress_many(self, encodings: list[bytes]):
        """Batched validating decompression.  Returns (points, valid flags)."""
        rows, valid = self.decompress_many_lazy(encodings)
        coords = to_ints(rows)  # 4 n ints, row-major X, Y, Z, T
        return [RistrettoPoint(*coords[4 * i : 4 * i + 4]) for i in range(len(valid))], valid

    def compress_many(self, points: list[RistrettoPoint]) -> list[bytes]:
        """Batched ristretto encode (K4), one pull."""
        if not points:
            return []
        n = len(points)
        enc = K.compress(self._to_device_points(list(points))).cpu().numpy()
        return [bytes(enc[i]) for i in range(n)]


_default: Accelerator | None = None


def default_accelerator() -> Accelerator:
    """Process-wide accelerator on the CUDA device (raises without one)."""
    global _default
    if _default is None:
        _default = Accelerator()
    return _default


HOST = "host"  # an entry point's ``accel`` that asks for the reference's host path


def resolve_accel(accel):
    """An entry point's ``accel`` argument: None is the card
    (``default_accelerator()``, which raises without one); ``"host"`` (which
    asks for the reference's host path) and an accelerator are returned as
    they are.  No path falls back to the host on its own."""
    if accel is None:
        return default_accelerator()
    if isinstance(accel, str) and accel != HOST:
        raise ValueError(f"accel={accel!r}: give an Accelerator, None for the card or {HOST!r}")
    return accel
