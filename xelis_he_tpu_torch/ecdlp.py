"""ECDLP decoder: fast discrete log of m*G for small m (balance amounts).

Capability parity with the xelis curve25519-dalek fork's ``ecdlp`` module
(xelis-he/src/elgamal.rs:67-92): a precomputed baby-step table (file-backed,
built offline) plus a BSGS search with a configurable range and progress
callback; ``par_decode`` runs the giant steps as batched device rounds.

On the card both device paths are launches of K8 (csrc/add_compress.cu,
``ops.kernels.add_compress``), which adds two rows of points, one side
broadcast, and encodes the sums:
- ``ECDLPTables.build``: a chunk of baby steps plus the broadcast step point,
  encoded, the sums kept as the next chunk; the 8-byte prefixes stay on the
  device until one pull at the end;
- ``par_decode``: the broadcast cursor plus the lane offsets, encoded, with
  the big step as one more lane whose sum is the next cursor, so that a
  round is one launch and the walker never leaves the device.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from .pyref.ristretto import BASEPOINT as G, IDENTITY, RistrettoPoint, mul_base

_PREFIX_BYTES = 8


def _prefix_of(compressed: bytes) -> int:
    return int.from_bytes(compressed[:_PREFIX_BYTES], "little")


class ECDLPArguments:
    """Decode parameters (mirrors ecdlp::ECDLPArguments semantics)."""

    def __init__(self, range_min: int = 0, range_max: int = 1 << 48, progress_fn=None):
        assert range_max > range_min
        self.range_min = range_min
        self.range_max = range_max
        self.progress_fn = progress_fn


class ECDLPTables:
    """Baby-step table: sorted 8-byte prefixes of compress(i*G), i < 2^l1.

    Persisted as .npz (the analog of the reference's precomputed table
    *file*, ECDLPTablesFileView).
    """

    def __init__(self, l1: int, keys: np.ndarray, idx: np.ndarray):
        self.l1 = l1
        self.keys = keys  # sorted uint64 prefixes
        self.idx = idx  # uint32 baby-step index per key

    # -- construction --------------------------------------------------------

    @staticmethod
    def build(l1: int, accel=None, chunk: int = 4096) -> "ECDLPTables":
        """Generate the 2^l1 baby steps.  With ``accel`` (an
        ``ops.accel.Accelerator``) the chunks run on its device, one K8
        launch each; otherwise on host."""
        count = 1 << l1
        if accel is not None and count >= chunk:
            prefixes = _device_prefixes(count, accel, chunk)
        else:
            prefixes = np.empty(count, dtype=np.uint64)
            acc = IDENTITY
            for i in range(count):
                prefixes[i] = _prefix_of(acc.compress())
                acc = acc + G
        order = np.argsort(prefixes, kind="stable")
        return ECDLPTables(l1, prefixes[order], order.astype(np.uint32))

    def save(self, path: str | pathlib.Path) -> None:
        path = pathlib.Path(path)
        if path.suffix == ".npz":
            np.savez(path, l1=self.l1, keys=self.keys, idx=self.idx)
        else:
            self.save_flat(path)

    @staticmethod
    def load(path: str | pathlib.Path, mmap: bool = True) -> "ECDLPTables":
        path = pathlib.Path(path)
        if path.suffix == ".npz":
            data = np.load(path)
            return ECDLPTables(int(data["l1"]), data["keys"], data["idx"])
        return ECDLPTables.load_flat(path, mmap=mmap)

    # -- mmap-able flat file (ECDLPTablesFileView parity, elgamal.rs:77-91) --
    #
    # Layout (little-endian):
    #   0:8    magic  b"XHEECDLP"
    #   8:12   version u32 (1)
    #   12:16  l1 u32
    #   16:16+8*2^l1        sorted u64 key prefixes
    #   ...:+4*2^l1         u32 baby-step index per key
    # Loading with mmap=True maps the arrays zero-copy (np.memmap), so a
    # multi-GB table costs no RSS until pages are touched — the same
    # access pattern as the reference's mmap'd ECDLPTablesFileView.

    _MAGIC = b"XHEECDLP"

    def save_flat(self, path: str | pathlib.Path) -> None:
        count = len(self.keys)
        with open(path, "wb") as f:
            f.write(self._MAGIC)
            f.write((1).to_bytes(4, "little"))
            f.write(self.l1.to_bytes(4, "little"))
            f.write(np.ascontiguousarray(self.keys, dtype="<u8").tobytes())
            f.write(np.ascontiguousarray(self.idx, dtype="<u4").tobytes())
        assert pathlib.Path(path).stat().st_size == 16 + 12 * count

    @staticmethod
    def load_flat(path: str | pathlib.Path, mmap: bool = True) -> "ECDLPTables":
        with open(path, "rb") as f:
            header = f.read(16)
        if header[:8] != ECDLPTables._MAGIC:
            raise ValueError(f"not an ECDLP table file: {path}")
        version = int.from_bytes(header[8:12], "little")
        if version != 1:
            raise ValueError(f"unsupported ECDLP table version {version}")
        l1 = int.from_bytes(header[12:16], "little")
        count = 1 << l1
        if mmap:
            keys = np.memmap(path, dtype="<u8", mode="r", offset=16, shape=(count,))
            idx = np.memmap(
                path, dtype="<u4", mode="r", offset=16 + 8 * count, shape=(count,)
            )
        else:
            raw = pathlib.Path(path).read_bytes()
            keys = np.frombuffer(raw, dtype="<u8", count=count, offset=16)
            idx = np.frombuffer(raw, dtype="<u4", count=count, offset=16 + 8 * count)
        return ECDLPTables(l1, keys, idx)

    # -- lookup ---------------------------------------------------------------

    def lookup_many(self, encs: np.ndarray) -> np.ndarray:
        """encs: (B, 32) uint8 -> int64 baby index or -1 (prefix candidates;
        callers confirm with an exact point check)."""
        pre = encs[:, :_PREFIX_BYTES].copy().view("<u8").ravel()
        pos = np.searchsorted(self.keys, pre)
        pos = np.minimum(pos, len(self.keys) - 1)
        hit = self.keys[pos] == pre
        return np.where(hit, self.idx[pos].astype(np.int64), -1)


def _device_prefixes(count: int, accel, chunk: int) -> np.ndarray:
    """The (count,) uint64 prefixes of compress(i*G) in order of i, chunk by
    chunk on ``accel``'s device: K8 adds the step chunk*G to every lane and
    encodes.  Lane i starts at (i - chunk)*G, so the first launch gives the
    baby steps 0..chunk-1; every launch but the last keeps its sums as the
    next chunk.  The prefixes are pulled once, at the end."""
    from .ops import kernels as K

    start, p = [], -mul_base(chunk)
    for _ in range(chunk):
        start.append(p)
        p = p + G
    batch = accel._to_device_points(start)
    step = accel._to_device_points([mul_base(chunk)])
    n_chunks = -(-count // chunk)
    prefixes = torch.empty((n_chunks * chunk, _PREFIX_BYTES), dtype=torch.uint8, device=accel.device)
    for k in range(n_chunks):
        enc, batch = K.add_compress(batch, step, 0 if k + 1 < n_chunks else None)
        prefixes[k * chunk : (k + 1) * chunk] = enc[:, :_PREFIX_BYTES]
    return prefixes[:count].cpu().numpy().view("<u8").ravel()


_PAR_DECODE_GIANT_THRESHOLD = 1 << 12


def decode(tables: ECDLPTables, point: RistrettoPoint, args: ECDLPArguments | None = None):
    """BSGS decode.  Returns the integer m with m*G == point within
    [range_min, range_max), or None.

    Above ~2^12 giant steps the sequential host walk is not viable at
    reference ranges (elgamal.rs:77-91 decodes 2^48 spans); such calls
    delegate to :func:`par_decode`, which runs the giant steps as batched
    device rounds."""
    args = args or ECDLPArguments()
    baby_count = 1 << tables.l1
    span = args.range_max - args.range_min
    if (span + baby_count - 1) // baby_count > _PAR_DECODE_GIANT_THRESHOLD:
        return par_decode(tables, point, args)
    # normalize to a non-negative search: M' = point - range_min*G
    target = point - mul_base(args.range_min)
    span = args.range_max - args.range_min
    n_giant = (span + baby_count - 1) // baby_count
    giant_step = mul_base(baby_count)

    current = target
    for j in range(n_giant):
        enc = np.frombuffer(current.compress(), dtype=np.uint8).reshape(1, 32)
        cand = int(tables.lookup_many(enc)[0])
        if cand >= 0 and mul_base(cand) == current:
            m = args.range_min + j * baby_count + cand
            if m < args.range_max:
                return m
        current = current - giant_step
        if args.progress_fn is not None:
            args.progress_fn((j + 1) / n_giant)
    return None


def _pull_async(t: torch.Tensor):
    """Start copying ``t`` to the host without waiting; returns a function
    that waits for the copy and gives the numpy array."""
    if t.device.type != "cuda":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return host.numpy()

    return wait


def par_decode(
    tables: ECDLPTables,
    point: RistrettoPoint,
    args: ECDLPArguments | None = None,
    accel=None,
    batch: int = 8192,
):
    """Giant steps as batched device rounds (parity with ecdlp::par_decode).

    Each round adds a lane-offset table (-j*2^l1*G for j in a window) to the
    target and encodes the whole window in one launch of K8, which also
    advances the target by the big step.  Without ``accel`` it runs on
    ``ops.accel.default_accelerator()``, which needs a CUDA device."""
    from .ops import kernels as K

    args = args or ECDLPArguments()
    if accel is None:
        from .ops.accel import default_accelerator

        accel = default_accelerator()

    baby_count = 1 << tables.l1
    target = point - mul_base(args.range_min)
    span = args.range_max - args.range_min
    n_giant = (span + baby_count - 1) // baby_count
    batch = min(batch, max(1, n_giant))

    # lane offsets: -(j * 2^l1) * G for j in [0, batch), then the big step
    # -(batch * 2^l1) * G as the lane whose sum is the next cursor
    neg_gs = -mul_base(baby_count)
    offs = [IDENTITY]
    for _ in range(batch - 1):
        offs.append(offs[-1] + neg_gs)
    lanes = accel._to_device_points(offs + [-mul_base(baby_count * batch)])

    # The walker stays DEVICE-RESIDENT: each round is one launch, whose
    # encodings start on their way to the host at once; the host pulls them
    # for the prefix-table lookup.
    def _round(cur):
        enc, nxt = K.add_compress(cur, lanes, batch)
        return _pull_async(enc[:batch]), nxt

    cur = accel._to_device_points([target])
    done = 0
    # two-deep pipeline: dispatch round k+1 before pulling round k, so the
    # device works on the next round while the host looks up this one
    pending, cur = _round(cur)
    while done < n_giant:
        if done + batch < n_giant:
            nxt, cur = _round(cur)
        else:
            nxt = None
        encs = pending()
        cands = tables.lookup_many(encs)
        for j in np.nonzero(cands >= 0)[0]:
            if done + int(j) >= n_giant:
                continue
            cand = int(cands[j])
            m = args.range_min + (done + int(j)) * baby_count + cand
            # prefix hits are candidates only: confirm exactly
            if m < args.range_max and mul_base(m) == point:
                return m
        done += batch
        pending = nxt
        if args.progress_fn is not None:
            args.progress_fn(min(1.0, done / n_giant))
    return None
