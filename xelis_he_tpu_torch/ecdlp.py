"""ECDLP decoder: fast discrete log of m*G for small m (balance amounts).

Capability parity with the xelis curve25519-dalek fork's ``ecdlp`` module
(xelis-he/src/elgamal.rs:67-92): a precomputed baby-step table (file-backed,
built offline) plus a BSGS search with a configurable range and progress
callback; ``par_decode`` runs the giant steps as batched device rounds.

On the card both device paths are launches of K8 (csrc/add_compress.cu,
``ops.kernels.add_compress``), which adds every row of a to every row of b
(a grid of lanes) and encodes the sums:
- ``ECDLPTables.build``: short doubling chains of K8 make the baby steps
  j*G (j < chunk) and the starts r*chunk*G on the device; then a few
  launches of about a million lanes add every start to every baby step and
  write the 8-byte prefixes into their slots, pulled once at the end;
- ``par_decode``: one launch runs a group of rounds, the group's cursors
  plus the lane offsets, with the group's big step as one more column whose
  sums are the next group's cursors, so the walker never leaves the device.

Each phase is a span of ``metrics`` (``ecdlp.build.*``, ``ecdlp.decode.*``).
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from .metrics import span
from .pyref.ristretto import BASEPOINT as G, IDENTITY, RistrettoPoint, mul_base

_PREFIX_BYTES = 8
# lanes of a table launch of K8 at most: a few launches make the table, and
# the encodings of one stay 32 MiB at any l1
_TABLE_LAUNCH_LANES = 1 << 20


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
        """Generate the 2^l1 baby steps.  At ``chunk`` steps or more they
        are made on ``accel``'s device by K8, as the grid of starts
        r*chunk*G and steps j*G (j < chunk): ``accel`` is an
        ``ops.accel.Accelerator``, or None for ``default_accelerator()``
        (the card, which raises without one), or ``"host"`` for the
        reference's host loop.  Fewer steps are made on the host, as the
        JAX package makes them."""
        from .ops.accel import HOST, resolve_accel

        count = 1 << l1
        accel = resolve_accel(accel) if count >= chunk else HOST
        if accel != HOST:
            prefixes = _device_prefixes(count, accel, chunk)
        else:
            prefixes = np.empty(count, dtype=np.uint64)
            acc = IDENTITY
            for i in range(count):
                prefixes[i] = _prefix_of(acc.compress())
                acc = acc + G
        with span("ecdlp.build.sort"):
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


def _multiples(step: torch.Tensor, n: int) -> torch.Tensor:
    """The (n, 4, 18) rows k*P for k < n, P the one row of ``step``, by a
    doubling chain of K8: rows k*P (k < m) and one more row m*P, plus P,
    give the rows m..2m-1 and 2m*P."""
    from .ops import kernels as K

    rows = K.identity_rows(1, step.device)
    while rows.shape[0] < n:
        m = rows.shape[0]
        need = min(m, n - m)
        _, sums = K.add_compress(torch.cat([rows[:need], step]), step, 0)
        rows, step = torch.cat([rows, sums[:need, 0]]), sums[need]
    return rows[:n]


def _wait(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _device_prefixes(count: int, accel, chunk: int) -> np.ndarray:
    """The (count,) uint64 prefixes of compress(i*G) in order of i, made on
    ``accel``'s device by K8 as lane (r, j) = r*chunk*G + j*G of the grid of
    starts and baby steps, at most ``_TABLE_LAUNCH_LANES`` lanes a launch.
    The prefixes go into their slots on the device and are pulled once, at
    the end."""
    from .ops import kernels as K

    starts_n = -(-count // chunk)
    with span("ecdlp.build.start_rows"):
        seeds = accel._to_device_points([G, mul_base(chunk)])
        steps = _multiples(seeds[:1], chunk)  # j*G, j < chunk
        starts = _multiples(seeds[1:], starts_n)  # r*chunk*G
        _wait(starts)
    per = max(1, _TABLE_LAUNCH_LANES // chunk)
    prefixes = torch.empty((starts_n * chunk, _PREFIX_BYTES), dtype=torch.uint8, device=accel.device)
    with span("ecdlp.build.k8"):
        for r in range(0, starts_n, per):
            enc, _ = K.add_compress(starts[r : r + per], steps)
            prefixes[r * chunk : (r + per) * chunk] = enc[..., :_PREFIX_BYTES].reshape(-1, _PREFIX_BYTES)
        _wait(prefixes)
    with span("ecdlp.build.pull"):
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
    that waits for the kernel that made ``t`` (span ``ecdlp.decode.k8_wait``),
    then for the copy (``ecdlp.decode.pull``), and gives the numpy array."""
    if t.device.type != "cuda":
        return t.numpy
    made = torch.cuda.Event()
    made.record()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()

    def wait():
        with span("ecdlp.decode.k8_wait"):
            made.synchronize()
        with span("ecdlp.decode.pull"):
            copied.synchronize()
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

    A round adds a lane-offset table (-j*2^l1*G for j in a window of
    ``batch``) to the cursor and encodes the window.  One launch of K8 runs
    a group of rounds, the group's cursors against the offsets, enough
    rounds to fill the card (``ops.kernels.K8_FILL_LANES``) and no more
    than are left; its last column advances each cursor by the group's
    rounds.  The rounds are looked up and confirmed in order, so the value
    found and the ``progress_fn`` calls (one a round) are the JAX
    package's.  Without ``accel`` it runs on
    ``ops.accel.default_accelerator()``, which needs a CUDA device."""
    from .ops import kernels as K

    args = args or ECDLPArguments()
    if accel is None:
        from .ops.accel import default_accelerator

        accel = default_accelerator()

    baby_count = 1 << tables.l1
    target = point - mul_base(args.range_min)
    width = args.range_max - args.range_min
    n_giant = (width + baby_count - 1) // baby_count
    batch = min(batch, max(1, n_giant))
    n_rounds = -(-n_giant // batch)
    group = min(-(-K.K8_FILL_LANES // batch), n_rounds)

    # lane offsets: -(j * 2^l1) * G for j in [0, batch), then the group's big
    # step -(group * batch * 2^l1) * G as the column whose sums are the next
    # group's cursors
    neg_gs = -mul_base(baby_count)
    offs = [IDENTITY]
    for _ in range(batch - 1):
        offs.append(offs[-1] + neg_gs)
    lanes = accel._to_device_points(offs + [-mul_base(baby_count * batch * group)])
    cursors, round_step = [target], -mul_base(baby_count * batch)
    for _ in range(group - 1):
        cursors.append(cursors[-1] + round_step)

    # The walker stays DEVICE-RESIDENT: each group is one launch, whose
    # encodings start on their way to the host at once; the host pulls them
    # for the prefix-table lookup.
    def _group(cur, rounds):
        enc, nxt = K.add_compress(cur[:rounds], lanes, batch)
        return _pull_async(enc), nxt[:, 0]

    cur = accel._to_device_points(cursors)
    done = 0  # rounds looked up
    # two-deep pipeline: dispatch group k+1 before pulling group k, so the
    # device works on the next group while the host looks up this one
    rounds = group
    pending, cur = _group(cur, rounds)
    while done < n_rounds:
        with span("ecdlp.decode.group"):
            left = n_rounds - done - rounds
            if left > 0:
                nxt_rounds = min(group, left)
                nxt, cur = _group(cur, nxt_rounds)
            else:
                nxt, nxt_rounds = None, 0
            encs = pending()
            for r in range(rounds):
                first = (done + r) * batch  # giant steps before this round
                # one round's lookup at a time, so a hit in an early round
                # returns without looking up the rest of its group
                with span("ecdlp.decode.lookup"):
                    cands = tables.lookup_many(encs[r, :batch])
                with span("ecdlp.decode.confirm"):
                    for j in np.nonzero(cands >= 0)[0]:
                        if first + int(j) >= n_giant:
                            continue
                        cand = int(cands[j])
                        m = args.range_min + (first + int(j)) * baby_count + cand
                        # prefix hits are candidates only: confirm exactly
                        if m < args.range_max and mul_base(m) == point:
                            return m
                if args.progress_fn is not None:
                    args.progress_fn(min(1.0, (first + batch) / n_giant))
            done += rounds
            pending, rounds = nxt, nxt_rounds
    return None
