#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (xelis_he_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--txs 10000] [--iters 3] [--seed 1]

Phases, each of which fails the run loudly:

1. card: the CUDA device's name, power limit and maximum SM clock;
2. build: nvcc compiles the four kernels of xelis_he_tpu_torch/csrc (K1-K4);
3. kernels vs plain: each kernel's wrapper on the card against its plain
   PyTorch version on the card, on edge cases at main-path scale (bit-exact:
   every output is canonical), and against host references (pyref);
4. main path: a block of ``--txs`` one-transfer transactions, built as
   bench.py builds it, verified through xelis_he_tpu_torch.verify_batch on
   ``Accelerator()``: one counted verify (launch counts, synchronising calls,
   receiver balance, no host-path block), then ``--iters`` timed verifies;
5. rejects: a tampered signature, fee and range proof each raise
   ProofVerificationError;
6. kernel times: each kernel and its plain version on the inputs of its
   largest main-path launch (CUDA events, median of 5), with the card's bound;
7. trace: one more verify under torch.profiler, whose CUDA activity gives
   the device's busy time and idle share during a verify.

Standard output ends with one {"kernels": [...]} JSON line, the card's name
and power limit as nvidia-smi prints them, and {"ok": true, "device": {...}}.
Long logs go to chiprun_out/.  Without a CUDA device, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import pathlib
import random
import statistics
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
OUT = ROOT / "chiprun_out"

L = 2**252 + 27742317777372353535851937790883648493
P = 2**255 - 19
# H100 SXM: HBM3 bandwidth and integer issue width (132 SMs x 64 INT32 lanes)
MEM_BYTES_PER_S = 3.35e12
INT32_LANES = 132 * 64

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "decompress": ("xelis_he_tpu_torch/csrc/decompress.cu", "xelis_he_tpu/ops/pallas_msm.py:596"),
    "windowed_lanes_k8": ("xelis_he_tpu_torch/csrc/windowed_lanes.cu", "xelis_he_tpu/ops/pallas_msm.py:1468"),
    "tile_sums": ("xelis_he_tpu_torch/csrc/tile_sums.cu", "xelis_he_tpu/ops/pallas_msm.py:453"),
    "compress": ("xelis_he_tpu_torch/csrc/compress.cu", "xelis_he_tpu/ops/pallas_msm.py:559"),
}


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def mismatch(a, b) -> tuple[int, int]:
    """(elements that differ, max |a - b|) of two integer tensors."""
    import torch

    d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    return int((d != 0).sum()), int(d.max()) if d.numel() else 0


def expect_equal(what: str, kernel_out, plain_out) -> tuple[int, int]:
    """(mismatches, max_abs_err) of a kernel's output against its plain
    version's; raises on any mismatch."""
    n, err = mismatch(kernel_out, plain_out)
    log(f"  {what}: {kernel_out.shape[0]} items, mismatches {n}, max_abs_err {err}")
    if n:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return n, err


def worst(*results: tuple[int, int]) -> tuple[int, int]:
    return max(n for n, _ in results), max(e for _, e in results)


def time_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (warm: the caller has
    already run it once)."""
    import torch

    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions on edge cases
# ---------------------------------------------------------------------------


def encodings_with_edges(rng: random.Random, n: int):
    """(n, 32) uint8 encodings: valid points, the identity, s >= p, negative
    s, a non-square, bit 255 set and all-0xFF.  Returns (array, points,
    expected valid flags)."""
    import numpy as np

    from xelis_he_tpu_torch.pyref.ristretto import IDENTITY, RistrettoPoint, mul_base

    specials: list[tuple[bytes, bool]] = [
        (bytes(32), True),  # the identity
        (P.to_bytes(32, "little"), False),  # s = p
        ((P + 2).to_bytes(32, "little"), False),  # s >= p
        (b"\x01" + bytes(31), False),  # negative s
        (b"\xff" * 32, False),
    ]
    s = 2
    while RistrettoPoint.decompress(s.to_bytes(32, "little")) is not None:
        s += 2
    specials.append((s.to_bytes(32, "little"), False))  # not a square
    top = bytearray(mul_base(12345).compress())
    top[31] |= 0x80
    specials.append((bytes(top), False))  # a valid point with bit 255 set
    pts = [mul_base(rng.randrange(L)) for _ in range(n - len(specials))]
    encs = [p.compress() for p in pts]
    ok = [True] * len(encs)
    for i, (e, v) in enumerate(specials):
        at = 1 + i * (len(encs) // len(specials))
        encs.insert(at, e)
        pts.insert(at, IDENTITY if e == bytes(32) else None)
        ok.insert(at, v)
    arr = np.frombuffer(b"".join(encs), dtype=np.uint8).reshape(n, 32).copy()
    return arr, pts, ok


def check_kernels(rng: random.Random, device) -> dict:
    """Phase 3; returns {kernel: (mismatches, max_abs_err)}."""
    import numpy as np
    import torch

    from xelis_he_tpu_torch.carry import rows_to_device
    from xelis_he_tpu_torch.ops import kernels as K
    from xelis_he_tpu_torch.ops.fe import from_ints_np
    from xelis_he_tpu_torch.pyref.ristretto import IDENTITY, multiscalar_mul, mul_base

    errs = {}

    def dev_rows(points):
        ints = [c for p in points for c in (p.X, p.Y, p.Z, p.T)]
        return rows_to_device(from_ints_np(ints).reshape(len(points), 4, K.NLIMBS), device)

    # K1 on 4096 encodings
    enc_np, pts, ok = encodings_with_edges(rng, 4096)
    enc = torch.from_numpy(enc_np).to(device)
    rows, valid = K.decompress(enc)
    p_rows, p_valid = K.decompress_plain(enc)
    errs["decompress"] = worst(expect_equal("K1 rows", rows, p_rows), expect_equal("K1 valid", valid, p_valid))
    if valid.cpu().tolist() != [int(v) for v in ok]:
        raise AssertionError("K1 valid flags disagree with pyref decode")
    good = [i for i, v in enumerate(ok) if v]

    # K4 on 4096 points: the K1 rows (identities included) and 2048 host
    # points with Z != 1
    host = [mul_base(rng.randrange(L)) for _ in range(2048)] + [IDENTITY] * 16
    k4_in = torch.cat([rows[: 4096 - len(host)], dev_rows(host)]).contiguous()
    k4 = K.compress(k4_in)
    errs["compress"] = expect_equal("K4 bytes", k4, K.compress_plain(k4_in))
    want = [bytes(enc_np[i]) if ok[i] else bytes(32) for i in range(4096 - len(host))]
    want += [p.compress() for p in host]
    if [bytes(r) for r in k4.cpu().numpy()] != want:
        raise AssertionError("K4 encodings disagree with pyref encode")

    # K2 on 2048 slots: pool points (Z = 1 rows from K1, Z != 1 host rows),
    # edge scalars, zero-digit subs, signature-style (s*H, -e*P) slots
    S = 2048
    pool_rows = torch.cat([rows[good], dev_rows(host[:512])])
    pool_pts = [pts[i] for i in good] + host[:512]
    pick = [[rng.randrange(len(pool_pts)) for _ in range(S)] for _ in range(K.K_PACK)]
    scal = [[rng.randrange(L) for _ in range(S)] for _ in range(K.K_PACK)]
    edges = [0, 1, L - 1, 2**252 + 27742317777372353535851937790883648493 - 1,
             (1 << 253) - 1, 2, L - 2, 1 << 128]
    for k in range(K.K_PACK):
        for j, e in enumerate(edges):
            scal[k][j] = edges[(j + k) % len(edges)]
    for s_ in range(8, 16):  # zero-digit subs
        for k in range(s_ - 8, K.K_PACK):
            scal[k][s_] = 0
    # signature-style slots as the main path packs them: sub 0 = s*B, sub 1 =
    # -e*P, subs 2-7 = B with zero digits (B = pool point 0 stands for H)
    for s_ in range(16, 32):
        for k in range(K.K_PACK):
            pick[k][s_] = 0 if k != 1 else pick[1][s_]
            if k >= 2:
                scal[k][s_] = 0
        scal[1][s_] = (-rng.randrange(L)) % L
    flat_idx = torch.tensor(pick, device=device).reshape(-1)
    k2_pts = pool_rows[flat_idx].reshape(K.K_PACK, S, 4, K.NLIMBS).contiguous()
    digits = np.stack([K.recode_signed4(scal[k]) for k in range(K.K_PACK)]).astype(np.uint8)
    for s_ in range(8, 32):  # zero subs store digit 8 throughout
        for k in range(K.K_PACK):
            if scal[k][s_] == 0:
                assert (digits[k, :, s_] == 8).all()
    k2_dig = torch.from_numpy(digits).to(device)
    acc = K.windowed_lanes_k8(k2_pts, k2_dig)
    errs["windowed_lanes_k8"] = expect_equal("K2 rows", acc, K.windowed_lanes_k8_plain(k2_pts, k2_dig))
    acc_enc = K.compress(acc).cpu().numpy()
    for s_ in list(range(40)) + [S - 1]:
        ref = multiscalar_mul([scal[k][s_] for k in range(K.K_PACK)],
                              [pool_pts[pick[k][s_]] for k in range(K.K_PACK)])
        if bytes(acc_enc[s_]) != ref.compress():
            raise AssertionError(f"K2 slot {s_} disagrees with pyref")

    # K3 on 64 tiles of 512: pool and K2 rows, two all-identity tiles and
    # identity-padded tails
    tile, n_tiles = K.TILE, 64
    src = torch.cat([pool_rows, acc])
    k3_in = src[torch.randint(0, src.shape[0], (n_tiles * tile,), device=device,
                              generator=torch.Generator(device).manual_seed(rng.randrange(2**31)))]
    ident = K.identity_rows(tile, device)
    k3_in[:tile] = ident
    k3_in[5 * tile : 6 * tile] = ident
    for t in range(8, 16):
        k3_in[t * tile + tile // (t - 6) : (t + 1) * tile] = ident[: tile - tile // (t - 6)]
    k3_in = k3_in.contiguous()
    sums = K.tile_sums(k3_in, tile)
    errs["tile_sums"] = expect_equal("K3 rows", sums, K.tile_sums_plain(k3_in, tile))
    if (K.compress(sums[:1]) != 0).any():
        raise AssertionError("K3: the sum of an identity tile is not the identity")
    torch.cuda.synchronize()
    return errs


# ---------------------------------------------------------------------------
# phase 4/5: the main path
# ---------------------------------------------------------------------------


def build_block(n_txs: int):
    """bench.py's block: one sender per tx, one receiver, fee 1."""
    from xelis_he_tpu_torch import (
        NATIVE_ASSET, TransactionBuilder, TransferBuilder, TransfersBuilder, build_batch,
    )
    from xelis_he_tpu_torch.mock import Account, GenerationBalance, Ledger

    ledger = Ledger()
    receiver = Account([(NATIVE_ASSET, 0)])
    pk_receiver = ledger.add_account(receiver)
    jobs = []
    for _ in range(n_txs):
        sender = Account([(NATIVE_ASSET, 1_000_000)])
        pk_s = ledger.add_account(sender)
        builder = TransactionBuilder(
            version=1,
            source=pk_s,
            data=TransfersBuilder([TransferBuilder(asset=NATIVE_ASSET, amount=10, dest_pubkey=pk_receiver)]),
            fee=1,
            nonce=0,
        )
        jobs.append((builder, GenerationBalance({NATIVE_ASSET: 1_000_000}, sender), sender.keypair))
    return build_batch(jobs), ledger, pk_receiver


class Recorder:
    """Wraps a kernel wrapper for one run: passes every call through and
    keeps (clones of) the inputs of the call with the largest first input."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None
        self.size = -1

    def __call__(self, *args):
        size = args[0].shape[1] if self.name == "windowed_lanes_k8" else args[0].shape[0]
        if size > self.size:
            self.size = size
            self.args = tuple(a.clone() if hasattr(a, "clone") else a for a in args)
        return self.fn(*args)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def main_path(args, accel):
    import torch

    from xelis_he_tpu_torch import NATIVE_ASSET, ProofVerificationError, verify_batch
    from xelis_he_tpu_torch.bulletproofs.range_proof import RangeProof
    from xelis_he_tpu_torch.metrics import metrics
    from xelis_he_tpu_torch.ops import kernels as K
    from xelis_he_tpu_torch.pyref.ristretto import mul_base

    t0 = time.perf_counter()
    txs, ledger, pk_r = build_block(args.txs)
    log(f"main path: built {len(txs)} txs x 1 transfer in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    verify_batch(txs, ledger.clone(), accel=accel)
    log(f"  warm-up verify: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    gc.collect()
    gc.freeze()

    # the counted run: launch counts, synchronising calls, balance
    state = ledger.clone()
    metrics.reset()
    recorders = [Recorder(K, name) for name in KERNELS]
    for r in recorders:
        r.__enter__()
    K.reset_launches()
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                verify_batch(txs, state, accel=accel)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        launches = dict(K.launches)
    finally:
        for r in recorders:
            r.__exit__()
    syncs = [w for w in seen if "called a synchronizing CUDA operation" in str(w.message)]
    log(f"  counted verify: launches {launches}")
    log(f"  synchronising calls seen: {len(syncs)} (the block's one result pull is expected)")
    snap = metrics.snapshot()
    host_blocks = snap["counters"].get("verify_batch.host_path_blocks", 0)
    if host_blocks:
        raise AssertionError(f"verify_batch.host_path_blocks = {host_blocks}: the block left the device path")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if state.get_bal_decrypted(pk_r, NATIVE_ASSET) != mul_base(10 * len(txs)):
        raise AssertionError("receiver balance is wrong after the verified block")
    log(f"  receiver balance = {10 * len(txs)} (decrypted and checked)")

    times = []
    for it in range(args.iters):
        state = ledger.clone()
        metrics.reset()
        t0 = time.perf_counter()
        verify_batch(txs, state, accel=accel)
        times.append(time.perf_counter() - t0)
        log(f"  iter {it}: {times[-1] * 1e3:.1f} ms, {times[-1] * 1e3 / len(txs):.4f} ms/tx")
    times.sort()
    per_tx = {"best_ms_per_tx": times[0] * 1e3 / len(txs),
              "p50_ms_per_tx": times[len(times) // 2] * 1e3 / len(txs)}
    log(f"  verify {len(txs)} txs: {json.dumps(per_tx)}")
    log(f"  metrics (last iter): {metrics.json_line()}")

    def tamper_sig(bad):
        bad[1].signature.s = (bad[1].signature.s + 1) % L

    def tamper_fee(bad):
        bad[0].fee = 2

    def tamper_range(bad):
        rb = bytearray(bad[0].range_proof.to_bytes())
        rb[33] ^= 1
        bad[0].range_proof = RangeProof.from_bytes(bytes(rb))

    for name, tamper in (("signature s", tamper_sig), ("fee", tamper_fee), ("range proof byte 33", tamper_range)):
        bad = list(txs)
        bad[0], bad[1] = copy.deepcopy(txs[0]), copy.deepcopy(txs[1])
        tamper(bad)
        try:
            verify_batch(bad, ledger.clone(), accel=accel)
        except ProofVerificationError as e:
            log(f"  tampered {name}: rejected ({e})")
        else:
            raise AssertionError(f"tampered {name} was accepted")
    return launches, per_tx, recorders, (txs, ledger)


def trace_verify(txs, ledger, accel) -> dict:
    """Phase 7: one verify under torch.profiler (CUDA activity only).  The
    device is busy for the union of the traced kernels' and copies'
    intervals; the idle share is the rest of the traced verify's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xelis_he_tpu_torch import verify_batch

    state = ledger.clone()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        verify_batch(txs, state, accel=accel)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    out = {"device_events": len(spans), "device_busy_ms": busy_us / 1e3, "traced_wall_ms": wall_ms,
           "idle_share": 1 - busy_us / 1e3 / wall_ms if spans else None}
    log(f"  trace: {json.dumps(out)}")
    if not spans:
        log("  trace: no device events in the trace; the idle share is not measured")
    return out


# ---------------------------------------------------------------------------
# phase 6: kernel times at the main path's shapes
# ---------------------------------------------------------------------------


def kernel_line(recorders, launches, errs, clock_hz):
    import torch

    from xelis_he_tpu_torch.ops import kernels as K

    plain = {
        "decompress": K.decompress_plain,
        "windowed_lanes_k8": K.windowed_lanes_k8_plain,
        "tile_sums": K.tile_sums_plain,
        "compress": K.compress_plain,
    }
    rows = []
    for r in recorders:
        name, args = r.name, r.args
        kernel = getattr(K, name)
        out_k, out_p = kernel(*args), plain[name](*args)
        if isinstance(out_k, tuple):
            res = worst(*(expect_equal(f"{name} (main-path shape) {i}", a, b)
                          for i, (a, b) in enumerate(zip(out_k, out_p))))
        else:
            res = expect_equal(f"{name} (main-path shape)", out_k, out_p)
        n_bad, err = worst(res, errs[name])
        ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: plain[name](*args), reps=3)  # seconds each at these shapes
        if name == "decompress":
            n = args[0].shape[0]
            items, nbytes, shape = n, n * (32 + 288 + 1), f"{n} encodings"
        elif name == "windowed_lanes_k8":
            s = args[0].shape[1]
            items, nbytes, shape = s, s * (8 * 288 + 8 * 64 + 288), f"{s} slots"
        elif name == "tile_sums":
            n, tile = args[0].shape[0], args[1]
            items, nbytes = n - n // tile, (n + n // tile) * 288
            shape = f"{n} rows, tile {tile}"
        else:
            n = args[0].shape[0]
            items, nbytes, shape = n, n * (288 + 32), f"{n} points"
        ops_ms = K.muladds(name, items) / (INT32_LANES * clock_hz) * 1e3
        bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
        source, replaces = KERNELS[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "max_mismatch": n_bad,
            "shape": shape, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
        })
        log(f"  {name} at {shape}: {ms:.3f} ms (plain {plain_ms:.1f} ms, bound {max(ops_ms, bytes_ms):.3f} ms)")
    torch.cuda.synchronize()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--txs", type=int, default=10_000, help="transactions in the main-path block")
    ap.add_argument("--iters", type=int, default=3, help="timed verifies of the block")
    ap.add_argument("--seed", type=int, default=1, help="seed of the kernel inputs")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(exist_ok=True)
    device = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    log(f"card: {torch.cuda.get_device_name(0)} | {card} | max SM clock {clock_hz / 1e6:.0f} MHz")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    from xelis_he_tpu_torch.ops import _build
    from xelis_he_tpu_torch.ops.accel import Accelerator

    _build.build_all()
    log(f"build: {_build.build_seconds:.1f} s")
    (OUT / "ptxas.txt").write_text("\n".join(f"== {k}\n{v}" for k, v in _build.ptxas_log.items()))
    for k, v in _build.ptxas_log.items():
        for line in v.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k}: {line.strip()}")

    log("kernels vs plain (edge cases):")
    errs = check_kernels(random.Random(args.seed), device)

    accel = Accelerator()
    launches, per_tx, recorders, block = main_path(args, accel)

    log("kernel times at the main path's largest launch:")
    rows = kernel_line(recorders, launches, errs, clock_hz)
    log("trace of one verify:")
    trace = trace_verify(*block, accel)
    print(json.dumps({"kernels": rows, "txs": args.txs, **per_tx, "trace": trace}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
