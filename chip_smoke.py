#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (xelis_he_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--txs 10000] [--iters 3] [--seed 1]
    python3 chip_smoke.py --kernels-from DIR [--seed 1]

Phases, each of which fails the run loudly:

1. card: the CUDA device's name, power limit and maximum SM clock;
2. build: nvcc compiles the fourteen kernels of xelis_he_tpu_torch/csrc
   (K1-K14), one process each, side by side; the SASS loop of K11's three
   forms shows which instruction a wide and a high multiply-add are
   (cuobjdump);
3. kernels vs plain: each kernel's wrapper on the card against its plain
   PyTorch version on the card, on edge cases (bit-exact: every output is
   canonical), against host references (pyref), and K6 against K2 (by
   encodings: the two split a slot over their own thread counts); K1 and K4
   also at counts at and around their blocks' edges, K4 on 4-torsion cosets
   with Z != 1 (both branches of its encode's rotation and sign flip), K2
   and K6 at a ragged slot count, K3 at tiles from 1 to 1024, K7 at lane
   counts that leave a quad of threads or a warp partly filled, K8 on one
   row against 1 to 8,193 columns, as many rows against one, small grids
   and the path's grids, 256 x 4,096 (a table launch) and 16 x 8,193 (a
   decode group) (sums and encodings);
   ptxas must report no spills for K1, K4 and K8, and its figures for K6-K10
   are printed;
4. main path: a block of ``--txs`` one-transfer transactions, built as
   bench.py builds it, verified through xelis_he_tpu_torch.verify_batch on
   ``Accelerator()``: one counted verify (launch counts, synchronising calls,
   receiver balance, no host-path block), then ``--iters`` timed verifies;
5. rejects: a tampered signature, fee and range proof each raise
   ProofVerificationError;
6. the lane-kernel switches: the same block verified with quad lanes off
   (every lane through K5) and with the tier switch off (K6 in K2's place):
   accepted, the default verify's balances, one synchronising call, K2 not
   launched;
7. generic MSM: ``accel.msm`` on one transaction's range-proof lanes (the K5
   branch) and on a lane count that fills packed tiles (the K2 branch),
   against pyref; ``verify(tx, state, msm=accel.msm)`` over 64 transactions;
   ``MsmEngine.msm_daa`` at 512 lanes (K7); the host's figure beside it is
   ``verify`` with pyref's ``multiscalar_mul``;
8. signatures and conversions: ``verify_signatures`` on the block's
   signatures with one made bad; ``decompress_many_lazy``, ``decompress_many``
   and ``compress_many`` round trips on the block's encodings;
9. the Python block path: the first 2,000 transactions of the block with
   XELIS_NATIVE_PREVERIFY=0 (``_fused_deferred``): accepted, no host-path
   block, one synchronising call;
10. the fused block without the fold library: the whole block with
    ``hashcore.verifyfold_native`` made to fail its import and
    XELIS_NATIVE_PREVERIFY=0 (``fused_block_begin`` / ``fused_block_finish``):
    K1, K5, K3 and K4 and no other kernel, one pull, the default verify's
    balances, every launch of the run (K1, both K5s, the three K3s, K4) held
    to its plain version on its own inputs and timed on the device,
    ``fused_block_check`` giving begin/finish's flags, and a tampered
    signature rejected as such;
11. ECDLP: an l1 = 22 table built on the card (K8: the two doubling chains
    and four launches of 2^20 lanes), sampled entries against pyref, a flat
    save/load round trip, ``par_decode`` of 16 values in [0, 2^44) at 8,192
    lanes a round and 16 rounds a launch, one with a negative ``range_min``
    and one out of range (None, at most ceil(512 / 16) + 1 launches); the
    build's split (start rows, K8, pull, host sort) and one decode group's
    (K8 wait, pull, lookup, confirm, Python), from ``ecdlp``'s spans;
11a. the mesh: ``ShardedMsm`` and ``MultiDeviceMsm`` on a mesh that lists the
    card twice (and ``ShardedMsm`` on ``make_mesh()``), at 512 and 49,152
    lanes, equal to ``accel.msm`` by encoding and to pyref at 64 lanes, with
    the shard sizes K7 sees; the block verified on
    ``Accelerator(mesh=<the card twice>)``: accepted with the default verify's
    balances, K2 launched twice a chunk, the first chunk's two shards held to
    K2's plain version, ms/tx beside the default verify's;
11b. multi-process accept: two worker processes on the card
    (``python -m xelis_he_tpu_torch.parallel._dcn_worker``, gloo) each verify
    their round-robin half of the block and both print ACCEPT; with one fee
    tampered on rank 1's half, both print REJECT; wall time of each;
11c. Pippenger: ``MsmEngine(window=13).msm_points`` at 65,536 points (K9,
    K10) equal to ``accel.msm`` by encoding and to pyref at 64 points, K9
    on a window whose lanes all share one digit, each call of K9 (all its
    passes) and K10 held to its plain version, K10 also on one window (and
    ``_window_sum`` at 64 points against pyref), K9's passes, threads,
    longest walk and device ms against its bound at 65,536 and on the
    skewed lanes; K10's two launches equal, its device ms whole, of phase 1
    alone (a launch without the Horner chain) and of phase 1 then the chain
    (no overlap), and the chain's latency floor: its rounds at the round
    latency of K10's own steps on one quad (``k10_rounds``, held to its
    plain version); the call's time beside ``accel.msm``'s and its
    ``msm.*`` spans;
11d. roofline probes: the probe scripts (python -m xelis_he_tpu_torch.scripts.
    bench_roofline, bench_fe13, bench_qtile) at 16,384, 131,072 and
    1,048,576 lanes and launches of ~2 ms: K11's u32, wide and high-word
    (mad.hi) multiply-add rates, K12 (_mul_t in its column-sum form,
    at three block widths), K13 (_mul13 and its two
    carry variants) and K14 (the port's fe_mul/fe_sq on both tiers), every
    launch held to its plain version bit for bit (every lane at 4 reps, a
    sample of lanes at the timed reps, K14's sample also by value against
    Python's pow; the 4-rep launches count among the phase's launches), and
    K5, K2 and K6 at the scripts' shapes against the rates K14 predicts;
12. kernel times: each kernel on the inputs of its largest launch on its
    path, as device time (torch.profiler's records of it over 5 calls) and
    as the time of a call in a run of 10 back to back (CUDA events: for a
    small kernel that is mostly the host's launch cost), beside its plain
    version's time (CUDA events around one call, median of 3) and the card's
    bound, with the bound at K11's measured multiply-add rate beside it
    (K11-K14: their rows at 16,384 lanes from phase 11d, each with its
    plateau's launch beside it); K3 also at every
    other shape the path launches it at (the group sums of ``sum_points``
    among them), with phase 10's launches beside them; each kernel's
    mismatch count covers phase 10's launches too;
13. trace: one more default verify under utils.profiling.trace
    (torch.profiler, CPU and CUDA activity), whose CUDA events give the
    device's busy time and idle share during a verify.

Every path is driven with the launch counts set to 0 just before it and read
just after.  Standard output ends with one {"kernels": [...]} JSON line, the
card's name and power limit as nvidia-smi prints them, and {"ok": true,
"device": {...}}.  Long logs go to chiprun_out/.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no result.

With ``--kernels-from DIR`` it only times K1-K12 of the port checked out at
DIR (for instance a ``git archive`` of an earlier commit) at the main path's
largest shapes, K7 also at a count that fills the card, K8 on 16 decode
rounds of 8,193 lanes (one launch or sixteen, as the tree's K8 takes them),
K9 on the digits of 65,536 scalars (all its launches) and K10 on K9's
buckets, on inputs made
from ``--seed``, with a digest of each output, K12 at 1,048,576 lanes x 8
reps (block 256) and K11's forms (u32, wide and, where the tree has it,
high word) on 131,072 x 18 elements (device time and CUDA events, a digest
of each, K12's ptxas figures and SASS counts by pipe), then the entry points that
call K8 and K9 on the host's clock (the l1 = 22 table, a decode that hits
in its first round, a full walk of [0, 2^44), ``msm_points`` at 65,536
points), the ptxas figures of K1, K4, K6-K10 and K1's and K4's SASS mix of
one squaring, and prints one JSON line: run it on two checkouts in one call
to compare them on one card.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import pathlib
import random
import re
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
    # name: (source, TPU kernel it replaces, CUDA function)
    "decompress": ("xelis_he_tpu_torch/csrc/decompress.cu", "xelis_he_tpu/ops/pallas_msm.py:596",
                   "decompress_kernel"),
    "windowed_lanes_k8": ("xelis_he_tpu_torch/csrc/windowed_lanes.cu", "xelis_he_tpu/ops/pallas_msm.py:1468",
                          "windowed_lanes_k8_kernel"),
    "tile_sums": ("xelis_he_tpu_torch/csrc/tile_sums.cu", "xelis_he_tpu/ops/pallas_msm.py:453",
                  "tile_sums_kernel"),
    "compress": ("xelis_he_tpu_torch/csrc/compress.cu", "xelis_he_tpu/ops/pallas_msm.py:559",
                 "compress_kernel"),
    "windowed_lanes": ("xelis_he_tpu_torch/csrc/windowed_lane.cu", "xelis_he_tpu/ops/pallas_msm.py:894",
                       "windowed_lane_kernel"),
    "windowed_lanes_k8_fe15": ("xelis_he_tpu_torch/csrc/windowed_lanes_fe15.cu",
                               "xelis_he_tpu/ops/pallas_msm.py:1364", "windowed_lanes_k8_fe15_kernel"),
    "daa_lanes": ("xelis_he_tpu_torch/csrc/daa_lanes.cu", "xelis_he_tpu/ops/pallas_msm.py:411",
                  "daa_lanes_kernel"),
    # no Pallas kernel: the JAX package's ECDLP adds and encodes in XLA
    "add_compress": ("xelis_he_tpu_torch/csrc/add_compress.cu", "xelis_he_tpu/ecdlp.py:228",
                     "add_compress_kernel"),
    # no Pallas kernel: the JAX package's Pippenger scans and reduces in XLA
    "bucket_sums": ("xelis_he_tpu_torch/csrc/bucket_sums.cu", "xelis_he_tpu/ops/msm.py:170",
                    "bucket_sums_kernel"),
    "window_sums": ("xelis_he_tpu_torch/csrc/window_sums.cu", "xelis_he_tpu/ops/msm.py:195",
                    "window_sums_kernel"),
    # the roofline probes of scripts/ (phase 11d)
    "probe_imad": ("xelis_he_tpu_torch/csrc/probe_imad.cu", "scripts/bench_roofline.py:57", "probe_imad_kernel"),
    "probe_mul15": ("xelis_he_tpu_torch/csrc/probe_mul15.cu", "scripts/bench_roofline.py:57",
                    "probe_mul15_kernel"),
    "probe_mul13": ("xelis_he_tpu_torch/csrc/probe_mul13.cu", "scripts/bench_roofline.py:135",
                    "probe_mul13_kernel"),
    # no Pallas kernel: the port's own field multiplication in the place of
    # the probes' production one (_mul13)
    "probe_fe": ("xelis_he_tpu_torch/csrc/probe_fe.cu",
                 "none: the port's fe_mul/fe_sq (xelis_he_tpu_torch/csrc/ed25519.cuh)", "probe_fe_kernel"),
}
PROBE_KERNELS = ("probe_imad", "probe_mul15", "probe_mul13", "probe_fe")
# each probe's row in the kernels line: the sweep (ops/probes.py mode) it reports
PROBE_ROWS = {"probe_imad": "imad", "probe_mul15": "mul15_b256", "probe_mul13": "mul13_3pass", "probe_fe": "fe_mul"}
# the probe phase's lane counts (the scripts sweep 1,024 to 1,048,576) and launch time
PROBE_LANES = (16_384, 131_072, 1_048_576)
PROBE_TARGET_MS = 2.0
# the SASS whose loop mix the build phase prints: K11's three forms (IMAD,
# IMAD.WIDE or IMAD.HI), and one instantiation each of K12, K13 and K14
PROBE_SASS = {"probe_imad": ("probe_imad_kernel", "probe_imad_wide_kernel", "probe_imad_hi_kernel"),
              "probe_mul15": ("probe_mul15_kernelILi256E",), "probe_mul13": ("probe_mul13_kernelILi0E",),
              "probe_fe": ("probe_fe_kernelIN3xhe2feELb0E", "probe_fe_kernelIN3xhe4fe15ELb0E")}
# the library (csrc/<name>.cu, ops/_build.py) each kernel is built into
LIBS = {name: pathlib.Path(src).stem for name, (src, _, _) in KERNELS.items()}
# kernels whose ptxas figures the build phase and --kernels-from print
BUILD_FIGURES = ("decompress", "compress", "windowed_lanes_k8_fe15", "daa_lanes", "add_compress", "bucket_sums",
                 "window_sums")
# the kernels of the default verify (phase 4); the others run on the paths of phases 6-11
DEFAULT_PATH = ("decompress", "windowed_lanes_k8", "tile_sums", "compress")
# the kernels of the fused block without the fold library (phase 10)
FUSED_PATH = ("decompress", "windowed_lanes", "tile_sums", "compress")
EDGE_SCALARS = [0, 1, L - 1, L - 1, (1 << 253) - 1, 2, L - 2, 1 << 128]  # tests/test_fe13.py's


T0 = time.perf_counter()


def log(*args) -> None:
    """Print a log line; a phase's heading (a line not indented) with the
    seconds since the start."""
    if args and isinstance(args[0], str) and not args[0].startswith(" "):
        args = (f"[{time.perf_counter() - T0:.0f} s] {args[0]}", *args[1:])
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


def device_ms(fn, kernel: str, reps: int = 5) -> float:
    """Device time of one launch of the CUDA function named ``kernel`` in
    ``fn`` (warm): the mean of torch.profiler's records of it over ``reps``
    calls.  A trace can drop records, so the mean is over those it holds; a
    trace that holds none is taken again, and after three such traces the
    time is the median of CUDA events around single calls (``time_ms``),
    which counts each call's launch too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    named = re.compile(rf"\b{kernel}\b")
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and named.search(e.name)]
        if us:
            return statistics.mean(us) / 1e3
    log(f"  the profiler recorded no launch of {kernel} in three traces: CUDA events instead")
    return time_ms(fn, reps)


def call_ms(fn, n: int = 10) -> float:
    """Time of one call of ``fn`` in a run of ``n`` back to back, CUDA events
    around the run: a long kernel's device time, a short one's launch cost on
    the host."""
    import torch

    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


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


RAGGED = (1, 127, 128, 129, 1000)  # K1's and K4's counts at their blocks' edges


def torsion_coset_rows(points, rng: random.Random):
    """(4 n, 4, 18) uint32 rows of each point plus each 4-torsion point --
    (0, 1), (0, -1), (i, 0), (-i, 0): P + (0, -1) = (-X, -Y, Z, T) and
    P + (+-i, 0) = (+-iY, +-iX, Z, -T) -- every row scaled by a random
    factor of Z, with the encodings they must give (each point's own; zero
    for the identity's coset) and the set of (rotate, sign flip) branches of
    RFC 9496's ENCODE they take, in Python integers."""
    from xelis_he_tpu_torch.ops.fe import from_ints_np
    from xelis_he_tpu_torch.pyref import field as pf

    i = pf.SQRT_M1
    coords, want, branches = [], [], set()
    for q in points:
        X, Y, Z, T = q.X, q.Y, q.Z, q.T
        for c in ((X, Y, Z, T), (-X, -Y, Z, T), (i * Y, i * X, Z, -T), (-i * Y, -i * X, Z, -T)):
            lam = rng.randrange(2, P)
            X_, Y_, Z_, T_ = (v * lam % P for v in c)
            coords += [X_, Y_, Z_, T_]
            want.append(q.compress())
            u1, u2 = (Z_ + Y_) * (Z_ - Y_) % P, X_ * Y_ % P
            _, inv = pf.sqrt_ratio_m1(1, u1 * u2 * u2 % P)
            z_inv = inv * u1 % P * (inv * u2 % P) % P * T_ % P
            rotate = pf.is_negative(T_ * z_inv)
            branches.add((rotate, pf.is_negative((Y_ * i if rotate else X_) * z_inv)))
    return from_ints_np(coords).reshape(len(want), 4, 18), want, branches


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
    k1_errs = [expect_equal("K1 rows", rows, p_rows), expect_equal("K1 valid", valid, p_valid)]
    if valid.cpu().tolist() != [int(v) for v in ok]:
        raise AssertionError("K1 valid flags disagree with pyref decode")
    # K1 launches on exactly the caller's count: one block and its edges, and
    # counts that end inside a block, each holding the edge encodings first
    edges_first = torch.cat([enc[[i for i in range(4096) if not ok[i] or not enc_np[i].any()]], enc])
    for n_ in RAGGED:
        part = edges_first[:n_].contiguous()
        got, want = K.decompress(part), K.decompress_plain(part)
        k1_errs += [expect_equal(f"K1 rows, {n_} encodings", got[0], want[0]),
                    expect_equal(f"K1 valid, {n_} encodings", got[1], want[1])]
    errs["decompress"] = worst(*k1_errs)
    good = [i for i, v in enumerate(ok) if v]

    # K4 on 4096 points: the K1 rows (identities included) and 2048 host
    # points with Z != 1
    host = [mul_base(rng.randrange(L)) for _ in range(2048)] + [IDENTITY] * 16
    k4_in = torch.cat([rows[: 4096 - len(host)], dev_rows(host)]).contiguous()
    k4 = K.compress(k4_in)
    k4_errs = [expect_equal("K4 bytes", k4, K.compress_plain(k4_in))]
    want = [bytes(enc_np[i]) if ok[i] else bytes(32) for i in range(4096 - len(host))]
    want += [p.compress() for p in host]
    if [bytes(r) for r in k4.cpu().numpy()] != want:
        raise AssertionError("K4 encodings disagree with pyref encode")
    for n_ in RAGGED:  # K4's blocks hold 128 points: ragged edges inside a block
        part = k4_in[-n_:].contiguous()
        k4_errs.append(expect_equal(f"K4 bytes, {n_} points", K.compress(part), K.compress_plain(part)))
    # each host point plus each 4-torsion point, Z scaled: a coset encodes as
    # its point, the identity's as zero; both branches of rotate and of the
    # sign flip occur
    tors, tors_want, branches = torsion_coset_rows(host[:64] + [IDENTITY], rng)
    tors = rows_to_device(tors, device)
    k4_tors = K.compress(tors)
    k4_errs.append(expect_equal("K4 bytes, 4-torsion cosets", k4_tors, K.compress_plain(tors)))
    if [bytes(r) for r in k4_tors.cpu().numpy()] != tors_want:
        raise AssertionError("K4 encodes a 4-torsion coset otherwise than its point")
    if branches != {(r, f) for r in (False, True) for f in (False, True)}:
        raise AssertionError(f"K4's edge points miss a branch of its encode: {branches}")
    errs["compress"] = worst(*k4_errs)

    # K2 on 2048 slots: pool points (Z = 1 rows from K1, Z != 1 host rows),
    # edge scalars, zero-digit subs, signature-style (s*H, -e*P) slots
    S = 2048
    pool_rows = torch.cat([rows[good], dev_rows(host[:512])])
    pool_pts = [pts[i] for i in good] + host[:512]
    pick = [[rng.randrange(len(pool_pts)) for _ in range(S)] for _ in range(K.K_PACK)]
    scal = [[rng.randrange(L) for _ in range(S)] for _ in range(K.K_PACK)]
    edges = EDGE_SCALARS
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
    ragged = (k2_pts[:, :37].contiguous(), k2_dig[:, :, :37].contiguous())  # a block's slots left idle
    errs["windowed_lanes_k8"] = worst(
        expect_equal("K2 rows", acc, K.windowed_lanes_k8_plain(k2_pts, k2_dig)),
        expect_equal("K2 rows, 37 slots", K.windowed_lanes_k8(*ragged), K.windowed_lanes_k8_plain(*ragged)),
    )
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
    errs["tile_sums"] = worst(
        expect_equal("K3 rows", sums, K.tile_sums_plain(k3_in, tile)),
        # one block a tile up to K3_SUB rows; above, sub-tiles and a last block
        *(expect_equal(f"K3 rows at tile {t}", K.tile_sums(k3_in[: 8 * t], t), K.tile_sums_plain(k3_in[: 8 * t], t))
          for t in (1, 2, 64, 128, 1024)),
    )
    if (K.compress(sums[:1]) != 0).any():
        raise AssertionError("K3: the sum of an identity tile is not the identity")

    # K6 on K2's 2048 slots and on a ragged count: against its plain version
    # by rows and against K2 (two field tiers, one answer: compared encoded)
    acc15 = K.windowed_lanes_k8_fe15(k2_pts, k2_dig)
    acc15_ragged = K.windowed_lanes_k8_fe15(*ragged)
    errs["windowed_lanes_k8_fe15"] = worst(
        expect_equal("K6 rows", acc15, K.windowed_lanes_k8_fe15_plain(k2_pts, k2_dig)),
        expect_equal("K6 encodings against K2's", K.compress(acc15), K.compress(acc)),
        expect_equal("K6 rows, 37 slots", acc15_ragged, K.windowed_lanes_k8_fe15_plain(*ragged)),
        expect_equal("K6 encodings against K2's, 37 slots", K.compress(acc15_ragged),
                     K.compress(acc[:37].contiguous())),
    )

    # K5 on 4096 lanes: pool points, edge scalars, zero scalars, identity lanes
    n5 = 4096
    lane_pick = [rng.randrange(len(pool_pts)) for _ in range(n5)]
    lane_scal = [rng.randrange(L) for _ in range(n5)]
    lane_scal[: len(edges)] = edges
    for i in range(16, 24):
        lane_scal[i] = 0
    k5_pts = pool_rows[torch.tensor(lane_pick, device=device)].contiguous()
    k5_pts[24:32] = K.identity_rows(8, device)
    k5_dig = torch.from_numpy(K.recode_signed4(lane_scal).astype(np.uint8)).to(device)
    lanes = K.windowed_lanes(k5_pts, k5_dig)
    errs["windowed_lanes"] = expect_equal("K5 rows", lanes, K.windowed_lanes_plain(k5_pts, k5_dig))
    lanes_enc = K.compress(lanes).cpu().numpy()
    for i in list(range(40)) + [n5 - 1]:
        ref = IDENTITY if 24 <= i < 32 else multiscalar_mul([lane_scal[i]], [pool_pts[lane_pick[i]]])
        if bytes(lanes_enc[i]) != ref.compress():
            raise AssertionError(f"K5 lane {i} disagrees with pyref")

    # K7 on 512 lanes: the same points, scalars with bits 253-255 set among
    # them (ignored), all-ones and zero
    n7 = 512
    daa_scal = lane_scal[:n7]
    daa_scal[32], daa_scal[33], daa_scal[34] = (1 << 253) + 12345, (1 << 256) - 1, (1 << 253) - 1
    k7_bits = torch.from_numpy(K.pack_bits(daa_scal).view(np.int32)).to(device)
    raw = np.frombuffer(b"".join(x.to_bytes(32, "little") for x in daa_scal), np.uint8).reshape(n7, 32).copy()
    if not torch.equal(K.pack_bits_torch(torch.from_numpy(raw).to(device)), k7_bits):
        raise AssertionError("K7: the device form of pack_bits disagrees with the host's")
    k7_pts = k5_pts[:n7].contiguous()
    daa = K.daa_lanes(k7_pts, k7_bits)
    k7_errs = [expect_equal("K7 rows", daa, K.daa_lanes_plain(k7_pts, k7_bits))]
    # a lane is a quad of threads, 8 lanes a warp: counts that leave a quad's
    # warp or block partly filled, each from the edge lanes on
    for n_ in (1, 7, 9, 511):
        part_pts, part_bits = k7_pts[:n_].contiguous(), k7_bits[:, :n_].contiguous()
        k7_errs.append(expect_equal(f"K7 rows, {n_} lanes", K.daa_lanes(part_pts, part_bits),
                                    K.daa_lanes_plain(part_pts, part_bits)))
    errs["daa_lanes"] = worst(*k7_errs)
    daa_enc = K.compress(daa).cpu().numpy()
    for i in range(40):
        ref = IDENTITY if 24 <= i < 32 else multiscalar_mul([daa_scal[i] & ((1 << 253) - 1)], [pool_pts[lane_pick[i]]])
        if bytes(daa_enc[i]) != ref.compress():
            raise AssertionError(f"K7 lane {i} disagrees with pyref")

    errs["add_compress"] = check_add_compress(rng, device, torch.cat([rows[good], dev_rows(host)]),
                                              [pts[i] for i in good] + host, tors, host[:64] + [IDENTITY])
    torch.cuda.synchronize()
    return errs


# K8's grids, rows x columns: one row against 1 to 8,193 columns and as many
# rows against one column (a block's edges, a table chunk, a decode round),
# grids that end inside a block, and the path's own: a table launch of the
# build and a decode group (16 rounds of 8,193 lanes)
K8_EDGE_COUNTS = (1, 127, 128, 129, 4096, 8193)
K8_GRIDS = ((3, 43), (64, 129), (256, 4096), (16, 8193))


def check_add_compress(rng: random.Random, device, pool_rows, pool_pts, tors, tors_pts) -> tuple[int, int]:
    """K8 against its plain version, bit for bit (encodings and sums), on
    one row against K8_EDGE_COUNTS columns, as many rows against one column
    and the K8_GRIDS, every column's sums kept, and on the decode group's
    grid also only the last column's and on the build's none, as the path
    keeps them; addends drawn from K1 rows (Z = 1), host points (Z != 1),
    the identity and the 4-torsion cosets of K4's check (Z scaled);
    encodings of sampled lanes against pyref."""
    import torch

    from xelis_he_tpu_torch.ops import kernels as K
    from xelis_he_tpu_torch.pyref.ristretto import IDENTITY

    rows = torch.cat([pool_rows, tors, K.identity_rows(1, device)])
    pts = pool_pts + [q for q in tors_pts for _ in range(4)] + [IDENTITY]
    n = max(K8_EDGE_COUNTS)
    pick = [[rng.randrange(len(pts)) for _ in range(n)] for _ in range(2)]
    pick[0][:4], pick[1][:4] = [len(pts) - 1] * 4, [len(pts) - 1, 0, len(pool_pts), len(pool_pts) + 1]
    a, b = (rows[torch.tensor(p, device=device)].contiguous() for p in pick)
    # one-row sides: 4-torsion coset rows (Z scaled), as a cursor or step point
    a_one, b_one = (rows[len(pool_pts) + k : len(pool_pts) + k + 1] for k in (1, 6))
    cases = [(f"1 x {n_}", a_one, b[:n_], 0) for n_ in K8_EDGE_COUNTS]
    cases += [(f"{n_} x 1", a[:n_], b_one, 0) for n_ in K8_EDGE_COUNTS]
    cases += [(f"{r} x {c}", a[:r], b[:c], 0) for r, c in K8_GRIDS]
    (r_b, c_b), (r_d, c_d) = K8_GRIDS[-2:]
    cases += [(f"{r_b} x {c_b}, no sums (a table launch)", a[:r_b], b[:c_b], None),
              (f"{r_d} x {c_d}, the last column's sums (a decode group)", a[:r_d], b[:c_d], c_d - 1)]
    results = []
    for what, a_, b_, sums_from in cases:
        a_, b_ = a_.contiguous(), b_.contiguous()
        got, want = K.add_compress(a_, b_, sums_from), K.add_compress_plain(a_, b_, sums_from)
        results.append(expect_equal(f"K8 encodings, {what}", got[0].reshape(-1, 32), want[0].reshape(-1, 32)))
        if sums_from is not None:
            results.append(expect_equal(f"K8 sums, {what}", got[1].reshape(-1, 72), want[1].reshape(-1, 72)))
    r, c = K8_GRIDS[1]
    enc = K.add_compress(a[:r].contiguous(), b[:c].contiguous())[0].cpu().numpy()
    for i, j in sorted({*((k % r, k) for k in range(min(40, c))), (r - 1, c - 1), (r - 1, 0)}):
        if bytes(enc[i, j]) != (pts[pick[0][i]] + pts[pick[1][j]]).compress():
            raise AssertionError(f"K8 lane ({i}, {j}) disagrees with pyref")
    return worst(*results)


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
    keeps (clones of) the inputs of the call with the most work items.  For
    K3 it also keeps the first inputs of each shape it is called at, with
    the number of calls (``shapes``).  With ``keep_all`` it keeps the inputs
    of every call (``calls``)."""

    def __init__(self, module, name, keep_all=False):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None
        self.size = -1
        self.shapes = {}
        self.keep_all = keep_all
        self.calls = []

    def __call__(self, *args):
        if self.name in ("windowed_lanes_k8", "windowed_lanes_k8_fe15"):
            size = args[0].shape[1]
        elif self.name == "window_sums":
            size = args[0].shape[0] * args[0].shape[1]
        elif self.name == "add_compress":
            size = args[0].shape[0] * args[1].shape[0]
        else:
            size = args[0].shape[0]
        if size > self.size:
            self.size = size
            self.args = tuple(a.clone() if hasattr(a, "clone") else a for a in args)
        if self.name == "tile_sums":
            key = (size, args[1])
            if key not in self.shapes:
                self.shapes[key] = [0, (args[0].clone(), args[1])]
            self.shapes[key][0] += 1
        if self.keep_all:
            self.calls.append(tuple(a.clone() if hasattr(a, "clone") else a for a in args))
        return self.fn(*args)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def counted(fn, record=(), keep_all=False):
    """Run ``fn`` once with the launch counts set to 0 just before and read
    just after, the inputs of the kernels named in ``record`` kept (of every
    call with ``keep_all``), and synchronising CUDA calls counted.  Returns
    (fn's result, launches, number of synchronising calls, {name: Recorder})."""
    import torch

    from xelis_he_tpu_torch.ops import kernels as K

    recorders = {name: Recorder(K, name, keep_all) for name in record}
    for r in recorders.values():
        r.__enter__()
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            K.reset_launches()
            try:
                out = fn()
            finally:
                launches = dict(K.launches)
                torch.cuda.set_sync_debug_mode("default")
    finally:
        for r in recorders.values():
            r.__exit__()
    syncs = [w for w in seen if "called a synchronizing CUDA operation" in str(w.message)]
    return out, launches, len(syncs), recorders


def expect_launched(what: str, launches: dict, used, unused=()) -> None:
    log(f"  {what}: launches {launches}")
    missing = [k for k in used if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what}: kernels not launched: {missing}")
    stray = [k for k in unused if launches[k]]
    if stray:
        raise AssertionError(f"{what}: kernels launched that this path must not run: {stray}")


def no_host_path_blocks() -> None:
    from xelis_he_tpu_torch.metrics import metrics

    n = metrics.snapshot()["counters"].get("verify_batch.host_path_blocks", 0)
    if n:
        raise AssertionError(f"verify_batch.host_path_blocks = {n}: a block left the device path")


def ledger_balances(ledger) -> dict:
    """Every balance as compressed bytes, with each account's nonce."""
    return {pk.data: ({a.data: ct.compress().data for a, ct in acc.balances.items()}, acc.nonce)
            for pk, acc in ledger.accounts.items()}


def main_path(args, accel):
    from xelis_he_tpu_torch import NATIVE_ASSET, ProofVerificationError, verify_batch
    from xelis_he_tpu_torch.bulletproofs.range_proof import RangeProof
    from xelis_he_tpu_torch.metrics import metrics
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
    _, launches, syncs, recorders = counted(lambda: verify_batch(txs, state, accel=accel), DEFAULT_PATH)
    expect_launched("counted verify", launches, DEFAULT_PATH,
                    ("windowed_lanes", "windowed_lanes_k8_fe15", "daa_lanes"))
    from xelis_he_tpu_torch.tx.verify import _collect_compressed

    n_enc = len(_collect_compressed(txs))
    k1_n, k4_n = recorders["decompress"].size, recorders["compress"].size
    log(f"  K1: {launches['decompress']} launch on {k1_n} encodings (the block has {n_enc}); "
        f"K4: {launches['compress']} launch on {k4_n} points")
    if launches["decompress"] != 1 or k1_n != n_enc or launches["compress"] != 1:
        raise AssertionError("K1 must launch once on exactly the block's encodings, and K4 once")
    log(f"  synchronising calls seen: {syncs} (the block's one result pull is expected)")
    if syncs != 1:
        raise AssertionError(f"the default verify made {syncs} synchronising calls, not 1")
    no_host_path_blocks()
    if state.get_bal_decrypted(pk_r, NATIVE_ASSET) != mul_base(10 * len(txs)):
        raise AssertionError("receiver balance is wrong after the verified block")
    log(f"  receiver balance = {10 * len(txs)} (decrypted and checked)")

    times = []
    for it in range(args.iters):
        timed_state = ledger.clone()
        metrics.reset()
        t0 = time.perf_counter()
        verify_batch(txs, timed_state, accel=accel)
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
    return launches, per_tx, recorders, (txs, ledger), ledger_balances(state)


# ---------------------------------------------------------------------------
# phases 6-9: this slice's paths
# ---------------------------------------------------------------------------


def switch_paths(txs, ledger, want_balances):
    """Phase 6: the block through K5 (quad lanes off) and through K6 (the tier
    switch off).  Returns ({kernel: launches}, {kernel: Recorder})."""
    from xelis_he_tpu_torch import verify_batch
    from xelis_he_tpu_torch.metrics import metrics
    from xelis_he_tpu_torch.ops.accel import Accelerator

    launches, recorders = {}, {}
    for what, kwargs, name in (("quad lanes off", {"quad_lanes": False}, "windowed_lanes"),
                               ("tier switch off", {"fe15": True}, "windowed_lanes_k8_fe15")):
        accel = Accelerator(**kwargs)
        verify_batch(txs, ledger.clone(), accel=accel)  # warm-up
        state = ledger.clone()
        metrics.reset()
        t0 = time.perf_counter()
        _, seen, syncs, recs = counted(lambda: verify_batch(txs, state, accel=accel), (name,))
        ms = (time.perf_counter() - t0) * 1e3
        used = ("decompress", name, "tile_sums", "compress")
        expect_launched(f"verify, {what}", seen, used, [k for k in seen if k not in used])
        log(f"  verify, {what}: {ms:.1f} ms, {ms / len(txs):.4f} ms/tx, synchronising calls {syncs}")
        if syncs != 1:
            raise AssertionError(f"verify, {what}: {syncs} synchronising calls, not 1")
        no_host_path_blocks()
        if ledger_balances(state) != want_balances:
            raise AssertionError(f"verify, {what}: balances differ from the default verify's")
        log(f"  verify, {what}: accepted, balances equal to the default verify's")
        launches[name], recorders[name] = seen[name], recs[name]
    return launches, recorders


def generic_msm(rng: random.Random, txs, ledger, accel):
    """Phase 7.  Returns (K7's launches, its Recorder)."""
    import torch

    from xelis_he_tpu_torch import verify
    from xelis_he_tpu_torch.ops.curve import Curve
    from xelis_he_tpu_torch.ops.fe import Field
    from xelis_he_tpu_torch.ops.msm import MsmEngine, decompose_bits
    from xelis_he_tpu_torch.pyref.ristretto import multiscalar_mul

    # one transaction's MSMs, captured from a host verify
    calls = []

    def spy(scalars, points):
        calls.append((list(scalars), list(points)))
        return multiscalar_mul(scalars, points)

    verify(txs[0], ledger.clone(), msm=spy)
    sc, pts = max(calls, key=lambda c: len(c[0]))
    log(f"  one transaction's range-proof MSM: {len(sc)} lanes (padded to {accel._lane_granule(len(sc))})")
    (got, got_rand), launches, syncs, _ = counted(
        lambda: (accel.msm(sc, pts), accel.msm([rng.randrange(L) for _ in sc], pts)))
    expect_launched("accel.msm, K5 branch", launches, ("windowed_lanes", "tile_sums"),
                    ("windowed_lanes_k8", "windowed_lanes_k8_fe15"))
    if not got.is_identity() or got != multiscalar_mul(sc, pts):
        raise AssertionError("accel.msm disagrees with pyref on the range-proof lanes")
    rng_scal = [rng.randrange(L) for _ in sc]
    if accel.msm(rng_scal, pts) != multiscalar_mul(rng_scal, pts) or got_rand.is_identity():
        raise AssertionError("accel.msm disagrees with pyref on random scalars")
    if syncs != 2:
        raise AssertionError(f"two accel.msm calls made {syncs} synchronising calls, not one each")
    if not bool(accel.msm_check(sc, pts)) or bool(accel.msm_check(rng_scal, pts)):
        raise AssertionError("accel.msm_check is wrong on the range-proof lanes")

    # a lane count that fills packed tiles: 4,000 points -> 4,096 lanes, K2
    from xelis_he_tpu_torch.ops.kernels import K_PACK
    from xelis_he_tpu_torch.tx.verify import _collect_compressed

    n_big = K_PACK * accel.tile - 96
    encs = _collect_compressed(txs[:200])
    encs = (encs * (n_big // len(encs) + 1))[:n_big]
    t0 = time.perf_counter()
    big_pts, valid = accel.decompress_many(encs)
    if not all(valid):
        raise AssertionError("decompress_many rejected an encoding of the block")
    big_sc = [rng.randrange(L) for _ in encs]
    got, launches, _, _ = counted(lambda: accel.msm(big_sc, big_pts))
    expect_launched(f"accel.msm, {len(encs)} points", launches, ("windowed_lanes_k8", "tile_sums"),
                    ("windowed_lanes", "windowed_lanes_k8_fe15"))
    if got != multiscalar_mul(big_sc, big_pts):
        raise AssertionError("accel.msm disagrees with pyref on the packed branch")
    log(f"  accel.msm on {len(encs)} points agrees with pyref ({time.perf_counter() - t0:.1f} s with the host reference)")
    # what the host pays to turn big-int points into limb rows, beside the whole call
    t0 = time.perf_counter()
    accel._to_device_points(big_pts, accel._lane_granule(len(big_pts)))
    torch.cuda.synchronize()
    rows_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    accel.msm(big_sc, big_pts)
    log(f"  accel.msm on {len(encs)} points: {(time.perf_counter() - t0) * 1e3:.1f} ms, of which "
        f"_to_device_points (big ints -> limb rows -> upload) {rows_ms:.1f} ms")

    # single transactions, as a node checks them on arrival
    # (every MSM goes to the card, the 19-point sigma check too; the host
    # figure beside it is the same 64 verifies with pyref's MSM)
    sizes = []

    def card_msm(scalars, points):
        sizes.append(len(scalars))
        return accel.msm(scalars, points)

    t0 = time.perf_counter()
    state = ledger.clone()
    _, launches, _, _ = counted(lambda: [verify(tx, state, msm=card_msm) for tx in txs[:64]])
    card_ms = (time.perf_counter() - t0) * 1e3 / 64
    expect_launched("verify(tx, state, msm=accel.msm) x 64", launches, ("windowed_lanes", "tile_sums"))
    if launches["windowed_lanes"] != len(sizes):
        raise AssertionError(f"{len(sizes)} MSMs of the single-transaction verifies made "
                             f"{launches['windowed_lanes']} K5 launches: some ran elsewhere")
    t0 = time.perf_counter()
    state = ledger.clone()
    for tx in txs[:64]:
        verify(tx, state, msm=multiscalar_mul)
    host_ms = (time.perf_counter() - t0) * 1e3 / 64
    log(f"  64 single-transaction verifies: {card_ms:.2f} ms each with accel.msm "
        f"({len(sizes) // 64} MSMs a transaction, of {sorted(set(sizes))} points, one K5 launch and one "
        f"pull each), {host_ms:.2f} ms each with the host's MSM")

    # the double-and-add engine at 512 lanes: K7, then K3
    curve = Curve(Field(accel.device))
    engine = MsmEngine(curve)
    daa_pts, daa_sc = big_pts[:512], big_sc[:512]
    batch = curve.from_points(daa_pts)
    bits = torch.from_numpy(decompose_bits(daa_sc).astype("int64")).to(accel.device)
    res, launches, _, recs = counted(lambda: engine.msm_daa(batch, bits), ("daa_lanes",))
    expect_launched("MsmEngine.msm_daa, 512 lanes", launches, ("daa_lanes", "tile_sums"))
    if curve.to_points(tuple(c[None] for c in res))[0] != multiscalar_mul(daa_sc, daa_pts):
        raise AssertionError("MsmEngine.msm_daa disagrees with pyref")
    daa_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine.msm_daa(batch, bits)
        torch.cuda.synchronize()
        daa_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"  MsmEngine.msm_daa on 512 lanes agrees with pyref; one call {statistics.median(daa_ms):.3f} ms "
        f"(host clock to the end of its device work, median of 5)")
    return launches["daa_lanes"], recs["daa_lanes"]


def signatures_and_conversions(txs, accel) -> None:
    """Phase 8."""
    import numpy as np

    from xelis_he_tpu_torch.elgamal import Signature
    from xelis_he_tpu_torch.tx.verify import _collect_compressed

    entries = []
    for tx in txs:
        entries.append((tx.signature, tx.source.data, tx.source, tx.to_bytes()[0]))
    bad_at = len(entries) // 3
    sig = entries[bad_at][0]
    entries[bad_at] = (Signature(sig.s + 1, sig.e), *entries[bad_at][1:])
    t0 = time.perf_counter()
    ok, launches, syncs, _ = counted(lambda: accel.verify_signatures(entries))
    expect_launched(f"verify_signatures x {len(entries)}", launches, ("windowed_lanes_k8", "compress"))
    if ok != [i != bad_at for i in range(len(entries))]:
        raise AssertionError("verify_signatures: wrong verdicts")
    if syncs != 1:
        raise AssertionError(f"verify_signatures made {syncs} synchronising calls, not 1")
    log(f"  verify_signatures: {len(entries)} signatures, the bad one found, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, one synchronising call")

    encs = _collect_compressed(txs)
    t0 = time.perf_counter()
    (rows, valid), launches, syncs, _ = counted(lambda: accel.decompress_many_lazy(encs))
    expect_launched(f"decompress_many_lazy x {len(encs)}", launches, ("decompress",))
    if not all(valid) or rows.shape != (len(encs), 4, 18) or syncs != 1:
        raise AssertionError("decompress_many_lazy: wrong flags, shape or sync count")
    log(f"  decompress_many_lazy: {len(encs)} encodings in {(time.perf_counter() - t0) * 1e3:.1f} ms, one pull")
    part = encs[:20_000]
    t0 = time.perf_counter()
    pts, valid = accel.decompress_many(part)
    back, launches, syncs, _ = counted(lambda: accel.compress_many(pts))
    expect_launched(f"compress_many x {len(part)}", launches, ("compress",))
    if back != part or not all(valid) or syncs != 1:
        raise AssertionError("compress_many(decompress_many(encodings)) is not the encodings")
    if not np.array_equal(accel._points_to_rows(pts[:64]), rows[:64]):
        raise AssertionError("decompress_many and decompress_many_lazy disagree")
    log(f"  decompress_many -> compress_many round trip on {len(part)} encodings: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")


def python_path(txs, ledger, accel, n_txs: int = 2000) -> None:
    """Phase 9: a block the native engine is told not to take."""
    from xelis_he_tpu_torch import NATIVE_ASSET, verify_batch
    from xelis_he_tpu_torch.metrics import metrics
    from xelis_he_tpu_torch.pyref.ristretto import mul_base

    part = txs[:n_txs]
    pk_r = part[0].data[0].dest_pubkey
    os.environ["XELIS_NATIVE_PREVERIFY"] = "0"
    try:
        state = ledger.clone()
        metrics.reset()
        t0 = time.perf_counter()
        _, launches, syncs, _ = counted(lambda: verify_batch(part, state, accel=accel))
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        del os.environ["XELIS_NATIVE_PREVERIFY"]
    expect_launched(f"Python block path, {len(part)} txs", launches, DEFAULT_PATH)
    snap = metrics.snapshot()
    if "verify_batch.collect" in snap["span_counts"] or "verify_batch.pre_verify" not in snap["span_counts"]:
        raise AssertionError("the block did not go through the Python block path")
    no_host_path_blocks()
    if syncs != 1:
        raise AssertionError(f"the Python block path made {syncs} synchronising calls, not 1")
    if state.get_bal_decrypted(pk_r, NATIVE_ASSET) != mul_base(10 * len(part)):
        raise AssertionError("receiver balance is wrong after the Python block path")
    log(f"  accepted in {ms:.1f} ms, {ms / len(part):.4f} ms/tx, one synchronising call, "
        f"receiver balance = {10 * len(part)}")
    log(f"  metrics: {metrics.json_line()}")


FOLD_LIBRARY = "xelis_he_tpu_torch.hashcore.verifyfold_native"


def fused_block_path(txs, ledger, want_balances, clock_hz):
    """Phase 10: the block through the fused block check, the fold library's
    import made to fail and the native engine told not to take the block
    (both restored after).  Every kernel launch of the counted run is held
    to its plain version.  Returns (the phase's figures, {name:
    (mismatches, max_abs_err)}, a row for each launch)."""
    from xelis_he_tpu_torch import ProofVerificationError, verify_batch
    from xelis_he_tpu_torch.metrics import metrics
    from xelis_he_tpu_torch.ops.accel import Accelerator

    saved = sys.modules.get(FOLD_LIBRARY)
    sys.modules[FOLD_LIBRARY] = None
    os.environ["XELIS_NATIVE_PREVERIFY"] = "0"
    try:
        accel = Accelerator()

        # the accepted block, fused_block_check beside begin/finish (also the warm-up)
        seen = {}
        begin, finish = accel.fused_block_begin, accel.fused_block_finish

        def spy_begin(sigma, sig_entries):
            seen["sigma"], seen["sig_entries"] = sigma, sig_entries
            return begin(sigma, sig_entries)

        def spy_finish(state, range_):
            seen["phases"] = finish(state, range_)
            seen["check"] = accel.fused_block_check(seen["sigma"], range_, seen["sig_entries"])
            return seen["phases"]

        def with_check(block):
            seen.clear()
            accel.fused_block_begin, accel.fused_block_finish = spy_begin, spy_finish
            try:
                verify_batch(block, ledger.clone(), accel=accel)
            finally:
                del accel.fused_block_begin, accel.fused_block_finish
            return seen.get("phases"), seen.get("check")

        t0 = time.perf_counter()
        phases, check = with_check(txs)
        log(f"  accepted block with fused_block_check beside it: {(time.perf_counter() - t0) * 1e3:.1f} ms; "
            f"begin/finish flags {phases}, fused_block_check {check}")
        if phases != check or phases != (True, True, True):
            raise AssertionError("fused_block_check disagrees with begin/finish on the accepted block")

        # the counted run
        state = ledger.clone()
        metrics.reset()
        t0 = time.perf_counter()
        _, launches, syncs, recs = counted(lambda: verify_batch(txs, state, accel=accel), FUSED_PATH, keep_all=True)
        ms = (time.perf_counter() - t0) * 1e3
        snap = metrics.snapshot()
        expect_launched(f"fused block, {len(txs)} txs", launches, FUSED_PATH,
                        [k for k in launches if k not in FUSED_PATH])
        if snap["span_counts"].get("fused_check.pull") != 1 or "verify_batch.range_fold" not in snap["span_counts"]:
            raise AssertionError(f"the block did not go through the fused block check with one pull: {snap}")
        if syncs != 1:
            raise AssertionError(f"the fused block made {syncs} synchronising calls, not 1")
        no_host_path_blocks()
        if ledger_balances(state) != want_balances:
            raise AssertionError("fused block: balances differ from the default verify's")
        spans = {k: round(v * 1e3, 3) for k, v in sorted(snap["span_seconds"].items())}
        log(f"  fused block: accepted in {ms:.1f} ms, {ms / len(txs):.4f} ms/tx, one pull, one synchronising "
            f"call, balances equal to the default verify's")
        log(f"  fused block spans, ms: {json.dumps(spans)}")
        log(f"  fused block counters: {json.dumps(snap['counters'])}")
        log("  every kernel launch of the fused block against its plain version, and timed:")
        errs, rows = each_launch(recs, clock_hz)

        # a tampered signature: rejected as such, fused_block_check alike
        bad = list(txs)
        bad[1] = copy.deepcopy(txs[1])
        bad[1].signature.s = (bad[1].signature.s + 1) % L
        try:
            with_check(bad)
        except ProofVerificationError as e:
            if e.kind != "signature":
                raise AssertionError(f"tampered signature rejected as {e.kind}") from e
            log(f"  tampered signature: rejected ({e}); flags {seen.get('phases')}, "
                f"fused_block_check {seen.get('check')}")
        else:
            raise AssertionError("fused block: a tampered signature was accepted")
        if seen.get("phases") != seen.get("check") or seen.get("phases") != (True, True, False):
            raise AssertionError("fused_block_check disagrees with begin/finish on the tampered block")
    finally:
        del os.environ["XELIS_NATIVE_PREVERIFY"]
        if saved is None:
            sys.modules.pop(FOLD_LIBRARY, None)
        else:
            sys.modules[FOLD_LIBRARY] = saved
    fused = {"txs": len(txs), "ms": ms, "ms_per_tx": ms / len(txs), "spans_ms": spans}
    return fused, errs, rows


def each_launch(recorders, clock_hz) -> tuple[dict, list[dict]]:
    """Every launch the recorders kept, held to its plain version on the same
    inputs and timed on the device: ({name: (mismatches, max_abs_err)}, a
    row for each launch)."""
    from xelis_he_tpu_torch.ops import kernels as K

    errs, rows = {}, []
    for name, rec in recorders.items():
        kernel, plain = rec.fn, getattr(K, name + "_plain")
        results = []
        for i, args in enumerate(rec.calls):
            shape, bound_ms, bound_by = bound(name, args, clock_hz)
            got, want = kernel(*args), plain(*args)
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            n_bad, err = worst(*(expect_equal(f"{name} launch {i + 1} of {len(rec.calls)}, {shape}, output {j}", a, b)
                                 for j, (a, b) in enumerate(pairs)))
            results.append((n_bad, err))
            ms = device_ms(lambda: kernel(*args), KERNELS[name][2])
            log(f"  {name} at {shape}: {ms:.4f} ms on the device (bound {bound_ms:.5f} ms, {bound_by})")
            rows.append({"name": name, "shape": shape, "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "max_mismatch": n_bad, "max_abs_err": err})
        errs[name] = worst(*results)
    return errs, rows


def ecdlp_split(spans: dict, names, per: str | None = None) -> dict:
    """ms of each ``ecdlp.<names>`` span in ``spans`` (a metrics snapshot),
    a call of span ``per`` when given (its mean), else in all."""
    seconds, counts = spans["span_seconds"], spans["span_counts"]
    calls = counts.get(per, 1) if per else 1
    return {k.rsplit(".", 1)[1]: seconds.get(k, 0.0) * 1e3 / calls for k in names}


def ecdlp_path(rng: random.Random, accel):
    """Phase 11: an l1 = 22 table built on the card, checked and saved, and
    par_decode at 8,192 lanes a round.  Returns (K8's launches, its
    Recorder, the phase's figures)."""
    import tempfile

    import numpy as np

    from xelis_he_tpu_torch import scalars
    from xelis_he_tpu_torch.ecdlp import ECDLPArguments, ECDLPTables, par_decode
    from xelis_he_tpu_torch.metrics import metrics
    from xelis_he_tpu_torch.ops import kernels as K
    from xelis_he_tpu_torch.pyref.ristretto import mul_base

    l1, batch = 22, 8192
    values = [rng.randrange(1 << 44) for _ in range(16)]
    neg = -rng.randrange(1, 1 << 39)
    out, split = {}, {}
    build_spans = [f"ecdlp.build.{k}" for k in ("start_rows", "k8", "pull", "sort")]
    group_spans = [f"ecdlp.decode.{k}" for k in ("group", "k8_wait", "pull", "lookup", "confirm")]

    def timed(what, fn):
        metrics.reset()
        before = K.launches["add_compress"]
        t0 = time.perf_counter()
        res = fn()
        out[what + "_s"] = time.perf_counter() - t0
        out[what + "_launches"] = K.launches["add_compress"] - before
        split[what] = metrics.snapshot()
        return res

    def run():
        tables = timed("build", lambda: ECDLPTables.build(l1, accel=accel))
        args = ECDLPArguments(0, 1 << 44)
        got = timed("decode", lambda: [par_decode(tables, mul_base(m), args, accel=accel, batch=batch)
                                       for m in values])
        got_neg = timed("negative", lambda: par_decode(tables, mul_base(neg % scalars.L),
                                                       ECDLPArguments(-(1 << 40), 1 << 40), accel=accel, batch=batch))
        got_none = timed("out_of_range", lambda: par_decode(tables, mul_base((1 << 44) + 12345), args, accel=accel,
                                                            batch=batch))
        return tables, got, got_neg, got_none

    (tables, got, got_neg, got_none), launches, _, recs = counted(run, ("add_compress",))
    expect_launched("ECDLP build and decode", launches, ("add_compress",),
                    [k for k in launches if k != "add_compress"])
    count = 1 << l1
    chains = (4096 - 1).bit_length() + (count // 4096 - 1).bit_length()  # 4,096 baby steps, 1,024 starts
    table_launches = -(-count // (1 << 20))
    if out["build_launches"] != chains + table_launches:
        raise AssertionError(f"the table took {out['build_launches']} K8 launches, not {chains} + {table_launches}")
    out["build_split_ms"] = ecdlp_split(split["build"], build_spans)
    log(f"  table l1 = {l1}: {count} baby steps, {tables.keys.nbytes + tables.idx.nbytes} bytes, "
        f"built in {out['build_s']:.3f} s: {out['build_launches']} K8 launches ({chains} of the doubling chains, "
        f"{table_launches} of 2^20 lanes), one pull, host sort; split ms {json.dumps(out['build_split_ms'])}")
    inv = np.empty(count, dtype=np.int64)
    inv[tables.idx] = np.arange(count)
    edges = [0, 1, 4095, 4096, 4097, (1 << 20) - 1, 1 << 20, count - 1]  # chunks' and launches' edges
    sample = edges + [rng.randrange(count) for _ in range(1024 - len(edges))]
    for i in sample:
        if int(tables.keys[inv[i]]) != int.from_bytes(mul_base(i).compress()[:8], "little"):
            raise AssertionError(f"ECDLP table entry {i} disagrees with pyref")
    if not np.all(tables.keys[1:] >= tables.keys[:-1]):
        raise AssertionError("ECDLP table keys are not sorted")
    log(f"  {len(sample)} sampled entries equal pyref's mul_base(i).compress()[:8]")
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "tables.bin"
        tables.save_flat(path)
        loaded = ECDLPTables.load_flat(path)
        if not (np.array_equal(loaded.keys, tables.keys) and np.array_equal(loaded.idx, tables.idx)):
            raise AssertionError("ECDLP flat table round trip changed the table")
        probe = values[0] % (1 << 30)
        if par_decode(loaded, mul_base(probe), ECDLPArguments(0, 1 << 30), accel=accel, batch=batch) != probe:
            raise AssertionError("par_decode through the loaded table failed")
    log(f"  flat save/load round trip: {16 + 12 * count} bytes, equal, decodes")
    if got != values:
        raise AssertionError(f"par_decode: {got} != {values}")
    if got_neg != neg:
        raise AssertionError(f"par_decode with a negative range_min: {got_neg} != {neg}")
    if got_none is not None:
        raise AssertionError(f"par_decode of a value out of range gave {got_none}")
    rounds = (1 << 44) // (count * batch)
    group = -(-K.K8_FILL_LANES // batch)
    if out["out_of_range_launches"] > -(-rounds // group) + 1:
        raise AssertionError(f"a full walk of {rounds} rounds took {out['out_of_range_launches']} K8 launches")
    out["decode_group_split_ms"] = ecdlp_split(split["decode"], group_spans, "ecdlp.decode.group")
    g = out["decode_group_split_ms"]
    g["python"] = g["group"] - g["k8_wait"] - g["pull"] - g["lookup"] - g["confirm"]
    out["decode_groups"] = split["decode"]["span_counts"].get("ecdlp.decode.group", 0)
    out.update({"l1": l1, "batch": batch, "rounds_a_launch": group, "decodes_per_s": len(values) / out["decode_s"],
                "rounds_full_walk": rounds})
    log(f"  par_decode: 16 values in [0, 2^44) at {batch} lanes a round, {group} rounds a launch ({rounds} rounds "
        f"a full walk) in {out['decode_s']:.3f} s, {out['decodes_per_s']:.2f} decodes a second, "
        f"{out['decode_launches']} K8 launches over {out['decode_groups']} groups; negative range_min ({neg}) in "
        f"{out['negative_s']:.3f} s; out of range -> None, every round, in {out['out_of_range_s']:.3f} s and "
        f"{out['out_of_range_launches']} launches")
    log(f"  one decode group ({group} rounds), mean ms: {json.dumps(g)}")
    return launches["add_compress"], recs["add_compress"], out


def card_points(txs, accel, n: int):
    """n host points: the block's encodings (repeated as needed) through
    ``decompress_many``."""
    from xelis_he_tpu_torch.tx.verify import _collect_compressed

    encs = _collect_compressed(txs)
    encs = (encs * (n // len(encs) + 1))[:n]
    pts, valid = accel.decompress_many(encs)
    if not all(valid):
        raise AssertionError("decompress_many rejected an encoding of the block")
    return pts


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock time of ``fn`` (its result pulled, so it ends after
    its device work), after one warm call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def mesh_path(rng: random.Random, txs, ledger, accel, want_balances, default_k2: int, default_ms_per_tx: float,
              sizes=(64, 512, 49_152)):
    """Phase 11a.  Returns (the phase's figures, {name: (mismatches,
    max_abs_err)} of the K7 and K2 launches held to their plain versions)."""
    import torch

    from xelis_he_tpu_torch import verify_batch
    from xelis_he_tpu_torch.metrics import metrics
    from xelis_he_tpu_torch.ops import kernels as K
    from xelis_he_tpu_torch.ops.accel import Accelerator
    from xelis_he_tpu_torch.parallel import MultiDeviceMsm, ShardedMsm, make_mesh
    from xelis_he_tpu_torch.pyref.ristretto import multiscalar_mul

    twice = make_mesh(devices=["cuda:0", "cuda:0"])
    single = make_mesh()
    log(f"  meshes: {twice} (the card twice) and make_mesh() = {single}")
    out, errs = {"msm": []}, {"daa_lanes": [], "windowed_lanes_k8": []}
    pts = card_points(txs, accel, max(sizes))
    scal = [rng.randrange(L) for _ in pts]
    for n in sizes:
        want = accel.msm(scal[:n], pts[:n])
        if n == 64 and want != multiscalar_mul(scal[:n], pts[:n]):
            raise AssertionError("accel.msm disagrees with pyref at 64 lanes")
        engines = [("ShardedMsm, the card twice", ShardedMsm(twice)),
                   ("MultiDeviceMsm, the card twice", MultiDeviceMsm(twice.devices))]
        if n == sizes[1]:
            engines.append(("ShardedMsm, make_mesh()", ShardedMsm(single)))
        for what, engine in engines:
            got, launches, _, recs = counted(lambda: engine.msm_points(scal[:n], pts[:n]), ("daa_lanes",),
                                             keep_all=True)
            expect_launched(f"{what}, {n} lanes", launches, ("daa_lanes", "tile_sums"))
            if got.compress() != want.compress():
                raise AssertionError(f"{what} at {n} lanes disagrees with accel.msm")
            shards = [c[0].shape[0] for c in recs["daa_lanes"].calls]
            # each K7 launch of a shard held to its plain version, at every size
            errs["daa_lanes"] += [expect_equal(f"K7, a shard of {what}, {n} lanes", K.daa_lanes(*c),
                                               K.daa_lanes_plain(*c)) for c in recs["daa_lanes"].calls]
            ms = host_ms(lambda: engine.msm_points(scal[:n], pts[:n]))
            log(f"  {what}, {n} lanes: equal to accel.msm{' and pyref' if n == 64 else ''}; K7 shards {shards}; "
                f"{ms:.1f} ms a call (host clock)")
            out["msm"].append({"what": what, "lanes": n, "k7_shards": shards, "ms": ms})
            if n == sizes[-1] and engine is engines[0][1]:
                # K7 on one shard against K7 on both shards' lanes in one launch
                half = recs["daa_lanes"].calls[0]
                both = tuple(torch.cat([a, b], dim=-1 if a.dim() == 2 else 0).contiguous()
                             for a, b in zip(half, recs["daa_lanes"].calls[1]))
                errs["daa_lanes"].append(expect_equal(f"K7 on both shards' {both[0].shape[0]} lanes",
                                                      K.daa_lanes(*both), K.daa_lanes_plain(*both)))
                k7 = {"shard_lanes": shards[0], "shard_ms": device_ms(lambda: K.daa_lanes(*half), "daa_lanes_kernel"),
                      "whole_lanes": both[0].shape[0], "whole_ms": device_ms(lambda: K.daa_lanes(*both),
                                                                            "daa_lanes_kernel")}
                out["k7_at_shard_size"] = k7
                log(f"  K7 on the device: one shard of {shards[0]} lanes {k7['shard_ms']:.4f} ms, the "
                    f"{k7['whole_lanes']} lanes in one launch {k7['whole_ms']:.4f} ms")
        out["msm"].append({"what": "accel.msm", "lanes": n, "ms": host_ms(lambda: accel.msm(scal[:n], pts[:n]))})

    # the block on the card twice: K2 twice a chunk, the first chunk's shards held to plain
    sharded = Accelerator(mesh=twice)
    verify_batch(txs, ledger.clone(), accel=sharded)  # warm-up
    state = ledger.clone()
    metrics.reset()
    _, launches, syncs, recs = counted(lambda: verify_batch(txs, state, accel=sharded), ("windowed_lanes_k8",),
                                       keep_all=True)
    expect_launched("sharded verify", launches, DEFAULT_PATH, ("windowed_lanes", "windowed_lanes_k8_fe15"))
    calls = recs["windowed_lanes_k8"].calls
    slots = [c[0].shape[1] for c in calls]
    log(f"  sharded verify: K2 launches {launches['windowed_lanes_k8']} (default verify {default_k2}), "
        f"slots a launch {slots}; synchronising calls {syncs}")
    if launches["windowed_lanes_k8"] != 2 * default_k2 or slots[0] != slots[1]:
        raise AssertionError("the sharded verify must launch K2 twice a chunk, on equal shards")
    no_host_path_blocks()
    if ledger_balances(state) != want_balances:
        raise AssertionError("sharded verify: balances differ from the default verify's")
    errs["windowed_lanes_k8"] += [expect_equal(f"K2, shard {i} of the first chunk", K.windowed_lanes_k8(*calls[i]),
                                               K.windowed_lanes_k8_plain(*calls[i])) for i in (0, 1)]
    # the sharded and the default verify in turns (default, sharded, sharded, default, ...)
    times = {"default": [], "sharded": []}
    for which in ("default", "sharded", "sharded", "default") * 2:
        timed = ledger.clone()
        t0 = time.perf_counter()
        verify_batch(txs, timed, accel=sharded if which == "sharded" else accel)
        times[which].append((time.perf_counter() - t0) * 1e3 / len(txs))
    out["sharded_verify"] = {"k2_launches": launches["windowed_lanes_k8"], "k2_slots": slots,
                             "best_ms_per_tx": min(times["sharded"]), "p50_ms_per_tx": statistics.median(times["sharded"]),
                             "default_best_ms_per_tx": min(times["default"]),
                             "default_p50_ms_per_tx": statistics.median(times["default"]),
                             "phase4_best_ms_per_tx": default_ms_per_tx}
    log(f"  sharded verify: accepted, the default verify's balances; in turns with the default verify, "
        f"best {min(times['sharded']):.4f} ms/tx (default {min(times['default']):.4f}), "
        f"p50 {statistics.median(times['sharded']):.4f} (default {statistics.median(times['default']):.4f})")
    return out, {k: worst(*v) for k, v in errs.items()}


def dcn_path(txs, ledger) -> dict:
    """Phase 11b: two processes share the card over gloo; every process this
    starts is stopped before it returns."""
    import pickle
    import socket
    import tempfile

    from xelis_he_tpu_torch.carry import ledger_snapshot
    from xelis_he_tpu_torch.tx.wire import encode_transaction

    snap = ledger_snapshot(ledger)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tamper in (False, True):
            block = list(txs)
            if tamper:
                block[1] = copy.deepcopy(txs[1])
                block[1].fee = 7  # rank 1's half
            path = pathlib.Path(tmp) / f"block_{int(tamper)}.pkl"
            path.write_bytes(pickle.dumps({"txs": [encode_transaction(tx) for tx in block], "ledger": snap}))
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            t0 = time.perf_counter()
            procs = [subprocess.Popen([sys.executable, "-m", "xelis_he_tpu_torch.parallel._dcn_worker", str(path),
                                       f"127.0.0.1:{port}", "2", str(rank)], cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True) for rank in range(2)]
            results = []
            try:
                for p in procs:
                    stdout, stderr = p.communicate(timeout=600)
                    results.append((p.returncode, stdout, stderr, time.perf_counter() - t0))
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            runs = []
            for rank, (rc, stdout, stderr, wall) in enumerate(results):
                if rc != 0:
                    raise AssertionError(f"dcn worker {rank} exited {rc}: {stderr[-3000:]}")
                lines = stdout.strip().splitlines()
                runs.append({**json.loads(lines[-2]), "verdict": lines[-1], "wall_s": wall})
            want = "REJECT" if tamper else "ACCEPT"
            log(f"  two processes, {'fee tampered on rank 1' if tamper else 'valid block'}: {json.dumps(runs)}")
            if [r["verdict"] for r in runs] != [want, want]:
                raise AssertionError(f"multi-process verify: {[r['verdict'] for r in runs]}, want {want} twice")
            # a worker that crashed rejects too: the tampered fee must be what rejected rank 1, and only it
            errors = [r["error"] and r["error"]["class"] for r in runs]
            if errors != [None, "ProofVerificationError" if tamper else None]:
                raise AssertionError(f"multi-process verify: the shares' errors are {errors}")
            out["tampered" if tamper else "valid"] = runs
    return out


def pippenger_path(rng: random.Random, txs, accel, clock_hz, n: int = 65_536):
    """Phase 11c.  Returns (K9's and K10's launches, their Recorders, the
    phase's figures, {name: (mismatches, max_abs_err)} of the other launches
    held to their plain versions)."""
    import torch

    from xelis_he_tpu_torch.metrics import metrics
    from xelis_he_tpu_torch.ops import kernels as K
    from xelis_he_tpu_torch.ops.curve import Curve
    from xelis_he_tpu_torch.ops.fe import Field
    from xelis_he_tpu_torch.ops.msm import MsmEngine, bucket_runs, decompose_digits
    from xelis_he_tpu_torch.pyref.ristretto import multiscalar_mul

    names = ("bucket_sums", "window_sums")
    engine = MsmEngine(Curve(Field(accel.device)), window=13)
    pts = card_points(txs, accel, n)
    scal = [rng.randrange(L) for _ in pts]
    scal[:4] = [0, 1, L - 1, L - 1]
    got, launches, syncs, recs = counted(lambda: engine.msm_points(scal, pts), names)
    expect_launched(f"MsmEngine.msm_points, {n} points", launches, names,
                    [k for k in launches if k not in names])
    passes = K.k9_passes(n)
    if launches["bucket_sums"] != passes or launches["window_sums"] != 1:
        raise AssertionError(f"msm_points must launch K9's {passes} passes and K10 once: {launches}")
    if got.compress() != accel.msm(scal, pts).compress():
        raise AssertionError("MsmEngine.msm_points disagrees with accel.msm")
    log(f"  msm_points at {n} points, window 13: equal to accel.msm; synchronising calls {syncs}")

    errs = {name: [] for name in names}
    k9_args = recs["bucket_sums"].args
    errs["bucket_sums"].append(expect_equal(f"K9 ({passes} passes), msm_points at {n} points",
                                            K.bucket_sums(*k9_args), K.bucket_sums_plain(*k9_args)))
    k9 = k9_figures(k9_args, clock_hz)
    small, small_launches, _, small_recs = counted(lambda: engine.msm_points(scal[:64], pts[:64]), names,
                                                   keep_all=True)
    if small != multiscalar_mul(scal[:64], pts[:64]):
        raise AssertionError("MsmEngine.msm_points disagrees with pyref at 64 points")
    for name in names:
        errs[name] += [expect_equal(f"{name}, msm_points at 64 points", getattr(K, name)(*c),
                                    getattr(K, name + "_plain")(*c)) for c in small_recs[name].calls]
    # K9 when one bucket holds most of the lanes: every lane but two shares a scalar
    skew_n = min(4096, n)
    skew = [scal[7]] * (skew_n - 2) + [0, L - 1]
    order, offsets = bucket_runs(decompose_digits(skew, 13), 13, accel.device)
    rows = engine.curve.from_points(pts[:skew_n])
    rows = torch.stack(rows, dim=1).to(torch.int32).contiguous()
    before = K.launches["bucket_sums"]
    buckets = K.bucket_sums(rows, order, offsets)
    if K.launches["bucket_sums"] - before != K.k9_passes(skew_n):
        raise AssertionError(f"K9 on {skew_n} lanes must run {K.k9_passes(skew_n)} passes")
    errs["bucket_sums"].append(expect_equal(f"K9 ({K.k9_passes(skew_n)} passes), {skew_n} lanes, one bucket a "
                                            f"window holding {skew_n - 2}", buckets,
                                            K.bucket_sums_plain(rows, order, offsets)))
    skew_k9 = k9_figures((rows, order, offsets), clock_hz)
    total = K.window_sums(buckets)
    errs["window_sums"].append(expect_equal("K10 on those buckets", total, K.window_sums_plain(buckets)))
    if bytes(K.compress(total).cpu().numpy()[0]) != multiscalar_mul(skew, pts[:skew_n]).compress():
        raise AssertionError("K9 and K10 disagree with pyref when one bucket holds most lanes")
    # K10 on one window: the main call's lowest window, and the engine's
    # _window_sum at 64 points against pyref
    main = recs["window_sums"].args[0]
    one = main[:1].contiguous()
    errs["window_sums"].append(expect_equal(f"K10 on one window of {n} points ({K.k10_shape(1, 13)[0]} pieces)",
                                            K.window_sums(one), K.window_sums_plain(one)))
    # K10's Horner steps alone on one quad, from a bucket sum of the main call
    W = main.shape[0]
    point = main[0, :1].contiguous()
    errs["window_sums"].append(expect_equal(f"K10's chain rounds on one quad ({W - 1} windows of 13)",
                                            K.k10_rounds(point, 13, W - 1), K.k10_rounds_plain(point, 13, W - 1)))
    d = decompose_digits(scal[:64], 13)[0]
    got = engine._window_sum(engine.curve.from_points(pts[:64]), d)
    if engine.curve.to_points(tuple(c[None] for c in got))[0] != multiscalar_mul([int(x) for x in d], pts[:64]):
        raise AssertionError("MsmEngine._window_sum disagrees with pyref at 64 points")
    out = {"points": n, "window": 13, "msm_points_ms": host_ms(lambda: engine.msm_points(scal, pts)),
           "accel_msm_ms": host_ms(lambda: accel.msm(scal, pts)), "k9": k9, "k9_skewed": skew_k9,
           "k10": k10_figures(main, clock_hz)}
    out["k10"]["floor"] = k10_floor(point, W, 13)
    out["k10"]["share_of_floor"] = out["k10"]["floor"]["floor_ms"] / out["k10"]["ms"]
    log(f"  K10's chain floor {out['k10']['floor']['floor_ms']:.4f} ms ({out['k10']['floor']['rounds']} quad rounds "
        f"at {out['k10']['floor']['round_us']:.4f} us, K10's own steps on one quad; ms of 1, 2, 4 and 8 chains "
        f"{json.dumps(out['k10']['floor']['chains_ms'])}); K10 at "
        f"{100 * out['k10']['share_of_floor']:.1f}% of it, the chain inside K10 at "
        f"{100 * out['k10']['floor']['floor_ms'] / out['k10']['chain_ms']:.1f}%")
    log(f"  msm_points at {n} points: {out['msm_points_ms']:.1f} ms a call, accel.msm {out['accel_msm_ms']:.1f} ms "
        f"(host clock, median of 3, host decomposition and point rows included)")
    metrics.reset()
    engine.msm_points(scal, pts)
    out["msm_points_spans_ms"] = {k: v * 1e3 for k, v in metrics.snapshot()["span_seconds"].items()}
    log(f"  msm_points's spans, ms (host clock; msm.pull holds the wait for the card): "
        f"{json.dumps(out['msm_points_spans_ms'])}")
    return ({k: launches[k] for k in names}, recs, out, {k: worst(*v) for k, v in errs.items()})


def k10_figures(buckets, clock_hz, shape=None) -> dict:
    """K10 on ``buckets`` (W, 2^c - 1, 4, 18) at ``shape`` (pieces a window,
    quads a piece; default ``k10_shape``): two launches' rows equal (every
    sum in an order the indices fix), the device ms of the whole kernel, of
    phase 1 alone (a launch without the Horner chain) and of phase 1 then
    the chain (a launch whose chain waits on every window first: their
    difference is the chain as it runs inside K10)."""
    import torch

    from xelis_he_tpu_torch.ops import kernels as K

    W, nb = buckets.shape[0], buckets.shape[1] + 1
    shape = shape or K.k10_shape(W, nb.bit_length() - 1)
    first, again = K.window_sums(buckets, shape), K.window_sums(buckets, shape)
    if not torch.equal(first, again):
        raise AssertionError(f"K10 at {shape}: two launches on the same buckets give different rows")
    fn = KERNELS["window_sums"][2]
    out = {"shape": f"{W} windows of {nb - 1} buckets", "pieces_quads": list(shape), "deterministic": True,
           "ms": device_ms(lambda: K.window_sums(buckets, shape), fn),
           "phase1_ms": device_ms(lambda: K.window_sums(buckets, shape, "phase1"), fn),
           "serial_ms": device_ms(lambda: K.window_sums(buckets, shape, "serial"), fn),
           "bound_ms": bound("window_sums", (buckets,), clock_hz)[1]}
    out["chain_ms"] = out["serial_ms"] - out["phase1_ms"]
    log(f"  K10 at {out['shape']}, {shape} (pieces, quads): two launches equal; {out['ms']:.4f} ms on the "
        f"device, phase 1 alone {out['phase1_ms']:.4f} ms, phase 1 then the chain {out['serial_ms']:.4f} ms "
        f"(the chain {out['chain_ms']:.4f} ms), ops bound {out['bound_ms']:.5f} ms")
    return out


def k10_floor(point, W: int, c: int) -> dict:
    """The latency floor of K10's Horner chain over W windows of c bits: its
    2 (W - 1) (c + 1) dependent quad rounds at the latency of a round of
    K10's own steps on one quad with nothing to wait on or load
    (``k10_rounds`` from ``point``).  Device ms of the chain's steps 1, 2, 4
    and 8 times over; the floor is the slope between the two longest runs
    (4 chains' worth of rounds), which leaves out the launch,
    the point's load and the rows' write."""
    from xelis_he_tpu_torch.ops import kernels as K

    ms = {k: device_ms(lambda k=k: K.k10_rounds(point, c, k * (W - 1)), "k10_rounds_kernel") for k in (1, 2, 4, 8)}
    rounds = 2 * (W - 1) * (c + 1)
    floor = (ms[8] - ms[4]) / 4
    return {"rounds": rounds, "chains_ms": {str(k): v for k, v in ms.items()}, "floor_ms": floor,
            "round_us": floor * 1e3 / rounds}


def pass_ms(fn, kernel: str, launches: int, reps: int = 5) -> list[float] | None:
    """Device ms of each of the ``launches`` launches of the CUDA function
    ``kernel`` that one call of ``fn`` makes, in order (torch.profiler, mean
    over ``reps`` calls); None when three traces in a row dropped one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    named = re.compile(rf"\b{kernel}\b")
    fn()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.time_range.end - e.time_range.start) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA and named.search(e.name))
        if len(ev) == reps * launches:
            return [statistics.mean(us for _, us in ev[p::launches]) / 1e3 for p in range(launches)]
    log(f"  the profiler dropped launches of {kernel} in three traces: CUDA events around whole calls instead")
    return None


K9_MS_FROM = ("its passes' profiler records", "CUDA events around whole calls (plan glue and launch gaps included)")


def call_device_ms(fn, kernel: str, launches: int) -> tuple[float, list[float] | None]:
    """(device ms of one call of ``fn``, its launches' ms or None): the sum
    of ``pass_ms``, or CUDA events around single calls (``time_ms``), which
    count the host's launch gaps too; a caller marks which (``K9_MS_FROM``)."""
    ms = pass_ms(fn, kernel, launches)
    return (sum(ms), ms) if ms is not None else (time_ms(fn), None)


def k9_figures(args, clock_hz) -> dict:
    """K9 on ``args``: its passes and each pass's threads, the longest walk
    a thread makes (at most 2^K9_K lanes: a split run's blocks but its
    first hold exactly 2^K9_K), each pass's device ms and their total
    against the bound."""
    from xelis_he_tpu_torch.ops import kernels as K

    rows, order, offsets = args
    plan = list(K.bucket_passes(offsets, rows.shape[0]))
    threads = [int(first[-1]) for _, _, first in plan]
    walk = 0
    for _, length, first in plan:
        blocks = first[1:] - first[:-1]
        whole = length[blocks == 1]  # runs one thread walks whole
        walk = max(walk, int(whole.max()) if whole.numel() else 0, (1 << K.K9_K) if bool((blocks >= 2).any()) else 0)
    if walk > 1 << K.K9_K:
        raise AssertionError(f"a thread of K9 walks {walk} lanes, more than 2^{K.K9_K}")
    total, ms = call_device_ms(lambda: K.bucket_sums(*args), KERNELS["bucket_sums"][2], len(plan))
    shape, bound_ms, bound_by = bound("bucket_sums", args, clock_hz)
    out = {"k": K.K9_K, "passes": len(plan), "threads": threads, "longest_walk": walk, "pass_ms": ms,
           "ms": total, "ms_from": K9_MS_FROM[ms is None], "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / total, "shape": shape}
    log(f"  K9 at {shape}: {len(plan)} passes of {threads} threads, longest walk {walk} lanes (2^k = "
        f"{1 << K.K9_K}); device ms {ms and [round(x, 4) for x in ms]}, total {total:.4f} ({out['ms_from']}) "
        f"against a bound of "
        f"{bound_ms:.5f} ms ({bound_by}): {100 * bound_ms / total:.2f}%")
    return out


def trace_verify(txs, ledger, accel) -> dict:
    """Phase 13: one verify under utils.profiling.trace (torch.profiler, CPU
    and CUDA activity; the trace file goes to a temporary directory).  The
    device is busy for the union of the traced kernels' and copies'
    intervals; the idle share is the rest of the traced verify's wall time,
    which the CPU activity's recording lengthens."""
    import tempfile

    import torch

    from xelis_he_tpu_torch import verify_batch
    from xelis_he_tpu_torch.utils.profiling import annotate, trace

    state = ledger.clone()
    with tempfile.TemporaryDirectory() as tmp, trace(tmp) as prof:
        t0 = time.perf_counter()
        with annotate("chip_smoke.verify_batch"):
            verify_batch(txs, state, accel=accel)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # record_function ranges also appear on the device's timeline, spanning
    # the kernels inside them: those are not device work
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.name != "chip_smoke.verify_batch"
                   and not getattr(e, "is_user_annotation", False))
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    out = {"device_events": len(spans), "device_busy_ms": busy_us / 1e3, "traced_wall_ms": wall_ms,
           "idle_share": 1 - busy_us / 1e3 / wall_ms if spans else None,
           "annotated": any(e.name == "chip_smoke.verify_batch" for e in prof.events())}
    log(f"  trace: {json.dumps(out)}")
    if not spans:
        log("  trace: no device events in the trace; the idle share is not measured")
    return out


# ---------------------------------------------------------------------------
# phase 11d: the roofline probes
# ---------------------------------------------------------------------------


def roofline_probes(args, clock_hz, sass) -> tuple[list[dict], float]:
    """Phase 11d: the three probe scripts (xelis_he_tpu_torch/scripts/
    bench_roofline, bench_fe13, bench_qtile) at PROBE_LANES and launches of
    PROBE_TARGET_MS, every sweep holding every launch to its plain version
    (every lane at 4 reps; a sample at the timed reps, K14's also by value);
    the scripts' lines and sweeps go to chiprun_out/probes.json.  A probe's
    launches are all those of the scripts' run, the 4-rep checks among
    them.  Returns (K11-K14's rows of the kernels line, each at 16,384 lanes
    with its plateau's launch beside it, and K11's measured multiply-adds a
    second)."""
    import torch

    from xelis_he_tpu_torch.ops import kernels as K
    from xelis_he_tpu_torch.scripts import _probe as B
    from xelis_he_tpu_torch.scripts import bench_fe13, bench_qtile, bench_roofline

    device = torch.device("cuda")
    ns = argparse.Namespace(device=device, lanes=PROBE_LANES, target_ms=PROBE_TARGET_MS, end_lanes=262_144,
                            end_slots=B.REF_LANES)
    cache = {}
    K.reset_launches()
    lines = [ln for mod in (bench_roofline, bench_fe13, bench_qtile) for ln in mod.run(ns, cache, log=log)]
    (OUT / "probes.json").write_text(json.dumps({"lines": lines, "sweeps": cache}, indent=1))
    launches = {k: K.launches[k] for k in PROBE_KERNELS}
    expect_launched("roofline probes", launches, PROBE_KERNELS)
    peak = cache["imad"]["peak"]["muladds_per_s"]

    def bounds(probe, r):
        """(bound ms, bound ms at the measured peak, what bounds it) of the
        sweep row ``r``'s launch."""
        muladds = probe.muladds * r["lanes"] * r["reps"]
        nbytes = probe.rows * r["lanes"] * 4 * (2 + (4 if probe.name == "probe_fe" else 1))
        ops_ms, bytes_ms = muladds / (INT32_LANES * clock_hz) * 1e3, nbytes / MEM_BYTES_PER_S * 1e3
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        return max(ops_ms, bytes_ms), max(muladds / peak * 1e3, bytes_ms), by

    rows = []
    for name in PROBE_KERNELS:
        m = cache[PROBE_ROWS[name]]
        r, probe = m["ref"], B.PROBES[m["label"]]
        x, y = B.inputs(probe, r["lanes"], device)
        plain_ms = time_ms(lambda: probe.plain(x, y, r["reps"]), reps=1)
        bound_ms, peak_ms, bound_by = bounds(probe, r)
        p = m["plateau"]
        p_bound, p_peak, _ = bounds(probe, p)
        source, replaces, _ = KERNELS[name]
        keep = ("lanes", "reps", "ms", "muladds_per_s", "ops_per_s")
        sweeps = [v for v in cache.values() if v["probe"] == name]
        variants = [{"mode": v["label"], "at_16384": {k: v["ref"][k] for k in keep},
                     "peak": {k: v["peak"][k] for k in keep}, "plateau_lanes": v["plateau"]["lanes"]} for v in sweeps]
        checked = [row for v in sweeps for row in v["sweep"]]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches[name],
               "max_abs_err": max(c["max_abs_err"] for c in checked),
               "max_mismatch": sum(c["mismatches_4_reps"] + c["mismatches_timed_sample"] for c in checked),
               "shape": f"{m['label']}, {r['lanes']} lanes, {r['reps']} reps",
               "ms": r["ms"], "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
               "share_of_bound": bound_ms / r["ms"], "bound_ms_measured_peak": peak_ms,
               "share_of_measured_peak": peak_ms / r["ms"],
               "plateau": {"lanes": p["lanes"], "reps": p["reps"], "ms": p["ms"], "bound_ms": p_bound,
                           "share_of_bound": p_bound / p["ms"], "share_of_measured_peak": p_peak / p["ms"]},
               "variants": variants, "sass_loop_mix": sass.get(name, {})}
        log(f"  {name} at {row['shape']}: {r['ms']:.4f} ms (plain {plain_ms:.1f} ms, bound {bound_ms:.5f} ms, "
            f"{100 * row['share_of_bound']:.1f}%; at the measured peak {100 * row['share_of_measured_peak']:.1f}%); "
            f"plateau {p['lanes']} lanes: {p['ms']:.4f} ms, {100 * p_bound / p['ms']:.1f}% of its bound")
        rows.append(row)
    return rows, peak


# ---------------------------------------------------------------------------
# phase 6: kernel times at the main path's shapes
# ---------------------------------------------------------------------------


def set_bits_253(words) -> int:
    """Set bits among bits 0-252 of K7's (8, N) int32 bit words."""
    import torch

    w = words.to(torch.int64) & 0xFFFFFFFF
    w[7] &= (1 << 29) - 1
    return int(sum(((w >> k) & 1).sum() for k in range(32)))


def bound(name, args, clock_hz, peak=None) -> tuple[str, float, str]:
    """(shape, bound ms, what bounds it) of kernel ``name`` on ``args``: the
    function's 32-bit multiply-adds over the card's INT32 lanes at the max
    SM clock (or over ``peak`` multiply-adds a second, K11's measured
    rate), or its bytes (each input read once, each output written once)
    over the memory rate, whichever is larger."""
    shape, muladds, nbytes = work(name, args)
    ops_ms = muladds / (peak or INT32_LANES * clock_hz) * 1e3
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    return shape, max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def work(name, args) -> tuple[str, int, int]:
    """(shape, 32-bit multiply-adds, bytes) of kernel ``name``'s function on
    ``args``."""
    from xelis_he_tpu_torch.ops import kernels as K

    set_bits = doublings = 0
    if name == "decompress":
        n = args[0].shape[0]
        items, nbytes, shape = n, n * (32 + 288 + 1), f"{n} encodings"
    elif name in ("windowed_lanes_k8", "windowed_lanes_k8_fe15"):
        n = args[0].shape[1]
        items, nbytes, shape = n, n * (8 * 288 + 8 * 64 + 288), f"{n} slots"
    elif name == "tile_sums":
        n, tile = args[0].shape[0], args[1]
        items, nbytes = n - n // tile, (n + n // tile) * 288
        shape = f"{n} rows, tile {tile}"
    elif name == "windowed_lanes":
        n = args[0].shape[0]
        items, nbytes, shape = n, n * (288 + 64 + 288), f"{n} lanes"
    elif name == "daa_lanes":
        n = args[0].shape[0]
        set_bits = set_bits_253(args[1])
        items, nbytes, shape = n, n * (288 + 32 + 288), f"{n} lanes, {set_bits} set bits"
    elif name == "add_compress":
        a, b, sums_from = (*args, None)[:3]  # the build's launches keep no sums
        R, n = a.shape[0], b.shape[0]
        kept = 0 if sums_from is None else R * (n - sums_from)
        items, nbytes = R * n, (R + n + kept) * 288 + R * n * 32
        shape = f"{R * n} lanes ({R} x {n} rows, {kept} sums kept)"
    elif name == "bucket_sums":
        rows, order, offsets = args
        n, w, nb = rows.shape[0], order.shape[0], offsets.shape[1] - 1
        items = K.bucket_additions(offsets)
        nbytes = n * 288 + w * n * 4 + w * (nb + 1) * 4 + w * (nb - 1) * 288
        shape = f"{n} lanes, {w} windows of {nb - 1} buckets, {items} additions"
    elif name == "window_sums":
        w, nb = args[0].shape[0], args[0].shape[1] + 1
        items, doublings = K.window_sums_work(w, nb.bit_length() - 1)
        nbytes = (w * (nb - 1) + 1) * 288
        shape = f"{w} windows of {nb - 1} buckets"
    else:
        n = args[0].shape[0]
        items, nbytes, shape = n, n * (288 + 32), f"{n} points"
    return shape, K.muladds(name, items, set_bits, doublings), nbytes


def k3_shapes(recorder, clock_hz) -> list[dict]:
    """K3 at every other shape it is launched at on the path, the group sums
    of ``sum_points`` among them, each held to its plain version."""
    from xelis_he_tpu_torch.ops import kernels as K

    rows = []
    for (size, tile), (calls, args) in sorted(recorder.shapes.items()):
        if size == recorder.size:
            continue
        expect_equal(f"K3 at {size} rows, tile {tile}", K.tile_sums(*args), K.tile_sums_plain(*args))
        r = {"what": f"{calls} launches", "ms": device_ms(lambda: K.tile_sums(*args), KERNELS["tile_sums"][2]),
             "call_ms": call_ms(lambda: K.tile_sums(*args))}
        r["shape"], r["bound_ms"], r["bound_by"] = bound("tile_sums", args, clock_hz)
        log(f"  tile_sums {r['what']} at {r['shape']}: {r['ms']:.4f} ms on the device, "
            f"{r['call_ms']:.4f} ms a call (bound {r['bound_ms']:.5f} ms)")
        rows.append(r)
    return rows


def kernel_line(recorders, launches, errs, clock_hz, peak):
    """Each path kernel's row of the kernels line, its bound beside the
    bound at ``peak`` multiply-adds a second (K11's measured rate)."""
    import torch

    from xelis_he_tpu_torch.ops import kernels as K

    rows = []
    for name in KERNELS:
        if name in PROBE_KERNELS:
            continue
        args = recorders[name].args
        kernel, plain = getattr(K, name), getattr(K, name + "_plain")
        out_k, out_p = kernel(*args), plain(*args)
        if isinstance(out_k, tuple):  # K8's sums are None where a launch keeps none
            res = worst(*(expect_equal(f"{name} (main-path shape) {i}", a, b)
                          for i, (a, b) in enumerate(zip(out_k, out_p)) if a is not None or b is not None))
        else:
            res = expect_equal(f"{name} (main-path shape)", out_k, out_p)
        n_bad, err = worst(res, errs[name])
        extra = {}
        if name == "bucket_sums":  # one call is its passes: their device time together
            ms, passes = call_device_ms(lambda: kernel(*args), KERNELS[name][2], K.k9_passes(args[0].shape[0]))
            extra["ms_from"] = K9_MS_FROM[passes is None]
        else:
            ms = device_ms(lambda: kernel(*args), KERNELS[name][2])
        one_call_ms = call_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: plain(*args), reps=3)  # seconds each at these shapes
        shape, bound_ms, bound_by = bound(name, args, clock_hz)
        peak_ms = bound(name, args, clock_hz, peak)[1]
        source, replaces, _ = KERNELS[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "max_mismatch": n_bad,
            "shape": shape, "ms": ms, "call_ms": one_call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "share_of_bound": bound_ms / ms,
            "bound_ms_measured_peak": peak_ms, "share_of_measured_peak": peak_ms / ms, **extra,
        })
        log(f"  {name} at {shape}: {ms:.4f} ms on the device, {one_call_ms:.4f} ms a call "
            f"(plain {plain_ms:.1f} ms, bound {bound_ms:.5f} ms)")
        if name == "tile_sums":
            rows[-1]["variants"] = k3_shapes(recorders[name], clock_hz)
    torch.cuda.synchronize()
    return rows


def ptxas_info(log: str, kernel: str) -> dict:
    """Registers, stack frame, spill stores and loads, and shared memory of
    the CUDA function named ``kernel``, from an ``nvcc -Xptxas -v`` log."""
    lines = log.splitlines()
    for at, line in enumerate(lines):
        if "Function properties for" in line and kernel in line.split("for", 1)[1]:
            info = {}
            for nxt in lines[at + 1 : at + 4]:
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", nxt)
                if m:
                    info["stack"], info["spill_stores"], info["spill_loads"] = map(int, m.groups())
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    info["registers"] = int(m.group(1))
                    sm = re.search(r"(\d+) bytes smem", nxt)
                    info["smem"] = int(sm.group(1)) if sm else 0
            return info
    raise RuntimeError(f"ptxas reported nothing for {kernel}")


def resident_blocks(regs: int, threads: int, smem: int = 0) -> int:
    """Blocks of ``threads`` an SM can hold at ``regs`` registers a thread
    (allocated 256 a warp) and ``smem`` bytes of shared memory a block (1 KB
    more reserved), within 2,048 threads and 32 blocks an SM."""
    warp_regs = -(-regs * 32 // 256) * 256
    warps = -(-threads // 32)
    return min(65536 // (warp_regs * warps), 2048 // threads, 32, 233472 // (smem + 1024))


SASS_CLASSES = ("IMAD.WIDE", "IMAD.HI", "IMAD", "IADD3", "SHF", "LOP3", "LEA")
# integer opcodes by the pipe that issues them (16 lanes a clock an SM
# sub-partition each): the FMA pipe runs IMAD in every form (WIDE, HI, SHL,
# MOV, IADD), the ALU pipe the adds, logic, shifts, LEA and compares
SASS_ALU = ("IADD3", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PRMT", "IMNMX", "IABS", "FLO", "POPC", "PLOP3")


def sass_function(lib: pathlib.Path, kernel: str) -> str:
    """The SASS (cuobjdump) of the CUDA function whose name contains
    ``kernel`` in the built library ``lib``, with the device functions it
    calls."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                     "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = next((f for f in funcs[1:] if kernel in f.split("\n", 1)[0]), None)
    if body is None:
        raise RuntimeError(f"cuobjdump shows no function {kernel} in {lib}")
    return body


def sass_class_mix(ops) -> dict:
    mix = {c: 0 for c in SASS_CLASSES}
    for op in ops:
        cls = next((c for c in SASS_CLASSES if op.startswith(c)), "other")
        mix[cls] = mix.get(cls, 0) + 1
    mix["total"] = len(ops)
    return mix


def sass_pipe_mix(ops) -> dict:
    """Instructions by pipe (``fma``, ``alu``, ``other``: memory, control,
    moves) and by opcode."""
    import collections

    by_op = collections.Counter(ops)
    fma = sum(n for op, n in by_op.items() if op.startswith("IMAD"))
    alu = sum(n for op, n in by_op.items() if op.split(".")[0] in SASS_ALU)
    return {"fma": fma, "alu": alu, "other": len(ops) - fma - alu, "total": len(ops),
            "by_op": dict(by_op.most_common())}


def sass_function_mix(lib: pathlib.Path, kernel: str) -> dict:
    """Instruction count by class of the whole of ``kernel``'s SASS (its
    callees included): K14's fe15 loop only calls fe_mul."""
    body = sass_function(lib, kernel)
    return sass_class_mix([m.group(1).split()[0] for m in
                           (re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?(.*?)\s*;", ln)
                            for ln in body.splitlines()) if m])


def sass_loop_mix(lib: pathlib.Path, kernel: str, classify=sass_class_mix) -> dict:
    """Instruction count by class (``classify``: ``sass_class_mix`` or
    ``sass_pipe_mix``) of one fe_sq of kernel ``kernel`` in the
    built library ``lib``: fe_sqn's loops (``#pragma unroll 1``) each hold one
    squaring and the loop's own test, so the body that occurs most often
    among the innermost loops of the kernel's SASS (cuobjdump) is one fe_sq.
    (The probes' kernels have one loop, a rep.)"""
    import collections

    body = sass_function(lib, kernel)
    insns, labels, pending = [], {}, []
    for line in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            insns.append((addr, re.sub(r"^@!?U?P\w+\s+", "", m.group(2))))
    loops = []
    for addr, ins in insns:
        if not ins.startswith("BRA"):
            continue
        m = re.search(r"\((\.L_x_\d+)\)", ins) or re.search(r"(0x[0-9a-f]+)", ins)
        target = labels.get(m.group(1)) if m and m.group(1).startswith(".L") else (int(m.group(1), 16) if m else None)
        if target is not None and target <= addr:
            loops.append((target, addr))
    inner = [(a, b) for a, b in loops if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]
    if not inner:
        raise RuntimeError(f"no loop in the SASS of {kernel}")
    bodies = [[ins.split()[0] for addr, ins in insns if a <= addr <= b] for a, b in inner]
    length = collections.Counter(len(x) for x in bodies).most_common(1)[0][0]
    mix = classify(next(x for x in bodies if len(x) == length))
    mix["loops_alike"] = sum(len(x) == length for x in bodies)
    return mix


def kernels_from(root: pathlib.Path, seed: int) -> dict:
    """The kernels of the port checked out at ``root``, at the main path's
    largest shapes: K1 at 290,002 encodings, K2 and K6 at 7,936 slots, K3 at
    6,656 rows in tiles of 512 and at a ``sum_points`` shape (32 rows in tiles
    of 16), K4 at 10,242 points, K5 at 49,152 lanes, and K7 at 512 lanes and
    at 49,152 (a count that fills the card).  Device time and call time (over
    100 calls back to back) of each, on inputs made from ``seed`` (points
    from 1,024 valid encodings through K1, K4's from K2's slot sums, so Z !=
    1), with a digest of each kernel's output (K1's rows and flags, K4's
    bytes, K7's rows, the others' sums encoded by the running tree's K4),
    which any two commits must share; K8, K9, K10 (on K9's output; its
    digest is of the encoding) and the entry points that call them
    (``end_to_end``); ptxas's figures of K1, K4 and K6-K10 and one
    fe_sq's SASS instruction mix of K1 and K4 as that tree builds them."""
    import hashlib

    import numpy as np

    sys.path.insert(0, str(root))
    import torch

    from xelis_he_tpu_torch.ops import _build
    from xelis_he_tpu_torch.ops import kernels as K
    from xelis_he_tpu_torch.pyref.ristretto import mul_base

    if not pathlib.Path(K.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {K.__file__}, not the port at {root}")
    lib_dir = _build.build_all()
    device = torch.device("cuda")
    rng = random.Random(seed)
    gen = torch.Generator(device).manual_seed(seed)

    def pick(src, n):
        return src[torch.randint(0, src.shape[0], (n,), device=device, generator=gen)].contiguous()

    def scalars(n):
        raw = b"".join(rng.randrange(L).to_bytes(32, "little") for _ in range(n))
        return torch.from_numpy(np.frombuffer(raw, np.uint8).reshape(n, 32).copy()).to(device)

    def digest(t):
        return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]

    encs = b"".join(mul_base(rng.randrange(1, L)).compress() for _ in range(1024))
    enc_pool = torch.from_numpy(np.frombuffer(encs, np.uint8).reshape(-1, 32).copy()).to(device)
    pool, valid = K.decompress(enc_pool)
    if not bool(valid.all()):
        raise AssertionError("K1 rejected a valid encoding")
    S = 7936
    pts = pick(pool, 8 * S).reshape(8, S, 4, 18).contiguous()
    dig = K.recode_signed4_torch(scalars(8 * S)).reshape(64, 8, S).permute(1, 0, 2).contiguous()
    k1_in = pick(enc_pool, 290_002)
    k2 = K.windowed_lanes_k8(pts, dig)
    k4_in = pick(k2, 10_242)
    k5_pts, k5_dig = pick(pool, 49_152), K.recode_signed4_torch(scalars(49_152))
    k7_pts, k7_bits = pick(pool, 512), K.pack_bits_torch(scalars(512))
    k3_in = {(n, tile): pick(pool, n) for n, tile in ((6656, 512), (32, 16))}
    k7_full_pts, k7_full_bits = pick(pool, 49_152), K.pack_bits_torch(scalars(49_152))
    cases = [
        ("decompress", "290002 encodings", lambda: K.decompress(k1_in)),
        ("windowed_lanes_k8", f"{S} slots", lambda: K.windowed_lanes_k8(pts, dig)),
        *((("tile_sums", f"{n} rows, tile {tile}", lambda rows=rows, tile=tile: K.tile_sums(rows, tile))
           for (n, tile), rows in k3_in.items())),
        ("compress", "10242 points", lambda: K.compress(k4_in)),
        ("windowed_lanes", "49152 lanes", lambda: K.windowed_lanes(k5_pts, k5_dig)),
        ("daa_lanes", "512 lanes", lambda: K.daa_lanes(k7_pts, k7_bits)),
        ("windowed_lanes_k8_fe15", f"{S} slots", lambda: K.windowed_lanes_k8_fe15(pts, dig)),
        ("daa_lanes", "49152 lanes", lambda: K.daa_lanes(k7_full_pts, k7_full_bits)),
    ]
    out = {"kernels_from": str(root)}
    for name, shape, fn in cases:
        res = fn()
        if name == "decompress":
            d = digest(torch.cat([res[0].reshape(-1, 72), res[1][:, None].to(torch.int32)], dim=1))
        elif name in ("compress", "daa_lanes"):
            d = digest(res)  # K7's rows are bit for bit its function's
        else:
            d = digest(K.compress(res))
        out[f"{name} at {shape}"] = {"ms": device_ms(fn, KERNELS[name][2]), "call_ms": call_ms(fn, 100), "digest": d}
    # K8 on 16 decode rounds of 8,193 lanes (this tree's grid takes them in
    # one launch, an earlier tree's one row a launch: the same encodings),
    # and K9 on the window-13 digits of 65,536 scalars; ms is the device
    # time of the launches one call makes
    from xelis_he_tpu_torch.ops.msm import bucket_runs, decompose_digits

    cursors, offsets_8193 = pick(pool, 16), pick(pool, 8193)
    grid = hasattr(K, "K8_FILL_LANES")

    def k8_rounds():
        if grid:
            return K.add_compress(cursors, offsets_8193, 8192)[0].reshape(-1, 32)
        return torch.cat([K.add_compress(cursors[r : r + 1].contiguous(), offsets_8193, 8192)[0] for r in range(16)])

    k9_rows = pick(pool, 65_536)
    k9_order, k9_offsets = bucket_runs(decompose_digits([rng.randrange(L) for _ in range(65_536)], 13), 13, device)
    k10_in = K.bucket_sums(k9_rows, k9_order, k9_offsets)
    for name, shape, fn in (("add_compress", "16 rounds of 8193 lanes", k8_rounds),
                            ("bucket_sums", "65536 lanes, window 13",
                             lambda: K.bucket_sums(k9_rows, k9_order, k9_offsets)),
                            ("window_sums", "20 windows of 8191 buckets (K9's on 65536 lanes)",
                             lambda: K.window_sums(k10_in))):
        before = K.launches[name]
        res = fn()
        per_call = K.launches[name] - before
        if name == "window_sums":  # trees that add in other orders share the point, not its rows
            res = K.compress(res)
        out[f"{name} at {shape}"] = {"ms": device_ms(fn, KERNELS[name][2]) * per_call, "launches": per_call,
                                     "call_ms": call_ms(fn, 10), "digest": digest(res)}
    out.update(probe_cases(root, device))
    out.update(end_to_end(rng, encs, device))
    torch.cuda.synchronize()
    for name in BUILD_FIGURES:
        fn_name, lib = KERNELS[name][2], LIBS[name]
        # ptxas speaks only when this process compiled the library
        info = ptxas_info(_build.ptxas_log[lib], fn_name) if lib in _build.ptxas_log else {}
        if name in ("decompress", "compress"):
            info["fe_sq_sass"] = sass_loop_mix(lib_dir / f"lib{lib}.so", fn_name)
        out[f"{name} build"] = info
    return out


def probe_cases(root: pathlib.Path, device) -> dict:
    """K12 at 1,048,576 lanes x 8 reps (block 256) and K11's forms (u32,
    wide and, where the tree has it, the high word's) on 131,072 x 18
    elements, in the tree ``kernels_from`` imported: device time (the
    profiler's records over 5 calls) and CUDA events (median of 5 single
    calls), with a digest of the output that any two commits share (K12's
    limbs are _mul_t's), and K12's ptxas figures and SASS counts by pipe of
    its loop (one rep: four _mul_t) as that tree builds it."""
    import hashlib
    import inspect

    import numpy as np
    import torch

    from xelis_he_tpu_torch.ops import _build
    from xelis_he_tpu_torch.ops import probes as PR

    def operands(lanes):
        rng = np.random.default_rng(1)  # the probe scripts' inputs: x below 2^15, y in [1, 2^15)
        x = rng.integers(0, 1 << 15, (18, lanes), dtype=np.uint32)
        y = rng.integers(1, 1 << 15, (18, lanes), dtype=np.uint32)
        return tuple(torch.from_numpy(a.view(np.int32)).to(device) for a in (x, y))

    x12, y12 = operands(1_048_576)
    x11, y11 = operands(131_072)
    cases = [("probe_mul15", "probe_mul15_kernel", "1048576 lanes x 8 reps, block 256",
              lambda: PR.probe_mul15(x12, y12, 8, 256))]
    forms = [("u32", {}, 40), ("wide", {"wide": True}, 16)]
    if "hi" in inspect.signature(PR.probe_imad).parameters:
        forms.append(("hi", {"hi": True}, 40))
    for form, kw, reps in forms:
        kernel = {"u32": "probe_imad_kernel"}.get(form, f"probe_imad_{form}_kernel")
        cases.append(("probe_imad", kernel, f"{form}, 131072 x 18 elements x {reps} reps",
                      lambda kw=kw, reps=reps: PR.probe_imad(x11, y11, reps, **kw)))
    out = {}
    for name, kernel, shape, fn in cases:
        res = fn()
        out[f"{name} at {shape}"] = {
            "ms": device_ms(fn, kernel), "event_ms": time_ms(fn),
            "digest": hashlib.sha256(res.cpu().numpy().tobytes()).hexdigest()[:16]}
    fn_name = "probe_mul15_kernelILi256E"
    info = ptxas_info(_build.ptxas_log["probe_mul15"], fn_name) if "probe_mul15" in _build.ptxas_log else {}
    info["loop_sass"] = sass_loop_mix(_build.build_dir() / "libprobe_mul15.so", fn_name, sass_pipe_mix)
    out["probe_mul15 build"] = info
    log(f"  probes: {json.dumps(out)}")
    return out


def end_to_end(rng: random.Random, encs: bytes, device) -> dict:
    """The entry points that call K8 and K9, on the host's clock (``host_ms``
    after a warm call: the median of 3 for the build and the walk, of 9 for
    the others), in the tree ``kernels_from`` imported:
    the l1 = 22 table, a decode at 8,192 lanes a round whose value lies in
    the first round, a full walk of [0, 2^44) (a value out of range), and
    ``msm_points`` at 65,536 points (window 13; the 1,024 points of ``encs``
    repeated), with a digest of its result that any two commits share."""
    from xelis_he_tpu_torch.ecdlp import ECDLPArguments, ECDLPTables, par_decode
    from xelis_he_tpu_torch.ops.accel import Accelerator
    from xelis_he_tpu_torch.ops.curve import Curve
    from xelis_he_tpu_torch.ops.fe import Field
    from xelis_he_tpu_torch.ops.msm import MsmEngine
    from xelis_he_tpu_torch.pyref.ristretto import mul_base

    accel = Accelerator()
    tables = ECDLPTables.build(22, accel=accel)
    walk = ECDLPArguments(0, 1 << 44)
    first = rng.randrange(1 << 35)  # below 2^22 baby steps x 8,192 giant steps: round 0
    out = {"ecdlp build l1 = 22 ms": host_ms(lambda: ECDLPTables.build(22, accel=accel))}
    for what, m, want in (("a hit in round 0", first, first), ("a full walk", (1 << 44) + 12345, None)):
        point = mul_base(m)
        got = par_decode(tables, point, walk, accel=accel, batch=8192)
        if got != want:
            raise AssertionError(f"par_decode {what}: {got} != {want}")
        out[f"par_decode {what} ms"] = host_ms(lambda point=point: par_decode(tables, point, walk, accel=accel,
                                                                              batch=8192), 9 if want else 3)
    n = 65_536
    pts, valid = accel.decompress_many([encs[i % 1024 * 32 : i % 1024 * 32 + 32] for i in range(n)])
    if not all(valid):
        raise AssertionError("decompress_many rejected a valid encoding")
    scal = [rng.randrange(L) for _ in range(n)]
    engine = MsmEngine(Curve(Field(device)), window=13)
    out[f"msm_points at {n} points ms"] = host_ms(lambda: engine.msm_points(scal, pts), 9)
    out[f"msm_points at {n} points digest"] = engine.msm_points(scal, pts).compress().hex()[:16]
    log(f"  end to end (host clock): {json.dumps(out)}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--txs", type=int, default=10_000, help="transactions in the main-path block")
    ap.add_argument("--iters", type=int, default=3, help="timed verifies of the block")
    ap.add_argument("--seed", type=int, default=1, help="seed of the kernel inputs")
    ap.add_argument("--kernels-from", type=pathlib.Path, default=None, metavar="DIR",
                    help="only time K1-K12 of the port checked out at DIR")
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
    if args.kernels_from is not None:
        print(json.dumps(kernels_from(args.kernels_from, args.seed)), flush=True)
        print(card, flush=True)
        return 0

    from xelis_he_tpu_torch.ops import _build
    from xelis_he_tpu_torch.ops.accel import Accelerator

    from xelis_he_tpu_torch.ops import kernels as K

    lib_dir = _build.build_all()
    log(f"build: {_build.build_seconds:.1f} s")
    (OUT / "ptxas.txt").write_text("\n".join(f"== {k}\n{v}" for k, v in _build.ptxas_log.items()))
    for k, v in _build.ptxas_log.items():
        for line in v.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k}: {line.strip()}")
    # K1, K4 and K8 buy resident warps with registers: their figures, and no
    # spills; K6's, K7's, K9's and K10's figures beside them
    builds = {}
    block_threads = {"decompress": 128, "compress": 128, "windowed_lanes_k8_fe15": 32 * K.K6_SPLIT,
                     "daa_lanes": 32, "add_compress": 32, "bucket_sums": 128,
                     "window_sums": 4 * K.k10_shape(20, 13)[1]}
    for name in BUILD_FIGURES:
        threads = block_threads[name]
        info = ptxas_info(_build.ptxas_log[LIBS[name]], KERNELS[name][2])
        dynamic = threads // 4 * K.GE_WORDS * 4 if name == "window_sums" else 0  # K10's buffer, a point a quad
        info["resident_blocks"] = resident_blocks(info["registers"], threads, info["smem"] + dynamic)
        log(f"  {name}: {json.dumps(info)} at {threads} threads a block")
        if name in ("decompress", "compress", "add_compress") and (info["spill_stores"] or info["spill_loads"]):
            raise AssertionError(f"{name}: ptxas spills registers")
        builds[name] = info
    # which instruction a wide multiply-add is (K11's two forms), and the
    # probes' loop bodies
    sass = {}
    for name, fns in PROBE_SASS.items():
        for fn in fns:
            mix = sass_loop_mix(lib_dir / f"lib{LIBS[name]}.so", fn)
            log(f"  SASS loop of {fn}: {json.dumps(mix)}")
            sass.setdefault(name, {})[fn] = mix
    fn = PROBE_SASS["probe_fe"][1]  # fe15's loop is a call: count the called fe_mul with it
    sass["probe_fe"][fn + " (whole)"] = mix = sass_function_mix(lib_dir / f"lib{LIBS['probe_fe']}.so", fn)
    log(f"  SASS of {fn} and the fe_mul it calls: {json.dumps(mix)}")

    log("kernels vs plain (edge cases):")
    errs = check_kernels(random.Random(args.seed), device)

    accel = Accelerator()
    launches, per_tx, recorders, block, balances = main_path(args, accel)
    launches = {k: launches[k] for k in DEFAULT_PATH}

    log("the lane-kernel switches on the same block:")
    seen, recs = switch_paths(*block, balances)
    launches.update(seen)
    recorders.update(recs)
    log("generic MSM:")
    launches["daa_lanes"], recorders["daa_lanes"] = generic_msm(random.Random(args.seed + 1), *block, accel)
    log("signatures and conversions:")
    signatures_and_conversions(block[0], accel)
    log("the Python block path (XELIS_NATIVE_PREVERIFY=0):")
    python_path(*block, accel)
    log("the fused block without the fold library (no verifyfold_native, XELIS_NATIVE_PREVERIFY=0):")
    fused, fused_errs, fused_rows = fused_block_path(*block, balances, clock_hz)
    for name, res in fused_errs.items():
        errs[name] = worst(errs[name], res)
    log("ECDLP:")
    launches["add_compress"], recorders["add_compress"], ecdlp = ecdlp_path(random.Random(args.seed + 2), accel)
    log("the mesh (ShardedMsm, MultiDeviceMsm, Accelerator(mesh=)):")
    mesh, mesh_errs = mesh_path(random.Random(args.seed + 3), *block, accel, balances,
                                launches["windowed_lanes_k8"], per_tx["best_ms_per_tx"])
    for name, res in mesh_errs.items():
        errs[name] = worst(errs[name], res)
    log("multi-process accept (two processes on the card, gloo):")
    dcn = dcn_path(*block)
    log("Pippenger (MsmEngine.msm_points, K9 and K10):")
    pip_launches, pip_recs, pippenger, pip_errs = pippenger_path(random.Random(args.seed + 4), block[0], accel, clock_hz)
    launches.update(pip_launches)
    recorders.update(pip_recs)
    errs.update(pip_errs)

    log("roofline probes (K11-K14; the probe scripts at reduced reps):")
    probe_rows, peak = roofline_probes(args, clock_hz, sass)

    log("kernel times at each kernel's largest launch on its path:")
    rows = kernel_line(recorders, launches, errs, clock_hz, peak) + probe_rows
    for r in rows:
        if r["name"] in builds:
            r["build"] = builds[r["name"]]
        mine = [{"what": "a launch of the fused block without the fold library",
                 **{k: v for k, v in f.items() if k != "name"}} for f in fused_rows if f["name"] == r["name"]]
        if mine:
            r.setdefault("variants", []).extend(mine)
    log("trace of one verify:")
    trace = trace_verify(*block, accel)
    result = json.dumps({"kernels": rows, "txs": args.txs, **per_tx, "fused_block": fused, "ecdlp": ecdlp,
                         "mesh": mesh, "dcn": dcn, "pippenger": pippenger, "measured_peak_muladds_per_s": peak,
                         "trace": trace})
    (OUT / "kernels_line.json").write_text(result)
    print(result, flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
