"""K8's block shape, K9's block size and K10's shape on the card.

    python -m xelis_he_tpu_torch.scripts.bench_k8_k9   (from the repo root)

Each variant is the port's CUDA source with its constants changed (K8's
block shape in csrc/add_compress.cu: ``K8_THREADS`` a block and
``K8_REGISTERS`` a thread at most, which set the warps an SM holds;
``K9_K`` of csrc/ed25519.cuh, log2 of the lanes a thread of K9
walks), built by nvcc into its own directory beside the port's build and
swapped in for the built kernel behind the port's own wrapper.  Every
variant's output is held bit for bit to the built kernel's, which
chip_smoke.py holds to the plain version.  Times are chip_smoke.py's: CUDA
events around one call (K9: all its passes and their glue), the median of
``REPS`` (``time_ms``), and K9's device time, its passes' profiler records
summed over a call (``call_device_ms``).

One JSON line a variant, with ptxas's registers, stack and spills and the
card's name and power limit:
  K8 on a decode group (16 x 8,193 lanes), a table launch (256 x 4,096) and
  grids of 2^15 to 2^20 lanes (ns a lane: how many lanes fill the card);
  K9 on the window-13 digits of 65,536 random scalars and on 4,096 lanes
  that all but two share one scalar: its passes, ms a call and device ms;
  K10 on K9's buckets of those 65,536 lanes at each of ``K10_SHAPES``
  (pieces a window and quads a piece are launch parameters: no build),
  held to the default shape's result by encoding (another shape adds in
  another order), with chip_smoke.py's ``k10_figures``: device ms whole,
  of phase 1 alone and of phase 1 then the Horner chain.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import random
import re
import shutil
import subprocess

import numpy as np
import torch

from ..ops import _build
from ..ops import kernels as K
from ..ops.msm import bucket_runs, decompose_digits
from ..pyref.ristretto import mul_base

L = 2**252 + 27742317777372353535851937790883648493
SEED = 1  # of the inputs
REPS = 5  # timed calls of each shape (median)
# K8's (threads a block, registers a thread at most): warps an SM, 65,536
# registers in units of 256 a warp and whole blocks: 8 at 255 and at 168
# (2 and 3 blocks of 128), 9 at 224 (blocks of 96), 10 at 200 (blocks of
# 64 or 32), 11 at 184 (blocks of 32)
K8_SHAPES = ((128, 255), (128, 168), (96, 224), (64, 200), (32, 200), (32, 184))
K9_KS = (3, 4, 5, 6)
FILL_ROWS = (8, 16, 32, 64, 128, 256)  # grids of FILL_ROWS x 4,096 lanes: 2^15 to 2^20
# K10's (pieces a window, quads a piece) at c = 13, 20 windows: k10_shape's (16, 64) among them
K10_SHAPES = ((8, 32), (16, 16), (16, 32), (16, 64), (32, 32), (32, 64), (64, 64))
OUT = pathlib.Path("chiprun_out") / "k8_k9_variants.json"


def substitute(src: str, values: dict) -> str:
    """``src`` with each ``constexpr int NAME = <n>;`` of ``values`` set to
    its value; raises unless each is defined exactly once."""
    for const, value in values.items():
        src, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};", src)
        if n != 1:
            raise RuntimeError(f"{n} definitions of {const}")
    return src


def build_variants(specs, ptxas_info) -> dict:
    """specs: {tag: (library, file, {constant: value})} -> {tag: (ctypes
    function, ptxas figures)}; one nvcc process a variant, side by side."""
    root = _build.build_dir().parent / "variants"
    procs = {}
    for tag, (lib, file, values) in specs.items():
        out = root / tag
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(_build.CSRC, out)
        (out / file).write_text(substitute((out / file).read_text(), values))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(out), "-o", str(out / f"lib{lib}.so"),
               str(out / f"{lib}.cu")]
        procs[tag] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for tag, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {tag}:\n{log}")
        lib = specs[tag][0]
        sym, argtypes = _build.SIGNATURES[lib]
        fn = getattr(ctypes.CDLL(str(root / tag / f"lib{lib}.so")), sym)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        built[tag] = (fn, ptxas_info(log, f"{lib}_kernel"))
    return built


def k10_lines(CS, card, buckets) -> list[dict]:
    """K10 at each of ``K10_SHAPES`` on ``buckets``, its encoding held to the
    default shape's."""
    clock_hz = float(CS.nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    want = K.compress(K.window_sums(buckets))
    lines = []
    for shape in K10_SHAPES:
        if not torch.equal(K.compress(K.window_sums(buckets, shape)), want):
            raise AssertionError(f"K10 at {shape} differs from the default shape by encoding")
        lines.append({"variant": f"K10 G={shape[0]},Q={shape[1]}", **CS.k10_figures(buckets, clock_hz, shape),
                      "card": card})
        print(json.dumps(lines[-1]), flush=True)
    return lines


def main() -> int:
    import chip_smoke as CS  # its timing and ptxas helpers; run from the repo root

    if not torch.cuda.is_available():
        raise SystemExit("bench_k8_k9: no CUDA device")
    device = torch.device("cuda")
    card = CS.nvidia_smi("name,power.limit")
    rng = random.Random(SEED)
    gen = torch.Generator(device).manual_seed(SEED)
    encs = b"".join(mul_base(rng.randrange(1, L)).compress() for _ in range(1024))
    pool, valid = K.decompress(torch.from_numpy(np.frombuffer(encs, np.uint8).reshape(-1, 32).copy()).to(device))
    if not bool(valid.all()):
        raise AssertionError("K1 rejected a valid encoding")

    def pick(n):
        return pool[torch.randint(0, pool.shape[0], (n,), device=device, generator=gen)].contiguous()

    k8_cases = {"decode group 16 x 8193": (pick(16), pick(8193), 8192), "table launch 256 x 4096":
                (pick(256), pick(4096), None)}
    steps = pick(4096)
    k8_cases.update({f"grid {r} x 4096": (pick(r), steps, None) for r in FILL_ROWS})
    skew = [rng.randrange(L)] * 4094 + [0, L - 1]
    k9_cases = {}
    for what, scal, n in (("65536 lanes", [rng.randrange(L) for _ in range(65_536)], 65_536),
                          ("4096 lanes, all but two alike", skew, 4096)):
        order, offsets = bucket_runs(decompose_digits(scal, 13), 13, device)
        k9_cases[what] = (pick(n), order, offsets)

    k10_in = K.bucket_sums(*k9_cases["65536 lanes"])
    lines = k10_lines(CS, card, k10_in)
    specs = {f"K8_THREADS={t},K8_REGISTERS={r}": ("add_compress", "add_compress.cu",
                                                  {"K8_THREADS": t, "K8_REGISTERS": r}) for t, r in K8_SHAPES}
    specs.update({f"K9_K={k}": ("bucket_sums", "ed25519.cuh", {"K9_K": k}) for k in K9_KS})
    _build.kernel_fn("add_compress")  # the port's own build first, for the reference outputs
    want8 = {what: K.add_compress(*c)[0] for what, c in k8_cases.items()}
    want9 = {what: K.bucket_sums(*c) for what, c in k9_cases.items()}
    built = build_variants(specs, CS.ptxas_info)
    for tag, (fn, figures) in built.items():
        lib = specs[tag][0]
        saved_fn, saved_k = _build._fns[lib], K.K9_K
        _build._fns[lib] = fn
        if lib == "bucket_sums":
            K.K9_K = specs[tag][2]["K9_K"]
        try:
            line = {"variant": tag, **figures}
            if lib == "add_compress":
                for what, c in k8_cases.items():
                    if not torch.equal(K.add_compress(*c)[0], want8[what]):
                        raise AssertionError(f"{tag}: K8 on the {what} differs from the built kernel")
                    call = lambda c=c: K.add_compress(*c)  # noqa: E731
                    call()
                    ms = CS.time_ms(call, REPS)
                    lanes = c[0].shape[0] * c[1].shape[0]
                    line[what] = {"ms": ms, "ns_a_lane": ms * 1e6 / lanes}
            else:
                for what, c in k9_cases.items():
                    if not torch.equal(K.bucket_sums(*c), want9[what]):
                        raise AssertionError(f"{tag}: K9 on {what} differs from the built kernel")
                    call = lambda c=c: K.bucket_sums(*c)  # noqa: E731
                    passes = K.k9_passes(c[0].shape[0])
                    call()
                    device_ms, pass_ms = CS.call_device_ms(call, "bucket_sums_kernel", passes)
                    line[what] = {"ms": CS.time_ms(call, REPS), "device_ms": device_ms, "passes": passes,
                                  "device_ms_from": "profiler" if pass_ms is not None else "cuda events"}
        finally:
            _build._fns[lib], K.K9_K = saved_fn, saved_k
        line["card"] = card
        print(json.dumps(line), flush=True)
        lines.append(line)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
