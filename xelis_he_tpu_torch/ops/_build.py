"""Builds the CUDA kernels of ``xelis_he_tpu_torch/csrc`` and loads them.

Each ``<name>.cu`` compiles with nvcc into its own plain-C shared library
(``lib<name>.so``), loaded with ctypes.  All sources build at once, one nvcc
process each, into ``<repo>/build/xelis_he_tpu_torch/<hash>/`` where the
hash covers every source and the flags: a change to any kernel or to the
shared header builds afresh, and an unchanged tree reuses its libraries.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "xelis_he_tpu_torch"
KERNELS = ("decompress", "windowed_lanes", "tile_sums", "compress")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_vp, _int = ctypes.c_void_p, ctypes.c_int
# C entry points: every pointer and the stream are void*, counts are int;
# each returns the cudaError_t of its launch
SIGNATURES = {
    "decompress": ("xhe_decompress", [_vp, _vp, _vp, _int, _vp]),
    "windowed_lanes": ("xhe_windowed_lanes_k8", [_vp, _vp, _vp, _int, _vp]),
    "tile_sums": ("xhe_tile_sums", [_vp, _vp, _int, _int, _vp]),
    "compress": ("xhe_compress", [_vp, _vp, _int, _vp]),
}

_lock = threading.Lock()
_fns: dict[str, ctypes._CFuncPtr] = {}
build_seconds: float | None = None
ptxas_log: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def build_dir() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> pathlib.Path:
    """Compile every missing library (in parallel); raise on any failure."""
    global build_seconds
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    nvcc = None
    for name in KERNELS:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out / f".lib{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        ptxas_log[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return out


def kernel_fn(name: str):
    """The ctypes entry of kernel ``name`` (builds everything on first use)."""
    fn = _fns.get(name)
    if fn is None:
        with _lock:
            if not _fns:
                out = build_all()
                for kname, (sym, argtypes) in SIGNATURES.items():
                    f = getattr(ctypes.CDLL(str(out / f"lib{kname}.so")), sym)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                    _fns[kname] = f
            fn = _fns[name]
    return fn
