"""The port stands alone: it imports nothing of JAX or of the JAX package, and
its copy of the host layer has not drifted from the JAX package's.

The host layer (pyref, hashcore and its C++, transcripts, sigma and range
proofs, the transaction model) imports no JAX, so the port keeps a
byte-identical copy of it, with the package name changed and citations of
the reference crate written as ``xelis-he/<path>``.  Only one edit is
deliberate: the port's cache root (utils/cachedir.py).  The modules of
``PORTED`` are rebuilt on torch, not copied: ops/msm.py runs both engines on
the port's kernels (Pippenger on the bucket and window kernels, double-and-
add on the lanes kernel), tx/verify.py, beside the torch device glue, drops
the JAX device pump and the small-block host crossover, ecdlp.py runs its
table build and giant-step rounds on the port's add-and-compress kernel,
parallel/ shards lanes over a list of torch devices and decides a block over
torch.distributed, and utils/profiling.py traces with torch.profiler.  What
those modules keep of the JAX package's (ecdlp.py's arguments, the table's
files and lookups and the host walk of ``decode``; ops/msm.py's scalar
decompositions and window constants; the mesh axis, ``shard_round_robin``,
the parallel package's exports and ``kernel_report``) is copied, and each of
those definitions is held to the JAX package's (``COPIED_DEFS``); the JAX-only
helpers of ``OMITTED`` are not carried at all."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "xelis_he_tpu_torch"
JAX_PKG = REPO / "xelis_he_tpu"

# modules rebuilt on torch rather than copied
PORTED = {"__init__.py", "ecdlp.py", "ops/fe.py", "ops/curve.py", "ops/msm.py", "ops/accel.py", "tx/verify.py",
          "parallel/__init__.py", "parallel/mesh.py", "parallel/dcn.py", "utils/profiling.py"}
# citations of the reference crate name a checkout directory in the JAX
# package; the port writes them as paths inside the crate
CITATION = re.compile(r"/\w+/reference/")
# the deliberate edits of the copy: (regex over the original, port text)
EDITS = {
    "utils/cachedir.py": [
        # the docstring's note on why caches live in the repo
        (r"``~/\.cache`` so they survive environment resets: .*?\n\n",
         "``~/.cache`` so they survive environment resets: a cold start of a\n"
         "checkout finds the tables it built before.\n\n"),
        (re.escape('        return repo / ".cache"\n'),
         "        # the port's own subtree: never beside the JAX package's committed\n"
         "        # .cache/bpgens_*.bin files\n"
         '        return repo / ".cache" / "torch"\n'),
    ],
}

# the definitions of a PORTED module that the port rebuilds on torch; every
# other top-level or class-level definition of the JAX package's module is a
# copy that must not drift
REBUILT = {
    "ecdlp.py": {"ECDLPTables.build", "par_decode"},
    "ops/msm.py": {"_combine_seg", "_inclusive_scan", "_tree_reduce", "MsmEngine", "MsmEngine.__init__",
                   "MsmEngine._window_sum", "MsmEngine.msm", "MsmEngine.msm_daa_lanes", "MsmEngine.msm_daa",
                   "MsmEngine.batch_dual_mul", "MsmEngine.msm_points"},
    "parallel/__init__.py": set(),
    "parallel/mesh.py": {"make_mesh", "ShardedMsm", "ShardedMsm.__init__", "ShardedMsm.msm_device",
                         "ShardedMsm.msm_points", "MultiDeviceMsm", "MultiDeviceMsm.__init__",
                         "MultiDeviceMsm.msm_points"},
    "parallel/dcn.py": {"init_process", "all_reduce_accept", "verify_batch_distributed"},
    "utils/profiling.py": {"trace", "annotate"},
}

# JAX-only helpers of a PORTED module that the port leaves out: no copy of
# theirs is in the port, and each still names a definition on the JAX side
OMITTED = {
    "ops/msm.py": {"decompose_bits_xp"},  # the jit-traceable bit split of the fused-verification jits
}

SOURCES = sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")) + ["chip_smoke.py"]
# the roofline probes and their scripts, new in the port: no JAX counterpart
# module to copy, held to the no-JAX rule like every source
PROBE_MODULES = ("ops/probes.py", "scripts/__init__.py", "scripts/_probe.py", "scripts/bench_roofline.py",
                 "scripts/bench_fe13.py", "scripts/bench_qtile.py")
COPIES = sorted(
    p.relative_to(PORT).as_posix()
    for pattern in ("*.py", "*.cpp", "*.inc")
    for p in PORT.rglob(pattern)
    if p.relative_to(PORT).as_posix() not in PORTED and (JAX_PKG / p.relative_to(PORT)).exists()
)


def _definitions(path: pathlib.Path) -> dict[str, str]:
    """{name: source} of the module's functions, classes and assignments, a
    class's methods as ``Class.method`` and the rest of its body as
    ``Class``; imports and the module docstring are left out."""
    lines = path.read_text().splitlines(keepends=True)

    def source(node):
        first = min([node.lineno] + [d.lineno for d in getattr(node, "decorator_list", [])])
        return "".join(lines[first - 1 : node.end_lineno])

    def name_of(node):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            return node.name
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            return node.targets[0].id
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            return node.target.id
        return None

    defs = {}
    for node in ast.parse("".join(lines), str(path)).body:
        name = name_of(node)
        if isinstance(node, ast.ClassDef):
            rest = []
            for member in node.body:
                if isinstance(member, ast.FunctionDef):
                    defs[f"{name}.{member.name}"] = source(member)
                else:
                    rest.append(source(member))
            defs[name] = "".join(rest)
        elif name is not None:
            defs[name] = source(node)
    return defs


COPIED_DEFS = sorted(
    (rel, name) for rel, rebuilt in REBUILT.items() for name in _definitions(JAX_PKG / rel)
    if name not in rebuilt | OMITTED.get(rel, set())
)


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module)
    return roots


@pytest.mark.parametrize("rel", SOURCES)
def test_port_source_imports_no_jax(rel):
    bad = {m for m in _imported_roots(REPO / rel)
           if m.split(".")[0] == "jax" or m == "xelis_he_tpu" or m.startswith("xelis_he_tpu.")}
    assert not bad, f"{rel} imports {sorted(bad)}"


@pytest.mark.parametrize("rel", COPIES)
def test_host_layer_copy_has_not_drifted(rel):
    want = (JAX_PKG / rel).read_text().replace("xelis_he_tpu", "xelis_he_tpu_torch")
    want = CITATION.sub("xelis-he/", want)
    for old, new in EDITS.get(rel, []):
        want, n = re.subn(old, lambda _: new, want, count=1, flags=re.S)
        assert n == 1, f"{rel}: the JAX package changed where the port's edit sits"
    assert (PORT / rel).read_text() == want


@pytest.mark.parametrize("rel,name", COPIED_DEFS, ids=[f"{r}::{n}" for r, n in COPIED_DEFS])
def test_ported_module_copies_have_not_drifted(rel, name):
    want = CITATION.sub("xelis-he/", _definitions(JAX_PKG / rel)[name].replace("xelis_he_tpu", "xelis_he_tpu_torch"))
    assert _definitions(PORT / rel).get(name) == want


def test_rebuilt_definitions_exist_in_both_packages():
    """The names that ``REBUILT`` exempts from the drift check still name a
    definition on each side, so that the check covers the rest of each module."""
    for rel, rebuilt in REBUILT.items():
        assert rel in PORTED
        assert rebuilt <= set(_definitions(JAX_PKG / rel)) and rebuilt <= set(_definitions(PORT / rel))


@pytest.mark.parametrize("rel,name", sorted((r, n) for r, names in OMITTED.items() for n in names))
def test_omitted_definitions_are_jax_only(rel, name):
    """What ``OMITTED`` leaves out of the drift check is a definition of the
    JAX package's module that the port does not carry."""
    assert rel in PORTED
    assert name in _definitions(JAX_PKG / rel) and name not in _definitions(PORT / rel)


def test_copy_covers_the_host_layer():
    """Every host-layer module the issue names is in the copy."""
    for rel in ("pyref/field.py", "hashcore/csrc/keccak_unrolled.inc", "transcript.py", "sigma.py",
                "bulletproofs/range_proof.py", "tx/wire.py", "tx/builder.py", "mock.py", "utils/cachedir.py"):
        assert rel in COPIES


def test_public_names_match_the_jax_package():
    def names(path):
        tree = ast.parse(path.read_text())
        return {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
                for a in node.names}

    assert names(PORT / "__init__.py") == names(JAX_PKG / "__init__.py")


def test_port_verifies_a_block_without_jax_in_the_process():
    """The port builds and verifies a 2-tx block (its own builder, the plain
    kernel versions on the CPU) in a fresh interpreter that never loads jax
    or xelis_he_tpu."""
    code = """
import sys
import torch
torch.set_num_threads(1)
from xelis_he_tpu_torch import NATIVE_ASSET, TransactionBuilder, TransferBuilder, TransfersBuilder, verify_batch
from xelis_he_tpu_torch.mock import Account, GenerationBalance, Ledger
from xelis_he_tpu_torch.ops.accel import Accelerator
from xelis_he_tpu_torch.pyref.ristretto import mul_base
ledger = Ledger()
pk_r = ledger.add_account(Account([(NATIVE_ASSET, 0)]))
txs = []
for i in range(2):
    sender = Account([(NATIVE_ASSET, 100)])
    pk_s = ledger.add_account(sender)
    txs.append(TransactionBuilder(
        version=1, source=pk_s, fee=1, nonce=0,
        data=TransfersBuilder([TransferBuilder(asset=NATIVE_ASSET, amount=10 + i, dest_pubkey=pk_r)]),
    ).build(GenerationBalance({NATIVE_ASSET: 100}, sender), sender.keypair))
verify_batch(txs, ledger, accel=Accelerator(device="cpu", tile=8, qtile=8))
assert ledger.get_bal_decrypted(pk_r, NATIVE_ASSET) == mul_base(21)
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "xelis_he_tpu")))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_probe_modules_import_no_jax():
    """The probe modules are among the sources checked above, are no copy of
    a JAX-package module, and load in a fresh interpreter without jax or
    xelis_he_tpu."""
    assert {f"xelis_he_tpu_torch/{m}" for m in PROBE_MODULES} <= set(SOURCES)
    assert not set(PROBE_MODULES) & set(COPIES)
    code = """
import sys
import xelis_he_tpu_torch.ops.probes
import xelis_he_tpu_torch.scripts.bench_fe13
import xelis_he_tpu_torch.scripts.bench_qtile
import xelis_he_tpu_torch.scripts.bench_roofline
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "xelis_he_tpu")))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
