"""The port stands alone: it imports nothing of JAX or of the JAX package, and
its copy of the host layer has not drifted from the JAX package's.

The host layer (pyref, hashcore and its C++, transcripts, sigma and range
proofs, the transaction model) imports no JAX, so the port keeps a
byte-identical copy of it, with the package name changed and citations of
the reference crate written as ``xelis-he/<path>``.  Only two edits are
deliberate: the port's cache root (utils/cachedir.py) and ECDLP decoding,
which is not ported yet (elgamal.py).  The port's tx/verify.py is rebuilt,
not copied; beside the torch device glue it drops the JAX device pump and
the small-block host crossover."""

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
PORTED = {"__init__.py", "ops/fe.py", "ops/curve.py", "ops/msm.py", "ops/accel.py", "tx/verify.py"}
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
    "elgamal.py": [
        (re.escape("        from .ecdlp import decode\n\n        return decode(tables, self.point, args)\n"),
         '        raise NotImplementedError("ECDLP is ROADMAP queue 1")\n'),
        (re.escape("        from .ecdlp import par_decode\n\n        return par_decode(tables, self.point, args)\n"),
         '        raise NotImplementedError("ECDLP is ROADMAP queue 1")\n'),
    ],
}

SOURCES = sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")) + ["chip_smoke.py"]
COPIES = sorted(
    p.relative_to(PORT).as_posix()
    for pattern in ("*.py", "*.cpp", "*.inc")
    for p in PORT.rglob(pattern)
    if p.relative_to(PORT).as_posix() not in PORTED and (JAX_PKG / p.relative_to(PORT)).exists()
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
