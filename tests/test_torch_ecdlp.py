"""The port's ECDLP decoder (xelis_he_tpu_torch.ecdlp) against the JAX
package's (tests/test_ecdlp.py), with small tables: the host build and walk,
``par_decode`` on ``Accelerator(device="cpu")`` (K8's plain version) against
the JAX package's on ``Accelerator("numpy")``, the table built through the
port's device path against the host-built ones, and ElGamal decryption
ending in a decode."""

import pathlib

import numpy as np
import pytest
import torch

from xelis_he_tpu import ecdlp as jax_ecdlp
from xelis_he_tpu.ops.accel import Accelerator as JaxAccelerator
from xelis_he_tpu_torch import scalars
from xelis_he_tpu_torch.ecdlp import ECDLPArguments, ECDLPTables, decode, par_decode
from xelis_he_tpu_torch.elgamal import ElGamalKeypair
from xelis_he_tpu_torch.ops import kernels as K
from xelis_he_tpu_torch.ops.accel import Accelerator
from xelis_he_tpu_torch.pyref.ristretto import IDENTITY, mul_base

# small tensor ops: one intra-op thread, so parallel test workers keep their cores
torch.set_num_threads(1)
TABLES = ECDLPTables.build(8)  # 256 baby steps, on the host
JAX_TABLES = jax_ecdlp.ECDLPTables.build(8)


def _same_table(a, b):
    assert a.l1 == b.l1
    assert np.array_equal(np.asarray(a.keys), np.asarray(b.keys))
    assert np.array_equal(np.asarray(a.idx), np.asarray(b.idx))


@pytest.fixture(scope="module")
def accel():
    return Accelerator(device="cpu", tile=8, qtile=8)


def test_host_table_equals_the_jax_packages():
    _same_table(TABLES, JAX_TABLES)
    assert TABLES.keys[np.nonzero(TABLES.idx == 0)[0][0]] == 0  # the identity encodes as zero bytes


def test_decode_small_values():
    args = ECDLPArguments(range_min=0, range_max=1 << 16)
    for m in (0, 1, 255, 256, 257, 10_000, (1 << 16) - 1):
        assert decode(TABLES, mul_base(m), args) == m


def test_decode_out_of_range_returns_none():
    assert decode(TABLES, mul_base(5000), ECDLPArguments(range_min=0, range_max=1 << 10)) is None


def test_decode_negative_range():
    # -42 * G == (L - 42) * G
    assert decode(TABLES, mul_base(scalars.L - 42), ECDLPArguments(range_min=-500, range_max=500)) == -42


def test_decode_progress_callback():
    seen = []
    decode(TABLES, mul_base((1 << 12) - 1), ECDLPArguments(range_min=0, range_max=1 << 12, progress_fn=seen.append))
    assert seen and seen[-1] <= 1.0


@pytest.mark.parametrize("m, range_min, range_max", [
    (7, 0, 1 << 14), (300, 0, 1 << 14), (12_345, 0, 1 << 14), (1 << 15, 0, 1 << 14),
    (scalars.L - 4_321, -5_000, 5_000), ((1 << 14) - 1, 0, 1 << 14),
])
def test_par_decode_matches_the_jax_package(accel, m, range_min, range_max):
    """batch=16 lanes a round: the last round's lanes past the giant-step
    count are skipped; out of range gives None on both."""
    args = ECDLPArguments(range_min=range_min, range_max=range_max)
    want = jax_ecdlp.par_decode(JAX_TABLES, jax_ecdlp.mul_base(m), jax_ecdlp.ECDLPArguments(range_min, range_max),
                                accel=JaxAccelerator("numpy", min_size=4), batch=16)
    K.reset_launches()
    got = par_decode(TABLES, mul_base(m), args, accel=accel, batch=16)
    assert got == want
    assert K.launches["add_compress"] == 0  # CPU tensors: the plain version
    if range_min <= (m if m < scalars.L // 2 else m - scalars.L) < range_max:
        assert got is not None


def test_par_decode_rounds_go_through_add_compress(accel, monkeypatch):
    """A group of rounds is one K8 call: the group's cursors against batch
    + 1 columns (the offsets and the group's big step), only the last
    column's sums kept.  Here all 4 rounds fit one group; progress is
    reported once a round."""
    seen = []

    def spy(a, b, sums_from=None, fn=K.add_compress):
        seen.append((a.shape[0], b.shape[0], sums_from))
        return fn(a, b, sums_from)

    monkeypatch.setattr(K, "add_compress", spy)
    progress = []
    args = ECDLPArguments(0, 1 << 14, progress_fn=progress.append)
    assert par_decode(TABLES, mul_base(1 << 15), args, accel=accel, batch=16) is None
    assert seen == [(4, 17, 16)] and progress == [0.25, 0.5, 0.75, 1.0]


@pytest.mark.parametrize("m, range_min, range_max", [
    (9_000, 0, 1 << 16),  # round 2 of the group of rounds 0-3
    (40_000, 0, 1 << 16),  # round 1 of the third group
    ((1 << 16) - 1, 0, 1 << 16),  # the last lane of the last round
    (1 << 17, 0, 1 << 16),  # out of range: every round, None
    (scalars.L - 10_000, -30_000, 30_000),  # negative, round 0 of the second group
])
def test_par_decode_groups_match_the_jax_package(accel, monkeypatch, m, range_min, range_max):
    """batch=16 with the card's fill cut to 64 lanes: 4 rounds a launch over
    16 rounds (15 for the negative range, whose last group is short).  The
    value, the progress calls and the launches are those of the JAX
    package's one round a dispatch, and the next group is dispatched before
    this one is looked up."""
    monkeypatch.setattr(K, "K8_FILL_LANES", 64)
    want_progress, progress = [], []
    want = jax_ecdlp.par_decode(JAX_TABLES, jax_ecdlp.mul_base(m),
                                jax_ecdlp.ECDLPArguments(range_min, range_max, progress_fn=want_progress.append),
                                accel=JaxAccelerator("numpy", min_size=4), batch=16)
    seen = []

    def spy(a, b, sums_from=None, fn=K.add_compress):
        seen.append(a.shape[0])
        return fn(a, b, sums_from)

    monkeypatch.setattr(K, "add_compress", spy)
    got = par_decode(TABLES, mul_base(m), ECDLPArguments(range_min, range_max, progress_fn=progress.append),
                     accel=accel, batch=16)
    assert got == want and progress == want_progress
    rounds = -(-((range_max - range_min + 255) // 256) // 16)
    assert sum(seen) >= len(progress) and all(r == 4 for r in seen[:-1]) and seen[-1] <= 4
    assert len(seen) == min(-(-rounds // 4), len(progress) // 4 + 2)
    if got is None:
        assert sum(seen) == rounds and progress[-1] == 1.0


def test_par_decode_needs_a_card_without_an_accelerator(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("xelis_he_tpu_torch.ops.accel._default", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        par_decode(TABLES, mul_base(7), ECDLPArguments(0, 1 << 14))


def test_device_built_table_equals_host_and_jax_tables(accel):
    """l1 = 12: one chunk of 4,096 baby steps through K8's plain version."""
    K.reset_launches()
    dev = ECDLPTables.build(12, accel=accel)
    assert K.launches["add_compress"] == 0
    _same_table(dev, ECDLPTables.build(12, accel="host"))
    _same_table(dev, jax_ecdlp.ECDLPTables.build(12))


def test_table_build_needs_a_card_without_an_accelerator(monkeypatch):
    """Given no accelerator, a table of ``chunk`` steps or more is built on
    ``default_accelerator()``, which raises as ``Accelerator()`` does; a
    smaller one stays on the host, as the JAX package builds it; a string
    other than ``"host"`` is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("xelis_he_tpu_torch.ops.accel._default", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ECDLPTables.build(12)
    with pytest.raises(RuntimeError, match="CUDA"):
        ECDLPTables.build(8, chunk=64)
    _same_table(ECDLPTables.build(5), jax_ecdlp.ECDLPTables.build(5))
    with pytest.raises(ValueError, match="accel='cuda'"):
        ECDLPTables.build(12, accel="cuda")


def test_device_build_chains_chunks(accel, monkeypatch):
    """Chunks of 64 at l1 = 8: K8's doubling chains make the baby steps
    j*G (j < 64, six calls) and the starts r*64*G (r < 4, two calls), each
    call the rows so far and the step against the step; then one call of
    the 4 x 64 grid gives the host's table."""
    seen = []

    def spy(a, b, sums_from=None, fn=K.add_compress):
        seen.append((a.shape[0], b.shape[0], sums_from))
        return fn(a, b, sums_from)

    monkeypatch.setattr(K, "add_compress", spy)
    _same_table(ECDLPTables.build(8, accel=accel, chunk=64), TABLES)
    chain = [(m + 1, 1, 0) for m in (1, 2, 4, 8, 16, 32)] + [(2, 1, 0), (3, 1, 0)]
    assert seen == chain + [(4, 64, None)]


def test_table_roundtrip(tmp_path: pathlib.Path):
    path = tmp_path / "tables.npz"
    TABLES.save(path)
    loaded = ECDLPTables.load(path)
    _same_table(loaded, TABLES)
    assert decode(loaded, mul_base(777), ECDLPArguments(0, 1 << 12)) == 777


def test_flat_table_mmap_roundtrip(tmp_path: pathlib.Path):
    path = tmp_path / "tables.bin"
    TABLES.save_flat(path)
    assert path.stat().st_size == 16 + 12 * (1 << TABLES.l1)
    JAX_TABLES.save_flat(tmp_path / "jax.bin")
    assert path.read_bytes() == (tmp_path / "jax.bin").read_bytes()
    mapped = ECDLPTables.load(path)
    assert isinstance(mapped.keys, np.memmap)
    _same_table(mapped, TABLES)
    assert decode(mapped, mul_base(777), ECDLPArguments(0, 1 << 12)) == 777
    ram = ECDLPTables.load_flat(path, mmap=False)
    assert decode(ram, mul_base(901), ECDLPArguments(0, 1 << 12)) == 901
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"NOTATBL!" + path.read_bytes()[8:])
    with pytest.raises(ValueError):
        ECDLPTables.load_flat(bad)


def test_decrypt_then_decode():
    """ElGamal decrypt -> ECDLPInstance -> decode (elgamal.rs:67-92)."""
    keypair = ElGamalKeypair.keygen()
    instance = keypair.secret().decrypt(keypair.pubkey().encrypt(4242))
    assert instance.decode(TABLES, ECDLPArguments(0, 1 << 14)) == 4242


def test_add_compress_plain_matches_pyref():
    """K8's plain version on pyref points, the identity among them: the
    R x n grid, then one row against every column and every row against one
    column; encodings and sums against pyref's addition."""
    pts = [mul_base(s) for s in (1, 2, 3, 12345, scalars.L - 1)] + [IDENTITY]
    acc = Accelerator(device="cpu")
    a = acc._to_device_points(pts)
    b = acc._to_device_points(pts[::-1])
    for ta, tb in ((a, b[:4]), (a[2:3], b), (a, b[:1])):
        ra, rb = (pts[:ta.shape[0]] if ta.shape[0] > 1 else [pts[2]]), pts[::-1][:tb.shape[0]]
        want = [[p + q for q in rb] for p in ra]
        enc, sums = K.add_compress(ta.contiguous(), tb.contiguous(), 1)
        assert enc.shape == (len(ra), len(rb), 32) and sums.shape == (len(ra), len(rb) - 1, 4, 18)
        assert [[bytes(x) for x in row] for row in enc.numpy()] == [[w.compress() for w in row] for row in want]
        got_sums = K.compress(sums.reshape(-1, 4, 18)).numpy()
        assert [bytes(x) for x in got_sums] == [w.compress() for row in want for w in row[1:]]
