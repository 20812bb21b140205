"""The port's Accelerator entry points outside block verification (generic
MSM, batch signature checks, conversions, the block context) against the JAX
package's ``Accelerator("numpy")`` and pyref, on identical inputs made from a
seed.  Comparisons are exact.  ``Accelerator(device="cpu")`` runs the
kernels' plain versions; ``torch_carry.plain_calls`` shows which branch a
call took."""

import copy

import numpy as np
import pytest
import torch

from torch_carry import plain_calls
from xelis_he_tpu.elgamal import ElGamalKeypair as JaxKeypair
from xelis_he_tpu.ops.accel import Accelerator as JaxAccelerator
from xelis_he_tpu.pyref.ristretto import mul_base as jax_mul_base
from xelis_he_tpu.pyref.ristretto import multiscalar_mul as jax_multiscalar_mul
from xelis_he_tpu_torch import (
    NATIVE_ASSET, ProofVerificationError, TransactionBuilder, TransferBuilder, TransfersBuilder, verify,
)
from xelis_he_tpu_torch.elgamal import Signature
from xelis_he_tpu_torch.mock import Account, GenerationBalance, Ledger
from xelis_he_tpu_torch.ops.accel import Accelerator
from xelis_he_tpu_torch.pyref import field as pf
from xelis_he_tpu_torch.pyref.ristretto import IDENTITY, L, mul_base, multiscalar_mul
from xelis_he_tpu_torch.types import CompressedPubkey

torch.set_num_threads(1)
RNG = np.random.default_rng(2016)


def _rand_scalars(n):
    raw = RNG.integers(0, 256, size=(n, 40), dtype=np.uint8)
    return [int.from_bytes(r.tobytes(), "little") % L for r in raw]


@pytest.fixture(scope="module")
def accel():
    # K_PACK * tile = 256 lanes fill a packed tile: 128 or 192 padded lanes
    # take the single-lane kernel, 256 the packed one
    return Accelerator(device="cpu", tile=32, qtile=8)


@pytest.fixture(scope="module")
def jax_accel():
    return JaxAccelerator("numpy")


def _taken(calls):
    return {k: v for k, v in calls.items() if v}


@pytest.mark.parametrize("n,branch", [(5, "windowed_lanes"), (20, "windowed_lanes"), (200, "windowed_lanes_k8")])
def test_msm_matches_numpy_accelerator_and_pyref(accel, jax_accel, n, branch):
    gen = _rand_scalars(n)
    scal = _rand_scalars(n)
    scal[0], scal[1], scal[2] = 0, 1, L - 1
    pts, jax_pts = [mul_base(g) for g in gen], [jax_mul_base(g) for g in gen]
    pts[3], jax_pts[3] = IDENTITY, jax_mul_base(0)
    with plain_calls() as calls:
        got = accel.msm(scal, pts)
    took = _taken(calls)
    assert took.pop(branch) == 1 and set(took) == {"tile_sums"}  # however few the points
    assert got.compress() == jax_accel.msm(scal, jax_pts).compress() == multiscalar_mul(scal, pts).compress()
    # the (n, 32) uint8 form of the scalars
    raw = np.frombuffer(b"".join(s.to_bytes(32, "little") for s in scal), np.uint8).reshape(n, 32)
    assert accel.msm(raw, pts).compress() == got.compress()


def test_msm_of_nothing_is_the_identity(accel):
    assert accel.msm([], []) == IDENTITY and accel.msm_check([], []) is True


@pytest.mark.parametrize("n", [4, 40])
def test_msm_check_matches_numpy_accelerator(accel, jax_accel, n):
    gen, scal = _rand_scalars(n), _rand_scalars(n)
    total = jax_multiscalar_mul(scal, [jax_mul_base(g) for g in gen])
    # sum s_i P_i - 1 * total = 0; with another last scalar it is not
    total_scalar = sum(s * g for s, g in zip(scal, gen)) % L
    pts = [mul_base(g) for g in gen] + [mul_base(total_scalar)]
    jax_pts = [jax_mul_base(g) for g in gen] + [total]
    for last, want in ((L - 1, True), (L - 2, False)):
        got = accel.msm_check(scal + [last], pts)
        assert isinstance(got, torch.Tensor) and got.dim() == 0 and got.dtype == torch.bool
        assert bool(got) is want
        # (the numpy accelerator's own msm_check traces a jax loop at this size)
        assert jax_accel.msm(scal + [last], jax_pts).is_identity() is want


def _transfer():
    ledger = Ledger()
    pk_r = ledger.add_account(Account([(NATIVE_ASSET, 0)]))
    sender = Account([(NATIVE_ASSET, 100)])
    pk_s = ledger.add_account(sender)
    tx = TransactionBuilder(
        version=1, source=pk_s, fee=1, nonce=0,
        data=TransfersBuilder([TransferBuilder(asset=NATIVE_ASSET, amount=10, dest_pubkey=pk_r)]),
    ).build(GenerationBalance({NATIVE_ASSET: 100}, sender), sender.keypair)
    return tx, ledger, pk_r


def test_single_transaction_verifies_through_accel_msm(accel):
    """verify(tx, state, msm=accel.msm): one transaction, as a node checks it
    on arrival.  The range proof's MSM goes through the lane kernels."""
    tx, ledger, pk_r = _transfer()
    state = ledger.clone()
    seen = []

    def msm(scalars, points):
        seen.append(len(scalars))
        return accel.msm(scalars, points)

    with plain_calls() as calls:
        verify(tx, state, msm=msm)
    # the sigma check's MSM and the range proof's both ran the lane kernel
    assert len(seen) == 2 and calls["windowed_lanes"] == 2 == calls["tile_sums"]
    assert state.get_bal_decrypted(pk_r, NATIVE_ASSET) == mul_base(10)
    bad = copy.deepcopy(tx)
    bad.fee = 2
    with pytest.raises(ProofVerificationError):
        verify(bad, ledger.clone(), msm=accel.msm)


@pytest.mark.parametrize("quad", [True, False])
def test_verify_signatures_matches_numpy_accelerator(accel, jax_accel, quad):
    n = 5
    keys = [JaxKeypair.keygen_with_secret(s) for s in _rand_scalars(n)]
    msgs = [bytes([i]) * (3 + i) for i in range(n)]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    sigs[2].s = (sigs[2].s + 1) % L  # a bad signature
    jax_entries = [(s, k.pubkey(), k.pubkey().compress(), m) for s, k, m in zip(sigs, keys, msgs)]
    want = jax_accel.verify_signatures(jax_entries)
    assert want == [True, True, False, True, True]
    # the port's entries from bytes: public keys as 32-byte encodings
    entries = [
        (Signature(s.s, s.e), k.pubkey().compress().data, CompressedPubkey(k.pubkey().compress().data), m)
        for s, k, m in zip(sigs, keys, msgs)
    ]
    acc = Accelerator(device="cpu", tile=8, qtile=8, quad_lanes=quad)
    with plain_calls() as calls:
        assert acc.verify_signatures(entries) == want
    took = _taken(calls)
    assert took.get("windowed_lanes_k8" if quad else "windowed_lanes") == 1 and took["compress"] == 1
    assert acc.verify_signatures([]) == []


def _encodings():
    good = [jax_mul_base(s).compress() for s in _rand_scalars(6)] + [bytes(32)]
    top = bytearray(good[0])
    top[31] |= 0x80  # a valid encoding with bit 255 set
    return good + [b"\x03" + bytes(31), (pf.P + 5).to_bytes(32, "little"), bytes(top)], len(good)


def test_decompress_many_matches_numpy_accelerator(accel, jax_accel):
    encs, n_good = _encodings()
    pts, valid = accel.decompress_many(encs)
    jax_pts, jax_valid = jax_accel.decompress_many(encs)
    assert valid == [True] * n_good + [False] * (len(encs) - n_good)
    assert valid == jax_valid  # a valid encoding with bit 255 set is rejected by both
    assert [p.compress() for p in pts[:n_good]] == encs[:n_good] == [p.compress() for p in jax_pts[:n_good]]
    assert all(p == IDENTITY for p in pts[n_good:])  # invalid encodings: the identity
    rows, valid_lazy = accel.decompress_many_lazy(encs)
    jax_rows, _ = jax_accel.decompress_many_lazy(encs)
    assert valid_lazy == valid and rows.dtype == np.uint32 and rows.shape == (len(encs), 4, 18)
    assert np.array_equal(rows[:n_good], jax_rows[:n_good])
    assert accel.decompress_many([]) == ([], [])
    assert accel.decompress_many_lazy([])[0].shape == (0, 4, 18)


def test_compress_many_matches_numpy_accelerator(accel, jax_accel):
    gen = _rand_scalars(9)
    pts = [mul_base(g) for g in gen] + [IDENTITY]
    jax_pts = [jax_mul_base(g) for g in gen] + [jax_mul_base(0)]
    got = accel.compress_many(pts)
    assert got == jax_accel.compress_many(jax_pts) == [p.compress() for p in pts]
    assert accel.compress_many([]) == []


def test_block_context_matches_numpy_accelerator(accel, jax_accel):
    """begin_block / begin_block_async + begin_block_wait: rows, valid flags
    and the encoding -> row map of the valid encodings."""
    encs, n_good = _encodings()
    try:
        rows, valid = accel.begin_block(encs)
        jax_rows, jax_valid = jax_accel.begin_block(encs)
        assert valid == jax_valid == [True] * n_good + [False] * (len(encs) - n_good)
        assert np.array_equal(rows[:n_good], jax_rows[:n_good])
        blk, jax_blk = accel._block_state(), jax_accel._block_state()
        assert blk.index == jax_blk.index == {e: i for i, e in enumerate(encs[:n_good])}
        assert accel.block_valid_flags() == jax_accel.block_valid_flags() == valid
        assert accel.block_row_base() == len(encs)  # K1 runs on the block's real count
        accel.begin_block_async(encs)
        assert accel._block_state().index == {e: i for i, e in enumerate(encs)}  # before the pull: every row
        assert accel.begin_block_wait()[1] == valid
        assert accel.begin_block_wait()[1] == []  # nothing is pending after the pull
        accel.begin_block_async([])
        assert accel.begin_block_wait()[1] == [] and accel.block_row_base() == 0
    finally:
        accel.end_block()
        jax_accel.end_block()
    assert accel._block_state().index == {} and accel._block_state().rows is None


@pytest.mark.parametrize("n", [1, 3, 129])
def test_k1_and_k4_receive_exactly_the_real_count(accel, monkeypatch, n):
    """The block context, decompress_many_lazy and compress_many hand K1 and
    K4 exactly their n rows: no padding to a lane granule."""
    from xelis_he_tpu_torch.ops import kernels as K

    seen = []
    for name in ("decompress", "compress"):
        def spy(t, name=name, fn=getattr(K, name)):
            seen.append((name, t.shape[0]))
            return fn(t)

        monkeypatch.setattr(K, name, spy)
    pts = [mul_base(s) for s in range(1, 4)] * (n // 3 + 1)
    encs = [p.compress() for p in pts[:n]]
    rows = np.frombuffer(bytearray(b"".join(encs)), np.uint8).reshape(n, 32)
    try:
        accel.begin_block_async_rows(rows)
        assert accel.block_row_base() == n
        assert accel.begin_block_wait()[1] == [True] * n
    finally:
        accel.end_block()
    assert accel.decompress_many_lazy(encs)[1] == [True] * n
    assert accel.compress_many(pts[:n]) == encs
    assert seen == [("decompress", n), ("decompress", n), ("compress", n)]


def test_methods_that_still_wait_name_their_roadmap_item(accel):
    """The fused block check (ROADMAP queue 1, item 7) is ported: empty
    groups sum to the identity with one K3 call over the lane tiles and
    none for absent signatures; a range group that does not cancel lowers
    its flag alone, in one dispatch and in two phases."""
    P = mul_base(5)
    with plain_calls() as calls:
        assert accel.fused_block_check(([], []), ([], []), []) == (True, True, True)
    assert (calls["windowed_lanes"], calls["tile_sums"], calls["compress"]) == (1, 1, 1)
    sigma, range_ = ([3, L - 3], [P, P]), ([1], [P])
    assert accel.fused_block_check(sigma, range_, []) == (True, False, True)
    assert accel.fused_block_finish(accel.fused_block_begin(sigma, []), range_) == (True, False, True)


def _no_card(monkeypatch):
    """No CUDA device, and no process-wide accelerator made before."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("xelis_he_tpu_torch.ops.accel._default", None)


def test_entry_points_need_a_card_without_an_accelerator(monkeypatch):
    """Given no accelerator, ``verify_batch``, ``verify``, ``verify_share``
    and ``verify_batch_distributed`` take ``default_accelerator()`` and raise
    as ``Accelerator()`` does, before touching the block: no path goes to
    the host on its own."""
    from xelis_he_tpu_torch import verify_batch
    from xelis_he_tpu_torch.parallel.dcn import verify_batch_distributed, verify_share

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA") as want:
        Accelerator()
    for call in (lambda: verify_batch([], Ledger()), lambda: verify_batch([object()], Ledger(), transactional=True),
                 lambda: verify(object(), Ledger()),
                 lambda: verify_share([object()], Ledger(), process_index=0, num_processes=1),
                 lambda: verify_batch_distributed([object()], Ledger(), process_index=0, num_processes=1)):
        with pytest.raises(RuntimeError, match="CUDA") as got:
            call()
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="accel='cpu'"):
        verify_batch([], Ledger(), accel="cpu")


def test_host_path_only_when_asked(monkeypatch):
    """``accel="host"`` (and pyref's ``multiscalar_mul`` for ``verify``)
    verify one transaction on the reference's host path: accepted, the
    receiver credited, a tampered fee rejected, and no accelerator made."""
    from xelis_he_tpu_torch import verify_batch
    from xelis_he_tpu_torch.parallel.dcn import verify_share

    _no_card(monkeypatch)

    def refuse(*args, **kwargs):
        raise AssertionError("the host path made an accelerator")

    monkeypatch.setattr(Accelerator, "__init__", refuse)
    tx, ledger, pk_r = _transfer()
    for check in (lambda state: verify_batch([tx], state, accel="host"),
                  lambda state: verify_batch([tx], state, accel="host", transactional=True),
                  lambda state: verify(tx, state, msm=multiscalar_mul),
                  lambda state: verify_share([tx], state, accel="host", process_index=0, num_processes=1)):
        state = ledger.clone()
        assert check(state) is None
        assert state.get_bal_decrypted(pk_r, NATIVE_ASSET) == mul_base(10)
    bad = copy.deepcopy(tx)
    bad.fee = 2
    with pytest.raises(ProofVerificationError):
        verify_batch([bad], ledger.clone(), accel="host")
    assert isinstance(verify_share([bad], ledger.clone(), accel="host", process_index=0, num_processes=1),
                      ProofVerificationError)
