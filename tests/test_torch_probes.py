"""The roofline probes K11-K14 (xelis_he_tpu_torch/ops/probes.py): their plain
versions against the JAX package's helpers composed as the TPU probe
scripts compose them (scripts/bench_roofline.py, bench_fe13.py), K14 against
Python integers mod p, and the kernels' lane bodies (csrc/probes.cuh, built
for the host with g++) against the plain versions, bit for bit."""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import xelis_he_tpu.ops.pallas_msm as pm
from xelis_he_tpu_torch.ops import kernels as K
from xelis_he_tpu_torch.ops import probes as PR

LANES = 64
REPS = 3
P = 2**255 - 19
M32 = (1 << 32) - 1


def _inputs(rows, bits, seed):
    """The probe scripts' inputs: x below 2^bits, y in [1, 2^bits)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << bits, (rows, LANES), dtype=np.uint32),
            rng.integers(1, 1 << bits, (rows, LANES), dtype=np.uint32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _np(t):
    return t.numpy().view(np.uint32)


def _chained(body, x, y, reps):
    """make_fm's kernel in numpy: 4 chains x + k, ``reps`` rounds of body on
    each, the XOR of the chains."""
    xs = tuple(x + np.uint32(k) for k in range(4))
    for _ in range(reps):
        xs = tuple(body(v, y) for v in xs)
    return xs[0] ^ xs[1] ^ xs[2] ^ xs[3]


def _raw(x, y, reps):
    """make_raw's kernel in numpy: 81 steps of v * y + 1 a rep."""
    def body(v, y):
        for _ in range(81):
            v = v * y + np.uint32(1)
        return v

    with np.errstate(over="ignore"):
        return _chained(body, x, y, reps)


def _mul13_2pass(a, b, jnp):
    """bench_fe13.py's deferred multiplication, from the JAX package's helpers."""
    T = a.shape[1]
    z = lambda r: jnp.zeros((r, T), jnp.uint32)
    acc = jnp.zeros((2 * pm.NL13 - 1, T), dtype=jnp.uint32)
    for j in range(pm.NL13):
        acc = acc + pm._cat([z(j), a * b[j : j + 1], z(pm.NL13 - 1 - j)], jnp)
    hi = acc[pm.NL13 :]
    hi_lo = (hi & jnp.uint32(pm.M13)) * jnp.uint32(608)
    hi_hi = (hi >> 13) * jnp.uint32(608)
    low = acc[: pm.NL13]
    low = low + pm._cat([hi_lo, z(1)], jnp)
    low = low + pm._cat([z(1), hi_hi], jnp)
    return pm._carry13(pm._carry13_wide(low, jnp), jnp)


MUL13_JAX = {
    "3pass": lambda v, y: pm._mul13(v, y, np),
    "2pass_consumer": lambda v, y: pm._carry13(_mul13_2pass(v, y, np), np),
    "2pass": lambda v, y: _mul13_2pass(v, y, np),
}
FE_CASES = [(tier, sq) for tier in ("fe", "fe15") for sq in (False, True)]


def _fe_inputs(tier, seed):
    """Limbs in the tier's widths (the port's carried limbs)."""
    rng = np.random.default_rng(seed)
    widths = PR.FE_WIDTHS if tier == "fe" else (15,) * 18
    x = np.stack([rng.integers(0, 1 << w, LANES, dtype=np.uint32) for w in widths])
    y = np.stack([rng.integers(0, 1 << w, LANES, dtype=np.uint32) for w in widths])
    return x, y


def test_imad_plain_matches_make_raw():
    x, y = _inputs(18, 15, 1)
    assert np.array_equal(_np(PR.probe_imad_plain(_t(x), _t(y), REPS)), _raw(x, y, REPS))


def test_imad_plain_wraps_at_full_width():
    """Any u32 operands, y = 2^32 - 1 (the wide form's y + 1 = 2^32) among them."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 1 << 32, (2, LANES), dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 1 << 32, (2, LANES), dtype=np.uint64).astype(np.uint32)
    y[0, :4] = 0xFFFFFFFF
    assert np.array_equal(_np(PR.probe_imad_plain(_t(x), _t(y), REPS)), _raw(x, y, REPS))
    got = _np(PR.probe_imad_plain(_t(x), _t(y), REPS, wide=True))
    want = np.zeros_like(x)
    for r in range(x.shape[0]):
        for t in range(LANES):
            out = 0
            for k in range(4):
                acc = (int(x[r, t]) + k) & 0xFFFFFFFF
                for _ in range(REPS * 81):
                    acc = ((acc & 0xFFFFFFFF) * int(y[r, t]) + acc) % 2**64
                out ^= (acc & 0xFFFFFFFF) ^ (acc >> 32)
            want[r, t] = out
    assert np.array_equal(got, want)


def test_mul15_plain_matches_mul_t():
    x, y = _inputs(18, 15, 3)
    want = _chained(lambda v, y: pm._mul_t(v, y, np), x, y, REPS)
    assert np.array_equal(_np(PR.probe_mul15_plain(_t(x), _t(y), REPS)), want)


def test_mul15_plain_refuses_limbs_of_16_bits():
    """K12's column-sum form needs every limb below 2^16 (the relaxed limbs
    are at most 2^15 + 2^11): the plain version asserts it of both operands."""
    x, y = _inputs(18, 15, 3)
    x[0, 5] = 1 << 16
    with pytest.raises(AssertionError, match="_mul_t limb of a leaves 16 bits"):
        PR.probe_mul15_plain(_t(x), _t(y), 1)
    x[0, 5], y[17, 0] = 0, 1 << 16
    with pytest.raises(AssertionError, match="_mul_t limb of b leaves 16 bits"):
        PR.probe_mul15_plain(_t(x), _t(y), 1)


def _imad_hi_numpy(x, y, reps):
    """The high form's chains in numpy uint64: x = ((x y) >> 32) + x mod 2^32."""
    c = [(x.astype(np.uint64) + np.uint64(k)) & np.uint64(M32) for k in range(4)]
    y = y.astype(np.uint64)
    for _ in range(reps * 81):
        c = [(((v * y) >> np.uint64(32)) + v) & np.uint64(M32) for v in c]
    return (c[0] ^ c[1] ^ c[2] ^ c[3]).astype(np.uint32)


def test_imad_hi_plain_matches_numpy():
    """K11's high form at full width: any u32 operands, y = 2^32 - 1 among
    them, against numpy's (a b) >> 32 in uint64."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 32, (2, LANES), dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 1 << 32, (2, LANES), dtype=np.uint64).astype(np.uint32)
    y[0, :4] = 0xFFFFFFFF
    got = _np(PR.probe_imad_plain(_t(x), _t(y), REPS, hi=True))
    assert np.array_equal(got, _imad_hi_numpy(x, y, REPS))
    with pytest.raises(ValueError):
        PR.probe_imad_plain(_t(x), _t(y), REPS, wide=True, hi=True)


@pytest.mark.parametrize("mode", PR.MUL13_MODES)
def test_mul13_plain_matches_fe13_helpers(mode):
    x, y = _inputs(20, 13, 4)
    want = _chained(MUL13_JAX[mode], x, y, REPS)
    assert np.array_equal(_np(PR.probe_mul13_plain(_t(x), _t(y), REPS, mode)), want)


@pytest.mark.parametrize("tier,square", FE_CASES)
def test_fe_plain_matches_python_integers(tier, square):
    x, y = _fe_inputs(tier, 5)
    out = PR.probe_fe_plain(_t(x), _t(y), REPS, tier, square).numpy()
    assert out.shape == (4, x.shape[0], LANES)
    for t in range(0, LANES, 7):
        yv = PR.fe_value(y[:, t], tier)
        for k in range(4):
            xk = PR.fe_value(x[:, t] + k, tier)
            want = pow(xk, 2**REPS, P) if square else xk * pow(yv, REPS, P) % P
            assert PR.fe_value(out[k, :, t], tier) == want


def test_fe_tiers_agree_by_value():
    """The same field elements on both tiers give chains of the same values:
    chain 0 starts from x on either tier (chain k from x plus k in every
    limb, a value that depends on the tier), and x_k^-1 times chain k of a
    multiplication is y^reps on both."""
    rng = np.random.default_rng(6)
    vals = [(int(rng.integers(0, 2**63)) << 190 | int(rng.integers(0, 2**63))) % P for _ in range(2 * LANES)]

    def limbs(v, tier):
        if tier == "fe15":
            return [(v >> (15 * i)) & 0x7FFF for i in range(18)]
        offs = [26 * ((i + 1) >> 1) + 25 * (i >> 1) for i in range(10)]
        return [(v >> o) & ((1 << w) - 1) for o, w in zip(offs, PR.FE_WIDTHS)]

    values = {}
    for tier in ("fe", "fe15"):
        x = np.array([limbs(v, tier) for v in vals[:LANES]], dtype=np.uint32).T
        y = np.array([limbs(v, tier) for v in vals[LANES:]], dtype=np.uint32).T
        for square in (False, True):
            out = PR.probe_fe_plain(_t(x), _t(y), REPS, tier, square).numpy()
            values[tier, square] = [PR.fe_value(out[0, :, t], tier) for t in range(LANES)]
            if not square:
                values[tier, "y^reps"] = [
                    PR.fe_value(out[k, :, t], tier) * pow(PR.fe_value(x[:, t] + k, tier), -1, P) % P
                    for k in range(4) for t in range(LANES)]
    for key in (False, True, "y^reps"):
        assert values["fe", key] == values["fe15", key]
    assert values["fe", "y^reps"][:LANES] == [pow(v, REPS, P) for v in vals[LANES:]]


def test_wrappers_check_shapes_and_devices():
    z18, z20 = torch.zeros((18, 8), dtype=torch.int32), torch.zeros((20, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        PR.probe_imad(z18, z18.to(torch.int64), 1)
    with pytest.raises(ValueError):
        PR.probe_imad(z18, z18, 1, wide=True, hi=True)
    with pytest.raises(ValueError):
        PR.probe_imad(z18, z20, 1)
    with pytest.raises(ValueError):
        PR.probe_imad(z18[:, ::2], z18[:, ::2], 1)
    with pytest.raises(ValueError):
        PR.probe_mul15(z20, z20, 1)
    with pytest.raises(ValueError):
        PR.probe_mul15(z18, z18, 1, block=64)
    with pytest.raises(ValueError):
        PR.probe_mul13(z18, z18, 1)
    with pytest.raises(ValueError):
        PR.probe_mul13(z20, z20, 1, mode="4pass")
    with pytest.raises(ValueError):
        PR.probe_fe(z18, z18, 1, tier="fe")
    with pytest.raises(ValueError):
        PR.probe_fe(z18, z18, 1, tier="fe13")
    with pytest.raises(ValueError):
        PR.probe_fe(z18, z18, -1, tier="fe15")
    with pytest.raises(ValueError):
        PR.probe_mul15(z18, torch.zeros((18, 8), dtype=torch.int32, device="meta"), 1)
    with pytest.raises(ValueError):
        PR.probe_mul15(z18.to("meta"), z18.to("meta"), 1)
    # CPU tensors: the plain versions, and no launch counted
    K.reset_launches()
    assert PR.probe_imad(z18, z18, 1).shape == (18, 8)
    assert PR.probe_fe(z18, z18, 1, tier="fe15").shape == (4, 18, 8)
    assert all(K.launches[k] == 0 for k in ("probe_imad", "probe_mul15", "probe_mul13", "probe_fe"))


def test_muladd_counts():
    """Each probe's 32-bit multiply-adds: K11 81 steps on 4 chains; _mul_t's
    324 products and 20 constant multiplies; _mul13's 400 products and 41
    multiplies by 608 (42 with the consumer's carry); K14 the bounds'."""
    assert PR.MULADDS_IMAD == 324
    assert PR.MULADDS_MUL_T == 344
    assert PR.MULADDS_MUL13 == {"3pass": 441, "2pass_consumer": 442, "2pass": 441}
    assert PR.fe_muladds("fe15", True) == K.MULADDS_PER_FIELD_SQ15
    assert PR.fe_muladds("fe", False) == K.MULADDS_PER_FIELD_MUL


# -- the probe scripts (xelis_he_tpu_torch/scripts/) on the CPU ------------------

SCRIPT_METRICS = {
    "bench_roofline": ["vpu_u32_mul_per_sec", "vpu_u32_mul_per_sec_wide", "vpu_u32_mulhi_per_sec",
                       "field_muls_per_sec_chip",
                       "field_muls_per_sec_chip_fe13", "port_fe_mul_per_sec", "port_fe_sq_per_sec",
                       "port_fe15_mul_per_sec", "port_fe15_sq_per_sec", "msm_windowed_pts_per_sec",
                       "msm_quad_pts_per_sec"],
    "bench_fe13": ["fe13_mul_3pass", "fe13_mul_2pass_plus_consumer", "fe13_mul_2pass_only", "fe15_mul_prod",
                   "quad_kernel_fe13=0", "quad_kernel_fe13=1"],
    "bench_qtile": ["fe15_mul_T128", "fe15_mul_T256", "fe15_mul_T512", "quad_qtile_sweep"],
}


@pytest.fixture(scope="module")
def sweeps():
    """The sweeps the three scripts share within a run."""
    return {}


@pytest.mark.parametrize("script", SCRIPT_METRICS)
def test_script_runs_plain_versions_on_cpu(script, sweeps, capsys):
    """``--device cpu --lanes 16``: every sweep checked against the plain
    versions with 0 mismatches, the JAX scripts' metric names, and no time
    or rate printed (the end kernels at 8 lanes and 2 slots of 8)."""
    import importlib
    import json

    from xelis_he_tpu_torch.scripts import _probe as B

    mod = importlib.import_module(f"xelis_he_tpu_torch.scripts.{script}")
    args = B.cli("probe", ["--device", "cpu", "--lanes", "16", "--target-ms", "1"])
    args.end_lanes, args.end_slots = 8, 2
    lines = mod.run(args, sweeps, log=lambda *a: None)
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [ln["metric"] for ln in lines] == SCRIPT_METRICS[script]
    for ln in lines:
        assert ln["value"] is None and ln["card"].startswith("cpu")
        assert not any(isinstance(v, float) for v in ln.values())
    for m in sweeps.values():
        for row in m["sweep"]:
            assert row["lanes"] == 16 and row["reps"] >= 4
            assert row["mismatches_4_reps"] == row["mismatches_timed_sample"] == row["max_abs_err"] == 0


def test_script_checks_refuse_a_mismatch():
    from xelis_he_tpu_torch.scripts import _probe as B

    a = torch.tensor([[1, -1, 7]], dtype=torch.int32)
    assert B._compare(a, a.clone(), "same") == (0, 0)
    with pytest.raises(AssertionError, match="1 limbs differ"):
        B._compare(a, torch.tensor([[1, 0x7FFFFFFF, 7]], dtype=torch.int32), "one limb")


def test_scripts_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    from xelis_he_tpu_torch.scripts import _probe as B

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.device_of("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.cli("probe", [])
    assert B.device_of("cpu").type == "cpu"


# -- csrc/probes.cuh built for the host ------------------------------------------


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """The probes' lane bodies, compiled by g++ from the kernels' header."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    repo = pathlib.Path(__file__).resolve().parents[1]
    out = tmp_path_factory.mktemp("probes_shim") / "libprobes.so"
    subprocess.run(
        ["g++", "-x", "c++", "-DXHE_HD=", "-DXHE_NOINLINE=", "-O1", "-shared", "-fPIC",
         "-I", str(repo / "xelis_he_tpu_torch" / "csrc"), "-o", str(out),
         str(repo / "tests" / "torch_probes_shim.cpp")],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.shim_probe_imad.argtypes = [vp, vp, vp, i, i, i]
    lib.shim_probe_mul15.argtypes = [vp, vp, vp, i, i]
    lib.shim_probe_mul13.argtypes = [vp, vp, vp, i, i, i]
    lib.shim_probe_fe.argtypes = [vp, vp, vp, i, i, i, i]
    for fn in (lib.shim_probe_imad, lib.shim_probe_mul13):
        fn.restype = i
    for fn in (lib.shim_probe_mul15, lib.shim_probe_fe):
        fn.restype = None
    return lib


def _run(fn, x, y, out_shape, *args):
    x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
    out = np.zeros(out_shape, dtype=np.uint32)
    rc = fn(x.ctypes.data, y.ctypes.data, out.ctypes.data, *args)
    assert rc in (None, 0)
    return out


@pytest.mark.parametrize("wide", [False, True])
def test_cuh_imad_matches_plain(shim, wide):
    x, y = _inputs(18, 15, 7)
    y[0, :3] = 0xFFFFFFFF
    got = _run(shim.shim_probe_imad, x, y, x.shape, x.size, REPS, int(wide))
    assert np.array_equal(got, _np(PR.probe_imad_plain(_t(x), _t(y), REPS, wide)))


def test_cuh_imad_hi_matches_plain_and_numpy(shim):
    """K11's high form (mad.hi) built for the host: the plain version's and
    numpy's chains, y = 2^32 - 1 among the operands; a form the kernel lacks
    is refused."""
    rng = np.random.default_rng(12)
    x = rng.integers(0, 1 << 32, (2, LANES), dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 1 << 32, (2, LANES), dtype=np.uint64).astype(np.uint32)
    y[1, :3] = 0xFFFFFFFF
    got = _run(shim.shim_probe_imad, x, y, x.shape, x.size, REPS, 2)
    assert np.array_equal(got, _np(PR.probe_imad_plain(_t(x), _t(y), REPS, hi=True)))
    assert np.array_equal(got, _imad_hi_numpy(x, y, REPS))
    out = np.zeros_like(x)
    assert shim.shim_probe_imad(x.ctypes.data, y.ctypes.data, out.ctypes.data, x.size, 1, 3) == -1


def test_cuh_mul15_matches_plain(shim):
    x, y = _inputs(18, 15, 8)
    got = _run(shim.shim_probe_mul15, x, y, x.shape, LANES, REPS)
    assert np.array_equal(got, _np(PR.probe_mul15_plain(_t(x), _t(y), REPS)))


EDGE15 = (1 << 15) + (1 << 11)  # _mul_t's largest relaxed limb


def _edge_inputs15():
    """Random limbs, and lanes of 0, 2^15 - 1 and 2^15 + 2^11 (a chain k
    adds k to x's limbs: still below 2^16)."""
    x, y = _inputs(18, 15, 13)
    x[:, 0], y[:, 1] = 0, 0
    x[:, 2], y[:, 2] = (1 << 15) - 1, (1 << 15) - 1
    x[:, 3], y[:, 3] = EDGE15, EDGE15
    x[:, 4], y[:, 4] = EDGE15, (1 << 15) - 1
    x[::2, 5], y[1::2, 5] = EDGE15, EDGE15
    return x, y


def test_cuh_mul15_matches_plain_and_mul_t_at_edge_limbs(shim):
    """K12's column-sum _mul_t built for the host, limb for limb (tolerance
    0): the plain version and the JAX helper _mul_t chained as the probe
    chains it, on random and edge limbs, after 1 to 8 reps (each rep's
    inputs the chains' outputs of the rep before)."""
    x, y = _edge_inputs15()
    xs = tuple(x + np.uint32(k) for k in range(4))
    for reps in range(1, 9):
        xs = tuple(pm._mul_t(v, y, np) for v in xs)
        want = xs[0] ^ xs[1] ^ xs[2] ^ xs[3]
        if reps in (1, 2, 5, 8):
            assert np.array_equal(_np(PR.probe_mul15_plain(_t(x), _t(y), reps)), want)
        got = _run(shim.shim_probe_mul15, x, y, x.shape, LANES, reps)
        assert np.array_equal(got, want), f"{reps} reps"


@pytest.mark.parametrize("mode", PR.MUL13_MODES)
def test_cuh_mul13_matches_plain(shim, mode):
    x, y = _inputs(20, 13, 9)
    got = _run(shim.shim_probe_mul13, x, y, x.shape, LANES, REPS, PR.MUL13_MODES.index(mode))
    assert np.array_equal(got, _np(PR.probe_mul13_plain(_t(x), _t(y), REPS, mode)))


@pytest.mark.parametrize("tier,square", FE_CASES)
def test_cuh_fe_matches_plain(shim, tier, square):
    x, y = _fe_inputs(tier, 10)
    got = _run(shim.shim_probe_fe, x, y, (4, *x.shape), LANES, REPS, int(tier == "fe15"), int(square))
    assert np.array_equal(got, _np(PR.probe_fe_plain(_t(x), _t(y), REPS, tier, square)))
