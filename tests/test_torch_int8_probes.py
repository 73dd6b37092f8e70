"""The int8 probes of ``experiments/`` in the PyTorch port (K12
``shift_dot``, K13 ``pad_inject``, K4's cast and no-statistics forms; the
entry points of ``neuralstyletransferv1_torch/experiments/``) against the
scripts' own Pallas kernels, on the CPU.

The scripts' kernels take no interpret switch; each test runs them in
Pallas interpret mode by patching ``jax.experimental.pallas.pallas_call``
to ``partial(pallas_call, interpret=True)`` for that test only
(``monkeypatch``), with the scripts' module globals patched to small
shapes. mk21's ``kern`` and mk27's ``_k_*`` bodies are wrapped by the
scripts in jitted chains, so their ``pallas_call`` specs are rebuilt here
around the module-level bodies; mk27's ``_k_s8_aligned`` gets an A block of
ROWS + 160 rows (the script's ROWS + 64 is too short for its 32·5 offset:
its own ``build`` does not trace, pinned below). mk28's probes build their
inputs inside; their ``pallas_call`` inputs and outputs are captured
through the interpret wrapper.

Tolerances. Every integer-valued output is held bit for bit: s32 sums,
bf16(f32(acc)·2^-8) of s8 sums, K13's codes, mk27's s8 forms, mk28's P5,
and mk27's bf16 form (its integer operands keep every f32 sum exact). The
bf16 strip forms sum exact products in f32 in another order: within 1 bf16
ulp (an ulp taken at no less than 2^-8 of the largest magnitude) and equal
on ≥ 99%. mk20's bf16 → f32 dot: within 1e-5·Σ_k |a_k b_k| per element.
mk31's v1/v2 against the interpret-mode kernel: within 1 ulp on ≥ 99.9%
(interpret mode contracts acc·ws + bi into an FMA) and sums within 1e-5,
the gate ``tests/test_torch_int8.py`` uses for K4.

The ``cuda`` cases hold the kernels against their plain versions on the
card at ragged shapes; they import no JAX, so that machine runs them with
``--noconftest``.
"""

import functools
import importlib
import json
import types

import numpy as np
import pytest
import torch

from neuralstyletransferv1_torch.experiments import _bench
from neuralstyletransferv1_torch.experiments import mk21_int8_res_sweep as tmk21
from neuralstyletransferv1_torch.experiments import mk27_pallas_s8_dot as tmk27
from neuralstyletransferv1_torch.experiments import mk28_probe as tmk28
from neuralstyletransferv1_torch.experiments import mk31_i8_variants as tmk31
from neuralstyletransferv1_torch.kernels import int8_probes as k12
from neuralstyletransferv1_torch.kernels import int8_sites as k8
from neuralstyletransferv1_torch.kernels.bf16_sites import bf16_ulp_error

ENTRY_POINTS = ("mk20_int8_smoke", "mk21_int8_res_sweep", "mk27_pallas_s8_dot", "mk28_probe",
                "mk31_i8_variants")
C = 128
OSCALE = 2.0 ** -8


@pytest.fixture
def jx(monkeypatch):
    """The JAX side, with the scripts' pallas_call in interpret mode for this
    test (imported here so that the card cases need no JAX)."""
    import jax
    import jax.experimental.pallas as pl
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from experiments import (mk21_int8_res_sweep, mk27_pallas_s8_dot, mk28_probe,
                             mk31_i8_variants)
    from neuralstyletransferv1_tpu.models import s2d2_sites_i8

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
    return types.SimpleNamespace(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, orig=orig,
                                 mk21=mk21_int8_res_sweep, mk27=mk27_pallas_s8_dot,
                                 mk28=mk28_probe, mk31=mk31_i8_variants, si8=s2d2_sites_i8)


def _t(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(a) -> np.ndarray:
    """A JAX array → numpy f32 (bf16 exactly)."""
    return np.asarray(a.astype("float32"))


def _bf(a) -> np.ndarray:
    """Round to bf16, back as f32 numpy."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _assert_equal(ours: torch.Tensor, ref):
    r = np.asarray(ref)
    assert tuple(ours.shape) == r.shape, (ours.shape, r.shape)
    np.testing.assert_array_equal(ours.float().numpy(), r.astype(np.float32))


def _assert_bf16_close(ours: torch.Tensor, ref, equal_share=0.99):
    r = torch.from_numpy(np.array(ref, np.float32))
    assert tuple(ours.shape) == tuple(r.shape), (ours.shape, r.shape)
    worst, equal = bf16_ulp_error(ours, r)
    assert worst <= 1.0 and equal >= equal_share, (worst, equal)


# ---------------------------------------------------------------------------
# K12, flat form: mk20's probe-2 dot and mk27's shifted dots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["int8", "bf16"])
def test_flat_dot_matches_mk20_probe2(jx, form):
    """The probe's own check, ``jax.lax.dot_general`` with s32 / f32
    accumulation, at M = 256, K = 512, N = 256: s32 bit for bit; f32
    within 1e-5·Σ_k |a_k b_k| (both sum exact products in f32, in their
    own orders)."""
    jnp = jx.jnp
    rng = np.random.default_rng(3)
    m, k, n = 256, 512, 256
    if form == "int8":
        a, b = rng.integers(-127, 127, (m, k)).astype(np.int8), rng.integers(
            -127, 127, (k, n)).astype(np.int8)
        ja, jb, acc, out = jnp.asarray(a), jnp.asarray(b), jnp.int32, "s32"
        ta, tb = _t(a), _t(b)
    else:
        a, b = _bf(rng.normal(0, 1, (m, k))), _bf(rng.normal(0, 1, (k, n)))
        ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
        acc, out = jnp.float32, "f32"
        ta, tb = _t(a, torch.bfloat16), _t(b, torch.bfloat16)
    ref = np.asarray(jx.jax.lax.dot_general(ja, jb, (((1,), (0,)), ((), ())),
                                            preferred_element_type=acc))
    ours = k12.flat_dot(ta, k12.pack_taps(tb[None]), [0], out=out)
    assert ours.dtype == (torch.int32 if form == "int8" else torch.float32)
    if form == "int8":
        _assert_equal(ours, ref)
    else:
        scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
        assert np.all(np.abs(ours.numpy().astype(np.float64) - ref) <= 1e-5 * scale)


ROWS27, GRID27 = 2048, 2


def _mk27_operands(seed, rows):
    rng = np.random.default_rng(seed)
    return (rng.integers(-100, 100, (rows, C)).astype(np.float32),
            rng.integers(-100, 100, (6, C, C)).astype(np.float32))


def _mk27_port(x, w, kern, offsets, xdt, wdt):
    pro = "cast" if kern == "_k_bf16cast" else "none"
    a = _t(x).to(torch.bfloat16) if xdt == "bf16" else _t(x).to(torch.int8)
    wt = k12.pack_taps(_t(w).to(torch.bfloat16 if wdt == "bf16" else torch.int8))
    return k12.flat_dot(a, wt, offsets, ROWS27, pro=pro)


@pytest.mark.parametrize("kern,xdt,wdt", [("_k_s8_unaligned", "s8", "s8"),
                                          ("_k_bf16cast", "bf16", "s8"),
                                          ("_k_bf16", "bf16", "bf16")])
def test_flat_dot_matches_mk27_build(jx, monkeypatch, kern, xdt, wdt):
    """mk27's ``build`` at ROWS, GRID = 2048, 2 in interpret mode against
    K12's flat form at offsets 0..5: bit for bit (the bf16 form too: its
    integer operands keep every f32 sum exact)."""
    jnp, mk27 = jx.jnp, jx.mk27
    monkeypatch.setattr(mk27, "ROWS", ROWS27)
    monkeypatch.setattr(mk27, "GRID", GRID27)
    x, w = _mk27_operands(5, ROWS27 + 64)
    dt = {"s8": jnp.int8, "bf16": jnp.bfloat16}
    f, _ = mk27.build(getattr(mk27, kern), dt[xdt], dt[wdt])
    ref = _np(f(jnp.asarray(x), jnp.asarray(w)))
    _assert_equal(_mk27_port(x, w, kern, list(range(6)), xdt, wdt), ref)


def test_flat_dot_matches_mk27_aligned(jx, monkeypatch):
    """``_k_s8_aligned`` (offsets 32r; the script defines it and never runs
    it) around a rebuilt spec whose A block has ROWS + 160 rows: bit for
    bit."""
    jnp, pl, mk27 = jx.jnp, jx.pl, jx.mk27
    monkeypatch.setattr(mk27, "ROWS", ROWS27)
    x, w = _mk27_operands(6, ROWS27 + 160)
    ref = jx.orig(
        mk27._k_s8_aligned, grid=(GRID27,),
        in_specs=[pl.BlockSpec((ROWS27 + 160, C), lambda b: (0, 0)),
                  pl.BlockSpec((6, C, C), lambda b: (0, 0, 0))],
        out_specs=pl.BlockSpec((ROWS27, C), lambda b: (0, 0)),
        out_shape=jx.jax.ShapeDtypeStruct((ROWS27, C), jnp.bfloat16), interpret=True,
    )(jnp.asarray(x, jnp.int8), jnp.asarray(w, jnp.int8))
    _assert_equal(_mk27_port(x, w, "_k_s8_aligned", [32 * r for r in range(6)], "s8", "s8"),
                  _np(ref))


@pytest.mark.parametrize("step", [1, 32])
def test_mk27_library_call_is_the_flat_dot(step):
    """``conv1d_call`` (mk27's ``library_ms``: one ``F.conv1d`` at dilation
    ``step``) computes K12's flat bf16 form at offsets step·r: on two slices
    of the script's integer operands, bit for bit."""
    rows = 96
    offsets = [step * r for r in range(6)]
    a = torch.stack([_t(_mk27_operands(8 + s, rows + 32 * 5)[0]) for s in range(2)])
    w = _t(_mk27_operands(8, 1)[1])
    a, w = a.to(torch.bfloat16), w.to(torch.bfloat16)
    lib = tmk27.conv1d_call(a, w, step, rows)()
    ref = k12.flat_dot_plain(a, k12.pack_taps(w), offsets, rows)
    _assert_equal(lib.transpose(1, 2), ref.float().numpy())


def test_mk27_aligned_build_does_not_trace(jx, monkeypatch):
    """The reference's fault: ``build(_k_s8_aligned)`` gives its body an A
    block of ROWS + 64 rows, and the last tile's offset 32·5 reads past it."""
    jnp, mk27 = jx.jnp, jx.mk27
    monkeypatch.setattr(mk27, "ROWS", ROWS27)
    monkeypatch.setattr(mk27, "GRID", GRID27)
    x, w = _mk27_operands(7, ROWS27 + 64)
    f, _ = mk27.build(mk27._k_s8_aligned, jnp.int8, jnp.int8)
    with pytest.raises(TypeError, match="incompatible shapes"):
        f(jnp.asarray(x), jnp.asarray(w))


def test_cast_saturates_as_xla(jx, monkeypatch):
    """XLA's bf16 → s8 convert truncates, clamps to [−128, 127] and maps
    NaN to 0 (PyTorch's ``.to(torch.int8)`` wraps): the plain cast holds to
    it, and so does mk27's bf16cast form on operands beyond ±127 and NaN."""
    jnp, mk27 = jx.jnp, jx.mk27
    v = np.array([300, -300, 127.5, -128.5, 2.7, -2.7, 0.5, np.nan, np.inf, -np.inf], np.float32)
    ref = np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.int8))
    ours = k12.saturate_s8(_t(v).to(torch.bfloat16))
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.float32))
    monkeypatch.setattr(mk27, "ROWS", ROWS27)
    monkeypatch.setattr(mk27, "GRID", GRID27)
    x, w = _mk27_operands(8, ROWS27 + 64)
    rng = np.random.default_rng(9)
    pick = rng.random(x.shape)
    x = np.where(pick < 0.05, rng.choice(v, x.shape), x).astype(np.float32)
    f, _ = mk27.build(mk27._k_bf16cast, jnp.bfloat16, jnp.int8)
    ref = _np(f(jnp.asarray(x), jnp.asarray(w)))
    _assert_equal(_mk27_port(x, w, "_k_bf16cast", list(range(6)), "bf16", "s8"), ref)


# ---------------------------------------------------------------------------
# K12, strip form: mk21's kern (mk20's probe 3), k384
# ---------------------------------------------------------------------------


def _mk21_call(jx, mode, mt, in_int8, x, w, b, h, wd, ts=8):
    """mk21's ``kern`` in interpret mode around the script's specs (B, H, W,
    TS patched to the test's shape)."""
    jnp, pl = jx.jnp, jx.pl
    int8 = mode.endswith("i8")
    sdt = jnp.int8 if int8 else jnp.bfloat16
    k384 = mode.startswith("k384")
    wshape = (3, 3 * C, C) if k384 else (9, C, C)
    scr = [jx.pltpu.VMEM(((ts + 3) * wd, C), sdt),
           jx.pltpu.VMEM(((ts + 2) * wd + 2, 3 * C), sdt) if k384 else jx.pltpu.VMEM((8, C), sdt)]
    return jx.orig(
        functools.partial(jx.mk21.kern, mode=mode, mt_rows=mt, in_int8=in_int8),
        grid=(b, h // ts),
        in_specs=[pl.BlockSpec((1, ts, wd, C), lambda i, j: (i, j, 0, 0)),
                  pl.BlockSpec((1, 2, wd, C), lambda i, j: (i, 4 * j + 4, 0, 0)),
                  pl.BlockSpec(wshape, lambda i, j: (0,) * len(wshape))],
        out_specs=pl.BlockSpec((1, ts, wd, C), lambda i, j: (i, j, 0, 0)),
        out_shape=jx.jax.ShapeDtypeStruct((b, h, wd, C), jnp.bfloat16),
        scratch_shapes=scr, interpret=True)(x, x, w)


def _patch_mk21(jx, monkeypatch, b, h, wd):
    for name, v in (("B", b), ("H", h), ("W", wd), ("TS", 8)):
        monkeypatch.setattr(jx.mk21, name, v)


@pytest.mark.parametrize("mode,mt,b,wd", [("tap9i8", 2, 1, 24), ("tap9i8", 4, 1, 24),
                                          ("tap9i8", 2, 2, 21), ("tap9i8", 4, 1, 21),
                                          ("noq", 4, 1, 21), ("tap9", 2, 1, 21),
                                          ("tap9", 4, 1, 24)])
def test_strip_dot_matches_mk21_kern(jx, monkeypatch, mode, mt, b, wd):
    """K12's strip form against mk21's kernel body, H = 16 (two strips, so
    the strip's tail rows and the row spill are read), W = 21 (not a
    multiple of 8) and 24: tap9i8 at MT = 2W and 4W and noq bit for bit,
    tap9 (bf16) within 1 ulp on ≥ 99%."""
    jnp = jx.jnp
    h = 16
    _patch_mk21(jx, monkeypatch, b, h, wd)
    rng = np.random.default_rng(wd * mt + b)
    x = _bf(rng.normal(0, 1, (b, h + 2, wd, C)))
    jxx = jnp.asarray(x, jnp.bfloat16)
    if mode == "tap9":
        w = _bf(rng.normal(0, 1, (9, C, C)))
        ref = _mk21_call(jx, "tap9", mt * wd, False, jxx, jnp.asarray(w, jnp.bfloat16), b, h, wd)
        ours = k12.strip_dot(_t(x, torch.bfloat16), k12.pack_taps(_t(w, torch.bfloat16)),
                             oscale=OSCALE)
        _assert_bf16_close(ours, _np(ref))
        return
    w = rng.integers(-127, 127, (9, C, C)).astype(np.int8)
    if mode == "noq":
        xq = jnp.clip(jnp.round(jxx.astype(jnp.float32) * 16.0), -127, 127).astype(jnp.int8)
        ref = _mk21_call(jx, "tap9i8", mt * wd, True, xq, jnp.asarray(w), b, h, wd)
        ours = k12.strip_dot(_t(np.asarray(xq)), k12.pack_taps(_t(w)), oscale=OSCALE)
    else:
        ref = _mk21_call(jx, "tap9i8", mt * wd, False, jxx, jnp.asarray(w), b, h, wd)
        ours = k12.strip_dot(_t(x, torch.bfloat16), k12.pack_taps(_t(w)), pro="quant",
                             oscale=OSCALE)
    _assert_equal(ours, _np(ref))


def _strips(x: np.ndarray, ts: int = 8) -> np.ndarray:
    """S_j of every strip: its ts + 2 rows flattened, then W zero rows
    → [B, H/ts, (ts+3)·W, C]."""
    b, h2, w, c = x.shape
    nj = (h2 - 2) // ts
    s = np.stack([x[:, ts * j:ts * j + ts + 2].reshape(b, (ts + 2) * w, c) for j in range(nj)], 1)
    return np.concatenate([s, np.zeros((b, nj, w, c), x.dtype)], 2)


def test_mk20_probe3_bf16_twin():
    """mk20's probe 3 in bf16 (no scale; its int8 form is mk21's tap9i8)
    against a numpy oracle of the strip function with f32 sums: within 1
    ulp on ≥ 99%."""
    rng = np.random.default_rng(11)
    b, h, wd, ts = 1, 16, 21, 8
    x, w = _bf(rng.normal(0, 1, (b, h + 2, wd, C))), _bf(rng.normal(0, 1, (9, C, C)))
    s = _strips(x)
    acc = sum(s[:, :, dy * wd + dx:dy * wd + dx + ts * wd] @ w[3 * dy + dx]
              for dy in range(3) for dx in range(3))
    ref = _bf(acc.reshape(b, h, wd, C))
    ours = k12.strip_dot(_t(x, torch.bfloat16), k12.pack_taps(_t(w, torch.bfloat16)))
    _assert_bf16_close(ours, ref)


def test_k384_is_tap9_on_regrouped_weights():
    """mk21's k384 as its docstring means it: x3[i] = [xs[i], xs[i+1],
    xs[i+2]] (3C lanes), 3 dots of K = 3C with w3[dy]; an int64 numpy
    oracle of that equals K12's tap9 form on ``regroup_k384(w3)`` bit for
    bit."""
    rng = np.random.default_rng(12)
    b, h, wd, ts = 1, 16, 21, 8
    x = _bf(rng.normal(0, 1, (b, h + 2, wd, C)))
    w3 = rng.integers(-127, 127, (3, 3 * C, C)).astype(np.int8)
    s = _strips(np.clip(np.round(x * 16.0), -127, 127).astype(np.int64))
    s = np.concatenate([s, np.zeros_like(s[:, :, :2])], 2)
    x3 = np.concatenate([s[:, :, i:i + (ts + 3) * wd] for i in range(3)], -1)
    acc = sum(x3[:, :, dy * wd:dy * wd + ts * wd] @ w3[dy].astype(np.int64) for dy in range(3))
    ref = _bf((acc.astype(np.float32) * OSCALE).reshape(b, h, wd, C))
    ours = k12.strip_dot(_t(x, torch.bfloat16), k12.pack_taps(k12.regroup_k384(_t(w3))),
                         pro="quant", oscale=OSCALE)
    _assert_equal(ours, ref)


def test_mk21_k384_does_not_trace(jx, monkeypatch):
    """The reference's fault: ``make_fn("k384i8", ...)`` stores (TS+2)·W
    rows into its (TS+2)·W + 2-row scratch, so its kernel does not trace
    (on the TPU the script only printed FAILED for k384)."""
    wd = 24
    _patch_mk21(jx, monkeypatch, 1, 16, wd)
    (_, g1), make = jx.mk21.make_fn("k384i8", 2 * wd)
    x, w = make(0)
    with pytest.raises(ValueError, match="Invalid shape"):
        g1(x, w)


# ---------------------------------------------------------------------------
# K13 and K4 against mk28's probes (captured through the interpret wrapper)
# ---------------------------------------------------------------------------


def _capture(jx, monkeypatch) -> list:
    seen = []

    def pallas_call(*a, **k):
        f = jx.orig(*a, interpret=True, **k)

        def run(*args):
            out = f(*args)
            seen.append(([np.asarray(v) for v in args], np.asarray(out)))
            return out
        return run
    monkeypatch.setattr(jx.pl, "pallas_call", pallas_call)
    return seen


@pytest.mark.parametrize("probe", ["p1_pad", "p2_inject"])
def test_pad_inject_matches_mk28(jx, monkeypatch, probe):
    """P1 and P2 at the script's shape [1, 8, 480, 128] → 488 columns: K13's
    plain version bit for bit (P2's injected column is the probe's 482)."""
    seen = _capture(jx, monkeypatch)
    getattr(jx.mk28, probe)()  # its own asserts pass
    (x,), out = seen[0]
    inject = probe == "p2_inject"
    ours = k12.pad_inject(_t(x.astype(np.float32), torch.bfloat16), jx.mk28.WP, inject=inject)
    assert ours.dtype == (torch.int8 if inject else torch.bfloat16)
    _assert_equal(ours, out.astype(np.float32))


def test_k4_nostats_matches_mk28_p5(jx, monkeypatch):
    """P5, the mini site on a 10-row strip, is K4 without statistics with a
    = 4, c = 0, floor −127, ws = 1, bias = 0: its rows 1..8 bit for bit
    (interior rows read no row halo; the column halo is the same reflect)."""
    seen = _capture(jx, monkeypatch)
    jx.mk28.p5_mini_site()
    (x, wn), out = seen[0]
    xt = _t(x.astype(np.float32), torch.bfloat16)
    ours, sums = k8.res_site(xt, *tmk28.p5_operands(xt, wn), stats=False)
    _assert_equal(ours[:, 1:-1], out.astype(np.float32))
    assert not sums.any()


# ---------------------------------------------------------------------------
# K4's cast and no-statistics forms against mk31's kernels
# ---------------------------------------------------------------------------


def _patch_mk31(jx, monkeypatch):
    b, h, w, ts, mt = 2, 12, 16, 6, 4
    for name, v in (("B", b), ("H4", h), ("W0", w), ("TS", ts), ("MT", mt),
                    ("WP", ((w + 2 + 7) // 8) * 8)):
        monkeypatch.setattr(jx.mk31, name, v)
    return b, h, w


def _mk31_operands(b):
    """The script's weights, dequant row and statistics (``main``, seed 0),
    as the port's entry point builds them, and as JAX arrays."""
    a, c, lo, wk, ws, bias = tmk31.operands(b, C, 0, torch.device("cpu"))
    w9 = k8.unpack_weights(wk).reshape(9, C, C).numpy()
    stat = np.stack([a.numpy(), c.numpy()], 1)
    dq = np.stack([ws.numpy(), bias.numpy()], 0)
    return (a, c, lo, wk, ws, bias), (stat, w9, dq)


def _assert_sums_close(sums, ours, sout, ref, n, tol=1e-5):
    """[Σ, Σ²] within ``tol`` relative of the Pallas sums, after moving those
    by what the outputs' isolated 1-ulp flips change (each side sums its own
    bf16 outputs), as ``tests/test_torch_int8.py`` holds K4: Σ² against
    itself, Σ against sqrt(n·Σ²)."""
    def exact(v):
        v = np.asarray(v, np.float64)
        return np.stack([v.sum(axis=(1, 2)), (v * v).sum(axis=(1, 2))], axis=1)

    got = sums.numpy().astype(np.float64)
    want = np.asarray(sout, np.float64) + exact(ours.float().numpy()) - exact(ref)
    s2 = np.abs(want[:, 1])
    assert np.all(np.abs(got[:, 1] - want[:, 1]) <= tol * s2)
    assert np.all(np.abs(got[:, 0] - want[:, 0]) <= tol * np.sqrt(n * s2))


@pytest.mark.parametrize("variant,scale", [("v1", 2.0), ("v1", 200.0), ("v2", 2.0)])
def test_k4_forms_match_mk31(jx, monkeypatch, variant, scale):
    """mk31's v1 (the bare saturating cast; x·200 reaches beyond ±127) and
    v2 (no statistics) at B, H4, W0, TS, MT = 2, 12, 16, 6, 4: the raw out
    within 1 ulp on ≥ 99.9%, v1's sums within 1e-5, v2's exactly zero."""
    jnp, mk31 = jx.jnp, jx.mk31
    b, h, w = _patch_mk31(jx, monkeypatch)
    ops, (stat, w9, dq) = _mk31_operands(b)
    x = _bf(np.random.default_rng(13).normal(0, 1, (b, h, w, C)) * scale)
    kern = mk31.k_v1_noaffine if variant == "v1" else mk31.k_v2_nostats
    y, s = mk31.build(kern, (mk31.TS + 2) * mk31.WP + 32)(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(stat), jnp.asarray(w9), jnp.asarray(dq))
    kw = {"prologue": "cast"} if variant == "v1" else {"stats": False}
    ours, sums = k8.res_site(_t(x, torch.bfloat16), *ops, **kw)
    _assert_bf16_close(ours, _np(y), equal_share=0.999)
    if variant == "v1":
        _assert_sums_close(sums, ours, np.asarray(s), _np(y), h * w)
    else:
        assert not sums.any() and not np.asarray(s).any()


def test_k4_v0_matches_si8_res_site(jx, monkeypatch):
    """mk31's v0 is ``si8.res_site`` as is: the port's K4 on the same
    operands, within 1 ulp on ≥ 99.9% and sums within 1e-5."""
    jnp = jx.jnp
    monkeypatch.setattr(jx.si8, "_INTERPRET", True)
    b, h, w = 2, 12, 16
    ops, (stat, w9, dq) = _mk31_operands(b)
    x = _bf(np.random.default_rng(14).normal(0, 2, (b, h, w, C)))
    y, s = jx.si8.res_site(jnp.asarray(x, jnp.bfloat16), jnp.asarray(stat[:, 0]),
                           jnp.asarray(stat[:, 1]), jnp.asarray(w9), jnp.asarray(dq[0]),
                           jnp.asarray(dq[1]), -127.0, ts=6, mt=4)
    ours, sums = k8.res_site(_t(x, torch.bfloat16), *ops)
    _assert_bf16_close(ours, _np(y), equal_share=0.999)
    _assert_sums_close(sums, ours, np.asarray(s), _np(y), h * w)


def test_k4_new_forms_keep_the_default():
    """K4's default form is unchanged by the new arguments; the cast form is
    the conv of the saturated codes (a, c, lo unused); without statistics
    the raw out is the same and the sums are zero; CPU tensors take the
    plain versions and count no launch."""
    b, h, w = 2, 9, 11
    ops, _ = _mk31_operands(b)
    a, c, lo, wk, ws, bias = ops
    x = torch.from_numpy(np.random.default_rng(15).normal(0, 60, (b, h, w, C)).astype(
        np.float32)).to(torch.bfloat16)
    before = {**k8.LAUNCHES, **k8.PROBE_LAUNCHES}
    y0, s0 = k8.res_site(x, *ops)
    assert torch.equal(y0, k8._conv_dequant(k8._quantize(x.float(), a, c, lo), wk, ws, bias,
                                            "reflect"))
    assert torch.equal(s0, k8._sums(y0))
    yc, sc = k8.res_site(x, a, c, lo, wk, ws, bias, prologue="cast")
    yc2, _ = k8.res_site(x, a * 0 + 3.0, c + 1.0, 0.0, wk, ws, bias, prologue="cast")
    codes = torch.clamp(torch.trunc(x.float()), -128, 127)
    assert torch.equal(yc, k8._conv_dequant(codes, wk, ws, bias, "reflect"))
    assert torch.equal(yc, yc2)
    assert torch.equal(sc, k8._sums(yc))
    yn, sn = k8.res_site(x, *ops, stats=False)
    assert torch.equal(yn, y0) and not sn.any() and sn.shape == s0.shape
    assert {**k8.LAUNCHES, **k8.PROBE_LAUNCHES} == before
    with pytest.raises(ValueError, match="prologue"):
        k8.res_site(x, *ops, prologue="affine")


# ---------------------------------------------------------------------------
# the entry points and the bench's bound
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_runs_on_cpu(name, capsys):
    """Each entry point at its small shape on the plain versions: one JSON
    line, every check passed (the plain version against itself: bit for
    bit), no time (a CPU run measures no device)."""
    mod = importlib.import_module(f"neuralstyletransferv1_torch.experiments.{name}")
    before = {**k8.LAUNCHES, **k8.PROBE_LAUNCHES, **k12.LAUNCHES}
    rec = mod.main(["--device", "cpu", "--small"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == rec
    assert rec["experiment"] == name and rec["device"] == "cpu"
    runs = rec.get("variants") or rec.get("probes")
    assert runs
    for r in runs:
        assert "ms" not in r and "bound_ms" not in r
        if "max_abs_err" in r:
            assert r["max_abs_err"] == 0.0
    assert {**k8.LAUNCHES, **k8.PROBE_LAUNCHES, **k12.LAUNCHES} == before


def test_entry_points_cover_every_form():
    """The default runs launch K12 in every built form (mk20: s8 → s32,
    bf16 → f32, quantize and bf16 strips; mk21: the noq strip; mk27: s8 →
    bf16, bf16, cast), and mk31 v1/v2 K4's two new forms."""
    assert {v[1] for v in tmk21.VARIANTS.values()} == {"int8", "bf16", "noq"}
    forms = {(adt, pro) for adt, pro, _step, _w in tmk27.VARIANTS.values()}
    assert forms == {(torch.bfloat16, "none"), (torch.int8, "none"), (torch.bfloat16, "cast")}
    assert {tmk31.VARIANTS[v][:2] for v in ("v1", "v2")} == set(k8.K4_PROBE_FORMS)
    assert {tmk31.VARIANTS[v][2] for v in ("v1", "v2")} == set(k8.K4_PROBE_FORMS.values())


def test_bound_keeps_the_bf16_default():
    """``bound``'s peak defaults to bf16, so the earlier records keep their
    bounds; ``peak=PEAK_INT8_OPS`` halves the operations' time."""
    nbytes, ops = 4.0e8, 6.12e11
    bf = _bench.bound(nbytes, ops)
    assert bf == _bench.bound(nbytes, ops, peak=_bench.PEAK_BF16_OPS)
    assert bf["bound_ms"] == max(nbytes / 3.35e12, ops / 989e12) * 1e3
    i8 = _bench.bound(nbytes, ops, peak=_bench.PEAK_INT8_OPS)
    assert i8["bound_ms"] == max(nbytes / 3.35e12, ops / 1979e12) * 1e3


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain versions at ragged shapes
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K12, K13 and K4 are CUDA kernels with no CPU mode)")
    from neuralstyletransferv1_torch.device import resolve_device

    return resolve_device("cuda")


def _card_operands(dev, form, shape, seed):
    """A seeded operand [.., K] in the form's dtype and weights [R, K, N]."""
    adt, pro, out = form
    rng = np.random.default_rng(seed)
    if adt == torch.int8:
        a = torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8))
    elif pro == "cast":
        a = torch.from_numpy(rng.normal(0, 90, shape).astype(np.float32))
        a[..., :3] = torch.tensor([float("nan"), 300.0, -300.0])
    else:
        a = torch.from_numpy(rng.normal(0, 4 if pro == "quant" else 1, shape).astype(np.float32))
    return a.to(dev).to(adt), rng


def _card_weights(rng, r, k, n, mma_bf16, dev):
    if mma_bf16:
        return _bench.normal(rng, (r, k, n), 1.0, dev)
    return torch.from_numpy(rng.integers(-128, 128, (r, k, n)).astype(np.int8)).to(dev)


def _card_check(name, out, again, ref, a, wt, offsets=None):
    if out.dtype == torch.float32:  # bf16 → f32: within 1e-5 of Σ|ab|
        from neuralstyletransferv1_torch.experiments.mk20_int8_smoke import check_f32

        scale = k12.flat_dot_plain(a.abs(), wt.abs(), offsets, out="f32")
        return check_f32(scale)(name, out, again, ref)
    if a.dtype == torch.bfloat16 and out.dtype == torch.bfloat16 and wt.dtype == torch.bfloat16:
        return _bench.check(name, out, again, ref)
    return _bench.check(name, out, again, ref, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("form", k12.FORMS, ids=lambda f: f"{str(f[0])[6:]}-{f[1]}-{f[2]}")
@pytest.mark.parametrize("g,ma,k,n,offsets", [(3, 300, 128, 128, [0, 1, 2, 3, 4, 5]),
                                              (1, 1000, 512, 256, [0]),
                                              (2, 700, 128, 256, [0, 32, 64, 96, 128, 160]),
                                              (2, 1200, 256, 128, [7, 0, 300, 5])])
def test_flat_dot_matches_plain_on_card(cuda_device, form, g, ma, k, n, offsets):
    """K12's flat form in every built form at ragged row counts (partial
    128-row tiles), K = 128..512, N = 128 and 256, offsets in one segment or
    several: integer-valued outputs bit-identical, two launches identical."""
    adt, pro, out = form
    a, rng = _card_operands(cuda_device, form, (g, ma, k), g * ma + k)
    wt = k12.pack_taps(_card_weights(rng, len(offsets), k, n, k12._mma_bf16(a, pro), cuda_device))
    kw = {"pro": pro, "out": out, "oscale": 0.5}
    before = k12.LAUNCHES["shift_dot"]
    res, again = (k12.flat_dot(a, wt, offsets, **kw) for _ in range(2))
    ref = k12.flat_dot_plain(a, wt, offsets, **kw)
    torch.cuda.synchronize()
    assert k12.LAUNCHES["shift_dot"] - before == 2
    assert res.shape == (g, ma - max(offsets), n)
    _card_check("shift_dot", res, again, ref, a, wt, offsets)


@pytest.mark.cuda
@pytest.mark.parametrize("form", [f for f in k12.FORMS if f[2] == "bf16"],
                         ids=lambda f: f"{str(f[0])[6:]}-{f[1]}")
@pytest.mark.parametrize("b,h,w", [(2, 16, 21), (1, 24, 488), (3, 8, 9)])
def test_strip_dot_matches_plain_on_card(cuda_device, form, b, h, w):
    """K12's strip form at W = 21, 488 and 9 (< 16: every strip-end spill),
    H/8 = 1..3 strips: the int8 forms bit-identical, bf16 within 1 ulp."""
    adt, pro, _ = form
    x, rng = _card_operands(cuda_device, form, (b, h + 2, w, C), b * h * w)
    wt = k12.pack_taps(_card_weights(rng, 9, C, C, k12._mma_bf16(x, pro), cuda_device))
    kw = {"pro": pro, "oscale": OSCALE}
    res, again = (k12.strip_dot(x, wt, **kw) for _ in range(2))
    ref = k12.strip_dot_plain(x, wt, **kw)
    torch.cuda.synchronize()
    assert res.shape == (b, h, w, C)
    _card_check("shift_dot", res, again, ref, x, wt)


@pytest.mark.cuda
@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("b,r,w0,wp,c", [(1, 8, 480, 488, 128), (2, 3, 37, 45, 64)])
def test_pad_inject_matches_plain_on_card(cuda_device, inject, b, r, w0, wp, c):
    x = _bench.normal(np.random.default_rng(r * w0), (b, r, w0, c), 8.0, cuda_device)
    before = k12.LAUNCHES["pad_inject"]
    res, again = (k12.pad_inject(x, wp, inject=inject) for _ in range(2))
    ref = k12.pad_inject_plain(x, wp, inject=inject)
    torch.cuda.synchronize()
    assert k12.LAUNCHES["pad_inject"] - before == 2
    _bench.check("pad_inject", res, again, ref, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("prologue,stats", sorted(k8.K4_PROBE_FORMS))
@pytest.mark.parametrize("b,h,w,scale", [(2, 13, 37, 2.0), (1, 8, 16, 200.0), (3, 5, 7, 2.0)])
def test_k4_probe_forms_match_plain_on_card(cuda_device, prologue, stats, b, h, w, scale):
    """K4's cast and no-statistics forms at ragged grids (partial 8×16
    tiles; x·200 saturates the cast, which also meets NaN and ±inf):
    bit-identical to the plain version,
    sums within 1e-5 or zero, two launches identical, counted under the
    form's own name."""
    ops, _ = _mk31_operands(b)
    ops = tuple(o.to(cuda_device) if isinstance(o, torch.Tensor) else o for o in ops)
    x = _bench.normal(np.random.default_rng(h * w), (b, h, w, C), scale, cuda_device)
    if prologue == "cast":  # XLA's convert: NaN → 0, ±inf saturate
        x[0, 0, :3, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    name = k8.K4_PROBE_FORMS[(prologue, stats)]
    before = {**k8.LAUNCHES, **k8.PROBE_LAUNCHES}
    (y, s), (y2, s2) = (k8.res_site(x, *ops, prologue=prologue, stats=stats) for _ in range(2))
    yr, sr = k8.res_site_plain(x, *ops, prologue=prologue, stats=stats)
    torch.cuda.synchronize()
    assert k8.PROBE_LAUNCHES[name] - before[name] == 2
    assert k8.LAUNCHES["res_site"] == before["res_site"]
    _bench.check(name, y, y2, yr, exact=True, sums=s, sums_again=s2, sums_ref=sr,
                 zero_sums=not stats)


@pytest.mark.cuda
def test_unbuilt_forms_raise(cuda_device):
    """A form the kernels are not built for raises before any launch."""
    before = {**k8.LAUNCHES, **k8.PROBE_LAUNCHES, **k12.LAUNCHES}
    a = torch.zeros((1, 256, 128), dtype=torch.int8, device=cuda_device)
    wt = torch.zeros((1, 128, 128), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="no kernel form"):
        k12.flat_dot(a, wt, [0], pro="quant")
    with pytest.raises(ValueError, match="no kernel form"):
        k12.flat_dot(a, wt, [0], out="f32")
    with pytest.raises(ValueError, match="K=192"):
        k12.flat_dot(torch.zeros((1, 256, 192), dtype=torch.int8, device=cuda_device),
                     torch.zeros((1, 128, 192), dtype=torch.int8, device=cuda_device), [0])
    with pytest.raises(TypeError, match="bfloat16"):
        k12.flat_dot(a.to(torch.bfloat16), wt, [0])
    with pytest.raises(ValueError, match="read past"):
        k12.flat_dot(a, torch.zeros((2, 128, 128), dtype=torch.int8, device=cuda_device),
                     [0, 10], 250)
    with pytest.raises(ValueError, match="shared memory"):  # nine segments of 128 rows
        k12.flat_dot(torch.zeros((1, 2000, 128), dtype=torch.bfloat16, device=cuda_device),
                     torch.zeros((9, 128, 128), dtype=torch.bfloat16, device=cuda_device),
                     [200 * r for r in range(9)], 300)
    x = torch.zeros((1, 8, 16, 128), dtype=torch.bfloat16, device=cuda_device)
    ops, _ = _mk31_operands(1)
    ops = tuple(o.to(cuda_device) if isinstance(o, torch.Tensor) else o for o in ops)
    with pytest.raises(ValueError, match="no kernel form"):
        k8.res_site(x, *ops, prologue="cast", stats=False)
    with pytest.raises(ValueError, match="halo"):
        k8.res_site(x, *ops, prologue="cast", halo="edge")
    with pytest.raises(ValueError, match="C=64"):
        k8.res_site(x[..., :64].contiguous(), *ops[:3],
                    k8.pack_weights(torch.zeros((3, 3, 64, 128), dtype=torch.int8)).to(cuda_device),
                    *ops[4:], stats=False)
    assert {**k8.LAUNCHES, **k8.PROBE_LAUNCHES, **k12.LAUNCHES} == before
