"""K12's flat form and K10 on their Hopper cores (``shift_wgmma_kernel``,
``fused_wgmma_kernel``): the plain versions at the shapes that meet the new
tiles' edges against the JAX package's functions on the CPU, the wrappers'
dispatch, and the shared-memory plan of K12; on the card, the new cores
against the plain versions and the previous cores.

K12's JAX side is a Pallas shifted dot in interpret mode, as
``tests/test_torch_int8_probes.py`` runs the probe scripts: mk27's own
kernel bodies at ROWS = MT = 200 (off the new 128-row tile; module globals
patched), and a body of the same form, Σ_r jnp.dot(x[off_r : off_r + M],
w[r]) after the prologue's convert, rebuilt here for what mk27 cannot take
(N = 256, K = 512, offsets in several staged segments, slices as a grid
axis). K10's is mk1's ``xla_unit`` (prologue f32 or none) and mk5's
``_prologue(..., "bf16")`` before it, run eagerly, at output grids off the
new 4 × 32 tile.

Tolerances, as in ``tests/test_torch_int8_probes.py`` and
``tests/test_torch_experiments.py``: integer-valued outputs bit for bit;
bf16 → f32 within 1e-5·Σ_k |a_k b_k|; bf16 outputs within 1 bf16 ulp (taken
at no less than 2^-8 of the largest magnitude) and equal on ≥ 99%; sums
within 1e-5 relative. The ``cuda`` cases import no JAX, so the card's
machine runs them with ``--noconftest``.
"""

import functools

import numpy as np
import pytest
import torch

from neuralstyletransferv1_torch.experiments import _bench
from neuralstyletransferv1_torch.kernels import bf16_sites as k9
from neuralstyletransferv1_torch.kernels import int8_probes as k12

C = 128
F32_TOL = 1e-5


@pytest.fixture
def jx(monkeypatch):
    """The JAX side, with pallas_call in interpret mode for this test."""
    import types

    import jax
    import jax.experimental.pallas as pl
    import jax.numpy as jnp

    from experiments import mk1_fusedconv, mk5_ablate, mk27_pallas_s8_dot

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
    return types.SimpleNamespace(jax=jax, jnp=jnp, pl=pl, orig=orig, mk1=mk1_fusedconv,
                                 mk5=mk5_ablate, mk27=mk27_pallas_s8_dot)


def _bf(a) -> np.ndarray:
    """Round to bf16, back as f32 numpy."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _assert_bf16_close(ours: torch.Tensor, ref):
    r = torch.from_numpy(np.array(ref, np.float32))
    assert tuple(ours.shape) == tuple(r.shape), (ours.shape, r.shape)
    worst, equal = k9.bf16_ulp_error(ours, r)
    assert worst <= 1.0 and equal >= _bench.BF16_EQUAL_SHARE, (worst, equal)


# ---------------------------------------------------------------------------
# K12: the flat form's plain version at the new tiles' edges
# ---------------------------------------------------------------------------

#: (A dtype, prologue, out) by name
FORMS = {"s8-s32": (torch.int8, "none", "s32"), "s8-bf16": (torch.int8, "none", "bf16"),
         "bf16-f32": (torch.bfloat16, "none", "f32"),
         "bf16-bf16": (torch.bfloat16, "none", "bf16"),
         "quant-bf16": (torch.bfloat16, "quant", "bf16"),
         "cast-bf16": (torch.bfloat16, "cast", "bf16")}
#: (form, G, MA, K, N, offsets): M = MA − max(offsets) off the 128-row tile
#: everywhere; one staged segment, several, and one of 288 rows (two boxes)
FLAT_CASES = [("s8-s32", 2, 300, 128, 128, (0, 1, 2, 3, 4, 5)),
              ("bf16-f32", 1, 200, 512, 256, (0,)),
              ("s8-bf16", 2, 700, 256, 128, (7, 0, 300, 5)),
              ("quant-bf16", 1, 560, 128, 256, (0, 130, 260)),
              ("cast-bf16", 3, 400, 128, 128, (0, 32, 64, 96, 128, 160)),
              ("bf16-bf16", 2, 260, 128, 256, (0, 1, 2, 130, 131, 132))]
OSCALE = 0.5


def _flat_operands(form, g, ma, k, n, r, seed):
    """Seeded A [G, MA, K] (s8 codes, or bf16: normal, ·4 for the quantize,
    ·90 with NaN and ±300 for the cast) and weights [R, K, N]."""
    adt, pro, _ = FORMS[form]
    rng = np.random.default_rng(seed)
    if adt == torch.int8:
        a = rng.integers(-128, 128, (g, ma, k)).astype(np.float32)
    else:
        a = _bf(rng.normal(0, {"quant": 4, "cast": 90}.get(pro, 1), (g, ma, k)))
        if pro == "cast":
            a[..., :3] = [np.nan, 300.0, -300.0]
    if k12._mma_bf16(torch.zeros((), dtype=adt), pro):
        w = _bf(rng.normal(0, 1, (r, k, n)))
    else:
        w = rng.integers(-128, 128, (r, k, n)).astype(np.float32)
    return a, w


def _shift_body(offsets, m, pro, form_out, jnp):
    """A Pallas body of K12's flat function for one slice."""
    acc_t = jnp.float32 if form_out == "f32" else None

    def kern(x_ref, w_ref, o_ref):
        acc = None
        for r, off in enumerate(offsets):
            xs = x_ref[0, off:off + m, :]
            if pro == "quant":
                xs = jnp.clip(jnp.round(xs.astype(jnp.float32) * k12.QSCALE_DOT), -127,
                              127).astype(jnp.int8)
            elif pro == "cast":
                xs = xs.astype(jnp.int8)
            at = acc_t or (jnp.float32 if xs.dtype == jnp.bfloat16 else jnp.int32)
            p = jnp.dot(xs, w_ref[r], preferred_element_type=at)
            acc = p if acc is None else acc + p
        if form_out == "bf16":
            acc = (acc.astype(jnp.float32) * OSCALE).astype(jnp.bfloat16)
        o_ref[0] = acc
    return kern


@pytest.mark.parametrize("form,g,ma,k,n,offsets", FLAT_CASES,
                         ids=[f"{c[0]}-g{c[1]}-k{c[3]}-n{c[4]}-r{len(c[5])}" for c in FLAT_CASES])
def test_flat_plain_matches_pallas_shifted_dot(jx, form, g, ma, k, n, offsets):
    """K12's flat plain version against the shifted dot as a Pallas kernel
    over G slices (grid axis), in interpret mode."""
    jnp, pl = jx.jnp, jx.pl
    adt, pro, out = FORMS[form]
    a, w = _flat_operands(form, g, ma, k, n, len(offsets), g * ma + k)
    m = ma - max(offsets)
    jdt = {torch.int8: jnp.int8, torch.bfloat16: jnp.bfloat16}
    wdt = jnp.bfloat16 if k12._mma_bf16(torch.zeros((), dtype=adt), pro) else jnp.int8
    odt = {"s32": jnp.int32, "f32": jnp.float32, "bf16": jnp.bfloat16}[out]
    ref = jx.orig(
        _shift_body(offsets, m, pro, out, jnp), grid=(g,),
        in_specs=[pl.BlockSpec((1, ma, k), lambda i: (i, 0, 0)),
                  pl.BlockSpec((len(offsets), k, n), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((1, m, n), lambda i: (i, 0, 0)),
        out_shape=jx.jax.ShapeDtypeStruct((g, m, n), odt), interpret=True,
    )(jnp.asarray(a, jdt[adt]), jnp.asarray(w, wdt))
    ta = torch.from_numpy(a).to(adt)
    wt = k12.pack_taps(torch.from_numpy(w).to(torch.bfloat16 if wdt == jnp.bfloat16
                                              else torch.int8))
    ours = k12.flat_dot(ta, wt, list(offsets), pro=pro, out=out, oscale=OSCALE)
    assert tuple(ours.shape) == (g, m, n)
    r = np.asarray(ref.astype(jnp.float32) if out == "bf16" else ref)
    if out == "f32":
        scale = k12.flat_dot_plain(ta.abs(), wt.abs(), list(offsets), out="f32").numpy()
        assert np.all(np.abs(ours.numpy().astype(np.float64) - r) <= F32_TOL * scale)
    elif adt == torch.bfloat16 and pro == "none":
        _assert_bf16_close(ours, r)
    else:
        np.testing.assert_array_equal(ours.float().numpy(), r.astype(np.float32))


@pytest.mark.parametrize("kern,adt,wdt", [("_k_s8_unaligned", torch.int8, torch.int8),
                                          ("_k_bf16cast", torch.bfloat16, torch.int8),
                                          ("_k_bf16", torch.bfloat16, torch.bfloat16)])
def test_flat_plain_matches_mk27_off_the_tile(jx, monkeypatch, kern, adt, wdt):
    """mk27's own bodies at ROWS = MT = 200 rows (off the new 128-row tile),
    offsets 0..5: bit for bit (integer operands keep every sum exact)."""
    jnp, mk27 = jx.jnp, jx.mk27
    monkeypatch.setattr(mk27, "ROWS", 200)
    monkeypatch.setattr(mk27, "MT", 200)
    monkeypatch.setattr(mk27, "GRID", 1)
    rng = np.random.default_rng(9)
    x = rng.integers(-100, 100, (264, C)).astype(np.float32)
    w = rng.integers(-100, 100, (6, C, C)).astype(np.float32)
    dt = {torch.int8: jnp.int8, torch.bfloat16: jnp.bfloat16}
    f, _ = mk27.build(getattr(mk27, kern), dt[adt], dt[wdt])
    ref = np.asarray(f(jnp.asarray(x), jnp.asarray(w)).astype(jnp.float32))
    ours = k12.flat_dot(torch.from_numpy(x).to(adt),
                        k12.pack_taps(torch.from_numpy(w).to(wdt)), list(range(6)), 200,
                        pro="cast" if kern == "_k_bf16cast" else "none")
    np.testing.assert_array_equal(ours.float().numpy(), ref)


# ---------------------------------------------------------------------------
# K10: the plain version off the new 4 × 32 tile, in its six forms
# ---------------------------------------------------------------------------


def _fused_operands(seed, b, h, w):
    """mk1's operands: x_pad [B, H+2, W+8, 128] (6 junk columns), stat with
    c > 0 on half the channels."""
    rng = np.random.default_rng(seed)
    return {"x_pad": _bf(rng.normal(0, 1.0, (b, h + 2, w + 8, C))),
            "stat": np.stack([rng.normal(0, 1.0, (b, C)), rng.normal(0.05, 0.3, (b, C))],
                             1).astype(np.float32),
            "w": _bf(rng.normal(0, 0.05, (3, 3, C, C))),
            "cb": np.asarray(rng.normal(0, 1.0, C), np.float32)}


def _torch_fused(op):
    t = torch.from_numpy
    return (t(op["x_pad"]).to(torch.bfloat16), t(op["stat"]),
            t(op["w"].reshape(9, C, C)).to(torch.bfloat16), t(op["cb"]))


@pytest.mark.parametrize("prologue", ["f32", "none", "bf16"])
@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("b,h,w", [(2, 6, 45), (1, 13, 37)])
def test_k10_plain_off_the_tile_matches_mk1(jx, prologue, stats, b, h, w):
    """K10's plain version at output grids that leave partial 4 × 32 tiles,
    against mk1's ``xla_unit`` (mk5's bf16 prologue before it)."""
    jnp = jx.jnp
    op = _fused_operands(b * h + w, b, h, w)
    x, stat = jnp.asarray(op["x_pad"], jnp.bfloat16), jnp.asarray(op["stat"])
    wj, cb = jnp.asarray(op["w"], jnp.bfloat16), jnp.asarray(op["cb"])
    if prologue == "bf16":
        x = jnp.stack([jx.mk5._prologue(x[i], stat[i:i + 1], "bf16") for i in range(b)])
    yr, sr = jx.mk1.xla_unit(x, wj, cb, stat,
                             prologue="affine_relu" if prologue == "f32" else "none")
    y, s = k9.fused_conv(*_torch_fused(op), (h, w), prologue=prologue, stats=stats)
    _assert_bf16_close(y, yr)
    if not stats:
        assert s is None
        return
    got, want = s.numpy().astype(np.float64), np.asarray(sr, np.float64)
    s2 = np.abs(want[:, 1])
    assert np.all(np.abs(got[:, 1] - want[:, 1]) <= F32_TOL * s2)
    assert np.all(np.abs(got[:, 0] - want[:, 0]) <= F32_TOL * np.sqrt(h * w * s2))


# ---------------------------------------------------------------------------
# dispatch and K12's shared-memory plan
# ---------------------------------------------------------------------------


def _small_k12():
    a = torch.from_numpy(np.random.default_rng(1).integers(-128, 128, (2, 140, C))
                         .astype(np.int8))
    wt = torch.from_numpy(np.random.default_rng(2).integers(-128, 128, (3, C, C))
                          .astype(np.int8))
    x = torch.from_numpy(_bf(np.random.default_rng(3).normal(0, 4, (1, 10, 21, C))))
    return a, wt, x.to(torch.bfloat16)


@pytest.mark.parametrize("name", ["flat_dot_prev", "strip_dot_prev", "fused_conv_prev"])
def test_previous_cores_refuse_cpu_tensors(name):
    """The previous cores are for timing on the card: a CPU tensor raises,
    and nothing is counted."""
    a, wt, x = _small_k12()
    before = {**k12.LAUNCHES, **k9.LAUNCHES}
    with pytest.raises(NotImplementedError, match="no kernel for device cpu"):
        if name == "flat_dot_prev":
            k12.flat_dot_prev(a, wt, [0, 1, 2])
        elif name == "strip_dot_prev":
            k12.strip_dot_prev(x, k12.pack_taps(torch.zeros((9, C, C), dtype=torch.int8)),
                               pro="quant")
        else:
            k9.fused_conv_prev(*_torch_fused(_fused_operands(0, 1, 4, 32)), (4, 32))
    assert {**k12.LAUNCHES, **k9.LAUNCHES} == before


@pytest.mark.parametrize("kernel", ["flat_dot", "strip_dot", "fused_conv"])
def test_cpu_tensors_take_the_plain_versions(kernel):
    """A CPU tensor runs the plain version (bit-identical to it), and the
    kernels count no launch."""
    a, wt, x = _small_k12()
    before = {**k12.LAUNCHES, **k9.LAUNCHES}
    if kernel == "flat_dot":
        assert torch.equal(k12.flat_dot(a, wt, [0, 5, 9], out="s32"),
                           k12.flat_dot_plain(a, wt, [0, 5, 9], out="s32"))
    elif kernel == "strip_dot":
        w9 = k12.pack_taps(torch.from_numpy(np.random.default_rng(4).integers(
            -128, 128, (9, C, C)).astype(np.int8)))
        assert torch.equal(k12.strip_dot(x, w9, pro="quant", oscale=2.0 ** -8),
                           k12.strip_dot_plain(x, w9, pro="quant", oscale=2.0 ** -8))
    else:
        args = _torch_fused(_fused_operands(5, 1, 5, 33))
        (y, s), (yp, sp) = (k9.fused_conv(*args, (5, 33), prologue="bf16"),
                            k9.fused_conv_plain(*args, (5, 33), prologue="bf16"))
        assert torch.equal(y, yp) and torch.equal(s, sp)
    assert {**k12.LAUNCHES, **k9.LAUNCHES} == before


#: every probe's offsets (and prologue): mk20's probe 2, mk27 at steps 1
#: and 32, mk20 / mk21's strips at W = 488 and the small W = 21, 24
PROBE_PLANS = {"mk20 P2": ([0], "none"), "mk27 r": (list(range(6)), "none"),
               "mk27 32r": ([32 * r for r in range(6)], "none"),
               "mk27 cast": (list(range(6)), "cast"),
               "strip W=488": (k12.strip_offsets(488), "none"),
               "strip W=488 quant": (k12.strip_offsets(488), "quant"),
               "strip W=21 quant": (k12.strip_offsets(21), "quant"),
               "strip W=24": (k12.strip_offsets(24), "none")}


@pytest.mark.parametrize("probe", list(PROBE_PLANS))
def test_smem_plan_fits_every_probe(probe):
    """K12's plan for every probe's offsets fits a block's shared memory
    with at least two slots of each ring, whole 1024-byte swizzle atoms a
    segment and boxes of at most 256 rows."""
    offsets, pro = PROBE_PLANS[probe]
    plan = k12.smem_plan(offsets, pro)
    assert plan["bytes"] <= k12.SMEM_MAX
    assert plan["a_slots"] >= 2 and plan["w_slots"] >= 2
    assert plan["box"] % 8 == 0 and plan["box"] <= 256
    assert plan["rows"] % plan["box"] == 0
    assert plan["rows"] >= k12.TILE_M + max(offsets) - min(offsets) or len(
        k12._segments(offsets)) > 1


def test_smem_plan_fits_the_test_shapes():
    """Every flat case above fits the kernel's shared memory."""
    for form, *_, offsets in FLAT_CASES:
        assert k12.smem_plan(offsets, FORMS[form][1])["bytes"] <= k12.SMEM_MAX, (form, offsets)


def test_smem_plan_refuses_far_apart_taps():
    """Nine taps 200 rows apart stage nine segments: two slots do not fit,
    and the wrapper would refuse the form."""
    plan = k12.smem_plan([200 * r for r in range(9)])
    assert plan["bytes"] > k12.SMEM_MAX and plan["rows"] == 9 * k12.TILE_M


# ---------------------------------------------------------------------------
# on the card: the new cores against the plain versions and the previous ones
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K10 and K12 are CUDA kernels with no CPU mode)")
    from neuralstyletransferv1_torch.device import resolve_device

    return resolve_device("cuda")


def _card_check(name, out, again, ref, a, wt, offsets):
    """The form's gate (mk20's check_f32 for f32 out, 1 ulp for bf16 sums,
    else bit for bit)."""
    if out.dtype == torch.float32:
        from neuralstyletransferv1_torch.experiments.mk20_int8_smoke import check_f32

        scale = k12.flat_dot_plain(a.abs(), wt.abs(), offsets, out="f32")
        return check_f32(scale)(name, out, again, ref)
    if a.dtype == torch.bfloat16 and wt.dtype == torch.bfloat16:
        return _bench.check(name, out, again, ref)
    return _bench.check(name, out, again, ref, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("form,g,ma,k,n,offsets", FLAT_CASES,
                         ids=[f"{c[0]}-g{c[1]}-k{c[3]}-n{c[4]}-r{len(c[5])}" for c in FLAT_CASES])
def test_flat_new_core_matches_plain_and_previous_on_card(cuda_device, form, g, ma, k, n,
                                                          offsets):
    """The flat form on the new core: two launches bit-identical, held
    against the plain version and the previous core by the form's gate,
    one launch counted each."""
    adt, pro, out = FORMS[form]
    a, w = _flat_operands(form, g, ma, k, n, len(offsets), g * ma + k)
    wdt = torch.bfloat16 if k12._mma_bf16(torch.zeros((), dtype=adt), pro) else torch.int8
    ta = torch.from_numpy(a).to(cuda_device).to(adt)
    wt = k12.pack_taps(torch.from_numpy(w).to(cuda_device).to(wdt))
    kw = {"pro": pro, "out": out, "oscale": OSCALE}
    before = k12.LAUNCHES["shift_dot"]
    res, again = (k12.flat_dot(ta, wt, list(offsets), **kw) for _ in range(2))
    prev = k12.flat_dot_prev(ta, wt, list(offsets), **kw)
    ref = k12.flat_dot_plain(ta, wt, list(offsets), **kw)
    torch.cuda.synchronize()
    assert k12.LAUNCHES["shift_dot"] - before == 2
    _card_check("shift_dot", res, again, ref, ta, wt, list(offsets))
    _card_check("shift_dot vs previous", res, again, prev, ta, wt, list(offsets))


@pytest.mark.cuda
@pytest.mark.parametrize("form", [f for f in FORMS if FORMS[f][2] == "bf16"])
@pytest.mark.parametrize("b,h,w", [(2, 16, 21), (1, 8, 488)])
def test_strip_new_core_matches_plain_and_previous_on_card(cuda_device, form, b, h, w):
    """The strip form on the new core (W = 21: one segment; 488: three),
    against the plain version and the previous core."""
    adt, pro, _ = FORMS[form]
    a, wn = _flat_operands(form, b, (h + 2) * w, C, C, 9, b * h * w)
    wdt = torch.bfloat16 if k12._mma_bf16(torch.zeros((), dtype=adt), pro) else torch.int8
    x = torch.from_numpy(a).to(cuda_device).to(adt).view(b, h + 2, w, C)
    wt = k12.pack_taps(torch.from_numpy(wn).to(cuda_device).to(wdt))
    kw = {"pro": pro, "oscale": 2.0 ** -8}
    res, again = (k12.strip_dot(x, wt, **kw) for _ in range(2))
    prev, ref = k12.strip_dot_prev(x, wt, **kw), k12.strip_dot_plain(x, wt, **kw)
    torch.cuda.synchronize()
    exact = not (adt == torch.bfloat16 and pro == "none")
    _bench.check("shift_dot strip", res, again, ref, exact=exact)
    _bench.check("shift_dot strip vs previous", res, again, prev, exact=exact)


@pytest.mark.cuda
@pytest.mark.parametrize("probe", list(PROBE_PLANS))
def test_smem_plan_mirrors_the_kernel_on_card(cuda_device, probe):
    """``smem_plan`` answers as the source's ``shift_dot_smem_bytes``."""
    import ctypes

    offsets, pro = PROBE_PLANS[probe]
    offs = (ctypes.c_int * len(offsets))(*offsets)
    assert (k12._lib().shift_dot_smem_bytes(offs, len(offsets), int(pro != "none"))
            == k12.smem_plan(offsets, pro)["bytes"])


@pytest.mark.cuda
@pytest.mark.parametrize("prologue", ["f32", "none", "bf16"])
@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("b,h,w", [(2, 6, 45), (1, 13, 37), (3, 9, 64)])
def test_k10_new_core_matches_plain_and_previous_on_card(cuda_device, prologue, stats, b, h,
                                                         w):
    """K10 on the new core at grids with partial 4 × 32 tiles and with
    several tiles a block (B = 3): two launches bit-identical, within 1 ulp
    of the plain version and of the previous core, sums within 1e-5."""
    args = tuple(t.to(cuda_device) for t in _torch_fused(_fused_operands(b * h + w, b, h, w)))
    kw = {"prologue": prologue, "stats": stats}
    before = k9.LAUNCHES["fused_conv"]
    (y, s), (y2, s2) = (k9.fused_conv(*args, (h, w), **kw) for _ in range(2))
    yp, sp = k9.fused_conv_prev(*args, (h, w), **kw)
    yr, sr = k9.fused_conv_plain(*args, (h, w), **kw)
    torch.cuda.synchronize()
    assert k9.LAUNCHES["fused_conv"] - before == 2
    _bench.check("fused_conv", y, y2, yr, sums=s, sums_again=s2, sums_ref=sr)
    _bench.check("fused_conv vs previous", y, y2, yp, sums=s, sums_again=s2, sums_ref=sp)
