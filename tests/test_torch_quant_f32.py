"""``--quantize`` under float32 and the empty fused-site set: the port
against the JAX package on the CPU.

Under float32 the JAX chains hand an f32 tensor to the first sites of the
res chain (K4's and K2's x, K5's and K3's residual); the Pallas bodies read
it with ``astype(float32)``, unrounded. Here: the four kernels' plain
versions with that f32 operand against the interpret-mode Pallas kernels
(power-of-two scales, where every product is exact: codes, s8 outputs and
bf16 outputs bit for bit, sums within 1e-5; random scales: codes and bf16
values equal on >= 99.9%), the f32 chains against the JAX chains, the f32
Johnson int8 forward against ``transformer_net_s2d2.apply`` with f32 params
and the same fused-site set (interpret mode), the empty set and
``bf16_static`` against the JAX engine, and the float32 modes of the
NST_Train, ReCoNet and Torch7 slots. The kernels themselves run on the
card (``chip_smoke.py`` holds them against these plain versions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralstyletransferv1_tpu.engine import stylizer as jst
from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_tpu.models import transformer_net as jtn
from neuralstyletransferv1_tpu.models import transformer_net_s2d2 as s2d2
from neuralstyletransferv1_torch import adopt_overrides
from neuralstyletransferv1_torch.engine import stylizer as tst
from neuralstyletransferv1_torch.kernels import int8_sites as k8
from neuralstyletransferv1_torch.models import sites_i8
from neuralstyletransferv1_torch.models import transformer_net_quant as tq
from neuralstyletransferv1_torch.models.transformer_net import (
    TransformerNet,
    params_from_jax,
    quant_from_jax,
)

B, H, W, C = 1, 8, 16, 32


_JITTED: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this file: in the six-worker tier-1 run
    the workers share the cores, and a multi-threaded pool then waits at
    each op's barrier for threads other workers preempt."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _static(v) -> bool:
    return v is None or isinstance(v, (bool, int, float, str))


def _jit_site(fn):
    """``fn`` in interpret mode, jitted once per static signature (its Python
    scalars, strings and None): the calls that share one signature, as the
    five blocks of a chain do, share one interpret-mode lowering, the part
    that costs."""

    def call(*args, **kw):
        spos = tuple((i, a) for i, a in enumerate(args) if _static(a))
        skw = tuple(sorted((k, v) for k, v in kw.items() if _static(v)))
        key = (fn, len(args), spos, skw)
        if key not in _JITTED:
            def inner(dyn, dyn_kw, _spos=dict(spos), _skw=dict(skw), _n=len(args)):
                it = iter(dyn)
                return fn(*(_spos[i] if i in _spos else next(it) for i in range(_n)),
                          **dyn_kw, **_skw)

            _JITTED[key] = jax.jit(inner)
        si8._INTERPRET = True
        try:
            return _JITTED[key]([a for a in args if not _static(a)],
                                {k: v for k, v in kw.items() if not _static(v)})
        finally:
            si8._INTERPRET = False

    return call


def _interpret(fn, *args, **kw):
    return jax.tree.map(np.asarray, _jit_site(fn)(*args, **kw))


def _inputs(seed, pow2: bool, w=W):
    """Site operands; x and y f32 (not bf16-representable). ``pow2``: the
    scales that multiply an operand are powers of two, so every product is
    exact and XLA's FMA contraction cannot round differently."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731

    def scale(lo, hi, shape):
        v = rng.uniform(lo, hi, shape)
        return f32(2.0 ** np.round(np.log2(v))) if pow2 else f32(v)

    return {
        "x": f32(rng.normal(0, 2, (B, H, w, C))), "y": f32(rng.normal(0, 1, (B, H, w, C))),
        "r2": np.asarray(jnp.asarray(rng.normal(0, 2, (B, H, w, C)), jnp.bfloat16)
                         .astype(jnp.float32)),
        "a": scale(5, 40, (B, C)), "c": f32(rng.normal(0, 8, (B, C))),
        "a2": scale(0.5, 1.5, (B, C)), "c2": f32(rng.normal(0, 0.3, (B, C))),
        "w": rng.integers(-127, 128, (3, 3, C, C)).astype(np.int8),
        "ws": scale(0.5 / (127 * 127 * 12), 2 / (127 * 127 * 12), C),
        "bias": f32(rng.normal(0, 0.2, C)),
        "qa": scale(10, 60, C), "qc": f32(rng.normal(0, 10, C)),
        "aa": scale(0.5, 1.5, C), "ac": f32(rng.normal(0, 0.3, C)),
        "codes": rng.integers(0, 128, (B, H, w, C)).astype(np.int8),
    }


def _t(d, k):
    v = torch.from_numpy(d[k].copy())
    if k == "r2":
        return v.to(torch.bfloat16)
    return k8.pack_weights(v) if k == "w" else v


def _j(d, k):
    return jnp.asarray(d[k], jnp.bfloat16) if k == "r2" else jnp.asarray(d[k])


def _assert_equal_or_close(ours: np.ndarray, ref: np.ndarray, exact: bool):
    if exact:
        assert np.array_equal(ours, ref), (ours != ref).mean()
    else:
        assert (ours == ref).mean() >= 0.999, (ours == ref).mean()


def _assert_sums(sums: torch.Tensor, sout):
    s, r = sums.numpy().astype(np.float64), np.asarray(sout, np.float64)
    assert np.all(np.abs(s[:, 1] - r[:, 1]) <= 1e-5 * np.abs(r[:, 1]))
    assert np.all(np.abs(s[:, 0] - r[:, 0]) <= 1e-5 * np.sqrt(H * W * np.abs(r[:, 1])))


# ---------------------------------------------------------------------------
# the four f32-operand forms: plain versions vs the interpret-mode Pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("halo", ["reflect", "zero"])
@pytest.mark.parametrize("pow2", [True, False], ids=["pow2", "random"])
def test_k4_f32_x_matches_pallas(halo, pow2):
    d = _inputs(1, pow2)
    ref, sout = _interpret(si8.res_site, _j(d, "x"), _j(d, "a"), _j(d, "c"),
                           _j(d, "w").reshape(9, C, C), _j(d, "ws"), _j(d, "bias"), -127.0,
                           halo=halo)
    ours, sums = k8.res_site(_t(d, "x"), _t(d, "a"), _t(d, "c"), -127.0, _t(d, "w"),
                             _t(d, "ws"), _t(d, "bias"), halo=halo)
    assert ours.dtype == torch.bfloat16
    _assert_equal_or_close(ours.float().numpy(), ref.astype(np.float32), pow2)
    _assert_sums(sums, sout)
    # the f32 operand is not the bf16-rounded one: rounding it first moves codes
    rounded = k8.res_site(_t(d, "x").to(torch.bfloat16), _t(d, "a"), _t(d, "c"), -127.0,
                          _t(d, "w"), _t(d, "ws"), _t(d, "bias"), halo=halo)[0]
    assert not torch.equal(rounded, ours)


@pytest.mark.parametrize("halo", ["reflect", "zero"])
@pytest.mark.parametrize("pow2", [True, False], ids=["pow2", "random"])
def test_k5_f32_residual_matches_pallas(halo, pow2):
    d = _inputs(2, pow2)
    ref, sout, vref = _interpret(
        si8.res_site_skip, _j(d, "r2"), _j(d, "y"), *(_j(d, k) for k in ("a", "c", "a2", "c2")),
        _j(d, "w").reshape(9, C, C), _j(d, "ws"), _j(d, "bias"), -127.0, halo=halo)
    ours, sums, v = k8.res_site_skip(*(_t(d, k) for k in ("r2", "y", "a", "c", "a2", "c2")),
                                     -127.0, _t(d, "w"), _t(d, "ws"), _t(d, "bias"), halo=halo)
    assert v.dtype == ours.dtype == torch.bfloat16
    _assert_equal_or_close(v.float().numpy(), vref.astype(np.float32), pow2)
    _assert_equal_or_close(ours.float().numpy(), ref.astype(np.float32), pow2)
    _assert_sums(sums, sout)


@pytest.mark.parametrize("w,sw,halo", [(W, None, "reflect"), (40, 36, "zero")])
@pytest.mark.parametrize("pow2", [True, False], ids=["pow2", "random"])
def test_k2_f32_x_matches_pallas(w, sw, halo, pow2):
    d = _inputs(3, pow2, w)
    ref = _interpret(si8.res_site_s8o, _j(d, "x"), _j(d, "a"), _j(d, "c"),
                     _j(d, "w").reshape(9, C, C), _j(d, "ws"), _j(d, "bias"), qa=_j(d, "qa"),
                     qc=_j(d, "qc"), lo=-127.0, qlo=0.0, halo=halo, sw=sw)
    ours = k8.res_site_s8o(_t(d, "x"), _t(d, "a"), _t(d, "c"), -127.0, _t(d, "w"), _t(d, "ws"),
                           _t(d, "bias"), _t(d, "qa"), _t(d, "qc"), halo=halo, sw=sw)
    assert ours.dtype == torch.int8
    _assert_equal_or_close(ours.numpy(), ref[:, :, 1:w + 1], pow2)
    if sw is not None:
        assert not ours[:, :, sw:].any()


@pytest.mark.parametrize("w,sw,halo", [(W, None, "reflect"), (40, 36, "zero")])
@pytest.mark.parametrize("pow2", [True, False], ids=["pow2", "random"])
def test_k3_f32_residual_matches_pallas(w, sw, halo, pow2):
    """K3 as block 1 of the static s8 chain runs it under float32: the frozen
    affine, then the f32 residual added unrounded."""
    d = _inputs(4, pow2, w)
    if sw is not None:
        d["codes"][:, :, sw:] = 0  # K2's output form
    carry = si8._s8_col_halo(jnp.asarray(d["codes"][0]), w, si8._wps(w), halo)[None]
    ref = _interpret(si8.site_s8, carry, _j(d, "w").reshape(9, C, C), _j(d, "ws"),
                     _j(d, "bias"), w0=w, y=_j(d, "y"), aff=(_j(d, "aa"), _j(d, "ac")),
                     halo=halo, sw=sw)
    ours = k8.site_s8(torch.from_numpy(d["codes"]), _t(d, "w"), _t(d, "ws"), _t(d, "bias"),
                      _t(d, "aa"), _t(d, "ac"), _t(d, "y"), halo=halo, sw=sw)
    assert ours.dtype == torch.bfloat16
    _assert_equal_or_close(ours.float().numpy(), ref.astype(np.float32), pow2)


def test_f32_forms_route_by_dtype_and_check_their_forms():
    """On the CPU the wrappers take either dtype (the plain versions compute
    both and count nothing); the f32 forms' channel counts are checked only
    where a kernel runs, so their table is what the card's instances are."""
    assert set(k8.F32_FORMS) == set(k8.F32_C) == {"res_site_s8o", "site_s8", "res_site",
                                                   "res_site_skip"}
    assert k8.F32_LAUNCHES == dict.fromkeys(k8.F32_FORMS.values(), 0)
    x = torch.zeros((1, 4, 4, 96), dtype=torch.float32)
    with pytest.raises(ValueError, match="no f32 form at C=96"):
        k8._f32_form("res_site", x, "reflect")
    with pytest.raises(ValueError, match="no f32 form at C=128 with the zero halo and a floor"):
        k8._f32_form("res_site_s8o", torch.zeros((1, 4, 4, 128)), "zero", floored=True)
    assert k8._f32_form("res_site_skip", torch.zeros((1, 4, 4, 192)), "reflect", floored=True)
    assert not k8._f32_form("site_s8", x.to(torch.bfloat16), "reflect")
    with pytest.raises(TypeError):
        k8._f32_form("res_site", x.half(), "reflect")


# ---------------------------------------------------------------------------
# the Johnson chains and forward under float32
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def johnson():
    """Random Johnson weights (``transformer_net.init``) as the JAX f32 f2
    params and the port's f32 net; frames of a smooth textured scene."""
    tree = jax.tree.map(np.asarray, jax.jit(jtn.init)(jax.random.key(0)))
    bp32 = jax.tree.map(jnp.asarray, s2d2.from_johnson_params(tree))
    net = TransformerNet()
    net.load_state_dict(params_from_jax(tree))
    net = net.eval().requires_grad_(False)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:32, 0:64].astype(np.float32)
    scene = 0.5 + 0.25 * np.sin(0.21 * xx + 0.13 * yy)[..., None] \
        + 0.15 * np.cos(0.17 * xx - 0.29 * yy)[..., None] + rng.normal(0, 0.05, (1, 1, 3))
    x = np.clip(scene[None] + rng.normal(0, 0.03, (1, 32, 64, 3)), 0, 1).astype(np.float32)
    return bp32, net, x


_CALIBRATIONS: dict = {}


def _calibrate(bp32, x, static: bool):
    """The JAX calibration of the module's net on ``x`` (kept: several tests
    start from the same one; callers copy before they change it)."""
    key = (id(bp32), x.shape, static)
    if key not in _CALIBRATIONS:
        _CALIBRATIONS[key] = _calibrate_once(bp32, x, static)
    return _CALIBRATIONS[key]


def _calibrate_once(bp32, x, static: bool):
    xj = jnp.asarray(x[:1])
    stats = s2d2.calibrate_in_stats(bp32, xj) if static else None
    scales = s2d2.calibrate_act_scales(bp32, xj, sites=s2d2.QUANT_SITES_PALLAS,
                                       static_stats=stats)
    scales = {k: v for k, v in scales.items() if k in tq.INT8_SITES}
    return stats, s2d2.quantize_net(bp32, scales)


def _spy_dtypes(monkeypatch):
    """The dtype of the operand each K2–K5 wrapper call reads as f32 or bf16
    (x for K2/K4, the residual for K3/K5), in call order."""
    seen = []
    for name, pos in (("res_site", 0), ("res_site_s8o", 0), ("res_site_skip", 1),
                      ("site_s8", 6)):
        fn = getattr(k8, name)

        def spy(*a, _fn=fn, _name=name, _pos=pos, **kw):
            t = a[_pos] if len(a) > _pos else kw.get("y")
            seen.append((_name, None if t is None else t.dtype))
            return _fn(*a, **kw)

        monkeypatch.setattr(k8, name, spy)
    return seen


def _record(monkeypatch, module, names, outs):
    """Record the first output of each call of ``module``'s ``names``."""
    for name in names:
        fn = getattr(module, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            r = _fn(*a, **kw)
            first = r[0] if isinstance(r, (tuple, list)) else r
            outs.append((_name, np.asarray(first.float() if isinstance(first, torch.Tensor)
                                           else first.astype(jnp.float32))))
            return r

        monkeypatch.setattr(module, name, spy)


def _pow2(v):
    """A scale rounded to the nearest power of two (f32)."""
    v = np.asarray(v, np.float32)
    return jnp.asarray((2.0 ** np.round(np.log2(v))).astype(np.float32))


@pytest.mark.parametrize("static", [False, True], ids=["int8", "int8_static"])
def test_f32_chains_match_pallas_chains(johnson, monkeypatch, static):
    """From one f32 res input, the port's f32 res chain against the JAX
    chain in interpret mode, site by site and whole: bit for bit. The sites
    that read the f32 tensor (int8: block 1's K4 and block 2's K5, its
    residual; int8_static: block 1's K2 and K3, its residual) take it as
    f32. The calibration's ws and qin are rounded to powers of two (in
    both): interpret mode may contract acc·ws + bias into an FMA, whose
    isolated bf16 flips the measured norms would carry through the chain
    (at the real scales the f32 sites agree on >= 99.9% and this input's
    int8 output to 6e-3 relative)."""
    bp32, net, x = johnson
    stats, quant = _calibrate(bp32, x, static)
    quant = {k: {**v, "ws": _pow2(v["ws"]), "qin": _pow2(v["qin"])} for k, v in quant.items()}
    q, st = quant_from_jax(quant, stats)
    sites = sites_i8.prepare_sites(net, q, "cpu")
    # an activated res input (f32, >= 0) at the res grid of the 32 x 64 frame
    y = np.maximum(np.random.default_rng(5).normal(0, 1.5, (1, 8, 16, 128)), 0).astype(np.float32)
    names = ("res_site_s8o", "site_s8") if static else ("res_site", "res_site_skip")
    jouts, touts = [], []
    with monkeypatch.context() as m:
        for name in names:  # the blocks' sites share their lowerings
            m.setattr(si8, name, _jit_site(getattr(si8, name)))
        _record(m, si8, names, jouts)
        if static:
            ref = jax.tree.map(np.asarray, si8.res_chain_s8_static(jnp.asarray(y), bp32, quant,
                                                                   stats))
        else:
            ref = jax.tree.map(np.asarray, si8.res_chain(jnp.asarray(y), bp32, quant))
    seen = _spy_dtypes(monkeypatch)
    _record(monkeypatch, k8, names, touts)
    with torch.no_grad():
        yt = torch.from_numpy(y)
        ours = (sites_i8.res_chain_s8_static(yt, net, sites, st) if static
                else sites_i8.res_chain(yt, net, sites, ret_carry=False))
    f32 = [name for name, dt in seen if dt == torch.float32]
    assert f32 == list(names)
    assert [n for n, _ in touts] == [n for n, _ in jouts]
    f32_sites = [0, 1] if static else [0, 2]  # K4 r1a, then K5 (after K4 r1b)
    for i in f32_sites:
        a, b = touts[i][1], jouts[i][1]
        if touts[i][0] == "res_site_s8o":
            b = b[:, :, 1:y.shape[2] + 1]
        assert np.array_equal(a, b), touts[i][0]
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert np.array_equal(ours.float().numpy(), ref.astype(np.float32))


@pytest.mark.parametrize("static", [False, True], ids=["int8", "int8_static"])
def test_f32_int8_forward_matches_jax_apply(johnson, static):
    """The whole f32 int8 forward under the adopted set against
    ``transformer_net_s2d2.apply`` with f32 params and the same quant in the
    XLA int8 form (``fused_sites=()``, what the JAX engine runs on the CPU):
    within the repo's 1e-2 int8 gate on [0, 1]. (With the adopted set itself
    the JAX forward stops at deconv3 under f32 params: the int8 sites' bf16
    output meets deconv3's f32 weights in one conv. The port runs the tail
    in f32 on it.)"""
    bp32, net, x = johnson
    stats, quant = _calibrate(bp32, x, static)
    ref = np.asarray(jax.jit(lambda xj: jnp.clip(s2d2.apply(
        bp32, xj, quant=quant, static_stats=stats), 0, 1))(jnp.asarray(x)))
    q, st = quant_from_jax(quant, stats)
    with torch.no_grad():
        ours = tq.forward_int8(net, torch.from_numpy(x), sites_i8.prepare_sites(net, q, "cpu"),
                               st, fused_sites=tq.default_sites(static))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    mae = float(np.abs(np.clip(ours.numpy(), 0, 1) - ref).mean())
    assert mae <= 1e-2, mae


def test_f32_sets_naming_head_or_tail_sites_raise(johnson):
    """head_i8, tail_s8 and d3_i8 have no float32 form (no adopted set and no
    CLI flag reaches them); under bfloat16 they run."""
    bp32, net, x = johnson
    _, quant = _calibrate(bp32, x, False)
    q, _ = quant_from_jax(quant)
    sites = sites_i8.prepare_sites(net, q, "cpu")
    for name in ("head_i8", "tail_s8", "d3_i8"):
        with pytest.raises(NotImplementedError, match="no CLI path"):
            tq.forward_int8(net, torch.from_numpy(x), sites, fused_sites=("res_i8", name))


# ---------------------------------------------------------------------------
# the engine's modes under float32: the empty set, bf16_static, other slots
# ---------------------------------------------------------------------------


def _model(net):
    return tst.StyleModel("johnson", net, "raw_01", "init")


def _jax_model(tmp_path, net):
    path = tmp_path / "j.pth"
    sd = {k: v for k, v in net.state_dict().items()}
    torch.save(sd, path)
    return jst.load_model(path, io_preset="raw_01")


@pytest.mark.parametrize("quantize", ["int8", "int8_static"])
def test_empty_set_matches_jax_engine(johnson, tmp_path, monkeypatch, quantize):
    """The empty fused-site set (the JAX engine's "mk32" configuration): every
    site of ``QUANT_SITES``, c2 and c3 included, through the XLA int8 form,
    no site kernel. Held against the JAX engine with its adopted set patched
    to () (its site filter then keeps ``QUANT_SITES``; on the CPU it applies
    ``fused_sites=()``), under float32 and bfloat16, within the 1e-2 gate
    (the two heads' f32 sums round differently, and a flipped code moves
    this random net's later statistics: measured 5e-3 to 6.5e-3)."""
    _, net, x = johnson
    monkeypatch.setattr(jst, "_I8_FUSED_SITES", ())
    monkeypatch.setattr(jst, "_I8_FUSED_STATIC", ())
    assert tq.check_fused_sites(()) == ()
    assert sorted(tq.site_filter({s: 1.0 for s in tq.QUANT_SITES_PALLAS}, 32, 64, ())) == \
        sorted(tq.QUANT_SITES)
    seen = _spy_dtypes(monkeypatch)
    qc_sites = []
    qc = sites_i8._qc
    monkeypatch.setattr(sites_i8, "_qc", lambda *a, **kw: (qc_sites.append(a[4]), qc(*a, **kw))[1])
    jmodel = _jax_model(tmp_path, net)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        qc_sites.clear()
        ours = tst.jit_stylizer(_model(net), dtype=dtype, quantize=quantize,
                                fused_sites=())(torch.from_numpy(x)).numpy()
        ref = np.asarray(jst.jit_stylizer(jmodel, dtype=jdt, quantize=quantize)(jnp.asarray(x)))
        mae = float(np.abs(ours - ref).mean())
        assert mae <= 1e-2, (dtype, mae)
        assert len(qc_sites) == len(tq.QUANT_SITES)  # c2, c3, the res sites, d1, d2
    assert seen == []  # no site kernel's wrapper


def test_bf16_static_f32_matches_jax_call_static(johnson, tmp_path):
    """``bf16_static`` under float32: the f32 static-norm path (JAX
    ``call_static``), frozen to the first frame's statistics."""
    _, net, x = johnson
    ours = tst.jit_stylizer(_model(net), quantize="bf16_static")(torch.from_numpy(x)).numpy()
    ref = np.asarray(jst.jit_stylizer(_jax_model(tmp_path, net), dtype=jnp.float32,
                                      quantize="bf16_static")(jnp.asarray(x)))
    mae = float(np.abs(ours - ref).mean())
    assert mae <= 1e-5, mae


@pytest.mark.parametrize("quantize", ["int8", "int8_static"])
def test_f32_stylize_modes_match_jax_engine(johnson, tmp_path, monkeypatch, quantize):
    """The Johnson slot's int8 modes under float32 through ``jit_stylizer``
    (the adopted sets: K4/K5 and K2/K3 with the f32 forms first) against the
    JAX engine's on the CPU (its XLA int8 reference): within 1e-2."""
    _, net, x = johnson
    seen = _spy_dtypes(monkeypatch)
    ours = tst.jit_stylizer(_model(net), quantize=quantize)(torch.from_numpy(x)).numpy()
    ref = np.asarray(jst.jit_stylizer(_jax_model(tmp_path, net), dtype=jnp.float32,
                                      quantize=quantize)(jnp.asarray(x)))
    assert np.abs(ours - ref).mean() <= 1e-2
    f32 = sorted({name for name, dt in seen if dt == torch.float32})
    assert f32 == (["res_site_s8o", "site_s8"] if quantize == "int8_static"
                   else ["res_site", "res_site_skip"])


def _x(shape, seed):
    return np.random.default_rng(seed).random(shape, np.float32)


@pytest.mark.parametrize("arch,quantize,f32_forms", [
    ("nst", "int8", []),
    ("nst", "int8_static", ["res_site_s8o", "site_s8"]),
    ("reconet", "int8", ["res_site", "res_site_skip"]),
    ("reconet", "int8_static", ["res_site", "res_site_s8o", "site_s8"]),
    ("reconet", "bf16_static", []),
    ("t7", "int8", ["res_site", "res_site_skip"]),
    ("t7", "bf16_static", [])])
def test_other_slots_f32_modes_match_jax_engine(tmp_path, monkeypatch, arch, quantize, f32_forms):
    """NST_Train (its adopted ``nst`` set is empty: the XLA-form chain;
    ``nst_static``: K2/K3 with the zero halo and sw), ReCoNet (``reco``: K4
    at block 0 and d1, K5 at block 1 with the f32 residual;
    ``reco_static``: every block's K2 and K3 read the f32 carry, and d1's
    K4) and an instance-norm Torch7 net (``t7``: K4/K5 with the zero halo)
    under float32, against the JAX engine's on the CPU: within 1e-2; and
    ``bf16_static`` under float32 (the f32 static-norm paths of the JAX
    engine's ``call_static_gen`` and ``call_static_t7``)."""
    if arch == "nst":
        from neuralstyletransferv1_torch.models import transformer_net_nst as tnn

        path = tmp_path / "nst.pth"
        torch.save(tnn.init(0), path)
        mt, x = "transformer", _x((2, 48, 64, 3), 9)
    elif arch == "reconet":
        from neuralstyletransferv1_torch.models import reconet as tr

        path = tmp_path / "reco.pth"
        torch.save(tr.init(1, False), path)
        mt, x = "reconet", _x((2, 32, 64, 3), 9)
    else:
        from test_torch_t7 import _frames, _layers, _write

        path = _write(tmp_path / "net.t7", _layers("in", seed=13))
        mt, x = "torch7", _frames((1, 32, 64, 3), 1)
    seen = _spy_dtypes(monkeypatch)
    ours = tst.jit_stylizer(tst.load_model(path, model_type=mt), quantize=quantize)(
        torch.from_numpy(x)).numpy()
    if mt == "torch7":
        from neuralstyletransferv1_tpu.io import t7 as jt7

        jmodel = jt7.load_torch7_model(str(path))
    else:
        jmodel = jst.load_model(path, model_type=mt)
    ref = np.asarray(jst.jit_stylizer(jmodel, dtype=jnp.float32, quantize=quantize)(
        jnp.asarray(x)))
    assert ours.shape == ref.shape == x.shape
    assert np.abs(ours - ref).mean() <= 1e-2
    assert sorted({name for name, dt in seen if dt == torch.float32}) == f32_forms


def test_adopted_sets_unchanged():
    assert adopt_overrides.sites("sites") == ("res_i8", "dec_i8")
    assert adopt_overrides.sites("sites_static") == ("res_i8", "res_s8", "dec_i8")
