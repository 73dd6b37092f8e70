"""The int8 kernel forms of the NST_Train path, and its forward under every
fused-site name, against the JAX package on the CPU.

Sites: the plain versions of K4's 2×2 block forms (``pt = pl = 1``, conv2's
stride-2 scatter; ``pt = pl = 0``, a k3 transposed conv's phase scatter), K4
and K5 with ``sw``, and K3's 2×2 form with ``sw``, bf16 out or its
``halo_out="zero2"`` emit feeding K6, bit-exact against the Pallas sites in
interpret mode; the 2×2 weight packing against the JAX ``reshape(4, C, CO)``
tap order. Chains: the port's ``transformer_net_nst_fast.apply`` against the
JAX ``apply`` under each name (``res_i8`` with measured and frozen norms,
``c2_i8``, ``dec_i8``, ``dec_s8``, ``tail_s8``, ``dec_xla_i8``,
``tail_xla_i8``), with the JAX Pallas sites in interpret mode where the
comparison is exact and within the JAX tests' own bounds where rounding
orders differ; and ``--quantize int8`` / ``int8_static`` through
``jit_stylizer`` under the built-in defaults (no adoption file), within the
repo's 1e-2 gate of their bf16 base. The kernels run only on the card
(``tests/test_torch_int8_forms_card.py``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_tpu.models import transformer_net_nst as jn
from neuralstyletransferv1_tpu.models import transformer_net_nst_fast as jf
from neuralstyletransferv1_torch import adopt_overrides
from neuralstyletransferv1_torch.engine import stylizer as tst
from neuralstyletransferv1_torch.kernels import int8_sites as k8
from neuralstyletransferv1_torch.models import transformer_net_nst as tn
from neuralstyletransferv1_torch.models import transformer_net_nst_fast as tf



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this file: in the six-worker tier-1 run
    the workers share the cores, and a multi-threaded pool then waits at
    each op's barrier for threads other workers preempt."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _interpret(fn, *args, **kw):
    si8._INTERPRET = True
    try:
        return jax.tree.map(np.asarray, fn(*args, **kw))
    finally:
        si8._INTERPRET = False


def _bf(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _inputs(seed, b, h, w, c, co, taps):
    """Site operands with power-of-two dequant and affine scales, so that
    no product rounds differently where XLA contracts an FMA."""
    rng = np.random.default_rng(seed)
    p2 = lambda lo, hi, n: (2.0 ** rng.integers(lo, hi, n)).astype(np.float32)  # noqa: E731
    return {
        "x": _bf(rng.normal(0, 2, (b, h, w, c))), "y": _bf(rng.normal(0, 1, (b, h, w, c))),
        "a": p2(2, 6, (b, c)), "c": _bf(rng.normal(0, 8, (b, c))),
        "a2": p2(-1, 1, (b, c)), "c2": _bf(rng.normal(0, 0.3, (b, c))),
        "w": rng.integers(-127, 128, (taps, c, co)).astype(np.int8),
        "ws": p2(-19, -16, co), "bias": _bf(rng.normal(0, 0.2, co)),
        "qa": p2(3, 6, co), "qc": _bf(rng.normal(0, 10, co)),
        "codes": rng.integers(0, 128, (b, h, w, c)).astype(np.int8),
    }


def _t(d, k):
    v = torch.from_numpy(np.ascontiguousarray(d[k]))
    return v.to(torch.bfloat16) if k in ("x", "y") else v


def _wk(d, kh):
    return k8.pack_weights(torch.from_numpy(d["w"]).reshape(kh, kh, *d["w"].shape[1:]))


def _j(d, k):
    return jnp.asarray(d[k], jnp.bfloat16) if k in ("x", "y") else jnp.asarray(d[k])


def _same_sums(ours, ref):
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-5, atol=1e-3)


def test_pack_weights_2x2_tap_order():
    """The port's [kh·kw, C/4, CO] words hold tap (dy, dx) at dy·kw + dx:
    the JAX sites' ``q["w"].reshape(4, C, CO)`` order."""
    w = np.random.default_rng(0).integers(-127, 128, (2, 2, 64, 128)).astype(np.int8)
    wk = k8.pack_weights(torch.from_numpy(w))
    assert tuple(wk.shape) == (4, 16, 128)
    flat = w.reshape(4, 64, 128)
    for t in range(4):
        for k in range(16):
            word = wk[t, k].numpy().view(np.int8).reshape(128, 4)
            assert np.array_equal(word, flat[t, 4 * k:4 * k + 4].T)
    assert np.array_equal(k8.unpack_weights(wk, 2, 2).numpy().reshape(4, 64, 128), flat)


# (C, CO, pt, W, sw): conv2's form at 128 -> 64 on an aligned grid, the k3
# deconv form at 64 -> 128 (NST d2) with and without the sw mask
K4_2X2 = [(128, 64, 1, 16, None), (64, 128, 0, 24, 21)]


@pytest.mark.parametrize("c,co,pt,w,sw", K4_2X2)
def test_k4_2x2_matches_pallas(c, co, pt, w, sw):
    d = _inputs(30 + pt, 1, 8, w, c, co, 4)
    if sw is not None:
        d["x"][:, :, sw:] = 7.0  # the padding columns hold junk the mask hides
    ry, rs = _interpret(si8.res_site, _j(d, "x"), _j(d, "a"), _j(d, "c"), _j(d, "w"),
                        _j(d, "ws"), _j(d, "bias"), -127.0, halo="zero", kh=2, kw=2, pt=pt,
                        pl_=pt, sw=sw)
    oy, os_ = k8.res_site(_t(d, "x"), _t(d, "a"), _t(d, "c"), -127.0, _wk(d, 2), _t(d, "ws"),
                          _t(d, "bias"), halo="zero", kh=2, kw=2, pt=pt, pl_=pt, sw=sw)
    assert oy.dtype == torch.bfloat16 and tuple(oy.shape) == (1, 8, w, co)
    assert np.array_equal(oy.float().numpy(), ry.astype(np.float32))
    _same_sums(os_, rs)


def test_k4_sw_matches_pallas():
    """K4's 3×3 zero-halo site with sw (the NST res chain's b-sites, floor
    0, on the 1080p grid's 500 → 504 at a small size)."""
    lo = 0.0
    d = _inputs(40, 2, 8, 24, 128, 128, 9)
    d["x"][:, :, 21:] = -5.0
    ry, rs = _interpret(si8.res_site, _j(d, "x"), _j(d, "a"), _j(d, "c"), _j(d, "w"),
                        _j(d, "ws"), _j(d, "bias"), lo, halo="zero", sw=21)
    oy, os_ = k8.res_site(_t(d, "x"), _t(d, "a"), _t(d, "c"), lo, _wk(d, 3), _t(d, "ws"),
                          _t(d, "bias"), halo="zero", sw=21)
    assert np.array_equal(oy.float().numpy(), ry.astype(np.float32))
    _same_sums(os_, rs)


@pytest.mark.parametrize("c,w,sw", [(128, 24, 21)])
def test_k5_sw_matches_pallas(c, w, sw):
    """K5 with sw: v is written in every column (the next block's residual),
    its codes beyond sw are zero, the sums leave those columns out."""
    d = _inputs(50, 2, 8, w, c, c, 9)
    ry, rs, rv = _interpret(si8.res_site_skip, _j(d, "x"), _j(d, "y"), _j(d, "a"), _j(d, "c"),
                            _j(d, "a2"), _j(d, "c2"), _j(d, "w"), _j(d, "ws"), _j(d, "bias"),
                            -127.0, halo="zero", sw=sw)
    oy, os_, ov = k8.res_site_skip(_t(d, "x"), _t(d, "y"), _t(d, "a"), _t(d, "c"), _t(d, "a2"),
                                   _t(d, "c2"), -127.0, _wk(d, 3), _t(d, "ws"), _t(d, "bias"),
                                   halo="zero", sw=sw)
    assert np.array_equal(oy.float().numpy(), ry.astype(np.float32))
    assert np.array_equal(ov.float().numpy(), rv.astype(np.float32))
    _same_sums(os_, rs)


@pytest.mark.parametrize("w,sw", [(24, 21)])
def test_k3_2x2_bf16_matches_pallas(w, sw):
    """K3's 2×2 pad-0 form with a bf16 raw out (NST dec_s8's d2)."""
    d = _inputs(60, 1, 8, w, 64, 128, 4)
    if sw is not None:
        d["codes"][:, :, sw:] = 0
    carry = jnp.pad(jnp.asarray(d["codes"]), ((0, 0), (0, 0), (1, si8._wps(w) - w - 1), (0, 0)))
    ref = _interpret(si8.site_s8, carry, _j(d, "w"), _j(d, "ws"), _j(d, "bias"), w0=w, kh=2,
                     kw=2, pt=0, pl_=0, halo="zero", sw=sw)
    ours = k8.site_s8(_t(d, "codes"), _wk(d, 2), _t(d, "ws"), _t(d, "bias"), halo="zero",
                      sw=sw, kh=2, kw=2, pt=0, pl_=0)
    assert np.array_equal(ours.float().numpy(), ref.astype(np.float32))


def test_k3_2x2_zero2_emit_feeds_k6():
    """K3's 2×2 pad-0 form emitting deconv3's codes (``halo_out="zero2"``,
    floor 0, zero beyond sw), then K6 on them: both bit-exact against the
    Pallas pair (NST tail_s8)."""
    w, sw = 24, 21
    d = _inputs(70, 1, 8, w, 64, 128, 4)
    d["codes"][:, :, sw:] = 0
    carry = jnp.pad(jnp.asarray(d["codes"]), ((0, 0), (0, 0), (1, si8._wps(w) - w - 1), (0, 0)))
    qa, qc = d["qa"] / 8, d["qc"]
    rq = _interpret(si8.site_s8, carry, _j(d, "w"), _j(d, "ws"), _j(d, "bias"), w0=w, kh=2,
                    kw=2, pt=0, pl_=0, qa=jnp.asarray(qa), qc=jnp.asarray(qc), qlo=0.0,
                    halo_out="zero2", sw=sw)
    oq = k8.site_s8(_t(d, "codes"), _wk(d, 2), _t(d, "ws"), _t(d, "bias"),
                    qa=torch.from_numpy(qa), qc=torch.from_numpy(qc), qlo=0.0, halo="zero",
                    sw=sw, kh=2, kw=2, pt=0, pl_=0, halo_out="zero2")
    assert oq.dtype == torch.int8 and np.array_equal(oq.numpy(), rq[:, :, 2:w + 2])
    assert not oq[:, :, sw:].any() and oq[:, :, :sw].any()
    rng = np.random.default_rng(71)
    w5 = rng.integers(-127, 128, (5, 128, 60)).astype(np.int8)
    ws5 = (2.0 ** rng.integers(-19, -16, 60)).astype(np.float32)
    b12 = _bf(rng.normal(0, 0.2, 12))
    ry = _interpret(si8.d3_s8_site, jnp.asarray(rq), jnp.asarray(w5), jnp.asarray(ws5),
                    jnp.asarray(b12), w0=w)
    oy = k8.d3_s8_site(oq, k8.pack_weights(torch.from_numpy(w5)[None], co_pad=k8.CO_TILE),
                       torch.nn.functional.pad(torch.from_numpy(ws5), (0, 4)),
                       torch.from_numpy(b12))
    assert np.array_equal(oy.float().numpy(), ry.astype(np.float32))


def test_geometries_and_layouts_outside_the_forms_raise():
    """The 2×2 taps exist for K4 (pads 1 and 0) and K3 (pad 0) under the
    zero halo only; K5 is 3×3; ``zero2`` names the zero-halo s8 emit."""
    d = _inputs(80, 1, 8, 16, 64, 128, 4)
    x4 = (_t(d, "x"), _t(d, "a"), _t(d, "c"), -127.0, _wk(d, 2), _t(d, "ws"), _t(d, "bias"))
    with pytest.raises(NotImplementedError, match="Queue 2"):
        k8.res_site(*x4, halo="edge", kh=2, kw=2, pt=0, pl_=0)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        k8.res_site(*x4, halo="zero", kh=2, kw=2, pt=1, pl_=0)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        k8.site_s8(_t(d, "codes"), *x4[4:], halo="zero", kh=2, kw=2, pt=1, pl_=1)
    d3 = _inputs(81, 1, 8, 16, 64, 64, 4)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        k8.res_site_skip(_t(d3, "x"), _t(d3, "y"), _t(d3, "a"), _t(d3, "c"), _t(d3, "a2"),
                         _t(d3, "c2"), -127.0, _wk(d3, 2), _t(d3, "ws"), _t(d3, "bias"),
                         halo="zero", kh=2, kw=2, pt=0, pl_=0)
    with pytest.raises(ValueError, match="zero2"):
        k8.site_s8(_t(d, "codes"), *x4[4:], halo="zero", kh=2, kw=2, pt=0, pl_=0,
                   halo_out="zero2")
    with pytest.raises(ValueError, match="zero halo"):
        k8.res_site(*x4[:4], k8.pack_weights(torch.zeros((3, 3, 64, 128), dtype=torch.int8)),
                    *x4[5:], halo="reflect", sw=13)


# ---------------------------------------------------------------------------
# the forward under each name, against the JAX forward
# ---------------------------------------------------------------------------


def _bf16(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                        if hasattr(a, "astype") and a.dtype == jnp.float32 else a, tree)


def _jnp(stats):
    return {k: tuple(jnp.asarray(t.numpy()) for t in v) for k, v in stats.items()}


@pytest.fixture(scope="module")
def ctx():
    """The JAX package's random NST weights (``transformer_net_nst.init``
    with key 3, as tests/test_torch_nst.py and the JAX tests take them) in
    both packages, one frame of
    1 × 16 × 32 (padded by 40: conv2's block grid 48 × 56, the res grid
    24 × 28, non-%8 as 1080p's 292 × 500), the port's frozen norms and
    activation scales (shared: both packages quantize from the same
    scales), the JAX ``quant`` and the port's sites made from it, and the
    JAX bf16 forward's tapped inputs of the res chain and the decoder."""
    tree = jax.tree.map(np.asarray, jax.jit(jn.init)(jax.random.key(3)))
    net = tn.TransformerNetNST()
    net.load_state_dict(tn.params_from_jax(tree))
    net = net.eval().requires_grad_(False)
    nb = copy.deepcopy(net).to(torch.bfloat16)
    fp = jf.from_nst_params(tree)
    x = np.random.default_rng(5).random((1, 16, 32, 3)).astype(np.float32)
    stats = tf.calibrate_in_stats(net, torch.from_numpy(x))
    scales = tf.calibrate_act_scales(net, torch.from_numpy(x))
    quant = jf.quantize_net(fp, scales)
    tquant = {k: {"w": torch.from_numpy(np.asarray(v["w"]).copy()),
                  "ws": torch.from_numpy(np.asarray(v["ws"]).copy()),
                  "qin": float(v["qin"])} for k, v in quant.items()}
    pb = _bf16(fp)
    xb = jnp.asarray(x, jnp.bfloat16)
    taps = {}
    jf.apply(pb, xb, tap=lambda k, t: taps.setdefault(k, t))
    mag = float(np.abs(np.asarray(jf.apply(fp, jnp.asarray(x)))).mean())
    return {"net": net, "nb": nb, "pb": pb, "x": x, "xb": xb, "stats": stats, "mag": mag,
            "jstats": _jnp(stats), "quant": quant, "tquant": tquant, "taps": taps,
            "sites": tf.prepare_sites(nb, tquant, torch.device("cpu"))}


def _spy(monkeypatch):
    """Count the site wrappers' calls from the NST forward (each is a
    kernel launch on the card), by form."""
    calls = {}

    def wrap(name, fn):
        def spy(*a, **kw):
            form = name
            if kw.get("kh", 3) == 2:
                form += f"_k2p{kw['pt']}"
            elif kw.get("sw") is not None and name in ("res_site", "res_site_skip"):
                form += "_sw"
            calls[form] = calls.get(form, 0) + 1
            return fn(*a, **kw)
        return spy

    for name in ("res_site", "res_site_skip", "res_site_s8o", "site_s8", "d3_s8_site"):
        monkeypatch.setattr(tf.k8, name, wrap(name, getattr(k8, name)))
    return calls


def _clip(y):
    return np.clip(np.asarray(y, np.float32), 0.0, 1.0)


# name → (the port's fused set, frozen norms, the JAX forward's set and
# whether its Pallas sites run in interpret mode, the site launches)
NAMES = {
    "res_i8": (("res_i8",), False, ((), False), {"res_site_sw": 6, "res_site_skip_sw": 4}),
    "res_i8 frozen": (("res_i8",), True, ((), False),
                      {"res_site_sw": 6, "res_site_skip_sw": 4}),
    "c2_i8": (("c2_i8",), False, (("c2_i8",), True), {"res_site_k2p1": 1}),
    "dec_i8": (("dec_i8",), False, (("dec_xla_i8",), False), {"res_site_k2p0": 2}),
    "dec_s8": (("res_i8", "res_s8", "dec_s8"), True, (("dec_xla_i8",), False),
               {"res_site_s8o": 5, "site_s8": 5, "site_s8_k2p0": 2}),
    "tail_s8": (("res_i8", "res_s8", "dec_s8", "tail_s8"), True,
                (("dec_xla_i8", "tail_xla_i8"), False),
                {"res_site_s8o": 5, "site_s8": 5, "site_s8_k2p0": 2, "d3_s8_site": 1}),
    "dec_xla_i8": (("dec_xla_i8",), False, (("dec_xla_i8",), False), {}),
    "tail_xla_i8": (("dec_xla_i8", "tail_xla_i8"), False, (("dec_xla_i8", "tail_xla_i8"), False),
                    {}),
}


@pytest.mark.parametrize("name", list(NAMES))
def test_apply_matches_jax(ctx, monkeypatch, name):
    """The port's bf16 forward under ``name`` against the JAX forward under
    the same name (its Pallas site in interpret mode for ``c2_i8``) or, for
    the names whose JAX chains run several Pallas sites, its XLA int8
    reference of that branch, within tests/test_int8.py's bound for the
    int8 res chain (mean < 5% of the exact output's mean magnitude): the two
    forwards' heads and output convs round in other orders (the pixel convs
    here, the block convs there), and the random net amplifies each code
    that flips (measured 2.2–2.9e-2 with measured norms, 1.7e-3 with frozen
ones, 0 for ``tail_s8``, against the bound 3.2e-2). Each
    runs exactly the sites the JAX branch launches. The chains themselves
    are compared on shared inputs below."""
    ours_set, frozen, (jset, interp), launches = NAMES[name]
    calls = _spy(monkeypatch)
    st = ctx["stats"] if frozen else None
    out = tf.apply(ctx["nb"], torch.from_numpy(ctx["x"]).to(torch.bfloat16), sites=ctx["sites"],
                   fused_sites=ours_set, static_stats=st)
    run = _interpret if interp else (lambda f, *a, **kw: np.asarray(f(*a, **kw)))
    ref = run(jf.apply, ctx["pb"], ctx["xb"], quant=ctx["quant"], fused_sites=jset,
              static_stats=ctx["jstats"] if frozen else None)
    assert tuple(out.shape) == ref.shape == (1, 16, 32, 3)
    assert np.abs(out.float().numpy() - ref.astype(np.float32)).mean() < 0.05 * ctx["mag"]
    assert calls == launches


def test_res_chains_match_the_xla_reference(ctx):
    """On the JAX forward's own res input (1 × 24 × 28 × 128, sw 28 on the
    padded 32): the K4/K5 chain with frozen norms, and the s8 chain
    through deconv1/deconv2 and the fused tail, against the JAX XLA int8
    references (``_res_quant_xla``, ``_dec_quant_xla``) within the JAX
    tests' bounds (tests/test_static_norm.py: mean < 1e-5 for the res
    chain, < 1e-3 through the decoder; the tail's mean < 1e-4 on its bf16
    scale); with measured norms, within tests/test_int8.py's 5% of the
    output's mean magnitude; and K4's dec_i8 on the JAX forward's decoder
    input against ``_dec_quant_xla`` within tests/test_int8.py's
    0.01 · max(|ref|, 0.1)."""
    y = ctx["taps"]["r1a"]
    yt = torch.from_numpy(np.array(y.astype(jnp.float32))).to(torch.bfloat16)
    nb, sites, stats = ctx["nb"], ctx["sites"], ctx["stats"]
    for st, jst, bound in ((None, None, None), (stats, ctx["jstats"], 1e-5)):
        ref = np.asarray(jf._res_quant_xla(y, ctx["pb"], ctx["quant"], jst), np.float32)
        ours = tf.res_chain_i8(yt, nb, sites, st).float().numpy()
        d = np.abs(ours - ref).mean()
        assert d <= (bound if bound is not None else 0.05 * np.abs(ref).mean()), d
    yr = jf._res_quant_xla(y, ctx["pb"], ctx["quant"], ctx["jstats"])
    xq = tf.res_chain_s8_static(yt, nb, sites, stats, emit_qo=sites["d1"].qin)
    assert xq.dtype == torch.int8 and tuple(xq.shape) == (1, 24, 32, 128)
    for tail, bound in ((False, 1e-3), (True, 1e-4)):
        ref = np.asarray(jf._dec_quant_xla(yr, ctx["pb"], ctx["quant"], ctx["jstats"],
                                           tail=tail), np.float32)
        ours = tf.dec_s8_static(xq, nb, sites, stats, 28, torch.bfloat16, tail=tail)
        assert ours.shape == ref.shape
        assert np.abs(ours.float().numpy() - ref).mean() <= bound
    yd = ctx["taps"]["d1"]
    ref = np.asarray(jf._dec_quant_xla(yd, ctx["pb"], ctx["quant"]), np.float32)
    ours = tf.dec_i8(torch.from_numpy(np.array(yd.astype(jnp.float32))).to(torch.bfloat16),
                     nb, sites).float().numpy()
    assert np.abs(ours - ref).mean() < 0.01 * max(np.abs(ref).mean(), 0.1)


@pytest.mark.parametrize("quantize,base", [("int8", "none"), ("int8_static", "bf16_static")])
def test_defaults_without_the_adoption_file(ctx, tmp_path, monkeypatch, quantize, base):
    """With no ``i8_adopt.json`` the engine takes ``adopt_overrides.DEFAULTS``:
    both int8 modes route ``res_i8`` (measured or frozen norms: 6 × K4 +
    4 × K5 with sw) and stylize within the repo's 1e-2 gate of their bf16
    base (measured 6.3e-3 and 6.4e-3, as the adopted sets measure on this
    net in tests/test_torch_nst.py)."""
    monkeypatch.setattr(adopt_overrides, "PATH", tmp_path / "absent.json")
    path = tmp_path / "nst.pth"
    torch.save(ctx["net"].state_dict(), path)
    model = tst.load_model(path)
    x = torch.from_numpy(np.random.default_rng(10).random((2, 48, 64, 3)).astype(np.float32))
    ref = tst.jit_stylizer(model, dtype=torch.bfloat16, quantize=base)(x)
    calls = _spy(monkeypatch)
    out = tst.jit_stylizer(model, dtype=torch.bfloat16, quantize=quantize)(x)
    assert calls == {"res_site_sw": 6, "res_site_skip_sw": 4}
    assert (out - ref).abs().mean() <= 1e-2
