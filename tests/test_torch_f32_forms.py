"""The float32 forms that the JAX package runs, in the PyTorch port against
the JAX package on the CPU.

Under f32 params the JAX forwards hand an f32 tensor to more sites than the
res chain's first: conv2's (K8a, Johnson's ``head_i8``; K4's 2×2 pad-1 form,
the NST_Train and Torch7 ``c2_i8``), deconv1's (K4's 2×2 pad-0 form, their
``dec_i8``; K2 at C = 192 → CO = 384, ReCoNet's ``dec_s8``), and deconv2's
and deconv3's bf16 sites (K9a, ``tail``; K9e, ``d3``). The Pallas bodies
read it unrounded, ``v.astype(float32)·a + c``. Here each form's plain
version meets the interpret-mode Pallas function on the same f32 operand:
bit for bit at power-of-two scales, where every product is exact and an FMA
that interpret mode contracts rounds as the separate operations do, on
≥ 99.9% of the codes and bf16 values at random scales, K9a and K9e within
1 bf16 ulp. Then the chains that carry the f32 tensor further: Johnson's
head chain of ``head_i8`` (K8a on conv1's f32 output, K8b) against the JAX
``head_chain``, and ReCoNet's s8 res and decoder chains, whose every block
keeps y's dtype in the JAX package, against the JAX chains. The whole
forwards under f32 params, set by set, are
tests/test_torch_f32_sets_johnson.py's and tests/test_torch_f32_sets_nets.py's
(the nets, frames and the map are tests/torch_f32_nets.py's); the kernels
run on the card (``tests/test_torch_f32_forms_card.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_f32_nets import interpret as _interpret
from torch_f32_nets import johnson_nets, one_thread, reco_nets, scene  # noqa: F401

from neuralstyletransferv1_tpu.models import reconet_fast as jrf
from neuralstyletransferv1_tpu.models import s2d2_sites as sj
from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_tpu.models import transformer_net_s2d as s2dj
from neuralstyletransferv1_tpu.models import transformer_net_s2d2 as s2d2
from neuralstyletransferv1_torch.kernels import bf16_sites as k9
from neuralstyletransferv1_torch.kernels import int8_sites as k8
from neuralstyletransferv1_torch.models import reconet_fast as trf
from neuralstyletransferv1_torch.models import sites_i8
from neuralstyletransferv1_torch.models import transformer_net_quant as tq
from neuralstyletransferv1_torch.models.transformer_net import quant_from_jax

CPU = torch.device("cpu")


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _operands(seed, b, h, w, c, co, taps, pow2):
    """Site operands; x f32, not bf16-representable. ``pow2``: the scales
    that multiply an operand (a, ws, qa) are powers of two."""
    rng = np.random.default_rng(seed)

    def scale(lo, hi, shape):
        v = rng.uniform(lo, hi, shape)
        return np.asarray(2.0 ** np.round(np.log2(v)) if pow2 else v, np.float32)

    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"x": f32(rng.normal(0, 2, (b, h, w, c))), "a": scale(5, 40, (b, c)),
            "c": f32(rng.normal(0, 8, (b, c))),
            "w": rng.integers(-127, 128, (taps, c, co)).astype(np.int8),
            "ws": scale(0.5 / (127 * 127 * 9 * c / 32), 2 / (127 * 127 * 9 * c / 32), co),
            "bias": f32(rng.normal(0, 0.2, co)), "qa": scale(10, 60, co),
            "qc": f32(rng.normal(0, 10, co)), "tau": f32(rng.normal(-20, 20, co))}


def _same(ours: np.ndarray, ref: np.ndarray, pow2: bool):
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    share = (ours == ref).mean()
    assert share == 1.0 if pow2 else share >= 0.999, share


def _sums(sums: torch.Tensor, sout, n: int):
    got, want = sums.numpy().astype(np.float64), np.asarray(sout, np.float64)
    s2 = np.abs(want[:, 1])
    assert np.all(np.abs(got[:, 1] - want[:, 1]) <= 1e-5 * s2)
    assert np.all(np.abs(got[:, 0] - want[:, 0]) <= 1e-5 * np.sqrt(n * s2))


def _t(d, k):
    return torch.from_numpy(np.ascontiguousarray(d[k]))


# ---------------------------------------------------------------------------
# the forms: plain versions vs the interpret-mode Pallas functions
# ---------------------------------------------------------------------------


# (pt, CO, W, sw): conv2's block form (pad 1) and the k3 deconv's (pad 0),
# the latter with the content width of a grid padded to %8
@pytest.mark.parametrize("pt,co,w,sw", [(1, 64, 16, None), (0, 64, 24, 21)], ids=["p1", "p0"])
@pytest.mark.parametrize("pow2", [True, False], ids=["pow2", "random"])
def test_k4_2x2_f32_x_matches_pallas(pt, co, w, sw, pow2):
    d = _operands(10 + pt, 1, 8, w, 128, co, 4, pow2)
    ry, rs = _interpret(si8.res_site, jnp.asarray(d["x"]), jnp.asarray(d["a"]),
                        jnp.asarray(d["c"]), jnp.asarray(d["w"]), jnp.asarray(d["ws"]),
                        jnp.asarray(d["bias"]), -127.0, halo="zero", kh=2, kw=2, pt=pt,
                        pl_=pt, sw=sw)
    wk = k8.pack_weights(_t(d, "w").reshape(2, 2, 128, co))
    oy, os_ = k8.res_site(_t(d, "x"), _t(d, "a"), _t(d, "c"), -127.0, wk, _t(d, "ws"),
                          _t(d, "bias"), halo="zero", kh=2, kw=2, pt=pt, pl_=pt, sw=sw)
    assert oy.dtype == torch.bfloat16
    _same(oy.float().numpy(), _f32(ry), pow2)
    if pow2:
        _sums(os_, rs, 8 * (sw or w))
    rounded = k8.res_site(_t(d, "x").to(torch.bfloat16), _t(d, "a"), _t(d, "c"), -127.0, wk,
                          _t(d, "ws"), _t(d, "bias"), halo="zero", kh=2, kw=2, pt=pt, pl_=pt,
                          sw=sw)[0]
    assert not torch.equal(rounded, oy)  # the f32 x is not its bf16 rounding


@pytest.mark.parametrize("frn,pow2", [(False, True), (True, True), (False, False)],
                         ids=["in-pow2", "frn-pow2", "in-random"])
def test_k2_co384_f32_x_matches_pallas(frn, pow2):
    """K2 at C = 192 → CO = 384 under the edge halo (ReCoNet's static-norm
    d1 on the f32 res output): the IN emit (floor 0) and the FRN emit (the
    (CO,) floor row, floor −127)."""
    d = _operands(20 + frn, 1, 8, 16, 192, 384, 9, pow2)
    qlo, tau = (-127.0, d["tau"]) if frn else (0.0, None)
    j = jnp.asarray
    ref = _interpret(si8.res_site_s8o, j(d["x"]), j(d["a"]), j(d["c"]), j(d["w"]), j(d["ws"]),
                     j(d["bias"]), qa=j(d["qa"]), qc=j(d["qc"]), tau=None if tau is None
                     else j(tau), lo=-127.0, qlo=qlo, halo="edge")
    ours = k8.res_site_s8o(_t(d, "x"), _t(d, "a"), _t(d, "c"), -127.0,
                           k8.pack_weights(_t(d, "w").reshape(3, 3, 192, 384)), _t(d, "ws"),
                           _t(d, "bias"), _t(d, "qa"), _t(d, "qc"), qlo=qlo,
                           tau=None if tau is None else torch.from_numpy(tau), halo="edge")
    assert ours.dtype == torch.int8 and tuple(ours.shape) == (1, 8, 16, 384)
    _same(ours.numpy(), ref[:, :, 1:17], pow2)
    assert bool((ours < 0).any()) == frn


@pytest.mark.parametrize("pow2", [True, False], ids=["pow2", "random"])
def test_k8a_f32_x_matches_pallas(pow2):
    """K8a on conv1's f32 output (Johnson's ``head_i8`` under float32)
    against ``c2p_site`` on the column-pair view of its space-to-depth form,
    floor 0."""
    b, h, w = 1, 20, 36
    d = _operands(30, b, h, w, 32, 64, 9, pow2)
    w33 = d["w"].reshape(3, 3, 32, 64)
    wblk = s2dj._scatter_stride2_s2d2(w33.astype(np.float32)).astype(np.int8)
    yp = np.asarray(s2dj.s2d(jnp.asarray(d["x"]), 2)).reshape(b, h // 2, w // 4, 256)
    ref, sout = _interpret(si8.c2p_site, jnp.asarray(yp), jnp.tile(jnp.asarray(d["a"]), (1, 8)),
                           jnp.tile(jnp.asarray(d["c"]), (1, 8)), si8._pair_c2_weights(wblk),
                           jnp.tile(jnp.asarray(d["ws"]), 2), jnp.tile(jnp.asarray(d["bias"]), 2))
    ours, sums = k8.c2_site(_t(d, "x"), _t(d, "a"), _t(d, "c"), 0.0,
                            k8.pack_weights(torch.from_numpy(w33)), _t(d, "ws"), _t(d, "bias"))
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (b, h // 2, w // 2, 64)
    _same(ours.float().numpy(), _f32(ref).reshape(b, h // 2, w // 2, 64), pow2)
    if pow2:
        _sums(sums, np.asarray(sout, np.float64).reshape(b, 2, 2, 64).sum(axis=2),
              (h // 2) * (w // 2))


# (wrapper, form, C, halo) → the name the f32 form counts under, or None
# where no such form was built: the gates admit exactly the built forms
F32_GATES = [("res_site", "k2p1", 128, "zero", "res_site_k2p1_f32"),
             ("res_site", "k2p0", 128, "zero", "res_site_k2p0_f32"),
             ("res_site", "k2p1", 64, "zero", None),
             ("res_site", "k2p0", 128, "reflect", None),
             ("res_site_s8o", "co384", 192, "edge", "res_site_s8o_co384_f32"),
             ("res_site_s8o", "co384", 192, "zero", None),
             ("c2_site", "3x3", 32, "reflect", "c2_site_f32"),
             ("c2_site", "3x3", 64, "reflect", None),
             ("site_s8", "k2p0", 128, "zero", None)]


@pytest.mark.parametrize("kernel,form,c,halo,name", F32_GATES,
                         ids=[f"{k}-{f}-{c}-{h}" for k, f, c, h, _ in F32_GATES])
def test_f32_gates_admit_the_built_forms(kernel, form, c, halo, name):
    """The int8 wrappers' f32 gate (``int8_sites._f32_form``, which picks
    the form a CUDA tensor launches) admits K4's 2×2 forms at C = 128
    under the zero halo, K2's CO = 384 form under the edge halo and K8a's
    at C = 32, each counted under its own name, and refuses every other
    width, halo and form (K8b and K3's 2×2 forms have none); a bf16
    operand takes the bf16 form."""
    x = torch.zeros((1, 4, 8, c))
    assert k8._f32_form(kernel, x.to(torch.bfloat16), halo, form=form) is None
    if name is None:
        with pytest.raises(ValueError, match=f"no f32 form at C={c} with the {halo} halo"):
            k8._f32_form(kernel, x, halo, form=form)
    else:
        assert k8._f32_form(kernel, x, halo, form=form) == {"name": name,
                                                            "counts": k8.F32_LAUNCHES}


@pytest.mark.parametrize("kernel,prev,name", [("d2_site", False, "d2_site_f32"),
                                              ("d3_rows", False, "d3_rows_f32"),
                                              ("d2_site", True, None),
                                              ("c2_site_bf16", False, None)])
def test_bf16_f32_gates_admit_the_built_forms(kernel, prev, name):
    """The bf16 sites' f32 gate: K9a and K9e have an f32-raw form on their
    current cores, counted under its own name; their previous cores and
    K9c have none."""
    x = torch.zeros((1, 4, 8, 64))
    assert k9._f32_form(kernel, x.to(torch.bfloat16), prev) is None
    if name is None:
        with pytest.raises(TypeError, match="no form with an f32 x"):
            k9._f32_form(kernel, x, prev)
    else:
        assert k9._f32_form(kernel, x, prev) == name


def _bf16_operands(seed, shape, taps_shape):
    rng = np.random.default_rng(seed)
    b, c = shape[0], shape[3]
    bf = lambda a: _f32(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    return {"x": np.asarray(rng.normal(0, 1.5, shape), np.float32),
            "a": np.asarray(rng.uniform(0.5, 1.5, (b, c)), np.float32),
            "c": np.asarray(rng.normal(0, 0.3, (b, c)), np.float32),
            "w": bf(rng.normal(0, 0.05, taps_shape)), "bias": bf(rng.normal(0, 0.2, 128))}


def test_k9a_f32_raw_matches_pallas():
    """K9a on deconv1's f32 raw (the ``tail`` under float32) against
    ``_d2_site`` on its edge-padded buffer of the same f32 raw: the bf16
    outputs within 1 ulp, the sums within 1e-4."""
    h2, w2 = 20, 32
    d = _bf16_operands(40, (2, h2, w2, 64), (3, 3, 64, 128))
    ho, hbuf, wp = sj._tail_geom(h2, w2)
    xin = s2dj._pad_edge_blocks(jnp.asarray(d["x"]))
    x4 = jnp.pad(xin, ((0, 0), (2, hbuf - h2 - 2), (2, wp - w2 - 4), (0, 0)))
    y5, sout = _interpret(sj._d2_site, x4, jnp.asarray(d["a"]), jnp.asarray(d["c"]),
                          jnp.asarray(d["w"], jnp.bfloat16).reshape(9, 64, 128),
                          jnp.asarray(d["bias"])[None, :], h2=h2, w2=w2, hbuf=hbuf, wp=wp)
    ours, sums = k9.d2_site(_t(d, "x"), _t(d, "a"), _t(d, "c"),
                            k9.pack_site_weights(_t(d, "w")), _t(d, "bias"))
    assert ours.dtype == torch.bfloat16
    worst, equal = k9.bf16_ulp_error(ours, torch.from_numpy(_f32(y5)[:, 2:2 + h2, 2:2 + w2]))
    assert worst <= 1.0 and equal >= 0.99, (worst, equal)
    got, want = sums.numpy().astype(np.float64), np.asarray(sout, np.float64)
    assert np.all(np.abs(got[:, 1] - want[:, 1]) <= 1e-4 * np.abs(want[:, 1]))
    rounded = k9.d2_site(_t(d, "x").to(torch.bfloat16), _t(d, "a"), _t(d, "c"),
                         k9.pack_site_weights(_t(d, "w")), _t(d, "bias"))[0]
    assert not torch.equal(rounded, ours)


def test_k9e_f32_raw_matches_pallas():
    """K9e on the f32 d2 raw (``d3`` under float32) against ``d3_rows`` on
    the same f32 raw: the 60 bf16 row lanes within 1 ulp."""
    d = _bf16_operands(41, (2, 20, 32, 128), (1, 5, 128, 60))
    ref = _interpret(sj.d3_rows, jnp.asarray(d["x"]), jnp.asarray(d["a"]), jnp.asarray(d["c"]),
                     jnp.asarray(d["w"], jnp.bfloat16),
                     pad_fn=lambda t: s2d2._pad_reflect_f2_4px(t, 32))
    ours = k9.d3_rows(_t(d, "x"), _t(d, "a"), _t(d, "c"), k9.pack_rows_weights(_t(d, "w")))
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (2, 24, 32, 60)
    worst, equal = k9.bf16_ulp_error(ours, torch.from_numpy(_f32(ref)))
    assert worst <= 1.0 and equal >= 0.99, (worst, equal)


# ---------------------------------------------------------------------------
# the chains that carry the f32 tensor past its first site
# ---------------------------------------------------------------------------


def test_johnson_f32_head_chain_matches_jax():
    """``head_i8`` under f32 params, the part the f32 operand reaches: K8a on
    conv1's f32 output (the in1 affine folded into its quantize), K8b on
    its bf16 output, frozen norms, against the JAX ``head_chain`` in
    interpret mode on the same f32 input: conv3's bf16 raw on >= 99.9% of
    its values (the f32 sums and the pair-packed dots order their additions
    otherwise). Everything after it reads that bf16 tensor as under
    bfloat16 (tests/test_torch_int8_headtail.py's set A); the whole
    forward against the JAX forward is tests/test_torch_f32_sets_johnson.py's."""
    h, w = 40, 64
    bp32, net = johnson_nets()
    x = torch.from_numpy(scene(h, w))
    st = tq.calibrate_in_stats(net, x)
    scales = tq.calibrate_act_scales(net, x, ("c2", "c3"), st)
    quant = s2d2.quantize_net(bp32, scales)
    jst = {k: tuple(jnp.asarray(t.numpy()) for t in v) for k, v in st.items()}
    q, _ = quant_from_jax(quant, jst)
    with torch.no_grad():
        y1 = net.conv1(x).contiguous()
        m1, inv1 = st["in1"]
        ours, m3, inv3 = sites_i8.head_chain(y1, m1, inv1, net, sites_i8.prepare_sites(net, q, CPU),
                                             st)
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (1, h // 4, w // 4, 128)
    y1j = s2dj.s2d(jnp.asarray(y1.numpy()), 2)
    ref, _, _ = _interpret(si8.head_chain, y1j, jnp.asarray(m1.numpy()),
                           jnp.asarray(inv1.numpy()), bp32, quant, static_stats=jst)
    assert (ours.float().numpy() == _f32(ref)).mean() >= 0.999


@pytest.mark.parametrize("frn", [False, True], ids=["in", "frn"])
def test_reco_s8_chains_carry_f32_as_jax(frn, monkeypatch):
    """ReCoNet's s8 chains on one f32 res input (frozen norms, the IN and
    the FRN net): the JAX ``_res_chain_s8_static`` keeps y's dtype, so
    every block's K2 and K3 read an f32 y, and ``_dec_s8_static``'s K2 at
    CO = 384 reads the chain's f32 output. The port's chains take those f32
    forms, spied (4 + 4, then 1; K3's C = 96 form reads codes), and return
    f32 within 1e-6 of the mean magnitude of the JAX chains in interpret mode
    (measured: 1e-9 and 6e-8; interpret mode contracts some acc·ws + bias
    into an FMA). Rounding the input to bf16, as a bf16 carry would, moves
    both outputs by 2-4% of that magnitude."""
    r = reco_nets(frn)
    y = np.maximum(np.random.default_rng(7).normal(0, 1.0, (1, 8, 16, 192)), 0)
    y = y.astype(np.float32)
    jy = _interpret(jrf._res_chain_s8_static, jnp.asarray(y), r["jfp"], r["quant"], frn,
                    r["jst"])
    jd = _interpret(jrf._dec_s8_static, jnp.asarray(jy), r["jfp"], r["quant"], frn, r["jst"],
                    jnp.float32)
    jd = trf.d2s(torch.from_numpy(jd), 2, 48).numpy()
    assert jy.dtype == jd.dtype == np.float32
    seen = []
    for name, pos in (("res_site_s8o", 0), ("site_s8", 6)):
        def spy(*a, _fn=getattr(k8, name), _name=name, _pos=pos, **kw):
            t = a[_pos] if len(a) > _pos else kw.get("y")
            seen.append((_name, None if t is None else t.dtype))
            return _fn(*a, **kw)

        monkeypatch.setattr(k8, name, spy)

    def chains(t):
        with torch.no_grad():
            ty = trf.res_chain_s8_static(t, r["fp"], r["sites"], r["st"])
            return ty, trf.dec_s8_static(ty, r["fp"], r["sites"], r["st"])

    oy, od = chains(torch.from_numpy(y))
    f32 = [(name, torch.float32) for name in ("res_site_s8o", "site_s8")]
    assert seen == f32 * 4 + [("res_site_s8o", torch.float32), ("site_s8", None)]
    assert oy.dtype == od.dtype == torch.float32
    for ours, ref in ((oy, jy), (od, jd)):
        assert np.abs(ours.numpy() - ref).mean() <= 1e-6 * np.abs(ref).mean()
    for ours, ref in zip(chains(torch.from_numpy(y).to(torch.bfloat16)), (jy, jd)):
        assert np.abs(ours.float().numpy() - ref).mean() >= 1e-2 * np.abs(ref).mean()
