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
1 bf16 ulp. The chains that carry the f32 tensor further are
tests/test_torch_f32_chains.py's; the whole forwards under f32 params, set
by set, tests/test_torch_f32_sets_*.py's (the nets, frames and the map are
tests/torch_f32_nets.py's); the kernels run on the card
(``tests/test_torch_f32_forms_card.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_f32_nets import interpret as _interpret
from torch_f32_nets import one_thread  # noqa: F401

from neuralstyletransferv1_tpu.models import s2d2_sites as sj
from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_tpu.models import transformer_net_s2d as s2dj
from neuralstyletransferv1_tpu.models import transformer_net_s2d2 as s2d2
from neuralstyletransferv1_torch.kernels import bf16_sites as k9
from neuralstyletransferv1_torch.kernels import int8_sites as k8

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
