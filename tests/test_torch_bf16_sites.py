"""The bf16 fused sites of the PyTorch port (``head``, ``tail``, ``d3``;
K9a–K9e) vs the JAX package, on the CPU.

The port runs on its kernels' plain versions; the JAX side runs the Pallas
kernels of ``models/s2d2_sites.py`` in interpret mode. Per kernel, then
``sites_bf16.head`` / ``.tail`` against ``s2d2_sites.head`` / ``.tail``, the
geometry gates, the whole forward under each set, the int8 sets that name a
bf16 site, and the int8 chains below the ``res_supported`` /
``dec_supported`` gates. The kernels themselves run only on the card:
``tests/test_torch_policy.py`` holds them against their plain versions there.

Tolerances. Both sides multiply bf16 values (exact in f32) and accumulate in
f32 in their own order, so bf16 outputs differ by isolated ulps: every element
within 1 bf16 ulp, an ulp taken at no less than 2^-8 of the tensor's largest
magnitude (the accumulation error does not shrink with the element), and at
least 99% of the elements equal. XLA may also contract the prologue's
x·a + c into an FMA on the CPU, which flips an activation by an ulp. Sums:
within 1e-4 relative (Σ² against itself, Σ against sqrt(n·Σ²)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_int8 import _video, calibrate_jax, johnson, xla_reference  # noqa: F401
from test_torch_int8_headtail import _jax_stylize, _port_stylize
from test_torch_int8_headtail import _spy_launches as _spy_k8

from neuralstyletransferv1_tpu.models import s2d2_sites as sj
from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_tpu.models import transformer_net_s2d as s2dj
from neuralstyletransferv1_tpu.models import transformer_net_s2d2 as s2d2
from neuralstyletransferv1_torch.kernels import bf16_sites as k9
from neuralstyletransferv1_torch.kernels import int8_sites as k8
from neuralstyletransferv1_torch.models import s2d as ts2d
from neuralstyletransferv1_torch.models import sites_bf16, sites_i8
from neuralstyletransferv1_torch.models import transformer_net_quant as tq
from neuralstyletransferv1_torch.models.transformer_net import quant_from_jax

B, H2, W2 = 2, 28, 32   # passes the head, tail and d3 gates


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this file: in the six-worker tier-1 run
    the workers share the cores, and a multi-threaded pool then waits at
    each op's barrier for threads other workers preempt."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _interpret_bf16_sites():
    sj._INTERPRET = True
    yield
    sj._INTERPRET = False


def _bf(a):
    """Round to bf16, back as f32 numpy."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(v, bf16=False):
    t = torch.from_numpy(np.array(v, np.float32))
    return t.to(torch.bfloat16) if bf16 else t


def _j(v):
    return jnp.asarray(v, jnp.bfloat16)


def assert_close_bf16(ours: torch.Tensor, ref, limit: float = 1.0, scale=None,
                      floor: float = 2.0 ** -8, share: float = 0.99):
    """Every element within ``limit`` bf16 ulp (``k9.bf16_ulp_error``: an ulp
    taken at no less than ``floor`` of the largest magnitude, or of ``scale``
    where given per element) and at least ``share`` of them equal."""
    r = torch.from_numpy(np.array(ref, np.float32))
    assert ours.shape == r.shape, (ours.shape, r.shape)
    scale = None if scale is None else torch.as_tensor(scale, dtype=torch.float32)
    worst, equal = k9.bf16_ulp_error(ours, r, floor=floor, scale=scale)
    assert worst <= limit and equal >= share, (worst, equal)


def assert_sums_close(sums: torch.Tensor, sout, n: int, tol: float = 1e-4):
    got, want = sums.numpy().astype(np.float64), np.asarray(sout, np.float64)
    s2 = np.abs(want[:, 1])
    assert np.all(np.abs(got[:, 1] - want[:, 1]) <= tol * s2)
    assert np.all(np.abs(got[:, 0] - want[:, 0]) <= tol * np.sqrt(n * s2))


def _site_operands(seed, c, co, h, w):
    rng = np.random.default_rng(seed)
    return {"x": _bf(rng.normal(0, 1.5, (B, h, w, c))),
            "a": np.asarray(rng.uniform(0.5, 1.5, (B, c)), np.float32),
            "c": np.asarray(rng.normal(0, 0.3, (B, c)), np.float32),
            "w": _bf(rng.normal(0, (9 * c) ** -0.5, (3, 3, c, co))),
            "bias": _bf(rng.normal(0, 0.2, co))}


def _rows_operands(seed):
    rng = np.random.default_rng(seed)
    return {"y": _bf(rng.normal(0, 1.5, (B, H2, W2, 128))),
            "a": np.tile(np.asarray(rng.uniform(0.5, 1.5, (B, 32)), np.float32), (1, 4)),
            "c": np.tile(np.asarray(rng.normal(0, 0.3, (B, 32)), np.float32), (1, 4)),
            "w": _bf(rng.normal(0, 640 ** -0.5, (1, 5, 128, 60))),
            "bias": _bf(rng.normal(0, 0.2, 12))}


# ---------------------------------------------------------------------------
# (a) per kernel: plain version vs interpret-mode Pallas
# ---------------------------------------------------------------------------


def test_k9a_d2_site_matches_pallas():
    """K9a on the dense [2,28,32,64] tensor (edge halo computed by the site)
    against ``_d2_site`` on its edge-padded, junk-aligned buffer: the interior
    of the TPU's halo buffer, the in5 sums over that interior, and the
    buffer's in-kernel reflect halo, which must be the 4-pixel reflect of the
    port's output (``s2d.pad_reflect_f2_4px``, the index map K9b/K9e read)."""
    d = _site_operands(31, 64, 128, H2, W2)
    ho, hbuf, wp = sj._tail_geom(H2, W2)
    xin = s2dj._pad_edge_blocks(_j(d["x"]))
    x4 = jnp.pad(xin, ((0, 0), (2, hbuf - H2 - 2), (2, wp - W2 - 4), (0, 0)))
    y5, sout = sj._d2_site(x4, jnp.asarray(d["a"]), jnp.asarray(d["c"]),
                           _j(d["w"]).reshape(9, 64, 128), jnp.asarray(d["bias"])[None, :],
                           h2=H2, w2=W2, hbuf=hbuf, wp=wp)
    before = dict(k9.LAUNCHES)
    ours, sums = k9.d2_site(_t(d["x"], True), _t(d["a"]), _t(d["c"]),
                            k9.pack_site_weights(_t(d["w"])), _t(d["bias"]))
    assert k9.LAUNCHES == before  # CPU tensors take the plain version
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (B, H2, W2, 128)
    y5 = np.asarray(y5.astype(jnp.float32))
    assert_close_bf16(ours, y5[:, 2:2 + H2, 2:2 + W2])
    assert_sums_close(sums, sout, H2 * W2)
    assert_close_bf16(ts2d.pad_reflect_f2_4px(ours, 32), y5[:, :H2 + 4, :W2 + 4])


def test_k9b_d3_sum_site_matches_pallas():
    """K9b on the raw d2 output [2,28,32,128] (reflect halo read through the
    index map) against ``_d3_sum_site`` on the halo buffer holding the same
    tensor reflect-padded: within 2 ulp of the largest of an element and its
    five bf16 row terms (each term may differ by an ulp of its own size)."""
    d = _rows_operands(32)
    ho, hbuf, wp = sj._tail_geom(H2, W2)
    yp = s2d2._pad_reflect_f2_4px(_j(d["y"]), 32)
    y5 = jnp.pad(yp, ((0, 0), (0, hbuf - H2 - 4), (0, wp - W2 - 4), (0, 0)))
    ref = sj._d3_sum_site(y5, jnp.asarray(d["a"]), jnp.asarray(d["c"]), _j(d["w"]),
                          jnp.asarray(d["bias"]), ho=ho, w2=W2, wp=wp)
    ref = np.asarray(ref[:, :H2, :, :12].astype(jnp.float32))
    w = k9.pack_rows_weights(_t(d["w"]))
    ours = k9.d3_sum_site(_t(d["y"], True), _t(d["a"]), _t(d["c"]), w, _t(d["bias"]))
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (B, H2, W2, 12)
    terms = k9.d3_sum_scale_plain(_t(d["y"], True), _t(d["a"]), _t(d["c"]), w)
    assert_close_bf16(ours, ref, limit=2.0, scale=terms)


def test_k9c_c2_site_matches_pallas():
    """K9c on conv1's raw output in pixels [2,56,64,32] against ``_c2_site`` on
    the space-to-depth tensor with the 2×2 block weights of the same taps,
    completed by ``_c2_fixup`` (the TPU kernel leaves row 0 and column 0 to
    that strip fixup). The in2 statistics: (mean, inv) within 2e-4 relative —
    the JAX ones mix f32 interior sums with the bf16-rounded strip values,
    and at 28×32 the strips are 6.6% of the positions (measured: 1.0e-4; at
    540×960 they are 0.3%)."""
    rng = np.random.default_rng(33)
    d = _site_operands(33, 32, 64, 2 * H2, 2 * W2)
    m1 = np.asarray(rng.normal(0, 0.3, (B, 32)), np.float32)
    inv1 = np.asarray(rng.uniform(0.5, 1.5, (B, 32)), np.float32)
    in1 = {"scale": jnp.asarray(_bf(rng.uniform(0.5, 1.5, 32))),
           "bias": jnp.asarray(_bf(rng.normal(0, 0.3, 32)))}
    a1 = jnp.asarray(inv1) * in1["scale"]
    c1 = in1["bias"] - jnp.asarray(m1) * jnp.asarray(inv1) * in1["scale"]
    raw1 = s2dj.s2d(_j(d["x"]), 2)                               # [2,28,32,128]
    wblk = jnp.asarray(s2dj._scatter_stride2_s2d2(d["w"]), jnp.bfloat16)
    ts2, _ = sj._head_geom(H2, W2)
    y2, sout = sj._c2_site(raw1, jnp.tile(a1, (1, 4)), jnp.tile(c1, (1, 4)),
                           wblk.reshape(4, 128, 64), jnp.asarray(d["bias"])[None, :], ts2=ts2)
    y2, m2, inv2 = sj._c2_fixup(y2, sout, raw1, jnp.asarray(m1), jnp.asarray(inv1), in1, wblk,
                                _j(d["bias"]))
    ours, sums = k9.c2_site_bf16(_t(d["x"], True), _t(np.asarray(a1)), _t(np.asarray(c1)),
                                 k9.pack_site_weights(_t(d["w"])), _t(d["bias"]))
    assert tuple(ours.shape) == (B, H2, W2, 64)
    assert_close_bf16(ours, y2.astype(jnp.float32))
    m, inv = sites_bf16._stats(sums, float(H2 * W2))
    np.testing.assert_allclose(inv.numpy(), np.asarray(inv2), rtol=2e-4)
    np.testing.assert_allclose(m.numpy(), np.asarray(m2), rtol=0, atol=2e-4 / np.asarray(inv2).min())


def test_k9d_c3_site_matches_pallas():
    """K9d on conv2's raw output in pixels [2,28,32,64] against ``_c3_site`` on
    its space-to-depth form with the stride-2 phase halo and the 2×2 block
    weights (K = 256) of the same taps."""
    d = _site_operands(34, 64, 128, H2, W2)
    _, ts3 = sj._head_geom(H2, W2)
    h4, w4 = H2 // 2, W2 // 2
    wp = ((w4 + 1 + 7) // 8) * 8
    x3 = s2dj._pad_stride2_halo(s2dj.s2d(_j(d["x"]), 2), 64)
    x3 = jnp.pad(x3, ((0, 0), (0, 0), (0, wp - (w4 + 1)), (0, 0)))
    wblk = jnp.asarray(s2dj._scatter_stride2_s2d2(d["w"]), jnp.bfloat16).reshape(4, 256, 128)
    ref, sout = sj._c3_site(x3, jnp.tile(jnp.asarray(d["a"]), (1, 4)),
                            jnp.tile(jnp.asarray(d["c"]), (1, 4)), wblk,
                            jnp.asarray(d["bias"])[None, :], ts3=ts3, h4=h4, w4dim=w4, wp=wp)
    ours, sums = k9.c3_site_bf16(_t(d["x"], True), _t(d["a"]), _t(d["c"]),
                                 k9.pack_site_weights(_t(d["w"])), _t(d["bias"]))
    assert tuple(ours.shape) == (B, h4, w4, 128)
    assert_close_bf16(ours, ref.astype(jnp.float32))
    assert_sums_close(sums, sout, h4 * w4)


def test_k9e_d3_rows_matches_pallas():
    """K9e against ``d3_rows`` (which pads with ``_pad_reflect_f2_4px``): the
    60 bf16 row lanes on the H2+4 rows of the padded grid."""
    d = _rows_operands(35)
    ref = sj.d3_rows(_j(d["y"]), jnp.asarray(d["a"]), jnp.asarray(d["c"]), _j(d["w"]),
                     pad_fn=lambda t: s2d2._pad_reflect_f2_4px(t, 32))
    ours = k9.d3_rows(_t(d["y"], True), _t(d["a"]), _t(d["c"]), k9.pack_rows_weights(_t(d["w"])))
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (B, H2 + 4, W2, 60)
    assert_close_bf16(ours, ref.astype(jnp.float32))


def test_pack_weights_layouts():
    rng = np.random.default_rng(36)
    w = _t(rng.normal(0, 1, (3, 3, 32, 64)))
    p = k9.pack_site_weights(w)
    assert p.dtype == torch.bfloat16 and tuple(p.shape) == (9, 64, 32)
    assert torch.equal(p[5, 7, 3], w[1, 2, 3, 7].to(torch.bfloat16))
    w5 = _t(rng.normal(0, 1, (1, 5, 128, 60)))
    p5 = k9.pack_rows_weights(w5)
    assert tuple(p5.shape) == (5, 64, 128) and not p5[:, 60:].any()
    assert torch.equal(p5[3, 17, 100], w5[0, 3, 100, 17].to(torch.bfloat16))


# ---------------------------------------------------------------------------
# (b) head and tail against the JAX chains
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params(johnson):  # noqa: F811
    """The JAX bf16 block-space params with conv3's block weights (the JAX
    head needs ``c3_wb``, built only on demand), the port's f32 and bf16 nets
    and the bf16 sites' weights."""
    bp32, net, nb = johnson
    bp32 = dict(bp32)
    bp32["c3_wb"] = jnp.asarray(s2dj._scatter_stride2_s2d2(np.asarray(bp32["c3_w"])))
    bp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), bp32)
    return bp32, bp, net, nb, sites_bf16.prepare(net, "cpu")


def test_site_weights_match_jax_params(params):
    """The port's packed bf16 weights are the JAX engine's bf16-cast
    block-space params: deconv2's phase form and deconv3's tap-packed rows
    scattered in f32 before the cast, conv2/conv3 the pixel taps whose scatter
    is the JAX block form."""
    _, bp, _, _, sw = params
    f = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    unpack = lambda p, c, co: p.float().numpy().transpose(0, 2, 1).reshape(3, 3, c, co)  # noqa: E731
    assert np.array_equal(unpack(sw.d2_w, 64, 128), f(bp["d2_w"]))
    assert np.array_equal(s2dj._scatter_stride2_s2d2(unpack(sw.c2_w, 32, 64)), f(bp["c2_w"]))
    assert np.array_equal(s2dj._scatter_stride2_s2d2(unpack(sw.c3_w, 64, 128)), f(bp["c3_wb"]))
    assert np.array_equal(sw.d3_w.float().numpy().transpose(0, 2, 1)[:, :, :60], f(bp["d3_w"])[0])
    for ours, ref in ((sw.c2_b, "c2_b"), (sw.c3_b, "c3_b"), (sw.d2_b, "d2_b"), (sw.d3_b, "d3_b")):
        assert np.array_equal(ours.numpy(), f(bp[ref])), ref


def test_head_matches_jax_head(params):
    """``sites_bf16.head`` from conv1's raw output against ``s2d2_sites.head``
    from the same tensor (space-to-depth). The JAX in2 statistics mix f32
    interior sums with bf16-rounded strip values (1.3e-4 relative from the
    port's all-f32 sums at this size, where the strips are 6.6% of the
    positions); that shift moves a few percent of conv3's bf16 activations by
    an ulp, so raw3 is held to 1 bf16 ulp of the tensor's largest magnitude
    everywhere, a mean |Δ| ≤ 5e-4 of its rms (measured 2.2e-4) and 85% of the
    elements equal (measured 87.8%); (m3, inv3) within 2e-4."""
    _, bp, _, nb, sw = params
    x = _video(B, 2 * H2, 2 * W2, seed=11)
    raw1 = s2d2._conv1_same_fixed(s2dj.s2d(_j(x), 2), bp["c1_w"], bp["c1_b"])
    m1, inv1 = s2dj._in_stats(raw1, 4, 32)
    raw3, m3, inv3 = sj.head(raw1, m1, inv1, bp["in1"], bp["c2_w"], bp["c2_b"], bp["in2"],
                             bp["c3_wb"], bp["c3_b"])
    with torch.no_grad():
        y1 = ts2d.d2s(_t(np.asarray(raw1.astype(jnp.float32)), True), 2, 32).contiguous()
        ours, m, inv = sites_bf16.head(y1, _t(np.asarray(m1)), _t(np.asarray(inv1)), nb, sw)
    assert tuple(ours.shape) == (B, H2 // 2, W2 // 2, 128)
    ref = np.asarray(raw3.astype(jnp.float32))
    assert_close_bf16(ours, ref, floor=1.0, share=0.85)
    assert np.abs(ours.float().numpy() - ref).mean() <= 5e-4 * np.sqrt((ref * ref).mean())
    np.testing.assert_allclose(inv.numpy(), np.asarray(inv3), rtol=2e-4)
    np.testing.assert_allclose(m.numpy(), np.asarray(m3), rtol=0,
                               atol=2e-4 / float(np.asarray(inv3).min()))


def test_tail_matches_jax_tail(params):
    """``sites_bf16.tail`` from deconv1's raw output (``d2s`` of the JAX phase
    form) against ``s2d2_sites.tail``: y12 within 2 bf16 ulp, an ulp taken at
    no less than 1/8 of the tensor's largest magnitude (the five row terms K9b
    adds are larger than their sum), 99% equal."""
    _, bp, _, nb, sw = params
    rng = np.random.default_rng(12)
    y = _bf(rng.normal(0.1, 1.0, (B, H2 // 2, W2 // 2, 256)))
    m4, inv4 = s2dj._in_stats(_j(y), 4, 64)
    ref = sj.tail(_j(y), m4, inv4, bp["in4"], bp["d2_w"], bp["d2_b"], bp["in5"], bp["d3_w"],
                  bp["d3_b"])
    with torch.no_grad():
        ours = sites_bf16.tail(ts2d.d2s(_t(y, True), 2, 64), _t(np.asarray(m4)),
                               _t(np.asarray(inv4)), nb, sw)
    assert tuple(ours.shape) == (B, H2, W2, 12)
    ref = np.asarray(ref.astype(jnp.float32))
    assert_close_bf16(ours, ref, limit=2.0, floor=2.0 ** -3)


# ---------------------------------------------------------------------------
# (c) the gates
# ---------------------------------------------------------------------------


def test_bf16_site_gates_match_jax():
    sizes = [(540, 960), (360, 640), (538, 960), (540, 30), (12, 64), (28, 32), (20, 960),
             (270, 480), (24, 16), (544, 1004)]
    sizes += [(h, w) for h in range(2, 70) for w in (8, 16, 24, 30, 32, 48, 64, 96)]
    for h2, w2 in sizes:
        assert sites_bf16.d3_supported(h2, w2) == sj.d3_supported(h2, w2), (h2, w2)
        assert sites_bf16.tail_supported(h2, w2) == sj.tail_supported(h2, w2), (h2, w2)
        assert sites_bf16.head_supported(h2, w2) == sj.head_supported(h2, w2), (h2, w2)
        assert sites_bf16._tail_geom(h2, w2) == sj._tail_geom(h2, w2), (h2, w2)
        assert sites_bf16._head_geom(h2, w2) == sj._head_geom(h2, w2), (h2, w2)
    assert sites_bf16._tail_geom(540, 960) == (544, 552, 968)
    assert sites_bf16._head_geom(540, 960) == (12, 10)
    assert not sites_bf16.tail_supported(360, 640) and sites_bf16.head_supported(360, 640)


# ---------------------------------------------------------------------------
# (d) the whole forward under each set
# ---------------------------------------------------------------------------


def _spy_k9(monkeypatch):
    """Count the K9 wrappers' calls on the CPU (where LAUNCHES stays 0)."""
    calls = dict.fromkeys(k9.LAUNCHES, 0)
    for name in calls:
        fn = getattr(k9, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(k9, name, spy)
    return calls


def _used(calls):
    return {k: v for k, v in calls.items() if v}


@pytest.mark.parametrize("fused,static,expect", [
    (("head", "tail"), False,
     {"c2_site_bf16": 1, "c3_site_bf16": 1, "d2_site": 1, "d3_sum_site": 1}),
    (("d3",), False, {"d3_rows": 1}),
    (("head", "tail"), True, {}),
    (("d3",), True, {"d3_rows": 1}),
])
def test_forward_with_fused_sites_matches_jax(params, monkeypatch, fused, static, expect):
    """``net(x, fused_sites=...)`` against ``transformer_net_s2d2.apply`` with
    the same set on carried-over weights (raw_01: outputs compared clamped to
    [0, 1], as ``stylize`` returns them): MAE ≤ 1e-2, the repo's gate — the
    port's pixel convs and the JAX space-to-depth convs differ by bf16
    reassociation. Under ``static_stats`` ``head`` and ``tail`` are dropped on
    both sides and ``d3`` stays. Each site runs once a forward."""
    from neuralstyletransferv1_torch.engine import stylizer as tst

    bp32, bp, net, nb, sw = params
    x = _video(B, 2 * H2, 2 * W2, seed=13)
    stats = s2d2.calibrate_in_stats(bp32, jnp.asarray(x[:1])) if static else None
    ref = jax.jit(lambda t: jnp.clip(s2d2.apply(bp, t, fused_sites=fused, static_stats=stats),
                                     0.0, 1.0).astype(jnp.float32))(_j(x))
    _, st = quant_from_jax(None, stats)
    calls = _spy_k9(monkeypatch)
    with torch.no_grad():
        got = tst.stylize(lambda t: nb(t, fused_sites=fused, static_stats=st, site_weights=sw),
                          "raw_01", torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert got.shape == x.shape
    mae = float(np.abs(got - np.asarray(ref)).mean())
    assert mae <= 1e-2, mae
    assert float(got.std()) > 0.05
    assert _used(calls) == expect


def test_fused_sites_through_the_stylizer(params, monkeypatch):
    """``jit_stylizer(fused_sites=("head", "tail", "d3"))`` under bfloat16:
    the head and the tail run fused (the tail returns before ``d3`` is
    reached) and the result stays within the 1e-2 gate of the plain bf16
    stylize; a size whose gates fail (36×80 → padded to 36×80, h2 = 18) runs
    unfused, bit for bit the plain path; under float32 ``head`` raises (it has
    no float32 form: the JAX forward takes it only from params with
    ``c3_wb``); ``tail`` and ``d3`` under float32 are
    tests/test_torch_f32_sets_johnson.py's."""
    from neuralstyletransferv1_torch.engine import stylizer as tst

    _, _, net, _, _ = params
    model = tst.StyleModel("johnson", net, "raw_01", "init")
    x = torch.from_numpy(_video(1, 2 * H2, 2 * W2, seed=14))
    plain = tst.jit_stylizer(model, dtype=torch.bfloat16)
    calls = _spy_k9(monkeypatch)
    got = tst.jit_stylizer(model, dtype=torch.bfloat16, fused_sites=("head", "tail", "d3"))(x)
    assert _used(calls) == {"c2_site_bf16": 1, "c3_site_bf16": 1, "d2_site": 1, "d3_sum_site": 1}
    assert float((got - plain(x)).abs().mean()) <= 1e-2
    small = torch.from_numpy(_video(1, 36, 80, seed=15))
    calls.update(dict.fromkeys(calls, 0))
    got = tst.jit_stylizer(model, dtype=torch.bfloat16, fused_sites=("head", "tail"))(small)
    assert _used(calls) == {} and torch.equal(got, plain(small))
    with pytest.raises(NotImplementedError, match="no float32 form"):
        tst.jit_stylizer(model, fused_sites=("head",))(x)
    with pytest.raises(ValueError, match="unknown fused sites"):
        tst.jit_stylizer(model, dtype=torch.bfloat16, fused_sites=("tale",))


# ---------------------------------------------------------------------------
# (e) int8 sets that name a bf16 site
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused,expect9,expect8", [
    (("res_i8", "dec_i8", "d3"), {"d3_rows": 1}, {"res_site": 7, "res_site_skip": 5}),
    (("res_i8", "tail"), {"d2_site": 1, "d3_sum_site": 1}, {"res_site": 6, "res_site_skip": 4}),
    (("head", "res_i8", "dec_i8"), {}, {"res_site": 7, "res_site_skip": 5}),
])
def test_int8_sets_with_bf16_sites_match_jax(johnson, monkeypatch, fused, expect9,  # noqa: F811
                                             expect8):
    """``--quantize int8`` with a set that names a bf16 site, through
    ``jit_stylizer``, against ``transformer_net_s2d2.apply(quant=)`` with the
    same set after the JAX engine's calibration: within the 1e-2 gate. ``d3``
    runs K9e after the int8 decoder; ``tail`` runs d1 as the int8 site it is
    in the XLA form (``_qc``: no ``dec_*`` site in the set, so not K4) and
    then K9a/K9b; ``head`` in an int8 set
    does nothing (the JAX engine's params never carry ``c3_wb``): the output
    equals the set without it bit for bit."""
    bp32, net, _ = johnson
    x = _video(1, 2 * H2, 2 * W2, seed=16)
    ref, quant = _jax_stylize(bp32, x, fused, static=False)
    assert "d3" not in quant
    calls9, calls8 = _spy_k9(monkeypatch), _spy_k8(monkeypatch)
    got = _port_stylize(net, x, "int8", fused)
    assert got.shape == ref.shape == x.shape
    mae = float(np.abs(got - ref).mean())
    assert mae <= 1e-2, mae
    assert float(got.std()) > 0.05
    assert _used(calls9) == expect9 and _used(calls8) == expect8
    if "head" in fused:
        rest = tuple(s for s in fused if s != "head")
        assert np.array_equal(got, _port_stylize(net, x, "int8", rest))


def test_tail_with_a_baked_deconv3(johnson, monkeypatch):  # noqa: F811
    """``("res_i8", "tail", "tail_s8")`` under ``int8``: ``tail_s8`` keeps d3
    among the quantized sites, so the stylizer only clamps the output; the
    bf16 tail then runs with the IO-baked deconv3 weights, as the JAX engine's
    baked params make ``s2d2_sites.tail`` do."""
    bp32, net, _ = johnson
    fused = ("res_i8", "tail", "tail_s8")
    x = _video(1, 2 * H2, 2 * W2, seed=17)
    ref, quant = _jax_stylize(bp32, x, fused, static=False)
    assert "d3" in quant
    calls9 = _spy_k9(monkeypatch)
    got = _port_stylize(net, x, "int8", fused)
    assert float(np.abs(got - ref).mean()) <= 1e-2
    assert _used(calls9) == {"d2_site": 1, "d3_sum_site": 1}


# ---------------------------------------------------------------------------
# below the res / decoder gates: the XLA form of the int8 sites
# ---------------------------------------------------------------------------


def _qc_chain(nb, quant, y, static_stats=None):
    """The port's below-gate int8 chains from the activated res input y up to
    deconv3's activated input in the phase form (the JAX "d3" tap)."""
    q, st = quant_from_jax(quant, static_stats)
    sites = sites_i8.prepare_sites(nb, q, "cpu")
    with torch.no_grad():
        y = sites_i8.res_chain_qc(_t(y, True), nb, sites, static_stats=st)
        r, m4, inv4 = sites_i8.dec_d1_qc(y, nb, sites, static_stats=st)
        r2, m5, inv5 = sites_i8.dec_d2_qc(r, m4, inv4, nb, sites, static_stats=st)
        return ts2d.apply_in_relu(r2, m5, inv5, nb.in5.weight, nb.in5.bias, 4).float().numpy()


@pytest.mark.parametrize("static", [True, False])
def test_below_the_res_and_dec_gates_chain_matches_xla(johnson, static):  # noqa: F811
    """24×48 (res grid 6×12: ``res_supported`` and ``dec_supported`` fail, and
    the engine does not pad to 8×32): the JAX ``apply`` runs every int8 site
    through XLA there, and so does the port (``res_chain_qc``, ``dec_d1_qc``,
    ``dec_d2_qc``). From the same res input, against the reference run op by
    op: with frozen norms deconv3's input is bit-identical. With measured
    norms the two frameworks sum the statistics in their own order; where
    that flips no code the outputs agree on ≥ 99.5% of the elements (this
    input: 99.99%, mean |Δ| 4e-7), and where it flips one, the measured
    norms of this random-weight net carry it everywhere (other inputs: 53%
    equal, mean |Δ| 1e-2 at values of 0.4), which only the stylize gate of
    the next test bounds."""
    bp32, _, nb = johnson
    x = _video(2, 24, 48, seed=18)
    assert not si8.res_supported(6, 12) and not si8.dec_supported(6, 12)
    stats, _, quant = calibrate_jax(bp32, x, static=static)
    _, taps = xla_reference(bp32, x, quant, stats, jit=False)
    ours = _qc_chain(nb, quant, taps["r1a"], stats)
    if static:
        np.testing.assert_array_equal(ours, taps["d3"])
    else:
        assert (ours == taps["d3"]).mean() >= 0.995, (ours == taps["d3"]).mean()
        assert np.abs(ours - taps["d3"]).mean() <= 2e-3


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_below_the_res_and_dec_gates_stylize_matches_jax(johnson, monkeypatch,  # noqa: F811
                                                         mode):
    """The port's ``int8`` and ``int8_static`` stylize at 24×48 under the
    adopted sets against the JAX ``apply(quant=, fused_sites=adopted)``:
    within the 1e-2 gate (the bf16 heads differ by isolated ulps), and no
    int8 kernel wrapper is called — every site runs in the XLA form."""
    bp32, net, _ = johnson
    static = mode == "int8_static"
    x = _video(1, 24, 48, seed=19)
    ref, _ = _jax_stylize(bp32, x, tq.default_sites(static), static=static)
    calls = _spy_k8(monkeypatch)
    got = _port_stylize(net, x, mode, None)
    mae = float(np.abs(got - ref).mean())
    assert mae <= 1e-2, mae
    assert _used(calls) == {}


def test_gates_route_each_size_like_jax(johnson, monkeypatch):  # noqa: F811
    """28×120 under ``int8``: the res gate fails (7×30) and so does the
    decoder's: XLA form throughout. 32×64: both pass, the kernels run."""
    _, net, _ = johnson
    for hw, expect in (((28, 120), {}), ((32, 64), {"res_site": 7, "res_site_skip": 5})):
        calls = _spy_k8(monkeypatch)
        _port_stylize(net, _video(1, *hw, seed=20), "int8", None)
        assert _used(calls) == expect, hw
        monkeypatch.undo()
