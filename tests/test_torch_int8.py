"""The int8 sites of the PyTorch port vs the JAX package, on the CPU.

Per kernel, the plain versions of K2–K5 (``kernels/int8_sites.py``) against
the interpret-mode Pallas kernels of ``models/s2d2_sites_i8.py``; then the
calibration contract, the ``--quantize int8`` chains against the XLA int8
reference (``transformer_net_s2d2.apply(quant=)``) and the quantized
stylize's quality. The kernels themselves run only on the card:
``tests/test_torch_policy.py`` holds them against their plain versions
there (a JAX-free file, as the card's machine has no jax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralstyletransferv1_tpu.models import transformer_net as jtn
from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_tpu.models import transformer_net_s2d2 as s2d2
from neuralstyletransferv1_torch.kernels import int8_sites as k8
from neuralstyletransferv1_torch.models import sites_i8
from neuralstyletransferv1_torch.models import transformer_net_quant as tq
from neuralstyletransferv1_torch.models.transformer_net import (
    TransformerNet,
    params_from_jax,
    quant_from_jax,
)

B, H, W, C = 1, 8, 16, 32   # per-kernel size


# ---------------------------------------------------------------------------
# per kernel: plain version vs interpret-mode Pallas
# ---------------------------------------------------------------------------


def _inputs(seed, c=C, co=C):
    """Random site operands, bf16-representable where the site reads bf16."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {
        "x": bf(rng.normal(0, 2, (B, H, W, c))), "y": bf(rng.normal(0, 1, (B, H, W, c))),
        "a": f32(rng.uniform(5, 40, (B, c))), "c": f32(rng.normal(0, 8, (B, c))),
        "a2": f32(rng.uniform(0.5, 1.5, (B, c))), "c2": f32(rng.normal(0, 0.3, (B, c))),
        "w": rng.integers(-127, 128, (3, 3, c, co)).astype(np.int8),
        "ws": f32(rng.uniform(0.5, 2, co) / (127 * 127 * 12)), "bias": f32(rng.normal(0, 0.2, co)),
        "qa": f32(rng.uniform(10, 60, co)), "qc": f32(rng.normal(0, 10, co)),
        "codes": rng.integers(0, 128, (B, H, W, c)).astype(np.int8),
    }


def _jax(d, k):
    v = d[k]
    return jnp.asarray(v, jnp.bfloat16) if k in ("x", "y") else jnp.asarray(v)


def _torch(d, k):
    v = torch.from_numpy(d[k].copy())
    if k in ("x", "y"):
        return v.to(torch.bfloat16)
    return k8.pack_weights(v) if k == "w" else v


def _interpret(fn, *args, **kw):
    si8._INTERPRET = True
    try:
        return jax.tree.map(np.asarray, fn(*args, **kw))
    finally:
        si8._INTERPRET = False


def _bf16_ordered(v):
    """bf16 values → integers ordered like the values (1 apart = 1 ulp)."""
    bits = np.asarray(jnp.asarray(v, jnp.bfloat16).view(jnp.int16)).astype(np.int32)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def assert_bf16_close(ours: torch.Tensor, ref):
    """Within 1 bf16 ulp at >= 99.9% of elements (XLA may contract to an FMA
    where the port rounds the product; tests/test_static_norm.py documents
    it for the Pallas kernels), and never more than 2 ulp."""
    d = np.abs(_bf16_ordered(ours.float().numpy()) - _bf16_ordered(np.asarray(ref, np.float32)))
    assert (d <= 1).mean() >= 0.999 and d.max() <= 2, (d.max(), (d > 1).mean())


def assert_codes_close(ours: torch.Tensor, ref):
    d = np.abs(ours.numpy().astype(np.int32) - np.asarray(ref).astype(np.int32))
    assert (d == 0).mean() >= 0.999 and d.max() <= 1, (d.max(), (d > 0).mean())


def assert_sums_close(sums: torch.Tensor, ours: torch.Tensor, sout, ref, n: int):
    """[Σ, Σ²] within 1e-5 relative of the Pallas sums, after moving those
    by what the outputs' isolated 1-ulp flips change (the sums are of each
    side's own bf16 outputs): Σ² against itself, Σ against the magnitude sum
    it could cancel from (at most sqrt(n·Σ²))."""
    def exact(v):
        v = np.asarray(v, np.float64)
        return np.stack([v.sum(axis=(1, 2)), (v * v).sum(axis=(1, 2))], axis=1)

    got = sums.numpy().astype(np.float64)
    want = np.asarray(sout, np.float64) + exact(ours.float().numpy()) - exact(np.asarray(ref, np.float32))
    s2 = np.abs(want[:, 1])
    assert np.all(np.abs(got[:, 1] - want[:, 1]) <= 1e-5 * s2)
    assert np.all(np.abs(got[:, 0] - want[:, 0]) <= 1e-5 * np.sqrt(n * s2))


@pytest.mark.parametrize("halo", ["reflect", "edge"])
@pytest.mark.parametrize("lo", [-127.0, 0.0])
def test_k4_res_site_matches_pallas(halo, lo):
    d = _inputs(1)
    ref, sout = _interpret(si8.res_site, _jax(d, "x"), _jax(d, "a"), _jax(d, "c"),
                           _jax(d, "w").reshape(9, C, C), _jax(d, "ws"), _jax(d, "bias"), lo,
                           halo=halo)
    before = dict(k8.LAUNCHES)
    ours, sums = k8.res_site(*(_torch(d, k) for k in ("x", "a", "c")), lo,
                             *(_torch(d, k) for k in ("w", "ws", "bias")), halo=halo)
    assert k8.LAUNCHES == before  # CPU tensors take the plain version
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (B, H, W, C)
    assert_bf16_close(ours, ref)
    assert_sums_close(sums, ours, sout, ref, H * W)


@pytest.mark.parametrize("halo", ["reflect", "edge"])
@pytest.mark.parametrize("lo", [-127.0, 0.0])
def test_k5_res_site_skip_matches_pallas(halo, lo):
    d = _inputs(2)
    ref, sout, vref = _interpret(
        si8.res_site_skip, _jax(d, "x"), _jax(d, "y"), *(_jax(d, k) for k in ("a", "c", "a2", "c2")),
        _jax(d, "w").reshape(9, C, C), _jax(d, "ws"), _jax(d, "bias"), lo, halo=halo)
    ours, sums, v = k8.res_site_skip(*(_torch(d, k) for k in ("x", "y", "a", "c", "a2", "c2")),
                                     lo, *(_torch(d, k) for k in ("w", "ws", "bias")), halo=halo)
    assert_bf16_close(v, vref)
    assert_bf16_close(ours, ref)
    assert_sums_close(sums, ours, sout, ref, H * W)
    _, _, none = k8.res_site_skip(*(_torch(d, k) for k in ("x", "y", "a", "c", "a2", "c2")),
                                  lo, *(_torch(d, k) for k in ("w", "ws", "bias")), halo=halo,
                                  yout=False)
    assert none is None


@pytest.mark.parametrize("halo", ["reflect", "edge"])
@pytest.mark.parametrize("lo", [-127.0, 0.0])
def test_k2_res_site_s8o_matches_pallas(halo, lo):
    d = _inputs(3)
    ref = _interpret(si8.res_site_s8o, _jax(d, "x"), _jax(d, "a"), _jax(d, "c"),
                     _jax(d, "w").reshape(9, C, C), _jax(d, "ws"), _jax(d, "bias"),
                     qa=_jax(d, "qa"), qc=_jax(d, "qc"), lo=lo, qlo=0.0, halo=halo)
    ours = k8.res_site_s8o(*(_torch(d, k) for k in ("x", "a", "c")), lo,
                           *(_torch(d, k) for k in ("w", "ws", "bias", "qa", "qc")), halo=halo)
    assert ours.dtype == torch.int8
    assert_codes_close(ours, ref[:, :, 1:W + 1])  # the Pallas carry's content columns


@pytest.mark.parametrize("halo", ["reflect", "edge"])
def test_k3_site_s8_matches_pallas(halo):
    d = _inputs(4)
    # the Pallas carry layout: column halos injected, padded to _wps(W)
    carry = si8._s8_col_halo(jnp.asarray(d["codes"][0]), W, si8._wps(W), halo)[None]
    ref = _interpret(si8.site_s8, carry, _jax(d, "w").reshape(9, C, C), _jax(d, "ws"),
                     _jax(d, "bias"), w0=W, y=_jax(d, "y"), aff=(_jax(d, "qa") / 40,
                                                                 _jax(d, "qc") / 40),
                     halo=halo)
    aa = torch.from_numpy(np.array(_jax(d, "qa") / 40))
    ac = torch.from_numpy(np.array(_jax(d, "qc") / 40))
    ours = k8.site_s8(torch.from_numpy(d["codes"]), _torch(d, "w"), _torch(d, "ws"),
                      _torch(d, "bias"), aa, ac, _torch(d, "y"), halo=halo)
    assert_bf16_close(ours, ref)


def test_pack_weights_roundtrip():
    w = torch.from_numpy(np.random.default_rng(5).integers(-127, 128, (3, 3, 64, 128))
                         .astype(np.int8))
    wk = k8.pack_weights(w)
    assert wk.dtype == torch.int32 and tuple(wk.shape) == (9, 16, 128)
    assert torch.equal(k8.unpack_weights(wk), w)
    # word (tap, k, o) holds channels 4k..4k+3 little-endian
    assert int(wk[4, 3, 7]) & 0xFF == int(w[1, 1, 12, 7]) & 0xFF


# ---------------------------------------------------------------------------
# the slice: calibration, chains and stylize at full Johnson width
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def johnson():
    """Random Johnson weights (``transformer_net.init``, as the JAX tests
    use) as the JAX f2 params — no IO affine baked, so both packages see the
    same input — and the port's f32 and bf16 nets. Outputs are compared raw
    (the ``raw_01`` preset): they spread over [0, 1]."""
    tree = jax.tree.map(np.asarray, jtn.init(jax.random.key(0)))
    bp32 = jax.tree.map(jnp.asarray, s2d2.from_johnson_params(tree))
    net = TransformerNet()
    net.load_state_dict(params_from_jax(tree))
    net = net.eval().requires_grad_(False)
    nb = TransformerNet()
    nb.load_state_dict(net.state_dict())
    return bp32, net, nb.to(torch.bfloat16).eval().requires_grad_(False)


def _video(n, h, w, seed):
    """n frames of one smooth textured scene panning by (1, 2) px a frame
    (a video: the frames share their statistics)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 2 * n, 0:w + 4 * n].astype(np.float32)
    scene = 0.5 + 0.25 * np.sin(0.21 * xx + 0.13 * yy)[..., None] \
        + 0.15 * np.cos(0.17 * xx - 0.29 * yy)[..., None] + rng.normal(0, 0.05, (1, 1, 3))
    scene = np.clip(scene + rng.normal(0, 0.03, scene.shape), 0, 1).astype(np.float32)
    return np.stack([scene[t:t + h, 2 * t:2 * t + w] for t in range(n)])


def calibrate_jax(bp32, x, static: bool):
    """The JAX engine's calibration on frame 0 (f32): frozen stats for the
    static modes, act scales of the sites the engine quantizes, quant."""
    xj = jnp.asarray(x[:1])
    stats = s2d2.calibrate_in_stats(bp32, xj) if static else None
    scales = s2d2.calibrate_act_scales(bp32, xj, sites=s2d2.QUANT_SITES_PALLAS,
                                       static_stats=stats)
    scales = {k: v for k, v in scales.items() if k in tq.INT8_SITES}
    return stats, scales, s2d2.quantize_net(bp32, scales)


def xla_reference(bp32, x, quant, stats, *, jit=True):
    """The XLA int8 reference (``apply(quant=, static_stats=)``, bf16
    params) on x, with its res input ("r1a") and deconv3 input ("d3").
    Under jit, XLA picks mul+add or an FMA per fusion, which flips isolated
    bf16 ulps (tests/test_static_norm.py::test_static_s8_chain_bit_exact);
    op by op (``jit=False``) every product rounds."""
    bp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), bp32)

    def run(xb):
        taps = {}
        y = s2d2.apply(bp, xb, quant=quant, static_stats=stats,
                       tap=lambda s, t: taps.__setitem__(s, t) if s in ("r1a", "d3") else None)
        return y, taps

    y, taps = (jax.jit(run) if jit else run)(jnp.asarray(x, jnp.bfloat16))
    return (np.asarray(y.astype(jnp.float32)),
            {k: np.asarray(v.astype(jnp.float32)) for k, v in taps.items()})


@pytest.fixture(scope="module")
def dyn(johnson):
    """--quantize int8: the JAX calibration and XLA reference at (2, 32, 64)."""
    bp32, _, _ = johnson
    x = _video(2, 32, 64, seed=0)
    _, scales, quant = calibrate_jax(bp32, x, static=False)
    ref, taps = xla_reference(bp32, x, quant, None)
    return {"x": x, "scales": scales, "quant": quant, "ref": ref, "taps": taps}


def test_act_scales_and_quantize_net_match_jax(johnson, dyn):
    _, net, _ = johnson
    ours = tq.calibrate_act_scales(net, torch.from_numpy(dyn["x"][:1]),
                                   sites=tq.QUANT_SITES_PALLAS)
    assert set(tq.QUANT_SITES_PALLAS) <= set(ours)
    for k, v in dyn["scales"].items():
        assert abs(ours[k] - v) <= 1e-5 * v, (k, ours[k], v)
    q = tq.quantize_net(net, dyn["scales"])
    assert sorted(q) == sorted(tq.INT8_SITES)
    for k, ref in dyn["quant"].items():
        assert np.array_equal(q[k]["w"].numpy(), np.asarray(ref["w"])), k  # d1/d2: phase form
        assert np.array_equal(q[k]["ws"].numpy(), np.asarray(ref["ws"])), k
        assert q[k]["qin"] == float(ref["qin"]), k
    assert tuple(q["d1"]["w"].shape) == (3, 3, 128, 256)
    assert tuple(q["d2"]["w"].shape) == (3, 3, 64, 128)


def chain_out(nb, quant, y, static_stats=None):
    """The port's int8 res + dec chains from the activated res input y (a
    JAX head's output, so both packages start from the same tensor), up to
    deconv3's activated input in the phase form (the JAX "d3" tap)."""
    from neuralstyletransferv1_torch.models.s2d import apply_in_relu

    q, st = quant_from_jax(quant, static_stats)
    sites = sites_i8.prepare_sites(nb, q, "cpu")
    y = torch.from_numpy(y.copy()).to(torch.bfloat16)
    with torch.no_grad():
        if st is None:
            y4, carry = sites_i8.res_chain(y, nb, sites)
            r2, m5, inv5 = sites_i8.dec_chain(y4, nb, sites, carry=carry)
        else:
            y = sites_i8.res_chain_s8_static(y, nb, sites, st)
            r2, m5, inv5 = sites_i8.dec_chain(y, nb, sites, static_stats=st)
        return apply_in_relu(r2, m5, inv5, nb.in5.weight, nb.in5.bias, 4).float().numpy()


def test_int8_chains_match_pallas_chains(johnson, dyn):
    """From the same res input, the port's ten res sites, d1 and d2 (K4/K5,
    block 5's add folded into d1) reproduce the JAX engine's own Pallas
    chains (``res_chain(ret_carry=True)`` + ``dec_chain(carry=)``, interpret
    mode) bit for bit: same folded rows, same statistics of the bf16 outputs
    (every element equal). The XLA reference differs from both where its
    residual norm rounds (instance_norm instead of the folded carry) and
    with XLA's fusion choices; with measured norms one flipped code moves
    the statistics, so the chains and XLA agree only to a mean of 1e-3."""
    from neuralstyletransferv1_tpu.models.transformer_net_s2d import _apply_in_relu

    bp32, _, nb = johnson
    bp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), bp32)
    y = dyn["taps"]["r1a"]
    q = dyn["quant"]

    def jax_chains():
        y4, carry = si8.res_chain(jnp.asarray(y, jnp.bfloat16), bp, q, ret_carry=True)
        r2, m5, inv5 = si8.dec_chain(y4, bp, q, carry=carry)
        return _apply_in_relu(r2, m5, inv5, bp["in5"]["scale"], bp["in5"]["bias"], 4
                              ).astype(jnp.float32)

    ref = _interpret(jax_chains)
    ours = chain_out(nb, q, y)
    assert (ours == ref).mean() >= 0.999, (ours == ref).mean()
    d = np.abs(ours - dyn["taps"]["d3"])
    assert d.mean() <= 1e-3, d.mean()


def test_int8_stylize_matches_xla_reference(johnson, dyn):
    """The whole int8 forward (the port's bf16 pixel head and deconv3) with
    the JAX calibration carried across, against the XLA int8 reference.
    The heads differ by isolated bf16 ulps (summation order of the pixel vs
    the space-to-depth convs); with measured norms a flipped code moves the
    statistics of the random-weight net, so whole outputs agree to the
    repo's 1e-2 gate, not to the chains' bit level (the test above)."""
    _, _, nb = johnson
    q, _ = quant_from_jax(dyn["quant"])
    with torch.no_grad():
        ours = tq.forward_int8(nb, torch.from_numpy(dyn["x"]).to(torch.bfloat16),
                               sites_i8.prepare_sites(nb, q, "cpu")).float().numpy()
    assert ours.shape == dyn["ref"].shape
    d = np.abs(np.clip(ours, 0, 1) - np.clip(dyn["ref"], 0, 1))
    assert d.mean() <= 1e-2, d.mean()


@pytest.mark.parametrize("mode", ["int8", "int8_static", "bf16_static"])
def test_quantized_stylizer_quality_vs_bf16(johnson, mode):
    """Each quantize mode of the port's stylizer, calibrating itself, stays
    within the repo's 1e-2 MAE gate of its dynamic bf16 output on the
    calibration frame (a static mode's later frames drift with the video's
    statistics; the gate is the JAX engine's, on the same terms)."""
    from neuralstyletransferv1_torch.engine import stylizer as tst

    _, net, _ = johnson
    model = tst.StyleModel("johnson", net, "raw_01", "init")
    x = torch.from_numpy(_video(1, 32, 128, seed=1))
    ref = tst.jit_stylizer(model, dtype=torch.bfloat16)(x)
    got = tst.jit_stylizer(model, dtype=torch.bfloat16, quantize=mode)(x)
    assert got.shape == ref.shape == x.shape and got.dtype == torch.float32
    mae = float((got - ref).abs().mean())
    assert mae <= 1e-2, mae
    assert float(got.std()) > 0.05


@pytest.mark.parametrize("mode,padded", [("int8", (40, 96)), ("int8_static", (40, 96)),
                                         ("bf16_static", (36, 80)), ("none", (36, 80))])
def test_int8_modes_pad_to_8x32(johnson, monkeypatch, mode, padded):
    """The int8 modes reflect-pad to 8×32 multiples once H ≥ 32 and W ≥ 64
    (36×80 → 40×96) and crop back, as the JAX engine does; the others pad
    to 4. The padding changes the instance-norm statistics, so where the
    port pads is part of the function it computes."""
    from neuralstyletransferv1_torch.engine import stylizer as tst

    _, net, _ = johnson
    model = tst.StyleModel("johnson", net, "raw_01", "init")
    seen, stylize = [], tst.stylize

    def spy(forward, preset, x):
        seen.append(tuple(x.shape[1:3]))
        return stylize(forward, preset, x)

    monkeypatch.setattr(tst, "stylize", spy)
    x = torch.from_numpy(_video(1, 36, 80, seed=2))
    got = tst.jit_stylizer(model, dtype=torch.bfloat16, quantize=mode)(x)
    assert got.shape == x.shape and seen == [padded]
