"""The all-int8 Johnson head and tail of the PyTorch port vs the JAX package,
on the CPU.

Per kernel, the plain versions of K8a/K8b (the int8 conv2/conv3 head
sites), K6/K7 (deconv3's tap-packed rows conv, on s8 codes and with the
quantize prologue) and K3's S8OUT and YAFF epilogues against the
interpret-mode Pallas kernels of ``models/s2d2_sites_i8.py``, fed the same
tensors in their TPU layouts; then the c2/c3/d3 int8 weights, the fused-site
sets (``head_i8``, ``res_s8``, ``dec_s8``, ``tail_s8``, ``d3_i8``) through the
chains and the whole stylize, and the geometry gates. The kernels
themselves run only on the card: ``tests/test_torch_policy.py`` holds them
against their plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_int8 import (  # noqa: F401
    _interpret,
    _video,
    assert_bf16_close,
    assert_codes_close,
    assert_sums_close,
    johnson,
)

from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_tpu.models import transformer_net_s2d as s2dj
from neuralstyletransferv1_tpu.models import transformer_net_s2d2 as s2d2
from neuralstyletransferv1_torch.kernels import int8_sites as k8
from neuralstyletransferv1_torch.models import sites_i8
from neuralstyletransferv1_torch.models import transformer_net_quant as tq
from neuralstyletransferv1_torch.models.transformer_net import quant_from_jax

B = 1


def _rng_inputs(seed, h, w, c, co):
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {
        "x": bf(rng.normal(0, 2, (B, h, w, c))), "y": bf(rng.normal(0, 1, (B, h, w, co))),
        "a": f32(rng.uniform(5, 40, (B, c))), "c": f32(rng.normal(0, 8, (B, c))),
        "w": rng.integers(-127, 128, (3, 3, c, co)).astype(np.int8),
        "ws": f32(rng.uniform(0.5, 2, co) / (127 * 127 * 12)), "bias": f32(rng.normal(0, 0.2, co)),
        "qa": f32(rng.uniform(10, 60, co)), "qc": f32(rng.normal(0, 10, co)),
        "ya": f32(rng.uniform(0.5, 1.5, co)), "yc": f32(rng.normal(0, 0.3, co)),
        "codes": rng.integers(0, 128, (B, h, w, c)).astype(np.int8),
    }


def _t(v, bf16=False):
    t = torch.from_numpy(np.array(v))
    return t.to(torch.bfloat16) if bf16 else t


def _s2d(x):
    return np.asarray(s2dj.s2d(jnp.asarray(x), 2))


# ---------------------------------------------------------------------------
# per kernel: plain version vs interpret-mode Pallas
# ---------------------------------------------------------------------------


def test_k8a_c2_site_matches_pallas():
    """K8a: the conv1 raw in pixels [1,32,64,32] against ``c2p_site`` on its
    column-pair view of the space-to-depth tensor, with the pair-packed
    weights of the same int8 taps (floor 0, the pixel reflect halo)."""
    d = _rng_inputs(11, 32, 64, 32, 64)
    wblk = s2dj._scatter_stride2_s2d2(d["w"].astype(np.float32)).astype(np.int8)
    yp = _s2d(d["x"]).reshape(B, 16, 16, 256)
    ref, sout = _interpret(
        si8.c2p_site, jnp.asarray(yp, jnp.bfloat16), jnp.tile(jnp.asarray(d["a"]), (1, 8)),
        jnp.tile(jnp.asarray(d["c"]), (1, 8)), si8._pair_c2_weights(wblk),
        jnp.tile(jnp.asarray(d["ws"]), 2), jnp.tile(jnp.asarray(d["bias"]), 2))
    ref = ref.reshape(B, 16, 32, 64)
    sout = sout.reshape(B, 2, 2, 64).sum(axis=2)
    before = dict(k8.LAUNCHES)
    ours, sums = k8.c2_site(_t(d["x"], True), _t(d["a"]), _t(d["c"]), 0.0,
                            k8.pack_weights(_t(d["w"])), _t(d["ws"]), _t(d["bias"]))
    assert k8.LAUNCHES == before  # CPU tensors take the plain version
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (B, 16, 32, 64)
    assert_bf16_close(ours, ref)
    assert_sums_close(sums, ours, sout, ref, 16 * 32)


def test_k8b_c3_site_matches_pallas():
    """K8b: the conv2 raw in pixels [1,16,32,64] against ``c3p_site`` on its
    pair view, stride 2 to [1,8,16,128]."""
    d = _rng_inputs(12, 16, 32, 64, 128)
    ref, sout = _interpret(
        si8.c3p_site, jnp.asarray(d["x"].reshape(B, 16, 16, 128), jnp.bfloat16),
        jnp.tile(jnp.asarray(d["a"]), (1, 2)), jnp.tile(jnp.asarray(d["c"]), (1, 2)),
        si8._pair_c3_weights(d["w"]), jnp.asarray(d["ws"]), jnp.asarray(d["bias"]))
    ours, sums = k8.c3_site(_t(d["x"], True), _t(d["a"]), _t(d["c"]), 0.0,
                            k8.pack_weights(_t(d["w"])), _t(d["ws"]), _t(d["bias"]))
    assert tuple(ours.shape) == (B, 8, 16, 128)
    assert_bf16_close(ours, ref)
    assert_sums_close(sums, ours, sout, ref, 8 * 16)


def _k3(d, halo, w0, **kw):
    """``site_s8`` on the Pallas carry layout of d["codes"]."""
    carry = si8._s8_col_halo(jnp.asarray(d["codes"][0]), w0, si8._wps(w0), halo)[None]
    c, co = d["codes"].shape[-1], d["w"].shape[-1]
    return _interpret(si8.site_s8, carry, jnp.asarray(d["w"]).reshape(9, c, co),
                      jnp.asarray(d["ws"]), jnp.asarray(d["bias"]), w0=w0, halo=halo, **kw)


@pytest.mark.parametrize("qlo", [0.0, -127.0])
def test_k3_s8out_matches_pallas(qlo):
    """K3 with S8OUT and no affine or residual (the d1/d2 sites of the s8
    decoder): 128 → 256 and 64 → 128 with the edge halo, floor 0; and the
    res chain's bridge (frozen affine + residual, then the emit at floor
    −127, reflect halo)."""
    if qlo == 0.0:
        for seed, (c, co) in ((13, (128, 256)), (14, (64, 128))):
            d = _rng_inputs(seed, 8, 16, c, co)
            ref = _k3(d, "edge", 16, qa=jnp.asarray(d["qa"]), qc=jnp.asarray(d["qc"]), qlo=0.0,
                      halo_out="edge")
            ours = k8.site_s8(_t(d["codes"]), k8.pack_weights(_t(d["w"])), _t(d["ws"]),
                              _t(d["bias"]), qa=_t(d["qa"]), qc=_t(d["qc"]), qlo=0.0,
                              halo="edge")
            assert ours.dtype == torch.int8 and tuple(ours.shape) == (B, 8, 16, co)
            assert_codes_close(ours, ref[:, :, 1:17])
    else:
        d = _rng_inputs(15, 8, 16, 128, 128)
        aa, ac = d["qa"] / 40, d["qc"] / 40
        ref = _k3(d, "reflect", 16, y=jnp.asarray(d["y"], jnp.bfloat16),
                  aff=(jnp.asarray(aa), jnp.asarray(ac)), qo=jnp.float32(23.5), qlo=-127.0,
                  halo_out="edge")
        ours = k8.site_s8(_t(d["codes"]), k8.pack_weights(_t(d["w"])), _t(d["ws"]),
                          _t(d["bias"]), _t(aa), _t(ac), _t(d["y"], True),
                          qa=torch.full((128,), 23.5), qc=torch.zeros(128), qlo=-127.0)
        assert int(ours.min()) < 0  # the floor −127 is reached below 0
        assert_codes_close(ours, ref[:, :, 1:17])


def test_k3_yaff_matches_pallas():
    """K3 with YAFF: the residual arrives raw and the frozen in3 affine +
    ReLU apply to it in the epilogue (res block 1 after the int8 head)."""
    d = _rng_inputs(16, 8, 16, 128, 128)
    aa, ac = d["qa"] / 40, d["qc"] / 40
    ref = _k3(d, "reflect", 16, y=jnp.asarray(d["y"], jnp.bfloat16),
              aff=(jnp.asarray(aa), jnp.asarray(ac)),
              yaff=(jnp.asarray(d["ya"]), jnp.asarray(d["yc"])))
    ours = k8.site_s8(_t(d["codes"]), k8.pack_weights(_t(d["w"])), _t(d["ws"]), _t(d["bias"]),
                      _t(aa), _t(ac), _t(d["y"], True), yaff=(_t(d["ya"]), _t(d["yc"])))
    assert ours.dtype == torch.bfloat16
    assert_bf16_close(ours, ref)


def _d3_operands(seed, h, w):
    rng = np.random.default_rng(seed)
    w5 = rng.integers(-127, 128, (1, 5, 128, 60)).astype(np.int8)
    ws = np.asarray(rng.uniform(0.5, 2, 60) / (127 * 127 * 20), np.float32)
    wk = k8.pack_weights(_t(w5), co_pad=k8.CO_TILE)
    wsp = torch.cat([_t(ws), torch.zeros(4)])
    return rng, w5, ws, wk, wsp


def test_k7_d3_rows_site_matches_pallas():
    """K7: the d2 raw [1,8,16,128] with the in5 affine folded into the
    quantize (floor 0), 1×5 int8 conv with zero column pads, 60 bf16 lanes."""
    rng, w5, ws, wk, wsp = _d3_operands(17, 8, 16)
    y = np.asarray(jnp.asarray(rng.normal(0, 2, (B, 8, 16, 128)), jnp.bfloat16)
                   .astype(jnp.float32))
    a = np.asarray(rng.uniform(5, 40, (B, 128)), np.float32)
    c = np.asarray(rng.normal(0, 8, (B, 128)), np.float32)
    ref = _interpret(si8.d3_rows_site, jnp.asarray(y, jnp.bfloat16), jnp.asarray(a),
                     jnp.asarray(c), jnp.asarray(w5[0]), jnp.asarray(ws))
    ours = k8.d3_rows_site(_t(y, True), _t(a), _t(c), wk, wsp)
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (B, 8, 16, 60)
    assert_bf16_close(ours, ref)


def test_k6_d3_s8_site_matches_pallas():
    """K6: deconv3 on s8 codes [1,16,16,128]: K rows, the 5-row dy-sum in
    f32 and the bias, zero-SAME borders."""
    rng, w5, ws, wk, wsp = _d3_operands(18, 16, 16)
    codes = rng.integers(0, 128, (B, 16, 16, 128)).astype(np.int8)
    bias = np.asarray(rng.normal(0, 0.2, 12), np.float32)
    carry = jnp.pad(jnp.asarray(codes), ((0, 0), (0, 0), (2, si8._wps2(16) - 18), (0, 0)))
    ref = _interpret(si8.d3_s8_site, carry, jnp.asarray(w5[0]), jnp.asarray(ws),
                     jnp.asarray(bias), w0=16)
    ours = k8.d3_s8_site(_t(codes), wk, wsp, _t(bias))
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (B, 16, 16, 12)
    assert_bf16_close(ours, ref)


def test_pack_weights_pads_the_d3_lanes():
    w = torch.from_numpy(np.random.default_rng(19).integers(-127, 128, (1, 5, 128, 60))
                         .astype(np.int8))
    wk = k8.pack_weights(w, co_pad=64)
    assert wk.dtype == torch.int32 and tuple(wk.shape) == (5, 32, 64)
    back = k8.unpack_weights(wk, 1, 5)
    assert torch.equal(back[..., :60], w) and not back[..., 60:].any()


# ---------------------------------------------------------------------------
# weights: c2, c3 and the baked, tap-packed d3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["imagenet_255", "caffe_bgr"])
def test_head_and_d3_int8_weights_match_jax(johnson, preset):  # noqa: F811
    """``quantize_net`` for c2, c3 and d3 gives the JAX ``w``/``ws``/``qin``
    exactly: c2 as the pixel weight whose scatter into the TPU's 2×2 block
    form is the JAX codes (each tap lands once, so the per-channel scales
    agree), c3 as the same pixel weight, d3 tap-packed to 60 lanes with the
    preset's post affine (and, for caffe_bgr, the BGR permutation) baked in
    before the per-lane scales are taken; and the baked d3 bias."""
    bp32, net, _ = johnson
    baked = s2d2.bake_io_affine(bp32, preset)
    scales = {"c2": 3.7, "c3": 5.1, "d3": 9.3}
    ref = s2d2.quantize_net(baked, scales)
    ours = tq.quantize_net(net, scales, io_preset=preset)
    assert tuple(ours["c2"]["w"].shape) == (3, 3, 32, 64)
    assert tuple(ours["c3"]["w"].shape) == (3, 3, 64, 128)
    assert tuple(ours["d3"]["w"].shape) == (1, 5, 128, 60)
    blk = s2dj._scatter_stride2_s2d2(ours["c2"]["w"].numpy().astype(np.float32))
    assert np.array_equal(blk.astype(np.int8), np.asarray(ref["c2"]["w"]))
    for k in ("c3", "d3"):
        assert np.array_equal(ours[k]["w"].numpy(), np.asarray(ref[k]["w"])), k
    for k in scales:
        assert np.array_equal(ours[k]["ws"].numpy(), np.asarray(ref[k]["ws"])), k
        assert ours[k]["qin"] == float(ref[k]["qin"]), k
    w_row, b12 = tq.baked_d3(net, preset)
    assert np.array_equal(w_row, np.asarray(baked["d3_w"]))
    assert np.array_equal(b12, np.asarray(baked["d3_b"]))


# ---------------------------------------------------------------------------
# the chains and the whole stylize under the two site sets
# ---------------------------------------------------------------------------

SET_A = ("head_i8", "res_i8", "res_s8", "dec_i8", "dec_s8", "tail_s8")  # int8_static
SET_B = ("head_i8", "res_i8", "dec_i8", "tail_s8", "d3_i8")              # int8


def _calibrate_jax(bp32, x, fused, static):
    """The JAX engine's calibration on frame 0 (f32) filtered by the set."""
    from neuralstyletransferv1_tpu.engine import stylizer as jst

    xj = jnp.asarray(x[:1])
    stats = s2d2.calibrate_in_stats(bp32, xj) if static else None
    scales = s2d2.calibrate_act_scales(bp32, xj, sites=s2d2.QUANT_SITES_PALLAS,
                                       static_stats=stats)
    scales = jst._s2d2_site_filter(scales, xj, sites=fused)
    return stats, s2d2.quantize_net(bp32, scales)


def _bf16_params(bp32):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16), bp32)


def _port_sites(net, nb, quant, stats):
    q, st = quant_from_jax(quant, stats)
    d3 = tq.baked_d3(net, "raw_01") if "d3" in q else None
    return sites_i8.prepare_sites(nb, q, "cpu", d3=d3), st


def _spy_launches(monkeypatch):
    """Count the kernel wrappers' calls on the CPU (where LAUNCHES stays 0)."""
    calls = dict.fromkeys(k8.LAUNCHES, 0)
    for name in calls:
        fn = getattr(k8, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(k8, name, spy)
    return calls


@pytest.fixture(scope="module")
def config_a(johnson):  # noqa: F811
    """--quantize int8_static with SET_A: the JAX calibration at (2, 32, 64)
    (raw_01: the IO affine bakes to the identity, so both packages see the
    same input and weights) and the conv1 raw output of the bf16 net."""
    bp32, _, _ = johnson
    x = _video(2, 32, 64, seed=7)
    stats, quant = _calibrate_jax(bp32, x, SET_A, static=True)
    bp = _bf16_params(bp32)
    y1 = s2d2._conv1_same_fixed(s2dj.s2d(jnp.asarray(x, jnp.bfloat16), 2), bp["c1_w"],
                                bp["c1_b"])
    return {"x": x, "stats": stats, "quant": quant, "y1": np.asarray(y1.astype(jnp.float32))}


@pytest.fixture(scope="module")
def chain_a(johnson, config_a):  # noqa: F811
    """The JAX Pallas chain of configuration A from config_a's conv1 raw
    output (interpret mode, under jit): head_chain → the s8 res chain with
    the deferred in3 (``in_aff``) and the d1 bridge (``emit_qo``) →
    ``dec_chain_s8_static(tail=True)`` → d2s. This is what
    ``transformer_net_s2d2.apply`` computes under SET_A after conv1 at this
    size (every gate passes), so clamped it is the JAX engine's stylize."""
    bp32, _, _ = johnson
    bp = _bf16_params(bp32)
    quant, stats = config_a["quant"], config_a["stats"]

    def run(y1):
        m1, inv1 = stats["in1"]
        y3, m3, inv3 = si8.head_chain(y1, m1, inv1, bp, quant, static_stats=stats)
        sc3 = bp["in3"]["scale"].astype(jnp.float32)
        bi3 = bp["in3"]["bias"].astype(jnp.float32)
        yq = si8.res_chain_s8_static(y3, bp, quant, stats,
                                     in_aff=(inv3 * sc3, bi3 - m3 * inv3 * sc3),
                                     emit_qo=quant["d1"]["qin"])
        y12 = si8.dec_chain_s8_static(yq, bp, quant, stats, w0=y3.shape[2], tail=True)
        return s2dj.d2s(y12, 2, 3).astype(jnp.float32)

    return _interpret(jax.jit(run), jnp.asarray(config_a["y1"], jnp.bfloat16))


def test_config_a_chain_matches_pallas_chain(johnson, config_a, chain_a,  # noqa: F811
                                             monkeypatch):
    """Configuration A from one conv1 raw output and one frozen calibration:
    K8a → K8b (head_chain) → the s8 res chain with the deferred in3 folded
    into block 1 (quantize and YAFF) and block 5 bridging into d1 → d1, d2
    on s8 codes → K6 + the reflect strips, against the JAX Pallas chain in
    interpret mode (fed the same tensor in its space-to-depth layout): bit
    for bit. (The interpret-mode kernels run through XLA, which may
    contract a quantize's x·a + c into an FMA and so flip an isolated code
    on other inputs; on these it does not.) Launches per forward: K8a 1,
    K8b 1, K2 5, K3 7, K6 1."""
    from neuralstyletransferv1_torch.models.s2d import d2s, in_affine

    _, net, nb = johnson
    quant, stats = config_a["quant"], config_a["stats"]
    assert {"c2", "c3", "d3"} <= set(quant)
    sites, st = _port_sites(net, nb, quant, stats)
    calls = _spy_launches(monkeypatch)
    with torch.no_grad():
        y1 = d2s(torch.from_numpy(config_a["y1"].copy()).to(torch.bfloat16), 2, 32).contiguous()
        y3, m3, inv3 = sites_i8.head_chain(y1, *st["in1"], nb, sites, st)
        in_aff = in_affine(m3, inv3, nb.in3.weight.float(), nb.in3.bias.float())
        yq = sites_i8.res_chain_s8_static(y3, nb, sites, st, in_aff=in_aff,
                                          emit_qo=sites["d1"].qin)
        assert yq.dtype == torch.int8
        y12 = sites_i8.dec_chain_s8_static(yq, nb, sites, st, tail=True)
        ours = d2s(y12, 2, 3).float().numpy()
    assert ours.shape == chain_a.shape == (2, 32, 64, 3)
    np.testing.assert_array_equal(ours, chain_a)
    assert {k: v for k, v in calls.items() if v} == {
        "c2_site": 1, "c3_site": 1, "res_site_s8o": 5, "site_s8": 7, "d3_s8_site": 1}


def test_config_b_d3_matches_jax_branch(johnson):  # noqa: F811
    """Configuration B's deconv3 (``d3_i8``): K7 on the d2 raw with the in5
    affine folded into its quantize, the bf16 dy-sum, the bf16 border
    strips and the bf16 bias add, against the JAX branch of
    ``transformer_net_s2d2.apply`` run op by op (K7 in interpret mode).
    The interior — everything outside the 4-pixel border frame — is K7's
    rows and is bit-identical. The frame comes from the bf16 strips, whose
    1×5 conv each framework sums in its own order in f32 before the one
    bf16 round: each of the five strip rows may differ by one bf16 ulp, and
    the bf16 dy-sum and bias add carry that into at most 8 ulp of the
    frame's largest value (measured: far fewer)."""
    from neuralstyletransferv1_tpu.models.transformer_net_s2d import _apply_in_relu
    from neuralstyletransferv1_tpu.ops.conv import conv2d as jconv2d

    bp32, net, nb = johnson
    bp = _bf16_params(bp32)
    rng = np.random.default_rng(21)
    hb, wb = 16, 32
    y = np.asarray(jnp.asarray(rng.normal(0.2, 1.5, (2, hb, wb, 128)), jnp.bfloat16)
                   .astype(jnp.float32))
    yr = y.reshape(2, hb, wb, 4, 32).astype(np.float64)
    m = yr.mean(axis=(1, 2, 3)).astype(np.float32)
    inv = (1 / np.sqrt(yr.var(axis=(1, 2, 3)) + 1e-5)).astype(np.float32)
    ya = np.asarray(_apply_in_relu(jnp.asarray(y), jnp.asarray(m), jnp.asarray(inv),
                                   bp32["in5"]["scale"], bp32["in5"]["bias"], 4))
    quant = s2d2.quantize_net(bp32, {"d3": float(np.abs(ya).max())})
    qd = quant["d3"]

    def jax_branch():
        yj, mj, ij = jnp.asarray(y, jnp.bfloat16), jnp.asarray(m), jnp.asarray(inv)

        def _d3_strip(sl):
            ps = s2d2._pad_reflect_f2_4px(sl, 32)
            ps = _apply_in_relu(ps, mj, ij, bp["in5"]["scale"], bp["in5"]["bias"], 4)
            rs = jconv2d(ps, bp["d3_w"])
            n = rs.shape[1] - 4
            return sum(rs[:, dy:dy + n, :, dy * 12:(dy + 1) * 12] for dy in range(5))

        top = _d3_strip(yj[:, :4])[:, :2]
        bot = _d3_strip(yj[:, -4:])[:, -2:]
        lef = _d3_strip(yj[:, :, :4])[:, :, :2]
        rig = _d3_strip(yj[:, :, -4:])[:, :, -2:]
        scf = bp["in5"]["scale"].astype(jnp.float32)
        bif = bp["in5"]["bias"].astype(jnp.float32)
        a5 = jnp.tile(ij * scf, (1, 4)) * qd["qin"]
        c5 = jnp.tile(bif - mj * ij * scf, (1, 4)) * qd["qin"]
        K = si8.d3_rows_site(yj, a5, c5, qd["w"].reshape(5, 128, -1), qd["ws"])
        rows = jnp.pad(K, ((0, 0), (2, 2), (0, 0), (0, 0)))
        out = sum(rows[:, dy:dy + hb, :, dy * 12:(dy + 1) * 12] for dy in range(5))
        out = out.at[:, :2].set(top).at[:, -2:].set(bot)
        out = out.at[:, :, :2].set(lef).at[:, :, -2:].set(rig)
        out = out + bp["d3_b"].astype(out.dtype)
        return s2dj.d2s(out, 2, 3).astype(jnp.float32)

    ref = _interpret(jax_branch)
    sites, _ = _port_sites(net, nb, quant, None)
    with torch.no_grad():
        ours = sites_i8.d3_forward(torch.from_numpy(y.copy()).to(torch.bfloat16), torch.from_numpy(m),
                                   torch.from_numpy(inv), nb, sites["d3"],
                                   use_d3_i8=True).float().numpy()
    assert ours.shape == ref.shape == (2, 2 * hb, 2 * wb, 3)
    inner = (slice(None), slice(4, -4), slice(4, -4))
    np.testing.assert_array_equal(ours[inner], ref[inner])
    frame = np.ones(ours.shape, bool)
    frame[inner] = False
    d = np.abs(ours - ref)[frame]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref[frame]).max())) - 7)
    assert d.max() <= 8 * ulp, (d.max() / ulp, (d > 0).mean())


def _jax_stylize(bp32, x, fused, static):
    """The JAX engine's stylize under ``fused`` (raw_01): its calibration and
    site filter, then ``apply`` with the set, the Pallas sites in interpret
    mode, and the clamp, under jit (XLA may contract to FMAs there, which
    flips isolated codes: the comparison is the 1e-2 gate). Returns
    (output, quant)."""
    stats, quant = _calibrate_jax(bp32, x, fused, static)
    bp = _bf16_params(bp32)

    def run():
        y = s2d2.apply(bp, jnp.asarray(x, jnp.bfloat16), quant=quant, static_stats=stats,
                       fused_sites=fused)
        return jnp.clip(y, 0.0, 1.0).astype(jnp.float32)

    return _interpret(jax.jit(run)), quant


def _port_stylize(net, x, mode, fused):
    from neuralstyletransferv1_torch.engine import stylizer as tst

    model = tst.StyleModel("johnson", net, "raw_01", "init")
    fn = tst.jit_stylizer(model, dtype=torch.bfloat16, quantize=mode, fused_sites=fused)
    return fn(torch.from_numpy(x)).numpy()


def test_config_a_stylize_matches_jax_engine(johnson, config_a, chain_a,  # noqa: F811
                                             monkeypatch):
    """Configuration A's whole stylize through ``jit_stylizer(fused_sites=
    SET_A)``, calibrating itself on frame 0, against the JAX engine's (the
    clamped ``chain_a``, from the JAX engine's calibration and conv1):
    within the repo's 1e-2 MAE gate — the port's bf16 pixel conv1 differs
    from the JAX space-to-depth conv1 by isolated ulps, which flip codes
    downstream. The sites run exactly as often as on the card."""
    _, net, _ = johnson
    calls = _spy_launches(monkeypatch)
    got = _port_stylize(net, config_a["x"], "int8_static", SET_A)
    ref = np.clip(chain_a, 0.0, 1.0)
    assert got.shape == ref.shape == config_a["x"].shape
    mae = float(np.abs(got - ref).mean())
    assert mae <= 1e-2, mae
    assert float(got.std()) > 0.05
    assert {k: v for k, v in calls.items() if v} == {
        "c2_site": 1, "c3_site": 1, "res_site_s8o": 5, "site_s8": 7, "d3_s8_site": 1}


def test_config_b_stylize_matches_jax_engine(johnson, monkeypatch):  # noqa: F811
    """Configuration B (``--quantize int8``, SET_B) through
    ``jit_stylizer(fused_sites=SET_B)`` against ``transformer_net_s2d2.apply``
    with the same set after the JAX engine's calibration: within the 1e-2
    gate, with K8a 1, K8b 1, K4 7, K5 5 and K7 1 per forward."""
    bp32, net, _ = johnson
    x = _video(1, 32, 64, seed=8)
    ref, quant = _jax_stylize(bp32, x, SET_B, static=False)
    assert {"c2", "c3", "d3"} <= set(quant)
    calls = _spy_launches(monkeypatch)
    got = _port_stylize(net, x, "int8", SET_B)
    assert got.shape == ref.shape == x.shape
    mae = float(np.abs(got - ref).mean())
    assert mae <= 1e-2, mae
    assert float(got.std()) > 0.05
    assert {k: v for k, v in calls.items() if v} == {
        "c2_site": 1, "c3_site": 1, "res_site": 7, "res_site_skip": 5, "d3_rows_site": 1}


def test_below_the_head_and_tail_gates(johnson, monkeypatch):  # noqa: F811
    """24×48 under configuration A: the head gate fails at the calibration
    size, so c2/c3 stay bf16; the tail gate passes there, so d3 is
    quantized, but the res and decoder gates fail at run time (res grid
    6×12), so d3 runs as the bf16 tap-packed conv with the baked weights and
    the res blocks, d1 and d2 as int8 sites in the XLA form (no kernel
    wrapper is called) — where the JAX engine does the same. Within 1e-2 of
    it."""
    bp32, net, _ = johnson
    x = _video(1, 24, 48, seed=9)
    ref, quant = _jax_stylize(bp32, x, SET_A, static=True)
    assert "d3" in quant and "c2" not in quant and "c3" not in quant
    calls = _spy_launches(monkeypatch)
    got = _port_stylize(net, x, "int8_static", SET_A)
    mae = float(np.abs(got - ref).mean())
    assert mae <= 1e-2, mae
    assert {k: v for k, v in calls.items() if v} == {}


@pytest.mark.parametrize("static", [True, False])
def test_decoder_without_a_dec_site_runs_the_xla_form(johnson, monkeypatch,  # noqa: F811
                                                      static):
    """A set that names neither ``dec_i8`` nor ``dec_s8`` (``("res_i8",)``)
    at 32×64, where ``dec_supported`` passes (res grid 8×16): the JAX
    ``apply`` runs d1 and d2 as XLA ``_qc`` sites, with in4/in5 from the
    tensors' statistics, and so does the port — ``dec_d1_qc`` and
    ``dec_d2_qc`` once each, and d1/d2 never reach K4 (the launch spy sees
    the res chain only: K4 6, K5 4). Both start from the JAX head's output
    (the port's ``encode`` returns it), the JAX side run op by op with the
    Pallas res chain in interpret mode. With frozen norms deconv3's
    activated input is bit-identical (on this input: interpret-mode Pallas
    may contract a quantize into an FMA and flip an isolated code on
    others). With measured norms the res chain's and the decoder's
    statistics are summed in each framework's own order, which flips
    codes (this input: 96.5% of deconv3's input equal), so it is held to
    the mean |Δ| of the below-gate chain test in ``test_torch_bf16_sites.py``
    (2e-3; measured 1.7e-4). The whole forward (the bf16 deconv3s differ in
    summation order) meets the file's 1e-2 gate."""
    from neuralstyletransferv1_torch.models.s2d import apply_in_relu

    bp32, _, nb = johnson
    fused = ("res_i8",)
    x = _video(2, 32, 64, seed=24)
    assert sites_i8.dec_supported(8, 16)
    stats, quant = _calibrate_jax(bp32, x, fused, static)
    assert {"d1", "d2"} <= set(quant) and "c2" not in quant and "d3" not in quant
    bp = _bf16_params(bp32)
    seen = {}
    res_chain = si8.res_chain

    def spy_res_chain(y, *a, **kw):
        seen["res_in"] = y
        return res_chain(y, *a, **kw)

    monkeypatch.setattr(si8, "res_chain", spy_res_chain)

    def run():
        return s2d2.apply(bp, jnp.asarray(x, jnp.bfloat16), quant=quant, static_stats=stats,
                          fused_sites=fused,
                          tap=lambda s, t: seen.__setitem__(s, t) if s == "d3" else None)

    ref = _interpret(run).astype(np.float32)
    ref_d3 = np.asarray(seen["d3"].astype(jnp.float32))

    q, st = quant_from_jax(quant, stats)
    sites = sites_i8.prepare_sites(nb, q, "cpu")
    calls = _spy_launches(monkeypatch)
    dec = {}
    for name in ("dec_d1_qc", "dec_d2_qc"):
        def spy(*a, _fn=getattr(sites_i8, name), _name=name, **kw):
            dec[_name] = _fn(*a, **kw)
            return dec[_name]

        monkeypatch.setattr(sites_i8, name, spy)
    y0 = torch.from_numpy(np.array(seen["res_in"].astype(jnp.float32))).to(torch.bfloat16)
    monkeypatch.setattr(nb, "encode", lambda *a, **kw: y0)
    with torch.no_grad():
        out = tq.forward_int8(nb, torch.from_numpy(x).to(torch.bfloat16), sites, st,
                              fused_sites=fused).float().numpy()
        r2, m5, inv5 = dec["dec_d2_qc"]
        ours_d3 = apply_in_relu(r2, m5, inv5, nb.in5.weight, nb.in5.bias, 4).float().numpy()
    assert set(dec) == {"dec_d1_qc", "dec_d2_qc"}
    assert {k: v for k, v in calls.items() if v} == {"res_site": 6, "res_site_skip": 4}
    assert ours_d3.shape == ref_d3.shape == (2, 16, 32, 128)
    if static:
        np.testing.assert_array_equal(ours_d3, ref_d3)
    else:
        assert np.abs(ours_d3 - ref_d3).mean() <= 2e-3
    assert out.shape == ref.shape == x.shape
    mae = float(np.abs(np.clip(out, 0, 1) - np.clip(ref, 0, 1)).mean())
    assert mae <= 1e-2, mae


# ---------------------------------------------------------------------------
# the site sets and the gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [SET_A, SET_B, ("res_i8", "dec_i8"),
                                   ("res_i8", "res_s8", "dec_i8"), ("head_i8", "res_i8")])
@pytest.mark.parametrize("hw", [(32, 64), (24, 48), (1080, 1920), (36, 96)])
def test_site_filter_matches_jax(fused, hw):
    from neuralstyletransferv1_tpu.engine import stylizer as jst

    scales = {k: 1.0 for k in tq.QUANT_SITES_PALLAS}
    ref = jst._s2d2_site_filter(scales, np.zeros((1, *hw, 3), np.float32), sites=fused)
    assert sorted(tq.site_filter(scales, *hw, fused)) == sorted(ref)


def test_default_sets_are_int8_sites():
    scales = {k: 1.0 for k in tq.QUANT_SITES_PALLAS}
    for static in (True, False):
        kept = tq.site_filter(scales, 1080, 1920, tq.default_sites(static))
        assert sorted(kept) == sorted(tq.INT8_SITES)


def test_geometry_gates_match_jax():
    for h in range(2, 70, 1):
        for w in (8, 16, 24, 30, 32, 48, 60, 64, 96, 120, 240, 480, 960):
            assert sites_i8.res_supported(h, w) == si8.res_supported(h, w), (h, w)
            assert sites_i8.dec_supported(h, w) == si8.dec_supported(h, w), (h, w)
            assert sites_i8.head_supported(h, w) == si8.head_supported(h, w), (h, w)
            assert sites_i8.d3_supported(h, w) == si8.d3_supported(h, w), (h, w)
            assert sites_i8.d3s8_supported(h, w) == si8.d3s8_supported(h, w), (h, w)
    assert sites_i8.head_supported(540, 960) and sites_i8.d3s8_supported(540, 960)
    assert sites_i8.dec_supported(270, 480) and sites_i8.d3_supported(540, 960)


def test_adopted_sets_match_jax(tmp_path):
    """The port's ``adopt_overrides.sites`` reads its copy of ``i8_adopt.json``
    over the same defaults as the JAX package; a tuple in the JSON replaces
    the default wholesale, and a missing key keeps it."""
    import json

    from neuralstyletransferv1_tpu import adopt_overrides as jadopt
    from neuralstyletransferv1_torch import adopt_overrides as tadopt

    for key in ("sites", "sites_static", "t7", "t7_bn"):
        assert tadopt.sites(key) == jadopt.sites(key), key
    assert tadopt.sites("sites_static") == ("res_i8", "res_s8", "dec_i8")
    f = tmp_path / "i8_adopt.json"
    f.write_text(json.dumps({"sites": ["head_i8", "res_i8"]}))
    assert tadopt.sites("sites", f) == ("head_i8", "res_i8")
    assert tadopt.sites("sites_static", f) == tadopt.DEFAULTS["sites_static"]
    with pytest.raises(KeyError):
        tadopt.sites("magenta")


@pytest.mark.parametrize("fused,err", [(("head", "res_i8"), None),
                                       (("res_i8", "tail"), None),
                                       (("d3",), None),
                                       ((), NotImplementedError),
                                       (("res_i9",), ValueError)])
def test_unported_site_names_raise(fused, err):
    """The empty set (every site in the XLA-int8 form) and unknown names
    raise; the bf16 site names ``head``, ``tail`` and ``d3`` are accepted."""
    if err is None:
        assert tq.check_fused_sites(fused) == fused
    else:
        with pytest.raises(err):
            tq.check_fused_sites(fused)
