"""The NST_Train net of the PyTorch port vs the JAX package, on the CPU.

Weight import from the reference key layout; the reference-form net
(``transformer_net_nst.apply``) and the fast form the JAX engine runs
(``transformer_net_nst_fast.apply``: f32, bf16, frozen norms); calibration;
K2 and K3 in their zero-halo, ``sw``-masked forms (plain versions vs the
interpret-mode Pallas kernels, at a res width of 36 padded to 40 as the
1080p grid's 500 pads to 504, and an aligned control); the ``int8_static``
s8 chain (bit-exact against the op-by-op XLA reference, and against the JAX
Pallas chain within the JAX test's own bound); the quantized stylizes within
the repo's 1e-2 gate; and an NST slot through the CLI. The kernels
themselves run only on the card (``tests/test_torch_policy.py``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from neuralstyletransferv1_tpu.engine import pipeline as jpipe
from neuralstyletransferv1_tpu.engine import stylizer as jst
from neuralstyletransferv1_tpu.io import checkpoints as jckpt
from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_tpu.models import transformer_net_nst as jn
from neuralstyletransferv1_tpu.models import transformer_net_nst_fast as jf
from neuralstyletransferv1_torch.engine import pipeline as tpipe
from neuralstyletransferv1_torch.engine import stylizer as tst
from neuralstyletransferv1_torch.io import checkpoints as tckpt
from neuralstyletransferv1_torch.kernels import int8_sites as k8
from neuralstyletransferv1_torch.models import transformer_net_nst as tn
from neuralstyletransferv1_torch.models import transformer_net_nst_fast as tf

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this file: in the six-worker tier-1 run
    the workers share the cores, and a multi-threaded pool then waits at
    each op's barrier for threads other workers preempt."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                        if hasattr(a, "astype") and a.dtype == jnp.float32 else a, tree)


@pytest.fixture(scope="module")
def nst():
    """The JAX package's random NST weights (``transformer_net_nst.init``,
    as its tests use them), its fast-form params, and the port's f32 and
    bf16 nets with the same weights."""
    tree = jax.tree.map(np.asarray, jn.init(jax.random.key(3)))
    net = tn.TransformerNetNST()
    net.load_state_dict(tn.params_from_jax(tree))
    net = net.eval().requires_grad_(False)
    nb = copy.deepcopy(net).to(torch.bfloat16)
    return {"tree": tree, "fp": jf.from_nst_params(tree), "net": net, "nb": nb}


def _x(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _ref_sd(seed=0):
    """A state dict in the reference NST_Train key layout."""
    return tn.init(seed)


# ---------------------------------------------------------------------------
# weights and the two net forms
# ---------------------------------------------------------------------------


def test_import_matches_jax_and_round_trips(tmp_path):
    sd = _ref_sd(1)
    np_sd = {k: v.numpy() for k, v in sd.items()}
    assert tckpt.detect_transformer_arch(np_sd) == jckpt.detect_transformer_arch(np_sd) == "nst"
    ours, ref = tckpt.import_transformer_nst(np_sd), jckpt.import_transformer_nst(np_sd)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    assert [p for p, _ in flat(ours)] == [p for p, _ in flat(ref)]
    for (_, a), (_, b) in zip(flat(ours), flat(ref)):
        assert a.shape == b.shape and np.array_equal(a, b)
    back = tn.params_from_jax(ours)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    path = tmp_path / "nst.pth"
    torch.save(sd, path)
    for preset, want in (("auto", "raw_01"), ("imagenet_255", "raw_01"), ("raw_255", "raw_01"),
                         ("caffe_bgr", "caffe_bgr")):
        m = tst.load_model(path, io_preset=preset)
        assert (m.arch, m.io_preset) == ("nst", want)
        assert jst.load_model(path, io_preset=preset).io_preset == want
    assert all(torch.equal(m.net.state_dict()[k], sd[k]) for k in sd)


def test_reference_net_matches_jax(nst):
    x = _x((1, 48, 64, 3), 0)
    ref = np.asarray(jax.jit(lambda t: jn.apply(jax.tree.map(jnp.asarray, nst["tree"]), t))(x))
    ours = nst["net"](torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (1, 48, 64, 3)
    assert np.abs(ours - ref).mean() <= 1e-5


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_fast_form_matches_jax(nst, dtype, bound):
    """f32: measured 2.8e-6. bf16 on the clipped [0,1] output (the
    stylize's): measured 2.2e-3 — the same function in other rounding
    orders, amplified by the random net."""
    x = _x((1, 48, 64, 3), 1)
    if dtype == "float32":
        ref = np.asarray(jax.jit(lambda t: jf.apply(nst["fp"], t))(x))
        ours = tf.apply(nst["net"], torch.from_numpy(x)).numpy()
    else:
        pb = _bf16(nst["fp"])
        ref = np.asarray(jax.jit(lambda t: jf.apply(pb, t))(jnp.asarray(x, jnp.bfloat16))
                         .astype(jnp.float32))
        ours = tf.apply(nst["nb"], torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
        ref, ours = np.clip(ref, 0, 1), np.clip(ours, 0, 1)
    assert np.abs(ours - ref).mean() <= bound


def test_calibration_matches_jax(nst):
    x = _x((1, 48, 64, 3), 2)
    js = jf.calibrate_in_stats(nst["fp"], jnp.asarray(x))
    ts = tf.calibrate_in_stats(nst["net"], torch.from_numpy(x))
    assert sorted(js) == sorted(ts) and len(ts) == 15
    for k in js:
        for a, b in zip(ts[k], js[k]):
            b = np.asarray(b)
            assert a.shape == b.shape
            assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max(), k
    for stats in (None, ts):
        jsc = jf.calibrate_act_scales(
            nst["fp"], jnp.asarray(x),
            static_stats=None if stats is None else {k: tuple(jnp.asarray(t.numpy()) for t in v)
                                                     for k, v in stats.items()})
        tsc = tf.calibrate_act_scales(nst["net"], torch.from_numpy(x), static_stats=stats)
        assert sorted(jsc) == sorted(tsc)
        assert all(abs(tsc[k] - jsc[k]) <= 1e-5 * jsc[k] for k in jsc)
    q = tf.quantize_net(nst["net"], tsc)
    jq = jf.quantize_net(nst["fp"], tsc)
    assert sorted(q) == sorted(tf.RES_SITES + tf.BLOCK_SITES) == sorted(jq)
    for k in q:
        assert np.array_equal(q[k]["w"].numpy(), np.asarray(jq[k]["w"]))
        assert np.array_equal(q[k]["ws"].numpy(), np.asarray(jq[k]["ws"]))
        assert q[k]["qin"] == float(jq[k]["qin"])


# ---------------------------------------------------------------------------
# K2 and K3, zero halo and sw: plain versions vs interpret-mode Pallas
# ---------------------------------------------------------------------------

H, C = 8, 32


def _site_inputs(seed, w):
    rng = np.random.default_rng(seed)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {
        "x": bf(rng.normal(0, 2, (1, H, w, C))), "y": bf(rng.normal(0, 1, (1, H, w, C))),
        "a": f32(rng.uniform(5, 40, (1, C))), "c": f32(rng.normal(0, 8, (1, C))),
        "w": rng.integers(-127, 128, (3, 3, C, C)).astype(np.int8),
        "ws": f32(rng.uniform(0.5, 2, C) / (127 * 127 * 12)), "bias": f32(rng.normal(0, 0.2, C)),
        "qa": f32(rng.uniform(10, 60, C)), "qc": f32(rng.normal(0, 10, C)),
        "aa": f32(rng.uniform(0.5, 1.5, C)), "ac": f32(rng.normal(0, 0.3, C)),
        "codes": rng.integers(0, 128, (1, H, w, C)).astype(np.int8),
    }


def _interpret(fn, *args, **kw):
    si8._INTERPRET = True
    try:
        return np.asarray(fn(*args, **kw))
    finally:
        si8._INTERPRET = False


def _t(d, k):
    v = torch.from_numpy(d[k].copy())
    return v.to(torch.bfloat16) if k in ("x", "y") else v


# (padded width, sw): the 1080p form (500 → 504) at a small size, and the
# aligned control without a mask
WIDTHS = [(40, 36), (40, None)]


@pytest.mark.parametrize("w,sw", WIDTHS)
def test_k2_zero_halo_sw_matches_pallas(w, sw):
    d = _site_inputs(11, w)
    if sw is not None:  # the chain's carry is zero beyond sw; junk must not matter
        d["x"][:, :, sw:] = 7.0
    ref = _interpret(si8.res_site_s8o, jnp.asarray(d["x"], jnp.bfloat16), jnp.asarray(d["a"]),
                     jnp.asarray(d["c"]), jnp.asarray(d["w"]).reshape(9, C, C),
                     jnp.asarray(d["ws"]), jnp.asarray(d["bias"]), qa=jnp.asarray(d["qa"]),
                     qc=jnp.asarray(d["qc"]), lo=-127.0, qlo=0.0, halo="zero", sw=sw)
    ours = k8.res_site_s8o(_t(d, "x"), _t(d, "a"), _t(d, "c"), -127.0,
                           k8.pack_weights(_t(d, "w")), _t(d, "ws"), _t(d, "bias"),
                           _t(d, "qa"), _t(d, "qc"), halo="zero", sw=sw)
    assert ours.dtype == torch.int8
    assert np.array_equal(ours.numpy(), ref[:, :, 1:w + 1])
    if sw is not None:
        assert not ours[:, :, sw:].any()
        assert ours[:, :, :sw].any()


@pytest.mark.parametrize("w,sw", WIDTHS)
@pytest.mark.parametrize("form", ["aff_add", "s8out"])
def test_k3_zero_halo_sw_matches_pallas(w, sw, form):
    """K3 as the NST chain runs it (frozen affine + residual add, bf16 out)
    and with the s8 emit, whose codes beyond sw are masked."""
    d = _site_inputs(12, w)
    if sw is not None:
        d["codes"][:, :, sw:] = 0  # K2's output form
    carry = si8._s8_col_halo(jnp.asarray(d["codes"][0]), w, si8._wps(w), "zero")[None]
    kw = {}
    if form == "s8out":
        kw = {"qa": jnp.asarray(d["qa"] / 20), "qc": jnp.asarray(d["qc"] / 20), "qlo": -127.0}
    ref = _interpret(si8.site_s8, carry, jnp.asarray(d["w"]).reshape(9, C, C),
                     jnp.asarray(d["ws"]), jnp.asarray(d["bias"]), w0=w,
                     y=jnp.asarray(d["y"], jnp.bfloat16),
                     aff=(jnp.asarray(d["aa"]), jnp.asarray(d["ac"])), halo="zero", sw=sw, **kw)
    tkw = {k: torch.from_numpy(np.asarray(v).copy()) if k != "qlo" else v for k, v in kw.items()}
    ours = k8.site_s8(torch.from_numpy(d["codes"]), k8.pack_weights(_t(d, "w")), _t(d, "ws"),
                      _t(d, "bias"), _t(d, "aa"), _t(d, "ac"), _t(d, "y"), halo="zero", sw=sw,
                      **tkw)
    if form == "s8out":
        assert ours.dtype == torch.int8
        assert np.array_equal(ours.numpy(), ref[:, :, 1:w + 1])
        if sw is not None:
            assert not ours[:, :, sw:].any()
    else:
        assert ours.dtype == torch.bfloat16
        assert np.array_equal(ours.float().numpy(), ref.astype(np.float32))


def test_sw_needs_the_zero_halo():
    d = _site_inputs(13, 40)
    args = (_t(d, "x"), _t(d, "a"), _t(d, "c"), -127.0, k8.pack_weights(_t(d, "w")),
            _t(d, "ws"), _t(d, "bias"), _t(d, "qa"), _t(d, "qc"))
    with pytest.raises(ValueError, match="zero halo"):
        k8.res_site_s8o(*args, halo="reflect", sw=36)
    with pytest.raises(ValueError, match="zero halo"):
        k8.site_s8(torch.from_numpy(d["codes"]), *args[4:7], halo="edge", sw=36)


# ---------------------------------------------------------------------------
# the int8 res chains
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def calib(nst):
    """Frozen stats and the static int8 calibration of the JAX fast form at
    (1, 48, 64): the res grid is 32 × 36 (non-%8, as 1080p's 290 × 500)."""
    x = _x((1, 48, 64, 3), 6)
    stats = jf.calibrate_in_stats(nst["fp"], jnp.asarray(x))
    quant = jf.quantize_net(nst["fp"], jf.calibrate_act_scales(nst["fp"], jnp.asarray(x),
                                                                static_stats=stats))
    tstats = {k: tuple(torch.from_numpy(np.asarray(t).copy()) for t in v)
              for k, v in stats.items()}
    tquant = {k: {"w": torch.from_numpy(np.asarray(v["w"]).copy()),
                  "ws": torch.from_numpy(np.asarray(v["ws"]).copy()),
                  "qin": float(v["qin"])} for k, v in quant.items() if k in tf.RES_SITES}
    return {"x": x, "stats": stats, "quant": quant, "tstats": tstats,
            "sites": tf.prepare_sites(nst["nb"], tquant, CPU)}


def _res_input(w, seed=7):
    """An activated res-chain input [1, 32, w, 128] bf16 (ReLU'd, O(1))."""
    y = np.maximum(np.random.default_rng(seed).normal(0.2, 1.0, (1, 32, w, 128)), 0)
    return np.asarray(jnp.asarray(y, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("w", [36, 40])
def test_s8_chain_matches_op_by_op_xla(nst, calib, w):
    """The int8_static chain (K2/K3 plain versions, zero halo, sw = 36 on the
    padded 40) bit for bit against ``_res_quant_xla`` with frozen norms run
    op by op (eager: no FMA contraction between the ops)."""
    y = _res_input(w)
    with jax.disable_jit():
        ref = np.asarray(jf._res_quant_xla(jnp.asarray(y, jnp.bfloat16), _bf16(nst["fp"]),
                                           calib["quant"], calib["stats"]).astype(jnp.float32))
    ours = tf.res_chain_s8_static(torch.from_numpy(y).to(torch.bfloat16), nst["nb"],
                                  calib["sites"], calib["tstats"])
    assert tuple(ours.shape) == (1, 32, w, 128)
    assert np.array_equal(ours.float().numpy(), ref)
    xla = tf.res_quant_xla(torch.from_numpy(y).to(torch.bfloat16), nst["nb"], calib["sites"],
                           calib["tstats"])
    assert torch.equal(xla, ours)


def test_s8_chain_vs_pallas_chain(nst, calib):
    """Against the JAX Pallas chain (``_res_chain_s8_static`` in interpret
    mode, which contracts FMAs) within the bound tests/test_static_norm.py
    holds that chain to against XLA."""
    y = _res_input(36, seed=8)
    si8._INTERPRET = True
    try:
        ref = np.asarray(jf._res_chain_s8_static(jnp.asarray(y, jnp.bfloat16), _bf16(nst["fp"]),
                                                 calib["quant"], calib["stats"])
                         .astype(jnp.float32))
    finally:
        si8._INTERPRET = False
    ours = tf.res_chain_s8_static(torch.from_numpy(y).to(torch.bfloat16), nst["nb"],
                                  calib["sites"], calib["tstats"]).float().numpy()
    d = np.abs(ours - ref)
    assert d.mean() / (np.abs(ref).mean() + 1e-6) < 2e-4 and d.max() < 0.1, (d.mean(), d.max())


def _spy(monkeypatch):
    calls = {"res_site_s8o": 0, "site_s8": 0, "res_site": 0, "res_site_skip": 0}
    for name in calls:
        fn = getattr(k8, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(k8, name, spy)
    return calls


@pytest.mark.parametrize("quantize,launches", [
    ("none", 0), ("bf16_static", 0), ("int8", 0), ("int8_static", 5)])
def test_stylize_modes_match_jax(nst, tmp_path, monkeypatch, quantize, launches):
    """Each NST stylize mode through ``jit_stylizer`` (bf16) against the JAX
    engine's on the CPU, within the 1e-2 gate; under int8_static the port
    runs the adopted ``res_s8`` chain (5 × K2 + 5 × K3 per forward, sw = 36)
    where the JAX CPU engine runs its XLA reference; --quantize int8 runs
    the XLA-form chain of the empty adopted set in both."""
    path = tmp_path / "nst.pth"
    torch.save(nst["net"].state_dict(), path)
    x = _x((2, 48, 64, 3), 9)
    calls = _spy(monkeypatch)
    fn = tst.jit_stylizer(tst.load_model(path), dtype=torch.bfloat16, quantize=quantize)
    ours = fn(torch.from_numpy(x)).numpy()
    jfn = jst.jit_stylizer(jst.load_model(path), dtype=jnp.bfloat16,
                           quantize=quantize if quantize != "none" else "none")
    ref = np.asarray(jfn(jnp.asarray(x)))
    assert ours.shape == ref.shape == (2, 48, 64, 3)
    assert np.abs(ours - ref).mean() <= 1e-2
    assert calls["res_site_s8o"] == calls["site_s8"] == launches
    assert calls["res_site"] == calls["res_site_skip"] == 0


@pytest.mark.parametrize("quantize,base", [("int8", "none"), ("int8_static", "bf16_static")])
def test_quantized_stylize_quality_vs_bf16(nst, tmp_path, quantize, base):
    """Each int8 mode within the 1e-2 gate of the bf16 stylize with the same
    norms (measured or frozen), as tests/test_static_norm.py gates the JAX
    NST int8_static (measured 6.3e-3 and 6.4e-3 on this random net and
    input)."""
    path = tmp_path / "nst.pth"
    torch.save(nst["net"].state_dict(), path)
    model = tst.load_model(path)
    x = torch.from_numpy(_x((2, 48, 64, 3), 10))
    ref = tst.jit_stylizer(model, dtype=torch.bfloat16, quantize=base)(x)
    out = tst.jit_stylizer(model, dtype=torch.bfloat16, quantize=quantize)(x)
    assert (out - ref).abs().mean() <= 1e-2


def test_unported_nst_sites_raise(nst, calib):
    """Every name the JAX NST forward routes on runs; what still raises is
    an unknown name, and a site form outside the ported kernel forms (the
    2×2 taps under another halo or pad, K5's 2×2 taps)."""
    xb = torch.from_numpy(_x((1, 48, 64, 3), 3)).to(torch.bfloat16)
    with pytest.raises(ValueError, match="unknown"):
        tf.apply(nst["nb"], xb, fused_sites=("head",))
    with pytest.raises(ValueError, match="unknown"):
        tf.apply(nst["nb"], xb, sites=calib["sites"], fused_sites=("res_i8", "d3_i8"))
    s = calib["sites"]["r1a"]
    x = torch.zeros((1, 8, 16, 128), dtype=torch.bfloat16)
    rows = (torch.ones((1, 128)), torch.zeros((1, 128)))
    with pytest.raises(NotImplementedError, match="Queue 2"):
        k8.res_site(x, *rows, -127.0, s.wk, s.ws, s.bias, halo="reflect", kh=2, kw=2, pt=1,
                    pl_=1)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        k8.res_site_skip(x, x, *rows, *rows, -127.0, s.wk, s.ws, s.bias, halo="zero", kh=2,
                         kw=2, pt=0, pl_=0)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        k8.site_s8(x.to(torch.int8), s.wk, s.ws, s.bias, halo="zero", kh=3, kw=3, pt=0, pl_=0)


def test_nst_slot_through_the_cli(nst, tmp_path):
    """An NST checkpoint (reference keys) through both engines' main() in the
    single-image mode, f32: within 1 level at >= 99% of the values."""
    path = tmp_path / "nst.pth"
    torch.save(nst["net"].state_dict(), path)
    src = tmp_path / "in.png"
    Image.fromarray((_x((64, 96, 3), 4) * 255).astype(np.uint8)).save(src)
    a, b = tmp_path / "torch.png", tmp_path / "jax.png"
    argv = ["--input_image", str(src), "--model", str(path)]
    assert tpipe.main(argv + ["--output_image", str(a), "--device", "cpu",
                              "--work_dir", str(tmp_path / "_wt")]) == 0
    assert jpipe.main(argv + ["--output_image", str(b), "--work_dir", str(tmp_path / "_wj")]) == 0
    ua = np.asarray(Image.open(a), np.int32)
    ub = np.asarray(Image.open(b), np.int32)
    d = np.abs(ua - ub)
    assert ua.shape == (64, 96, 3) and (d <= 1).mean() >= 0.99 and ua.std() > 1.0
