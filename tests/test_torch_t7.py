"""Torch7 ``.t7`` slots in the PyTorch port vs the JAX package, on the CPU.

The nets are the JAX tests' eccv16-shaped layer lists
(``tests/test_t7_fast.py``: c0 = 8, 3 residual blocks, BN-folded or
instance-norm, deconv k = 3 or 4) written to ``.t7`` bytes with
``tests/test_t7.py``'s ``T7Writer``. Held against the JAX package from the
same numpy seeds: the reader and the layer list (bit for bit), the exact
executor, the fast form's parameters (bit for bit) and forward, calibration,
quantization and the static-norm fold, K4/K5's zero-halo plain versions
against the interpret-mode Pallas kernels, the ``res_i8`` and PyTorch-int8
res chains, the stylize modes, routing, and a ``.t7`` slot through the CLI.
The kernels themselves run only on the card (``tests/test_torch_policy.py``).

Outputs of whole nets are compared on the [0,1] frame scale (the raw
tanh·150 output / 255, what ``caffe_bgr`` postprocesses), as MAE.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_t7_fast as jt7_tests
import torch
from PIL import Image
from test_t7 import T7Writer
from test_torch_int8 import _interpret, _jax, _torch, assert_bf16_close, assert_sums_close
from test_torch_int8 import _inputs as _site_inputs

import chip_smoke
from neuralstyletransferv1_tpu.engine import pipeline as jpipe
from neuralstyletransferv1_tpu.engine import stylizer as jst
from neuralstyletransferv1_tpu.io import t7 as jt7
from neuralstyletransferv1_tpu.io import t7_fast as jf
from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_torch import adopt_overrides
from neuralstyletransferv1_torch.engine import pipeline as tpipe
from neuralstyletransferv1_torch.engine import stylizer as tst
from neuralstyletransferv1_torch.io import t7 as tt7
from neuralstyletransferv1_torch.io import t7_fast as tf
from neuralstyletransferv1_torch.kernels import int8_sites as k8
from neuralstyletransferv1_torch.models import s2d

CPU = torch.device("cpu")
NORMS = ["bn", "in"]


def _layers(norm: str = "bn", deconv_k: int = 3, seed: int = 7) -> list:
    """``_johnson_layers`` (every batchnorm swapped for ``_in`` on the IN
    form, as the JAX tests swap them), drawn from a generator seeded here."""
    saved = jt7_tests.rng
    jt7_tests.rng = np.random.default_rng(seed)
    try:
        ls = jt7_tests._johnson_layers(deconv_k=deconv_k)
        if norm == "in":
            swap = lambda l: jt7_tests._in(l["weight"].shape[0]) \
                if l["op"] == "batchnorm" else l  # noqa: E731
            ls = [swap(l) for l in ls]
            for l in ls:
                if l["op"] == "concat_table":
                    l["branches"][0][:] = [swap(b) for b in l["branches"][0]]
    finally:
        jt7_tests.rng = saved
    return ls


def _write(path, layers):
    """``layers`` as ``.t7`` bytes through the JAX tests' ``T7Writer``."""
    _, name, state = chip_smoke.t7_modules(layers)
    with open(path, "wb") as f:
        T7Writer(f).module(name, state)
    return path


def _x(shape, seed, scale=50.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


def _frames(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _eq(a, b, path="", sub=False):
    """Two trees (dicts, lists, arrays / tensors, python values) equal, arrays
    bit for bit; with ``sub`` b's dicts may hold more keys (a layer list as
    written against the list read back, which names every absent array)."""
    if isinstance(a, dict):
        assert set(a) <= set(b) if sub else set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _eq(a[k], b[k], f"{path}/{k}", sub)
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{path}[{i}]", sub)
    elif hasattr(a, "shape") or hasattr(b, "shape"):
        bb = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert np.array_equal(np.asarray(a), bb) and np.asarray(a).shape == bb.shape, path
    else:
        assert a == b, (path, a, b)


def _bf16(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                        if hasattr(a, "astype") and a.dtype == jnp.float32 else a, tree)


def _mae01(ours, ref) -> float:
    """MAE of two raw outputs on the [0,1] frame scale."""
    return float(np.abs(np.asarray(ours, np.float64) - np.asarray(ref, np.float64)).mean()) / 255


# ---------------------------------------------------------------------------
# the reader, the layer list and the exact executor
# ---------------------------------------------------------------------------


def _reflect_net():
    """``tests/test_t7.py``'s reflect-padded two-conv net."""
    rng = np.random.default_rng(5)
    return [{"op": "reflect_pad", "pad": 1},
            {"op": "conv", "w": rng.standard_normal((3, 3, 3, 8)).astype(np.float32) * 0.2,
             "b": rng.standard_normal(8).astype(np.float32) * 0.1, "stride": (1, 1),
             "pad": (0, 0)}, {"op": "relu"}, {"op": "reflect_pad", "pad": 1},
            {"op": "conv", "w": rng.standard_normal((3, 3, 8, 3)).astype(np.float32) * 0.2,
             "b": rng.standard_normal(3).astype(np.float32) * 0.1, "stride": (1, 1),
             "pad": (0, 0)}]


def _residual_net():
    """``tests/test_t7.py``'s ConcatTable{branch, Identity} + CAddTable."""
    rng = np.random.default_rng(9)
    branch = [{"op": "reflect_pad", "pad": 1},
              {"op": "conv", "w": rng.standard_normal((3, 3, 4, 4)).astype(np.float32) * 0.2,
               "b": rng.standard_normal(4).astype(np.float32) * 0.1, "stride": (1, 1),
               "pad": (0, 0)}]
    return [{"op": "concat_table", "branches": [branch, []]}, {"op": "add_table"}]


NETS = {"reflect": (_reflect_net, 3), "residual": (_residual_net, 4),
        "johnson_bn": (lambda: _layers("bn"), 3), "johnson_in": (lambda: _layers("in"), 3),
        "johnson_k4": (lambda: _layers("bn", deconv_k=4), 3)}


@pytest.mark.parametrize("net", list(NETS))
def test_reader_and_layers_match_jax(net, tmp_path):
    """``load_t7`` + ``build_t7_layers`` give the JAX package's layer dicts,
    arrays bit for bit; they are the layers written."""
    layers = NETS[net][0]()
    path = _write(tmp_path / "net.t7", layers)
    ours = tt7.build_t7_layers(tt7.load_t7(str(path)))
    _eq(jt7.build_t7_layers(jt7.load_t7(str(path))), ours)
    _eq(layers, ours, sub=True)


def test_reader_on_independent_handwritten_bytes(tmp_path):
    """The byte fixture of ``tests/test_t7.py`` (written straight from the
    torch7 serialization spec, not by a writer): both readers give the same
    objects."""
    import io
    import struct

    buf = io.BytesIO()
    w_int = lambda v: buf.write(struct.pack("<i", v))  # noqa: E731
    w_long = lambda v: buf.write(struct.pack("<q", v))  # noqa: E731

    def w_raw(s):
        b = s.encode()
        w_int(len(b))
        buf.write(b)

    def w_string(s):
        w_int(2)
        w_raw(s)

    def w_number(v):
        w_int(1)
        buf.write(struct.pack("<d", v))

    w_int(3); w_int(1); w_int(5)                            # noqa: E702 root table, 5 entries
    w_number(1)
    w_int(4); w_int(2); w_raw("V 1"); w_raw("torch.FloatTensor")  # noqa: E702
    w_int(2); w_long(2); w_long(3); w_long(3); w_long(1); w_long(1)  # noqa: E702
    w_int(4); w_int(3); w_raw("V 1"); w_raw("torch.FloatStorage"); w_long(6)  # noqa: E702
    buf.write(np.arange(6, dtype="<f4").tobytes())
    w_string("name"); w_string("candy")                     # noqa: E702
    w_string("scale"); w_number(0.5)                        # noqa: E702
    w_string("flag"); w_int(5); buf.write(b"\x01\x00\x00\x00")  # noqa: E702
    w_string("net"); w_int(4); w_int(4); w_raw("V 1"); w_raw("nn.ReLU")  # noqa: E702
    w_int(3); w_int(5); w_int(1)                            # noqa: E702
    w_string("inplace"); w_int(5); buf.write(b"\x00\x00\x00\x00")  # noqa: E702
    p = tmp_path / "handwritten.t7"
    p.write_bytes(buf.getvalue())

    ours, ref = tt7.load_t7(str(p)), jt7.load_t7(str(p))
    assert ours["name"] == ref["name"] == "candy" and ours["scale"] == ref["scale"] == 0.5
    assert ours["flag"] is True and ref["flag"] is True
    _eq(ref[1.0], ours[1.0])
    assert ours["net"].torch_typename == "nn.ReLU" and ours["net"].get("inplace") is False


def test_smoke_writer_bytes_load_like_t7writer(tmp_path):
    """``chip_smoke.write_t7`` (the card machine has no JAX, so the smoke has
    its own writer) gives bytes that JAX ``load_t7`` reads into the same
    layers as ``T7Writer``'s, at the smoke's full width, BN and IN."""
    for norm in NORMS:
        layers = chip_smoke.t7_net_layers(3, norm, c0=16, nres=2)
        a = chip_smoke.write_t7(tmp_path / f"smoke_{norm}.t7", layers)
        b = _write(tmp_path / f"writer_{norm}.t7", layers)
        got = jt7.build_t7_layers(jt7.load_t7(str(a)))
        _eq(jt7.build_t7_layers(jt7.load_t7(str(b))), got)
        _eq(layers, got, sub=True)


@pytest.mark.parametrize("net", ["reflect", "residual", "johnson_bn", "johnson_in"])
def test_t7_apply_matches_jax(net):
    """The exact executor in f32 within 1e-5 MAE of JAX's on the [0,1]
    scale (measured ≤ 3.1e-7: XLA's rsqrt is not correctly rounded, and this
    random net amplifies its ulp differences), and 1e-4 at the worst pixel."""
    make, c = NETS[net]
    layers = make()
    x = _x((2, 32, 64, c), 0)
    ref = np.asarray(jt7.t7_apply(layers, jnp.asarray(x)))
    ours = tt7.t7_apply(layers, torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    assert _mae01(ours, ref) <= 1e-5 and np.abs(ours - ref).max() / 255 <= 1e-4


# ---------------------------------------------------------------------------
# the fast form: parameters, forward, calibration, quantization, static fold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm,deconv_k", [("bn", 3), ("in", 3), ("bn", 4), ("in", 4)])
def test_fast_params_match_jax(norm, deconv_k):
    layers = _layers(norm, deconv_k)
    ref = jf.try_fast_johnson(layers)
    ours = tf.try_fast_johnson(layers)
    assert ref is not None and ours is not None
    _eq(ref, ours)
    assert tf.has_deferred_norms(ours) == (norm == "in")
    w = np.random.default_rng(1).normal(0, 1, (3, 3, 5, 7)).astype(np.float32)
    assert np.array_equal(s2d.stride2_pixel_weight(s2d.scatter_stride2_f2(w)), w)


def test_reflect_padded_net_keeps_the_exact_executor():
    assert tf.try_fast_johnson([{"op": "reflect_pad", "pad": 4}] + _layers()) is None
    assert tf.try_fast_johnson(_reflect_net()) is None


@pytest.fixture(scope="module", params=NORMS)
def t7net(request):
    layers = _layers(request.param, seed=11)
    jp, tp = jf.try_fast_johnson(layers), tf.try_fast_johnson(layers)
    return {"norm": request.param, "layers": layers, "jp": jp, "tp": tp, "jpb": _bf16(jp),
            "tpb": tf.params_to(tp, CPU, torch.bfloat16)}


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_fast_forward_matches_jax(t7net, dtype, bound):
    """``t7_fast_apply`` against JAX's, MAE on the [0,1] scale: f32 within
    1e-5 (measured 7e-9 BN, 4e-7 IN), bf16 within the 1e-2 gate (5.0e-4,
    6.9e-4); f32 also against the
    exact executor (the JAX tests' 1e-3 on the raw scale)."""
    x = _x((2, 32, 64, 3), 2)
    p = t7net["tp"] if dtype == "float32" else t7net["tpb"]
    jp = t7net["jp"] if dtype == "float32" else t7net["jpb"]
    ours = tf.t7_fast_apply(p, torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    ref = np.asarray(jf.t7_fast_apply(jp, jnp.asarray(x, getattr(jnp, dtype)))
                     .astype(jnp.float32))
    assert ours.shape == ref.shape == (2, 32, 64, 3)
    assert _mae01(ours, ref) <= bound
    if dtype == "float32":
        exact = tt7.t7_apply(t7net["layers"], torch.from_numpy(x)).numpy()
        assert np.abs(ours - exact).mean() < 1e-3


@pytest.fixture(scope="module")
def calib(t7net):
    """Both packages' calibrations on one model-space batch; the port's
    quantization of the JAX scales (so that codes compare), its sites."""
    x = _x((2, 32, 64, 3), 4)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    out = {"x": x, "scales_j": jf.calibrate_t7_scales(t7net["jp"], xj),
           "scales_t": tf.calibrate_t7_scales(t7net["tp"], xt)}
    out["quant_j"] = jf.quantize_t7(t7net["jp"], out["scales_j"])
    out["quant_t"] = tf.quantize_t7(t7net["tp"], out["scales_j"])
    out["sites"] = tf.prepare_sites(t7net["tpb"], out["quant_t"], CPU)
    if t7net["norm"] == "in":
        out["stats_j"] = jf.calibrate_t7_in_stats(t7net["jp"], xj)
        out["stats_t"] = tf.calibrate_t7_in_stats(t7net["tp"], xt)
    return out


def test_calibration_and_quantization_match_jax(t7net, calib):
    """Scales to a relative 1e-6, the int8 weights of the same scales bit for
    bit (codes, ws, qin); on the IN form the frozen statistics to 1e-5 and
    ``fold_static_in`` of the same statistics bit for bit."""
    sj, st = calib["scales_j"], calib["scales_t"]
    assert sorted(sj) == sorted(st) == sorted([f"r{i}{ab}" for i in range(3) for ab in "ab"]
                                              + ["c2", "d1", "d2", "d3"])
    for k in sj:
        assert abs(st[k] - sj[k]) <= 1e-6 * sj[k], k
    for k, q in calib["quant_j"].items():
        t = calib["quant_t"][k]
        assert np.array_equal(np.asarray(q["w"]), t["w"].numpy()), k
        assert np.array_equal(np.asarray(q["ws"]), t["ws"].numpy()), k
        assert float(q["qin"]) == t["qin"], k
    if t7net["norm"] == "bn":
        assert not tf.has_deferred_norms(t7net["tp"])
        return
    assert sorted(calib["stats_j"]) == sorted(calib["stats_t"])
    for k, (m, inv) in calib["stats_j"].items():
        tm, tinv = calib["stats_t"][k]
        np.testing.assert_allclose(tm.numpy(), np.asarray(m), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tinv.numpy(), np.asarray(inv), rtol=1e-5)
    same = {k: (torch.from_numpy(np.asarray(m)), torch.from_numpy(np.asarray(inv)))
            for k, (m, inv) in calib["stats_j"].items()}
    folded = tf.fold_static_in(t7net["tp"], same)
    _eq(jf.fold_static_in(t7net["jp"], calib["stats_j"]), folded)
    assert not tf.has_deferred_norms(folded)


# ---------------------------------------------------------------------------
# K4 / K5 with the zero halo: plain versions vs the interpret-mode Pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("lo,affine", [(-127.0, False), (0.0, True), (0.0, False)])
def test_k4_zero_halo_matches_pallas(c, lo, affine):
    """K4 ``halo="zero"``: the a-site form (qin, no shift, floor −127) and
    the b-site form (floor 0) with and without an IN affine (a nonzero c,
    where the halo's code 0 differs from round(c))."""
    d = _site_inputs(50 + c, c=c, co=c)
    if not affine:
        d["a"] = np.full_like(d["a"], 30.0)
        d["c"] = np.zeros_like(d["c"])
    ref, sout = _interpret(si8.res_site, _jax(d, "x"), _jax(d, "a"), _jax(d, "c"),
                           _jax(d, "w").reshape(9, c, c), _jax(d, "ws"), _jax(d, "bias"), lo,
                           halo="zero")
    ours, sums = k8.res_site(*(_torch(d, k) for k in ("x", "a", "c")), lo,
                             *(_torch(d, k) for k in ("w", "ws", "bias")), halo="zero")
    assert_bf16_close(ours, ref)
    assert_sums_close(sums, ours, sout, ref, 8 * 16)
    if affine:  # the halo is code 0, not the quantized zero: that would differ
        x = torch.nn.functional.pad(_torch(d, "x").float(), (0, 0, 1, 1, 1, 1))
        q = k8._quantize(x, _torch(d, "a"), _torch(d, "c"), lo)
        acc = k8.conv2d_i8(q, torch.from_numpy(d["w"]))
        other = (acc.float() * _torch(d, "ws") + _torch(d, "bias")).to(torch.bfloat16)
        assert not torch.equal(other, ours)


@pytest.mark.parametrize("lo", [-127.0, 0.0])
def test_k5_zero_halo_matches_pallas(lo):
    d = _site_inputs(60)
    ref, sout, vref = _interpret(
        si8.res_site_skip, _jax(d, "x"), _jax(d, "y"), *(_jax(d, k) for k in ("a", "c", "a2", "c2")),
        _jax(d, "w").reshape(9, 32, 32), _jax(d, "ws"), _jax(d, "bias"), lo, halo="zero")
    ours, sums, v = k8.res_site_skip(*(_torch(d, k) for k in ("x", "y", "a", "c", "a2", "c2")),
                                     lo, *(_torch(d, k) for k in ("w", "ws", "bias")),
                                     halo="zero")
    assert_bf16_close(v, vref)
    assert_bf16_close(ours, ref)
    assert_sums_close(sums, ours, sout, ref, 8 * 16)


# ---------------------------------------------------------------------------
# the res chains
# ---------------------------------------------------------------------------


def _res_input(seed=7):
    """A res-chain input (2 × 8 × 16 × 32), bf16-representable."""
    y = np.random.default_rng(seed).normal(0, 1.5, (2, 8, 16, 32)).astype(np.float32)
    return np.asarray(jnp.asarray(y, jnp.bfloat16).astype(jnp.float32))


def _rel(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).mean() / np.abs(ref).mean())


def test_res_chains_match_jax(t7net, calib):
    """``_t7_res_quant_xla`` against JAX's run op by op, and ``_t7_res_chain_i8``
    (K4/K5's plain versions) against JAX's Pallas chain in interpret mode.
    BN-folded: the quantize affines are constants, so the PyTorch-int8 chain
    is bit for bit JAX's, and the K4/K5 chain bit for bit the PyTorch-int8
    one; the Pallas chain (interpret mode contracts acc·ws + bias to an FMA)
    within 2e-3 relative. IN: the statistics are f32 sums in another order,
    so a code may flip (ROADMAP Queue 3): within 1e-2 relative, the gate."""
    y = _res_input()
    yj, yt = jnp.asarray(y, jnp.bfloat16), torch.from_numpy(y).to(torch.bfloat16)
    with jax.disable_jit():
        ref_x = np.asarray(jf._t7_res_quant_xla(yj, t7net["jpb"]["res"], calib["quant_j"])
                           .astype(jnp.float32))
    si8._INTERPRET = True
    try:
        ref_p = np.asarray(jf._t7_res_chain_i8(yj, t7net["jpb"]["res"], calib["quant_j"])
                           .astype(jnp.float32))
    finally:
        si8._INTERPRET = False
    ours_x = tf._t7_res_quant_xla(yt, t7net["tpb"]["res"], calib["sites"])
    ours_i = tf._t7_res_chain_i8(yt, t7net["tpb"]["res"], calib["sites"])
    assert ours_x.dtype == ours_i.dtype == torch.bfloat16 and tuple(ours_i.shape) == y.shape
    if t7net["norm"] == "bn":
        assert np.array_equal(ours_x.float().numpy(), ref_x)
        assert torch.equal(ours_i, ours_x)
        assert _rel(ours_i.float().numpy(), ref_p) <= 2e-3
    else:
        assert _rel(ours_x.float().numpy(), ref_x) <= 1e-2
        assert _rel(ours_i.float().numpy(), ref_p) <= 1e-2


def test_int8_forward_matches_jax(t7net, calib):
    """The whole int8 forward under ``res_i8`` (K4/K5's plain versions): JAX's
    own gates (``tests/test_int8.py``) — against the PyTorch-int8 route MAE
    < 0.05 on the raw tanh·150 scale, against the f32 forward within 5% of
    its mean magnitude — and against JAX's forward (its Pallas chain in
    interpret mode) within the 1e-2 gate on the [0,1] scale: the bf16 head
    convs round differently in the two packages, so a code may flip."""
    x = calib["x"]
    xb = jnp.asarray(x, jnp.bfloat16)
    si8._INTERPRET = True
    try:
        ref = np.asarray(jf.t7_fast_apply(t7net["jpb"], xb, quant=calib["quant_j"],
                                          fused_sites=("res_i8",)).astype(jnp.float32))
    finally:
        si8._INTERPRET = False
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ours = tf.t7_fast_apply(t7net["tpb"], xt, sites=calib["sites"],
                            fused_sites=("res_i8",)).float().numpy()
    xla = tf.t7_fast_apply(t7net["tpb"], xt, sites=calib["sites"]).float().numpy()
    assert np.abs(ours - xla).mean() < 0.05
    f32 = np.asarray(jf.t7_fast_apply(t7net["jp"], jnp.asarray(x)))
    assert np.abs(ours - f32).mean() < 0.05 * np.abs(f32).mean()
    assert _mae01(ours, ref) <= 1e-2


# ---------------------------------------------------------------------------
# routing, the adopted sets, the stylize modes and the CLI
# ---------------------------------------------------------------------------


def test_adopted_t7_sets(tmp_path):
    """``t7`` (IN graphs) keeps the JAX default ``res_i8``; the JSON's
    ``t7_bn`` is empty (every quantized conv in PyTorch int8 ops) and wins
    over its default."""
    assert adopt_overrides.sites("t7") == ("res_i8",)
    assert adopt_overrides.sites("t7_bn") == ()
    empty = tmp_path / "empty.json"
    empty.write_text("{}")
    assert adopt_overrides.sites("t7_bn", path=empty) == ("res_i8",)


def _spy(monkeypatch):
    calls = {"res_site": 0, "res_site_skip": 0, "chain_i8": 0, "chain_xla": 0}
    for name in ("res_site", "res_site_skip"):
        fn = getattr(k8, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(k8, name, spy)
    for key, name in (("chain_i8", "_t7_res_chain_i8"), ("chain_xla", "_t7_res_quant_xla")):
        fn = getattr(tf, name)

        def spy(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tf, name, spy)
    return calls


@pytest.mark.parametrize("norm,quantize,launches", [
    ("in", "int8", {"res_site": 4, "res_site_skip": 2, "chain_i8": 1}),
    ("in", "int8_static", {"chain_xla": 1}),
    ("bn", "int8", {"chain_xla": 1}),
    ("bn", "int8_static", {"chain_xla": 1})])
def test_launch_routing(tmp_path, monkeypatch, norm, quantize, launches):
    """The adopted sets through ``jit_stylizer``: an IN graph's ``int8`` runs
    the K4/K5 chain (3 blocks: 4 × K4 + 2 × K5), its ``int8_static`` the
    folded graph on ``t7_bn`` (the PyTorch-int8 chain, no site kernel), as
    does a BN graph's ``int8`` (and its ``int8_static``, which runs as
    int8)."""
    path = _write(tmp_path / "net.t7", _layers(norm, seed=13))
    calls = _spy(monkeypatch)
    fn = tst.jit_stylizer(tst.load_model(path), dtype=torch.bfloat16, quantize=quantize)
    out = fn(torch.from_numpy(_frames((1, 32, 64, 3), 1)))
    assert out.shape == (1, 32, 64, 3) and bool(torch.isfinite(out).all())
    assert calls == {**dict.fromkeys(calls, 0), **launches}


def test_unported_and_unknown_sites_raise(t7net, calib):
    x = torch.from_numpy(calib["x"]).to(torch.bfloat16)
    for name in ("res_s8", "dec_s8", "dec_i8", "tail_s8", "c2_i8", "dec_xla_i8", "tail_xla_i8"):
        with pytest.raises(NotImplementedError, match="Queue 2"):
            tf.t7_fast_apply(t7net["tpb"], x, sites=calib["sites"], fused_sites=("res_i8", name))
    with pytest.raises(ValueError, match="unknown"):
        tf.t7_fast_apply(t7net["tpb"], x, fused_sites=("head_i8",))


def test_fused_chain_below_the_gate_runs_bf16(t7net, calib, monkeypatch):
    """A requested ``res_i8`` chain that ``res_supported`` refuses (a res grid
    of 4 × 8) runs the bf16 blocks, never the PyTorch-int8 chain, as the
    JAX forward routes it."""
    calls = _spy(monkeypatch)
    x = torch.from_numpy(_x((1, 16, 32, 3), 5)).to(torch.bfloat16)
    out = tf.t7_fast_apply(t7net["tpb"], x, sites=calib["sites"], fused_sites=("res_i8",))
    plain = tf.t7_fast_apply(t7net["tpb"], x)
    assert torch.equal(out, plain) and calls == dict.fromkeys(calls, 0)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("dtype,quantize", [
    ("float32", "none"), ("bfloat16", "none"), ("bfloat16", "bf16_static"),
    ("bfloat16", "int8"), ("bfloat16", "int8_static")])
def test_stylize_modes_match_jax(tmp_path, norm, dtype, quantize):
    """Each mode through ``jit_stylizer`` on a written ``.t7`` against the
    JAX engine's on the CPU, [0,1] frames: f32 within 1e-5 MAE, the rest
    within the 1e-2 gate (under int8 an IN graph runs the K4/K5 chain's plain
    versions where the JAX CPU engine runs its XLA-int8 chain). A BN graph's
    static modes fall back as the JAX engine's do. Also a 6 × 6 frame, which
    runs the exact executor. Measured: f32 ≤ 1.5e-7, bf16 and bf16_static ≤
    2.2e-3, int8 and int8_static ≤ 3.7e-3."""
    path = _write(tmp_path / "net.t7", _layers(norm, seed=17))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for shape in ((2, 32, 64, 3), (1, 6, 6, 3)):
        x = _frames(shape, 9)
        ours = tst.jit_stylizer(tst.load_model(path), dtype=tdt, quantize=quantize)(
            torch.from_numpy(x)).numpy()
        ref = np.asarray(jst.jit_stylizer(jt7.load_torch7_model(str(path)), dtype=jdt,
                                          quantize=quantize)(jnp.asarray(x)))
        assert ours.shape == ref.shape == shape
        assert np.abs(ours - ref).mean() <= (1e-5 if dtype == "float32" else 1e-2), shape
        assert float(ours.std()) > 0.01


def test_t7_slot_through_the_cli(tmp_path):
    """A ``.t7`` slot through both engines' main() in the single-image mode,
    f32: by its suffix (the preset ``auto`` → ``caffe_bgr``) within 1 level
    at >= 99% of the values of JAX's; by ``--model_type torch7`` on a file
    of another suffix, the same image; without ``--device cpu`` the port
    needs CUDA."""
    path = _write(tmp_path / "net.t7", _layers("in", seed=19))
    other = tmp_path / "net.bin"
    shutil.copy(path, other)
    src = tmp_path / "in.png"
    Image.fromarray((_frames((64, 96, 3), 4) * 255).astype(np.uint8)).save(src)
    a, b, c = tmp_path / "torch.png", tmp_path / "jax.png", tmp_path / "torch7.png"
    argv = ["--input_image", str(src), "--model", str(path)]
    cpu = ["--device", "cpu"]
    assert tpipe.main(argv + ["--output_image", str(a), "--work_dir", str(tmp_path / "_a")]
                      + cpu) == 0
    assert jpipe.main(argv + ["--output_image", str(b), "--work_dir", str(tmp_path / "_b")]) == 0
    assert tpipe.main(["--input_image", str(src), "--model", str(other), "--model_type",
                       "torch7", "--output_image", str(c), "--work_dir", str(tmp_path / "_c")]
                      + cpu) == 0
    ua, ub, uc = (np.asarray(Image.open(p), np.int32) for p in (a, b, c))
    assert ua.shape == (64, 96, 3) and (np.abs(ua - ub) <= 1).mean() >= 0.99 and ua.std() > 1.0
    assert np.array_equal(ua, uc)
    assert tst.load_model(path).io_preset == "caffe_bgr"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tpipe.main(argv + ["--output_image", str(a)])
