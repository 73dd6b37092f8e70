"""The Torch7 fast form's s8 carries (``res_s8``, ``dec_s8``, ``tail_s8``) in
the PyTorch port against the JAX package, on the CPU.

The nets are the JAX tests' eccv16-shaped layer lists (``tests/
test_t7_fast.py``) at the real width c0 = 32 (the res chain at C = 128,
deconv1 128 → 4·64, deconv2 64 → 4·32: the forms the card runs), cut to two
residual blocks, BN-folded with k3 or k4 transposed convs. The port runs
its sites' plain versions, the JAX chains their Pallas sites in interpret
mode. The chains compare bit for bit: against the Pallas chains with every
scale (qin, ws) a power of two, where an FMA that interpret mode contracts
rounds as the separate operations do, and against the JAX XLA references
run op by op at the calibrated scales (the JAX s8 chains are bit-exact
against those by design). Whole forwards under each name are held to the
JAX XLA-reference forward at tests/test_int8.py's 5% bound, with their
kernel launches counted; every fallback of the routing is checked. The
kernels run only on the card (``tests/test_torch_s8_carry_card.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_t7_fast as jt7_tests
import torch

from neuralstyletransferv1_tpu.io import t7_fast as jf
from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_torch.io import t7_fast as tf
from neuralstyletransferv1_torch.kernels import int8_sites as k8

CPU = torch.device("cpu")
C0 = 32  # eccv16's width: the res chain at 4·c0 = 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this file: in the six-worker tier-1 run
    the workers share the cores, and a multi-threaded pool then waits at
    each op's barrier for threads other workers preempt."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layers(norm: str, k: int, seed: int = 31) -> list:
    """``_johnson_layers(C=32)`` with two residual blocks; ``norm`` "in"
    swaps every batchnorm for ``_in``, "dec_in" only the two deconvs'."""
    saved = jt7_tests.rng
    jt7_tests.rng = np.random.default_rng(seed)
    try:
        ls = jt7_tests._johnson_layers(C=C0, deconv_k=k)
        del ls[9:11]  # one of the three residual blocks
        swap = lambda l: jt7_tests._in(l["weight"].shape[0]) \
            if l["op"] == "batchnorm" else l  # noqa: E731
        if norm == "in":
            ls = [swap(l) for l in ls]
            for l in ls:
                if l["op"] == "concat_table":
                    l["branches"][0][:] = [swap(b) for b in l["branches"][0]]
        elif norm == "dec_in":
            ls = [swap(l) if i > 0 and ls[i - 1]["op"] == "conv_transpose" else l
                  for i, l in enumerate(ls)]
    finally:
        jt7_tests.rng = saved
    return ls


def _bf16(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                        if hasattr(a, "astype") and a.dtype == jnp.float32 else a, tree)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 50, shape).astype(np.float32)


def _p2(quant: dict) -> dict:
    """``quant`` with every qin and ws rounded to a power of two."""
    p2 = lambda v: np.float32(2.0) ** np.round(np.log2(np.asarray(v, np.float32)))  # noqa: E731
    return {k: {"w": v["w"], "ws": jnp.asarray(p2(v["ws"]), jnp.float32),
                "qin": jnp.float32(p2(v["qin"]))} for k, v in quant.items()}


def _sites(tpb: dict, quant: dict) -> dict:
    """The port's sites of a JAX ``quant`` (the same int8 weights and
    scales)."""
    tq = {k: {"w": torch.from_numpy(np.asarray(v["w"]).copy()),
              "ws": torch.from_numpy(np.asarray(v["ws"], np.float32).copy()),
              "qin": float(v["qin"])} for k, v in quant.items()}
    return tf.prepare_sites(tpb, tq, CPU)


@functools.cache
def _net(norm: str, k: int) -> dict:
    """One net in both packages' fast forms (f32 and bf16), a 1 × 32 × 64
    model-space frame (the res grid 8 × 16, the decoder's doubled grid
    16 × 32), the JAX ``quant`` of the JAX scales and the port's sites of it,
    and the same with power-of-two scales."""
    layers = _layers(norm, k)
    jp, tp = jf.try_fast_johnson(layers), tf.try_fast_johnson(layers)
    x = _x((1, 32, 64, 3), 4)
    quant = jf.quantize_t7(jp, jf.calibrate_t7_scales(jp, jnp.asarray(x)))
    tpb = tf.params_to(tp, CPU, torch.bfloat16)
    q2 = _p2(quant)
    return {"jp": jp, "tp": tp, "jpb": _bf16(jp), "tpb": tpb, "x": x, "quant": quant,
            "sites": _sites(tpb, quant), "q2": q2, "sites2": _sites(tpb, q2)}


def _res_input(seed: int) -> np.ndarray:
    """A res-chain input (1 × 8 × 16 × 128), O(1), bf16-representable."""
    y = np.random.default_rng(seed).normal(0, 1.5, (1, 8, 16, 4 * C0))
    return np.asarray(jnp.asarray(y, jnp.bfloat16).astype(jnp.float32))


def _np(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32)) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


def _interpret(fn, *a, **kw):
    si8._INTERPRET = True
    try:
        return fn(*a, **kw)
    finally:
        si8._INTERPRET = False


# ---------------------------------------------------------------------------
# the chains
# ---------------------------------------------------------------------------


def test_res_s8_chain_matches_jax():
    """``_t7_res_chain_i8_s8c`` (K2 → K3 per block): with ``emit_qo`` at
    power-of-two scales bit for bit the JAX Pallas chain in interpret mode
    (block 1's K3 adds the residual in bf16, block 2's emits deconv1's codes:
    the content columns of the JAX carry); bf16 out at the calibrated scales
    bit for bit JAX's ``_t7_res_quant_xla`` run op by op, and the port's
    PyTorch-int8 chain."""
    net = _net("bn", 3)
    y = _res_input(7)
    yj, yt = jnp.asarray(y, jnp.bfloat16), torch.from_numpy(y).to(torch.bfloat16)
    res_j, res_t = net["jpb"]["res"], net["tpb"]["res"]
    qo = net["q2"]["d1"]["qin"]
    ref_q = np.asarray(_interpret(jf._t7_res_chain_i8_s8c, yj, res_j, net["q2"], emit_qo=qo))
    ours_q = tf._t7_res_chain_i8_s8c(yt, res_t, net["sites2"], emit_qo=float(qo))
    assert ours_q.dtype == torch.int8 and np.array_equal(ours_q.numpy(), ref_q[:, :, 1:17])
    assert (ours_q < 0).any() and (ours_q > 0).any()
    with jax.disable_jit():
        ref_x = jf._t7_res_quant_xla(yj, res_j, net["quant"])
    ours = tf._t7_res_chain_i8_s8c(yt, res_t, net["sites"])
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == y.shape
    assert np.array_equal(_np(ours), _np(ref_x))
    assert torch.equal(tf._t7_res_quant_xla(yt, res_t, net["sites"]), ours)


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("tail", [False, True], ids=["dec_s8", "tail_s8"])
def test_dec_s8_matches_jax(k, tail):
    """``_t7_dec_i8_s8`` on the res chain's codes (d1: K3 2×2 pad 0 for a k3
    deconv, 3×3 pad 1 for a k4; d2 the same; with ``tail`` the ``zero2``
    emit into K6): at power-of-two scales bit for bit the JAX Pallas pair in
    interpret mode; at the calibrated scales bit for bit the port's
    PyTorch-int8 references on the chain's bf16 output (quantize commutes
    with the shuffle), and (the tail case, through both) those against
    JAX's run op by op."""
    net = _net("bn", k)
    y = _res_input(8)
    yt = torch.from_numpy(y).to(torch.bfloat16)
    s2 = net["sites2"]
    xq = tf._t7_res_chain_i8_s8c(yt, net["tpb"]["res"], s2, emit_qo=s2["d1"].qin)
    carry = jnp.pad(jnp.asarray(xq.numpy()), ((0, 0), (0, 0), (1, si8._wps(16) - 17), (0, 0)))
    ref = _interpret(jf._t7_dec_i8_s8, carry, net["jpb"], net["q2"], C0, 16, jnp.bfloat16,
                     tail=tail)
    ours = tf._t7_dec_i8_s8(xq, net["tpb"], s2, torch.bfloat16, tail=tail)
    assert ours.dtype == torch.bfloat16
    assert tuple(ours.shape) == (1, 16, 32, 12 if tail else 4 * C0)
    assert np.array_equal(_np(ours), _np(ref))
    sites = net["sites"]
    xq = tf._t7_res_chain_i8_s8c(yt, net["tpb"]["res"], sites, emit_qo=sites["d1"].qin)
    yb = tf._t7_res_chain_i8_s8c(yt, net["tpb"]["res"], sites)
    ours = tf._t7_dec_i8_s8(xq, net["tpb"], sites, torch.bfloat16, tail=tail)
    xla = tf._t7_dec_quant_xla(yb, net["tpb"], sites, C0)
    if not tail:
        assert torch.equal(ours, xla)
        return
    with jax.disable_jit():
        ref = jf._t7_dec_quant_xla(jnp.asarray(yb.float().numpy(), jnp.bfloat16), net["jpb"],
                                   net["quant"], C0)
        ref3 = jf._t7_tail_quant_xla(ref, net["jpb"], net["quant"])
    assert np.array_equal(_np(xla), _np(ref))
    xla = tf._t7_tail_quant_xla(xla, net["tpb"], sites)
    assert torch.equal(ours, xla) and np.array_equal(_np(xla), _np(ref3))


# ---------------------------------------------------------------------------
# the forward under each name, and the routing
# ---------------------------------------------------------------------------


def _spy(monkeypatch):
    """Count the site wrappers' calls (each is a kernel launch on the card),
    by form."""
    calls = {}

    def wrap(name, fn):
        def spy(*a, **kw):
            form = name + (f"_k2p{kw['pt']}" if kw.get("kh", 3) == 2 else "")
            calls[form] = calls.get(form, 0) + 1
            return fn(*a, **kw)
        return spy

    for name in ("res_site", "res_site_skip", "res_site_s8o", "site_s8", "d3_s8_site"):
        monkeypatch.setattr(k8, name, wrap(name, getattr(k8, name)))
    return calls


def _forward(net, names, sites="sites", x=None):
    x = net["x"] if x is None else x
    return tf.t7_fast_apply(net["tpb"], torch.from_numpy(x).to(torch.bfloat16),
                            sites=None if sites is None else net[sites], fused_sites=names)


# name → (the port's set, the JAX forward's set: its XLA references of the
# s8 branches, the launches for a k3 / k4 net)
NAMES = {
    "res_s8": (("res_s8",), (), {"res_site_s8o": 2, "site_s8": 2}),
    "dec_s8": (("res_s8", "dec_s8"), ("dec_xla_i8",),
               {"res_site_s8o": 2, "site_s8": 2, "site_s8_k2p0": 2}),
    "tail_s8": (("res_s8", "dec_s8", "tail_s8"), ("dec_xla_i8", "tail_xla_i8"),
                {"res_site_s8o": 2, "site_s8": 2, "site_s8_k2p0": 2, "d3_s8_site": 1}),
}


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("name", list(NAMES))
def test_forward_matches_jax(monkeypatch, name, k):
    """The bf16 forward under ``name`` against the JAX forward on its XLA
    int8 references of the same branches (which the JAX s8 chains match bit
    for bit), within tests/test_int8.py's bound for the int8 res chain: mean
    < 5% of the exact output's mean magnitude (the heads round in other
    orders in the two packages and a flipped code spreads; measured ≤ 0.6%);
    each name runs exactly its kernels (a k4 net's deconvs are 3×3)."""
    ours_set, jset, launches = NAMES[name]
    net = _net("bn", k)
    if k == 4 and "site_s8_k2p0" in launches:
        launches = {**launches, "site_s8": 4}
        del launches["site_s8_k2p0"]
    calls = _spy(monkeypatch)
    out = _forward(net, ours_set).float().numpy()
    assert calls == launches
    ref = np.asarray(jf.t7_fast_apply(net["jpb"], jnp.asarray(net["x"], jnp.bfloat16),
                                      quant=net["quant"], fused_sites=jset), np.float32)
    exact = np.asarray(jf.t7_fast_apply(net["jp"], jnp.asarray(net["x"])), np.float32)
    assert out.shape == ref.shape == (1, 32, 64, 3)
    assert np.abs(out - ref).mean() < 0.05 * np.abs(exact).mean()


@functools.cache
def _in_folded():
    """The IN net's fold of its frozen statistics (the static-norm mode's
    graph, BN-folded in form) and the port's sites of its quantization."""
    net = _net("in", 3)
    xt = torch.from_numpy(net["x"])
    folded = tf.fold_static_in(net["tp"], tf.calibrate_t7_in_stats(net["tp"], xt))
    fb = tf.params_to(folded, CPU, torch.bfloat16)
    q = tf.quantize_t7(folded, tf.calibrate_t7_scales(folded, xt))
    return fb, tf.prepare_sites(fb, q, CPU)


# case → (net, the set, whether the forward equals the bf16 blocks', launches)
ROUTES = {
    "in: res_s8 alone runs the bf16 blocks": (("in", 3), ("res_s8",), True, {}),
    "in: res_s8 falls to res_i8": (("in", 3), ("res_i8", "res_s8", "dec_s8", "tail_s8"), False,
                                   {"res_site": 3, "res_site_skip": 1}),
    "in folded: res_s8 runs": ("folded", ("res_s8", "dec_s8", "tail_s8"), False,
                               {"res_site_s8o": 2, "site_s8": 2, "site_s8_k2p0": 2,
                                "d3_s8_site": 1}),
    "below res_supported: the bf16 blocks": (("bn", 3), ("res_s8", "dec_s8", "tail_s8"), True,
                                             {}),
    "dec_s8 without res_s8 falls to dec_i8": (("bn", 3), ("dec_s8", "dec_i8"), False,
                                              {"res_site_k2p0": 2}),
    "deconv norms: dec_s8 falls to dec_i8": (("dec_in", 3), ("res_s8", "dec_s8", "dec_i8"),
                                             False, {"res_site_s8o": 2, "site_s8": 2,
                                                     "res_site_k2p0": 2}),
    "tail_s8 without dec_s8": (("bn", 3), ("res_s8", "tail_s8"), False,
                               {"res_site_s8o": 2, "site_s8": 2}),
    "tail_s8 without a d3 site": (("bn", 3), ("res_s8", "dec_s8", "tail_s8"), False,
                                  {"res_site_s8o": 2, "site_s8": 2, "site_s8_k2p0": 2}),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_routing_fallbacks(monkeypatch, case):
    """Each s8 name runs only where the JAX forward routes it: ``res_s8`` on
    res blocks without deferred norms (an IN graph runs ``res_i8`` if named,
    else the bf16 blocks; once ``fold_static_in`` folds it, ``res_s8``),
    where ``res_supported`` takes the grid; ``dec_s8`` only on ``res_s8``'s
    carry and deconvs without deferred norms; ``tail_s8`` only on
    ``dec_s8`` with a d3 site. Elsewhere the next branch runs."""
    netkey, names, plain, launches = ROUTES[case]
    x = None
    if netkey == "folded":
        params, sites = _in_folded()
    else:
        net = _net(*netkey)
        params, sites = net["tpb"], dict(net["sites"])
        if "below" in case:
            x = _x((1, 16, 32, 3), 5)  # the res grid 4 × 8
        if "d3 site" in case:
            del sites["d3"]
    xt = torch.from_numpy(_net("bn", 3)["x"] if x is None else x).to(torch.bfloat16)
    calls = _spy(monkeypatch)
    out = tf.t7_fast_apply(params, xt, sites=sites, fused_sites=names)
    assert calls == launches
    assert bool(torch.isfinite(out).all())
    if plain:
        assert torch.equal(out, tf.t7_fast_apply(params, xt))
