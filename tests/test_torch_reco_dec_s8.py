"""ReCoNet's ``dec_s8`` (deconv1 + deconv2 on an s8 carry with frozen norms)
in the PyTorch port against the JAX package, on the CPU, for both norm
families (IN + ReLU, FRN + TLU).

The two kernel forms at the real widths on small grids, their plain versions
bit for bit against the Pallas sites in interpret mode at power-of-two
scales (an FMA that interpret mode contracts then rounds as the separate
operations do): K2 at C = 192 → CO = 384 under the edge halo emitting d2's
codes (IN: floor 0; FRN: the (CO,) ``tau`` floor row, floor −127), and K3 at
C = 96 → 192 under the edge halo with a bare bf16 raw out. The chain
``dec_s8_static``: bit for bit the JAX Pallas chain in interpret mode on a
net whose decoder norm scales, frozen inverse deviations and site scales are
powers of two, and at the calibrated scales bit for bit the port's
``dec_i8`` and ``dec_quant_xla`` under the same frozen norms (which
tests/test_torch_reconet.py holds to JAX's ``_dec_quant_xla`` run op by
op). The forward under
``bench.py``'s ``s8_sites`` set against the JAX forward on its XLA
references, at tests/test_int8.py's 5% bound, with its launches counted;
every fallback of the routing. The kernels run only on the card
(``tests/test_torch_s8_carry_card.py``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralstyletransferv1_tpu.io import checkpoints as jckpt
from neuralstyletransferv1_tpu.models import reconet_fast as jf
from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_torch.kernels import int8_sites as k8
from neuralstyletransferv1_torch.models import reconet as tr
from neuralstyletransferv1_torch.models import reconet_fast as tf
from neuralstyletransferv1_torch.models.s2d import d2s

CPU = torch.device("cpu")
#: bench.py's ReCoNet s8 set (``s8_sites``)
S8_SITES = ("res_s8", "res_i8", "dec_s8", "dec_i8")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this file: in the six-worker tier-1 run
    the workers share the cores, and a multi-threaded pool then waits at
    each op's barrier for threads other workers preempt."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _p2(rng, lo, hi, shape):
    return (2.0 ** rng.integers(lo, hi, shape)).astype(np.float32)


def _tree(frn: bool, seed: int = 3) -> dict:
    """The port's seeded ReCoNet weights in the reference layout
    (``reconet.init``) through the JAX package's importer, with every norm's
    affine (and TLU threshold) drawn; the decoder norms' scales are powers
    of two, so that the chain's rows are exact products."""
    tree = jckpt.import_reconet({k: v.numpy() for k, v in tr.init(seed, frn).items()})
    rng = np.random.default_rng(seed)

    def draw(n, p2=False):
        c = n["scale"].shape[0]
        n["scale"] = _p2(rng, -1, 2, c) if p2 else rng.uniform(0.5, 1.5, c).astype(np.float32)
        n["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
        if frn:
            n["tau"] = rng.uniform(-0.5, 0.0, c).astype(np.float32)

    for i, p in enumerate(tree["encoder"][:3] + tree["decoder"][:2]):
        draw(p["norm"], p2=i >= 3)
    for r in tree["encoder"][3:]:
        draw(r["norm1"])
        draw(r["norm2"])
        if frn:
            r["act"]["tau"] = rng.uniform(-0.5, 0.0, 192).astype(np.float32)
    return tree


def _tsites(fpb, quant: dict) -> dict:
    tq = {k: {"w": torch.from_numpy(np.asarray(v["w"]).copy()),
              "ws": torch.from_numpy(np.asarray(v["ws"], np.float32).copy()),
              "qin": float(v["qin"])} for k, v in quant.items()}
    return tf.prepare_sites(fpb, tq, CPU)


def _tstats(stats: dict) -> dict:
    return {k: tuple(torch.from_numpy(np.asarray(t, np.float32).copy()) for t in v)
            for k, v in stats.items()}


@pytest.fixture(scope="module", params=[False, True], ids=["in", "frn"])
def reco(request):
    """One net per norm family in both packages (the JAX fast params f32 and
    bf16, the port's fast form f32 and bf16), a 1 × 32 × 64 frame in
    [−1, 1] (the res grid 8 × 16, d2's 16 × 32), the port's frozen
    statistics and static activation scales of it, the JAX ``quant`` of
    those scales (both packages quantize from the same scales) and the
    port's sites of it; then the same with power-of-two site scales and
    frozen in4/in5 whose inverse deviations are powers of two."""
    frn = request.param
    tree = _tree(frn)
    net = tr.ReCoNet(frn)
    net.load_state_dict(tr.params_from_jax(tree))
    net = net.eval().requires_grad_(False)
    fp32 = tf.FastReCoNet(net)
    fpb = copy.deepcopy(fp32).to(torch.bfloat16)
    jfp = jf.from_reconet_params(tree)
    x = np.random.default_rng(6).random((1, 32, 64, 3)).astype(np.float32) * 2 - 1
    tstats = tf.calibrate_in_stats(fp32, torch.from_numpy(x))
    stats = {k: tuple(jnp.asarray(t.numpy()) for t in v) for k, v in tstats.items()}
    quant = jf.quantize_net(jfp, tf.calibrate_act_scales(fp32, torch.from_numpy(x),
                                                         static_stats=tstats))
    rng = np.random.default_rng(9)
    q2 = {k: {"w": quant[k]["w"], "ws": jnp.asarray(2.0 ** np.round(np.log2(
        np.asarray(quant[k]["ws"]))), jnp.float32),
        "qin": jnp.float32(2.0 ** np.round(np.log2(float(quant[k]["qin"]))))}
        for k in ("d1", "d2")}
    st2 = {"in4": (_bf(rng.normal(0, 0.3, (1, 96))), _p2(rng, -2, 2, (1, 96))),
           "in5": (_bf(rng.normal(0, 0.3, (1, 48))), _p2(rng, -2, 2, (1, 48)))}
    jpb = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                       if hasattr(a, "astype") and a.dtype == jnp.float32 else a, jfp)
    return {"frn": frn, "fp32": fp32, "fpb": fpb, "jpb": jpb, "x": x, "stats": stats,
            "tstats": tstats, "quant": quant, "sites": _tsites(fpb, quant), "q2": q2,
            "sites2": _tsites(fpb, q2), "st2": st2, "tst2": _tstats(st2)}


def _interpret(fn, *a, **kw):
    si8._INTERPRET = True
    try:
        return jax.tree.map(np.asarray, fn(*a, **kw))
    finally:
        si8._INTERPRET = False


def _res_out(frn, seed, shape=(1, 8, 16, 192)):
    """An activated res-chain output (ReLU'd, or TLU'd at −0.3), O(1), bf16."""
    y = np.random.default_rng(seed).normal(0.2, 1.0, shape)
    return _bf(np.maximum(y, -0.3 if frn else 0.0))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# the two kernel forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frn", [False, True], ids=["in", "frn"])
def test_k2_co384_edge_matches_pallas(frn):
    """K2 at C = 192 → CO = 384 under the edge halo (ReCoNet d1 emitting d2's
    codes): the IN emit (floor 0) and the FRN emit (the (CO,) pre-round
    floor row, floor −127), bit for bit the Pallas site's content columns."""
    rng = np.random.default_rng(40 + frn)
    x = _bf(rng.normal(0, 2, (1, 8, 16, 192)))
    a, c = _p2(rng, 2, 5, (1, 192)), _bf(rng.normal(0, 8, (1, 192)))
    w = rng.integers(-127, 128, (9, 192, 384)).astype(np.int8)
    ws, bias = _p2(rng, -18, -15, 384), _bf(rng.normal(0, 0.2, 384))
    qa, qc = _p2(rng, 3, 6, 384), _bf(rng.normal(0, 10, 384))
    tau = _bf(rng.normal(-20, 20, 384)) if frn else None
    qlo = -127.0 if frn else 0.0
    j = jnp.asarray
    ref = _interpret(si8.res_site_s8o, j(x, jnp.bfloat16), j(a), j(c), j(w), j(ws), j(bias),
                     qa=j(qa), qc=j(qc), tau=None if tau is None else j(tau), lo=-127.0,
                     qlo=qlo, halo="edge")
    t = torch.from_numpy
    wk = k8.pack_weights(t(w).reshape(3, 3, 192, 384))
    ours = k8.res_site_s8o(t(x).to(torch.bfloat16), t(a), t(c), -127.0, wk, t(ws), t(bias),
                           t(qa), t(qc), qlo=qlo, tau=None if tau is None else t(tau),
                           halo="edge")
    assert ours.dtype == torch.int8 and tuple(ours.shape) == (1, 8, 16, 384)
    assert np.array_equal(ours.numpy(), ref[:, :, 1:17])
    assert bool((ours < 0).any()) == frn and (ours > 0).any()


def test_k3_c96_edge_matches_pallas():
    """K3 at C = 96 → CO = 192 under the edge halo with a bare bf16 raw out
    (ReCoNet d2 on the s8 carry), bit for bit the Pallas site."""
    rng = np.random.default_rng(50)
    codes = rng.integers(-127, 128, (1, 16, 32, 96)).astype(np.int8)
    w = rng.integers(-127, 128, (9, 96, 192)).astype(np.int8)
    ws, bias = _p2(rng, -18, -15, 192), _bf(rng.normal(0, 0.2, 192))
    carry = si8._s8_col_halo(jnp.asarray(codes[0]), 32, si8._wps(32), "edge")[None]
    ref = _interpret(si8.site_s8, carry, jnp.asarray(w), jnp.asarray(ws), jnp.asarray(bias),
                     w0=32, halo="edge")
    t = torch.from_numpy
    ours = k8.site_s8(t(codes), k8.pack_weights(t(w).reshape(3, 3, 96, 192)), t(ws), t(bias),
                      halo="edge")
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (1, 16, 32, 192)
    assert np.array_equal(_np(ours), ref.astype(np.float32))


# ---------------------------------------------------------------------------
# the chain and the forward
# ---------------------------------------------------------------------------


def test_dec_s8_chain_matches_jax(reco):
    """``dec_s8_static``: with power-of-two scales and frozen inverse
    deviations, bit for bit the JAX Pallas ``_dec_s8_static`` in interpret
    mode (its block-form output moved to pixels by ``d2s``); at the
    calibrated scales and frozen norms equal to the port's ``dec_i8`` and
    ``dec_quant_xla`` under the same norms, which tests/test_torch_reconet.py
    holds bit for bit to JAX's ``_dec_quant_xla`` run op by op."""
    frn = reco["frn"]
    y = _res_out(frn, 10)
    yj, yt = jnp.asarray(y, jnp.bfloat16), torch.from_numpy(y).to(torch.bfloat16)
    ref = _interpret(jf._dec_s8_static, yj, reco["jpb"], reco["q2"], frn, reco["st2"],
                     jnp.bfloat16)
    ours = tf.dec_s8_static(yt, reco["fpb"], reco["sites2"], reco["tst2"])
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (1, 32, 64, 48)
    assert np.array_equal(_np(ours), d2s(torch.from_numpy(ref.astype(np.float32)), 2, 48)
                          .numpy())
    ours = tf.dec_s8_static(yt, reco["fpb"], reco["sites"], reco["tstats"])
    assert torch.equal(tf.dec_i8(yt, reco["fpb"], reco["sites"], reco["tstats"]), ours)
    assert torch.equal(tf.dec_quant_xla(yt, reco["fpb"], reco["sites"], reco["tstats"]), ours)


def _spy(monkeypatch):
    """Count the site wrappers' calls from the forward (each is a kernel
    launch on the card), the decoder forms under their own names."""
    calls = {}

    def wrap(name, fn):
        def spy(*a, **kw):
            form = name
            if name == "res_site_s8o" and a[4].shape[-1] != a[0].shape[-1]:
                form += "_co384"
            elif name == "site_s8" and a[0].shape[-1] == 96:
                form += "_c96"
            calls[form] = calls.get(form, 0) + 1
            return fn(*a, **kw)
        return spy

    for name in ("res_site", "res_site_skip", "res_site_s8o", "site_s8"):
        monkeypatch.setattr(k8, name, wrap(name, getattr(k8, name)))
    return calls


def test_s8_sites_forward_matches_jax(reco, monkeypatch):
    """The bf16 forward under ``bench.py``'s ``s8_sites`` set with frozen
    norms (4 × K2 + 4 × K3 on the res chain, then d1 on K2 at CO = 384 and
    d2 on K3 at C = 96) against the JAX forward on its XLA int8 references
    of the same branches, within tests/test_int8.py's bound for the int8
    res chain: mean < 5% of the exact output's mean magnitude."""
    calls = _spy(monkeypatch)
    xb = torch.from_numpy(reco["x"]).to(torch.bfloat16)
    out = tf.apply(reco["fpb"], xb, sites=reco["sites"], fused_sites=S8_SITES,
                   static_stats=reco["tstats"]).float().numpy()
    assert calls == {"res_site_s8o": 4, "site_s8": 4, "res_site_s8o_co384": 1, "site_s8_c96": 1}
    ref = np.asarray(jax.jit(lambda x, q, st: jf.apply(
        reco["jpb"], x, quant=q, fused_sites=("dec_xla_i8",), static_stats=st))(
        jnp.asarray(reco["x"], jnp.bfloat16), reco["quant"], reco["stats"]), np.float32)
    exact = tf.apply(reco["fp32"], torch.from_numpy(reco["x"]),
                     static_stats=reco["tstats"]).numpy()
    assert out.shape == ref.shape == (1, 32, 64, 3)
    assert np.abs(out - ref).mean() < 0.05 * np.abs(exact).mean()


# case → (the set, the frozen norms kept (None: measured), a small frame,
# the launches)
ROUTES = {
    "dec_s8 runs on frozen in4 and in5": (("dec_s8",), ("in4", "in5"), False,
                                          {"res_site_s8o_co384": 1, "site_s8_c96": 1}),
    "measured norms: dec_i8": (("dec_s8", "dec_i8"), None, False, {"res_site": 2}),
    "no frozen in4: dec_i8": (("dec_s8", "dec_i8"), ("in5",), False, {"res_site": 2}),
    "no frozen in5: dec_xla_i8": (("dec_s8", "dec_xla_i8"), ("in4",), False, {}),
    "below dec_supported: the bf16 decoder": (("dec_s8", "dec_i8"), ("in4", "in5"), True, {}),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_routing_fallbacks(reco, monkeypatch, case):
    """``dec_s8`` runs where the JAX forward routes it: with the in4 and in5
    statistics frozen, where the res grid and its double pass
    ``res_supported``; else ``dec_i8`` where named, else ``dec_xla_i8``,
    else the bf16 decoder. No res name: the res chain runs in PyTorch int8
    ops (no kernel)."""
    names, keep, small, launches = ROUTES[case]
    st = None if keep is None else {k: v for k, v in reco["tstats"].items()
                                    if k not in ("in4", "in5") or k in keep}
    x = np.random.default_rng(12).random((1, 16, 32, 3)) * 2 - 1 if small else reco["x"]
    calls = _spy(monkeypatch)
    out = tf.apply(reco["fpb"], torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16),
                   sites=reco["sites"], fused_sites=names, static_stats=st)
    assert calls == launches
    assert bool(torch.isfinite(out).all())
