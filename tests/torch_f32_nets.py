"""The nets, frames and fused-site sets of the float32 tests of the PyTorch
port (tests/test_torch_f32_*.py); not a test file itself.

Each context builds one seeded random net in both packages (f32 params),
one small frame, and where the sets quantize, the calibration both take;
it returns (JAX forward of a fused-site set, the port's forward of the same
set, frame). ``F32_MAP`` is the map of PERF.md section 6: every set under
f32 params with the dtype the JAX forward returns, or "raises" where its
trace raises the TypeError of a bf16 site output meeting an f32 conv.
``check_set`` holds the port's forward of one set to the JAX forward with
its Pallas sites in interpret mode: the same dtype, within the set's MAE
bound on the [0, 1] frame the net's IO preset makes of the output; or, where
the JAX forward raises, the port raises naming it.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralstyletransferv1_tpu.io import t7_fast as jt7
from neuralstyletransferv1_tpu.models import io_presets as iop
from neuralstyletransferv1_tpu.models import reconet_fast as jrf
from neuralstyletransferv1_tpu.models import s2d2_sites as sj
from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_tpu.models import transformer_net as jtn
from neuralstyletransferv1_tpu.models import transformer_net_nst as jn
from neuralstyletransferv1_tpu.models import transformer_net_nst_fast as jnf
from neuralstyletransferv1_tpu.models import transformer_net_s2d2 as s2d2
from neuralstyletransferv1_torch.io import t7_fast as tt7
from neuralstyletransferv1_torch.models import reconet as tr
from neuralstyletransferv1_torch.models import reconet_fast as trf
from neuralstyletransferv1_torch.models import sites_bf16, sites_i8
from neuralstyletransferv1_torch.models import transformer_net_nst as tn
from neuralstyletransferv1_torch.models import transformer_net_nst_fast as tnf
from neuralstyletransferv1_torch.models import transformer_net_quant as tq
from neuralstyletransferv1_torch.models.transformer_net import (
    TransformerNet,
    params_from_jax,
    quant_from_jax,
)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op torch thread for the importing test file: in the
    six-worker tier-1 run the workers share the cores, and a multi-threaded
    pool then waits at each op's barrier for threads other workers
    preempt."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def interpret(fn, *args, **kw):
    """``fn`` with the JAX package's Pallas sites in interpret mode, its
    outputs as numpy arrays."""
    si8._INTERPRET = sj._INTERPRET = True
    try:
        return jax.tree.map(np.asarray, fn(*args, **kw))
    finally:
        si8._INTERPRET = sj._INTERPRET = False


def interpret_forward(jfn, x) -> np.ndarray:
    """The JAX forward with its Pallas sites in interpret mode, jitted; its
    output in its own dtype."""
    return interpret(jax.jit(jfn), jnp.asarray(x))


def jax_dtype(jfn, x) -> str:
    """The JAX forward's output dtype from its trace alone (no kernel runs),
    or "raises" where its trace raises the TypeError of a bf16 site output
    meeting an f32 conv."""
    try:
        return str(jax.eval_shape(jfn, jax.ShapeDtypeStruct(x.shape, jnp.float32)).dtype)
    except TypeError as e:
        assert "same dtypes" in str(e), e
        return "raises"


def tquant(quant: dict) -> dict:
    """The JAX ``quantize_net`` dict as the port's sites take it."""
    return {k: {"w": torch.from_numpy(np.asarray(v["w"]).copy()),
                "ws": torch.from_numpy(np.asarray(v["ws"], np.float32).copy()),
                "qin": float(v["qin"])} for k, v in quant.items()}


def _jstats(st: dict | None):
    return None if st is None else {k: tuple(jnp.asarray(t.numpy()) for t in v)
                                    for k, v in st.items()}


@functools.cache
def johnson_nets():
    """Random Johnson weights (``transformer_net.init``, key 0) as the JAX
    f32 f2 params and the port's f32 net."""
    tree = jax.tree.map(np.asarray, jax.jit(jtn.init)(jax.random.key(0)))
    bp32 = jax.tree.map(jnp.asarray, s2d2.from_johnson_params(tree))
    net = TransformerNet()
    net.load_state_dict(params_from_jax(tree))
    return bp32, net.eval().requires_grad_(False)


def scene(h: int, w: int) -> np.ndarray:
    """A 1 × h × w frame of a smooth textured scene in [0, 1]."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    s = 0.5 + 0.25 * np.sin(0.21 * xx + 0.13 * yy) + 0.15 * np.cos(0.17 * xx - 0.29 * yy)
    return np.clip(s[None, ..., None] + np.random.default_rng(1).normal(0, 0.03, (1, h, w, 3)),
                   0, 1).astype(np.float32)


@functools.cache
def johnson(h: int, w: int, static):
    """The Johnson net on an h × w scene; for ``static`` True / False the
    port's calibration (frozen / measured norms; the scales of every
    Pallas site, d3 among them; tests/test_torch_int8_headtail.py holds it
    to JAX's), the JAX quant of its scales and the port's sites of it (d3
    baked for ``raw_01``); the bf16 sites' weights for the float32 net
    (``static`` None: no quantize)."""
    bp32, net = johnson_nets()
    x = scene(h, w)
    sw = sites_bf16.prepare(net, CPU, torch.float32)
    if static is None:
        return (lambda f: lambda xj: s2d2.apply(bp32, xj, fused_sites=f),
                lambda f: net(torch.from_numpy(x), fused_sites=f, site_weights=sw), x)
    xt = torch.from_numpy(x)
    tst = tq.calibrate_in_stats(net, xt) if static else None
    stats = _jstats(tst)
    quant = s2d2.quantize_net(bp32, tq.calibrate_act_scales(net, xt, tq.QUANT_SITES_PALLAS, tst))
    q, st = quant_from_jax(quant, stats)
    sites = sites_i8.prepare_sites(net, q, CPU, d3=tq.baked_d3(net, "raw_01"))
    return (lambda f: lambda xj: s2d2.apply(bp32, xj, quant=quant, static_stats=stats,
                                            fused_sites=f),
            lambda f: tq.forward_int8(net, torch.from_numpy(x), sites, st, fused_sites=f,
                                      site_weights=sw), x)


@functools.cache
def nst(static: bool):
    """The NST_Train random net (key 3), one 1 × 16 × 32 frame, the port's
    calibration (frozen norms where ``static``), the JAX quant of its scales
    and the port's sites of it."""
    tree = jax.tree.map(np.asarray, jax.jit(jn.init)(jax.random.key(3)))
    net = tn.TransformerNetNST()
    net.load_state_dict(tn.params_from_jax(tree))
    net = net.eval().requires_grad_(False)
    fp = jnf.from_nst_params(tree)
    x = np.random.default_rng(5).random((1, 16, 32, 3)).astype(np.float32)
    st = tnf.calibrate_in_stats(net, torch.from_numpy(x)) if static else None
    quant = jnf.quantize_net(fp, tnf.calibrate_act_scales(net, torch.from_numpy(x),
                                                          static_stats=st))
    jst = _jstats(st)
    sites = tnf.prepare_sites(net, tquant(quant), CPU)
    return (lambda f: lambda xj: jnf.apply(fp, xj, quant=quant, fused_sites=f, static_stats=jst),
            lambda f: tnf.apply(net, torch.from_numpy(x), sites=sites, fused_sites=f,
                                static_stats=st), x)


@functools.cache
def t7(norm: str):
    """An eccv16-shaped Torch7 net (c0 = 32, two res blocks, k3 deconvs;
    tests/test_torch_t7_s8.py's layer lists), a 1 × 32 × 64 model-space
    frame, the JAX quant and the port's sites of it."""
    from test_torch_t7_s8 import _layers, _x

    layers = _layers(norm, 3)
    jp, tp = jt7.try_fast_johnson(layers), tt7.try_fast_johnson(layers)
    x = _x((1, 32, 64, 3), 4)
    quant = jt7.quantize_t7(jp, jt7.calibrate_t7_scales(jp, jnp.asarray(x)))
    sites = tt7.prepare_sites(tp, tquant(quant), CPU)
    return (lambda f: lambda xj: jt7.t7_fast_apply(jp, xj, quant=quant, fused_sites=f),
            lambda f: tt7.t7_fast_apply(tp, torch.from_numpy(x), sites=sites, fused_sites=f), x)


@functools.cache
def reco_nets(frn: bool) -> dict:
    """A seeded ReCoNet net (tests/test_torch_reco_dec_s8.py's) in both
    packages' fast forms (f32), a 1 × 32 × 64 frame in [−1, 1], its frozen
    norms, the JAX quant of the port's static scales and the port's sites of
    it."""
    from test_torch_reco_dec_s8 import _tree

    tree = _tree(frn)
    net = tr.ReCoNet(frn)
    net.load_state_dict(tr.params_from_jax(tree))
    fp32 = trf.FastReCoNet(net.eval().requires_grad_(False))
    x = np.random.default_rng(6).random((1, 32, 64, 3)).astype(np.float32) * 2 - 1
    st = trf.calibrate_in_stats(fp32, torch.from_numpy(x))
    jfp = jrf.from_reconet_params(tree)
    quant = jrf.quantize_net(jfp, trf.calibrate_act_scales(fp32, torch.from_numpy(x),
                                                           static_stats=st))
    return {"fp": fp32, "jfp": jfp, "x": x, "st": st, "jst": _jstats(st), "quant": quant,
            "sites": trf.prepare_sites(copy.deepcopy(fp32), tquant(quant), CPU)}


@functools.cache
def reco(frn: bool):
    """The ReCoNet forwards of ``reco_nets(frn)`` under frozen norms."""
    r = reco_nets(frn)
    return (lambda f: lambda xj: jrf.apply(r["jfp"], xj, quant=r["quant"], fused_sites=f,
                                           static_stats=r["jst"]),
            lambda f: trf.apply(r["fp"], torch.from_numpy(r["x"]), sites=r["sites"],
                                fused_sites=f, static_stats=r["st"]), r["x"])


#: each context's IO preset (its JAX package default; Johnson's d3 is baked
#: for ``raw_01``), which makes the [0, 1] frame of the output
PRESETS = {johnson: "raw_01", nst: "raw_01", t7: "caffe_bgr", reco: "imagenet_01"}
#: the MAE bound on [0, 1]: the repo's int8 gate; and where the port's
#: forward runs JAX's Pallas chains on JAX's own inputs (measured at most
#: 1.3e-7), a bound a rounded carry or operand would break
GATE, NEAR = 1e-2, 1e-5
S8T = ("res_s8", "dec_s8", "tail_s8")
J40, J40I, J40B = (johnson, 40, 64, True), (johnson, 40, 64, False), (johnson, 40, 64, None)
#: the map (PERF.md section 6): name → (context and its key, the set, the
#: dtype the JAX forward with f32 params returns or "raises", the bound).
#: Johnson's sets take a 40 × 64 frame: at 32 × 64 the JAX d3 site's rows
#: kernel does not trace (its 5-row strip leaves its last partial MMA tile
#: out: a fault of the reference at that geometry, in bf16 as in f32);
#: ``tail`` needs h/2 ≡ 4 (mod 8), and 64 × 64 falls below its gate
F32_MAP = {
    "johnson head_i8+res_s8+dec_s8+tail_s8": (J40, ("head_i8",) + S8T, "bfloat16", GATE),
    "johnson head_i8+res_i8+dec_s8+tail_s8": (J40, ("head_i8", "res_i8", "dec_s8", "tail_s8"),
                                              "bfloat16", GATE),
    "johnson set A": (J40, ("head_i8", "res_i8", "res_s8", "dec_i8", "dec_s8", "tail_s8"),
                      "bfloat16", GATE),
    "johnson res_s8+dec_s8+tail_s8": (J40, S8T, "bfloat16", GATE),
    "johnson dec_s8+tail_s8": (J40, ("dec_s8", "tail_s8"), "bfloat16", GATE),
    "johnson head_i8+res_s8+dec_s8 raises": (J40, ("head_i8", "res_s8", "dec_s8"), "raises",
                                             None),
    "johnson head_i8+res_s8+dec_s8+d3": (J40, ("head_i8", "res_s8", "dec_s8", "d3"),
                                         "bfloat16", GATE),
    "johnson head_i8+res_i8+dec_i8+d3": (J40I, ("head_i8", "res_i8", "dec_i8", "d3"),
                                         "bfloat16", GATE),
    "johnson head_i8 raises": (J40I, ("head_i8",), "raises", None),
    # d3_i8 on the XLA-form decoder: K7 reads the f32 d2 raw unrounded, the
    # border strips run in f32
    "johnson d3_i8 on the XLA-form decoder": (J40I, ("d3_i8",), "bfloat16", GATE),
    "johnson d3": (J40B, ("d3",), "bfloat16", GATE),
    "johnson tail": (J40B, ("tail",), "float32", GATE),
    "johnson tail+d3": (J40B, ("tail", "d3"), "float32", GATE),
    "johnson tail+d3 below the tail gate": ((johnson, 64, 64, None), ("tail", "d3"),
                                            "bfloat16", GATE),
    "nst c2_i8": ((nst, False), ("c2_i8",), "float32", GATE),
    "nst res_i8+dec_i8": ((nst, False), ("res_i8", "dec_i8"), "float32", GATE),
    "nst c2_i8+res_i8+dec_i8": ((nst, False), ("c2_i8", "res_i8", "dec_i8"), "float32", GATE),
    "nst c2_i8+dec_i8": ((nst, False), ("c2_i8", "dec_i8"), "float32", GATE),
    "nst res_s8+dec_s8": ((nst, True), ("res_s8", "dec_s8"), "float32", GATE),
    "nst res_s8+dec_s8+tail_s8": ((nst, True), S8T, "bfloat16", GATE),
    "nst c2_i8+res_s8+dec_s8+tail_s8": ((nst, True), ("c2_i8",) + S8T, "bfloat16", GATE),
    "t7 bn c2_i8": ((t7, "bn"), ("c2_i8",), "float32", NEAR),
    "t7 in c2_i8+res_i8+dec_i8": ((t7, "in"), ("c2_i8", "res_i8", "dec_i8"), "float32", GATE),
    "t7 bn res_s8+dec_s8": ((t7, "bn"), ("res_s8", "dec_s8"), "float32", NEAR),
    "t7 bn res_s8+dec_s8+tail_s8": ((t7, "bn"), S8T, "bfloat16", NEAR),
    "t7 bn c2_i8+res_s8+dec_s8+tail_s8": ((t7, "bn"), ("c2_i8",) + S8T, "bfloat16", NEAR),
    "reco in res_s8+dec_s8": ((reco, False), ("res_s8", "dec_s8"), "float32", NEAR),
    "reco frn res_i8+dec_s8": ((reco, True), ("res_i8", "dec_s8"), "float32", GATE),
    "reco frn res_s8+dec_s8": ((reco, True), ("res_s8", "dec_s8"), "float32", GATE),
    "reco frn dec_s8": ((reco, True), ("dec_s8",), "float32", GATE),
}


#: the map's sets by the test file that runs them (the key is the file's
#: stem after ``test_torch_f32_sets_``): each file's share keeps its worker
#: near 30 s in the six-worker tier-1 run (every set lowers its own
#: interpret-mode Pallas sites, 1-2 s each, whatever the other sets lower)
F32_PARTS = {
    "johnson": ("johnson head_i8+res_s8+dec_s8+tail_s8", "johnson head_i8+res_s8+dec_s8 raises",
                "johnson head_i8 raises"),
    "johnson_2": ("johnson head_i8+res_i8+dec_s8+tail_s8", "johnson dec_s8+tail_s8",
                  "johnson d3_i8 on the XLA-form decoder"),
    "johnson_3": ("johnson set A", "johnson res_s8+dec_s8+tail_s8"),
    "johnson_4": ("johnson head_i8+res_i8+dec_i8+d3", "johnson head_i8+res_s8+dec_s8+d3"),
    "johnson_5": ("johnson d3", "johnson tail", "johnson tail+d3",
                  "johnson tail+d3 below the tail gate"),
    "nets": ("nst res_i8+dec_i8", "nst c2_i8"),
    "nets_2": ("nst c2_i8+res_i8+dec_i8", "nst c2_i8+dec_i8"),
    "nets_3": ("nst c2_i8+res_s8+dec_s8+tail_s8", "t7 bn c2_i8+res_s8+dec_s8+tail_s8"),
    "nets_4": ("nst res_s8+dec_s8+tail_s8", "t7 bn c2_i8", "t7 in c2_i8+res_i8+dec_i8"),
    "nets_5": ("nst res_s8+dec_s8", "t7 bn res_s8+dec_s8", "t7 bn res_s8+dec_s8+tail_s8"),
    "nets_6": ("reco in res_s8+dec_s8", "reco frn res_i8+dec_s8", "reco frn res_s8+dec_s8",
               "reco frn dec_s8"),
}


def check_set(name: str):
    """One set of the map under f32 params: where the JAX forward runs, the
    port's forward returns its dtype (bf16 where it ends in ``tail_s8`` or
    ``d3``, f32 from ``tail`` and elsewhere) and its frame's shape, within
    the set's MAE bound of the JAX forward with its Pallas sites in
    interpret mode on the [0, 1] frame; where the JAX forward raises, the
    port raises, naming the JAX forward's TypeError."""
    (ctx, *key), fused, want, bound = F32_MAP[name]
    jfn, pfn, x = ctx(*key)
    if want == "raises":
        assert jax_dtype(jfn(fused), x) == "raises"
        with torch.no_grad(), pytest.raises(NotImplementedError, match="JAX forward"):
            pfn(fused)
        return
    ref = interpret_forward(jfn(fused), x)
    with torch.no_grad():
        ours = pfn(fused)
    assert str(ref.dtype) == want and str(ours.dtype) == f"torch.{want}"
    assert tuple(ours.shape) == ref.shape == x.shape

    def frame(y):
        return np.asarray(iop.postprocess(PRESETS[ctx], jnp.asarray(y, jnp.float32)))

    mae = float(np.abs(frame(ours.float().numpy()) - frame(ref.astype(np.float32))).mean())
    assert mae <= bound, (mae, bound)
