"""The Torch7 fast form's ``c2_i8``, ``dec_i8``, ``dec_xla_i8`` and
``tail_xla_i8`` branches of the PyTorch port against the JAX package's, on
the CPU.

The nets are the JAX tests' eccv16-shaped layer lists (``tests/
test_t7_fast.py``: c0 = 8, 3 residual blocks), BN-folded or instance-norm,
with k3 or k4 transposed convs. Both packages quantize from the same
activation scales (their int8 weights of the same scales are bit-identical,
``tests/test_torch_t7.py``); the port runs its sites' plain versions, the
JAX forward its Pallas sites in interpret mode. Whole forwards are compared
on the stylize's [0,1] frame scale at the repo's 1e-2 gate, and the decoder
and tail on the JAX forward's own inputs at the JAX tests' bound on the raw
scale (tanh·150). The kernels run only on the card
(``tests/test_torch_int8_forms_card.py``).
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



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this file: in the six-worker tier-1 run
    the workers share the cores, and a multi-threaded pool then waits at
    each op's barrier for threads other workers preempt."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _layers(norm: str, deconv_k: int, seed: int = 21) -> list:
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


def _bf16(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                        if hasattr(a, "astype") and a.dtype == jnp.float32 else a, tree)


@functools.cache
def _net(norm: str, k: int) -> dict:
    """One net in both packages' fast forms (bf16), one model-space frame
    (1 × 32 × 64: the res grid 8 × 16, conv2's block grid 16 × 32), the
    port's activation scales, the JAX ``quant`` of them, the port's sites of
    its own quantization of them, and the JAX bf16 forward's decoder input
    (``d1``) and output-conv input (``d3``)."""
    layers = _layers(norm, k)
    jp, tp = jf.try_fast_johnson(layers), tf.try_fast_johnson(layers)
    x = np.random.default_rng(4).normal(0, 50, (1, 32, 64, 3)).astype(np.float32)
    scales = tf.calibrate_t7_scales(tp, torch.from_numpy(x))
    tpb, jpb = tf.params_to(tp, CPU, torch.bfloat16), _bf16(jp)
    taps = {}
    jf.t7_fast_apply(jpb, jnp.asarray(x, jnp.bfloat16), tap=lambda s, t: taps.setdefault(s, t))
    return {"jpb": jpb, "tpb": tpb, "x": x, "taps": taps, "quant": jf.quantize_t7(jp, scales),
            "sites": tf.prepare_sites(tpb, tf.quantize_t7(tp, scales), CPU)}


def _frame(y: np.ndarray) -> np.ndarray:
    """A raw output (tanh·150, BGR) on the stylize's [0,1] RGB frame scale."""
    return np.clip(y[..., ::-1] / 255.0, 0.0, 1.0)


def _run(net, names, interpret, monkeypatch):
    """Both forwards under ``names``; the port's K4 launches by form. The
    outputs agree within the repo's 1e-2 gate on the frame scale (as
    tests/test_torch_t7.py holds the int8 stylizes): the bf16 heads round in
    other orders and each int8 code that flips spreads through the random
    net (measured ≤ 6.4e-3; 0 on the BN graphs)."""
    calls = {}

    def spy(fn):
        def wrapped(*a, **kw):
            form = f"res_site_k{kw['kh']}p{kw['pt']}" if kw.get("kh", 3) == 2 else "res_site"
            calls[form] = calls.get(form, 0) + 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tf.k8, "res_site", spy(k8.res_site))
    ours = tf.t7_fast_apply(net["tpb"], torch.from_numpy(net["x"]).to(torch.bfloat16),
                            sites=net["sites"], fused_sites=names).float().numpy()
    si8._INTERPRET = interpret
    try:
        ref = np.asarray(jf.t7_fast_apply(net["jpb"], jnp.asarray(net["x"], jnp.bfloat16),
                                          quant=net["quant"], fused_sites=names), np.float32)
    finally:
        si8._INTERPRET = False
    assert ours.shape == ref.shape == (1, 32, 64, 3)
    assert np.abs(_frame(ours) - _frame(ref)).mean() <= 1e-2
    return calls


def _close(ours: torch.Tensor, ref) -> None:
    """tests/test_int8.py's bound for the Torch7 decoder's fused sites
    against its XLA reference: mean < 5e-3 · max(mean |ref|, 1)."""
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    assert np.abs(ours.float().numpy() - ref).mean() < 5e-3 * max(np.abs(ref).mean(), 1.0)


def _tap(net, site) -> torch.Tensor:
    return torch.from_numpy(np.array(net["taps"][site].astype(jnp.float32))).to(torch.bfloat16)


NETS = [("bn", 3), ("in", 3), ("bn", 4), ("in", 4)]


@pytest.mark.parametrize("norm,k", NETS)
def test_dec_i8_matches_jax(norm, k, monkeypatch):
    """``dec_i8``: deconv1 and deconv2 on K4's zero-halo forms (2×2 pad 0 for
    k3, 3×3 pad 1 for k4) against the JAX forward with its Pallas pair in
    interpret mode; on the JAX forward's own decoder input, against the
    JAX XLA reference ``_t7_dec_quant_xla`` (as tests/test_int8.py holds
    the JAX pair)."""
    net = _net(norm, k)
    calls = _run(net, ("dec_i8",), True, monkeypatch)
    assert calls == ({"res_site_k2p0": 2} if k == 3 else {"res_site": 2})
    c0 = net["tpb"]["c0"]
    _close(tf._t7_dec_i8(_tap(net, "d1"), net["tpb"], net["sites"], c0),
           jf._t7_dec_quant_xla(net["taps"]["d1"], net["jpb"], net["quant"], c0))


@pytest.mark.parametrize("norm", ["bn", "in"])
def test_c2_i8_matches_jax(norm, monkeypatch):
    """``c2_i8``: conv2 on K4's 2×2 pad-1 form against the JAX forward with
    its Pallas site in interpret mode (the site itself is bit-exact:
    tests/test_torch_nst_int8_forms.py)."""
    assert _run(_net(norm, 3), ("c2_i8",), True, monkeypatch) == {"res_site_k2p1": 1}


@pytest.mark.parametrize("norm,k", NETS)
@pytest.mark.parametrize("names", [("dec_xla_i8",), ("dec_xla_i8", "tail_xla_i8")])
def test_xla_references_match_jax(norm, k, monkeypatch, names):
    """``dec_xla_i8`` and ``tail_xla_i8``: the PyTorch-int8 decoder and tail
    against the JAX forward's XLA int8 references (no site kernel), and on
    the JAX forward's own inputs against the JAX functions."""
    net = _net(norm, k)
    assert _run(net, names, False, monkeypatch) == {}
    c0 = net["tpb"]["c0"]
    if "tail_xla_i8" in names:
        _close(tf._t7_tail_quant_xla(_tap(net, "d3"), net["tpb"], net["sites"]),
               jf._t7_tail_quant_xla(net["taps"]["d3"], net["jpb"], net["quant"]))
    else:
        _close(tf._t7_dec_quant_xla(_tap(net, "d1"), net["tpb"], net["sites"], c0),
               jf._t7_dec_quant_xla(net["taps"]["d1"], net["jpb"], net["quant"], c0))
