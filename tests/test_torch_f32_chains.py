"""The chains that carry the f32 tensor of the float32 forwards past its
first site, in the PyTorch port against the JAX package on the CPU:
Johnson's head chain of ``head_i8`` (K8a on conv1's f32 output, K8b)
against the JAX ``head_chain``, and ReCoNet's s8 res and decoder chains,
whose every block keeps y's dtype in the JAX package, against the JAX
chains, Pallas in interpret mode. The forms themselves are
tests/test_torch_f32_forms.py's; the whole forwards under f32 params, set by
set, tests/test_torch_f32_sets_*.py's (the nets, frames and the map are
tests/torch_f32_nets.py's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_f32_nets import interpret as _interpret
from torch_f32_nets import johnson_nets, one_thread, reco_nets, scene  # noqa: F401

from neuralstyletransferv1_tpu.models import reconet_fast as jrf
from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_tpu.models import transformer_net_s2d as s2dj
from neuralstyletransferv1_tpu.models import transformer_net_s2d2 as s2d2
from neuralstyletransferv1_torch.kernels import int8_sites as k8
from neuralstyletransferv1_torch.models import reconet_fast as trf
from neuralstyletransferv1_torch.models import sites_i8
from neuralstyletransferv1_torch.models import transformer_net_quant as tq
from neuralstyletransferv1_torch.models.transformer_net import quant_from_jax

CPU = torch.device("cpu")


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def test_johnson_f32_head_chain_matches_jax():
    """``head_i8`` under f32 params, the part the f32 operand reaches: K8a on
    conv1's f32 output (the in1 affine folded into its quantize), K8b on
    its bf16 output, frozen norms, against the JAX ``head_chain`` in
    interpret mode on the same f32 input: conv3's bf16 raw on >= 99.9% of
    its values (the f32 sums and the pair-packed dots order their additions
    otherwise). Everything after it reads that bf16 tensor as under
    bfloat16 (tests/test_torch_int8_headtail.py's set A); the whole
    forward against the JAX forward is tests/test_torch_f32_sets_johnson.py's."""
    h, w = 40, 64
    bp32, net = johnson_nets()
    x = torch.from_numpy(scene(h, w))
    st = tq.calibrate_in_stats(net, x)
    scales = tq.calibrate_act_scales(net, x, ("c2", "c3"), st)
    quant = s2d2.quantize_net(bp32, scales)
    jst = {k: tuple(jnp.asarray(t.numpy()) for t in v) for k, v in st.items()}
    q, _ = quant_from_jax(quant, jst)
    with torch.no_grad():
        y1 = net.conv1(x).contiguous()
        m1, inv1 = st["in1"]
        ours, m3, inv3 = sites_i8.head_chain(y1, m1, inv1, net, sites_i8.prepare_sites(net, q, CPU),
                                             st)
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (1, h // 4, w // 4, 128)
    y1j = s2dj.s2d(jnp.asarray(y1.numpy()), 2)
    ref, _, _ = _interpret(si8.head_chain, y1j, jnp.asarray(m1.numpy()),
                           jnp.asarray(inv1.numpy()), bp32, quant, static_stats=jst)
    assert (ours.float().numpy() == _f32(ref)).mean() >= 0.999


@pytest.mark.parametrize("frn", [False, True], ids=["in", "frn"])
def test_reco_s8_chains_carry_f32_as_jax(frn, monkeypatch):
    """ReCoNet's s8 chains on one f32 res input (frozen norms, the IN and
    the FRN net): the JAX ``_res_chain_s8_static`` keeps y's dtype, so
    every block's K2 and K3 read an f32 y, and ``_dec_s8_static``'s K2 at
    CO = 384 reads the chain's f32 output. The port's chains take those f32
    forms, spied (4 + 4, then 1; K3's C = 96 form reads codes), and return
    f32 within 1e-6 of the mean magnitude of the JAX chains in interpret mode
    (measured: 1e-9 and 6e-8; interpret mode contracts some acc·ws + bias
    into an FMA). Rounding the input to bf16, as a bf16 carry would, moves
    both outputs by 2-4% of that magnitude."""
    r = reco_nets(frn)
    y = np.maximum(np.random.default_rng(7).normal(0, 1.0, (1, 8, 16, 192)), 0)
    y = y.astype(np.float32)
    jy = _interpret(jrf._res_chain_s8_static, jnp.asarray(y), r["jfp"], r["quant"], frn,
                    r["jst"])
    jd = _interpret(jrf._dec_s8_static, jnp.asarray(jy), r["jfp"], r["quant"], frn, r["jst"],
                    jnp.float32)
    jd = trf.d2s(torch.from_numpy(jd), 2, 48).numpy()
    assert jy.dtype == jd.dtype == np.float32
    seen = []
    for name, pos in (("res_site_s8o", 0), ("site_s8", 6)):
        def spy(*a, _fn=getattr(k8, name), _name=name, _pos=pos, **kw):
            t = a[_pos] if len(a) > _pos else kw.get("y")
            seen.append((_name, None if t is None else t.dtype))
            return _fn(*a, **kw)

        monkeypatch.setattr(k8, name, spy)

    def chains(t):
        with torch.no_grad():
            ty = trf.res_chain_s8_static(t, r["fp"], r["sites"], r["st"])
            return ty, trf.dec_s8_static(ty, r["fp"], r["sites"], r["st"])

    oy, od = chains(torch.from_numpy(y))
    f32 = [(name, torch.float32) for name in ("res_site_s8o", "site_s8")]
    assert seen == f32 * 4 + [("res_site_s8o", torch.float32), ("site_s8", None)]
    assert oy.dtype == od.dtype == torch.float32
    for ours, ref in ((oy, jy), (od, jd)):
        assert np.abs(ours.numpy() - ref).mean() <= 1e-6 * np.abs(ref).mean()
    for ours, ref in zip(chains(torch.from_numpy(y).to(torch.bfloat16)), (jy, jd)):
        assert np.abs(ours.float().numpy() - ref).mean() >= 1e-2 * np.abs(ref).mean()
