"""The int8 residual and decoder chains of the quantized Johnson path, over
the K2–K5 site kernels (``kernels/int8_sites.py``).

Port of ``neuralstyletransferv1_tpu/models/s2d2_sites_i8.py``: ``res_chain``
(``--quantize int8``), ``res_chain_s8_static`` (``--quantize int8_static``)
and ``dec_chain`` (the K=64 d2 form; the pair-packed d2 is off in the JAX
engine), with the helpers ``_stats`` and ``_stats_phased``. The JAX
``_quant_halo`` / ``_s8_row_maps`` halos are the kernels' own (reflect or
edge, rows and columns alike); the s8 carry between K2 and K3 is the dense
[B,H,W,C] code tensor.

Every per-channel row is computed in f32 in the JAX code's order — the
products round, so the order is part of the function. The conv biases and
norm parameters come from the bf16 net (the JAX engine reads them from its
bf16-cast params), the int8 weights, ``ws`` and ``qin`` from ``quantize_net``
on the f32 net.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import int8_sites as k8
from .s2d import d2s, in_affine, quant_affine

NUM_RES = 5


@dataclass
class Site:
    """One quantized conv site, on its device."""

    wk: torch.Tensor    # int32 [9, C/4, CO] packed int8 weights
    ws: torch.Tensor    # f32 [CO] dequant row (weight scale · act scale / 127)
    bias: torch.Tensor  # f32 [CO] conv bias (phase-tiled for d1/d2)
    qin: float          # input quantizer 127 / act scale (an f32 value)


def prepare_sites(net, quant: dict, device) -> dict[str, Site]:
    """``quantize_net`` output + the (bf16) net → device-resident sites."""
    sites = {}
    for name, q in quant.items():
        if name.startswith("r"):
            blk = getattr(net, f"res{name[1]}")
            conv = blk.conv1 if name[2] == "a" else blk.conv2
            bias = conv.conv2d.bias.float()
        else:
            conv = {"d1": net.deconv1, "d2": net.deconv2}[name]
            bias = conv.conv2d.bias.float().repeat(4)
        sites[name] = Site(wk=k8.pack_weights(q["w"]).to(device),
                           ws=q["ws"].to(device, torch.float32),
                           bias=bias.to(device).contiguous(), qin=float(q["qin"]))
    return sites


def _stats(sums: torch.Tensor, n: float, eps: float = 1e-5):
    """(mean, inv) [B,CO] from the kernels' [Σ, Σ²] [B,2,CO]."""
    mean = sums[:, 0] / n
    var = sums[:, 1] / n - mean * mean
    return mean, torch.rsqrt(var + eps)


def _stats_phased(sums: torch.Tensor, n: float, phases: int, eps: float = 1e-5):
    """IN stats per logical channel when CO = phases × C."""
    b, _, co = sums.shape
    s1 = sums[:, 0].reshape(b, phases, co // phases).sum(1)
    s2 = sums[:, 1].reshape(b, phases, co // phases).sum(1)
    nn = n * phases
    mean = s1 / nn
    var = s2 / nn - mean * mean
    return mean, torch.rsqrt(var + eps)


def _frozen(static_stats: dict, site: str, B: int):
    m, inv = static_stats[site]
    return (m.float().expand(B, m.shape[-1]).contiguous(),
            inv.float().expand(B, inv.shape[-1]).contiguous())


def _norm_params(norm):
    return norm.weight.float(), norm.bias.float()


def _plain_quant(B: int, C: int, qin: float, device):
    """The quantize rows of a site whose input has no pending affine."""
    return (torch.full((B, C), qin, dtype=torch.float32, device=device),
            torch.zeros((B, C), dtype=torch.float32, device=device))


def res_chain(y: torch.Tensor, net, sites: dict):
    """The five residual blocks on K4/K5 (``--quantize int8``).

    y: [B,H,W,128] bf16, the activated res input. Each block's in2 apply and
    residual add fold into the next a-site's prologue (K5); the last one
    stays pending: returns ``(y4, (r2, a2, c2))`` for the d1 site to fold
    (the JAX ``res_chain(ret_carry=True)``, the engine's only use)."""
    B, H, W, C = y.shape
    n = float(H * W)
    carry = None
    for i in range(1, NUM_RES + 1):
        blk = getattr(net, f"res{i}")
        sa, sb = sites[f"r{i}a"], sites[f"r{i}b"]
        aq, cq = _plain_quant(B, C, sa.qin, y.device)
        if carry is None:
            r, sums = k8.res_site(y, aq, cq, -127.0, sa.wk, sa.ws, sa.bias)
        else:
            r2p, a2p, c2p = carry
            r, sums, y = k8.res_site_skip(r2p, y, aq, cq, a2p, c2p, -127.0,
                                          sa.wk, sa.ws, sa.bias)
        m, inv = _stats(sums, n)
        a_eff, c_eff = quant_affine(m, inv, *_norm_params(blk.in1), sb.qin)
        r2, sums2 = k8.res_site(r, a_eff, c_eff, 0.0, sb.wk, sb.ws, sb.bias)
        m2, inv2 = _stats(sums2, n)
        a2, c2 = in_affine(m2, inv2, *_norm_params(blk.in2))
        carry = (r2, a2.contiguous(), c2.contiguous())
    return y, carry


def res_chain_s8_static(y: torch.Tensor, net, sites: dict, static_stats: dict) -> torch.Tensor:
    """The five residual blocks on s8 carries with frozen norms
    (``--quantize int8_static``): per block, K2 quantizes y, convolves and
    emits the b-site's codes with the frozen in1 affine and ReLU folded in;
    K3 convolves them, applies the frozen in2 affine and adds y."""
    B, H, W, C = y.shape
    for i in range(1, NUM_RES + 1):
        blk = getattr(net, f"res{i}")
        sa, sb = sites[f"r{i}a"], sites[f"r{i}b"]
        m1, inv1 = (t.float() for t in static_stats[f"r{i}in1"])
        m2, inv2 = (t.float() for t in static_stats[f"r{i}in2"])
        # the b-site input quantize (the frozen in1 + ReLU folded in)
        qa, qc = (t[0].contiguous() for t in quant_affine(m1, inv1, *_norm_params(blk.in1),
                                                          sb.qin))
        aq, cq = _plain_quant(B, C, sa.qin, y.device)
        codes = k8.res_site_s8o(y, aq, cq, -127.0, sa.wk, sa.ws, sa.bias, qa, qc)
        # the frozen in2 affine
        aa, ac = (t[0].contiguous() for t in in_affine(m2, inv2, *_norm_params(blk.in2)))
        y = k8.site_s8(codes, sb.wk, sb.ws, sb.bias, aa, ac, y)
    return y


def dec_chain(y: torch.Tensor, net, sites: dict, *, carry=None,
              static_stats: dict | None = None):
    """deconv1 + deconv2 on K4/K5 in the space-to-depth phase form.

    d1 is a 3×3 conv at the res grid with 4·64 phase outputs (edge halo;
    with ``carry`` = (r2, a2, c2) from ``res_chain`` block 5's
    residual add folds into its prologue, K5); ``d2s`` moves the phases to
    the 2× grid, where d2 runs with the in4 affine and ReLU folded into its
    quantize (K4), 4·32 phase outputs. Returns (d2 raw [B,2H,2W,128] bf16,
    mean5, inv5 [B,32]) — frozen in5 statistics under ``static_stats``."""
    B, H, W, C = y.shape
    s1, s2 = sites["d1"], sites["d2"]
    aq, cq = _plain_quant(B, C, s1.qin, y.device)
    if carry is not None:
        r2p, a2p, c2p = carry
        r, sums, _ = k8.res_site_skip(r2p, y, aq, cq, a2p, c2p, -127.0, s1.wk, s1.ws,
                                      s1.bias, halo="edge", yout=False)
    else:
        r, sums = k8.res_site(y, aq, cq, -127.0, s1.wk, s1.ws, s1.bias, halo="edge")
    co = r.shape[-1] // 4  # 64
    if static_stats is not None:
        m, inv = _frozen(static_stats, "in4", B)
    else:
        m, inv = _stats_phased(sums, float(H * W), 4)
    a_eff, c_eff = quant_affine(m, inv, *_norm_params(net.in4), s2.qin)
    yd = d2s(r, 2, co).contiguous()  # [B,2H,2W,64] raw
    r2, sums2 = k8.res_site(yd, a_eff, c_eff, 0.0, s2.wk, s2.ws, s2.bias, halo="edge")
    if static_stats is not None:
        m5, inv5 = _frozen(static_stats, "in5", B)
    else:
        m5, inv5 = _stats_phased(sums2, float(yd.shape[1] * yd.shape[2]), 4)
    return r2, m5, inv5
