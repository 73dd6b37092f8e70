"""The int8 head, residual, decoder and deconv3 chains of the quantized
Johnson path, over the K2–K8b site kernels (``kernels/int8_sites.py``).

Port of ``neuralstyletransferv1_tpu/models/s2d2_sites_i8.py``: ``head_chain``
(conv2 + conv3 on K8a/K8b), ``res_chain`` (``--quantize int8``; K4/K5),
``res_chain_s8_static`` (frozen norms, s8 carries; K2/K3, with the fused
head's deferred in3 apply and the bridge into the s8 decoder), the
zero-halo s8 chains the NST_Train and Torch7 nets share
(``res_chain_s8_zero``, ``dec_s8_zero``),
``dec_chain`` (K4/K5; the pair-packed d2 form is off in the JAX engine and
has the same numerics), ``dec_chain_s8_static`` with the ``tail_s8`` tail
(K3 emits deconv3's codes, K6 + the reflect border strips), and the
deconv3 forms of ``transformer_net_s2d2.apply``: the ``d3_i8`` rows site
(K7) with its bf16 strips and dy-sum, and the bf16 tap-packed deconv3 the
JAX engine falls back to below the geometry gates. Also the gates
(``head_supported``, ``res_supported``, ``dec_supported``, ``d3_supported``,
``d3s8_supported``) and the helpers ``_stats`` and ``_stats_phased``. Below
``res_supported`` / ``dec_supported`` the JAX engine runs the same int8 sites
through XLA (``_qc`` of ``transformer_net_s2d2.apply``); ``res_chain_qc``,
``dec_d1_qc`` and ``dec_d2_qc`` are that form in PyTorch ops.

The TPU carries hold pre-injected halo columns; here every carry is the
dense [B,H,W,C] tensor and each kernel computes its own halo (reflect, edge
or zero). conv2/conv3 run as pixel convs (the TPU's column-pair packing is
layout only); deconv1/deconv2 run in the space-to-depth phase form and
deconv3 in its tap-packed form, since their int8 scales are taken over
those weights.

Every per-channel row is computed in f32 in the JAX code's order — the
products round, so the order is part of the function. The conv biases and
norm parameters come from the bf16 net (the JAX engine reads them from its
bf16-cast params), the int8 weights, ``ws`` and ``qin`` from ``quantize_net``
on the f32 net.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import bf16_sites as k9
from ..kernels import int8_sites as k8
from ..ops.conv import conv2d, conv2d_i8
from ..ops.norm import instance_norm
from .s2d import apply_in_relu, d2s, in_affine, in_stats, pad_reflect_f2_4px, quant_affine

NUM_RES = 5

#: strip heights of the TPU kernels; a size whose grid no strip height
#: divides runs its sites in the XLA form in the JAX engine
_TS_CHOICES = (30, 28, 27, 24, 20, 18, 16, 12, 10, 8, 6, 5, 4, 3, 2)


def _pick_ts(h: int) -> int | None:
    for ts in _TS_CHOICES:
        if h % ts == 0:
            return ts
    return None


def res_supported(h4: int, w4: int) -> bool:
    return h4 >= 8 and w4 >= 16 and w4 % 8 == 0 and _pick_ts(h4) is not None


def dec_supported(h4: int, w4: int) -> bool:
    """d1 runs at the (h4, w4) grid, d2 at (2·h4, 2·w4)."""
    return res_supported(h4, w4) and res_supported(2 * h4, 2 * w4)


def head_supported(h2: int, w2: int) -> bool:
    """c2 at the (h2, w2) grid of the conv1 output's space-to-depth form
    (its column-pair width w2/2 is the TPU block width), c3 to (h2/2, w2/2)."""
    wp = w2 // 2
    return (h2 % 2 == 0 and w2 % 2 == 0 and wp >= 16 and h2 >= 16 and wp % 8 == 0
            and _pick_ts(h2) is not None and _pick_ts(h2 // 2) is not None)


def d3_supported(h2: int, w2: int) -> bool:
    """The ``d3_i8`` rows site (K7) at the (h2, w2) deconv3 block grid."""
    return h2 >= 8 and w2 >= 16 and w2 % 8 == 0 and _pick_ts(h2) is not None


def d3s8_supported(h2: int, w2: int) -> bool:
    """The ``tail_s8`` deconv3 site (K6); the JAX gate has K7's form."""
    return d3_supported(h2, w2)


@dataclass
class Site:
    """One quantized conv site, on its device."""

    wk: torch.Tensor    # int32 [taps, C/4, CO] packed int8 weights (d3: lanes padded to 64)
    ws: torch.Tensor    # f32 [CO] dequant row (weight scale · act scale / 127)
    bias: torch.Tensor  # f32 [CO] conv bias (phase-tiled for d1/d2; d3: the baked [12])
    qin: float          # input quantizer 127 / act scale (an f32 value)
    w8: torch.Tensor | None = None  # d3: int8 [1,5,128,60] (the border strips)
    wb: torch.Tensor | None = None  # d3: bf16 OIHW [60,128,1,5] baked weights
    wr: torch.Tensor | None = None  # d3: the same packed for K9b/K9e, bf16 [5,64,128]


def prepare_sites(net, quant: dict, device, *, d3=None) -> dict[str, Site]:
    """``quantize_net`` output + the (bf16) net → device-resident sites.
    ``d3``: deconv3's baked tap-packed f32 (w_row, b) of the f32 net
    (``transformer_net_quant.baked_d3``), needed when ``quant`` has "d3"."""
    sites = {}
    for name, q in quant.items():
        if name == "d3":
            if d3 is None:
                raise ValueError("the d3 site needs the baked deconv3 (d3=)")
            w_row, b12 = d3
            sites[name] = Site(
                wk=k8.pack_weights(q["w"], co_pad=k8.CO_TILE).to(device),
                ws=F.pad(q["ws"].to(torch.float32), (0, k8.CO_TILE - k8.D3_LANES)).to(device),
                bias=torch.from_numpy(np.asarray(b12, np.float32)).to(torch.bfloat16).float()
                .to(device),
                qin=float(q["qin"]), w8=q["w"].to(device),
                wb=torch.from_numpy(np.asarray(w_row, np.float32)).permute(3, 2, 0, 1)
                .contiguous().to(device, torch.bfloat16),
                wr=k9.pack_rows_weights(torch.from_numpy(np.asarray(w_row, np.float32)))
                .to(device))
            continue
        if name.startswith("r"):
            blk = getattr(net, f"res{name[1]}")
            conv = blk.conv1 if name[2] == "a" else blk.conv2
            bias = conv.conv2d.bias.float()
        elif name in ("c2", "c3"):
            bias = {"c2": net.conv2, "c3": net.conv3}[name].conv2d.bias.float()
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


def _batch(t: torch.Tensor, B: int) -> torch.Tensor:
    """A [1|B, C] row → a contiguous [B, C] kernel operand."""
    return t.float().expand(B, t.shape[-1]).contiguous()


def _frozen(static_stats: dict, site: str, B: int):
    m, inv = static_stats[site]
    return _batch(m, B), _batch(inv, B)


def _norm_params(norm):
    return norm.weight.float(), norm.bias.float()


def _plain_quant(B: int, C: int, qin: float, device):
    """The quantize rows of a site whose input has no pending affine."""
    return (torch.full((B, C), qin, dtype=torch.float32, device=device),
            torch.zeros((B, C), dtype=torch.float32, device=device))


def head_chain(y1: torch.Tensor, m1: torch.Tensor, inv1: torch.Tensor, net, sites: dict,
               static_stats: dict | None = None):
    """conv2 + conv3 as int8 sites (K8a, K8b), the ``head_i8`` set.

    y1: the conv1 raw output [B,H,W,32] bf16; m1, inv1: its in1 statistics
    ([1|B, 32]). The in1 apply + ReLU fold into K8a's quantize (floor 0), the
    in2 apply into K8b's. With ``static_stats`` the frozen in2/in3
    statistics replace the kernels' sums. Returns ``(y3_raw, m3, inv3)``:
    the raw conv3 output [B,H/4,W/4,128] and its in3 statistics."""
    B = y1.shape[0]
    s2, s3 = sites["c2"], sites["c3"]
    a1, c1 = quant_affine(m1, inv1, *_norm_params(net.in1), s2.qin)
    r2, sums = k8.c2_site(y1, _batch(a1, B), _batch(c1, B), 0.0, s2.wk, s2.ws, s2.bias)
    if static_stats is not None and "in2" in static_stats:
        m2, inv2 = _frozen(static_stats, "in2", B)
    else:
        m2, inv2 = _stats(sums, float(r2.shape[1] * r2.shape[2]))
    a2, c2 = quant_affine(m2, inv2, *_norm_params(net.in2), s3.qin)
    y3, sums3 = k8.c3_site(r2, a2, c2, 0.0, s3.wk, s3.ws, s3.bias)
    if static_stats is not None and "in3" in static_stats:
        m3, inv3 = _frozen(static_stats, "in3", B)
    else:
        m3, inv3 = _stats(sums3, float(y3.shape[1] * y3.shape[2]))
    return y3, m3, inv3


def res_chain(y: torch.Tensor, net, sites: dict, *, static_stats: dict | None = None,
              ret_carry: bool = True):
    """The five residual blocks on K4/K5 (``res_i8``).

    y: [B,H,W,128] bf16, or f32 under the float32 chains: then block 1's K4
    and block 2's K5 (its residual) take their f32 forms, as the JAX chain
    hands them the f32 tensor, and every later carry is K5's bf16 v. Each
    block's in2 apply and residual add fold into the next a-site's prologue
    (K5). With
    ``ret_carry`` the last one stays pending: returns ``(y4, (r2, a2, c2))``
    for the d1 site to fold; else the output bf16(bf16(r2·a2 + c2) + y4).
    ``static_stats`` freezes every norm (the kernels' sums are ignored)."""
    B, H, W, C = y.shape
    n = float(H * W)

    def stats(site, sums):
        if static_stats is not None and site in static_stats:
            return _frozen(static_stats, site, B)
        return _stats(sums, n)

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
        m, inv = stats(f"r{i}in1", sums)
        a_eff, c_eff = quant_affine(m, inv, *_norm_params(blk.in1), sb.qin)
        r2, sums2 = k8.res_site(r, a_eff, c_eff, 0.0, sb.wk, sb.ws, sb.bias)
        m2, inv2 = stats(f"r{i}in2", sums2)
        a2, c2 = in_affine(m2, inv2, *_norm_params(blk.in2))
        carry = (r2, a2.contiguous(), c2.contiguous())
    if ret_carry:
        return y, carry
    r2, a2, c2 = carry
    return combine_as(r2, y, a2, c2)


def combine_as(r2: torch.Tensor, y: torch.Tensor, a2: torch.Tensor,
               c2: torch.Tensor) -> torch.Tensor:
    """A chain's last residual add as the JAX chains write it,
    ``(r2·a2 + c2).astype(y.dtype) + y``: the affine in f32, rounded to y's
    dtype, added in it (bf16: ``k8._combine``; an f32 y stays unrounded)."""
    if y.dtype == torch.bfloat16:
        return k8._combine(r2, y, a2, c2)
    return (r2.float() * a2[:, None, None, :] + c2[:, None, None, :]).to(y.dtype) + y


def res_chain_s8_static(y: torch.Tensor, net, sites: dict, static_stats: dict, *,
                        in_aff=None, emit_qo: float | None = None) -> torch.Tensor:
    """The five residual blocks on s8 carries with frozen norms (``res_s8``):
    per block, K2 quantizes y, convolves and emits the b-site's codes with
    the frozen in1 affine and ReLU folded in; K3 convolves them, applies the
    frozen in2 affine and adds y.

    in_aff: the frozen in3 affine ``(a3, c3)`` ([1|B, C]) of the int8 head,
    whose apply is deferred: then y is the RAW conv3 output, the affine and
    ReLU fold into block 1's quantize (floor 0) and, as YAFF, into its
    residual operand.
    emit_qo: d1's qin — block 5 then emits d1's s8 input (floor −127)
    instead of bf16, the bridge into ``dec_chain_s8_static``.
    An f32 y (the float32 chains) goes to block 1's K2 and, as its residual,
    to its K3 in their f32 forms; K3's output, bf16, carries on."""
    B, H, W, C = y.shape
    for i in range(1, NUM_RES + 1):
        blk = getattr(net, f"res{i}")
        sa, sb = sites[f"r{i}a"], sites[f"r{i}b"]
        m1, inv1 = (t.float() for t in static_stats[f"r{i}in1"])
        m2, inv2 = (t.float() for t in static_stats[f"r{i}in2"])
        # the b-site input quantize (the frozen in1 + ReLU folded in)
        qa, qc = (t[0].contiguous() for t in quant_affine(m1, inv1, *_norm_params(blk.in1),
                                                          sb.qin))
        yaff = None
        if i == 1 and in_aff is not None:
            aq, cq = (_batch(t * sa.qin, B) for t in in_aff)
            lo = 0.0
            yaff = tuple(t[0].float().contiguous() for t in in_aff)
        else:
            aq, cq = _plain_quant(B, C, sa.qin, y.device)
            lo = -127.0
        codes = k8.res_site_s8o(y, aq, cq, lo, sa.wk, sa.ws, sa.bias, qa, qc)
        # the frozen in2 affine
        aa, ac = (t[0].contiguous() for t in in_affine(m2, inv2, *_norm_params(blk.in2)))
        if i == NUM_RES and emit_qo is not None:
            qo = torch.full((C,), emit_qo, dtype=torch.float32, device=y.device)
            return k8.site_s8(codes, sb.wk, sb.ws, sb.bias, aa, ac, y, yaff=yaff, qa=qo,
                              qc=torch.zeros_like(qo), qlo=-127.0)
        y = k8.site_s8(codes, sb.wk, sb.ws, sb.bias, aa, ac, y, yaff=yaff)
    return y


def res_chain_s8_zero(y: torch.Tensor, blocks, *, sw: int | None = None,
                      emit_qo: float | None = None) -> torch.Tensor:
    """Residual blocks on s8 carries under the zero halo: the ``res_s8``
    chain of the zero-padded nets (NST_Train with frozen norms, Torch7's
    BN-folded graphs). ``blocks``: per block (a-site, b-site, (qa, qc), aff).
    K2 quantizes y at the a-site's qin (floor −127), convolves and emits the
    b-site's codes at the (CO,) rows (qa, qc), floor 0 (the ReLU; a frozen
    norm folded in, or qa = qin, qc = 0); K3 convolves them, applies the
    (CO,) affine ``aff`` = (aa, ac) where given, and adds y. ``sw``: the
    content width of a grid padded to %8 (the codes beyond it are zero).
    ``emit_qo``: the last K3 emits deconv1's codes at that scale (floor
    −127) instead of bf16 (the bridge into ``dec_s8_zero``). Returns the last
    K3's output: bf16 (y's dtype for a bf16 y; an f32 y goes to the first
    block's K2 and K3 in their f32 forms), or the codes."""
    B, _, _, C = y.shape
    zeros = torch.zeros((B, C), dtype=torch.float32, device=y.device)
    for i, (sa, sb, (qa, qc), aff) in enumerate(blocks):
        aq = torch.full((B, C), sa.qin, dtype=torch.float32, device=y.device)
        codes = k8.res_site_s8o(y, aq, zeros, -127.0, sa.wk, sa.ws, sa.bias, qa, qc,
                                halo="zero", sw=sw)
        emit = {}
        if emit_qo is not None and i == len(blocks) - 1:
            emit = dict(qa=torch.full((C,), emit_qo, dtype=torch.float32, device=y.device),
                        qc=zeros[0], qlo=-127.0)
        y = k8.site_s8(codes, sb.wk, sb.ws, sb.bias, *(aff or (None, None)), y, halo="zero",
                       sw=sw, **emit)
    return y


def dec_s8_zero(xq: torch.Tensor, s1: Site, s2: Site, rows1, geo1: dict, geo2: dict, *,
                sw: int | None = None, tail=None) -> torch.Tensor:
    """deconv1 + deconv2 on the s8 carry under the zero halo (the ``dec_s8``
    of the zero-padded nets), on the phase-scattered block kernels ``geo1``,
    ``geo2`` (K3's ``kh``, ``kw``, ``pt``, ``pl_``): d1 (K3) takes the res
    chain's codes xq [B,H,W,C] and emits d2's codes at ``rows1`` = (qa, qc),
    rows over d1's 4 phases × c channels, floor 0 (the ReLU; zero beyond
    ``sw``); ``d2s`` on the codes (quantize is pointwise: it commutes with
    the shuffle); d2 (K3) returns its bf16 raw [B,2H,2W,4·c'], or with
    ``tail`` = (d3 site, qa, qc) emits deconv3's codes (``halo_out="zero2"``,
    floor 0, zero beyond 2·sw) into K6: the [B,2H,2W,12] bf16 tail output,
    its border the zero-SAME one. Both uncropped."""
    qa, qc = rows1
    r8 = k8.site_s8(xq, s1.wk, s1.ws, s1.bias, qa=qa, qc=qc, qlo=0.0, halo="zero", sw=sw,
                    **geo1)
    yd = d2s(r8, 2, r8.shape[-1] // 4).contiguous()
    if tail is None:
        return k8.site_s8(yd, s2.wk, s2.ws, s2.bias, halo="zero", **geo2)
    s3, qa3, qc3 = tail
    qd3 = k8.site_s8(yd, s2.wk, s2.ws, s2.bias, qa=qa3, qc=qc3, qlo=0.0, halo="zero",
                     halo_out="zero2", sw=None if sw is None else 2 * sw, **geo2)
    return k8.d3_s8_site(qd3, s3.wk, s3.ws, s3.bias)


def dec_d1(y: torch.Tensor, net, sites: dict, *, carry=None,
           static_stats: dict | None = None):
    """deconv1 on K4/K5 in the space-to-depth phase form: a 3×3 conv at the
    res grid with 4·64 phase outputs (edge halo; with ``carry`` = (r2, a2,
    c2) from ``res_chain`` block 5's residual add folds into its prologue,
    K5). Returns (d1 raw [B,H,W,256] bf16, mean4, inv4 [B,64]) — frozen in4
    statistics under ``static_stats``."""
    B, H, W, C = y.shape
    s1 = sites["d1"]
    aq, cq = _plain_quant(B, C, s1.qin, y.device)
    if carry is not None:
        r2p, a2p, c2p = carry
        r, sums, _ = k8.res_site_skip(r2p, y, aq, cq, a2p, c2p, -127.0, s1.wk, s1.ws,
                                      s1.bias, halo="edge", yout=False)
    else:
        r, sums = k8.res_site(y, aq, cq, -127.0, s1.wk, s1.ws, s1.bias, halo="edge")
    if static_stats is not None:
        return r, *_frozen(static_stats, "in4", B)
    return r, *_stats_phased(sums, float(H * W), 4)


def dec_d2(r: torch.Tensor, m4, inv4, net, sites: dict, *, static_stats: dict | None = None):
    """deconv2 on K4: ``d2s`` moves d1's phases to the 2× grid, where d2 runs
    with the in4 affine and ReLU folded into its quantize, 4·32 phase
    outputs. Returns (d2 raw [B,2H,2W,128] bf16, mean5, inv5 [B,32])."""
    B, s2 = r.shape[0], sites["d2"]
    a_eff, c_eff = quant_affine(m4, inv4, *_norm_params(net.in4), s2.qin)
    yd = d2s(r, 2, r.shape[-1] // 4).contiguous()  # [B,2H,2W,64] raw
    r2, sums2 = k8.res_site(yd, a_eff, c_eff, 0.0, s2.wk, s2.ws, s2.bias, halo="edge")
    if static_stats is not None:
        return r2, *_frozen(static_stats, "in5", B)
    return r2, *_stats_phased(sums2, float(yd.shape[1] * yd.shape[2]), 4)


def dec_chain(y: torch.Tensor, net, sites: dict, *, carry=None,
              static_stats: dict | None = None):
    """deconv1 + deconv2 on K4/K5 (``dec_i8``): ``dec_d1`` then ``dec_d2``.
    Returns (d2 raw [B,2H,2W,128] bf16, mean5, inv5 [B,32])."""
    r, m4, inv4 = dec_d1(y, net, sites, carry=carry, static_stats=static_stats)
    return dec_d2(r, m4, inv4, net, sites, static_stats=static_stats)


# ---------------------------------------------------------------------------
# the XLA form of the same sites (below the geometry gates)
# ---------------------------------------------------------------------------


def _qc(x: torch.Tensor, a: torch.Tensor, c: torch.Tensor, lo: float, site: Site,
        halo: str, tau: torch.Tensor | None = None, stride: int = 1) -> torch.Tensor:
    """One int8 site as the JAX engine's ``_qc`` runs it through XLA:
    q = clamp(round(x·a + c), lo, 127) over a 1-pixel halo (reflect, edge or
    zero codes) → exact int8 conv (``stride``) → acc·ws + bias in x's dtype
    (bf16, or f32 on the float32 chains, as ``.astype(xin.dtype)``). a, c:
    [B,C] quantize rows; ``tau`` [C]: a floor on x·a + c before the round (a
    TLU folded into the quantize, ReCoNet's ``_res_quant_xla``)."""
    v = x.float() * a[:, None, None, :] + c[:, None, None, :]
    if tau is not None:
        v = torch.maximum(v, tau)
    q = torch.clamp(torch.round(v), lo, 127.0)
    mode = {"reflect": "reflect", "edge": "replicate", "zero": "constant"}[halo]
    q = F.pad(q.permute(0, 3, 1, 2), (1, 1, 1, 1), mode=mode).permute(0, 2, 3, 1)
    acc = conv2d_i8(q, k8.unpack_weights(site.wk), stride=stride)
    return (acc.float() * site.ws + site.bias).to(x.dtype)


def qconv_xla(q: torch.Tensor, site: Site, kh: int, kw: int, pads, dtype) -> torch.Tensor:
    """The XLA form of an int8 conv: codes q (f32 or int8) zero-padded by
    ``pads`` = (top, bottom, left, right) → exact int32 conv → acc·ws + bias
    in ``dtype`` (``conv2d_i8(...).astype(f32) * ws + b`` then ``.astype``)."""
    t, b, l, r = pads
    qp = F.pad(q.double().permute(0, 3, 1, 2), (l, r, t, b)).permute(0, 2, 3, 1)
    acc = conv2d_i8(qp, k8.unpack_weights(site.wk, kh, kw).to(q.device))
    return (acc.float() * site.ws + site.bias).to(dtype)


def _st(static_stats: dict | None, site: str, t: torch.Tensor, B: int):
    """A norm's (mean, inv) [B,C]: frozen, else measured on the pixels of t."""
    if static_stats is not None and site in static_stats:
        return _frozen(static_stats, site, B)
    return in_stats(t)


def head_qc(x: torch.Tensor, net, sites: dict, *,
            static_stats: dict | None = None) -> torch.Tensor:
    """conv1, then conv2 and conv3 as int8 sites in the XLA form: the empty
    fused-site set, where ``transformer_net_s2d2.apply`` quantizes c2 and c3
    through ``_qc`` (stride 2, the pixel reflect halo; each site's pending
    norm and ReLU folded into its quantize, floor 0). Returns the activated
    res input (in3 applied)."""
    B = x.shape[0]
    y = net.conv1(x)
    for name, norm in (("c2", net.in1), ("c3", net.in2)):
        m, inv = _st(static_stats, "in1" if name == "c2" else "in2", y, B)
        a, c = quant_affine(m, inv, *_norm_params(norm), sites[name].qin)
        y = _qc(y, _batch(a, B), _batch(c, B), 0.0, sites[name], "reflect", stride=2)
    m3, inv3 = _st(static_stats, "in3", y, B)
    return apply_in_relu(y, m3, inv3, net.in3.weight, net.in3.bias)


def res_chain_qc(y: torch.Tensor, net, sites: dict, *,
                 static_stats: dict | None = None) -> torch.Tensor:
    """The five residual blocks as the JAX engine runs them where no Pallas
    res chain does (below ``res_supported``, or without ``res_i8`` in the
    set): each conv a ``_qc`` site, the block's in1 affine + ReLU folded into
    the b-site's quantize; with measured norms the residual norm is the plain
    ``instance_norm``, with frozen ones the deferred affine."""
    B, _, _, C = y.shape
    for i in range(1, NUM_RES + 1):
        blk = getattr(net, f"res{i}")
        sa, sb = sites[f"r{i}a"], sites[f"r{i}b"]
        r = _qc(y, *_plain_quant(B, C, sa.qin, y.device), -127.0, sa, "reflect")
        m, inv = _st(static_stats, f"r{i}in1", r, B)
        a_eff, c_eff = quant_affine(m, inv, *_norm_params(blk.in1), sb.qin)
        r = _qc(r, _batch(a_eff, B), _batch(c_eff, B), 0.0, sb, "reflect")
        if static_stats is None:
            y = instance_norm(r, blk.in2.weight, blk.in2.bias) + y
        else:
            m2, inv2 = _st(static_stats, f"r{i}in2", r, B)
            y = apply_in_relu(r, m2, inv2, blk.in2.weight, blk.in2.bias, relu=False) + y
    return y


def dec_d1_qc(y: torch.Tensor, net, sites: dict, *, static_stats: dict | None = None):
    """``dec_d1`` in the XLA form (below ``dec_supported``, or where the set
    names neither ``dec_i8`` nor ``dec_s8``): the same d1 site on the
    edge-haloed grid, in4 measured over the 4 phases."""
    B, _, _, C = y.shape
    s1 = sites["d1"]
    r = _qc(y, *_plain_quant(B, C, s1.qin, y.device), -127.0, s1, "edge")
    return r, *_st(static_stats, "in4", d2s(r, 2, r.shape[-1] // 4), B)


def dec_d2_qc(r: torch.Tensor, m4, inv4, net, sites: dict, *,
              static_stats: dict | None = None):
    """``dec_d2`` in the XLA form: the in4 affine folded into d2's quantize."""
    B, s2 = r.shape[0], sites["d2"]
    a_eff, c_eff = quant_affine(m4, inv4, *_norm_params(net.in4), s2.qin)
    r2 = _qc(d2s(r, 2, r.shape[-1] // 4), _batch(a_eff, B), _batch(c_eff, B), 0.0, s2, "edge")
    return r2, *_st(static_stats, "in5", d2s(r2, 2, r2.shape[-1] // 4), B)


def dec_chain_s8_static(y: torch.Tensor, net, sites: dict, static_stats: dict, *,
                        tail: bool = False):
    """deconv1 + deconv2 on s8 carries with frozen norms (``dec_s8``).

    y: the res output, bf16 (K2 quantizes it) or the s8 codes bridged from
    ``res_chain_s8_static(emit_qo=)`` (K3). d1 emits d2's codes with the
    frozen in4 affine + ReLU folded in (per-channel rows tiled over the 4
    phases, floor 0); ``d2s`` runs on the codes (quantize is pointwise, so
    it commutes with the shuffle and the edge halo). Returns (d2 raw
    [B,2H,2W,128] bf16, mean5, inv5) — or, with ``tail`` (``tail_s8``),
    deconv3's block output y12 [B,2H,2W,12] bf16 (``_tail_s8``)."""
    B = y.shape[0]
    s1, s2 = sites["d1"], sites["d2"]
    m4, inv4 = (t.float() for t in static_stats["in4"])
    qa, qc = (t[0].repeat(4).contiguous()
              for t in quant_affine(m4, inv4, *_norm_params(net.in4), s2.qin))
    if y.dtype == torch.int8:
        qd1 = k8.site_s8(y, s1.wk, s1.ws, s1.bias, qa=qa, qc=qc, qlo=0.0, halo="edge")
    else:
        aq, cq = _plain_quant(B, y.shape[-1], s1.qin, y.device)
        qd1 = k8.res_site_s8o(y, aq, cq, -127.0, s1.wk, s1.ws, s1.bias, qa, qc, halo="edge")
    qs = d2s(qd1, 2, qd1.shape[-1] // 4).contiguous()  # s8 at the 2× grid
    if tail:
        return _tail_s8(qs, net, sites, static_stats)
    r2 = k8.site_s8(qs, s2.wk, s2.ws, s2.bias, halo="edge")
    m5, inv5 = _frozen(static_stats, "in5", B)
    return r2, m5, inv5


def _in5_emit_affine(net, sites: dict, static_stats: dict):
    """deconv3's input quantize rows: the frozen in5 affine folded with d3's
    qin, tiled ×4 to d2's phase-major 128 channels (ReLU → floor 0)."""
    m5, inv5 = (t.float() for t in static_stats["in5"])
    return tuple(t[0].repeat(4).contiguous()
                 for t in quant_affine(m5, inv5, *_norm_params(net.in5), sites["d3"].qin))


def _d3_strip_i8(qsl: torch.Tensor, s3: Site) -> torch.Tensor:
    """deconv3 of a border strip of s8 codes with the true phase-permuted
    reflect halos (quantize is pointwise, so the reflect gather commutes
    with it): the same K rows and the same f32 dy-sum as K6."""
    rs = conv2d_i8(pad_reflect_f2_4px(qsl, 32), s3.w8)        # VALID 1×5 → 60 lanes
    rs = (rs.float() * s3.ws[:k8.D3_LANES]).to(torch.bfloat16)
    n = rs.shape[1] - 4
    y = sum(rs[:, dy:dy + n, :, dy * 12:(dy + 1) * 12].float() for dy in range(5))
    return (y + s3.bias).to(torch.bfloat16)


def _tail_strips_fix(y12: torch.Tensor, qd3: torch.Tensor, s3: Site) -> torch.Tensor:
    """Overwrite the 2-block zero-SAME border frame of y12 with the strips
    recomputed from the codes (top, bottom, left, right — corners exact)."""
    y12[:, :2] = _d3_strip_i8(qd3[:, :4], s3)[:, :2]
    y12[:, -2:] = _d3_strip_i8(qd3[:, -4:], s3)[:, -2:]
    y12[:, :, :2] = _d3_strip_i8(qd3[:, :, :4], s3)[:, :, :2]
    y12[:, :, -2:] = _d3_strip_i8(qd3[:, :, -4:], s3)[:, :, -2:]
    return y12


def _tail_s8(X: torch.Tensor, net, sites: dict, static_stats: dict) -> torch.Tensor:
    """deconv2 + deconv3 on the s8 carry (``tail_s8``): d2 (K3) emits
    deconv3's codes with the frozen in5 affine + ReLU folded in, K6 runs the
    tap-packed 1×5 conv with its dy-sum and bias, and the 2-block border
    frame is strip-fixed from the codes. X: d2's s8 input [B,H2,W2,64].
    Returns y12 [B,H2,W2,12] bf16 (the caller d2s's it to pixels)."""
    s2, s3 = sites["d2"], sites["d3"]
    qa5, qc5 = _in5_emit_affine(net, sites, static_stats)
    qd3 = k8.site_s8(X, s2.wk, s2.ws, s2.bias, qa=qa5, qc=qc5, qlo=0.0, halo="edge")
    y12 = k8.d3_s8_site(qd3, s3.wk, s3.ws, s3.bias)
    return _tail_strips_fix(y12, qd3, s3)


def _d3_strip(sl: torch.Tensor, m, inv, net, s3: Site) -> torch.Tensor:
    """The bf16 deconv3 of a border strip of the d2 raw: reflect halos, the
    in5 apply + ReLU, the 1×5 conv with the baked bf16 weights, and the
    dy-sum in bf16 (each add rounds)."""
    ps = apply_in_relu(pad_reflect_f2_4px(sl, 32), m, inv, net.in5.weight, net.in5.bias, 4)
    rs = conv2d(ps, s3.wb)                                       # VALID 1×5
    n = rs.shape[1] - 4
    return sum(rs[:, dy:dy + n, :, dy * 12:(dy + 1) * 12] for dy in range(5))


def d3_forward(y: torch.Tensor, m, inv, net, s3: Site, *, use_d3_i8: bool) -> torch.Tensor:
    """deconv3 in the JAX engine's tap-packed form with the IO post affine
    baked in (the d3 branch of ``transformer_net_s2d2.apply`` when d3 is an
    int8 site): y is the d2 raw [B,hb,wb,128] (4 phases × 32), m/inv its in5
    statistics. With ``use_d3_i8`` the rows conv is K7 (the in5 affine and
    ReLU folded into its quantize), else the bf16 conv with zero-SAME pads;
    either way the 2-block border frame comes from the bf16 strips, the
    dy-sum and the bias add round in bf16 at every add, as the JAX code
    does. Below 8 blocks the whole conv runs on the reflect-padded tensor.
    Returns [B,2hb,2wb,3] bf16 on the [0,1] scale (clamp only)."""
    hb, wb = y.shape[1], y.shape[2]

    def dysum(rows):
        return sum(rows[:, dy:dy + hb, :, dy * 12:(dy + 1) * 12] for dy in range(5))

    if hb >= 8 and wb >= 8:
        top = _d3_strip(y[:, :4], m, inv, net, s3)[:, :2]
        bot = _d3_strip(y[:, -4:], m, inv, net, s3)[:, -2:]
        lef = _d3_strip(y[:, :, :4], m, inv, net, s3)[:, :, :2]
        rig = _d3_strip(y[:, :, -4:], m, inv, net, s3)[:, :, -2:]
        if use_d3_i8:
            a, c = in_affine(m, inv, *_norm_params(net.in5))
            K = k8.d3_rows_site(y, (a.repeat(1, 4) * s3.qin).contiguous(),
                                (c.repeat(1, 4) * s3.qin).contiguous(), s3.wk, s3.ws)
            rows = F.pad(K, (0, 0, 0, 0, 2, 2))
        else:
            ya = apply_in_relu(y, m, inv, net.in5.weight, net.in5.bias, 4)
            rows = conv2d(F.pad(ya, (0, 0, 2, 2, 2, 2)), s3.wb)
        out = dysum(rows)
        out[:, :2] = top
        out[:, -2:] = bot
        out[:, :, :2] = lef
        out[:, :, -2:] = rig
    else:
        ya = apply_in_relu(pad_reflect_f2_4px(y, 32), m, inv, net.in5.weight, net.in5.bias, 4)
        out = dysum(conv2d(ya, s3.wb))
    out = out + s3.bias.to(out.dtype)
    return d2s(out, 2, 3)
