"""The NST_Train net in the JAX engine's fast-form numerics: bf16, frozen
instance norms (``--quantize bf16_static``) and the int8 res chains
(``--quantize int8``, ``int8_static``).

Port of ``neuralstyletransferv1_tpu/models/transformer_net_nst_fast.py``:
``apply`` with every int8 branch, ``calibrate_act_scales``,
``calibrate_in_stats``, ``quantize_net``, and the branches' chains:
``_res_quant_xla`` (no res name in the set: the adopted ``nst`` set is
empty), ``_res_chain_i8`` (``res_i8``: K4/K5 with ``sw``, the residual add
folded into the next a-site; the built-in default of both modes),
``_res_chain_s8_static`` (``res_s8`` under frozen norms: 5 × K2 + 5 × K3,
the adopted ``nst_static`` set), the ``c2_i8`` site (K4 2×2, pads 1),
``_dec_i8`` (``dec_i8``: K4 2×2, pads 0, with ``sw`` doubled through d2s),
``_dec_s8_static`` (``dec_s8`` / ``tail_s8``: K3 2×2, then K6) and
``_dec_quant_xla`` (``dec_xla_i8`` / ``tail_xla_i8``, PyTorch int8 ops).
The JAX module's f=2 block layout is a TPU lane answer; every NST conv is
zero-padded, so the block form computes the pixel net's function, and this
port runs the pixel convs of ``TransformerNetNST`` with the fast form's
norms: statistics E[x²] − mean² in f32 over each conv's bf16 output, the
affine (and ReLU) applied in f32 and rounded back (``models/s2d.py``). The
int8 sites of conv2 and the decoder run in the block forms the JAX weights
are quantized in (``block_weights``): conv2 on the space-to-depth grid of
conv1's output, the transposed convs on their four output phases.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import int8_sites as k8
from ..ops.conv import conv2d_i8
from .s2d import apply_in_relu, d2s, d3_tap_packed, in_affine, quant_affine, s2d, \
    scatter_stride2_f2
from .sites_i8 import (Site, _batch, _frozen, _norm_params, _pick_ts, _plain_quant, _qc, _st,
                       _stats, _stats_phased, combine_as, d3s8_supported, dec_s8_zero,
                       qconv_xla, res_chain_s8_zero, res_supported)
from .transformer_net import NormHooks
from .transformer_net_nst import NUM_RES, PAD, TransformerNetNST, pad_reflect
from .transformer_net_quant import quantize_site

RES_SITES = tuple(f"r{i}{ab}" for i in range(1, NUM_RES + 1) for ab in "ab")
#: the sites quantized in block form: conv2, the two transposed convs, and
#: the output conv tap-packed into 60 lanes
BLOCK_SITES = ("c2", "d1", "d2", "d3")
#: the names the JAX NST forward routes on
NST_SITE_NAMES = ("res_i8", "res_s8", "c2_i8", "dec_i8", "dec_s8", "tail_s8", "dec_xla_i8",
                  "tail_xla_i8")
#: the NST transposed convs (k3, stride 2, pad 1, output pad 1) scatter to 2×2
#: block convs with pads (0, 1): K4's and K3's 2×2 pad-0 form
_DEC_GEO = dict(kh=2, kw=2, pt=0, pl_=0)


def _no_tap(site, t):
    return None


def apply(net: TransformerNetNST, x: torch.Tensor, *, tap=None, sites: dict | None = None,
          fused_sites=(), static_stats: dict | None = None,
          stats_out: dict | None = None) -> torch.Tensor:
    """The forward of ``transformer_net_nst_fast.apply``: NHWC ``raw_01`` in
    (H, W divisible by 4 where the JAX engine calls it), cropped out.

    ``tap(site, t)`` sees the tensor each calibrated conv consumes (``c2``,
    ``r{i}a``, ``r{i}b``, ``d1``, ``d2``, ``d3``); ``stats_out`` records and
    ``static_stats`` freezes each norm's ``(mean, inv)`` (``in1..in5``,
    ``r{i}in{1,2}``). ``sites``: ``prepare_sites`` of ``quantize_net``
    (the int8 modes), routed by ``fused_sites`` as the JAX forward routes
    ``quant``: ``c2_i8`` → the K4 2×2 conv2 where ``res_supported`` takes its
    block grid; ``res_s8`` with frozen norms → ``res_chain_s8_static``
    (K2/K3), else ``res_i8`` → ``res_chain_i8`` (K4/K5), where the res grid's
    height has a strip height; ``dec_s8`` on that s8 chain with in4, in5
    frozen → ``dec_s8_static`` (K3), with ``tail_s8`` its deconv3 on K6;
    else ``dec_i8`` → ``dec_i8`` (K4), else ``dec_xla_i8`` →
    ``dec_quant_xla`` (with ``tail_xla_i8`` its deconv3); no res name →
    ``res_quant_xla``; a named chain the geometry refuses → the bf16
    blocks."""
    tap = tap or _no_tap
    fused = set(fused_sites)
    unknown = sorted(fused - set(NST_SITE_NAMES))
    if unknown:
        raise ValueError(f"unknown NST fused sites {unknown}; known: {NST_SITE_NAMES}")
    nh = NormHooks(stats_out, static_stats, deferred=True)
    h, w = x.shape[1], x.shape[2]
    y = pad_reflect(x, PAD)
    y = nh("in1", net.down1.norm, net.down1.conv(y))
    if (sites is not None and "c2" in sites and "c2_i8" in fused
            and res_supported(y.shape[1] // 2, y.shape[2] // 2)):
        y = c2_i8(y, net, sites["c2"], static_stats)
    else:
        tap("c2", y)
        y = nh("in2", net.down2.norm, net.down2.conv(y))
    y = nh("in3", net.down3.norm, net.down3.conv(y))

    use_q = sites is not None and all(s in sites for s in RES_SITES)
    use_res_s8 = use_res_i8 = False
    if use_q and {"res_i8", "res_s8"} & fused:
        # the chains pad the width up to %8 themselves: only H gates
        ok_geo = _pick_ts(y.shape[1]) is not None and y.shape[1] >= 8 and y.shape[2] >= 16
        if "res_s8" in fused and static_stats is not None:
            use_res_s8 = ok_geo and all(f"r{i}in{j}" in static_stats
                                        for i in range(1, NUM_RES + 1) for j in (1, 2))
        use_res_i8 = "res_i8" in fused and not use_res_s8 and ok_geo
    use_dec_s8 = (use_res_s8 and "dec_s8" in fused and "d1" in sites and "d2" in sites
                  and "in4" in static_stats and "in5" in static_stats
                  and _pick_ts(2 * y.shape[1]) is not None)
    # the tail's grid: (hp/2, 2·w0), w0 the %8-padded res width
    use_tail_s8 = (use_dec_s8 and "tail_s8" in fused and "d3" in sites
                   and d3s8_supported(2 * y.shape[1], 2 * (-(-y.shape[2] // 8) * 8)))
    if use_dec_s8:
        w0c, dt = y.shape[2], y.dtype
        xq = res_chain_s8_static(y, net, sites, static_stats, emit_qo=sites["d1"].qin)
        y = dec_s8_static(xq, net, sites, static_stats, w0c, dt, tail=use_tail_s8)
    elif use_res_s8:
        y = res_chain_s8_static(y, net, sites, static_stats)
    elif use_res_i8:
        y = res_chain_i8(y, net, sites, static_stats)
    elif use_q and not {"res_i8", "res_s8"} & fused:
        y = res_quant_xla(y, net, sites, static_stats)
    else:
        for i in range(1, NUM_RES + 1):
            blk = getattr(net, f"res{i}")
            tap(f"r{i}a", y)
            r = nh(f"r{i}in1", blk.norm1, blk.conv1(y))
            tap(f"r{i}b", r)
            y = nh(f"r{i}in2", blk.norm2, blk.conv2(r), relu=False) + y

    use_dec_i8 = use_dec_xla = False
    if not use_dec_s8 and sites is not None and "d1" in sites and "d2" in sites:
        if "dec_i8" in fused:
            use_dec_i8 = (_pick_ts(y.shape[1]) is not None and _pick_ts(2 * y.shape[1])
                          is not None and y.shape[1] >= 8 and y.shape[2] >= 16)
        use_dec_xla = not use_dec_i8 and "dec_xla_i8" in fused
    use_tail_xla = use_dec_xla and "tail_xla_i8" in fused and "d3" in sites
    if use_dec_i8:
        y = dec_i8(y, net, sites, static_stats)
    elif use_dec_xla:
        y = dec_quant_xla(y, net, sites, static_stats, tail=use_tail_xla)
    elif not use_dec_s8:
        tap("d1", y)
        y = nh("in4", net.up1.norm, net.up1.conv(y))
        tap("d2", y)
        y = nh("in5", net.up2.norm, net.up2.conv(y))
    if use_tail_s8 or use_tail_xla:
        out = d2s(y, 2, 3)  # y is deconv3's block output (bias added)
    else:
        if use_dec_s8 or use_dec_i8 or use_dec_xla:
            y = d2s(y, 2, 32)  # the decoder's block output → pixels
        tap("d3", y)
        out = net.final(y)
    return out[:, PAD:PAD + h, PAD:PAD + w]


def block_weights(net: TransformerNetNST) -> dict[str, np.ndarray]:
    """The f32 weights of the block-form sites, as ``from_nst_params`` builds
    ``c2_w``, ``d1_w``, ``d2_w``, ``d3_w``: conv2 as a 2×2 block conv
    [2,2,128,64] on conv1's space-to-depth output; each transposed conv
    scattered to its four output phases [2,2,Cin,4·Cout]; the output conv
    tap-packed [1,5,128,60]. (``prepare_sites`` takes the biases from the
    net, tiled ×4 over the phases.)"""
    from ..io.t7_fast import _scatter_convT_f2

    def hwio(w):
        return w.detach().float().cpu().numpy().transpose(2, 3, 1, 0)

    out = {"c2": scatter_stride2_f2(hwio(net.down2.conv.weight))}
    for site, up in (("d1", net.up1), ("d2", net.up2)):
        out[site] = _scatter_convT_f2(hwio(up.conv.weight), 3, 1, 1)[0]
    out["d3"] = d3_tap_packed(hwio(net.final.weight), np.zeros(3, np.float32))[0]
    return out


def c2_i8(y: torch.Tensor, net: TransformerNetNST, s2: Site,
          static_stats: dict | None = None) -> torch.Tensor:
    """The ``c2_i8`` branch: conv2 (3×3, stride 2, zero pad 1) as K4's 2×2
    pad-1 site on the space-to-depth grid of conv1's activated output y
    [B,hp,wp,32] (the zero halo's left column and top row are the pads),
    its in2 statistics from the site's sums or frozen; returns the
    activated [B,hp/2,wp/2,64] in y's dtype."""
    yb = s2d(y, 2).contiguous()
    B, Hc, Wc, Cin = yb.shape
    aq, cq = _plain_quant(B, Cin, s2.qin, y.device)
    r, sout = k8.res_site(yb, aq, cq, -127.0, s2.wk, s2.ws, s2.bias, halo="zero", kh=2, kw=2,
                          pt=1, pl_=1)
    if static_stats is not None and "in2" in static_stats:
        m, inv = _frozen(static_stats, "in2", B)
    else:
        m, inv = _stats(sout, float(Hc * Wc))
    return apply_in_relu(r.to(y.dtype), m, inv, *_norm_params(net.down2.norm))


def _pad8(y: torch.Tensor):
    """y padded with zero columns to a width that is a multiple of 8, and
    the content width sw (None when it already is one)."""
    w0c = y.shape[2]
    if w0c % 8 == 0:
        return y.contiguous(), None
    return F.pad(y, (0, 0, 0, (-w0c) % 8)).contiguous(), w0c


def res_chain_i8(y: torch.Tensor, net: TransformerNetNST, sites: dict,
                 static_stats: dict | None = None) -> torch.Tensor:
    """``_res_chain_i8``: the five res blocks on K4/K5 with the zero halo.
    A width that is not a multiple of 8 (500 on the 1080p pad-40 grid) is
    zero-padded once and every site masks the columns >= sw out of its
    quantize and its sums. Block 1's a-site on K4 (floor −127), every later
    a-site on K5, which folds the previous block's norm2 affine and residual
    add into its prologue and writes the sum v; every b-site on K4 (floor 0,
    the ReLU) with the norm1 affine folded into its quantize. Each norm is
    measured from the site's sums or frozen. 6 × K4 + 4 × K5. y bf16, or f32
    (the float32 chains: the first K4 and K5 take their f32 forms; the
    output is cast back, as the JAX chain's ``.astype(dt)``)."""
    B, H, W0c, C = y.shape
    dt = y.dtype
    y, sw = _pad8(y)
    n = float(H * W0c)
    ones, zeros = _plain_quant(B, C, 1.0, y.device)

    def stats(site, sums):
        if static_stats is not None and site in static_stats:
            return _frozen(static_stats, site, B)
        return _stats(sums, n)

    carry = None
    for i in range(1, NUM_RES + 1):
        blk = getattr(net, f"res{i}")
        sa, sb = sites[f"r{i}a"], sites[f"r{i}b"]
        aq = ones * sa.qin
        if carry is None:
            r, sout = k8.res_site(y, aq, zeros, -127.0, sa.wk, sa.ws, sa.bias, halo="zero",
                                  sw=sw)
        else:
            r2p, a2p, c2p = carry
            r, sout, y = k8.res_site_skip(r2p, y, aq, zeros, a2p, c2p, -127.0, sa.wk, sa.ws,
                                          sa.bias, halo="zero", sw=sw)
        a_eff, c_eff = quant_affine(*stats(f"r{i}in1", sout), *_norm_params(blk.norm1), sb.qin)
        r2, sout2 = k8.res_site(r, a_eff.contiguous(), c_eff.contiguous(), 0.0, sb.wk, sb.ws,
                                sb.bias, halo="zero", sw=sw)
        carry = (r2, *(t.contiguous() for t in in_affine(*stats(f"r{i}in2", sout2),
                                                           *_norm_params(blk.norm2))))
    r2, a2, c2 = carry
    y = combine_as(r2, y, a2, c2).to(dt)
    return y if sw is None else y[:, :, :sw].contiguous()


def dec_i8(y: torch.Tensor, net: TransformerNetNST, sites: dict,
           static_stats: dict | None = None) -> torch.Tensor:
    """``_dec_i8``: deconv1 and deconv2 as K4's 2×2 pad-0 sites on their
    four output phases (zero halo), in4 / in5 from the sites' sums over the
    phases or frozen, d2s between them. A res width that is not a multiple
    of 8 pads up with sw; d2s keeps the padding columns together at the
    right edge, so deconv2 runs with 2·sw. Returns the activated d2 output
    in block form [B,hp/2,wp/2,128] (4 phases × 32) in y's dtype."""
    B, H, W0c, C = y.shape
    dt = y.dtype
    s1, s2 = sites["d1"], sites["d2"]
    y, sw = _pad8(y)
    n = float(H * W0c)

    def stats(site, sums, nn):
        if static_stats is not None and site in static_stats:
            return _frozen(static_stats, site, B)
        return _stats_phased(sums, nn, 4)

    aq, cq = _plain_quant(B, C, s1.qin, y.device)
    r, sout = k8.res_site(y, aq, cq, -127.0, s1.wk, s1.ws, s1.bias, halo="zero", sw=sw,
                          **_DEC_GEO)
    a_eff, c_eff = quant_affine(*stats("in4", sout, n), *_norm_params(net.up1.norm), s2.qin)
    r2, sout2 = k8.res_site(d2s(r, 2, 64).contiguous(), a_eff.contiguous(), c_eff.contiguous(),
                            0.0, s2.wk, s2.ws, s2.bias, halo="zero",
                            sw=None if sw is None else 2 * sw, **_DEC_GEO)
    m2, inv2 = stats("in5", sout2, 4.0 * n)
    if sw is not None:
        r2 = r2[:, :, :2 * sw]
    return apply_in_relu(r2.to(dt), m2, inv2, *_norm_params(net.up2.norm), 4)


def _in_stats_phased(t: torch.Tensor, phases: int):
    """``_in_stats(t, phases, c)``: the (mean, inv) [B,c] of a block tensor
    whose channels are ``phases`` copies of c logical channels."""
    b, hb, wb, co = t.shape
    tr = t.reshape(b, hb, wb, phases, co // phases).float()
    mean = tr.mean(dim=(1, 2, 3))
    var = tr.square().mean(dim=(1, 2, 3)) - mean * mean
    return mean, torch.rsqrt(var + 1e-5)


def dec_quant_xla(y: torch.Tensor, net: TransformerNetNST, sites: dict,
                  static_stats: dict | None = None, *, tail: bool = False) -> torch.Tensor:
    """``_dec_quant_xla``: deconv1 and deconv2 in PyTorch int8 ops (the
    reference of ``dec_i8``), each a quantize then an exact int8 conv of the
    2×2 phase weights over the zero pads (0, 1), in4 / in5 measured over the
    phases or frozen. Returns the activated d2 output in block form, or,
    with ``tail`` (the reference of ``tail_s8``), deconv3's block output
    [B,hp/2,wp/2,12] bf16: d3's codes quantized from the d2 raw with the in5
    affine folded, the 1×5 int8 rows conv, K = bf16(acc·ws), the f32 dy-sum
    and the bias."""
    B = y.shape[0]
    s1, s2 = sites["d1"], sites["d2"]
    xq = torch.clamp(torch.round(y.float() * s1.qin), -127.0, 127.0)
    r = qconv_xla(xq, s1, 2, 2, (0, 1, 0, 1), y.dtype)
    m, inv = (_frozen(static_stats, "in4", B) if static_stats is not None
              and "in4" in static_stats else _in_stats_phased(r, 4))
    a1, c1 = quant_affine(m, inv, *_norm_params(net.up1.norm), s2.qin)
    yd = d2s(r, 2, 64)
    rq = torch.clamp(torch.round(yd.float() * a1[:, None, None, :] + c1[:, None, None, :]),
                     0.0, 127.0)
    r2 = qconv_xla(rq, s2, 2, 2, (0, 1, 0, 1), y.dtype)
    m2, inv2 = (_frozen(static_stats, "in5", B) if static_stats is not None
                and "in5" in static_stats else _in_stats_phased(r2, 4))
    if not tail:
        return apply_in_relu(r2, m2, inv2, *_norm_params(net.up2.norm), 4)
    s3 = sites["d3"]
    a5, b5 = (t.repeat(1, 4)[:, None, None, :]
              for t in quant_affine(m2, inv2, *_norm_params(net.up2.norm), s3.qin))
    qd3 = torch.clamp(torch.round(r2.float() * a5 + b5), 0.0, 127.0)
    h2 = r2.shape[1]
    K = conv2d_i8(F.pad(qd3, (0, 0, 2, 2, 2, 2)), s3.w8)
    K = (K.float() * s3.ws[:k8.D3_LANES]).to(torch.bfloat16)
    y12 = sum(K[:, dy:dy + h2, :, dy * 12:(dy + 1) * 12].float() for dy in range(5))
    return (y12 + s3.bias).to(torch.bfloat16)


def prepare_sites(net: TransformerNetNST, quant: dict, device) -> dict[str, Site]:
    """``quantize_net`` output → device-resident sites; the conv biases
    come from ``net`` (the bf16 net: the JAX engine reads them from its
    bf16-cast params), tiled ×4 over the phases for d1, d2 and d3. d3 is
    K6's: its 60 lanes padded to 64, and its int8 weights ``w8`` for the
    XLA form."""
    sites = {}
    for name, q in quant.items():
        if name == "d3":
            sites[name] = Site(
                wk=k8.pack_weights(q["w"], co_pad=k8.CO_TILE).to(device),
                ws=F.pad(q["ws"].to(torch.float32), (0, k8.CO_TILE - k8.D3_LANES)).to(device),
                bias=net.final.bias.float().repeat(4).to(device).contiguous(),
                qin=float(q["qin"]), w8=q["w"].to(device))
            continue
        if name in BLOCK_SITES:
            conv = {"c2": net.down2, "d1": net.up1, "d2": net.up2}[name].conv
            bias = conv.bias.float().repeat(1 if name == "c2" else 4)
        else:
            blk = getattr(net, f"res{name[1]}")
            bias = (blk.conv1 if name[2] == "a" else blk.conv2).bias.float()
        sites[name] = Site(wk=k8.pack_weights(q["w"]).to(device),
                           ws=q["ws"].to(device, torch.float32),
                           bias=bias.to(device).contiguous(), qin=float(q["qin"]))
    return sites


def res_quant_xla(y: torch.Tensor, net: TransformerNetNST, sites: dict,
                  static_stats: dict | None = None) -> torch.Tensor:
    """``_res_quant_xla``: the five res blocks with every conv an int8 site
    in PyTorch ops (zero halo), the in1 affine + ReLU folded into the
    b-site's quantize, each norm over the bf16 conv output (deferred form)
    or frozen."""
    B, _, _, C = y.shape
    for i in range(1, NUM_RES + 1):
        blk = getattr(net, f"res{i}")
        sa, sb = sites[f"r{i}a"], sites[f"r{i}b"]
        r = _qc(y, *_plain_quant(B, C, sa.qin, y.device), -127.0, sa, "zero")
        m, inv = _st(static_stats, f"r{i}in1", r, B)
        a_eff, c_eff = quant_affine(m, inv, *_norm_params(blk.norm1), sb.qin)
        r = _qc(r, _batch(a_eff, B), _batch(c_eff, B), 0.0, sb, "zero")
        m2, inv2 = _st(static_stats, f"r{i}in2", r, B)
        y = apply_in_relu(r, m2, inv2, blk.norm2.weight, blk.norm2.bias, relu=False) + y
    return y


def res_chain_s8_static(y: torch.Tensor, net: TransformerNetNST, sites: dict,
                        static_stats: dict, *, emit_qo: float | None = None) -> torch.Tensor:
    """``_res_chain_s8_static``: the five res blocks on s8 carries with frozen
    norms, zero halos (``sites_i8.res_chain_s8_zero``). A width that is not a
    multiple of 8 (500 on the 1080p pad-40 grid) is zero-padded up once and
    ``sw`` = the content width masks the padding columns' codes in K2's input
    and output, so they never enter a dot; the bf16 carry's padding columns
    hold junk that the next K2 masks, and the crop drops. Per block, K2's
    emit folds the frozen norm1 affine and ReLU, K3 applies the frozen norm2
    affine and adds y. An f32 y (the float32 chains) goes to block 1's K2 and
    K3 in their f32 forms; the chain's bf16 output is cast back to y's dtype,
    as the JAX chain's ``y.astype(dt)``. ``emit_qo`` (``dec_s8``): the last
    K3 also quantizes its sum at that scale (floor −127), and the chain
    returns deconv1's s8 codes [B,H,W8,C] at the padded width instead."""
    B, H, W0c, C = y.shape
    dt = y.dtype
    sw = None
    if W0c % 8:
        y = F.pad(y, (0, 0, 0, (-W0c) % 8))
        sw = W0c
    blocks = []
    for i in range(1, NUM_RES + 1):
        blk = getattr(net, f"res{i}")
        m1, inv1 = (t.float() for t in static_stats[f"r{i}in1"])
        m2, inv2 = (t.float() for t in static_stats[f"r{i}in2"])
        emit = tuple(t[0].contiguous() for t in quant_affine(
            m1, inv1, *_norm_params(blk.norm1), sites[f"r{i}b"].qin))
        aff = tuple(t[0].contiguous() for t in in_affine(m2, inv2, *_norm_params(blk.norm2)))
        blocks.append((sites[f"r{i}a"], sites[f"r{i}b"], emit, aff))
    y = res_chain_s8_zero(y, blocks, sw=sw, emit_qo=emit_qo)
    if emit_qo is not None:
        return y
    return (y if sw is None else y[:, :, :sw].contiguous()).to(dt)


def _in_rows(norm, stats, qin: float):
    """A frozen norm's affine folded with the next site's qin, as (CO,) rows
    tiled ×4 over the transposed conv's phases."""
    m, inv = (t.float() for t in stats)
    return tuple(t[0].repeat(4).contiguous()
                 for t in quant_affine(m, inv, *_norm_params(norm), qin))


def dec_s8_static(xq: torch.Tensor, net: TransformerNetNST, sites: dict, static_stats: dict,
                  w0c: int, dt: torch.dtype, *, tail: bool = False) -> torch.Tensor:
    """``_dec_s8_static`` (``dec_s8``; ``sites_i8.dec_s8_zero``): deconv1 on
    K3's 2×2 pad-0 form takes the res chain's s8 codes xq [B,H,W8,128] and
    emits deconv2's codes with the frozen in4 affine and ReLU folded in
    (zero beyond sw), d2s on the codes, then deconv2 on the same form: the
    bf16 raw, cropped to 2·w0c and activated with the frozen in5 (block form
    [B,hp/2,2·w0c,128] in ``dt``); or, with ``tail`` (``tail_s8``),
    deconv3's codes with the frozen in5 affine and ReLU folded in
    (``halo_out="zero2"``, zero beyond 2·sw) and deconv3 on K6:
    [B,hp/2,2·w0c,12] bf16, its border the zero-SAME one of the
    zero-padded net. w0c: the res grid's content width."""
    sw = w0c if w0c % 8 else None
    rows4 = _in_rows(net.up1.norm, static_stats["in4"], sites["d2"].qin)
    rows5 = (sites["d3"], *_in_rows(net.up2.norm, static_stats["in5"], sites["d3"].qin)) \
        if tail else None
    out = dec_s8_zero(xq, sites["d1"], sites["d2"], rows4, _DEC_GEO, _DEC_GEO, sw=sw,
                      tail=rows5)
    if sw is not None:
        out = out[:, :, :2 * sw].contiguous()
    if tail:
        return out
    m5, inv5 = (t.float() for t in static_stats["in5"])
    return apply_in_relu(out.to(dt), m5, inv5, *_norm_params(net.up2.norm), 4)


@torch.no_grad()
def calibrate_act_scales(net: TransformerNetNST, x_cal: torch.Tensor,
                         static_stats: dict | None = None) -> dict[str, float]:
    """Per-site max|activation| from one f32 forward on ``x_cal`` (raw_01,
    H, W divisible by 4) — against the static-norm graph when
    ``static_stats`` is given."""
    vals: dict[str, float] = {}

    def tap(site, t):
        vals[site] = float(t.float().abs().max())

    apply(net, x_cal.float(), tap=tap, static_stats=static_stats)
    return vals


@torch.no_grad()
def calibrate_in_stats(net: TransformerNetNST, x_cal: torch.Tensor) -> dict:
    """Frozen ``(mean, inv)`` of every norm from one f32 forward, averaged
    over the calibration batch to shape (1, C)."""
    so: dict = {}
    apply(net, x_cal.float(), stats_out=so)
    return {k: (m.mean(dim=0, keepdim=True), inv.mean(dim=0, keepdim=True))
            for k, (m, inv) in so.items()}


def quantize_net(net: TransformerNetNST, act_scales: dict) -> dict:
    """The ``quant`` dict (``quantize_net``'s contract): per-output-channel
    int8 weights of the f32 net and folded activation scales, for the res
    sites and for c2, d1, d2, d3 in their block forms (``block_weights``)."""
    def hwio(conv):
        return conv.weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0)

    q = {site: quantize_site(hwio(getattr(getattr(net, f"res{site[1]}"),
                                          "conv1" if site[2] == "a" else "conv2")),
                             act_scales[site])
         for site in RES_SITES if site in act_scales}
    if any(site in act_scales for site in BLOCK_SITES):
        blocks = block_weights(net)
        q.update({site: quantize_site(blocks[site], act_scales[site])
                  for site in BLOCK_SITES if site in act_scales})
    return q
