"""ReCoNet in the JAX engine's fast-form numerics: f32, bf16, frozen norms
(``--quantize bf16_static``) and the int8 res and decoder chains
(``--quantize int8``, ``int8_static``).

Port of ``neuralstyletransferv1_tpu/models/reconet_fast.py``: ``apply``,
``calibrate_act_scales``, ``calibrate_in_stats``, ``quantize_net``, the XLA
int8 references ``_res_quant_xla`` (``res_quant_xla``: no res name in the
set) and ``_dec_quant_xla`` (``dec_quant_xla``: ``dec_xla_i8``), and the
Pallas chains ``_res_chain_i8`` / ``_res_chain_i8_skip`` (``res_chain_i8``:
K4, and with ``RECO_SKIP`` K5 carrying the residual add and the post-add
activation), ``_res_chain_s8_static`` (K2 → K3), ``_dec_i8`` (``dec_i8``:
K4 at d1 and d2) and ``_dec_s8_static`` (``dec_s8`` with frozen norms: K2
at d1 emitting d2's codes at the edge halo, 192 → 384, then K3 at d2,
96 → 192).

The JAX module's f=2 block layout is a TPU lane answer; this port computes
the same function on pixels where the block form is only layout (conv1,
conv2, deconv3) and keeps the form where it is part of the numbers:
deconv1 and deconv2 (nearest ×2 upsample + reflect pad + 3×3 conv, which is
the 3×3 conv of the edge-haloed low-resolution grid with 4 phase outputs a
channel, ``s2d.scatter_upconv``), whose phase weights are summed in f32 and
whose int8 scales are taken over those weights. Each norm runs in the
deferred form: statistics in f32 over the conv's output (IN: mean and
rsqrt(E[x²] − mean² + 1e-5); FRN: 0 and rsqrt(E[x²] + 1e-5)), frozen or
measured, the affine and activation (ReLU, or the TLU max(y, tau)) in f32,
rounded back to the working dtype. The residual blocks activate after the
skip add.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..kernels import int8_sites as k8
from ..ops.conv import conv2d
from .reconet import NUM_RES, ReCoNet, post_act
from .s2d import d2s, in_affine, in_stats, pad_edge_blocks, quant_affine, scatter_upconv
from .sites_i8 import (Site, _batch, _plain_quant, _qc, _stats, _stats_phased, combine_as,
                       dec_supported, res_supported)
from .transformer_net_quant import quantize_site

EPS = 1e-5
RES_SITES = tuple(f"r{i}{ab}" for i in range(NUM_RES) for ab in "ab")
#: the names the JAX ReCoNet forward routes on
RECO_SITE_NAMES = ("res_i8", "res_s8", "dec_i8", "dec_s8", "dec_xla_i8")


class FastReCoNet(nn.Module):
    """The fast form's parameters (``from_reconet_params``) of an f32
    ``ReCoNet``: the pixel net,
    and deconv1/deconv2 as phase-form convs (``d{1,2}_w`` OIHW
    [4·cout, cin, 3, 3], ``d{1,2}_b`` the bias tiled over the 4 phases),
    scattered from the f32 weights; ``.to(torch.bfloat16)`` casts them after
    the f32 sums, as the JAX engine casts its fast params."""

    def __init__(self, net: ReCoNet):
        super().__init__()
        self.net = net
        self.frn = net.frn
        for name in ("dec1", "dec2"):
            conv = getattr(net, name).conv
            hwio = conv.weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0)
            w = torch.from_numpy(scatter_upconv(hwio).transpose(3, 2, 0, 1).copy())
            self.register_buffer(f"d{name[-1]}_w", w.to(conv.weight.device))
            self.register_buffer(f"d{name[-1]}_b", conv.bias.detach().float().repeat(4))


def norm_stats(x: torch.Tensor, frn: bool):
    """A norm's measured (mean, inv) [B,C] over the pixels of x (f32)."""
    if frn:
        nu2 = x.float().square().mean(dim=(1, 2))
        return torch.zeros_like(nu2), torch.rsqrt(nu2 + EPS)
    return in_stats(x)


def apply_norm(x: torch.Tensor, m, inv, norm, frn: bool, *, act: bool = True) -> torch.Tensor:
    """f32 a·x + c with (a, c) from the statistics and the norm's affine,
    then the activation (TLU max(y, tau), or ReLU), back in x's dtype."""
    a, c = in_affine(m, inv, norm.weight.float(), norm.bias.float())
    y = x.float() * a[:, None, None, :] + c[:, None, None, :]
    if act:
        y = torch.maximum(y, norm.tau.float()) if frn else torch.relu(y)
    return y.to(x.dtype)


def _sums_stats(sums: torch.Tensor, n: float, frn: bool, phases: int = 1):
    """(mean, inv) [B,C] from a kernel's [Σ, Σ²] [B,2,CO] over n pixels,
    CO = phases × C (``_res_i8_stats``, ``_stats_phased`` and the FRN form
    of ``_dec_i8``)."""
    if not frn:
        return _stats(sums, n) if phases == 1 else _stats_phased(sums, n, phases)
    b, _, co = sums.shape
    s2 = sums[:, 1] if phases == 1 else sums[:, 1].reshape(b, phases, co // phases).sum(1)
    s2 = s2 / (n * phases)
    return torch.zeros_like(s2), torch.rsqrt(s2 + EPS)


def _no_tap(site, t):
    return None


class _Norms:
    """Each norm's (mean, inv): frozen to ``static_stats[site]``, or measured
    (and recorded into ``stats_out``)."""

    def __init__(self, frn: bool, stats_out: dict | None, static_stats: dict | None):
        self.frn, self.stats_out, self.static_stats = frn, stats_out, static_stats

    def frozen(self, site: str):
        if self.static_stats is not None and site in self.static_stats:
            return tuple(t.float() for t in self.static_stats[site])
        return None

    def stats(self, site: str, x: torch.Tensor):
        fz = self.frozen(site)
        if fz is not None:
            return fz
        m, inv = norm_stats(x, self.frn)
        if self.stats_out is not None:
            self.stats_out[site] = (m, inv)
        return m, inv

    def __call__(self, site: str, norm, x: torch.Tensor, *, act: bool = True) -> torch.Tensor:
        return apply_norm(x, *self.stats(site, x), norm, self.frn, act=act)


def apply(fp: FastReCoNet, x: torch.Tensor, *, tap=None, sites: dict | None = None,
          fused_sites=(), static_stats: dict | None = None,
          stats_out: dict | None = None) -> torch.Tensor:
    """The forward of ``reconet_fast.apply``: NHWC model input (H, W
    divisible by 4) → tanh NHWC.

    ``tap(site, t)`` sees the tensor each calibrated conv consumes
    (``r{i}a``, ``r{i}b``, ``d1``, ``d2``); ``stats_out`` records and
    ``static_stats`` freezes each norm's ``(mean, inv)`` (``in1..in5``,
    ``r{i}in{1,2}``). ``sites``: ``prepare_sites`` of ``quantize_net`` (the
    int8 modes), routed by ``fused_sites`` as the JAX forward routes
    ``quant``: ``res_s8`` with frozen norms → ``res_chain_s8_static`` (K2/K3);
    ``res_i8`` → ``res_chain_i8`` (K4/K5); no res name → ``res_quant_xla``;
    a named chain the geometry refuses → the bf16 blocks; ``dec_s8`` with
    in4 and in5 frozen → ``dec_s8_static`` (K2/K3), else ``dec_i8`` →
    ``dec_i8`` (K4), both where the res grid and its double pass
    ``res_supported``; ``dec_xla_i8`` → ``dec_quant_xla``, else the bf16
    decoder."""
    tap = tap or _no_tap
    fused = set(fused_sites)
    unknown = sorted(fused - set(RECO_SITE_NAMES))
    if unknown:
        raise ValueError(f"unknown ReCoNet fused sites {unknown}; known: {RECO_SITE_NAMES}")
    net, frn = fp.net, fp.frn
    nh = _Norms(frn, stats_out, static_stats)
    y = nh("in1", net.enc1.norm, net.enc1.conv(x))
    y = nh("in2", net.enc2.norm, net.enc2.conv(y))
    y = nh("in3", net.enc3.norm, net.enc3.conv(y))

    use_q = sites is not None and all(s in sites for s in RES_SITES)
    use_res_s8 = use_res_i8 = False
    if use_q and {"res_i8", "res_s8"} & fused:
        ok_geo = res_supported(y.shape[1], y.shape[2])
        if "res_s8" in fused and static_stats is not None:
            use_res_s8 = ok_geo and all(f"r{i}in{j}" in static_stats
                                        for i in range(NUM_RES) for j in (1, 2))
        use_res_i8 = "res_i8" in fused and not use_res_s8 and ok_geo
    if use_res_s8:
        y = res_chain_s8_static(y, fp, sites, static_stats)
    elif use_res_i8:
        y = res_chain_i8(y, fp, sites, static_stats)
    elif use_q and not {"res_i8", "res_s8"} & fused:
        y = res_quant_xla(y, fp, sites, static_stats)
    else:
        for i in range(NUM_RES):
            blk = net.res(i)
            tap(f"r{i}a", y)
            r = nh(f"r{i}in1", blk.norm1, blk.conv1(y))
            tap(f"r{i}b", r)
            y = post_act(y + nh(f"r{i}in2", blk.norm2, blk.conv2(r), act=False), blk, frn)

    use_dec_s8 = use_dec_i8 = use_dec_xla = False
    if sites is not None and "d1" in sites and "d2" in sites:
        ok_dec = dec_supported(y.shape[1], y.shape[2])
        use_dec_s8 = ("dec_s8" in fused and static_stats is not None and "in4" in static_stats
                      and "in5" in static_stats and ok_dec)
        use_dec_i8 = "dec_i8" in fused and not use_dec_s8 and ok_dec
        use_dec_xla = not use_dec_s8 and not use_dec_i8 and "dec_xla_i8" in fused
    if use_dec_s8:
        y = dec_s8_static(y, fp, sites, static_stats)
    elif use_dec_i8:
        y = dec_i8(y, fp, sites, static_stats)
    elif use_dec_xla:
        y = dec_quant_xla(y, fp, sites, static_stats)
    else:
        tap("d1", y)
        r = conv2d(pad_edge_blocks(y), fp.d1_w, fp.d1_b)        # [B,H4,W4,4·96]
        y = d2s(r, 2, r.shape[-1] // 4)
        y = nh("in4", net.dec1.norm, y)
        tap("d2", y)
        r = conv2d(pad_edge_blocks(y), fp.d2_w, fp.d2_b)        # [B,H2,W2,4·48]
        y = nh("in5", net.dec2.norm, d2s(r, 2, r.shape[-1] // 4))
    return torch.tanh(net.final(y))


def prepare_sites(fp: FastReCoNet, quant: dict, device) -> dict[str, Site]:
    """``quantize_net`` output → device-resident sites; the conv biases come
    from ``fp`` (the bf16 fast form: the JAX engine reads them from its
    bf16-cast params; d1/d2's tiled over the phases)."""
    sites = {}
    for name, q in quant.items():
        if name in ("d1", "d2"):
            bias = getattr(fp, f"{name}_b")
        else:
            blk = fp.net.res(int(name[1]))
            bias = (blk.conv1 if name[2] == "a" else blk.conv2).bias
        sites[name] = Site(wk=k8.pack_weights(q["w"]).to(device),
                           ws=q["ws"].to(device, torch.float32),
                           bias=bias.float().to(device).contiguous(), qin=float(q["qin"]))
    return sites


def _tau_row(norm, qin: float, B: int) -> torch.Tensor:
    """A TLU folded into the next site's quantize: tau·qin, as a [B,C] row."""
    return _batch((norm.tau.float() * qin)[None], B)


def res_quant_xla(y: torch.Tensor, fp: FastReCoNet, sites: dict,
                  static_stats: dict | None = None) -> torch.Tensor:
    """``_res_quant_xla``: the four res blocks with every conv an int8 site
    in PyTorch ops (reflect halo), the norm1 affine and activation folded
    into the b-site's quantize (ReLU: floor 0; TLU: the pre-round floor
    tau·qin and floor −127), each norm over the bf16 conv output or frozen,
    the post-add activation after the skip."""
    B, _, _, C = y.shape
    net, frn = fp.net, fp.frn
    nh = _Norms(frn, None, static_stats)
    for i in range(NUM_RES):
        blk = net.res(i)
        sa, sb = sites[f"r{i}a"], sites[f"r{i}b"]
        r = _qc(y, *_plain_quant(B, C, sa.qin, y.device), -127.0, sa, "reflect")
        a1, c1 = quant_affine(*nh.stats(f"r{i}in1", r), blk.norm1.weight.float(),
                              blk.norm1.bias.float(), sb.qin)
        tau = (blk.norm1.tau.float() * sb.qin) if frn else None
        r = _qc(r, _batch(a1, B), _batch(c1, B), -127.0 if frn else 0.0, sb, "reflect", tau=tau)
        y = post_act(nh(f"r{i}in2", blk.norm2, r, act=False) + y, blk, frn)
    return y


def _site_stats(nh: _Norms, site: str, sums: torch.Tensor, n: float, B: int, phases: int = 1):
    fz = nh.frozen(site)
    if fz is not None:
        return tuple(_batch(t, B) for t in fz)
    return _sums_stats(sums, n, nh.frn, phases)


def res_chain_i8(y: torch.Tensor, fp: FastReCoNet, sites: dict,
                 static_stats: dict | None = None, *, skip: bool | None = None) -> torch.Tensor:
    """``_res_chain_i8``: the four res blocks' convs on K4 (reflect halo),
    the norm statistics from the kernels' sums (or frozen), norm1's affine
    and activation folded into the b-site's quantize (TLU: the ``tau``
    floor row, floor −127). With ``skip`` (default: ``adopt_overrides
    .flag("reco_skip", env="RECO_SKIP")``, ``_res_chain_i8_skip``) each
    block's norm2 apply, skip add and post-add activation fold into the next
    a-site's prologue (K5 with ``act``); only the last block's run in
    PyTorch ops. Without, they all do. An f32 y (the float32 chains) goes
    to block 0's K4 and block 1's K5 (without ``skip``: every block's K4) in
    their f32 forms, and the output is in y's dtype, as the JAX chains'
    ``.astype(dt)``."""
    from .. import adopt_overrides

    if skip is None:
        skip = adopt_overrides.flag("reco_skip", env="RECO_SKIP")
    y = y.contiguous()  # the kernels read dense NHWC (a cuDNN output may be an NCHW view)
    B, H, W, C = y.shape
    dt = y.dtype
    net, frn = fp.net, fp.frn
    nh = _Norms(frn, None, static_stats)
    n = float(H * W)
    carry = None
    for i in range(NUM_RES):
        blk = net.res(i)
        sa, sb = sites[f"r{i}a"], sites[f"r{i}b"]
        aq, cq = _plain_quant(B, C, sa.qin, y.device)
        if carry is None:
            r, sums = k8.res_site(y, aq, cq, -127.0, sa.wk, sa.ws, sa.bias)
        else:
            r2p, a2p, c2p, tprev = carry
            r, sums, y = k8.res_site_skip(r2p, y, aq, cq, a2p, c2p, -127.0, sa.wk, sa.ws,
                                          sa.bias, act="tau" if frn else "relu",
                                          tau_act=tprev)
        m, inv = _site_stats(nh, f"r{i}in1", sums, n, B)
        a_eff, c_eff = quant_affine(m, inv, blk.norm1.weight.float(), blk.norm1.bias.float(),
                                    sb.qin)
        tau = _tau_row(blk.norm1, sb.qin, B) if frn else None
        rb, sums2 = k8.res_site(r, a_eff, c_eff, -127.0 if frn else 0.0, sb.wk, sb.ws, sb.bias,
                                tau=tau)
        m2, inv2 = _site_stats(nh, f"r{i}in2", sums2, n, B)
        a2, c2 = (t.contiguous() for t in in_affine(m2, inv2, blk.norm2.weight.float(),
                                                     blk.norm2.bias.float()))
        if skip and i < NUM_RES - 1:
            carry = (rb, a2, c2, _batch(blk.act_tau.float()[None], B) if frn else None)
        else:
            y = post_act(combine_as(rb, y, a2, c2).to(dt), blk, frn)
    return y


def res_chain_s8_static(y: torch.Tensor, fp: FastReCoNet, sites: dict,
                        static_stats: dict) -> torch.Tensor:
    """``_res_chain_s8_static``: the four res blocks on s8 carries with frozen
    norms, reflect halos. Per block, K2 quantizes y (qin, floor −127),
    convolves and emits the b-site's codes with the frozen norm1 affine and
    activation folded in (ReLU: floor 0; TLU: the (C,) pre-round floor
    tau·qin and floor −127); K3 convolves them, applies the frozen norm2
    affine and adds y; the post-add activation runs in PyTorch ops. Every
    block's output is in y's dtype (the JAX chain's ``.astype(dt)``): an f32
    y goes to each block's K2 and K3 in their f32 forms."""
    y = y.contiguous()
    B, _, _, C = y.shape
    dt = y.dtype
    net, frn = fp.net, fp.frn
    for i in range(NUM_RES):
        blk = net.res(i)
        sa, sb = sites[f"r{i}a"], sites[f"r{i}b"]
        m1, inv1 = (t.float() for t in static_stats[f"r{i}in1"])
        m2, inv2 = (t.float() for t in static_stats[f"r{i}in2"])
        qa, qc = (t[0].contiguous() for t in quant_affine(
            m1, inv1, blk.norm1.weight.float(), blk.norm1.bias.float(), sb.qin))
        tau = (blk.norm1.tau.float() * sb.qin).contiguous() if frn else None
        aq, cq = _plain_quant(B, C, sa.qin, y.device)
        codes = k8.res_site_s8o(y, aq, cq, -127.0, sa.wk, sa.ws, sa.bias, qa, qc,
                                qlo=-127.0 if frn else 0.0, tau=tau)
        aa, ac = (t[0].contiguous() for t in in_affine(m2, inv2, blk.norm2.weight.float(),
                                                        blk.norm2.bias.float()))
        y = post_act(k8.site_s8(codes, sb.wk, sb.ws, sb.bias, aa, ac, y).to(dt), blk, frn)
    return y


def dec_i8(y: torch.Tensor, fp: FastReCoNet, sites: dict,
           static_stats: dict | None = None) -> torch.Tensor:
    """``_dec_i8``: deconv1 and deconv2 on K4 with the edge halo (the phase
    form's ``pad_edge_blocks``): d1 at the res grid, 192 → 4·96; its in4
    statistics per logical channel over the phases (or frozen); ``d2s`` to
    the 2× grid, where d2 runs 96 → 4·48 with the in4 affine and activation
    folded into its quantize (TLU: the ``tau`` floor row); the in5 apply in
    PyTorch ops. Returns the activated d2 output in pixels [B,4H,4W,48], in
    y's dtype (an f32 y: d1 on K4's f32 form, the in5 apply unrounded)."""
    y = y.contiguous()
    B, H, W, C = y.shape
    dt = y.dtype
    net, frn = fp.net, fp.frn
    nh = _Norms(frn, None, static_stats)
    s1, s2 = sites["d1"], sites["d2"]
    r, sums = k8.res_site(y, *_plain_quant(B, C, s1.qin, y.device), -127.0, s1.wk, s1.ws,
                          s1.bias, halo="edge")
    m, inv = _site_stats(nh, "in4", sums, float(H * W), B, phases=4)
    nd1 = net.dec1.norm
    a_eff, c_eff = quant_affine(m, inv, nd1.weight.float(), nd1.bias.float(), s2.qin)
    yd = d2s(r, 2, r.shape[-1] // 4).contiguous()
    r2, sums2 = k8.res_site(yd, a_eff, c_eff, -127.0 if frn else 0.0, s2.wk, s2.ws, s2.bias,
                            halo="edge", tau=_tau_row(nd1, s2.qin, B) if frn else None)
    m2, inv2 = _site_stats(nh, "in5", sums2, float(4 * H * W), B, phases=4)
    return apply_norm(d2s(r2, 2, r2.shape[-1] // 4).to(dt), m2, inv2, net.dec2.norm, frn)


def dec_s8_static(y: torch.Tensor, fp: FastReCoNet, sites: dict,
                  static_stats: dict) -> torch.Tensor:
    """``_dec_s8_static`` (``dec_s8``): deconv1 and deconv2 on an s8 carry
    with frozen norms, edge halos. d1 (K2, 192 → 4·96) quantizes y at its
    qin (floor −127), convolves and emits d2's codes with the frozen in4
    affine folded in, its (CO,) rows tiled ×4 over the phases (ReLU: floor 0;
    TLU: the pre-round floor row tau·qin, floor −127); ``d2s`` and the edge
    halo run on the codes (quantize is pointwise: it commutes with both); d2
    (K3, 96 → 4·48) returns its bf16 raw, and the frozen in5 apply and
    activation run in PyTorch ops. Returns the activated d2 output in pixels
    [B,4H,4W,48], in y's dtype."""
    y = y.contiguous()
    B, _, _, C = y.shape
    net, frn = fp.net, fp.frn
    s1, s2 = sites["d1"], sites["d2"]
    nd1 = net.dec1.norm
    m4, inv4 = (t.float() for t in static_stats["in4"])
    qa, qc = (t[0].repeat(4).contiguous() for t in quant_affine(
        m4, inv4, nd1.weight.float(), nd1.bias.float(), s2.qin))
    tau = (nd1.tau.float() * s2.qin).repeat(4).contiguous() if frn else None
    codes = k8.res_site_s8o(y, *_plain_quant(B, C, s1.qin, y.device), -127.0, s1.wk, s1.ws,
                            s1.bias, qa, qc, qlo=-127.0 if frn else 0.0, tau=tau, halo="edge")
    r2 = k8.site_s8(d2s(codes, 2, codes.shape[-1] // 4).contiguous(), s2.wk, s2.ws, s2.bias,
                    halo="edge")
    m5, inv5 = (t.float() for t in static_stats["in5"])
    return apply_norm(d2s(r2, 2, r2.shape[-1] // 4).to(y.dtype), m5, inv5, net.dec2.norm, frn)


def dec_quant_xla(y: torch.Tensor, fp: FastReCoNet, sites: dict,
                  static_stats: dict | None = None) -> torch.Tensor:
    """``_dec_quant_xla``: the same two sites in PyTorch int8 ops, the norm
    statistics over the bf16 conv outputs (or frozen)."""
    B, _, _, C = y.shape
    net, frn = fp.net, fp.frn
    nh = _Norms(frn, None, static_stats)
    s1, s2 = sites["d1"], sites["d2"]
    r = _qc(y, *_plain_quant(B, C, s1.qin, y.device), -127.0, s1, "edge")
    yd = d2s(r, 2, r.shape[-1] // 4)
    nd1 = net.dec1.norm
    a1, c1 = quant_affine(*nh.stats("in4", yd), nd1.weight.float(), nd1.bias.float(), s2.qin)
    tau = (nd1.tau.float() * s2.qin) if frn else None
    r2 = _qc(yd, _batch(a1, B), _batch(c1, B), -127.0 if frn else 0.0, s2, "edge", tau=tau)
    return nh("in5", net.dec2.norm, d2s(r2, 2, r2.shape[-1] // 4))


@torch.no_grad()
def calibrate_act_scales(fp: FastReCoNet, x_cal: torch.Tensor,
                         static_stats: dict | None = None) -> dict[str, float]:
    """Per-site max|activation| from one f32 forward on ``x_cal`` (model
    input, H, W divisible by 4) — against the static-norm graph when
    ``static_stats`` is given."""
    vals: dict[str, float] = {}

    def tap(site, t):
        vals[site] = float(t.float().abs().max())

    apply(fp, x_cal.float(), tap=tap, static_stats=static_stats)
    return vals


@torch.no_grad()
def calibrate_in_stats(fp: FastReCoNet, x_cal: torch.Tensor) -> dict:
    """Frozen ``(mean, inv)`` of every norm (FRN: ``(0, rsqrt(nu2 + eps))``)
    from one f32 forward, averaged over the calibration batch to (1, C)."""
    so: dict = {}
    apply(fp, x_cal.float(), stats_out=so)
    return {k: (m.mean(dim=0, keepdim=True), inv.mean(dim=0, keepdim=True))
            for k, (m, inv) in so.items()}


def quantize_net(fp: FastReCoNet, act_scales: dict) -> dict:
    """The ``quant`` dict (``quantize_net``'s contract): per-output-channel
    int8 weights of the f32 fast form, keyed ``r{i}{a,b}`` over the res
    blocks and ``d1``/``d2`` (the phase-form weights), for each site with a
    scale."""
    def hwio(w):
        return w.detach().float().cpu().numpy().transpose(2, 3, 1, 0)

    q = {}
    for i in range(NUM_RES):
        blk = fp.net.res(i)
        for ab, conv in (("a", blk.conv1), ("b", blk.conv2)):
            if f"r{i}{ab}" in act_scales:
                q[f"r{i}{ab}"] = quantize_site(hwio(conv.weight), act_scales[f"r{i}{ab}"])
    for site in ("d1", "d2"):
        if site in act_scales:
            q[site] = quantize_site(np.ascontiguousarray(hwio(getattr(fp, f"{site}_w"))),
                                    act_scales[site])
    return q
