"""The NST_Train net in the JAX engine's fast-form numerics: bf16, frozen
instance norms (``--quantize bf16_static``) and the int8 res chains
(``--quantize int8``, ``int8_static``).

Port of ``neuralstyletransferv1_tpu/models/transformer_net_nst_fast.py``:
``apply``, ``calibrate_act_scales``, ``calibrate_in_stats``,
``quantize_net``, ``_res_quant_xla`` (the res chain of ``--quantize int8``,
whose adopted NST set is empty) and ``_res_chain_s8_static`` (the adopted
``nst_static`` set ``res_i8, res_s8``: 5 × K2 + 5 × K3 with the zero halo).
The JAX module's f=2 block layout is a TPU lane answer; every NST conv is
zero-padded, so the block form computes the pixel net's function, and this
port runs the pixel convs of ``TransformerNetNST`` with the fast form's
norms: statistics E[x²] − mean² in f32 over each conv's bf16 output, the
affine (and ReLU) applied in f32 and rounded back (``models/s2d.py``).

The JAX forward's other int8 branches wait for kernel forms the port does
not have yet (ROADMAP.md Queue 2): ``_res_chain_i8`` (``res_i8`` without
frozen norms; K4/K5 with ``sw``), ``c2_i8`` (K4 2×2),
``dec_i8`` (K4 ``kh``/``kw``), ``dec_s8`` (K3 ``kh``/``kw``), ``tail_s8``
(K3 ``halo_out="zero2"`` + K6) and their XLA references ``dec_xla_i8`` /
``tail_xla_i8``. None is in an adopted set; a set naming one raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import int8_sites as k8
from .s2d import apply_in_relu, in_affine, quant_affine
from .sites_i8 import Site, _batch, _norm_params, _pick_ts, _plain_quant, _qc, _st
from .transformer_net import NormHooks
from .transformer_net_nst import NUM_RES, PAD, TransformerNetNST, pad_reflect
from .transformer_net_quant import quantize_site

RES_SITES = tuple(f"r{i}{ab}" for i in range(1, NUM_RES + 1) for ab in "ab")
#: the names the JAX NST forward routes on
NST_SITE_NAMES = ("res_i8", "res_s8", "c2_i8", "dec_i8", "dec_s8", "tail_s8", "dec_xla_i8",
                  "tail_xla_i8")
_QUEUE2 = "ROADMAP.md Queue 2 (NST kernel forms)"
_UNPORTED = {
    "c2_i8": "K4 as a 2x2 zero-halo block site",
    "dec_i8": "K4 with kh/kw = 2 and the zero halo",
    "dec_s8": "K3 with kh/kw = 2",
    "tail_s8": "K3 with halo_out='zero2', then K6",
    "dec_xla_i8": "the XLA int8 decoder (with dec_i8)",
    "tail_xla_i8": "the XLA int8 tail (with tail_s8)",
}


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
    ``quant``: ``res_s8`` with frozen norms → ``res_chain_s8_static``
    (K2/K3) where the res grid's height has a strip height; no res name →
    ``res_quant_xla``; a named chain the geometry refuses → the bf16
    blocks."""
    tap = tap or _no_tap
    fused = set(fused_sites)
    unknown = sorted(fused - set(NST_SITE_NAMES))
    if unknown:
        raise ValueError(f"unknown NST fused sites {unknown}; known: {NST_SITE_NAMES}")
    unported = sorted(fused & set(_UNPORTED)) if sites is not None else []
    if unported:
        raise NotImplementedError(
            f"NST fused site {unported[0]!r} needs {_UNPORTED[unported[0]]}: {_QUEUE2}")
    nh = NormHooks(stats_out, static_stats, deferred=True)
    h, w = x.shape[1], x.shape[2]
    y = pad_reflect(x, PAD)
    y = nh("in1", net.down1.norm, net.down1.conv(y))
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
    if use_res_s8:
        y = res_chain_s8_static(y, net, sites, static_stats)
    elif use_res_i8:
        raise NotImplementedError(
            "the NST res_i8 chain (measured norms) needs K4/K5 with sw: "
            + _QUEUE2)
    elif use_q and not {"res_i8", "res_s8"} & fused:
        y = res_quant_xla(y, net, sites, static_stats)
    else:
        for i in range(1, NUM_RES + 1):
            blk = getattr(net, f"res{i}")
            tap(f"r{i}a", y)
            r = nh(f"r{i}in1", blk.norm1, blk.conv1(y))
            tap(f"r{i}b", r)
            y = nh(f"r{i}in2", blk.norm2, blk.conv2(r), relu=False) + y

    tap("d1", y)
    y = nh("in4", net.up1.norm, net.up1.conv(y))
    tap("d2", y)
    y = nh("in5", net.up2.norm, net.up2.conv(y))
    tap("d3", y)
    return net.final(y)[:, PAD:PAD + h, PAD:PAD + w]


def prepare_sites(net: TransformerNetNST, quant: dict, device) -> dict[str, Site]:
    """``quantize_net`` output → device-resident res sites; the conv biases
    come from ``net`` (the bf16 net: the JAX engine reads them from its
    bf16-cast params)."""
    sites = {}
    for name, q in quant.items():
        blk = getattr(net, f"res{name[1]}")
        conv = blk.conv1 if name[2] == "a" else blk.conv2
        sites[name] = Site(wk=k8.pack_weights(q["w"]).to(device),
                           ws=q["ws"].to(device, torch.float32),
                           bias=conv.bias.float().to(device).contiguous(), qin=float(q["qin"]))
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
                        static_stats: dict) -> torch.Tensor:
    """``_res_chain_s8_static``: the five res blocks on s8 carries with frozen
    norms, zero halos. A width that is not a multiple of 8 (500 on the 1080p
    pad-40 grid) is zero-padded up once and ``sw`` = the content width masks
    the padding columns' codes in K2's input and output, so they never enter
    a dot; the bf16 carry's padding columns hold junk that the next K2
    masks, and the crop drops. Per block, K2 quantizes y (qin, floor −127),
    convolves and emits the b-site's codes with the frozen norm1 affine and
    ReLU folded in; K3 convolves them, applies the frozen norm2 affine and
    adds y. An f32 y (the float32 chains) goes to block 1's K2 and K3 in
    their f32 forms; the chain's bf16 output is cast back to y's dtype, as
    the JAX chain's ``y.astype(dt)``."""
    B, H, W0c, C = y.shape
    dt = y.dtype
    sw = None
    if W0c % 8:
        y = F.pad(y, (0, 0, 0, (-W0c) % 8))
        sw = W0c
    zeros = torch.zeros((B, C), dtype=torch.float32, device=y.device)
    for i in range(1, NUM_RES + 1):
        blk = getattr(net, f"res{i}")
        sa, sb = sites[f"r{i}a"], sites[f"r{i}b"]
        m1, inv1 = (t.float() for t in static_stats[f"r{i}in1"])
        m2, inv2 = (t.float() for t in static_stats[f"r{i}in2"])
        qa, qc = (t[0].contiguous() for t in quant_affine(m1, inv1, *_norm_params(blk.norm1),
                                                          sb.qin))
        aq = torch.full((B, C), sa.qin, dtype=torch.float32, device=y.device)
        codes = k8.res_site_s8o(y, aq, zeros, -127.0, sa.wk, sa.ws, sa.bias, qa, qc,
                                halo="zero", sw=sw)
        aa, ac = (t[0].contiguous() for t in in_affine(m2, inv2, *_norm_params(blk.norm2)))
        y = k8.site_s8(codes, sb.wk, sb.ws, sb.bias, aa, ac, y, halo="zero", sw=sw)
    return (y if sw is None else y[:, :, :sw].contiguous()).to(dt)


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
    """The ``quant`` dict of the res sites (``quantize_net``'s contract):
    per-output-channel int8 weights of the f32 net. The JAX function also
    quantizes c2/d1/d2/d3, which only the unported branches read."""
    def hwio(conv):
        return conv.weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0)

    return {site: quantize_site(hwio(getattr(getattr(net, f"res{site[1]}"),
                                             "conv1" if site[2] == "a" else "conv2")),
                                act_scales[site])
            for site in RES_SITES if site in act_scales}
