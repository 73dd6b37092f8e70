"""The fast form of Johnson-shaped ``.t7`` stylizers (BN-folded and
instance-norm graphs), with their int8 res chains.

Port of ``neuralstyletransferv1_tpu/io/t7_fast.py``: the matcher and weight
folds (``try_fast_johnson``: every static SpatialBatchNormalization folded
into its conv, instance norms deferred), the f=2 block-space forward
(``t7_fast_apply``), its calibration (``calibrate_t7_scales``,
``calibrate_t7_in_stats``), the static-norm fold (``fold_static_in``), the
int8 weights (``quantize_t7``), two res chains: ``_t7_res_chain_i8``
(``res_i8``: K4/K5 with the zero halo, each block's residual add folded into
the next a-site's prologue) and ``_t7_res_quant_xla`` (no res name in the
set: PyTorch int8 ops, the adopted route of BN-folded graphs), the ``c2_i8``
site (K4's 2×2 pad-1 form on conv2's block grid), ``_t7_dec_i8``
(``dec_i8``: the transposed convs on K4's zero-halo forms, 2×2 pad 0 for a
k3 deconv and 3×3 pad 1 for a k4 one, ``_dec_kform``) and its PyTorch-int8
references ``_t7_dec_quant_xla`` (``dec_xla_i8``) and
``_t7_tail_quant_xla`` (``tail_xla_i8``), and the s8 carries of BN-folded
graphs (every scale static): ``_t7_res_chain_i8_s8c`` (``res_s8``: K2 → K3
per block, the residual add in K3's epilogue), ``_t7_dec_i8_s8``
(``dec_s8``: K3 → K3 on the transposed convs' block kernels; with
``tail_s8`` deconv2 emits the output conv's codes into K6).

The eccv16 / jcjohnson Torch7 nets are zero-padded, so the block form is
exact (the zero pads ride the convs) and the port runs it as the JAX package
does: conv1 as a 5×5 block conv of the space-to-depth input, conv2 as a 2×2
block conv, conv3 at stride 2, the residual blocks on the quarter grid, the
transposed convs as phase-scattered block convs (``_scatter_convT_f2``) and
the 9×9 output conv tap-packed into a 1×5 conv to 60 lanes with a 5-row sum.
The parameters are a dict of tensors in the JAX package's layouts (HWIO).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import int8_sites as k8
from ..models.s2d import (apply_in_relu, d2s, in_affine, quant_affine, s2d, scatter_k9_f2,
                          scatter_stride2_f2)
from ..ops.conv import conv2d_i8
from ..models.sites_i8 import (Site, _plain_quant, _qc, _stats, _stats_phased, combine_as,
                               d3s8_supported, dec_s8_zero, qconv_xla, res_chain_s8_zero,
                               res_supported)
from ..models.transformer_net_quant import quantize_site
from .t7 import tree_map

#: the names the JAX ``t7_fast_apply`` routes on
T7_SITE_NAMES = ("res_i8", "res_s8", "dec_s8", "dec_i8", "tail_s8", "c2_i8", "dec_xla_i8",
                 "tail_xla_i8")


def _np(a) -> np.ndarray | None:
    """A layer array (numpy, or a tensor of a slot on its device) as numpy f32."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().float().numpy()
    return np.asarray(a, np.float32)


def _fold_bn(w, b, bn):
    """conv(+bias) followed by static batchnorm → adjusted conv weights."""
    if bn is None:
        return w, (b if b is not None else np.zeros(w.shape[-1], np.float32))
    mean = _np(bn["running_mean"])
    var = _np(bn["running_var"])
    if mean is None or var is None:
        return None, None
    s = 1.0 / np.sqrt(var + bn["eps"])
    if bn["weight"] is not None:
        s = s * _np(bn["weight"])
    beta = _np(bn["bias"]) if bn["bias"] is not None else 0.0
    b0 = b if b is not None else np.zeros(w.shape[-1], np.float32)
    return w * s, (b0 - mean) * s + beta


def _scatter_convT_f2(w_hwoi: np.ndarray, k: int, pad: int, adj: int):
    """SpatialFullConvolution (k, stride 2, pad, adj) → a 2×-phase block conv.

    w_hwoi: (k, k, Cout, Cin) as ``build_t7_layers`` stores it. Returns
    (w_blk [kb,kb,Cin,4·Cout], (pad_lo, pad_hi)) such that a VALID conv over
    the zero-padded input grid equals the transposed conv, output channel
    (qr·2 + qc)·Cout + c. Needs an output of twice the input:
    k + adj − 2·pad == 2. Output 2J+q of the flipped, (k−1−pad)-padded
    dilated conv reads x[(2J+q+κ−(k−1−pad))/2] for even numerators."""
    if k + adj - 2 * pad != 2:
        return None
    wf = np.transpose(w_hwoi[::-1, ::-1], (0, 1, 3, 2))  # flip spatial → (k,k,Cin,Cout)
    ci, co = wf.shape[2], wf.shape[3]
    taps = {0: [], 1: []}  # phase q → [(block offset, kernel index)]
    for q in range(2):
        for kk in range(k):
            num = q + kk - (k - 1 - pad)
            if num % 2 == 0:
                taps[q].append((num // 2, kk))
    offs = [o for tl in taps.values() for (o, _) in tl]
    lo, hi = -min(offs), max(offs)
    kb = lo + hi + 1
    out = np.zeros((kb, kb, ci, 4 * co), np.float32)
    for qr in range(2):
        for qc in range(2):
            for (oa, ka) in taps[qr]:
                for (ob, kc) in taps[qc]:
                    out[oa + lo, ob + lo, :, (qr * 2 + qc) * co:(qr * 2 + qc + 1) * co] \
                        += wf[ka, kc]
    return out, (lo, hi)


class _Cursor:
    def __init__(self, layers):
        self.ls = list(layers)
        self.i = 0

    def peek(self):
        return self.ls[self.i] if self.i < len(self.ls) else None

    def take(self, op):
        l = self.peek()
        if l is not None and l["op"] == op:
            self.i += 1
            return l
        return None


def _norm_of(cur, co):
    """Consume an optional norm layer: BN → ("fold", bn) (a static affine),
    IN → ("defer", {scale, bias, eps}) (runtime statistics), none → None."""
    bn = cur.take("batchnorm")
    if bn is not None:
        return ("fold", bn)
    inorm = cur.take("instancenorm")
    if inorm is not None:
        sc = _np(inorm["weight"]) if inorm["weight"] is not None else np.ones(co, np.float32)
        bi = _np(inorm["bias"]) if inorm["bias"] is not None else np.zeros(co, np.float32)
        return ("defer", {"scale": sc, "bias": bi, "eps": float(inorm["eps"])})
    return None


def _take_conv_bn_relu(cur, *, relu=True):
    """conv [+norm] [+relu]; an explicit zero_pad layer folds into the conv
    pad. Returns (w, b, stride, pad, deferred norm or None) with a static BN
    folded into (w, b), or None on a mismatch."""
    extra = 0
    zp = cur.take("zero_pad")
    if zp is not None:
        extra = zp["pad"]
    c = cur.take("conv")
    if c is None:
        return None
    norm = _norm_of(cur, c["w"].shape[-1])
    bn = norm[1] if (norm is not None and norm[0] == "fold") else None
    w, b = _fold_bn(_np(c["w"]), _np(c["b"]), bn)
    if w is None:
        return None
    if relu and cur.take("relu") is None:
        return None
    pad = (c["pad"][0] + extra, c["pad"][1] + extra)
    dn = norm[1] if (norm is not None and norm[0] == "defer") else None
    return w, b, c["stride"], pad, dn


def _fold_bn_phases(wb, b, bn):
    """The BN fold of a phase-scattered transposed-conv weight: its 4·Cout
    outputs are 4 phase copies of the Cout logical channels."""
    co4 = wb.shape[-1]
    co = co4 // 4
    if bn is None:
        bb = np.zeros(co4, np.float32) if b is None else np.tile(b, 4)
        return wb, bb
    if bn["running_mean"] is None or bn["running_var"] is None:
        return None, None
    s = 1.0 / np.sqrt(_np(bn["running_var"]) + bn["eps"])
    if bn["weight"] is not None:
        s = s * _np(bn["weight"])
    beta = _np(bn["bias"]) if bn["bias"] is not None else np.zeros(co, np.float32)
    b0 = b if b is not None else np.zeros(co, np.float32)
    s4, m4 = np.tile(s, 4), np.tile(_np(bn["running_mean"]), 4)
    bb = (np.tile(b0, 4) - m4) * s4 + np.tile(beta, 4)
    return wb * s4, bb


def params_to(p: dict, device, dtype: torch.dtype = torch.float32) -> dict:
    """The fast-form params with every tensor ``dtype`` on ``device`` (the
    JAX engine casts its fast params to the compute dtype the same way)."""
    return tree_map(lambda t: t.to(device, dtype), p)


def try_fast_johnson(layers: list[dict]) -> dict | None:
    """Recognize the zero-padded Johnson topology in a ``build_t7_layers``
    list and return the f=2 block-space params (f32 tensors on the CPU, the
    JAX package's dict and layouts), or None to keep the exact executor."""
    cur = _Cursor(layers)
    p: dict = {}
    # head: conv9 s1 pad4, conv3 s2 pad1, conv3 s2 pad1
    h1 = _take_conv_bn_relu(cur)
    if h1 is None:
        return None
    w, b, st, pad, dn = h1
    if w.shape[:2] != (9, 9) or w.shape[2] != 3 or st != (1, 1) or pad != (4, 4):
        return None
    c0 = w.shape[3]
    p["c1_w"] = scatter_k9_f2(w)
    p["c1_b"] = np.tile(b, 4)
    p["n1"] = dn
    h2 = _take_conv_bn_relu(cur)
    if h2 is None:
        return None
    w, b, st, pad, dn = h2
    if w.shape[:2] != (3, 3) or st != (2, 2) or pad != (1, 1):
        return None
    p["c2_w"], p["c2_b"], p["n2"] = scatter_stride2_f2(w), b, dn
    h3 = _take_conv_bn_relu(cur)
    if h3 is None:
        return None
    w, b, st, pad, dn = h3
    if w.shape[:2] != (3, 3) or st != (2, 2) or pad != (1, 1):
        return None
    p["c3_w"], p["c3_b"], p["n3"] = w, b, dn
    # residual blocks: ConcatTable{body, Identity} + CAddTable
    res = []
    while True:
        ct = cur.take("concat_table")
        if ct is None:
            break
        if cur.take("add_table") is None:
            return None
        brs = ct["branches"]
        if len(brs) != 2:
            return None
        body = brs[0] if not brs[1] else (brs[1] if not brs[0] else None)
        if body is None:
            return None
        bc = _Cursor(body)
        r1 = _take_conv_bn_relu(bc)
        if r1 is None:
            return None
        r2 = _take_conv_bn_relu(bc, relu=False)
        if r2 is None or bc.peek() is not None:
            return None
        for (w, b, st, pad, _dn) in (r1, r2):
            if w.shape[:2] != (3, 3) or st != (1, 1) or pad != (1, 1):
                return None
        res.append({"w1": r1[0], "b1": r1[1], "rn1": r1[4],
                    "w2": r2[0], "b2": r2[1], "rn2": r2[4]})
    if not res:
        return None
    p["res"] = res
    # the two transposed convs
    for name in ("d1", "d2"):
        zp = cur.take("zero_pad")
        c = cur.take("conv_transpose")
        if c is None or zp is not None:
            return None
        co = c["w"].shape[2]  # (k,k,Cout,Cin)
        norm = _norm_of(cur, co)
        if cur.take("relu") is None:
            return None
        wT = _np(c["w"])
        sc = _scatter_convT_f2(wT, wT.shape[0], c["pad"], c["adj"])
        if sc is None or c["stride"] != 2:
            return None
        wb, (lo, hi) = sc
        bn = norm[1] if (norm is not None and norm[0] == "fold") else None
        wb2, bb = _fold_bn_phases(wb, _np(c["b"]), bn)
        if wb2 is None:
            return None
        p[f"{name}_w"], p[f"{name}_b"] = wb2, bb
        p[f"{name}_pad"] = (lo, hi)
        p[f"n_{name}"] = norm[1] if (norm is not None and norm[0] == "defer") else None
    # tail: conv9 s1 pad4 → 3 channels [tanh] [mul]
    zp = cur.take("zero_pad")
    c = cur.take("conv")
    if c is None:
        return None
    w = _np(c["w"])
    pad = (c["pad"][0] + (zp["pad"] if zp else 0), c["pad"][1] + (zp["pad"] if zp else 0))
    if w.shape[:2] != (9, 9) or w.shape[3] != 3 or c["stride"] != (1, 1) or pad != (4, 4):
        return None
    b = _np(c["b"])
    if b is None:
        b = np.zeros(3, np.float32)
    w5 = scatter_k9_f2(w)  # (5,5,4C,12)
    w_row = np.zeros((1, 5, w5.shape[2], 5 * 12), np.float32)
    for dy in range(5):
        w_row[0, :, :, dy * 12:(dy + 1) * 12] = w5[dy]
    p["d3_w"] = w_row
    p["d3_b"] = np.tile(b, 4)
    p["tanh"] = cur.take("tanh") is not None
    ml = cur.take("mul")
    p["mul"] = float(ml["c"]) if ml is not None else None
    if cur.peek() is not None:
        return None
    p["c0"] = c0
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), p)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *, stride: int = 1,
          pad=0) -> torch.Tensor:
    """NHWC conv with HWIO weights; ``pad`` an int, or ((top, bottom), (left,
    right)) zero pads."""
    xt = x.permute(0, 3, 1, 2)
    if isinstance(pad, int):
        padding = pad
    else:
        (pt, pb), (pl, pr) = pad
        xt = F.pad(xt, (pl, pr, pt, pb))
        padding = 0
    y = F.conv2d(xt, w.permute(3, 2, 0, 1).to(x.dtype), None if b is None else b.to(x.dtype),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _defer_norm(y, nrm, phases, c, *, act=True, stats_out=None, site=None):
    """Deferred instance norm (+ ReLU) over a block tensor whose channels are
    ``phases`` phase copies of ``c`` logical channels: f32 statistics
    E[x²] − mean², the affine in f32, back in y's dtype. ``stats_out``
    records each site's (mean, inv), the input of ``fold_static_in``."""
    b, hb, wb, _ = y.shape
    yr = y.reshape(b, hb, wb, phases, c).float()
    mean = yr.mean(dim=(1, 2, 3))
    var = yr.square().mean(dim=(1, 2, 3)) - mean * mean
    inv = torch.rsqrt(var + nrm["eps"])
    if stats_out is not None:
        stats_out[site] = (mean, inv)
    return apply_in_relu(y, mean, inv, nrm["scale"], nrm["bias"], phases, relu=act)


def _res_stats(y, nrm):
    """The deferred IN of a res tensor as a per-(B, C) affine (a, c)."""
    yf = y.float()
    mean = yf.mean(dim=(1, 2))
    var = yf.square().mean(dim=(1, 2)) - mean * mean
    return in_affine(mean, torch.rsqrt(var + nrm["eps"]), nrm["scale"], nrm["bias"])


def _t7_res_quant_xla(y: torch.Tensor, res: list, sites: dict) -> torch.Tensor:
    """The res chain in PyTorch int8 ops (zero halo): each conv an int8 site
    (``sites_i8._qc``: quantize, exact int8 conv, bf16(acc·ws + bias)), the
    rn1 affine (IN) or qin alone (BN-folded) and the ReLU folded into the
    b-site's quantize (floor 0), the rn2 affine then the residual add. The
    route of BN-folded graphs (the adopted ``t7_bn`` set is empty). y bf16."""
    B, _, _, C = y.shape
    for i, rp in enumerate(res):
        sa, sb = sites[f"r{i}a"], sites[f"r{i}b"]
        ra = _qc(y, *_plain_quant(B, C, sa.qin, y.device), -127.0, sa, "zero")
        if rp["rn1"] is None:
            a_aff, c_aff = _plain_quant(B, C, sb.qin, y.device)
        else:
            av, cv = _res_stats(ra, rp["rn1"])
            a_aff, c_aff = av * sb.qin, cv * sb.qin
        rb = _qc(ra, a_aff, c_aff, 0.0, sb, "zero")
        if rp["rn2"] is None:
            y = y + rb
        else:
            a2, c2 = _res_stats(rb, rp["rn2"])
            y = (rb.float() * a2[:, None, None, :] + c2[:, None, None, :]).to(y.dtype) + y
    return y


def _t7_res_chain_i8(y: torch.Tensor, res: list, sites: dict) -> torch.Tensor:
    """The res chain on K4/K5 with the zero halo (``res_i8``): block 1's
    a-site on K4 (floor −127), every later a-site on K5, which folds the
    previous block's rn2 affine and residual add into its prologue and
    writes the sum v; every b-site on K4 (floor 0, the ReLU) with the rn1
    affine from the a-site's sums (``sites_i8._stats``) folded into its
    quantize. 6 × K4 + 4 × K5 for 5 blocks. y bf16 [B,H,W,C], or f32 (the
    float32 chains: block 1's K4 and block 2's K5 take their f32 forms, and
    the output is cast back to f32, as the JAX chain's ``.astype(dt)``)."""
    y = y.contiguous()  # the kernels read dense NHWC (a cuDNN output is an NCHW view)
    B, H, W0, C = y.shape
    dt = y.dtype
    n = float(H * W0)
    ones, zeros = _plain_quant(B, C, 1.0, y.device)
    carry = None
    for i, rp in enumerate(res):
        sa, sb = sites[f"r{i}a"], sites[f"r{i}b"]
        aq = ones * sa.qin
        if carry is None:
            ra, sout = k8.res_site(y, aq, zeros, -127.0, sa.wk, sa.ws, sa.bias, halo="zero")
        else:
            rb_p, a2p, c2p = carry
            ra, sout, y = k8.res_site_skip(rb_p, y, aq, zeros, a2p, c2p, -127.0, sa.wk, sa.ws,
                                           sa.bias, halo="zero")
        if rp["rn1"] is None:
            a_eff, c_eff = ones * sb.qin, zeros
        else:
            m, inv = _stats(sout, n, eps=rp["rn1"]["eps"])
            a_eff, c_eff = quant_affine(m, inv, rp["rn1"]["scale"], rp["rn1"]["bias"], sb.qin)
        rb, sout2 = k8.res_site(ra, a_eff, c_eff, 0.0, sb.wk, sb.ws, sb.bias, halo="zero")
        if rp["rn2"] is None:
            carry = (rb, ones, zeros)
        else:
            m2, inv2 = _stats(sout2, n, eps=rp["rn2"]["eps"])
            carry = (rb, *(t.contiguous() for t in in_affine(m2, inv2, rp["rn2"]["scale"],
                                                               rp["rn2"]["bias"])))
    rb, a2, c2 = carry
    return combine_as(rb, y, a2, c2).to(dt)


def _static_rows(co: int, qin: float, device):
    """A static scalar quantize scale as (CO,) emit rows: qa = qin, qc = 0
    (the JAX sites' scalar ``qo``)."""
    return (torch.full((co,), qin, dtype=torch.float32, device=device),
            torch.zeros((co,), dtype=torch.float32, device=device))


def _t7_res_chain_i8_s8c(y: torch.Tensor, res: list, sites: dict,
                         emit_qo: float | None = None) -> torch.Tensor:
    """The res chain of a BN-folded graph on s8 carries (``res_s8``;
    ``sites_i8.res_chain_s8_zero``): with every norm folded into the conv
    weights the inter-conv scale is a calibration constant, so per block K2
    quantizes y (qin, floor −127), convolves and emits the b-site's codes at
    its qin (floor 0: the ReLU), and K3 convolves them and adds y. 5 × K2 +
    5 × K3 for 5 blocks. ``emit_qo`` (``dec_s8``): the last K3 quantizes its
    sum at that scale (floor −127) and the chain returns deconv1's s8 codes.
    Otherwise the output is in y's dtype (an f32 y: the first block's K2 and
    K3 in their f32 forms)."""
    y = y.contiguous()
    C = y.shape[-1]
    blocks = [(sites[f"r{i}a"], sites[f"r{i}b"],
               _static_rows(C, sites[f"r{i}b"].qin, y.device), None) for i in range(len(res))]
    out = res_chain_s8_zero(y, blocks, emit_qo=emit_qo)
    return out if emit_qo is not None else out.to(y.dtype)


def _t7_dec_i8_s8(xq: torch.Tensor, p: dict, sites: dict, dt: torch.dtype,
                  tail: bool = False) -> torch.Tensor:
    """deconv1 + deconv2 on the s8 carry of ``res_s8`` (``dec_s8``;
    ``sites_i8.dec_s8_zero``): d1 (K3, 2×2 pad 0 for a k3 deconv, 3×3 pad 1
    for a k4) takes the chain's codes and emits d2's codes at its qin
    (floor 0: the ReLU), ``d2s`` runs on the codes, d2 (K3) returns its bf16
    raw, activated: [B,2H,2W,4·c0] in ``dt``. With ``tail`` (``tail_s8``)
    d2 emits the output conv's codes at its qin (``halo_out="zero2"``,
    floor 0) and K6 runs the tap-packed 9×9 conv with its dy-sum and bias:
    the [B,2H,2W,12] block output in bf16 (the zero pads of the net are
    K6's zero-SAME border)."""
    s1, s2 = sites["d1"], sites["d2"]
    rows1 = _static_rows(s1.wk.shape[-1], s2.qin, xq.device)
    tail3 = (sites["d3"], *_static_rows(s2.wk.shape[-1], sites["d3"].qin, xq.device)) \
        if tail else None
    out = dec_s8_zero(xq, s1, s2, rows1, _dec_geo(p["d1_pad"]), _dec_geo(p["d2_pad"]),
                      tail=tail3)
    return out if tail else torch.relu(out.float()).to(dt)


def _dec_kform(pad):
    """(kh, pt) of a phase-scattered transposed conv's block kernel: a k3
    deconv scatters to 2×2 with pads (0, 1), a k4 one to 3×3 with (1, 1);
    None for another."""
    if tuple(pad) == (0, 1):
        return 2, 0
    if tuple(pad) == (1, 1):
        return 3, 1
    return None


def _t7_c2_i8(y: torch.Tensor, p: dict, s2: Site) -> torch.Tensor:
    """The ``c2_i8`` branch: conv2's 2×2 block conv with (1, 0) zero pads as
    K4's 2×2 pad-1 zero-halo site on y [B,H,W,4·c0] (conv1's activated
    block output), its deferred IN (if any) from the site's sums; ReLU.
    Returns [B,H,W,2·c0] in y's dtype."""
    y = y.contiguous()
    B, H, W, Cin = y.shape
    aq, cq = _plain_quant(B, Cin, s2.qin, y.device)
    r, sout = k8.res_site(y, aq, cq, -127.0, s2.wk, s2.ws, s2.bias, halo="zero", kh=2, kw=2,
                          pt=1, pl_=1)
    if p["n2"] is None:
        return torch.relu(r.float()).to(y.dtype)
    m, inv = _stats(sout, float(H * W), eps=p["n2"]["eps"])
    return apply_in_relu(r.to(y.dtype), m, inv, p["n2"]["scale"], p["n2"]["bias"])


def _dec_geo(pad) -> dict:
    kh, pt = _dec_kform(pad)
    return dict(kh=kh, kw=kh, pt=pt, pl_=pt)


def _t7_dec_i8(y: torch.Tensor, p: dict, sites: dict, c0: int) -> torch.Tensor:
    """deconv1 + deconv2 as K4 zero-halo sites on their four output phases
    (2×2 pad 0 for a k3 deconv, 3×3 pad 1 for a k4), d2s between them, the
    deferred norms (if any) from the sites' sums over the phases (n_d1
    folded into deconv2's quantize, floor 0 the ReLU); returns the activated
    d2 output [B,2H,2W,4·c0] in y's dtype."""
    y = y.contiguous()
    B, H, W0, C = y.shape
    dt = y.dtype
    s1, s2 = sites["d1"], sites["d2"]
    aq, cq = _plain_quant(B, C, s1.qin, y.device)
    r, sout = k8.res_site(y, aq, cq, -127.0, s1.wk, s1.ws, s1.bias, halo="zero",
                          **_dec_geo(p["d1_pad"]))
    if p["n_d1"] is None:
        a_eff, c_eff = _plain_quant(B, 2 * c0, s2.qin, y.device)
    else:
        m, inv = _stats_phased(sout, float(H * W0), 4, eps=p["n_d1"]["eps"])
        a_eff, c_eff = (t.contiguous() for t in quant_affine(m, inv, p["n_d1"]["scale"],
                                                             p["n_d1"]["bias"], s2.qin))
    r2, sout2 = k8.res_site(d2s(r, 2, 2 * c0).contiguous(), a_eff, c_eff, 0.0, s2.wk, s2.ws,
                            s2.bias, halo="zero", **_dec_geo(p["d2_pad"]))
    if p["n_d2"] is None:
        return torch.relu(r2.float()).to(dt)
    m2, inv2 = _stats_phased(sout2, float(4 * H * W0), 4, eps=p["n_d2"]["eps"])
    return apply_in_relu(r2.to(dt), m2, inv2, p["n_d2"]["scale"], p["n_d2"]["bias"], 4)


def _t7_dec_quant_xla(y: torch.Tensor, p: dict, sites: dict, c0: int) -> torch.Tensor:
    """deconv1 + deconv2 in PyTorch int8 ops (the reference of
    ``_t7_dec_i8``): quantize, an exact int8 conv of the block kernel over
    the scatter's zero pads, bf16(acc·ws + bias); n_d1's affine (or qin
    alone) and the ReLU folded into deconv2's quantize; n_d2 deferred."""
    s1, s2 = sites["d1"], sites["d2"]
    (lo1, hi1), (lo2, hi2) = p["d1_pad"], p["d2_pad"]
    xq = torch.clamp(torch.round(y.float() * s1.qin), -127.0, 127.0)
    r = qconv_xla(xq, s1, lo1 + hi1 + 1, lo1 + hi1 + 1, (lo1, hi1, lo1, hi1), y.dtype)
    yd = d2s(r, 2, 2 * c0)
    if p["n_d1"] is None:
        a1, c1 = _plain_quant(1, 2 * c0, s2.qin, y.device)
    else:
        av, cv = _res_stats(yd, p["n_d1"])
        a1, c1 = av * s2.qin, cv * s2.qin
    rq = torch.clamp(torch.round(yd.float() * a1[:, None, None, :] + c1[:, None, None, :]),
                     0.0, 127.0)
    r2 = qconv_xla(rq, s2, lo2 + hi2 + 1, lo2 + hi2 + 1, (lo2, hi2, lo2, hi2), y.dtype)
    if p["n_d2"] is None:
        return torch.relu(r2)
    return _defer_norm(r2, p["n_d2"], 4, c0)


def _t7_tail_quant_xla(y: torch.Tensor, p: dict, sites: dict) -> torch.Tensor:
    """The tap-packed 9×9 output conv in PyTorch int8 ops (the reference of
    the fused tail): codes of the activated d2 output (floor 0), the 1×5
    int8 rows conv over zero pads, K = bf16(acc·ws), the f32 dy-sum and the
    bias → the [B,H2,W2,12] block output in bf16."""
    s3 = sites["d3"]
    h2 = y.shape[1]
    qd3 = torch.clamp(torch.round(y.float() * s3.qin), 0.0, 127.0)
    K = conv2d_i8(F.pad(qd3, (0, 0, 2, 2, 2, 2)), s3.w8)
    K = (K.float() * s3.ws[:k8.D3_LANES]).to(torch.bfloat16)
    y12 = sum(K[:, dy:dy + h2, :, dy * 12:(dy + 1) * 12].float() for dy in range(5))
    return (y12 + s3.bias).to(torch.bfloat16)


def _no_tap(site, t):
    return None


def t7_fast_apply(p: dict, x: torch.Tensor, *, tap=None, sites: dict | None = None,
                  fused_sites=(), stats_out: dict | None = None) -> torch.Tensor:
    """The f=2 block-space forward of a recognized ``.t7`` Johnson net:
    NHWC model-space input (caffe_bgr-preprocessed; H, W divisible by 4) →
    NHWC output (tanh·mul scale). Exact against ``t7_apply`` up to float
    reassociation.

    ``sites``: ``prepare_sites`` of ``quantize_t7`` (the int8 modes), routed
    by ``fused_sites`` as the JAX forward routes ``quant``: ``c2_i8`` → K4's
    2×2 conv2 where ``res_supported`` takes its grid; ``res_i8`` →
    ``_t7_res_chain_i8`` (K4/K5) where ``res_supported`` passes; no res name
    → ``_t7_res_quant_xla``; a named chain the geometry refuses → the bf16
    blocks (never the int8-ops chain); ``dec_i8`` → ``_t7_dec_i8`` (K4)
    where the res grid and its double pass ``res_supported`` and both
    deconvs scatter to a known block kernel, else ``dec_xla_i8`` →
    ``_t7_dec_quant_xla``; ``tail_xla_i8`` → ``_t7_tail_quant_xla``.
    ``res_s8`` → ``_t7_res_chain_i8_s8c`` (K2/K3) where ``res_supported``
    passes and no res block has a deferred norm (a BN-folded graph, or an
    IN graph after ``fold_static_in``; else ``res_i8`` or the bf16 blocks);
    on it, ``dec_s8`` → ``_t7_dec_i8_s8`` (K3) where the deconvs have no
    deferred norm, scatter to known block kernels and the doubled grid
    passes ``res_supported``, and on that, ``tail_s8`` its tail (K6) where
    ``d3s8_supported`` takes the doubled grid.
    ``tap(site, t)`` sees the tensor each calibrated conv consumes;
    ``stats_out`` records each deferred norm's (mean, inv)."""
    tap = tap or _no_tap
    fused = set(fused_sites)
    unknown = sorted(fused - set(T7_SITE_NAMES))
    if unknown:
        raise ValueError(f"unknown t7 fused sites {unknown}; known: {T7_SITE_NAMES}")
    hb = x.shape[1] // 2
    c0 = p["c0"]

    def na(site, y, nrm, phases, c, *, act=True):
        if nrm is None:
            return torch.relu(y) if act else y
        return _defer_norm(y, nrm, phases, c, act=act, stats_out=stats_out, site=site)

    y = s2d(x, 2)
    y = na("n1", _conv(y, p["c1_w"], p["c1_b"], pad=2), p["n1"], 4, c0)
    if (sites is not None and "c2" in sites and "c2_i8" in fused
            and res_supported(y.shape[1], y.shape[2])):
        y = _t7_c2_i8(y, p, sites["c2"])
    else:
        tap("c2", y)
        y = na("n2", _conv(y, p["c2_w"], p["c2_b"], pad=((1, 0), (1, 0))), p["n2"], 1, 2 * c0)
    y = na("n3", _conv(y, p["c3_w"], p["c3_b"], stride=2, pad=1), p["n3"], 1, 4 * c0)

    nres = len(p["res"])
    use_q = sites is not None and all(f"r{i}{ab}" in sites for i in range(nres) for ab in "ab")
    ok = use_q and res_supported(y.shape[1], y.shape[2])
    use_res_s8 = (ok and "res_s8" in fused
                  and all(rp["rn1"] is None and rp["rn2"] is None for rp in p["res"]))
    use_res_i8 = ok and not use_res_s8 and "res_i8" in fused
    use_dec_s8 = (use_res_s8 and "dec_s8" in fused and bool(p["res"]) and "d1" in sites
                  and "d2" in sites and p["n_d1"] is None and p["n_d2"] is None
                  and _dec_kform(p["d1_pad"]) is not None and _dec_kform(p["d2_pad"]) is not None
                  and res_supported(2 * y.shape[1], 2 * y.shape[2]))
    use_tail_s8 = (use_dec_s8 and "tail_s8" in fused and "d3" in sites
                   and d3s8_supported(2 * y.shape[1], 2 * y.shape[2]))
    dt = y.dtype
    if use_res_s8:
        y = _t7_res_chain_i8_s8c(y, p["res"], sites,
                                 emit_qo=sites["d1"].qin if use_dec_s8 else None)
    elif use_res_i8:
        y = _t7_res_chain_i8(y, p["res"], sites)
    elif use_q and not {"res_i8", "res_s8"} & fused:
        y = _t7_res_quant_xla(y, p["res"], sites)
    else:
        for i, rp in enumerate(p["res"]):
            tap(f"r{i}a", y)
            r = na(f"r{i}n1", _conv(y, rp["w1"], rp["b1"], pad=1), rp["rn1"], 1, 4 * c0)
            tap(f"r{i}b", r)
            r = na(f"r{i}n2", _conv(r, rp["w2"], rp["b2"], pad=1), rp["rn2"], 1, 4 * c0,
                   act=False)
            y = y + r
    dec_q = sites is not None and "d1" in sites and "d2" in sites
    if use_dec_s8:
        y = _t7_dec_i8_s8(y, p, sites, dt, tail=use_tail_s8)
    elif (dec_q and "dec_i8" in fused and res_supported(y.shape[1], y.shape[2])
            and res_supported(2 * y.shape[1], 2 * y.shape[2])
            and _dec_kform(p["d1_pad"]) is not None and _dec_kform(p["d2_pad"]) is not None):
        y = _t7_dec_i8(y, p, sites, c0)
    elif dec_q and "dec_xla_i8" in fused:
        y = _t7_dec_quant_xla(y, p, sites, c0)
    else:
        tap("d1", y)
        pd = p["d1_pad"]
        y = _conv(y, p["d1_w"], p["d1_b"], pad=(pd, pd))
        y = na("n_d1", d2s(y, 2, 2 * c0), p["n_d1"], 1, 2 * c0)
        tap("d2", y)
        pd = p["d2_pad"]
        y = na("n_d2", _conv(y, p["d2_w"], p["d2_b"], pad=(pd, pd)), p["n_d2"], 4, c0)
    if use_tail_s8:
        pass  # y is the output conv's [B,H2,W2,12] block output
    elif sites is not None and "d3" in sites and "tail_xla_i8" in fused:
        y = _t7_tail_quant_xla(y, p, sites)
    else:
        tap("d3", y)
        rows = _conv(y, p["d3_w"], None, pad=2)  # 1×5 taps: (B, H/2+4, W/2, 60)
        y = sum(rows[:, dy:dy + hb, :, dy * 12:(dy + 1) * 12] for dy in range(5))
        y = y + p["d3_b"].to(y.dtype)
    out = d2s(y, 2, 3)
    if p["tanh"]:
        out = torch.tanh(out)
    if p["mul"] is not None:
        out = out * torch.tensor(p["mul"], dtype=out.dtype, device=out.device)
    return out


def prepare_sites(p: dict, quant: dict, device) -> dict[str, Site]:
    """``quantize_t7`` output → the device-resident sites the int8 branches
    read; the conv biases come from ``p`` (the params in the compute dtype:
    the JAX engine reads them from its cast params). d3 holds its int8 rows
    weights ``w8`` (the PyTorch-int8 tail) beside K6's packing."""
    sites = {}
    for name, q in quant.items():
        if name == "d3":
            sites[name] = Site(
                wk=k8.pack_weights(q["w"], co_pad=k8.CO_TILE).to(device),
                ws=F.pad(q["ws"].to(torch.float32), (0, k8.CO_TILE - k8.D3_LANES)).to(device),
                bias=p["d3_b"].float().to(device).contiguous(), qin=float(q["qin"]),
                w8=q["w"].to(device))
            continue
        if name in ("c2", "d1", "d2"):
            bias = p[f"{name}_b"]
        else:
            i, ab = int(name[1:-1]), name[-1]
            bias = p["res"][i]["b1" if ab == "a" else "b2"]
        sites[name] = Site(wk=k8.pack_weights(q["w"]).to(device),
                           ws=q["ws"].to(device, torch.float32),
                           bias=bias.float().to(device).contiguous(), qin=float(q["qin"]))
    return sites


#: deferred-norm key → (conv weight key, bias key, phase copies of the
#: logical channels in the conv's output layout)
_IN_FOLD = {"n1": ("c1_w", "c1_b", 4), "n2": ("c2_w", "c2_b", 1), "n3": ("c3_w", "c3_b", 1),
            "n_d1": ("d1_w", "d1_b", 4), "n_d2": ("d2_w", "d2_b", 4)}


def has_deferred_norms(p: dict) -> bool:
    """True when the params carry runtime (instance) norms: the graphs the
    static-norm fold applies to."""
    return (any(p.get(k) is not None for k in _IN_FOLD)
            or any(rp.get(f"rn{j}") is not None for rp in p["res"] for j in (1, 2)))


@torch.no_grad()
def calibrate_t7_in_stats(p: dict, x_cal: torch.Tensor) -> dict:
    """Frozen per-norm (mean, inv) from one f32 forward, averaged over the
    calibration batch to shape (1, C): the static-norm mode's statistics."""
    so: dict = {}
    t7_fast_apply(p, x_cal.float(), stats_out=so)
    return {k: (m.mean(dim=0, keepdim=True), inv.mean(dim=0, keepdim=True))
            for k, (m, inv) in so.items()}


def fold_static_in(p: dict, stats: dict) -> dict:
    """Fold FROZEN instance-norm statistics into the conv weights (the
    static-norm ``.t7`` mode): norm(conv(x))·scale + bias with constant
    (mean, inv) is a per-output-channel affine, as a BN fold is, so the
    result is BN-folded in form (every deferred norm None). In numpy f32, as
    the JAX function computes it. Not exact against the dynamic path (IN is
    per image); the engine gates its quality."""
    q = dict(p)

    def fold(w, bias, nrm, mv, phases):
        m, inv = (_np(s)[0] for s in mv)
        a = inv * _np(nrm["scale"])
        c = _np(nrm["bias"]) - m * a
        a, c = np.tile(a, phases), np.tile(c, phases)
        dev = w.device
        return (torch.from_numpy(_np(w) * a).to(dev),
                torch.from_numpy(_np(bias) * a + c).to(dev))

    for nk, (wk, bk, ph) in _IN_FOLD.items():
        if p.get(nk) is not None and nk in stats:
            q[wk], q[bk] = fold(p[wk], p[bk], p[nk], stats[nk], ph)
            q[nk] = None
    res2 = []
    for i, rp in enumerate(p["res"]):
        rp2 = dict(rp)
        for j in (1, 2):
            if rp.get(f"rn{j}") is not None and f"r{i}n{j}" in stats:
                rp2[f"w{j}"], rp2[f"b{j}"] = fold(rp[f"w{j}"], rp[f"b{j}"], rp[f"rn{j}"],
                                                  stats[f"r{i}n{j}"], 1)
                rp2[f"rn{j}"] = None
        res2.append(rp2)
    q["res"] = res2
    return q


@torch.no_grad()
def calibrate_t7_scales(p: dict, x_cal: torch.Tensor) -> dict[str, float]:
    """Per-site max|activation| of the tensor each calibrated conv consumes
    (c2, the res sites, d1, d2, d3), from one f32 forward on the
    model-space input ``x_cal``."""
    vals: dict[str, float] = {}

    def tap(site, t):
        vals[site] = float(t.float().abs().max())

    t7_fast_apply(p, x_cal.float(), tap=tap)
    return vals


def quantize_t7(p: dict, act_scales: dict) -> dict:
    """Per-output-channel symmetric int8 weights and folded activation
    scales of every calibrated site (``quantize_site``'s contract): the res
    sites ``r{i}{a,b}`` and c2, d1, d2, d3 in their block forms."""
    q = {}
    for i, rp in enumerate(p["res"]):
        for ab, wk in (("a", "w1"), ("b", "w2")):
            site = f"r{i}{ab}"
            if site in act_scales:
                q[site] = quantize_site(_np(rp[wk]), act_scales[site])
    for site, wk in (("c2", "c2_w"), ("d1", "d1_w"), ("d2", "d2_w"), ("d3", "d3_w")):
        if site in act_scales:
            q[site] = quantize_site(_np(p[wk]), act_scales[site])
    return q
