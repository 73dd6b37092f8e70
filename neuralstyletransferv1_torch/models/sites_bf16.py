"""The bf16 fused sites of the Johnson net — ``head`` (conv2 + conv3),
``tail`` (deconv2 + deconv3) and ``d3`` (deconv3's rows conv) — over the
K9a–K9e kernels (``kernels/bf16_sites.py``).

Port of ``neuralstyletransferv1_tpu/models/s2d2_sites.py``: the geometry
gates with the JAX values (they decide which branch of the forward runs, so
they are part of the function), ``head``, ``tail`` and the ``d3`` branch of
``transformer_net_s2d2.apply``. Each site applies the pending instance norm
and ReLU in its kernel's prologue instead of a pass of its own, and the
next norm's statistics come from the kernel's sums.

The weights keep the forms the JAX engine casts to bf16: conv2/conv3 the
pixel weights (the TPU's block forms hold each pixel tap once), deconv2 the
phase form (``s2d.scatter_upconv`` sums pixel taps in f32 before the cast,
so an "upsample then conv" in bf16 is a different function at the ulp
level), deconv3 the tap-packed 1×5 rows. ``prepare`` forms them from the f32
net; the conv biases and norm parameters come from the net in the compute
dtype, as the JAX engine reads them from its cast params.

Under float32 (``tail``, ``d3``; JAX runs both with f32 params) the sites
read the f32 raw (K9a deconv1's, K9e the d2 raw) unrounded in their
prologues, the weights are cast to bf16 as the JAX sites cast them, and the
biases and norm rows stay f32. ``tail`` returns deconv3's block output in
its input's dtype (the JAX tail casts back to the d1 raw's), ``d3`` in bf16.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import bf16_sites as k9
from .s2d import d2s, d3_tap_packed, in_affine, scatter_upconv
from .sites_i8 import _batch, _stats, _stats_phased

BF16_SITE_NAMES = ("head", "tail", "d3")


def _pick_ts(hp: int) -> int | None:
    """The TPU d3 site's strip height: the largest of 8..4 that divides hp."""
    for ts in range(8, 3, -1):
        if hp % ts == 0:
            return ts
    return None


def d3_supported(h2: int, w2: int) -> bool:
    return _pick_ts(h2 + 4) is not None and w2 % 2 == 0


def _tail_geom(h2: int, w2: int):
    """(ho, hbuf, wp) of the TPU tail's halo buffer, or None where the JAX
    engine runs the unfused tail: (h2 + 4) % 8 == 0, w2 % 8 == 0, h2 ≥ 20,
    w2 ≥ 16."""
    if h2 < 20 or w2 < 16 or (h2 + 4) % 8 or w2 % 8:
        return None
    ho = h2 + 4
    return ho, ho + 8, ((w2 + 4 + 7) // 8) * 8


def tail_supported(h2: int, w2: int) -> bool:
    return _tail_geom(h2, w2) is not None


def _head_geom(h2: int, w2: int):
    """(ts_c2, ts_c3), the TPU head's strip heights, or None."""
    if h2 < 24 or w2 < 16 or h2 % 4 or w2 % 8 or (w2 // 2) % 8:
        return None
    h4 = h2 // 2
    ts2 = next((t for t in (12, 8, 4) if h2 % t == 0), None)
    ts3 = next((t for t in (10, 6, 2) if h4 % t == 0), None)
    if ts2 is None or ts3 is None:
        return None
    if w2 > 1000:
        ts2, ts3 = min(ts2, 4), min(ts3, 2)
    return ts2, ts3


def head_supported(h2: int, w2: int) -> bool:
    return _head_geom(h2, w2) is not None


@dataclass
class SiteWeights:
    """The bf16 sites' weights on their device (``kernels/bf16_sites``
    packings) and f32 bias rows."""

    c2_w: torch.Tensor   # bf16 [9,64,32]
    c3_w: torch.Tensor   # bf16 [9,128,64]
    d2_w: torch.Tensor   # bf16 [9,128,64], the phase form
    d3_w: torch.Tensor   # bf16 [5,64,128], tap-packed, nothing baked
    c2_b: torch.Tensor   # f32 [64]
    c3_b: torch.Tensor   # f32 [128]
    d2_b: torch.Tensor   # f32 [128], the conv bias tiled over the 4 phases
    d3_b: torch.Tensor   # f32 [12], tiled over the 4 phases


def _hwio(conv) -> np.ndarray:
    return conv.conv2d.weight.detach().float().permute(2, 3, 1, 0).cpu().numpy()


def _bias(conv, phases: int = 1, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The conv bias as the net in ``dtype`` holds it, in f32, tiled over
    phases."""
    return conv.conv2d.bias.detach().to(dtype).float().repeat(phases)


def prepare(net, device, dtype: torch.dtype = torch.bfloat16) -> SiteWeights:
    """The sites' weights of the f32 ``net``: formed in f32 (scattered to
    the phase and tap-packed forms), then cast to bf16, as the JAX engine
    casts its block-space params; the biases as the net in the compute
    ``dtype`` holds them (bf16-rounded, or f32 under float32)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    w_row, _ = d3_tap_packed(_hwio(net.deconv3), np.zeros(3, np.float32))
    sw = SiteWeights(
        c2_w=k9.pack_site_weights(t(_hwio(net.conv2))),
        c3_w=k9.pack_site_weights(t(_hwio(net.conv3))),
        d2_w=k9.pack_site_weights(t(scatter_upconv(_hwio(net.deconv2)))),
        d3_w=k9.pack_rows_weights(t(w_row)),
        c2_b=_bias(net.conv2, 1, dtype), c3_b=_bias(net.conv3, 1, dtype),
        d2_b=_bias(net.deconv2, 4, dtype), d3_b=_bias(net.deconv3, 4, dtype))
    return SiteWeights(**{k: v.to(device).contiguous() for k, v in vars(sw).items()})


def _affine(m, inv, norm, B: int, phases: int = 1):
    """The norm as kernel rows a, c [B, phases·C] (``s2d.in_affine``)."""
    a, c = in_affine(m, inv, norm.weight.float(), norm.bias.float())
    return _batch(a.repeat(1, phases), B), _batch(c.repeat(1, phases), B)


def _no_tap(site, t):
    return None


def head(raw1: torch.Tensor, m1, inv1, net, sw: SiteWeights, *, tap=_no_tap):
    """conv2 + conv3 as fused sites (K9c, K9d), the ``head`` name.

    raw1: conv1's raw output in pixels [B,H,W,32] bf16 (the JAX code holds
    it space-to-depth, [B,H/2,W/2,128]); m1, inv1: its in1 statistics
    ([1|B, 32]). The in1 apply + ReLU run in K9c's prologue, the in2
    statistics come from its sums over the (H/2)·(W/2) outputs, the in2
    apply runs in K9d's prologue. Returns ``(raw3, m3, inv3)``: conv3's raw
    output [B,H/4,W/4,128] and its in3 statistics. The JAX head sums K9c's
    f32 interior plus the bf16-rounded values of its strip fixup (row 0 and
    column 0); these all-f32 sums differ from that by about the strips'
    share of the positions times a bf16 ulp."""
    B = raw1.shape[0]
    tap("c2", raw1)
    y2, sums2 = k9.c2_site_bf16(raw1, *_affine(m1, inv1, net.in1, B), sw.c2_w, sw.c2_b)
    m2, inv2 = _stats(sums2, float(y2.shape[1] * y2.shape[2]))
    tap("c3", y2)
    raw3, sums3 = k9.c3_site_bf16(y2, *_affine(m2, inv2, net.in2, B), sw.c3_w, sw.c3_b)
    m3, inv3 = _stats(sums3, float(raw3.shape[1] * raw3.shape[2]))
    return raw3, m3, inv3


def tail(x_raw: torch.Tensor, m4, inv4, net, sw: SiteWeights, *, d3=None, tap=_no_tap):
    """deconv2 + deconv3 as fused sites (K9a, K9b), the ``tail`` name.

    x_raw: deconv1's raw output on the 2× grid [B,H2,W2,64] bf16, or f32
    under float32 (``d2s`` of the JAX phase form [B,H4,W4,256]); m4, inv4:
    its in4 statistics. The in4 apply + ReLU run in K9a's prologue; in5
    comes from K9a's sums with the 4 phases folded (n = 4·H2·W2); the in5
    apply, the tap-packed rows conv, the 5-row sum and the bias run in K9b.
    ``d3``: (weights, bias) of deconv3 when they are not the net's own (the
    IO-baked ones of an int8 set). Returns deconv3's block output y12
    [B,H2,W2,12] in x_raw's dtype (K9b's bf16, cast as the JAX tail casts
    it)."""
    B = x_raw.shape[0]
    d3_w, d3_b = (sw.d3_w, sw.d3_b) if d3 is None else d3
    tap("d2", x_raw)
    y5, sums = k9.d2_site(x_raw.contiguous(), *_affine(m4, inv4, net.in4, B), sw.d2_w, sw.d2_b)
    tap("d3", y5)
    m5, inv5 = _stats_phased(sums, float(y5.shape[1] * y5.shape[2]), 4)
    return k9.d3_sum_site(y5, *_affine(m5, inv5, net.in5, B, 4), d3_w, d3_b).to(x_raw.dtype)


def d3_branch(y: torch.Tensor, m5, inv5, net, sw: SiteWeights, *, d3=None, tap=_no_tap):
    """deconv3 with its rows conv fused (K9e), the ``d3`` name.

    y: the d2 raw in the phase form [B,H2,W2,128] bf16 (or f32 under
    float32, read unrounded by K9e); m5, inv5 its in5
    statistics. K9e applies in5 + ReLU and writes the 60-lane rows of the
    reflect-padded grid; the 5-row sum and the bias add then round in bf16
    at every add, as the JAX code's sum over bf16 slices does (the ``tail``
    sums in f32 in its kernel). Returns pixels [B,2·H2,2·W2,3] bf16."""
    B, hb = y.shape[0], y.shape[1]
    d3_w, d3_b = (sw.d3_w, sw.d3_b) if d3 is None else d3
    tap("d3", y)
    rows = k9.d3_rows(y.contiguous(), *_affine(m5, inv5, net.in5, B, 4), d3_w)
    out = sum(rows[:, dy:dy + hb, :, dy * 12:(dy + 1) * 12] for dy in range(5))
    return d2s(out + d3_b.to(out.dtype), 2, 3)
