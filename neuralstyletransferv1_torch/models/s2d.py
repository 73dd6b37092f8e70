"""Space-to-depth pieces of the int8 decoder sites, and the deferred
instance-norm formulas the quantized path shares with the JAX engine.

Port of ``neuralstyletransferv1_tpu/models/transformer_net_s2d.py``:
``_scatter_upconv`` (the int8 deconv1/deconv2 weights), ``d2s``,
``_pad_edge_blocks``, ``_in_stats`` and ``_apply_in_relu``. Channel index of
a block tensor = (u·f + v)·C + c.
"""

from __future__ import annotations

import numpy as np
import torch


def d2s(x: torch.Tensor, f: int, c: int) -> torch.Tensor:
    """[B,hb,wb,f·f·c] block tensor → [B,hb·f,wb·f,c] pixels."""
    b, hb, wb, _ = x.shape
    x = x.reshape(b, hb, wb, f, f, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hb * f, wb * f, c)


def scatter_upconv(w: np.ndarray) -> np.ndarray:
    """nearest ×2 upsample + 3×3 s1 conv (pad 1) → a 3×3 conv on the
    low-resolution grid whose 4·co outputs are the 2×2 output phases.

    w: HWIO [3,3,ci,co] → [3,3,ci,4·co], output channel (q·2+r)·co + c.
    Valid over the grid padded by one edge-copied pixel per side
    (``pad_edge_blocks``). Output pixel 2J+q reads upsampled pixel
    2J+q+a−1 = X[(2J+q+a−1)//2]: q=0 taps a=0 at J−1 and a=1,2 at J; q=1 taps
    a=0,1 at J and a=2 at J+1. Taps that land on the same block sum in f32."""
    _, _, ci, co = w.shape
    out = np.zeros((3, 3, ci, 4 * co), np.float32)

    def taps(q):
        return [(0 if q == 0 and a == 0 else (2 if q == 1 and a == 2 else 1), a)
                for a in range(3)]

    for q in range(2):
        for r in range(2):
            for ka, a in taps(q):
                for kb, b in taps(r):
                    out[ka, kb, :, (q * 2 + r) * co:(q * 2 + r + 1) * co] += w[a, b]
    return out


def pad_edge_blocks(x: torch.Tensor) -> torch.Tensor:
    """Edge-copied halo of one pixel on every side of an NHWC tensor."""
    x = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    return torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)


def in_stats(x: torch.Tensor):
    """Per-(N, channel) instance-norm statistics of an NHWC tensor: mean and
    inv = rsqrt(E[x²] − mean² + 1e-5), in f32 (the JAX engine's deferred-norm
    form; its phased variant is ``sites_i8._stats_phased``)."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2))
    var = xf.square().mean(dim=(1, 2)) - mean * mean
    return mean, torch.rsqrt(var + 1e-5)


def in_affine(mean: torch.Tensor, inv: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor):
    """The norm as a per-channel affine y = a·x + c, each product rounded in
    the JAX engine's order: a = inv·scale, c = bias − (mean·inv)·scale."""
    s, b = scale.float(), bias.float()
    return inv * s, b - mean * inv * s


def apply_in_relu(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor, phases: int = 1, *,
                  relu: bool = True) -> torch.Tensor:
    """f32 a·x + c (+ReLU) with per-(N, logical channel) a, c from the
    statistics, back in x's dtype. mean/inv: [B or 1, C]."""
    a, c = in_affine(mean, inv, scale, bias)
    a = a.repeat(1, phases)[:, None, None, :]
    c = c.repeat(1, phases)[:, None, None, :]
    y = x.float() * a + c
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def quant_affine(mean: torch.Tensor, inv: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, qin: float):
    """The JAX engine's ``_qc`` contract for a site whose input carries a
    pending norm + ReLU: the affine folds into the input quantizer,
    q = clamp(round(x·a + c), 0, 127) with a = (inv·scale)·qin and
    c = (bias − mean·inv·scale)·qin (qin > 0, so the ReLU is the clamp's
    floor 0). A site without a pending affine quantizes
    clamp(round(x·qin), −127, 127); either way the dequant is
    bf16(acc·ws + bias)."""
    a, c = in_affine(mean, inv, scale, bias)
    return (a * qin).contiguous(), (c * qin).contiguous()
