"""Space-to-depth pieces of the int8 and bf16 fused sites, and the deferred
instance-norm formulas they share with the JAX engine.

Port of ``neuralstyletransferv1_tpu/models/transformer_net_s2d.py``:
``_scatter_upconv`` (the deconv1/deconv2 phase weights), ``s2d``, ``d2s``,
``_pad_edge_blocks``, ``_in_stats`` and ``_apply_in_relu``;
``_scatter_stride2_s2d2`` and its inverse (conv2's block weights back to
pixels); and of
``transformer_net_s2d2.py``: ``_scatter_k9_f2``, deconv3's tap packing with
the d3 half of ``bake_io_affine`` (``d3_tap_packed``) and
``_pad_reflect_f2_4px``. Channel index of a block tensor = (u·f + v)·C + c.
"""

from __future__ import annotations

import numpy as np
import torch


def d2s(x: torch.Tensor, f: int, c: int) -> torch.Tensor:
    """[B,hb,wb,f·f·c] block tensor → [B,hb·f,wb·f,c] pixels."""
    b, hb, wb, _ = x.shape
    x = x.reshape(b, hb, wb, f, f, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hb * f, wb * f, c)


def s2d(x: torch.Tensor, f: int) -> torch.Tensor:
    """[B,H,W,c] pixels → [B,H/f,W/f,f·f·c] block tensor (inverse of d2s)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // f, f, w // f, f, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // f, w // f, f * f * c)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    i = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(i >= n, 2 * n - 2 - i, i)


def pad_reflect_f2_4px(x: torch.Tensor, c: int) -> torch.Tensor:
    """Reflect-pad an f=2 block tensor by two halo blocks per side, which is
    the 4-pixel reflect of its pixels (``_pad_reflect_f2_4px`` of
    ``transformer_net_s2d2.py``: a phase-permuted block reflect). An index
    gather, so it takes int8 codes as well as bf16."""
    p = d2s(x, 2, c)
    _, h, w, _ = p.shape
    p = p.index_select(1, _reflect_index(h, 4, x.device))
    p = p.index_select(2, _reflect_index(w, 4, x.device))
    return s2d(p, 2)


def scatter_stride2_f2(w: np.ndarray) -> np.ndarray:
    """A 3×3 stride-2 pixel conv (pad 1) → the 2×2 block conv on its input's
    space-to-depth grid (``_scatter_stride2_s2d2``; inverse of
    ``stride2_pixel_weight``): HWIO [3,3,ci,co] → [2,2,4·ci,co], valid over
    the grid padded by one block at the top and left. Output pixel j reads
    pixels 2j+a−1: a=0 → block j−1 phase 1, a=1 → block j phase 0, a=2 →
    block j phase 1."""
    _, _, ci, co = w.shape
    out = np.zeros((2, 2, 4 * ci, co), np.float32)
    taps = [(0, 1), (1, 0), (1, 1)]  # (κ, phase) of pixel tap a
    for a, (ka, pa) in enumerate(taps):
        for b, (kb, pb) in enumerate(taps):
            out[ka, kb, (pa * 2 + pb) * ci:(pa * 2 + pb + 1) * ci] += w[a, b]
    return out


def stride2_pixel_weight(wb: np.ndarray) -> np.ndarray:
    """The JAX engine's conv2 block weights (``_scatter_stride2_s2d2``: a
    3×3 stride-2 pixel conv as a 2×2 block conv on the space-to-depth grid,
    [2,2,4·ci,co]) → the pixel weights [3,3,ci,co]. Every pixel tap sits at
    exactly one block position (κ, phase): a=0 → (0, 1), a=1 → (1, 0),
    a=2 → (1, 1), so this is a gather and int8 codes stay codes."""
    wb = np.asarray(wb)
    ci = wb.shape[2] // 4
    taps = [(0, 1), (1, 0), (1, 1)]  # (κ, phase) of pixel tap a
    out = np.zeros((3, 3, ci, wb.shape[3]), wb.dtype)
    for a, (ka, pa) in enumerate(taps):
        for b, (kb, pb) in enumerate(taps):
            out[a, b] = wb[ka, kb, (pa * 2 + pb) * ci:(pa * 2 + pb + 1) * ci]
    return out


def scatter_k9_f2(w: np.ndarray) -> np.ndarray:
    """9×9 s1 pixel conv (pad 4) → 5×5 block conv at f=2 (``_scatter_k9_f2``).

    w: HWIO [9,9,ci,co] → [5,5,4·ci,4·co], valid over a grid pre-padded by
    two blocks per side; channel (u·2+v)·c + ch. Output pixel 2J+u reads
    input pixel 2J+u+a−4 = block J−2+(u+a)//2, phase (u+a)%2."""
    k, _, ci, co = w.shape
    assert k == 9
    out = np.zeros((5, 5, 4 * ci, 4 * co), np.float32)
    for u in range(2):
        for v in range(2):
            for a in range(9):
                for b in range(9):
                    al, u2 = divmod(u + a, 2)
                    be, v2 = divmod(v + b, 2)
                    out[al, be, (u2 * 2 + v2) * ci:(u2 * 2 + v2 + 1) * ci,
                        (u * 2 + v) * co:(u * 2 + v + 1) * co] += w[a, b]
    return out


def d3_tap_packed(w: np.ndarray, b: np.ndarray, post=None) -> tuple[np.ndarray, np.ndarray]:
    """deconv3 (HWIO [9,9,32,3], bias [3]) in the JAX engine's tap-packed
    f=2 form with the IO preset's post affine baked in: the 5 kernel rows
    of the 5×5 block conv pack into 5·12 = 60 output lanes of a 1×5 conv,
    and output lane dy·12 + phase·3 + c carries postprocess channel c
    (``from_johnson_params`` and ``bake_io_affine`` of
    ``transformer_net_s2d2.py``). ``post`` = (post_perm, post_s, post_t) of
    ``io_presets.preset_affine``; the output is then on the [0,1] scale
    before the final clamp. ``post`` None: nothing baked (the bf16 sites of
    a net whose output goes through ``postprocess``). Returns (w_row
    [1,5,128,60], b [12]) in f32."""
    w5 = scatter_k9_f2(np.asarray(w, np.float32))       # [5,5,128,12]
    w_row = np.zeros((1, 5, w5.shape[2], 5 * w5.shape[3]), np.float32)
    for dy in range(5):
        w_row[0, :, :, dy * 12:(dy + 1) * 12] = w5[dy]
    b12 = np.tile(np.asarray(b, np.float32), 4)
    if post is None:
        return w_row, b12
    operm, os_, ot = post
    w3 = np.zeros_like(w_row)
    b3 = np.zeros_like(b12)
    for ph in range(4):
        for c in range(3):
            co, src = ph * 3 + c, ph * 3 + operm[c]
            for dy in range(5):
                w3[..., dy * 12 + co] = w_row[..., dy * 12 + src] * os_[c]
            b3[co] = b12[src] * os_[c] + ot[c]
    return w3, b3


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
