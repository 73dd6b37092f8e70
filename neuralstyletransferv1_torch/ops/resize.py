"""Resize (NHWC / HWC).

``resize_bilinear`` reproduces ``jax.image.resize(..., "linear")``: half-pixel
centres, and a triangle filter widened by the scale factor when an axis
shrinks (JAX antialiases every downsample). That is ``F.interpolate`` bilinear
with ``antialias=True`` for a downsample and the plain bilinear for an
upsample. The DIS pyramid and the half-resolution flow input both downsample.
``resize_bilinear_align_corners`` is DeepLabV3+'s ``align_corners=True``
resize, written as the JAX function's own gathers and weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Exact nearest-neighbour integer upsample of NHWC by ``factor``."""
    return x.repeat_interleave(factor, dim=-3).repeat_interleave(factor, dim=-2)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize (half-pixel centres) of NHWC/HWC to ``out_hw``."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    h, w = x.shape[1], x.shape[2]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        y = x
    else:
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(oh, ow), mode="bilinear",
                          align_corners=False, antialias=oh < h or ow < w)
        y = y.permute(0, 2, 3, 1).contiguous()
    return y[0] if squeeze else y


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC/HWC with the ``align_corners=True`` convention
    (``src = dst·(in−1)/(out−1)``), as DeepLabV3+ resizes.

    The JAX function's gathers and weights: source positions in f32, the
    fractional weights cast to the input dtype, each product and sum
    rounded in that dtype (a bf16 input stays bf16). One departure on
    purpose: an integer input is upcast to f32 and the result is f32 (the
    JAX function casts its weights to the integer dtype, which makes them
    0)."""
    if not x.is_floating_point():
        x = x.float()
    oh, ow = int(out_hw[0]), int(out_hw[1])
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    h, w = x.shape[1], x.shape[2]
    ys = torch.arange(oh, dtype=torch.float32, device=x.device) * ((h - 1) / max(oh - 1, 1))
    xs = torch.arange(ow, dtype=torch.float32, device=x.device) * ((w - 1) / max(ow - 1, 1))
    y0, x0 = ys.floor().long(), xs.floor().long()
    y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
    fy = (ys - y0).to(x.dtype)[None, :, None, None]
    fx = (xs - x0).to(x.dtype)[None, None, :, None]
    r0, r1 = x.index_select(1, y0), x.index_select(1, y1)
    top = r0.index_select(2, x0) * (1 - fx) + r0.index_select(2, x1) * fx
    bot = r1.index_select(2, x0) * (1 - fx) + r1.index_select(2, x1) * fx
    out = top * (1 - fy) + bot * fy
    return out[0] if squeeze else out
