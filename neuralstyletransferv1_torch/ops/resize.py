"""Resize (NHWC / HWC).

``resize_bilinear`` reproduces ``jax.image.resize(..., "linear")``: half-pixel
centres, and a triangle filter widened by the scale factor when an axis
shrinks (JAX antialiases every downsample). That is ``F.interpolate`` bilinear
with ``antialias=True`` for a downsample and the plain bilinear for an
upsample. The DIS pyramid and the half-resolution flow input both downsample.
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
