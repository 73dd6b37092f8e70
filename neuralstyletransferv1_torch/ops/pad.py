"""Spatial padding (NHWC / HWC).

Reflection padding mirrors without repeating the edge pixel
(``torch.nn.ReflectionPad2d``, ``np.pad(mode="reflect")``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect_pad_2d(x: torch.Tensor, pad: int | tuple[int, int]) -> torch.Tensor:
    """Reflect-pad the H and W axes of an NHWC (or HWC) tensor by ``pad``
    (an int for both axes, or ``(pad_h, pad_w)``)."""
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    if ph == 0 and pw == 0:
        return x
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    y = F.pad(x.permute(0, 3, 1, 2), (pw, pw, ph, ph), mode="reflect")
    y = y.permute(0, 2, 3, 1)
    return y[0] if squeeze else y
