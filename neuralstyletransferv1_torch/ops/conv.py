"""2-D convolution on NHWC activations, over ``F.conv2d``.

Weights keep PyTorch's OIHW layout (the port's parameters are state dicts).
An NHWC tensor viewed as NCHW is a channels-last tensor, which cuDNN takes
without a copy. bf16 inputs accumulate in f32 inside cuDNN and come back
bf16, like the JAX engine's bf16 path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int = 1,
) -> torch.Tensor:
    """x: [N,H,W,Cin], w: [Cout,Cin,kh,kw], b: [Cout] → [N,H',W',Cout]."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype),
                 None if b is None else b.to(x.dtype),
                 stride=stride)
    return y.permute(0, 2, 3, 1)
