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


def conv2d_i8(x_q: torch.Tensor, w_q: torch.Tensor, *, padding: int | tuple[int, int] = 0,
              stride: int = 1) -> torch.Tensor:
    """Exact int8 × int8 → int32 convolution (the plain version of the int8
    sites' kernels).

    x_q: [N,H,W,Cin] int8 codes, w_q: [kh,kw,Cin,Cout] int8 (HWIO, as the
    quantized site weights are stored) → [N,H',W',Cout] int32. It runs as a
    float64 conv of the codes: every product is at most 127² and every
    partial sum stays far below 2^53, so the f64 result is the exact integer
    whatever order the convolution sums in; the final round only guards
    transform-based algorithms."""
    y = F.conv2d(x_q.permute(0, 3, 1, 2).double(), w_q.permute(3, 2, 0, 1).double(),
                 padding=padding, stride=stride)
    return y.round().to(torch.int32).permute(0, 2, 3, 1)
