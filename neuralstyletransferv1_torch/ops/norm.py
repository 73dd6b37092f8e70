"""Instance normalization (NHWC) with f32 statistics.

Matches ``torch.nn.InstanceNorm2d(C, affine=True)`` (eps 1e-5, biased
variance); the statistics and the affine run in f32 whatever the input
dtype, and the result returns in the input dtype.
"""

from __future__ import annotations

import torch


def instance_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Affine instance norm over the spatial dims of an NHWC tensor."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)
