"""Instance normalization, and ReCoNet's filter response normalization and
thresholded linear unit (NHWC), with f32 statistics.

``instance_norm`` matches ``torch.nn.InstanceNorm2d(C, affine=True)`` (eps
1e-5, biased variance); ``frn`` and ``tlu`` are the port's copy of the JAX
engine's ``ops/norm.py`` ones. The statistics and the affine run in f32
whatever the input dtype, and the result returns in the input dtype.
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


def frn(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
        eps: float = 1e-6) -> torch.Tensor:
    """Filter response normalization: x · rsqrt(mean(x²) + |eps|) · w + b,
    the mean over the spatial dims per (image, channel)."""
    x32 = x.float()
    nu2 = x32.square().mean(dim=(1, 2), keepdim=True)
    y = x32 * torch.rsqrt(nu2 + abs(eps))
    y = weight.float() * y + bias.float()
    return y.to(x.dtype)


def tlu(x: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Thresholded linear unit: max(x, tau), tau per channel."""
    return torch.maximum(x, tau.to(x.dtype))
