"""Separable Gaussian blur (NHWC / HWC / HW), matching cv2.GaussianBlur.

Used for flow-field smoothing at the finest DIS level and for the
motion-map smoothing of the motion-adaptive blend. Reflect-101 borders
(cv2.BORDER_DEFAULT), then two 1-D depthwise f32 passes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gaussian_kernel_1d(ksize: int, sigma: float, device=None) -> torch.Tensor:
    """cv2.getGaussianKernel-compatible 1-D kernel (normalized, float32)."""
    half = (ksize - 1) / 2.0
    xs = torch.arange(ksize, dtype=torch.float32, device=device) - half
    k = torch.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return k / k.sum()


def _ksize_for_sigma(sigma: float) -> int:
    # 3 sigma each side, forced odd (the JAX package's rule)
    return max(int(math.ceil(sigma * 3.0)) * 2 + 1, 3)


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur over the spatial dims of HW / HWC / NHWC input."""
    if sigma <= 0:
        return x
    ksize = _ksize_for_sigma(sigma)
    k = gaussian_kernel_1d(ksize, sigma, device=x.device)
    orig_ndim, orig_dtype = x.ndim, x.dtype
    if x.ndim == 2:
        x = x[None, :, :, None]
    elif x.ndim == 3:
        x = x[None]
    c = x.shape[3]
    pad = ksize // 2
    xf = F.pad(x.float().permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    y = F.conv2d(xf, k.view(1, 1, ksize, 1).expand(c, 1, ksize, 1), groups=c)
    y = F.conv2d(y, k.view(1, 1, 1, ksize).expand(c, 1, 1, ksize), groups=c)
    y = y.permute(0, 2, 3, 1)
    if orig_ndim == 2:
        y = y[0, :, :, 0]
    elif orig_ndim == 3:
        y = y[0]
    return y.to(orig_dtype)
