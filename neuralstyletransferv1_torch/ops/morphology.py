"""Grey-scale morphology by windowed max / min reductions (NHWC / HWC / HW),
square structuring elements.

Counterpart of ``neuralstyletransferv1_tpu/ops/morphology.py``: the window
is clipped at the border (the JAX reduce_window's ∓inf padding), as
``F.max_pool2d``'s implicit padding takes it; the min is the max of the
negation. The region compositor's gap fill dilates; the segmentation
masks' cleanup (``apps/sky_swap.py``) closes, dilates and erodes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _window_max(x: torch.Tensor, ksize: int, sign: float = 1.0) -> torch.Tensor:
    """max over the window of ``sign·x``, times ``sign`` (−1: the min)."""
    orig_ndim, orig_dtype = x.ndim, x.dtype
    if x.ndim == 2:
        x = x[None, :, :, None]
    elif x.ndim == 3:
        x = x[None]
    xf = x if x.is_floating_point() else x.double()  # max_pool2d takes floats only
    if sign < 0:
        xf = -xf
    y = F.max_pool2d(xf.permute(0, 3, 1, 2), ksize, stride=1, padding=ksize // 2)
    if sign < 0:
        y = -y
    y = y.permute(0, 2, 3, 1).to(orig_dtype)
    if orig_ndim == 2:
        y = y[0, :, :, 0]
    elif orig_ndim == 3:
        y = y[0]
    return y


def grey_dilate(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Square-structuring-element dilation (max filter)."""
    return _window_max(x, ksize)


def grey_erode(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Square-structuring-element erosion (min filter)."""
    return _window_max(x, ksize, -1.0)


def max_pool_dilate(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Alias used by the region compositor's gap fill (max-pool dilation)."""
    return grey_dilate(x, ksize)


def morph_close(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Dilate then erode (cv2.MORPH_CLOSE with a square kernel)."""
    return grey_erode(grey_dilate(x, ksize), ksize)
