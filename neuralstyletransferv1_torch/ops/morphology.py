"""Grey-scale dilation by a windowed max (NHWC / HWC / HW), square
structuring elements.

Counterpart of ``neuralstyletransferv1_tpu/ops/morphology.py``: the windowed
max with the window clipped at the border (the JAX reduce_window's
-inf padding), as ``F.max_pool2d``'s implicit padding takes it. The
region compositor's gap fill dilates with it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _window_max(x: torch.Tensor, ksize: int) -> torch.Tensor:
    orig_ndim, orig_dtype = x.ndim, x.dtype
    if x.ndim == 2:
        x = x[None, :, :, None]
    elif x.ndim == 3:
        x = x[None]
    xf = x if x.is_floating_point() else x.double()  # max_pool2d takes floats only
    y = F.max_pool2d(xf.permute(0, 3, 1, 2), ksize, stride=1, padding=ksize // 2)
    y = y.permute(0, 2, 3, 1).to(orig_dtype)
    if orig_ndim == 2:
        y = y[0, :, :, 0]
    elif orig_ndim == 3:
        y = y[0]
    return y


def grey_dilate(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Square-structuring-element dilation (max filter)."""
    return _window_max(x, ksize)
