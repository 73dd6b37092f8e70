"""Device resolution for the port.

``cuda`` requires a visible GPU and raises otherwise; ``cpu`` is an explicit
CPU run (tests). Nothing falls back from one to the other. On CUDA the f32
paths must stay f32: cuDNN convolutions (the stylizer, the depthwise Gaussian
blur) and matmuls (the LAB colour matrices) would otherwise run in TF32.
"""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``--device`` value → torch.device (``cuda`` or ``cpu`` only)."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda: no CUDA GPU is visible "
                "(pass --device cpu for an explicit CPU run)")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise NotImplementedError(
        f"--device {name}: the PyTorch port runs on 'cuda' (or 'cpu' for tests)")
