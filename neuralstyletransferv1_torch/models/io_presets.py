"""IO-preset normalization — the 7 presets of the reference engine.

  preprocess(preset, x01)  : NHWC float in [0,1] → model input
  postprocess(preset, y)   : model output → NHWC float clipped to [0,1]

Constants are cast to the input dtype, so the bf16 path stays bf16.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)

# Backend → default preset.
IO_PRESETS = {
    "transformer": "imagenet_255",
    "torch7": "caffe_bgr",
    "magenta": "imagenet_01",
    "reconet": "imagenet_01",
}


def resolve_auto_preset(model_type: str, arch: str | None = None) -> str:
    """'auto' → the backend's preset; NST_Train checkpoints force raw_01."""
    if arch == "nst":
        return "raw_01"
    return IO_PRESETS.get(model_type, "imagenet_01")


def _c(values, like: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """f32 constant (optionally scaled in f32) cast to ``like``'s dtype."""
    t = torch.tensor(values, dtype=torch.float32, device=like.device)
    return (t * scale if scale != 1.0 else t).to(like.dtype)


def preprocess(preset: str, x01: torch.Tensor) -> torch.Tensor:
    """[0,1] NHWC RGB → model-input tensor for ``preset``."""
    if preset == "tanh":
        return x01 * 2.0 - 1.0
    if preset == "imagenet_01":
        return (x01 - _c(IMAGENET_MEAN, x01)) / _c(IMAGENET_STD, x01)
    if preset == "imagenet_255":
        return (x01 * 255.0 - _c(IMAGENET_MEAN, x01, 255.0)) / _c(IMAGENET_STD, x01, 255.0)
    if preset == "caffe_bgr":
        return x01.flip(-1) * 255.0 - _c(CAFFE_MEAN_BGR, x01)
    if preset == "raw_01":
        return x01
    # raw_255 and any unknown preset take the 0..255 branch
    return x01 * 255.0


def preset_affine(preset: str):
    """The preset's pre/post transforms as per-channel affines + permutations:
    (pre_perm, pre_a, pre_b, post_perm, post_s, post_t) with
      preprocess(x01)  == x01[..., pre_perm] · pre_a + pre_b
      postprocess(y)   == clip(y[..., post_perm] · post_s + post_t, 0, 1)
    (index lists and numpy float32 arrays, the JAX engine's values). The
    int8 deconv3 folds the post affine into its weights and bias, which its
    int8 scales are taken over."""
    import numpy as np

    ident = [0, 1, 2]
    one = np.ones(3, np.float32)
    zero = np.zeros(3, np.float32)
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    if preset == "tanh":
        return ident, one * 2.0, one * -1.0, ident, one * 0.5, one * 0.5
    if preset == "imagenet_01":
        return ident, 1.0 / std, -mean / std, ident, std, mean
    if preset == "imagenet_255":
        return ident, 1.0 / std, -mean / std, ident, one / 255.0, zero
    if preset == "caffe_bgr":
        mbgr = np.asarray(CAFFE_MEAN_BGR, np.float32)
        return [2, 1, 0], one * 255.0, -mbgr, [2, 1, 0], one / 255.0, zero
    if preset == "raw_01":
        return ident, one, zero, ident, one, zero
    return ident, one * 255.0, zero, ident, one / 255.0, zero  # raw_255


def postprocess(preset: str, y: torch.Tensor) -> torch.Tensor:
    """Model output → [0,1] NHWC RGB (clipped)."""
    if preset == "tanh":
        out = (y + 1.0) * 0.5
    elif preset == "imagenet_01":
        out = y * _c(IMAGENET_STD, y) + _c(IMAGENET_MEAN, y)
    elif preset == "caffe_bgr":
        out = y.flip(-1) / 255.0
    elif preset == "raw_01":
        out = y
    else:  # imagenet_255, raw_255
        out = y / 255.0
    return out.clamp(0.0, 1.0)
