"""Masked stylization in one step: DeepLab mask, stylize, composite.

Counterpart of ``neuralstyletransferv1_tpu/engine/masked_stylize.py``
(BASELINE config #4): the DeepLab mask at ``infer_res`` (non-background =
alpha 1), the alpha's bilinear upsample to the frame, the Johnson slot
stylized in bf16 at full resolution, and the alpha composite, all on the
frames' device. ``compute_dtype`` (bf16 by default) is the dtype of the
resizes, the DeepLab convolutions and the composite.
"""

from __future__ import annotations

import copy

import torch

from ..models.deeplab import BN, Conv, DeepLab
from ..ops.resize import resize_bilinear
from .stylizer import StyleModel, jit_stylizer


def cast_params(model: DeepLab, dtype: torch.dtype) -> DeepLab:
    """A copy of ``model`` with its convolutions (weights and the classifier's
    bias) in ``dtype`` and every BN's affine and running statistics in f32.

    The JAX function decides by key name (it keeps the leaves named
    ``scale``, ``bias``, ``mean``, ``var``); this one decides by module
    type. The DeepLab trees have no conv ``bias`` key (the classifier's is
    ``b``), so both leave the same leaves in f32."""
    out = copy.deepcopy(model)
    for m in out.modules():
        if isinstance(m, Conv):
            m.to(dtype)
        elif isinstance(m, BN):
            m.float()
    return out


def make_masked_stylize_step(deeplab: DeepLab, style_model: StyleModel, out_hw,
                             *, infer_res: int = 513, compute_dtype=torch.bfloat16,
                             keep_fg: bool = True):
    """``step(x01) -> composited01`` for NHWC f32 frames at ``out_hw`` on the
    models' device: x in ``compute_dtype``, resized to ``infer_res``², DeepLab
    on ``small·2 − 1``, alpha = argmax ≠ 0, alpha resized to the frame, the
    slot stylized in bf16 (``jit_stylizer``) and clipped to [0, 1], then
    ``styled·alpha + x·(1 − alpha)`` (``keep_fg=False`` flips alpha: the
    mask's replace mode). Returns f32.

    The CPU has no bf16 antialiased resize: both resizes run in f32 and
    round to ``compute_dtype`` (``stylizer._input_size`` does the same)."""
    H, W = out_hw
    dt = compute_dtype
    dl = cast_params(deeplab, dt).eval()
    stylize = jit_stylizer(style_model, dtype=torch.bfloat16)

    @torch.no_grad()
    def step(x01: torch.Tensor) -> torch.Tensor:
        x = x01.to(dt)
        small = resize_bilinear(x.float(), (infer_res, infer_res)).to(dt)
        logits = dl(small * 2.0 - 1.0)
        alpha = (logits.argmax(-1) != 0).to(dt)[..., None]
        alpha = resize_bilinear(alpha.float(), (H, W)).to(dt)
        styled = stylize(x).clamp(0.0, 1.0).to(dt)
        if not keep_fg:
            alpha = 1.0 - alpha
        return (styled * alpha + x * (1.0 - alpha)).float()

    return step
