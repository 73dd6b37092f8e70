"""Temporal-coherence stages over a THWC batch.

Counterpart of ``neuralstyletransferv1_tpu/temporal/ema.py``'s split form
(``_temporal_postprocess_split``, the engine default): only the two true
recurrences run frame by frame — the flow-EMA warp-and-blend (frame t-1's
output is its input) and the LAB EMA multiply-add — and everything
elementwise in t runs batched over T. JAX's ``lax.scan``s become Python
loops over T. The per-step monolithic scan form and the mask composite are
not ported yet.

Constants mirror the reference: MOTION_NORM=8px, MIN_ALPHA=0.40,
GAUSS_SIGMA=3.0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.blur import gaussian_blur
from ..ops.color import lab_u8_to_rgb, rgb_to_lab_u8
from ..ops.warp import warp_flow, warp_flow_packed_u8

MOTION_NORM = 8.0
MIN_ALPHA = 0.40
GAUSS_SIGMA = 3.0


def _clip01(a: float) -> tuple[float, float]:
    """(a, 1 - a) clipped to [0, 1] and rounded as the f32 scalars the JAX
    graph computes them in."""
    a32 = np.float32(min(max(a, 0.0), 1.0))
    return float(a32), float(np.float32(1.0) - a32)


def flow_ema_fuse(curr_styled01, prev_styled01, flow, alpha: float) -> torch.Tensor:
    """a*curr + (1-a)*warp(prev, flow), clipped (HWC frames, HW2 flow)."""
    prev_warp = warp_flow(prev_styled01, flow)
    a, b = _clip01(alpha)
    return (a * curr_styled01 + b * prev_warp).clamp(0.0, 1.0)


def _lab_alphas(smooth_alpha, chroma_alpha, smooth_lightness, smooth_chroma, device):
    a_l = smooth_alpha if smooth_lightness else 1.0
    a_c = chroma_alpha if smooth_chroma else 1.0
    return torch.tensor([a_l, a_c, a_c], dtype=torch.float32, device=device)


def lab_ema_step(rgb01, prev_lab, *, smooth_alpha: float = 0.7, chroma_alpha: float = 0.85,
                 smooth_lightness: bool = True, smooth_chroma: bool = False):
    """One LAB EMA step on an HWC frame; returns (rgb01_out, new_prev_lab)."""
    lab = rgb_to_lab_u8(rgb01)
    if prev_lab is None:
        prev_lab = lab
    alphas = _lab_alphas(smooth_alpha, chroma_alpha, smooth_lightness, smooth_chroma,
                         lab.device)
    sm = alphas * lab + (1.0 - alphas) * prev_lab
    return lab_u8_to_rgb(sm.clamp(0.0, 255.0)), sm


def motion_adaptive_blend(styled01, orig01, flow, blend: float) -> torch.Tensor:
    """Per-pixel blend by flow magnitude:
    alpha = blend − (blend − 0.40)·blur(clip(|flow|/8, 0, 1), σ=3)."""
    mag = torch.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    m = gaussian_blur((mag / MOTION_NORM).clamp(0.0, 1.0)[..., None], GAUSS_SIGMA)
    alpha = blend - (blend - MIN_ALPHA) * m
    return (alpha * styled01 + (1.0 - alpha) * orig01).clamp(0.0, 1.0)


def uniform_blend(styled01, orig01, blend: float) -> torch.Tensor:
    """Global style/original blend."""
    if 0.0 <= blend < 1.0:
        return (blend * styled01 + (1.0 - blend) * orig01).clamp(0.0, 1.0)
    return styled01


class TemporalState(NamedTuple):
    """Carry between batches."""

    prev_styled01: torch.Tensor  # pre-LAB stylized frame t-1, HWC
    prev_lab: torch.Tensor  # smoothed LAB planes, HWC(3)


def temporal_postprocess_split(
    styled01: torch.Tensor,
    orig01: torch.Tensor,
    flows: torch.Tensor | None,
    *,
    flow_ema: bool = False,
    flow_alpha: float = 0.6,
    smooth_lightness: bool = True,
    smooth_chroma: bool = False,
    smooth_alpha: float = 0.7,
    chroma_alpha: float = 0.85,
    motion_blend: bool = False,
    blend: float = 1.0,
    init: TemporalState | None = None,
    fast_warp: bool = True,
) -> tuple[torch.Tensor, TemporalState]:
    """The temporal chain over a THWC batch; returns (output THWC, state).

    flows[t] is the flow from frame t-1 → t. With ``init`` None the batch
    starts a video: frame 0 skips the flow fusion and seeds the LAB EMA from
    itself. ``fast_warp`` picks the u8-corner packed warp (default) over the
    exact one (``--exact_warp``).
    """
    T = styled01.shape[0]
    if flows is None:
        flows = torch.zeros(styled01.shape[:3] + (2,), dtype=torch.float32,
                            device=styled01.device)
    first_is_warmup = init is None
    if init is None:
        init = TemporalState(styled01[0], rgb_to_lab_u8(styled01[0]))

    # Stage 1 — flow EMA, the heavy recurrence: warp + blend + clip per frame.
    if flow_ema:
        a, b = _clip01(flow_alpha)
        prev = init.prev_styled01
        outs = []
        for t in range(T):
            curr = styled01[t]
            if t == 0 and first_is_warmup:
                out = curr
            elif fast_warp:
                out = (a * curr + b * warp_flow_packed_u8(prev, flows[t])).clamp(0.0, 1.0)
            else:
                out = flow_ema_fuse(curr, prev, flows[t], flow_alpha)
            outs.append(out)
            prev = out
        fused = torch.stack(outs, dim=0)
        last_fused = prev
    else:
        fused = styled01
        last_fused = styled01[-1]

    # Stage 2 — LAB EMA: batched round trip, the multiply-add recurrence between.
    if smooth_lightness or smooth_chroma:
        lab = rgb_to_lab_u8(fused)
        alphas = _lab_alphas(smooth_alpha, chroma_alpha, smooth_lightness, smooth_chroma,
                             lab.device)
        prev_lab = lab[0] if first_is_warmup else init.prev_lab
        sms = []
        for t in range(T):
            prev_lab = alphas * lab[t] + (1.0 - alphas) * prev_lab
            sms.append(prev_lab)
        last_lab = prev_lab
        out = lab_u8_to_rgb(torch.stack(sms, dim=0).clamp(0.0, 255.0))
    else:
        out = fused
        last_lab = init.prev_lab

    # Stage 3 — blends, batched over T.
    if motion_blend:
        mag = torch.sqrt(flows[..., 0] ** 2 + flows[..., 1] ** 2)
        m = gaussian_blur((mag / MOTION_NORM).clamp(0.0, 1.0)[..., None], GAUSS_SIGMA)
        m_alpha = blend - (blend - MIN_ALPHA) * m
        blended = (m_alpha * out + (1.0 - m_alpha) * orig01).clamp(0.0, 1.0)
        if first_is_warmup:
            blended[0] = uniform_blend(out[0], orig01[0], blend)
        out = blended
    else:
        out = uniform_blend(out, orig01, blend)
    return out, TemporalState(last_fused, last_lab)
