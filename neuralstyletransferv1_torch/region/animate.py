"""Animated region masks: rotation and organic morph warps, on the device.

The port's copy of ``neuralstyletransferv1_tpu/region/animate.py``, on
stacked [R, H, W] f32 mask tensors: rotation with coverage renormalization,
the multi-octave sin/cos noise fields and the per-mode displacement warp,
the iterative max-pool gap fill, and the morph-spec parser. The per-octave
noise offsets are ``np.random.default_rng(seed).random()`` draws, computed
once per (seed, octaves) on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..ops.morphology import grey_dilate
from ..ops.warp import bilinear_sample

MIN_COVERAGE = 0.1
GAP_KERNELS = (5, 11, 21, 41)


@dataclass
class MorphAnimation:
    """Organic morph config."""

    enabled: bool = False
    speed: float = 1.0
    amplitude: float = 0.15
    frequency: float = 3.0
    octaves: int = 3
    mode: str = "blob"
    seed: int = 42


def parse_morph_animation(spec: str | None) -> MorphAnimation:
    """Parse 'speed,amplitude,frequency,mode' / a bare mode / off."""
    if not spec or spec.lower() in ("none", "off", "0", "static"):
        return MorphAnimation(enabled=False)
    modes = ["blob", "tentacle", "wave", "pulse"]
    if spec.lower() in modes:
        return MorphAnimation(enabled=True, mode=spec.lower())
    parts = spec.split(",")
    try:
        if len(parts) >= 4:
            return MorphAnimation(
                enabled=True,
                speed=float(parts[0]),
                amplitude=float(parts[1]),
                frequency=float(parts[2]),
                mode=parts[3].strip().lower(),
            )
        if len(parts) == 3:
            return MorphAnimation(
                enabled=True, speed=float(parts[0]), amplitude=float(parts[1]),
                frequency=float(parts[2]))
        if len(parts) == 2:
            return MorphAnimation(enabled=True, speed=float(parts[0]), amplitude=float(parts[1]))
        if len(parts) == 1:
            return MorphAnimation(enabled=True, speed=float(parts[0]))
    except ValueError:
        return MorphAnimation(enabled=True, mode=spec.lower())
    return MorphAnimation(enabled=False)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def rotate_all_masks(masks: torch.Tensor, angle_degrees: float) -> torch.Tensor:
    """Rotate stacked [R, H, W] masks about (W/2, H/2) with the replicate
    border, then renormalize the coverage."""
    R, H, W = masks.shape
    dev = masks.device
    theta = torch.deg2rad(_f32(angle_degrees, dev))
    cos, sin = torch.cos(theta), torch.sin(theta)
    cx, cy = W / 2.0, H / 2.0
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, :] - cx
    gy = torch.arange(H, dtype=torch.float32, device=dev)[:, None] - cy
    map_x = cos * gx - sin * gy + cx
    map_y = sin * gx + cos * gy + cy
    rotated = torch.stack([bilinear_sample(m, map_x, map_y) for m in masks], dim=0)
    total = rotated.sum(dim=0, keepdim=True).clamp(min=1e-6)
    return rotated / total


@lru_cache(maxsize=256)
def _octave_offsets(seed: int, octaves: int) -> tuple:
    """The per-octave rng.random()*1000 draws, in draw order."""
    rng = np.random.default_rng(seed)
    return tuple((float(rng.random() * 1000), float(rng.random() * 1000)) for _ in range(octaves))


def _noise_field(H, W, frequency, octaves, seed, time_offset: torch.Tensor) -> torch.Tensor:
    """Multi-octave sin/cos noise in [0,1]; ``time_offset`` an f32 scalar
    tensor."""
    dev = time_offset.device
    offsets = _octave_offsets(int(seed), int(octaves))
    y = torch.linspace(0.0, frequency, H, dtype=torch.float32, device=dev)[:, None]
    x = torch.linspace(0.0, frequency, W, dtype=torch.float32, device=dev)[None, :]
    result = torch.zeros((H, W), dtype=torch.float32, device=dev)
    amplitude, total_amplitude, freq_mult = 1.0, 0.0, 1.0
    for octave in range(octaves):
        rx, ry = offsets[octave]
        ox = time_offset * (0.5 + 0.3 * octave) + rx
        oy = time_offset * (0.3 + 0.2 * octave) + ry
        noise = torch.sin(x * freq_mult + ox) * torch.cos(y * freq_mult + oy)
        noise = noise + torch.sin((x + y) * freq_mult * 0.7 + ox * 0.8) * 0.5
        noise = noise + torch.cos((x - y) * freq_mult * 0.5 + oy * 0.6) * 0.3
        result = result + noise * amplitude
        total_amplitude += amplitude
        amplitude *= 0.5
        freq_mult *= 2.0
    result = result / total_amplitude
    return (result - result.min()) / (result.max() - result.min() + 1e-6)


def _flow_field(H, W, frequency, seed, time_offset):
    """(dx, dy) in [-1,1]."""
    fx = _noise_field(H, W, frequency, 2, seed, time_offset) * 2 - 1
    fy = _noise_field(H, W, frequency, 2, seed + 1000, time_offset * 1.3) * 2 - 1
    return fx, fy


def _reflect_coords(c: torch.Tensor, size: int) -> torch.Tensor:
    """cv2.BORDER_REFLECT coordinate folding (edge included)."""
    period = 2.0 * size
    c = torch.remainder(c, period)
    return torch.minimum(c, period - 1.0 - c).clamp(0.0, size - 1.0)


def warp_mask_organic(mask: torch.Tensor, amplitude: float, frequency: float, frame_idx,
                      speed: float, seed: int, mode: str = "blob") -> torch.Tensor:
    """Warp one [H, W] mask by an organic displacement field."""
    H, W = mask.shape
    dev = mask.device
    t = _f32(frame_idx, dev) * speed * 0.02
    if mode == "tentacle":
        fx, fy = _flow_field(H, W, frequency * 2, seed, t)
        y01 = torch.linspace(0.0, 1.0, H, dtype=torch.float32, device=dev)[:, None]
        fy = fy + torch.sin(y01 * math.pi * 3 + t) * 0.5
    elif mode == "wave":
        yc = torch.linspace(0.0, math.pi * frequency, H, dtype=torch.float32, device=dev)[:, None]
        xc = torch.linspace(0.0, math.pi * frequency, W, dtype=torch.float32, device=dev)[None, :]
        fx = torch.sin(yc + t * 2).expand(H, W)
        fy = torch.cos(xc + t * 1.5).expand(H, W)
    elif mode == "pulse":
        cy, cx = H // 2, W // 2
        y = torch.arange(H, dtype=torch.float32, device=dev)[:, None] - cy
        x = torch.arange(W, dtype=torch.float32, device=dev)[None, :] - cx
        r = torch.sqrt(x * x + y * y) + 1e-6
        theta = torch.atan2(y, x)
        pulse = torch.sin(r * 0.05 - t * 3) * 0.5 + 0.5
        fx, fy = torch.cos(theta) * pulse, torch.sin(theta) * pulse
    else:  # blob
        fx, fy = _flow_field(H, W, frequency, seed, t)

    max_disp = max(H, W) * amplitude
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    gy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    map_x = _reflect_coords(gx + fx * max_disp, W)
    map_y = _reflect_coords(gy + fy * max_disp, H)
    return bilinear_sample(mask, map_x, map_y)


def _gap_fill(masks: torch.Tensor) -> torch.Tensor:
    """Iterative max-pool dilation into low-coverage pixels, every kernel
    size in turn (a no-op where no gap remains)."""
    total = masks.sum(dim=0, keepdim=True)
    gap = (total < MIN_COVERAGE).to(masks.dtype)
    for k in GAP_KERNELS:
        dilated = grey_dilate(masks[..., None], k)[..., 0]
        masks = masks * (1 - gap) + dilated * gap
        total = masks.sum(dim=0, keepdim=True)
        gap = (total < MIN_COVERAGE).to(masks.dtype)
    return masks


def warp_all_masks_organic(masks: torch.Tensor, morph: MorphAnimation, frame_idx) -> torch.Tensor:
    """Warp all [R, H, W] masks (per-region seed offset), gap-fill and
    renormalize."""
    if not morph.enabled:
        return masks
    warped = torch.stack([
        warp_mask_organic(masks[i], amplitude=morph.amplitude, frequency=morph.frequency,
                          frame_idx=frame_idx, speed=morph.speed, seed=morph.seed + i * 100,
                          mode=morph.mode)
        for i in range(masks.shape[0])], dim=0)
    warped = _gap_fill(warped)
    total = warped.sum(dim=0, keepdim=True).clamp(min=1e-6)
    return warped / total
