"""Region assignment, harmonic weight animation, blend-spec DSL, compositing.

The port's copy of ``neuralstyletransferv1_tpu/region/blend.py``. Control
logic (assignment, the blend-spec DSL — A-H letters, O/ORIGINAL = -1, ':w'
weights, unweighted parts sharing the rest, then normalized — harmonic
scalars) is host Python with the same RNG draw order; the per-pixel
composite is one einsum contraction on the device:
result = Σ_r mask_r · Σ_m W[r,m]·out_m / Σ_r mask_r, with W the
``_region_weight_matrix`` [R, M+1] (column M the original frame). Base masks
are cached per key while they animate (``clear_mask_cache``).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.resize import resize_bilinear
from .animate import MorphAnimation, rotate_all_masks, warp_all_masks_organic
from .masks import feather_mask, generate_region_masks

_MODEL_MAP = {
    "A": 0, "B": 1, "C": 2, "D": 3, "E": 4, "F": 5, "G": 6, "H": 7,
    "O": -1, "ORIGINAL": -1,
}


@dataclass
class RegionConfig:
    model_indices: list[int]
    model_weights: list[float]
    scale: float


@dataclass
class BlendAnimation:
    enabled: bool = False
    period: float = 120.0
    min_opacity: float = 0.0
    max_opacity: float = 1.0
    phase_offset: float = 0.0
    waveform: str = "sine"
    per_model_phase: bool = True


@dataclass
class ScaleAnimation:
    enabled: bool = False
    period: float = 60.0
    min_scale: float = 0.5
    max_scale: float = 1.0
    phase_offset: float = 0.0
    waveform: str = "sine"


def compute_harmonic_value(
    frame_idx, period, min_val=0.0, max_val=1.0, phase_offset=0.0, waveform="sine"
) -> float:
    """Waveform oscillator."""
    if period <= 0:
        return (min_val + max_val) / 2
    t = ((frame_idx / period) + (phase_offset / 360.0)) % 1.0
    if waveform == "sine":
        wave = (math.sin(2 * math.pi * t) + 1) / 2
    elif waveform == "triangle":
        wave = t * 2 if t < 0.5 else 2 - t * 2
    elif waveform == "sawtooth":
        wave = t
    elif waveform == "sawtooth_down":
        wave = 1 - t
    elif waveform == "square":
        wave = 1.0 if t < 0.5 else 0.0
    else:
        wave = (math.sin(2 * math.pi * t) + 1) / 2
    return min_val + wave * (max_val - min_val)


def compute_animated_weights(base_weights, frame_idx, animation: BlendAnimation):
    """Per-model phase-spread oscillation, renormalized
   ."""
    if not animation.enabled or len(base_weights) <= 1:
        return base_weights
    n = len(base_weights)
    raw = []
    for i, bw in enumerate(base_weights):
        phase = animation.phase_offset + (i * 360.0 / n if animation.per_model_phase else 0.0)
        osc = compute_harmonic_value(
            frame_idx, animation.period, animation.min_opacity, animation.max_opacity,
            phase, animation.waveform,
        )
        raw.append(osc * bw)
    total = sum(raw)
    if total < 1e-6:
        return [1.0 / n] * n
    return [w / total for w in raw]


def compute_animated_scale(base_scale, frame_idx, animation: ScaleAnimation) -> float:
    """"""
    if not animation.enabled:
        return base_scale
    return compute_harmonic_value(
        frame_idx, animation.period, animation.min_scale, animation.max_scale,
        animation.phase_offset, animation.waveform,
    )


def parse_blend_animation(spec: str | None) -> BlendAnimation:
    """'period[,waveform[,phase[,min[,max]]]]'."""
    if not spec or spec.lower() in ("none", "static", "off", "0"):
        return BlendAnimation(enabled=False)
    parts = spec.split(",")
    try:
        period = float(parts[0].strip())
    except ValueError:
        return BlendAnimation(enabled=False)
    return BlendAnimation(
        enabled=True,
        period=period,
        waveform=parts[1].strip() if len(parts) > 1 else "sine",
        phase_offset=float(parts[2]) if len(parts) > 2 else 0.0,
        min_opacity=float(parts[3]) if len(parts) > 3 else 0.0,
        max_opacity=float(parts[4]) if len(parts) > 4 else 1.0,
        per_model_phase=True,
    )


def parse_region_blend_animations(spec: str | None, num_regions: int):
    """Pipe-separated per-region specs, cycled."""
    if not spec:
        return [BlendAnimation(enabled=False)] * num_regions
    if "|" in spec:
        parts = spec.split("|")
        return [parse_blend_animation(parts[i % len(parts)].strip()) for i in range(num_regions)]
    anim = parse_blend_animation(spec)
    return [anim] * num_regions


def parse_scale_animation(spec: str | None) -> ScaleAnimation:
    """"""
    if not spec or spec.lower() in ("none", "static", "off", "0"):
        return ScaleAnimation(enabled=False)
    parts = spec.split(",")
    try:
        period = float(parts[0].strip())
    except ValueError:
        return ScaleAnimation(enabled=False)
    return ScaleAnimation(
        enabled=True,
        period=period,
        waveform=parts[1].strip() if len(parts) > 1 else "sine",
        phase_offset=float(parts[2]) if len(parts) > 2 else 0.0,
        min_scale=float(parts[3]) if len(parts) > 3 else 0.5,
        max_scale=float(parts[4]) if len(parts) > 4 else 1.0,
    )


def parse_region_scale_animations(spec: str | None, num_regions: int):
    """"""
    if not spec:
        return [ScaleAnimation(enabled=False)] * num_regions
    if "|" in spec:
        parts = spec.split("|")
        return [parse_scale_animation(parts[i % len(parts)].strip()) for i in range(num_regions)]
    anim = parse_scale_animation(spec)
    return [anim] * num_regions


def parse_region_sizes(spec: str | None, num_regions: int):
    from .masks import parse_region_sizes as _p

    return _p(spec, num_regions)


def assign_models_to_regions(
    num_regions, num_models, assignment="random", weights=None, seed=None, original_chance=0.0
):
    """Region → model index; -1 = original frame. RNG draw order preserved."""
    rng = random.Random(seed) if seed is not None else random.Random()
    if assignment == "sequential":
        if original_chance > 0:
            options = list(range(num_models)) + [-1]
            return [options[i % len(options)] for i in range(num_regions)]
        return [i % num_models for i in range(num_regions)]
    if assignment == "random":
        out = []
        for _ in range(num_regions):
            if original_chance > 0 and rng.random() < original_chance:
                out.append(-1)
            else:
                out.append(rng.randint(0, num_models - 1))
        return out
    if assignment == "weighted":
        if weights is None:
            weights = [1.0 / num_models] * num_models
        if original_chance > 0:
            total = sum(weights[:num_models])
            scaled = [(w / total) * (1.0 - original_chance) for w in weights[:num_models]]
            scaled.append(original_chance)
            options = list(range(num_models)) + [-1]
            return rng.choices(options, weights=scaled, k=num_regions)
        total = sum(weights[:num_models])
        norm = [w / total for w in weights[:num_models]]
        return rng.choices(range(num_models), weights=norm, k=num_regions)
    raise ValueError(f"Unknown assignment mode: {assignment}")


def _parse_blend_spec(spec, num_regions, num_models, scales, rng):
    """'A:0.7+B:0.3|C|O' DSL."""
    region_specs = [s.strip() for s in spec.upper().split("|") if s.strip()]
    configs = []
    for i in range(num_regions):
        region_spec = region_specs[i % len(region_specs)]
        scale = scales[i % len(scales)] if scales else 1.0
        model_indices, model_weights = [], []
        for part in (p.strip() for p in region_spec.split("+") if p.strip()):
            if ":" in part:
                model_str, weight_str = part.split(":", 1)
                model_str, weight = model_str.strip(), float(weight_str.strip())
            else:
                model_str, weight = part, None
            if model_str in _MODEL_MAP:
                idx = _MODEL_MAP[model_str]
            elif model_str.isdigit():
                idx = int(model_str)
            else:
                raise ValueError(f"Unknown model in blend spec: {model_str}")
            model_indices.append(idx)
            model_weights.append(weight)
        none_count = model_weights.count(None)
        if none_count > 0:
            specified = sum(w for w in model_weights if w is not None)
            share = max(0.0, 1.0 - specified) / none_count
            model_weights = [w if w is not None else share for w in model_weights]
        total = sum(model_weights)
        if total > 0:
            model_weights = [w / total for w in model_weights]
        else:
            model_weights = [1.0 / len(model_indices)] * len(model_indices)
        configs.append(RegionConfig(model_indices, model_weights, scale))
    return configs


def parse_region_configs(
    num_regions,
    num_models,
    assignment="sequential",
    blend_spec=None,
    scale_spec=None,
    seed=None,
    original_chance=0.0,
):
    """"""
    rng = random.Random(seed) if seed is not None else random.Random()
    scales = []
    if scale_spec:
        scales = [float(s) for s in scale_spec.replace(",", "|").split("|") if s.strip()]
    if blend_spec:
        return _parse_blend_spec(blend_spec, num_regions, num_models, scales, rng)
    assignments = assign_models_to_regions(
        num_regions, num_models, assignment, None, seed, original_chance
    )
    return [
        RegionConfig([idx], [1.0], scales[i % len(scales)] if scales else 1.0)
        for i, idx in enumerate(assignments)
    ]


def get_required_scales(
    num_regions, num_models, assignment="sequential", blend_spec=None, scale_spec=None,
    seed=None, original_chance=0.0,
):
    """Unique scales the pipeline must pre-render."""
    if not scale_spec:
        return [1.0]
    scales = [float(s) for s in scale_spec.replace(",", "|").split("|") if s.strip()]
    if not scales:
        return [1.0]
    if blend_spec:
        configs = _parse_blend_spec(
            blend_spec, num_regions, num_models, scales,
            random.Random(seed) if seed else random.Random(),
        )
        return list(set(c.scale for c in configs))
    return list(set(scales))


def _region_weight_matrix(configs: list[RegionConfig], num_models: int) -> np.ndarray:
    """[R, M+1] per-region model weights; column M is the original frame."""
    R = len(configs)
    w = np.zeros((R, num_models + 1), np.float32)
    for r, cfg in enumerate(configs):
        for idx, wt in zip(cfg.model_indices, cfg.model_weights):
            col = num_models if idx == -1 else idx
            w[r, col] += wt
    return w


def _stack_outputs(styled_outputs, original):
    outs = torch.stack([torch.as_tensor(o) for o in styled_outputs], 0)  # [M,H,W,C]
    if original is not None:
        orig = torch.as_tensor(original).to(outs.device)
        if orig.shape[:2] != outs.shape[1:3]:
            orig = resize_bilinear(orig, (outs.shape[1], outs.shape[2]))
        outs = torch.cat([outs, orig[None].to(outs.dtype)], 0)
    else:
        outs = torch.cat([outs, torch.zeros_like(outs[:1])], 0)
    return outs


def composite_with_configs(
    styled_outputs, masks: torch.Tensor, configs: list[RegionConfig], original=None
) -> torch.Tensor:
    """Device-side composite: one einsum contraction over regions and models.

    result = Σ_r mask_r · Σ_m W[r,m]·out_m  /  Σ_r mask_r
    """
    num_models = len(styled_outputs)
    outs = _stack_outputs(styled_outputs, original)  # [M+1,H,W,C]
    H, W = outs.shape[1], outs.shape[2]
    if tuple(masks.shape[-2:]) != (H, W):
        masks = resize_bilinear(masks[..., None], (H, W))[..., 0]
    wmat = torch.from_numpy(_region_weight_matrix(configs, num_models)).to(masks.device)
    per_model = torch.einsum("rhw,rm->mhw", masks, wmat)
    result = torch.einsum("mhw,mhwc->hwc", per_model, outs.float())
    total = masks.sum(dim=0).clamp(min=1e-6)[..., None]
    return (result / total).clamp(0.0, 1.0)


def composite_regions(styled_outputs, masks, assignments, original=None) -> torch.Tensor:
    """Simple one-model-per-region composite."""
    configs = [RegionConfig([a], [1.0], 1.0) for a in assignments]
    return composite_with_configs(styled_outputs, masks, configs, original)


def composite_regions_advanced(
    styled_outputs_by_scale: dict,
    masks: torch.Tensor,
    configs: list[RegionConfig],
    original=None,
    H: int = 0,
    W: int = 0,
) -> torch.Tensor:
    """Multi-scale composite: per-region nearest available scale, upsampled
   ."""
    scales = list(styled_outputs_by_scale.keys())
    first = styled_outputs_by_scale[scales[0]][0]
    if H == 0 or W == 0:
        H, W = int(first.shape[0]), int(first.shape[1])
    num_models = len(styled_outputs_by_scale[scales[0]])
    if tuple(masks.shape[-2:]) != (H, W):
        masks = resize_bilinear(masks[..., None], (H, W))[..., 0]

    # Group regions by their (snapped) scale; one einsum per scale group.
    result = torch.zeros((H, W, 3), dtype=torch.float32, device=masks.device)
    for scale in scales:
        group = [
            (r, cfg)
            for r, cfg in enumerate(configs)
            if min(scales, key=lambda s: abs(s - cfg.scale)) == scale
        ]
        if not group:
            continue
        outs = [
            resize_bilinear(torch.as_tensor(o), (H, W))
            if tuple(o.shape[:2]) != (H, W)
            else torch.as_tensor(o)
            for o in styled_outputs_by_scale[scale]
        ]
        outs = _stack_outputs(outs, original)
        rows = [r for r, _ in group]
        sub_masks = masks[torch.tensor(rows, device=masks.device)]
        wmat = torch.from_numpy(_region_weight_matrix([c for _, c in group], num_models)).to(
            masks.device)
        per_model = torch.einsum("rhw,rm->mhw", sub_masks, wmat)
        result = result + torch.einsum("mhw,mhwc->hwc", per_model, outs.float())
    total = masks.sum(dim=0).clamp(min=1e-6)[..., None]
    return (result / total).clamp(0.0, 1.0)


# Base masks (and their assignments or configs) while they animate
_mask_cache: dict = {}


def clear_mask_cache():
    global _mask_cache
    _mask_cache = {}


def _device_of(outputs) -> torch.device:
    first = outputs[0]
    return first.device if isinstance(first, torch.Tensor) else torch.device("cpu")


def blend_by_regions(
    styled_outputs,
    H,
    W,
    mode="voronoi",
    region_count=None,
    assignment="random",
    weights=None,
    feather=20,
    seed=None,
    original=None,
    original_chance=0.0,
    frame_idx=0,
    rotation_rate=0.0,
    morph: MorphAnimation | None = None,
    region_sizes: list[float] | None = None,
) -> torch.Tensor:
    """High-level simple region blend; the masks live on the outputs'
    device. ``region_sizes`` weights the voronoi cells."""
    num_models = len(styled_outputs)
    if region_count is None:
        region_count = num_models
    needs_caching = rotation_rate != 0 or (morph and morph.enabled)
    sizes_key = tuple(region_sizes) if region_sizes else None
    cache_key = (H, W, mode, region_count, seed, feather, sizes_key)
    if needs_caching and cache_key in _mask_cache:
        base_masks, assignments = _mask_cache[cache_key]
        base_masks = base_masks.to(_device_of(styled_outputs))
    else:
        base_masks = generate_region_masks(
            H, W, mode, region_count, seed, feather, region_sizes=region_sizes,
            device=_device_of(styled_outputs)
        )
        assignments = assign_models_to_regions(
            base_masks.shape[0], num_models, assignment, weights, seed, original_chance
        )
        if needs_caching:
            _mask_cache[cache_key] = (base_masks, assignments)
    masks = base_masks
    if rotation_rate != 0:
        masks = rotate_all_masks(masks, frame_idx * rotation_rate)
        masks = feather_mask(masks[..., None], feather // 2)[..., 0]
    if morph and morph.enabled:
        masks = warp_all_masks_organic(masks, morph, frame_idx)
        masks = feather_mask(masks[..., None], max(5, feather // 4))[..., 0]
    if not needs_caching:
        assignments = assign_models_to_regions(
            masks.shape[0], num_models, assignment, weights, seed, original_chance
        )
    return composite_regions(styled_outputs, masks, assignments, original)


def blend_by_regions_advanced(
    styled_outputs_by_scale: dict,
    H,
    W,
    mode="voronoi",
    region_count=None,
    assignment="random",
    blend_spec=None,
    scale_spec=None,
    weights=None,
    feather=20,
    seed=None,
    original=None,
    original_chance=0.0,
    frame_idx=0,
    rotation_rate=0.0,
    morph: MorphAnimation | None = None,
    blend_animations: list[BlendAnimation] | None = None,
    scale_animations: list[ScaleAnimation] | None = None,
    region_sizes: list[float] | None = None,
) -> torch.Tensor:
    """Advanced multi-scale region blend. ``blend_animations`` (when given)
    animates each region's weights per frame before compositing;
    ``scale_animations`` animates each region's render scale, snapped to the
    nearest pre-rendered scale."""
    first_scale = list(styled_outputs_by_scale.keys())[0]
    num_models = len(styled_outputs_by_scale[first_scale])
    if region_count is None:
        region_count = num_models
    needs_caching = rotation_rate != 0 or (morph and morph.enabled)
    sizes_key = tuple(region_sizes) if region_sizes else None
    cache_key = (H, W, mode, region_count, seed, feather, blend_spec, scale_spec, sizes_key)
    if needs_caching and cache_key in _mask_cache:
        base_masks, configs = _mask_cache[cache_key]
        base_masks = base_masks.to(_device_of(styled_outputs_by_scale[first_scale]))
    else:
        base_masks = generate_region_masks(
            H, W, mode, region_count, seed, feather, region_sizes=region_sizes,
            device=_device_of(styled_outputs_by_scale[first_scale])
        )
        configs = parse_region_configs(
            base_masks.shape[0], num_models, assignment, blend_spec, scale_spec,
            seed, original_chance,
        )
        if needs_caching:
            _mask_cache[cache_key] = (base_masks, configs)
    masks = base_masks
    if rotation_rate != 0:
        masks = rotate_all_masks(masks, frame_idx * rotation_rate)
        masks = feather_mask(masks[..., None], feather // 2)[..., 0]
    if morph and morph.enabled:
        masks = warp_all_masks_organic(masks, morph, frame_idx)
        masks = feather_mask(masks[..., None], max(5, feather // 4))[..., 0]
    if not needs_caching:
        configs = parse_region_configs(
            masks.shape[0], num_models, assignment, blend_spec, scale_spec,
            seed, original_chance,
        )
    if blend_animations:
        animated = []
        for r, cfg in enumerate(configs):
            anim = blend_animations[r % len(blend_animations)]
            animated.append(
                RegionConfig(
                    cfg.model_indices,
                    compute_animated_weights(cfg.model_weights, frame_idx, anim),
                    cfg.scale,
                )
            )
        configs = animated
    if scale_animations:
        configs = [
            RegionConfig(
                cfg.model_indices,
                cfg.model_weights,
                compute_animated_scale(
                    cfg.scale, frame_idx, scale_animations[r % len(scale_animations)]
                ),
            )
            for r, cfg in enumerate(configs)
        ]
    return composite_regions_advanced(styled_outputs_by_scale, masks, configs, original, H, W)
