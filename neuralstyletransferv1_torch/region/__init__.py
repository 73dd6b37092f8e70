"""Region engine: mask generation, animation, blend-spec DSL, compositing.

The port's copy of ``neuralstyletransferv1_tpu/region``, with the same
exported names. Masks are generated once per (shape, mode, count, seed,
feather) on the host (the generators keep the ``random.Random(seed)`` draw
order) and live on the device as a stacked [R, H, W] tensor; the per-frame
rotation, organic warps, feathering and compositing run in PyTorch ops there.
"""

from .masks import generate_region_masks, feather_mask, AVAILABLE_MODES
from .animate import (
    MorphAnimation,
    parse_morph_animation,
    rotate_all_masks,
    warp_all_masks_organic,
)
from .blend import (
    BlendAnimation,
    RegionConfig,
    ScaleAnimation,
    assign_models_to_regions,
    blend_by_regions,
    blend_by_regions_advanced,
    clear_mask_cache,
    composite_regions,
    compute_animated_scale,
    compute_animated_weights,
    compute_harmonic_value,
    get_required_scales,
    parse_blend_animation,
    parse_region_blend_animations,
    parse_region_configs,
    parse_region_scale_animations,
    parse_region_sizes,
    parse_scale_animation,
)

__all__ = [
    "generate_region_masks",
    "feather_mask",
    "AVAILABLE_MODES",
    "MorphAnimation",
    "parse_morph_animation",
    "rotate_all_masks",
    "warp_all_masks_organic",
    "BlendAnimation",
    "RegionConfig",
    "ScaleAnimation",
    "assign_models_to_regions",
    "blend_by_regions",
    "blend_by_regions_advanced",
    "clear_mask_cache",
    "composite_regions",
    "compute_animated_scale",
    "compute_animated_weights",
    "compute_harmonic_value",
    "get_required_scales",
    "parse_blend_animation",
    "parse_region_blend_animations",
    "parse_region_configs",
    "parse_region_scale_animations",
    "parse_region_sizes",
    "parse_scale_animation",
]
