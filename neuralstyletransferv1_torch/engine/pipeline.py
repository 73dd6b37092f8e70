"""The engine: decode → stylize → flow → temporal chain → encode, for
videos and images.

Counterpart of ``neuralstyletransferv1_tpu/engine/pipeline.py``, with the
same CLI surface (``engine/config.build_arg_parser``, a copy of the JAX
engine's) and the same three runners:

- ``style_video_stream`` (video, ``--frame_batch`` > 1, ``--stream auto``):
  decode → device batches → encode, no frame files;
- ``style_frames_batched`` (``--frame_batch`` > 1 on frame files: ``--stream
  off`` after extraction, and the batch image mode): device batches over
  ``frame_*`` files, decoded ahead by the C++ frame loader
  (``io/native_loader.py``);
- ``style_frames`` (the default ``--frame_batch 1``, and the single-image
  mode): the per-frame loop.

The batched runners share ``make_batched_core``: frames cross to the device
as uint8 and convert there, the temporal state stays on the device between
batches, and the previous batch's frames are copied back and written while
the device works on the next one. ``--mesh_devices`` > 1 splits each batch
across a device mesh (``parallel/mesh.py``), as the JAX engine's batched
core shards it. ``--profile_dir`` wraps the runner in ``torch.profiler``
and writes the trace into that directory, around the region the JAX
engine traces.
"""

from __future__ import annotations

import re
import sys
import time
import uuid
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..io import frames as fio
from .config import build_arg_parser

_LETTERS = "abcdefgh"


def effective_flow_downscale(flow_downscale: int, h: int, w: int) -> int:
    """Resolve --flow_downscale 0 (auto): 2 when the half-resolution frame
    still holds the full DIS pyramid (min dim >= 512), else 1."""
    if flow_downscale <= 0:
        return 2 if min(h, w) >= 512 else 1
    return flow_downscale


def flows_at_downscale(args, prevs: torch.Tensor, grays: torch.Tensor) -> torch.Tensor:
    """Flow prevs[i] → grays[i] ([N,H,W] gray) by --flow_method (DIS or
    Farneback) at the auto/explicit --flow_downscale, scaled back to the
    frame size: [N,H,W,2]."""
    from ..ops.dis_flow import dis_flow
    from ..ops.flow import farneback_flow
    from ..ops.resize import resize_bilinear

    flow = dis_flow if args.flow_method == "dis" else farneback_flow
    H, W = grays.shape[1], grays.shape[2]
    ds = effective_flow_downscale(int(args.flow_downscale), H, W)
    if ds <= 1:
        return flow(prevs, grays)
    hs, ws = H // ds, W // ds
    f_small = flow(resize_bilinear(prevs[..., None], (hs, ws))[..., 0],
                   resize_bilinear(grays[..., None], (hs, ws))[..., 0])
    return resize_bilinear(f_small, (H, W)) * float(ds)


def parse_blend_weights(weights_str: str | None, num_models: int) -> list[float]:
    if not weights_str:
        return [1.0 / num_models] * num_models
    weights = [float(w) for w in weights_str.split(",")]
    if len(weights) != num_models:
        raise ValueError(f"Expected {num_models} weights, got {len(weights)}")
    if abs(sum(weights) - 1.0) > 1e-6:
        raise ValueError(f"Weights must sum to 1.0, got {sum(weights):.6f}")
    return weights


def parse_lab_weights(weights_str: str | None) -> tuple[float, float]:
    """``--blend_models_lab_weights`` "wL,wab" (default 0.5, 0.5; must sum to 1)."""
    if not weights_str:
        return 0.5, 0.5
    wL, wab = [float(w) for w in weights_str.split(",")]
    if abs(wL + wab - 1.0) > 1e-6:
        raise ValueError(f"LAB weights must sum to 1.0, got {wL + wab:.6f}")
    return wL, wab


def _lab_rest_weights(args, num_models: int) -> list[float]:
    """The a/b weights of slots B.. in the LAB blend: ``--blend_models_weights``
    over them, or equal when those do not parse."""
    n = max(num_models - 1, 1)
    try:
        return parse_blend_weights(args.blend_models_weights, n)
    except Exception:
        return [1.0 / n] * n


def _lab_blend(args, outs: torch.Tensor, num_models: int) -> torch.Tensor:
    """``--blend_models_lab``: L from slot A, the a/b planes a weighted mix
    of slots B.. blended with A's by (wL, wab), on the PIL-convention LAB
    byte planes. ``outs``: the slots' outputs stacked, [M, ..., 3] (a frame
    or a batch)."""
    from ..ops.color import lab_u8_to_rgb, rgb_to_lab_u8

    wL, wab = parse_lab_weights(args.blend_models_lab_weights)
    lab_a = rgb_to_lab_u8(outs[0])
    lab_rest = rgb_to_lab_u8(outs[1:])
    wr = torch.tensor(_lab_rest_weights(args, num_models), dtype=torch.float32,
                      device=outs.device).view(-1, *([1] * (outs.dim() - 2)))
    a_mix = (wr * lab_rest[..., 1]).sum(dim=0)
    b_mix = (wr * lab_rest[..., 2]).sum(dim=0)
    lab_mix = torch.stack([lab_a[..., 0], (wL * lab_a[..., 1] + wab * a_mix).clamp(0, 255),
                           (wL * lab_a[..., 2] + wab * b_mix).clamp(0, 255)], dim=-1)
    return lab_u8_to_rgb(lab_mix)


def load_mask_fit(mask_path: str, target_hw: tuple[int, int], invert: bool, feather_px: int,
                  autofix: bool = True, force_transpose: bool = False) -> np.ndarray:
    """A mask image as an f32 [H,W,1] alpha in [0,1] at ``target_hw``:
    greyscale, transposed when its aspect ratio is closer (in log space) to
    the target's transposed one (``autofix``) or ``force_transpose``, nearest
    resize, optionally inverted, feathered by OpenCV's uint8 Gaussian blur
    (sigma feather_px / 2) on the host."""
    from PIL import Image

    H_tgt, W_tgt = target_hw
    m_img = Image.open(mask_path).convert("L")
    if force_transpose:
        m_img = m_img.transpose(Image.TRANSPOSE)
    mw, mh = m_img.size
    if autofix and not force_transpose and W_tgt != H_tgt:
        transpose = (mw, mh) == (H_tgt, W_tgt)
        if not transpose:
            def _dist(a, b):
                return abs(np.log(max(a, 1e-6)) - np.log(max(b, 1e-6)))

            transpose = _dist(mw / mh, H_tgt / W_tgt) + 1e-6 < _dist(mw / mh, W_tgt / H_tgt)
        if transpose:
            print(f"[mask][autofix] {Path(mask_path).name}: applying transpose")
            m_img = m_img.transpose(Image.TRANSPOSE)
    m_img = m_img.resize((W_tgt, H_tgt), Image.Resampling.NEAREST)
    m = np.array(m_img, dtype=np.uint8)
    if invert:
        m = 255 - m
    if feather_px and feather_px > 0:
        try:
            import cv2

            m = cv2.GaussianBlur(m, (0, 0), sigmaX=feather_px * 0.5, sigmaY=feather_px * 0.5)
        except ImportError:
            from ..ops.blur import gaussian_blur

            m = gaussian_blur(torch.from_numpy(m.astype(np.float32)),
                              feather_px * 0.5).numpy().astype(np.uint8)
    return (m.astype(np.float32) / 255.0)[..., None]


def _mask_file(args, frame_path: Path) -> str | None:
    """The frame's mask: ``--mask``, else ``mask_<n>.png`` of ``--mask_dir``
    for frame ``frame_<n>`` where it exists."""
    if args.mask:
        return args.mask
    if args.mask_dir:
        cand = Path(args.mask_dir) / f"mask_{frame_path.stem.split('_')[-1]}.png"
        if cand.exists():
            return str(cand)
    return None


def _mask_feather(args, ref_h: int) -> int:
    feather_px = args.mask_feather
    if args.mask_feather_pct > 0:
        feather_px = max(feather_px, int(ref_h * args.mask_feather_pct / 100.0))
    return feather_px


def preflight_mask_dir(args, frame_files) -> None:
    """Check ``--mask_dir`` before styling: no mask for any frame exits 2,
    some missing warns."""
    if not args.mask_dir or args.mask:
        return
    try:
        md = Path(args.mask_dir)
        missing = [p.name for p in frame_files
                   if not (md / f"mask_{p.stem.split('_')[-1]}.png").exists()]
        total = len(frame_files)
        if total > 0 and len(missing) == total:
            print(f"[mask][ERROR] --mask_dir set to {md} but no masks like mask_0001.png were "
                  "found.")
            print("               Refusing to run unmasked; generate masks or remove --mask_dir.")
            sys.exit(2)
        elif missing:
            print(f"[mask][WARN] {len(missing)}/{total} mask(s) missing under {md}.")
            print("            Missing-mask frames will be fully stylized unless a global --mask "
                  "is provided.")
    except SystemExit:
        raise
    except Exception as e:
        print(f"[mask][WARN] could not validate --mask_dir: {e}")


def _mask_debug_dump(args, frames_dir: Path, idx: int, alpha: np.ndarray,
                     base_u8: np.ndarray) -> None:
    """``--mask_debug_alpha`` / ``--mask_debug_overlay``: the fitted alpha as
    a PNG and a red overlay JPEG under ``<work_dir>/debug``."""
    from PIL import Image

    debug_dir = frames_dir.parent / "debug"
    debug_dir.mkdir(parents=True, exist_ok=True)
    if args.mask_debug_alpha:
        Image.fromarray((alpha[..., 0] * 255).astype(np.uint8)).save(
            debug_dir / f"alpha_{idx:04d}.png")
    if args.mask_debug_overlay:
        tint = np.zeros_like(base_u8)
        tint[..., 0] = 255
        a3 = np.repeat(alpha, 3, axis=2)
        overlay = (base_u8 * (1.0 - 0.35 * a3) + tint * (0.35 * a3)).clip(0, 255).astype(
            np.uint8)
        Image.fromarray(overlay).save(debug_dir / f"overlay_{idx:04d}.jpg", quality=92)


def _parse_region_seed(args, morph_anim):
    """``--region_seed``: an int, "fixed" (42) or "random" (None: an unseeded
    ``random.Random()``); unset, 42 while the regions animate, else None."""
    seed_str = args.region_seed
    animating = args.region_rotate != 0 or (morph_anim and morph_anim.enabled)
    if seed_str is None:
        return 42 if animating else None
    if seed_str.lower() == "random":
        return None
    if seed_str.lower() == "fixed":
        return 42
    try:
        return int(seed_str)
    except ValueError:
        return None


class _RegionSetup:
    """The ``--region_*`` flags, parsed once a job: the morph animation, the
    per-region blend and scale animations, the voronoi sizes and the seed."""

    def __init__(self, args, num_models: int):
        from ..region import (parse_morph_animation, parse_region_blend_animations,
                              parse_region_scale_animations, parse_region_sizes)

        count = args.region_count or num_models
        self.morph = parse_morph_animation(args.region_morph) if args.region_morph else None
        self.blend_anims = (parse_region_blend_animations(
            args.blend_animate_regions or args.blend_animate, count)
            if (args.blend_animate or args.blend_animate_regions) else None)
        self.scale_anims = (parse_region_scale_animations(
            args.scale_animate_regions or args.scale_animate, count)
            if (args.scale_animate or args.scale_animate_regions) else None)
        self.sizes = parse_region_sizes(args.region_sizes, count) if args.region_sizes else None
        self.seed = _parse_region_seed(args, self.morph)


#: the render scales an animated per-region scale snaps to
_SCALE_LADDER = (0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)

#: (masks, configs) per key for the crop path, cached for the job
_crop_cache: dict = {}


def _region_blend(args, outputs: list, x_orig: torch.Tensor, H0: int, W0: int, idx: int,
                  num_models: int, rs: _RegionSetup) -> torch.Tensor:
    """The full-frame region composite of frame ``idx`` (1-based) from every
    slot's HWC output: ``blend_by_regions``, or ``blend_by_regions_advanced``
    with a blend spec, render scales or scale animations (every ladder scale
    an animation reaches is rendered)."""
    from ..ops.resize import resize_bilinear
    from ..region import blend_by_regions, blend_by_regions_advanced, get_required_scales

    region_count = args.region_count or num_models
    weights = None
    if args.region_assignment == "weighted":
        try:
            weights = parse_blend_weights(args.blend_models_weights, num_models)
        except Exception:
            weights = None
    has_scale_anim = bool(rs.scale_anims) and any(a.enabled for a in rs.scale_anims)
    if args.region_blend_spec or args.region_scales or has_scale_anim:
        required = get_required_scales(region_count, num_models, args.region_assignment,
                                       args.region_blend_spec, args.region_scales, rs.seed,
                                       args.region_original)
        if has_scale_anim:
            for anim in rs.scale_anims:
                if anim.enabled:
                    required.extend(s for s in _SCALE_LADDER
                                    if anim.min_scale - 1e-6 <= s <= anim.max_scale + 1e-6)
            required = sorted(set(required))
        by_scale = {}
        for scale in required:
            if scale == 1.0:
                by_scale[1.0] = outputs
            else:
                sh, sw = int(H0 * scale), int(W0 * scale)
                by_scale[scale] = [resize_bilinear(o, (sh, sw)) for o in outputs]
        use_orig = args.region_original > 0 or (args.region_blend_spec
                                                and "O" in args.region_blend_spec.upper())
        return blend_by_regions_advanced(
            by_scale, H0, W0, mode=args.region_mode, region_count=region_count,
            assignment=args.region_assignment, blend_spec=args.region_blend_spec,
            scale_spec=args.region_scales, weights=weights, feather=args.region_feather,
            seed=rs.seed, original=x_orig if use_orig else None,
            original_chance=args.region_original, frame_idx=idx,
            rotation_rate=args.region_rotate, morph=rs.morph, blend_animations=rs.blend_anims,
            scale_animations=rs.scale_anims, region_sizes=rs.sizes)
    return blend_by_regions(
        outputs, H0, W0, mode=args.region_mode, region_count=region_count,
        assignment=args.region_assignment, weights=weights, feather=args.region_feather,
        seed=rs.seed, original=x_orig if args.region_original > 0 else None,
        original_chance=args.region_original, frame_idx=idx, rotation_rate=args.region_rotate,
        morph=rs.morph, region_sizes=rs.sizes)


def _region_blend_optimized(args, stylize_fns: list, x_orig: np.ndarray, H0: int, W0: int,
                            idx: int, num_models: int, rs: _RegionSetup,
                            device: torch.device) -> np.ndarray:
    """``--region_optimize``: style only each region's padded crop (crops
    bucketed and batched per slot, ``region/crops.py``), per-region scales
    and animated scales (snapped to ``_SCALE_LADDER``) applied to the crop,
    then ``composite_from_crops``; returns the HWC f32 numpy frame."""
    from ..ops.resize import resize_bilinear
    from ..region import (compute_animated_scale, feather_mask, generate_region_masks,
                          parse_region_configs, rotate_all_masks, warp_all_masks_organic)
    from ..region.crops import (composite_from_crops, compute_crop_coverage,
                                models_needed_for_regions, prepare_region_crops,
                                style_crop_batched)

    region_count = args.region_count or num_models
    # the crop path defaults to a fixed seed, for stable regions
    seed = 42 if rs.seed is None and args.region_seed is None else rs.seed
    cache_key = (H0, W0, args.region_mode, region_count, seed, args.region_feather,
                 tuple(rs.sizes) if rs.sizes else None, args.region_blend_spec,
                 args.region_scales)
    if cache_key in _crop_cache:
        base_masks, configs = _crop_cache[cache_key]
        base_masks = base_masks.to(device)
    else:
        base_masks = generate_region_masks(H0, W0, args.region_mode, region_count, seed,
                                           args.region_feather, region_sizes=rs.sizes,
                                           device=device)
        configs = parse_region_configs(int(base_masks.shape[0]), num_models,
                                       args.region_assignment, args.region_blend_spec,
                                       args.region_scales, seed, args.region_original)
        _crop_cache[cache_key] = (base_masks, configs)
    masks = base_masks
    if args.region_rotate != 0:
        masks = rotate_all_masks(masks, idx * args.region_rotate)
        masks = feather_mask(masks[..., None], args.region_feather // 2)[..., 0]
    if rs.morph and rs.morph.enabled:
        masks = warp_all_masks_organic(masks, rs.morph, idx)
        masks = feather_mask(masks[..., None], max(5, args.region_feather // 4))[..., 0]
    masks_np = masks.cpu().numpy()

    crops = prepare_region_crops(masks_np, configs, H0, W0, args.region_padding)
    needed = models_needed_for_regions(crops)
    if idx <= 2:
        print(f"[region-opt][{idx}] mode={args.region_mode} regions={len(crops)} "
              f"models_needed={needed} coverage={compute_crop_coverage(crops, H0, W0):.1%} "
              f"padding={args.region_padding}px")

    def on_device(fn):
        return lambda batch: fn(torch.from_numpy(batch).to(device)).cpu().numpy()

    styled: dict = {}
    for model_idx in needed:
        if model_idx >= len(stylize_fns):
            print(f"[region-opt][WARN] Model {model_idx} requested but not loaded, skipping")
            continue
        regions = [c for c in crops if model_idx in c.config.model_indices]
        crop_px = []
        for c in regions:
            x1, y1, x2, y2 = c.padded_bbox
            px = x_orig[y1:y2, x1:x2]
            base_scale = c.config.scale
            if rs.scale_anims:
                s = compute_animated_scale(base_scale, idx,
                                           rs.scale_anims[c.region_idx % len(rs.scale_anims)])
                base_scale = min(_SCALE_LADDER, key=lambda v: abs(v - s))
            if base_scale < 1.0:
                sh = max(1, int(px.shape[0] * base_scale))
                sw = max(1, int(px.shape[1] * base_scale))
                px = resize_bilinear(torch.from_numpy(np.ascontiguousarray(px)), (sh, sw)).numpy()
            crop_px.append(px)
        outs = style_crop_batched(crop_px, on_device(stylize_fns[model_idx]))
        styled[model_idx] = {}
        for c, out in zip(regions, outs):
            x1, y1, x2, y2 = c.padded_bbox
            if out.shape[:2] != (y2 - y1, x2 - x1):
                out = resize_bilinear(torch.from_numpy(np.ascontiguousarray(out)),
                                      (y2 - y1, x2 - x1)).numpy()
            styled[model_idx][c.region_idx] = out
    use_orig = args.region_original > 0 or (args.region_blend_spec
                                            and "O" in args.region_blend_spec.upper())
    return composite_from_crops(styled, crops, x_orig if use_orig else None, H0, W0, masks_np,
                                frame_idx=idx, blend_animations=rs.blend_anims)


def build_parser():
    """The shared CLI surface, with ``--device`` defaulting to cuda."""
    ap = build_arg_parser()
    ap.set_defaults(device="cuda")
    return ap


def _slot_args(args):
    """(checkpoint, model type, IO preset, magenta style) of slots A..H."""
    yield args.model, args.model_type, args.io_preset, args.magenta_style
    for letter in _LETTERS[1:]:
        yield (getattr(args, f"model_{letter}"), getattr(args, f"model_{letter}_type"),
               getattr(args, f"io_preset_{letter}"), getattr(args, f"magenta_style_{letter}"))


def load_slot_bank(args, device) -> list:
    """Slots A..H on ``device``, as the JAX engine's ``_load_slot`` loads
    them: a Johnson, NST_Train, ReCoNet or Torch7 checkpoint (a ``.t7`` file
    loads as a Torch7 slot whatever its ``--model*_type``), or a magenta
    slot from its ``--magenta_style*`` image and the ``--magenta_*`` flags;
    a slot with neither is empty."""
    from . import stylizer as st

    slots = []
    for path, model_type, io_preset, style in _slot_args(args):
        if model_type == "magenta":
            if style:
                slots.append(st.load_model(style, model_type="magenta", device=device,
                                           magenta_args=args))
        elif path:
            slots.append(st.load_model(path, model_type=model_type, io_preset=io_preset,
                                       device=device))
    return slots


def list_frame_files(args, frames_dir: Path) -> list[Path]:
    """The ``frame_*`` files of ``frames_dir`` in order, then ``--stride`` and
    ``--max_frames``; exits 2 when there is none."""
    frame_files = sorted(list(frames_dir.glob("frame_*.png"))
                         + list(frames_dir.glob("frame_*.jpg"))
                         + list(frames_dir.glob("frame_*.jpeg")))
    frame_files = frame_files[::max(1, args.stride)]
    if args.max_frames:
        frame_files = frame_files[:args.max_frames]
    if not frame_files:
        print(f"[error] no frames found in {frames_dir}")
        sys.exit(2)
    return frame_files


def _out_path(args, frames_dir: Path, frame_path: Path, idx: int, image_mode: bool,
              save_map: dict[int, str]) -> tuple[Path, bool]:
    """Where styled frame ``idx`` (1-based) goes, and whether as JPEG: the
    image mode's target for that frame, else ``<output_prefix>_<n>`` beside
    the frames."""
    if image_mode and idx in save_map:
        out = Path(save_map[idx])
        out.parent.mkdir(parents=True, exist_ok=True)
        return out, out.suffix.lower() in (".jpg", ".jpeg")
    jpg = args.image_ext.lower() == "jpg"
    stem = f"{args.output_prefix}_{frame_path.stem.split('_')[-1]}"
    return (frames_dir / stem).with_suffix(".jpg" if jpg else ".png"), jpg


def _save(img_u8: np.ndarray, out_path: Path, jpg: bool, quality: int) -> None:
    from PIL import Image

    img = Image.fromarray(img_u8)
    if jpg:
        img.save(out_path, format="JPEG", quality=int(quality))
    else:
        img.save(out_path)


def engine_mesh(args, device: torch.device, mesh=None):
    """The ``--mesh_devices`` mesh of a batched run, or None for one device:
    JAX's clamp to the visible devices and its rounding of
    ``--frame_batch`` up to a multiple of the mesh size (``args`` is
    updated), with the JAX engine's printed lines. ``mesh``: an explicit
    ``parallel.mesh.Mesh`` instead of the flag (two shards on one card)."""
    from ..parallel import mesh as pm

    if mesh is None:
        n = int(args.mesh_devices or 0)
        if n <= 1:
            return None
        avail = pm.visible_devices(device, n)
        if n > avail:
            print(f"[mesh] only {avail} device(s) visible; clamping --mesh_devices {n} -> {avail}")
            n = pm.clamp_mesh(n, avail)
        if n <= 1:
            return None
        mesh = pm.make_mesh(n, device.type)
    n = len(mesh)
    if int(args.frame_batch) % n:
        new_b = pm.round_batch(int(args.frame_batch), n)
        print(f"[mesh] rounding --frame_batch {args.frame_batch} -> {new_b} (multiple of {n})")
        args.frame_batch = new_b
    print(f"[mesh] data-parallel stylize over {n} device(s)")
    return mesh


def make_batched_core(args, device: torch.device, *, fused_sites=None,
                      frames_dir: Path | None = None, mesh=None):
    """The per-batch pipeline: slot-bank stylize → slot blend (RGB weights,
    ``--blend_models_lab``, or the ``--region_*`` composite per frame) →
    ``--flow_method`` flow → temporal chain (with the ``--mask`` /
    ``--mask_dir`` composite), uint8 in and out. ``fused_sites``: the
    fused-site set (``jit_stylizer``): None is the adopted one in the int8
    modes and no fused site otherwise; ``head``, ``tail`` and ``d3`` name
    the bf16 sites. ``frames_dir``: where the mask debug dumps go (its
    parent's ``debug``).

    Returns (B, process_batch) where ``process_batch(imgs: list[np.uint8
    HWC], names: list[Path] | None, b0: int) -> device uint8 [B,H,W,3]``:
    ``names`` are the frames' files (``frame_<n>``, for ``--mask_dir``) and
    ``b0`` the index of the batch's first frame in the job (0-based; the
    region masks animate by the frame number); the temporal state carries
    across calls. ``--inference_res`` stylizes at that long side (the size
    fixed by the first batch) and resizes the outputs back to the frame
    size. Padded tail frames of the last batch reuse the last real frame's
    region composite and draw nothing from the mask RNG.
    """
    from ..ops.color import rgb_to_gray
    from ..ops.resize import resize_bilinear
    from ..parallel.mesh import temporal_postprocess_sharded
    from ..temporal.ema import TemporalState, temporal_postprocess_split
    from . import stylizer as st

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    if mesh is not None:
        device = mesh.primary
    models = load_slot_bank(args, device)
    num_models = len(models)
    print(f"[bank] {num_models} slot(s): "
          + ", ".join(f"{m.name}({m.arch}/{m.io_preset})" for m in models))
    mesh = engine_mesh(args, device, mesh)
    stylize_fns = [st.jit_stylizer(m, dtype=dtype, quantize=args.quantize, fused_sites=fused_sites,
                                   mesh=mesh) for m in models]
    use_lab_blend = args.blend_models_lab and num_models > 1
    weights = parse_blend_weights(args.blend_models_weights, num_models) \
        if num_models > 1 and not use_lab_blend else [1.0]
    w_slots = torch.tensor(weights, dtype=torch.float32, device=device)[:, None, None, None, None]
    rs = _RegionSetup(args, num_models) if args.region_mode else None
    mask_active = bool(args.mask or args.mask_dir)
    alpha_cache: dict = {}  # the constant --mask, loaded once per size

    def frame_alpha(name: Path, H0: int, W0: int):
        """(alpha [H,W,1] f32, has) of one frame."""
        mask_file = _mask_file(args, name)
        if not mask_file:
            return np.zeros((H0, W0, 1), np.float32), False
        key = (mask_file, H0, W0)
        if key not in alpha_cache:
            alpha = load_mask_fit(mask_file, (H0, W0), args.mask_invert,
                                  _mask_feather(args, H0), autofix=args.mask_autofix,
                                  force_transpose=args.mask_force_transpose)
            if mask_file != args.mask:  # a --mask_dir mask is the frame's own
                return alpha, True
            alpha_cache[key] = alpha
        return alpha_cache[key], True

    B = max(1, int(args.frame_batch))
    chain_kwargs = dict(
        flow_ema=args.flow_ema, flow_alpha=args.flow_alpha,
        smooth_lightness=args.smooth_lightness, smooth_chroma=args.smooth_chroma,
        smooth_alpha=args.smooth_alpha, chroma_alpha=args.chroma_alpha,
        motion_blend=args.motion_blend, blend=args.blend,
        fast_warp=not args.exact_warp, composite_keep=args.composite_mode == "keep",
    )
    carry = {"state": None, "prev_gray": None, "infer_hw": None}

    @torch.no_grad()
    def process_batch(imgs: list, names: list | None = None, b0: int = 0) -> torch.Tensor:
        n_real = len(imgs)
        imgs = list(imgs)
        while len(imgs) < B:  # pad the final batch; its extra outputs are dropped
            imgs.append(imgs[-1])
        u8 = torch.from_numpy(np.stack(imgs, 0))
        if device.type == "cuda":
            u8 = u8.pin_memory().to(device, non_blocking=True)
        orig = u8.float() / 255.0
        grays = rgb_to_gray(orig * 255.0)
        H0, W0 = orig.shape[1], orig.shape[2]

        src = orig
        if args.inference_res and max(H0, W0) > args.inference_res:
            if carry["infer_hw"] is None:
                s = args.inference_res / max(H0, W0)
                carry["infer_hw"] = (int(round(H0 * s)), int(round(W0 * s)))
            src = resize_bilinear(orig, carry["infer_hw"])
        # each slot's output, locked to the content size
        outs = [o if o.shape[1:3] == (H0, W0) else resize_bilinear(o, (H0, W0))
                for o in (fn(src) for fn in stylize_fns)]
        if rs is not None:
            # per frame, on the host's mask stream: the padded tail frames
            # reuse the last real frame's composite
            frames = []
            for i in range(B):
                frames.append(frames[-1] if i >= n_real else _region_blend(
                    args, [o[i] for o in outs], orig[i], H0, W0, b0 + i + 1, num_models, rs))
            styled = torch.stack(frames, 0)
        elif use_lab_blend:
            styled = _lab_blend(args, torch.stack(outs, 0), num_models)
        else:
            styled = (w_slots * torch.stack(outs, 0)).sum(dim=0).clamp(0.0, 1.0)
        masks = {}
        if mask_active:
            alphas = np.zeros((B, H0, W0, 1), np.float32)
            has = np.zeros((B,), bool)
            for i in range(n_real):
                name = names[i] if names is not None else Path(f"frame_{b0 + i + 1:04d}.png")
                alphas[i], has[i] = frame_alpha(name, H0, W0)
                if has[i] and (args.mask_debug_alpha or args.mask_debug_overlay) \
                        and frames_dir is not None:
                    _mask_debug_dump(args, frames_dir, b0 + i + 1, alphas[i], imgs[i])
            masks = dict(mask_alphas=torch.from_numpy(alphas).to(device),
                         mask_has=torch.from_numpy(has).to(device))

        first = carry["state"] is None
        if first:  # first batch: frame 0 is its own predecessor
            carry["prev_gray"] = grays[0]
        flows = None
        if args.flow_ema:
            # the whole batch's flows, the previous batch's boundary pair
            # included, so that the mesh's chunk seams warp with the true flow
            prevs = torch.cat([carry["prev_gray"][None], grays[:-1]], 0)
            flows = flows_at_downscale(args, prevs, grays)
        if mesh is not None:
            if first:  # JAX's zero carry; shard 0 warms up from it
                zero = torch.zeros((H0, W0, 3), dtype=torch.float32, device=device)
                carry["state"] = TemporalState(zero, zero)
            out, carry["state"] = temporal_postprocess_sharded(
                mesh, styled, orig, flows, state=carry["state"], first=first, **chain_kwargs,
                **masks)
        else:
            out, carry["state"] = temporal_postprocess_split(
                styled, orig, flows, init=carry["state"], **chain_kwargs, **masks)
        carry["prev_gray"] = grays[-1]
        return (out.clamp(0.0, 1.0) * 255.0).to(torch.uint8)

    return B, process_batch


class _HostCopy:
    """A batch's uint8 frames on their way to the host: the copy is queued
    behind the batch's compute, and ``wait`` blocks only on that copy, so the
    host encodes batch k while the device runs batch k+1."""

    def __init__(self, out_dev: torch.Tensor, n_real: int):
        self.n = n_real
        if out_dev.device.type == "cuda":
            self.host = torch.empty(out_dev.shape, dtype=torch.uint8, pin_memory=True)
            self.host.copy_(out_dev, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = out_dev, None

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def style_video_stream(args, device: torch.device, frames_dir: Path | None = None):
    """Streaming video path: decode → device batches → encode, with no frame
    files. Decode and encode run on the shared io/frames background threads.

    Returns (written_frames, streamed_frames, src_fps). ``frames_dir``: where
    the mask debug dumps go (its parent's ``debug``).
    """
    B, process_batch = make_batched_core(args, device, frames_dir=frames_dir)
    canvas_wh = None
    if args.canvas:
        cw, ch = args.canvas.lower().split("x")
        canvas_wh = (int(cw), int(ch))
    stream = fio.VideoFrameStream(
        Path(args.input_video).resolve(), fps=args.pre_fps or args.fps, scale=args.scale,
        canvas_wh=canvas_wh, max_frames=args.max_frames,
    )
    framerate_in = float(args.pre_fps or args.fps or stream.src_fps or 24)
    fps_out = float(args.fps) if (args.pre_fps and args.fps) else None
    writer = fio.VideoStreamWriter(Path(args.output_video).resolve(), framerate_in, fps_out)
    est = stream.estimated_frames
    if args.mask_dir and not args.mask:  # no frame files here: check by index
        md = Path(args.mask_dir)
        if est and not any((md / f"mask_{i:04d}.png").exists() for i in range(1, est + 1)):
            print(f"[mask][WARN] no mask_NNNN.png files in {md} match frames 1..{est}; frames "
                  "without masks pass through fully styled.")

    t_start = time.perf_counter()
    streamed = 0
    pending: _HostCopy | None = None

    def flush(ent: _HostCopy):
        frames = ent.wait()
        for i in range(ent.n):
            writer.write(frames[i])
        fps_now = streamed / max(1e-9, time.perf_counter() - t_start)
        total = f"/{est}" if est else ""
        print(f"[stream][{streamed}{total}] {fps_now:.1f} frames/s cumulative")

    try:
        batch_imgs: list = []
        it = iter(stream)
        while True:
            frame = next(it, None)
            if frame is not None:
                batch_imgs.append(frame)
                if len(batch_imgs) < B:
                    continue
            if not batch_imgs:
                break
            names = [Path(f"frame_{streamed + i + 1:04d}.png") for i in range(len(batch_imgs))]
            out_dev = process_batch(batch_imgs, names, streamed)
            streamed += len(batch_imgs)
            if pending is not None:
                flush(pending)
            pending = _HostCopy(out_dev, len(batch_imgs))
            batch_imgs = []
            if frame is None:
                break
        if pending is not None:
            flush(pending)
    finally:
        stream.close()
        written = writer.close()
    return written, streamed, stream.src_fps


def style_frames(args, frames_dir: Path, image_mode: bool, save_map: dict[int, str],
                 device: torch.device):
    """The per-frame loop over the ``frame_*`` files (JAX ``style_frames``):
    per frame, optional ``--inference_res`` downscale, every slot's stylize
    locked back to the frame size, the slot blend (the ``--region_*``
    composite, ``--blend_models_lab``, or RGB weights; ``--region_optimize``
    styles only the regions' crops instead), flow EMA (DIS or Farneback at
    the auto/explicit flow downscale, exact warp), LAB EMA, the ``--mask`` /
    ``--mask_dir`` composite, then the motion blend (not on a masked frame)
    or the uniform one. A change of frame size resets the temporal caches;
    the first two frames of a video dump slot A's output and the input under
    ``<work_dir>/debug``. A slot that runs out of device memory retries at
    half size, then falls back to the original frame; any other error
    propagates. Returns (written, planned)."""
    from ..ops.color import rgb_to_gray
    from ..ops.resize import resize_bilinear
    from ..temporal.ema import flow_ema_fuse, lab_ema_step, motion_adaptive_blend, uniform_blend
    from . import stylizer as st

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    models = load_slot_bank(args, device)
    if not models:
        print("[error] no models loaded")
        sys.exit(2)
    num_models = len(models)
    print(f"[bank] {num_models} slot(s): "
          + ", ".join(f"{m.name}({m.arch}/{m.io_preset})" for m in models))
    stylize_fns = [st.jit_stylizer(m, dtype=dtype, quantize=args.quantize) for m in models]
    rs = _RegionSetup(args, num_models) if args.region_mode else None
    crop_optimized = bool(args.region_mode and args.region_optimize)
    frame_files = list_frame_files(args, frames_dir)
    preflight_mask_dir(args, frame_files)
    use_lab = args.smooth_lightness or args.smooth_chroma

    def stylize_slot(si, fn, x01):
        try:
            return fn(x01)[0]
        except torch.cuda.OutOfMemoryError as e:
            print(f"[slot][{chr(65 + si)}][ERROR] forward failed ({type(e).__name__}: {e}) "
                  "— retrying at half-size")
        try:
            h2, w2 = max(1, x01.shape[1] // 2), max(1, x01.shape[2] // 2)
            y_small = fn(resize_bilinear(x01, (h2, w2)))[0]
            print(f"[slot][{chr(65 + si)}] retry succeeded at half-size")
            return resize_bilinear(y_small, (x01.shape[1], x01.shape[2]))
        except torch.cuda.OutOfMemoryError as e2:
            print(f"[slot][{chr(65 + si)}][FALLBACK] second attempt failed "
                  f"({type(e2).__name__}: {e2}); using original frame")
            return x01[0]

    prev_gray = prev_styled01 = prev_lab = None
    prev_frame_size = None
    written = 0
    with torch.no_grad():
        for idx, frame_path in enumerate(frame_files, start=1):
            t0 = time.perf_counter()
            u8 = np.array(fio.load_image_exif_rgb(str(frame_path)), np.uint8)
            x_orig = torch.from_numpy(u8).to(device).float() / 255.0
            H0, W0 = x_orig.shape[0], x_orig.shape[1]

            x_src = x_orig
            if args.inference_res and max(H0, W0) > args.inference_res:
                s = args.inference_res / max(H0, W0)
                x_src = resize_bilinear(x_orig, (int(round(H0 * s)), int(round(W0 * s))))
            if prev_frame_size != (H0, W0):  # a new size resets the temporal caches
                prev_gray = prev_styled01 = prev_lab = None
                prev_frame_size = (H0, W0)

            # the crop path styles the regions' crops, not the frame
            outputs = [stylize_slot(si, fn, x_src[None])
                       for si, fn in enumerate(stylize_fns if not crop_optimized else [])]
            outputs = [o if o.shape[:2] == (H0, W0) else resize_bilinear(o, (H0, W0))
                       for o in outputs]
            if idx <= 2 and not image_mode and outputs:
                debug_dir = frames_dir.parent / "debug"
                debug_dir.mkdir(parents=True, exist_ok=True)
                a_u8 = (np.clip(outputs[0].cpu().numpy(), 0, 1) * 255).astype(np.uint8)
                _save(a_u8, debug_dir / f"A_out_{idx:04d}.jpg", True, 92)
                in_u8 = (np.clip(u8.astype(np.float32) / 255.0, 0, 1) * 255).astype(np.uint8)
                _save(in_u8, debug_dir / f"IN_{idx:04d}.jpg", True, 92)
                print(f"[debug] wrote {debug_dir}/A_out_{idx:04d}.jpg and IN_{idx:04d}.jpg")

            if crop_optimized:
                out01 = torch.from_numpy(_region_blend_optimized(
                    args, stylize_fns, u8.astype(np.float32) / 255.0, H0, W0, idx, num_models,
                    rs, device)).to(device)
            elif num_models == 1 and not args.region_mode:
                out01 = outputs[0]
            elif args.region_mode:
                out01 = _region_blend(args, outputs, x_orig, H0, W0, idx, num_models, rs)
            elif args.blend_models_lab:
                out01 = _lab_blend(args, torch.stack(outputs, 0), num_models)
            else:
                weights = parse_blend_weights(args.blend_models_weights, num_models)
                acc = outputs[0] * weights[0]
                for o, w in zip(outputs[1:], weights[1:]):
                    acc = acc + o * w
                out01 = acc.clamp(0.0, 1.0)

            gray = rgb_to_gray(x_orig * 255.0)
            last_flow = None
            if args.flow_ema and prev_gray is not None and prev_styled01 is not None:
                last_flow = flows_at_downscale(args, prev_gray[None], gray[None])[0]
                out01 = flow_ema_fuse(out01, prev_styled01, last_flow, args.flow_alpha)
            prev_gray, prev_styled01 = gray, out01

            if use_lab:
                out01, prev_lab = lab_ema_step(
                    out01, prev_lab, smooth_alpha=args.smooth_alpha,
                    chroma_alpha=args.chroma_alpha, smooth_lightness=args.smooth_lightness,
                    smooth_chroma=args.smooth_chroma)

            mask_file = _mask_file(args, frame_path)
            if mask_file:
                # --fit_mask_to output fits the mask to the styled frame's size
                ref_h, ref_w = (out01.shape[0], out01.shape[1]) if args.fit_mask_to == "output" \
                    else (H0, W0)
                alpha = load_mask_fit(mask_file, (ref_h, ref_w), args.mask_invert,
                                      _mask_feather(args, ref_h), autofix=args.mask_autofix,
                                      force_transpose=args.mask_force_transpose)
                a = torch.from_numpy(alpha).to(device)
                out01 = out01 * a + x_orig * (1.0 - a) if args.composite_mode == "keep" \
                    else x_orig * a + out01 * (1.0 - a)
                if args.mask_debug_alpha or args.mask_debug_overlay:
                    base_u8 = (x_orig.cpu().numpy() * 255).clip(0, 255).astype(np.uint8)
                    _mask_debug_dump(args, frames_dir, idx, alpha, base_u8)
            if args.motion_blend and last_flow is not None and not mask_file:
                out01 = motion_adaptive_blend(out01, x_orig, last_flow, args.blend)
            else:
                out01 = uniform_blend(out01, x_orig, args.blend)

            out_u8 = (np.clip(out01.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
            out_path, jpg = _out_path(args, frames_dir, frame_path, idx, image_mode, save_map)
            _save(out_u8, out_path, jpg, args.jpeg_quality)
            written += 1
            if idx == 1 or idx % 10 == 0:
                print(f"[frame][{idx}/{len(frame_files)}] dt={time.perf_counter() - t0:.3f}s "
                      f"-> {out_path.name}")
    return written, len(frame_files)


def style_frames_batched(args, frames_dir: Path, image_mode: bool, save_map: dict[int, str],
                         device: torch.device):
    """Device batches over the ``frame_*`` files (JAX ``style_frames_batched``):
    ``make_batched_core`` per batch, the files decoded ahead on the C++
    loader's threads (``io/native_loader.py``), and the previous batch's
    frames written while the device runs the next. The staged and extracted
    frames carry no EXIF, so the loader's decode is the engine's; where the
    loader cannot be built (no g++, libjpeg or libpng) the frames are read
    with PIL on this thread, as the printed line says. Returns (written,
    planned)."""
    from ..io.native_loader import LoaderUnavailable, NativeFrameLoader

    B, process_batch = make_batched_core(args, device, frames_dir=frames_dir)
    frame_files = list_frame_files(args, frames_dir)
    preflight_mask_dir(args, frame_files)
    loader = None
    try:
        loader = NativeFrameLoader(frame_files, threads=4, capacity=max(8, 2 * B))
        print(f"[batch] native frame loader active ({len(frame_files)} frames)")
    except LoaderUnavailable as e:
        print(f"[batch] native frame loader unavailable ({e}); using PIL")
    written = 0
    t_start = time.perf_counter()

    def flush(ent: _HostCopy, chunk: list, b0: int):
        nonlocal written
        frames = ent.wait()
        for i in range(ent.n):
            out_path, jpg = _out_path(args, frames_dir, chunk[i], b0 + i + 1, image_mode,
                                      save_map)
            _save(frames[i], out_path, jpg, args.jpeg_quality)
            written += 1
        done = min(b0 + B, len(frame_files))
        print(f"[batch][{done}/{len(frame_files)}] "
              f"{done / max(1e-9, time.perf_counter() - t_start):.1f} frames/s cumulative")

    pending = None
    try:
        for b0 in range(0, len(frame_files), B):
            chunk = frame_files[b0:b0 + B]
            if loader is not None:
                imgs = [next(loader) for _ in chunk]
            else:
                imgs = [np.asarray(fio.load_image_exif_rgb(str(p)), np.uint8) for p in chunk]
            out_dev = process_batch(imgs, chunk, b0)
            if pending is not None:
                flush(*pending)
            pending = (_HostCopy(out_dev, len(chunk)), chunk, b0)
        if pending is not None:
            flush(*pending)
    finally:
        if loader is not None:
            loader.close()
    return written, len(frame_files)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.pattern is None:
        args.pattern = f"*.{args.image_ext}"

    image_single = bool(args.input_image) and bool(args.output_image)
    image_batch = bool(args.input_dir) and bool(args.output_dir)
    image_mode = image_single or image_batch
    video_mode = bool(args.input_video) and bool(args.output_video)
    if image_mode and video_mode:
        print("Provide exactly one of: (input_video & output_video) OR (input_image & "
              "output_image) OR (input_dir & output_dir).")
        return 2
    if not (image_mode or video_mode):
        print("Specify (input_video & output_video) OR (input_image & output_image) OR "
              "(input_dir & output_dir).")
        return 2
    if args.model_type != "magenta" and not args.model:
        print("[error] --model is required unless --model_type magenta")
        return 2
    if args.model_type == "magenta" and not args.magenta_style:
        print("[magenta][ERROR] --magenta_style is required when --model_type magenta")
        return 2
    if image_mode:
        if args.motion_blend:
            print("[warn] --motion_blend ignored in image mode.")
            args.motion_blend = False
        if args.flow_ema:
            print("[warn] --flow_ema ignored in image mode.")
            args.flow_ema = False

    # per-job work dirs isolate image jobs; a video job works in --work_dir
    base_work_dir = Path(args.work_dir).resolve()
    work_dir = base_work_dir / f"job_{uuid.uuid4().hex[:8]}" if image_mode else base_work_dir
    if image_mode:
        print(f"[work_dir] Using isolated work directory: {work_dir}")
    frames_dir = work_dir / "frames"
    frames_dir.mkdir(parents=True, exist_ok=True)

    def purge(patterns):
        for pat in patterns:
            for p in frames_dir.glob(pat):
                p.unlink(missing_ok=True)

    styled = ["styled_frame_*.png", "styled_frame_*.jpg", "styled_frame_*.jpeg"]
    if video_mode or image_single:
        purge(["frame_*.png", "frame_*.jpg", "frame_*.jpeg"] + styled)
    else:
        if Path(args.input_dir).resolve() != frames_dir.resolve():
            purge(["frame_*.png", "frame_*.jpg", "frame_*.jpeg"])
        purge(styled)

    # the crop-based --region_optimize stays per-frame: it styles per-region
    # crop batches, not full frames
    use_batched = args.frame_batch > 1 and not (args.region_mode and args.region_optimize)
    if args.frame_batch > 1 and not use_batched:
        print("[note] --region_optimize styles per-region crop batches; the full-frame batched "
              "path does not apply.")
    use_stream = video_mode and use_batched and args.stream != "off"
    save_map: dict[int, str] = {}
    src_fps = None
    if video_mode and use_stream:
        if args.pre_fps and args.fps:
            print(f"[note] --pre_fps set; frames streamed at pre_fps={args.pre_fps}, "
                  f"encoded at fps={args.fps}.")
    elif video_mode:
        if args.pre_fps and args.fps:
            print(f"[note] --pre_fps set; frames extracted at pre_fps={args.pre_fps}, "
                  f"assembled at fps={args.fps}.")
        canvas_wh = None
        if args.canvas:
            cw, ch = args.canvas.lower().split("x")
            canvas_wh = (int(cw), int(ch))
        src_fps = fio.extract_frames(Path(args.input_video).resolve(), frames_dir,
                                     args.pre_fps or args.fps, args.scale, args.image_ext,
                                     args.jpeg_quality, canvas_wh, args.max_frames)
    elif image_single:
        _stage(Path(args.input_image).resolve(), frames_dir / "frame_0001", args)
        save_map[1] = str(Path(args.output_image).resolve())
    else:
        import glob
        import os

        in_files = sorted(glob.glob(os.path.join(args.input_dir, args.pattern)))
        if not in_files:
            print(f"No files matched: {args.input_dir}/{args.pattern}")
            return 2
        Path(args.output_dir).mkdir(parents=True, exist_ok=True)
        for i, f in enumerate(in_files, start=1):
            src = Path(f).resolve()
            _stage(src, frames_dir / f"frame_{i:04d}", args)
            ext = (src.suffix.lower() if args.keep_ext
                   else (".jpg" if args.image_ext == "jpg" else ".png"))
            m = re.match(r"^frame_(\d+)$", src.stem)
            stem = (f"{args.output_prefix}_{m.group(1)}" if m
                    else f"{src.stem}{args.output_suffix or ''}")
            save_map[i] = str((Path(args.output_dir) / f"{stem}{ext}").resolve())

    prof = _start_profile(args.profile_dir, device) if args.profile_dir else None
    try:
        if use_stream:
            written, planned, _ = style_video_stream(args, device, frames_dir)
        else:
            runner = style_frames_batched if use_batched else style_frames
            written, planned = runner(args, frames_dir, image_mode, save_map, device)
    finally:
        if prof is not None:
            prof.stop()
            print(f"[profile] trace written to {args.profile_dir}")
    print(f"[done] wrote {written}/{planned} styled frames")

    if video_mode and not use_stream:
        framerate_in = float(args.pre_fps or args.fps or src_fps or 24)
        fps_out = float(args.fps) if (args.pre_fps and args.fps) else None
        n = fio.assemble_video(frames_dir, Path(args.output_video).resolve(), framerate_in,
                               fps_out)
        print(f"[assemble] {n} frames -> {args.output_video}")
    elif video_mode:
        print(f"[stream] encoded {written} frames -> {args.output_video}")

    if args.clean_frames:
        purge(["frame_*.png", "frame_*.jpg", "frame_*.jpeg", "styled_frame_*.png",
               "styled_frame_*.jpg"])
        print(f"[clean] removed frame files under {frames_dir}")
    if args.clean_work_dir and image_mode:
        import shutil

        shutil.rmtree(work_dir, ignore_errors=True)
        print(f"[clean] removed {work_dir}")
    return 0


def _start_profile(profile_dir: str, device: torch.device):
    """A started ``torch.profiler`` (host activity, and the card's
    where ``device`` is CUDA) that writes its Chrome trace,
    ``<host>_<pid>.<ms>.pt.trace.json``, into ``profile_dir`` when it
    stops."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir))
    prof.start()
    return prof


def _stage(src: Path, dst_stem: Path, args) -> None:
    """Copy an input image into the work dir as ``dst_stem`` + its suffix,
    EXIF-rotated to RGB (JPEGs re-encoded at ``--jpeg_quality``, at most 95)."""
    pil = fio.load_image_exif_rgb(str(src))
    dst = dst_stem.with_suffix(src.suffix.lower())
    if src.suffix.lower() in (".jpg", ".jpeg"):
        pil.save(dst, format="JPEG", quality=max(1, min(95, args.jpeg_quality)))
    else:
        pil.save(dst)


if __name__ == "__main__":
    sys.exit(main())
