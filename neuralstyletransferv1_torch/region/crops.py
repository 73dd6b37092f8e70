"""Crop-optimized region styling (``--region_optimize``): style only the
pixels each region needs.

The port's copy of ``neuralstyletransferv1_tpu/region/crops.py``: tight
bboxes from mask support (threshold 0.01), the padding clamp, per-model crop
styling, and ``composite_from_crops`` with weight accumulation and the gap
fill. Crops are wrap-padded to a fixed bucket ladder, and crops sharing a
bucket go to the stylizer as one batch per model. Per-region scales
downscale the crop before styling and upscale after. The composite is host
numpy, one accumulation at most the frame's size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .blend import RegionConfig, compute_animated_weights

BUCKETS = (128, 192, 256, 384, 512, 768, 1024, 1536, 2048)


@dataclass
class RegionCrop:
    """One region's crop: its bbox, the padded bbox and its config."""

    region_idx: int
    bbox: tuple
    padded_bbox: tuple
    config: RegionConfig


def compute_mask_bbox(mask: np.ndarray, threshold: float = 0.01):
    """Tight bbox (x1,y1,x2,y2) of mask support."""
    H, W = mask.shape
    rows = np.any(mask > threshold, axis=1)
    cols = np.any(mask > threshold, axis=0)
    if not rows.any() or not cols.any():
        return (0, 0, W, H)
    y1, y2 = np.where(rows)[0][[0, -1]]
    x1, x2 = np.where(cols)[0][[0, -1]]
    return (int(x1), int(y1), int(x2) + 1, int(y2) + 1)


def pad_bbox(bbox, padding, max_w, max_h):
    """The bbox grown by ``padding``, clamped to the frame."""
    x1, y1, x2, y2 = bbox
    return (max(0, x1 - padding), max(0, y1 - padding),
            min(max_w, x2 + padding), min(max_h, y2 + padding))


def prepare_region_crops(masks: np.ndarray, configs, H, W, padding=64):
    """masks [R,H,W] → RegionCrop list."""
    crops = []
    for idx, config in enumerate(configs):
        bbox = compute_mask_bbox(masks[idx])
        crops.append(RegionCrop(idx, bbox, pad_bbox(bbox, padding, W, H), config))
    return crops


def models_needed_for_regions(crops):
    """The sorted slot indices the crops' configs use (not the original)."""
    needed = set()
    for c in crops:
        for m in c.config.model_indices:
            if m >= 0:
                needed.add(m)
    return sorted(needed)


def compute_crop_coverage(crops, H, W):
    """Fraction of frame pixels inside padded crops."""
    covered = np.zeros((H, W), bool)
    for c in crops:
        x1, y1, x2, y2 = c.padded_bbox
        covered[y1:y2, x1:x2] = True
    return float(covered.mean())


def bucket_hw(h: int, w: int):
    """Smallest bucket ≥ (h, w), per axis; beyond the ladder rounds up to
    multiples of 128 (few distinct shapes reach the stylizer)."""
    def one(v):
        for b in BUCKETS:
            if v <= b:
                return b
        return -(-v // 128) * 128

    return one(h), one(w)


def style_crop_batched(crops_px, stylize_fn):
    """Style a list of HWC float01 crops through one stylize fn: group by
    bucket, WRAP-pad to the bucket (periodic tiling keeps the instance-norm
    statistics of the padded image ≈ the crop's own — edge padding would
    bias them toward border colors), batch per bucket, slice back."""
    by_bucket: dict = {}
    for i, c in enumerate(crops_px):
        bh, bw = bucket_hw(c.shape[0], c.shape[1])
        by_bucket.setdefault((bh, bw), []).append(i)
    out = [None] * len(crops_px)
    for (bh, bw), idxs in by_bucket.items():
        batch = np.stack([
            np.pad(crops_px[i],
                   ((0, bh - crops_px[i].shape[0]), (0, bw - crops_px[i].shape[1]), (0, 0)),
                   mode="wrap")
            for i in idxs
        ], 0)
        styled = np.asarray(stylize_fn(batch))
        for bi, i in enumerate(idxs):
            h, w = crops_px[i].shape[:2]
            out[i] = styled[bi, :h, :w]
    return out


def composite_from_crops(styled_crops, crops, original, H, W, masks,
                         frame_idx=0, blend_animations=None):
    """Weighted composite + gap fill, all numpy;
    styled_crops: {model_idx: {region_idx: HWC float01}}."""
    import cv2

    canvas = np.zeros((H, W, 3), np.float32)
    weight_sum = np.zeros((H, W, 1), np.float32)

    for crop_info in crops:
        config = crop_info.config
        x1, y1, x2, y2 = crop_info.padded_bbox
        ch, cw = y2 - y1, x2 - x1
        if blend_animations and crop_info.region_idx < len(blend_animations):
            anim = blend_animations[crop_info.region_idx]
            weights = compute_animated_weights(config.model_weights, frame_idx, anim)
        else:
            weights = config.model_weights
        region_blend = np.zeros((ch, cw, 3), np.float32)
        for model_idx, weight in zip(config.model_indices, weights):
            if model_idx == -1:
                if original is None:
                    raise ValueError("Region uses original but no original provided")
                source = original[y1:y2, x1:x2]
            else:
                source = styled_crops[model_idx][crop_info.region_idx]
            if source.shape[:2] != (ch, cw):
                source = cv2.resize(source, (cw, ch), interpolation=cv2.INTER_LINEAR)
            region_blend += weight * source
        crop_mask = masks[crop_info.region_idx][y1:y2, x1:x2][..., None]
        canvas[y1:y2, x1:x2] += region_blend * crop_mask
        weight_sum[y1:y2, x1:x2] += crop_mask

    # Gap fill
    MIN_COVERAGE = 0.1
    gap = (weight_sum < MIN_COVERAGE).astype(np.float32)
    if gap.sum() > 0:
        if original is not None:
            canvas = canvas + original * gap
            weight_sum = weight_sum + gap
        else:
            for ks in (5, 11, 21):
                kernel = np.ones((ks, ks), np.uint8)
                canvas_d = cv2.dilate(canvas, kernel)
                weight_d = cv2.dilate(weight_sum[..., 0], kernel)[..., None]
                canvas = canvas * (1 - gap) + canvas_d * gap
                weight_sum = weight_sum * (1 - gap) + weight_d * gap
                gap = (weight_sum < MIN_COVERAGE).astype(np.float32)
                if gap.sum() == 0:
                    break

    return np.clip(canvas / np.clip(weight_sum, 1e-6, None), 0.0, 1.0)
