"""morph_v2 — automatic self-style morph videos.

Counterpart of ``neuralstyletransferv1_tpu/apps/morph_v2.py``: segment the
image with DeepLab (the port's ``apps/sky_swap``), score every class region
(coverage sweet spot, squareness, centredness, semantic preference),
tight-crop the best region (or, with ``--face``, the largest SSD-detected
face), optionally pre-style it with a transformer checkpoint at blend
variants through ``engine/pipeline.main``, self-style it at a ladder of
magenta tile configs, then render an optical-flow morph video across the
variant sequence (``apps/morph``) with the Ken Burns / zoom pulse / hue
motion pass.

Segmentation, styling, self-style and the morph run on ``--device``
(``cuda`` unless told ``cpu``; no GPU raises); the motion pass is host
OpenCV, as in the JAX app. Run it as
``python -m neuralstyletransferv1_torch.apps.morph_v2``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile

import numpy as np

PREFERRED_LABELS = ["person", "cat", "dog", "bird", "horse", "cow", "sheep"]
GOOD_LABELS = ["car", "motorbike", "bicycle", "bus", "train", "aeroplane", "boat"]
TILE_CONFIGS = [(128, 16), (192, 24), (256, 32), (384, 48), (512, 64)]


def calculate_region_score(coverage_pct, bbox_w, bbox_h, center_x, center_y, img_w, img_h, label):
    """(reference: morph_v2.py:1109-1157)"""
    score = 0.0
    if coverage_pct < 2:
        score += coverage_pct * 5
    elif coverage_pct < 5:
        score += 10 + (coverage_pct - 2) * 10
    elif coverage_pct < 25:
        score += 40 + (coverage_pct - 5) * 2
    elif coverage_pct < 50:
        score += 80 - (coverage_pct - 25)
    else:
        score += 55 - (coverage_pct - 50) * 0.5
    if bbox_w > 0 and bbox_h > 0:
        score += (min(bbox_w, bbox_h) / max(bbox_w, bbox_h)) * 15
    dist = ((center_x - 0.5) ** 2 + (center_y - 0.5) ** 2) ** 0.5
    score += (1 - dist) * 10
    if label in PREFERRED_LABELS:
        score += 25
    elif label in GOOD_LABELS:
        score += 15
    else:
        score += 5
    return score


def analyze_regions(pred: np.ndarray, id_to_label: dict):
    """Score every present class id (reference: morph_v2.py:1002-1106)."""
    h, w = pred.shape
    regions = []
    for cid in np.unique(pred):
        label = id_to_label.get(int(cid), str(cid))
        if label == "background":
            continue
        mask = pred == cid
        coverage = 100.0 * mask.mean()
        ys, xs = np.nonzero(mask)
        if len(ys) == 0:
            continue
        y0, y1, x0, x1 = ys.min(), ys.max(), xs.min(), xs.max()
        bw, bh = int(x1 - x0 + 1), int(y1 - y0 + 1)
        cx, cy = (x0 + x1) / 2 / w, (y0 + y1) / 2 / h
        regions.append(
            {
                "id": int(cid),
                "label": label,
                "coverage_pct": float(coverage),
                "bbox": (int(x0), int(y0), bw, bh),
                "score": calculate_region_score(coverage, bw, bh, cx, cy, w, h, label),
            }
        )
    regions.sort(key=lambda r: -r["score"])
    return regions


def select_best_region(regions, min_coverage=1.0, max_coverage=60.0):
    """(reference: morph_v2.py:1158-1183)"""
    candidates = [r for r in regions if min_coverage <= r["coverage_pct"] <= max_coverage]
    if not candidates:
        candidates = regions
    return candidates[0] if candidates else None


def extract_crop(img: np.ndarray, mask: np.ndarray, padding=0):
    """Tight bbox crop of the mask, original pixels (reference:
    morph_v2.py:497-536)."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return None
    x, y = xs.min(), ys.min()
    w, h = xs.max() - x + 1, ys.max() - y + 1
    if padding > 0:
        x = max(0, x - padding)
        y = max(0, y - padding)
        w = min(img.shape[1] - x, w + 2 * padding)
        h = min(img.shape[0] - y, h + 2 * padding)
    return img[y : y + h, x : x + w]


def apply_hue_shift(frame_rgb, shift_degrees):
    """(reference: morph_v2.py:324-346 — OpenCV HSV hue is 0-180)"""
    import cv2

    if abs(shift_degrees) < 0.1:
        return frame_rgb
    hsv = cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2HSV).astype(np.float32)
    hsv[:, :, 0] = (hsv[:, :, 0] + shift_degrees / 2) % 180
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


def calculate_zoom_pulse(progress, pulse_amplitude=0.05, pulse_frequency=2.0):
    """Breathing zoom multiplier (reference: morph_v2.py:348-362)."""
    pulse = abs(np.sin(progress * pulse_frequency * 2 * np.pi))
    return 1.0 + pulse * pulse_amplitude


def apply_motion_effects(frames, *, pan_zoom=None, pan_direction="horizontal",
                         zoom_pulse=0.0, zoom_pulse_freq=2.0, hue_rotate=0.0,
                         zoom_in_pct=0.25):
    """Ken Burns pan-zoom + zoom pulse + hue rotation over a frame sequence
    (reference: morph_v2.py:624-860 motion vocabulary). Frames are RGB u8;
    output keeps their size."""
    from .morph import smootherstep
    from .morph_faces import apply_zoom_crop

    n = len(frames)
    if n == 0:
        return frames
    h, w = frames[0].shape[:2]
    out = []
    for i, f in enumerate(frames):
        p = i / max(1, n - 1)
        zoom = 1.0
        center = (0.5, 0.5)
        if pan_zoom and pan_zoom > 1.0:
            if p < zoom_in_pct:
                # phase 1: zoom in from full view to pan_zoom level
                zoom = 1.0 + (pan_zoom - 1.0) * smootherstep(p / zoom_in_pct)
                q = 0.0
            else:
                zoom = pan_zoom
                q = smootherstep((p - zoom_in_pct) / max(1e-6, 1.0 - zoom_in_pct))
            half = 1.0 / (2.0 * zoom)
            lo, hi = half, 1.0 - half
            path = {
                "horizontal": (lo + q * (hi - lo), 0.5),
                "vertical": (0.5, lo + q * (hi - lo)),
                "diagonal": (lo + q * (hi - lo), lo + q * (hi - lo)),
                "diagonal_reverse": (hi - q * (hi - lo), lo + q * (hi - lo)),
            }
            center = path.get(pan_direction, path["horizontal"])
        if zoom_pulse > 0:
            zoom *= calculate_zoom_pulse(p, zoom_pulse, zoom_pulse_freq)
        if zoom > 1.0001:
            f = apply_zoom_crop(f, zoom, center, (w, h))
        if hue_rotate:
            f = apply_hue_shift(f, hue_rotate * p)
        out.append(f)
    return out


def detect_face_crop(image_path, img, prototxt, caffemodel, padding_pct=0.6, device="cpu"):
    """The largest detected face's crop of RGB ``img``, or None."""
    import pathlib as _pl

    if not (_pl.Path(prototxt).exists() and _pl.Path(caffemodel).exists()):
        print("[morph_v2][warn] face detector files missing; skipping --face")
        return None
    from ..models.caffe_ssd import detect_faces
    from .morph_faces import extract_face_crop

    faces = detect_faces(image_path, prototxt, caffemodel, device=device)
    if not faces:
        return None
    crop_bgr = extract_face_crop(img[..., ::-1], faces[0]["bbox"], padding_pct)
    return crop_bgr[..., ::-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True)
    ap.add_argument("--output", required=True, help="output morph video path")
    ap.add_argument("--deeplab_weights", required=True)
    ap.add_argument("--auto", action="store_true", default=True,
                    help="auto-select the best semantic region (default)")
    ap.add_argument("--target_label", type=str, default=None,
                    help="use this label instead of auto-selection")
    ap.add_argument("--pytorch_model", type=str, default=None,
                    help="optional transformer checkpoint for pre-style blend variants")
    ap.add_argument("--pytorch_blends", type=str, default="0,50,100",
                    help="pre-style blend percentages")
    ap.add_argument("--io_preset", default="auto")
    ap.add_argument("--seg_res", type=int, default=512)
    ap.add_argument("--crop_size", type=int, default=512)
    ap.add_argument("--morph_frames", type=int, default=48)
    ap.add_argument("--fps", type=int, default=24)
    ap.add_argument("--easing", choices=["linear", "smooth", "smoother"], default="smooth")
    # motion vocabulary (reference: morph_v2.py:624-860)
    ap.add_argument("--pan_zoom", type=float, default=None,
                    help="Ken Burns zoom level (e.g. 2.0 shows 50%% and pans)")
    ap.add_argument("--pan_direction", choices=["horizontal", "vertical",
                    "diagonal", "diagonal_reverse"], default="horizontal")
    ap.add_argument("--zoom_pulse", type=float, default=0.0)
    ap.add_argument("--zoom_pulse_freq", type=float, default=2.0)
    ap.add_argument("--hue_rotate", type=float, default=0.0,
                    help="total hue rotation (degrees) over the video")
    ap.add_argument("--zoom_in_pct", type=float, default=0.25)
    ap.add_argument("--temporal_smooth", type=int, default=3)
    # face branch (reference: morph_v2.py:136-226)
    ap.add_argument("--face", action="store_true",
                    help="crop to the largest SSD-detected face instead of a "
                    "semantic region")
    ap.add_argument("--detector_prototxt", default="models/face_detector/deploy.prototxt")
    ap.add_argument("--detector_model",
                    default="models/face_detector/res10_300x300_ssd_iter_140000.caffemodel")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from PIL import Image

    from ..device import resolve_device
    from ..io.frames import write_mp4
    from .morph import optical_flow_morph, temporal_smooth_frames
    from .selfstyle_blob import self_style_variants
    from .sky_swap import VOC21_LABELS, SegmentationModel, load_deeplab

    device = resolve_device(args.device)
    img_pil = Image.open(args.image).convert("RGB")
    img = np.asarray(img_pil)

    # 1) region selection: SSD face crop (--face) or DeepLab semantic region
    crop = None
    if args.face:
        crop = detect_face_crop(args.image, img, args.detector_prototxt,
                                args.detector_model, device=device)
        if crop is not None:
            print(f"[morph_v2] face crop {crop.shape[1]}x{crop.shape[0]}")
    if crop is None:
        params, nc, bb = load_deeplab(args.deeplab_weights)
        model = SegmentationModel(params, nc, bb, device=device)
        work = img_pil
        w0, h0 = img_pil.size
        s = args.seg_res / max(w0, h0)
        if s < 1.0:
            work = img_pil.resize((int(w0 * s), int(h0 * s)), Image.LANCZOS)
        pred = model.predict(work)
        pred_full = np.array(Image.fromarray(pred).resize((w0, h0), Image.NEAREST))
        id_to_label = {v: k for k, v in VOC21_LABELS.items()}
        regions = analyze_regions(pred_full, id_to_label)
        if args.target_label:
            region = next((r for r in regions if r["label"] == args.target_label), None)
        else:
            region = select_best_region(regions)
        if region is None:
            print("[morph_v2][warn] no usable region; using full frame")
            crop = img
        else:
            print(f"[morph_v2] selected region '{region['label']}' "
                  f"coverage={region['coverage_pct']:.1f}% score={region['score']:.1f}")
            crop = extract_crop(img, pred_full == region["id"]) if region else img
            if crop is None or min(crop.shape[:2]) < 32:
                crop = img

    # resize crop to working size (even dims)
    ch, cw = crop.shape[:2]
    s = args.crop_size / max(ch, cw)
    if s < 1.0:
        crop = np.asarray(
            Image.fromarray(crop).resize((int(cw * s) // 2 * 2, int(ch * s) // 2 * 2), Image.LANCZOS)
        )

    variants = [crop.astype(np.float32) / 255.0]

    # 2) optional pre-style blend variants (reference: :566-621)
    if args.pytorch_model:
        from ..engine.pipeline import main as pipeline_main

        with tempfile.TemporaryDirectory(prefix="morphv2_") as td:
            td = pathlib.Path(td)
            src = td / "crop.png"
            Image.fromarray(crop).save(src)
            for pct in (int(p) for p in args.pytorch_blends.split(",")):
                if pct == 0:
                    continue
                outp = td / f"pre_{pct}.png"
                rc = pipeline_main([
                    "--input_image", str(src), "--output_image", str(outp),
                    "--model", args.pytorch_model, "--io_preset", args.io_preset,
                    "--blend", str(pct / 100.0), "--no-smooth_lightness",
                    "--work_dir", str(td / "_w"), "--device", args.device,
                ])
                if rc == 0 and outp.exists():
                    variants.append(np.asarray(Image.open(outp), np.float32) / 255.0)

    # 3) magenta self-style at the tile ladder (reference: :539-563)
    base01 = variants[-1]
    ss = self_style_variants(base01, TILE_CONFIGS, device=device).cpu().numpy()
    variants.extend(list(ss))
    print(f"[morph_v2] {len(variants)} variants total")

    # 4) optical-flow morph across the variant sequence (reference: :624-1000)
    stills = [(np.clip(v, 0, 1) * 255).astype(np.uint8) for v in variants]
    frames: list[np.ndarray] = []
    for a, b in zip(stills, stills[1:]):
        frames.extend(optical_flow_morph(a, b, args.morph_frames, args.easing, device=device))
    if args.temporal_smooth > 0:
        frames = temporal_smooth_frames(frames, kernel_size=args.temporal_smooth)
    # motion vocabulary pass (Ken Burns / pulse / hue)
    frames = apply_motion_effects(
        frames, pan_zoom=args.pan_zoom, pan_direction=args.pan_direction,
        zoom_pulse=args.zoom_pulse, zoom_pulse_freq=args.zoom_pulse_freq,
        hue_rotate=args.hue_rotate, zoom_in_pct=args.zoom_in_pct,
    )

    write_mp4(args.output, frames, args.fps)
    print(f"[morph_v2] wrote {args.output} ({len(frames)} frames)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
