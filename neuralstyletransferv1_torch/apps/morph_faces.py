"""morph_faces — multi-face zoom-blend video pipeline.

Counterpart of ``neuralstyletransferv1_tpu/apps/morph_faces.py``: detect
faces with the res10 SSD (``models/caffe_ssd.detect_faces``; >3% coverage,
IoU overlap filter) or take ``--manual_faces``, style each face crop with a
ladder of magenta tile configs (``selfstyle_blob.self_style_variants``),
optionally pre-styled by transformer checkpoints through the port's
stylizer, then render per-face zoom-out morphs, the optional blob-mode
gaussian blend, and crossfades between faces, ending each face on the
original image; a ``<video>_run.json`` log records the run.

The detector, the pre-style and the magenta ladder run on ``--device``
(``cuda`` unless told ``cpu``; no GPU raises); the per-frame zoom/blend
compositing of the 720p uint8 frames stays host numpy/OpenCV, as in the
JAX app. Run it as ``python -m neuralstyletransferv1_torch.apps.morph_faces``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from datetime import datetime

import numpy as np

TILE_CONFIGS = [(128, 16), (192, 24), (256, 32), (384, 48), (512, 64)]


def _smootherstep(t):
    """(reference: scripts/morph_v2.py:276-280)"""
    t = max(0.0, min(1.0, t))
    return t * t * t * (t * (t * 6 - 15) + 10)


# ---------------------------------------------------------------------------
# Face filtering (reference: morph_faces.py:290-350)
# ---------------------------------------------------------------------------


def _iou(box1, box2):
    x1, y1, w1, h1 = box1
    x2, y2, w2, h2 = box2
    ix1, iy1 = max(x1, x2), max(y1, y2)
    ix2, iy2 = min(x1 + w1, x2 + w2), min(y1 + h1, y2 + h2)
    if ix2 <= ix1 or iy2 <= iy1:
        return 0.0
    inter = (ix2 - ix1) * (iy2 - iy1)
    union = w1 * h1 + w2 * h2 - inter
    return inter / union if union > 0 else 0.0


def filter_overlapping_faces(faces, iou_threshold=0.3):
    """NMS over face dicts, higher confidence wins (reference:
    morph_faces.py:290-350)."""
    if len(faces) <= 1:
        return faces
    faces = sorted(faces, key=lambda f: f.get("confidence", 0), reverse=True)
    kept = []
    for face in faces:
        if all(_iou(face["bbox"], k["bbox"]) <= iou_threshold for k in kept):
            kept.append(face)
    for i, face in enumerate(kept):
        face["id"] = i + 1
    return kept


# ---------------------------------------------------------------------------
# Zoom / blend compositing (reference: morph_faces.py:353-790)
# ---------------------------------------------------------------------------


def calculate_safe_zoom(center, min_zoom=1.0):
    """(reference: morph_faces.py:353-362)"""
    if center is None:
        return min_zoom
    cx, cy = center
    min_dist = min(cx, 1 - cx, cy, 1 - cy)
    if min_dist <= 0:
        return 10.0
    return max(min_zoom, 0.5 / min_dist)


def apply_zoom_crop(img, zoom, center, target_size):
    """(reference: morph_faces.py:364-391)"""
    import cv2

    h, w = img.shape[:2]
    tw, th = target_size
    crop_w, crop_h = int(w / zoom), int(h / zoom)
    cx = int(center[0] * w) if center is not None else w // 2
    cy = int(center[1] * h) if center is not None else h // 2
    x1 = max(0, min(cx - crop_w // 2, w - crop_w))
    y1 = max(0, min(cy - crop_h // 2, h - crop_h))
    x1, y1 = max(0, x1), max(0, y1)
    x2, y2 = min(w, x1 + crop_w), min(h, y1 + crop_h)
    return cv2.resize(img[y1:y2, x1:x2], (tw, th), interpolation=cv2.INTER_LINEAR)


def create_soft_multi_blob_masks(H, W, frame_idx, num_blobs=4, frequency=2.5,
                                 speed=1.0, seed=42, feather=0.3):
    """Soft multi-blob softmax masks, draw-order identical to the reference
    (morph_faces.py:84-121)."""
    time_offset = frame_idx * speed * 0.02
    y_norm = np.linspace(0, 1, H, dtype=np.float32)[:, None]
    x_norm = np.linspace(0, 1, W, dtype=np.float32)[None, :]
    blob_values = np.zeros((num_blobs, H, W), dtype=np.float32)
    for blob_idx in range(num_blobs):
        np.random.seed(seed + blob_idx * 1000)
        noise = np.zeros((H, W), dtype=np.float32)
        blob_phase = blob_idx * 2 * np.pi / num_blobs
        for octave in range(4):
            freq = frequency * (2 ** octave)
            amp = 1.0 / (1.5 ** octave)
            phase_x = np.random.random() * 2 * np.pi
            phase_y = np.random.random() * 2 * np.pi
            phase_t = np.random.random() * 2 * np.pi
            noise += amp * np.sin(y_norm * freq * np.pi + phase_y + time_offset * (1 + octave * 0.3) + blob_phase)
            noise += amp * np.sin(x_norm * freq * np.pi + phase_x + time_offset * (1.2 + octave * 0.2) + blob_phase)
            noise += amp * 0.5 * np.sin((x_norm + y_norm) * freq * np.pi + phase_t + time_offset * 1.5 + blob_phase)
        blob_values[blob_idx] = noise
    temperature = max(0.1, feather * 5)
    blob_values = blob_values - blob_values.max(axis=0, keepdims=True)
    exp_values = np.exp(blob_values / temperature)
    return (exp_values / (exp_values.sum(axis=0, keepdims=True) + 1e-6)).astype(np.float32)


def get_blended_image(images, position):
    """(reference: morph_faces.py:123-138)"""
    import cv2

    pos = position % len(images)
    idx1 = int(pos)
    idx2 = (idx1 + 1) % len(images)
    blend = pos - idx1
    img1, img2 = images[idx1], images[idx2]
    if img1.shape != img2.shape:
        img2 = cv2.resize(img2, (img1.shape[1], img1.shape[0]))
    return cv2.addWeighted(img1, 1 - blend, img2, blend, 0)


def _blend_pair(images, pos):
    import cv2

    idx1 = int(pos)
    idx2 = min(idx1 + 1, len(images) - 1)
    alpha = pos - idx1
    img1, img2 = images[idx1], images[idx2]
    if img1.shape[:2] != img2.shape[:2]:
        img2 = cv2.resize(img2, (img1.shape[1], img1.shape[0]), interpolation=cv2.INTER_LINEAR)
    return cv2.addWeighted(img1, 1 - alpha, img2, alpha, 0)


def create_face_zoom_out(images, orig_img, target_size, min_zoom, max_zoom,
                         fps, duration, zoom_center):
    """Zoom out max→min morphing smallest→largest tile, last 20% blends to
    the original (reference: morph_faces.py:394-488)."""
    import cv2

    if not images:
        return []
    num_images = len(images)
    safe_min_zoom = calculate_safe_zoom(zoom_center, min_zoom)
    frames = []
    num_frames = int(duration * fps)
    morph_end = 0.8
    for frame_idx in range(num_frames):
        t = frame_idx / max(1, num_frames - 1)
        t_eased = _smootherstep(t)
        zoom = max_zoom - t_eased * (max_zoom - safe_min_zoom)
        if t < morph_end:
            morph_t_eased = _smootherstep(t / morph_end)
            styled = _blend_pair(images, (1 - morph_t_eased) * (num_images - 1))
            frame = apply_zoom_crop(styled, zoom, zoom_center, target_size)
        else:
            blend_t_eased = _smootherstep((t - morph_end) / (1.0 - morph_end))
            styled_frame = apply_zoom_crop(images[0], zoom, zoom_center, target_size)
            orig_frame = apply_zoom_crop(orig_img, zoom, zoom_center, target_size)
            frame = cv2.addWeighted(styled_frame, 1 - blend_t_eased, orig_frame, blend_t_eased, 0)
        frames.append(frame)
    return frames


def create_blob_face_morph(images, orig_img, target_size, min_zoom, max_zoom,
                           fps, morph_time, zoom_center, num_blobs=4,
                           blob_frequency=2.5, blob_speed=1.0, blob_feather=0.3,
                           blend_to_original=True):
    """Blob-mode gaussian-blend morph (reference: morph_faces.py:141-287)."""
    import cv2

    if not images:
        return []
    num_images = len(images)
    safe_min_zoom = calculate_safe_zoom(zoom_center, min_zoom)
    morph_duration = num_images * morph_time
    total_duration = morph_duration / 0.8 if blend_to_original else morph_duration
    num_frames = int(total_duration * fps)
    morph_end_t = 0.8 if blend_to_original else 1.0
    H, W = images[0].shape[:2]
    frames = []
    for frame_idx in range(num_frames):
        t = frame_idx / max(1, num_frames - 1)
        t_eased = _smootherstep(t)
        zoom = max_zoom - t_eased * (max_zoom - safe_min_zoom)
        blob_masks = create_soft_multi_blob_masks(
            H, W, frame_idx, num_blobs=num_blobs, frequency=blob_frequency,
            speed=blob_speed, feather=blob_feather,
        )
        blended = np.zeros((H, W, 3), dtype=np.float32)
        morph_t = min(t, morph_end_t) / morph_end_t
        for blob_idx in range(num_blobs):
            phase_offset = blob_idx / num_blobs
            if t < morph_end_t:
                pos = morph_t * (num_images - 1) + phase_offset * num_images
            else:
                pos = (num_images - 1) + phase_offset * num_images
            img = get_blended_image(images, pos)
            if img.shape[:2] != (H, W):
                img = cv2.resize(img, (W, H))
            blended += img.astype(np.float32) * blob_masks[blob_idx][:, :, None]
        styled = apply_zoom_crop(blended.astype(np.uint8), zoom, zoom_center, target_size)
        if t < morph_end_t:
            frame = styled
        else:
            blend_t_eased = _smootherstep((t - morph_end_t) / (1.0 - morph_end_t))
            orig_frame = apply_zoom_crop(orig_img, zoom, zoom_center, target_size)
            frame = cv2.addWeighted(styled, 1 - blend_t_eased, orig_frame, blend_t_eased, 0)
        frames.append(frame)
    return frames


def create_face_crossfade(orig_img, images_to, target_size, min_zoom, max_zoom,
                          fps, duration, center_from, center_to):
    """Original (zoomed out) → next face's smallest tile zooming in
    (reference: morph_faces.py:491-560)."""
    import cv2

    if orig_img is None or not images_to:
        return []
    styled_to = images_to[-1]  # smallest tile — where the next zoom-out starts
    safe_min_from = calculate_safe_zoom(center_from, min_zoom)
    safe_min_to = calculate_safe_zoom(center_to, min_zoom)
    frames = []
    num_frames = int(duration * fps)
    for frame_idx in range(num_frames):
        t_eased = _smootherstep(frame_idx / max(1, num_frames - 1))
        frame_from = apply_zoom_crop(orig_img, safe_min_from, center_from, target_size)
        zoom_to = safe_min_to + t_eased * (max_zoom - safe_min_to)
        frame_to = apply_zoom_crop(styled_to, zoom_to, center_to, target_size)
        frames.append(cv2.addWeighted(frame_from, 1 - t_eased, frame_to, t_eased, 0))
    return frames


# ---------------------------------------------------------------------------
# Styling stages (in-process; reference shells out per config :900-1000)
# ---------------------------------------------------------------------------


def extract_face_crop(img_bgr, bbox, padding_pct=0.6):
    """Expand bbox by padding_pct and crop (reference: morph_v2.py
    extract_face_region semantics used at morph_faces.py:905-908)."""
    x, y, w, h = bbox
    H, W = img_bgr.shape[:2]
    px, py = int(w * padding_pct), int(h * padding_pct)
    x1, y1 = max(0, x - px), max(0, y - py)
    x2, y2 = min(W, x + w + px), min(H, y + h + py)
    return img_bgr[y1:y2, x1:x2]


def style_face_set(crop_bgr, tiles, models, scale, blend, seed=0, device="cpu"):
    """Build the face's styled ladder: per style source (none + each
    transformer checkpoint), magenta self-style at every tile config, on
    ``device``. Returns a list of BGR uint8, ordered largest tile first (so
    that the most zoomed-in frames show the most detailed tile)."""
    from .selfstyle_blob import self_style_variants

    crop01 = crop_bgr[..., ::-1].astype(np.float32) / 255.0
    sources = [crop01]
    for ckpt in models or []:
        sources.append(_pytorch_style(crop01, ckpt, scale, 0.95, device=device))
    styled = []
    for src01 in sources:
        usable = [(t, o) for t, o in tiles if t <= min(src01.shape[:2])]
        if not usable:
            usable = tiles[:1]
        variants = self_style_variants(src01, usable, seed=seed, device=device).cpu().numpy()
        for v in variants:
            out01 = blend * v + (1.0 - blend) * src01
            styled.append((np.clip(out01, 0, 1)[..., ::-1] * 255).astype(np.uint8))
    return list(reversed(styled))


def _pytorch_style(img01_rgb, ckpt_path, scale, blend, device="cpu"):
    """Transformer pre-style of an HWC [0, 1] crop through the port's
    stylizer on ``device`` (the long side capped at ``scale``, the output
    resized back), blended with the crop by ``blend``."""
    import torch

    from ..engine import stylizer as st
    from ..ops.resize import resize_bilinear

    model = st.load_model(pathlib.Path(ckpt_path), device=device)
    fn = st.jit_stylizer(model)
    h, w = img01_rgb.shape[:2]
    x = torch.from_numpy(np.ascontiguousarray(img01_rgb, np.float32)).to(device)[None]
    with torch.no_grad():
        if max(h, w) > scale:
            s = scale / max(h, w)
            x = resize_bilinear(x, (int(h * s), int(w * s)))
        y = fn(x)[0]
        if y.shape[:2] != (h, w):
            y = resize_bilinear(y, (h, w))
    return np.clip(blend * y.float().cpu().numpy() + (1 - blend) * img01_rgb, 0, 1)


# ---------------------------------------------------------------------------
# Per-image pipeline (reference: morph_faces.py:791-1152)
# ---------------------------------------------------------------------------


def save_run_log(output_video, args_dict, faces_info, duration_sec):
    """(reference: morph_faces.py:39-82)"""
    log_path = output_video.parent / f"{output_video.stem}_run.json"
    log_path.write_text(json.dumps({
        "timestamp": datetime.now().isoformat(),
        "script": "morph_faces.py",
        "input_image": str(args_dict.get("image_path", "")),
        "output_video": str(output_video),
        "duration_seconds": round(duration_sec, 2),
        "parameters": args_dict,
        "faces_detected": len(faces_info),
        "faces": faces_info,
    }, indent=2, default=str))
    print(f"  [log] Saved run parameters to {log_path.name}")
    return log_path


def process_image(image_path, output_dir, *, detector_prototxt, detector_model,
                  manual_faces=None, min_coverage=3.0, confidence_threshold=0.5,
                  iou_threshold=0.3, scale=1440, blend=0.95, fps=24,
                  zoom_in_duration=2.0, zoom_out_duration=2.0,
                  transition_duration=1.0, morph_time=0.0, min_zoom=1.0,
                  max_zoom=4.0, vertical=True, face_padding=0.6,
                  models=None, tiles=None, blob_mode=False, num_blobs=4,
                  blob_frequency=2.5, blob_speed=1.0, blob_feather=0.3,
                  seed=0, device="cpu"):
    import cv2

    from ..io.frames import write_mp4

    image_path = pathlib.Path(image_path)
    name = image_path.stem
    base_output = pathlib.Path(output_dir) / name
    base_output.mkdir(parents=True, exist_ok=True)
    target_size = (720, 1280) if vertical else (1280, 720)
    tiles = tiles or TILE_CONFIGS

    print(f"\n[1/3] Detecting faces (min coverage: {min_coverage}%)...")
    if manual_faces:
        faces = manual_faces
    else:
        from ..models.caffe_ssd import detect_faces

        faces = detect_faces(image_path, detector_prototxt, detector_model,
                             confidence_threshold=confidence_threshold, device=device)
    valid_faces = [f for f in faces if f["coverage"] >= min_coverage]
    if not valid_faces:
        print(f"[skip] No faces with >= {min_coverage}% coverage found")
        return None
    valid_faces = filter_overlapping_faces(valid_faces, iou_threshold=iou_threshold)
    for f in valid_faces:
        x, y, w, h = f["bbox"]
        print(f"    Face #{f['id']}: {w}x{h} ({f['coverage']:.1f}% coverage)")

    orig_img = cv2.imread(str(image_path))
    orig_h, orig_w = orig_img.shape[:2]

    print(f"\n[2/3] Styling each face ({len(tiles)} tiles × {1 + len(models or [])} sources)...")
    face_sets, face_centers = {}, {}
    for face in valid_faces:
        fid = face["id"]
        cx, cy = face["center"]
        face_centers[fid] = (cx / orig_w, cy / orig_h)
        crop = extract_face_crop(orig_img, face["bbox"], padding_pct=face_padding)
        face_sets[fid] = style_face_set(crop, tiles, models, scale, blend, seed=seed,
                                        device=device)

    print("\n[3/3] Rendering video...")
    all_frames = []
    face_ids = sorted(face_sets.keys())
    for i, fid in enumerate(face_ids):
        images = face_sets[fid]
        center = face_centers[fid]
        if blob_mode:
            mt = morph_time if morph_time > 0 else 0.5
            all_frames.extend(create_blob_face_morph(
                images, orig_img, target_size, min_zoom, max_zoom, fps, mt,
                center, num_blobs=num_blobs, blob_frequency=blob_frequency,
                blob_speed=blob_speed, blob_feather=blob_feather,
            ))
        else:
            if morph_time > 0:
                duration = (len(images) * morph_time) / 0.8
            else:
                duration = zoom_in_duration + zoom_out_duration
            all_frames.extend(create_face_zoom_out(
                images, orig_img, target_size, min_zoom, max_zoom, fps,
                duration, center,
            ))
        if i < len(face_ids) - 1 and transition_duration > 0:
            nxt = face_ids[i + 1]
            all_frames.extend(create_face_crossfade(
                orig_img, face_sets[nxt], target_size, min_zoom, max_zoom,
                fps, transition_duration, center, face_centers[nxt],
            ))

    if not all_frames:
        print("[error] No frames generated")
        return None

    suffix = "faces_blob" if blob_mode else "faces_zoom"
    output_video = base_output / f"{name}_{suffix}.mp4"
    write_mp4(output_video, all_frames, fps, rgb=False)

    duration = len(all_frames) / fps
    print(f"COMPLETE: {output_video} ({len(all_frames)} frames, {duration:.1f}s)")
    faces_info = [
        {"id": f["id"], "bbox": f["bbox"], "coverage": round(f["coverage"], 2),
         "confidence": round(f.get("confidence", 0), 3), "center": list(f["center"])}
        for f in valid_faces
    ]
    save_run_log(output_video, {
        "image_path": image_path, "min_coverage": min_coverage,
        "confidence_threshold": confidence_threshold, "iou_threshold": iou_threshold,
        "scale": scale, "blend": blend, "fps": fps, "morph_time": morph_time,
        "min_zoom": min_zoom, "max_zoom": max_zoom, "vertical": vertical,
        "face_padding": face_padding, "blob_mode": blob_mode,
        "num_blobs": num_blobs, "blob_frequency": blob_frequency,
        "blob_speed": blob_speed, "blob_feather": blob_feather,
        "selected_models": models, "selected_tiles": tiles,
    }, faces_info, duration)
    return output_video


def _parse_manual_faces(spec, img_wh):
    """'x,y,w,h;x,y,w,h' → face dicts (lets the pipeline run where the
    detector caffemodel is unavailable)."""
    W, H = img_wh
    faces = []
    for i, part in enumerate(s for s in spec.split(";") if s.strip()):
        x, y, w, h = (int(v) for v in part.split(","))
        faces.append({
            "id": i + 1, "bbox": (x, y, w, h),
            "center": (x + w / 2, y + h / 2), "area": w * h,
            "coverage": w * h / (W * H) * 100, "confidence": 1.0,
            "aspect_ratio": w / h if h else 1.0,
        })
    return faces


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Multi-face zoom-blend videos")
    ap.add_argument("--input_dir", default=None)
    ap.add_argument("--image", default=None, help="Process a single image")
    ap.add_argument("--output_dir", default="output/morph_faces")
    ap.add_argument("--detector_prototxt", default="models/face_detector/deploy.prototxt")
    ap.add_argument("--detector_model",
                    default="models/face_detector/res10_300x300_ssd_iter_140000.caffemodel")
    ap.add_argument("--manual_faces", default=None,
                    help="'x,y,w,h;…' detections (skips the SSD)")
    ap.add_argument("--min_coverage", type=float, default=3.0)
    ap.add_argument("--confidence", type=float, default=0.5)
    ap.add_argument("--iou_threshold", type=float, default=0.3)
    ap.add_argument("--scale", type=int, default=1440)
    ap.add_argument("--blend", type=float, default=0.95)
    ap.add_argument("--fps", type=int, default=24)
    ap.add_argument("--zoom_in", type=float, default=2.0)
    ap.add_argument("--zoom_out", type=float, default=2.0)
    ap.add_argument("--transition", type=float, default=2.0)
    ap.add_argument("--morph_time", type=float, default=0.0)
    ap.add_argument("--min_zoom", type=float, default=1.0)
    ap.add_argument("--max_zoom", type=float, default=4.0)
    ap.add_argument("--blob", action="store_true")
    ap.add_argument("--num_blobs", type=int, default=4)
    ap.add_argument("--blob_frequency", type=float, default=2.5)
    ap.add_argument("--blob_speed", type=float, default=1.0)
    ap.add_argument("--blob_feather", type=float, default=0.3)
    ap.add_argument("--vertical", action="store_true", default=True)
    ap.add_argument("--horizontal", action="store_false", dest="vertical")
    ap.add_argument("--face_padding", type=float, default=0.6)
    ap.add_argument("--models", type=str, default=None,
                    help="Comma-separated transformer checkpoints for pre-styling")
    ap.add_argument("--tiles", type=str, default=None,
                    help="Comma-separated tile sizes, e.g. '128,256,512'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    device = resolve_device(args.device)
    if not args.image and not args.input_dir:
        print("Provide --image or --input_dir")
        return 2
    if args.image:
        images = [pathlib.Path(args.image)]
    else:
        d = pathlib.Path(args.input_dir)
        images = sorted(p for p in d.iterdir()
                        if p.suffix.lower() in (".jpg", ".jpeg", ".png"))
    tiles = None
    if args.tiles:
        by_size = dict((t, (t, o)) for t, o in TILE_CONFIGS)
        tiles = [by_size.get(int(t), (int(t), int(t) // 8))
                 for t in args.tiles.split(",")]
    models = args.models.split(",") if args.models else None

    done = 0
    for img in images:
        manual = None
        if args.manual_faces:
            import cv2

            im = cv2.imread(str(img))
            manual = _parse_manual_faces(args.manual_faces,
                                         (im.shape[1], im.shape[0]))
        out = process_image(
            img, args.output_dir,
            detector_prototxt=args.detector_prototxt,
            detector_model=args.detector_model, manual_faces=manual,
            min_coverage=args.min_coverage,
            confidence_threshold=args.confidence,
            iou_threshold=args.iou_threshold, scale=args.scale,
            blend=args.blend, fps=args.fps, zoom_in_duration=args.zoom_in,
            zoom_out_duration=args.zoom_out,
            transition_duration=args.transition, morph_time=args.morph_time,
            min_zoom=args.min_zoom, max_zoom=args.max_zoom,
            vertical=args.vertical, face_padding=args.face_padding,
            models=models, tiles=tiles, blob_mode=args.blob,
            num_blobs=args.num_blobs, blob_frequency=args.blob_frequency,
            blob_speed=args.blob_speed, blob_feather=args.blob_feather,
            seed=args.seed, device=device,
        )
        done += out is not None
    print(f"[morph_faces] {done}/{len(images)} videos rendered")
    return 0 if done or not images else 1


if __name__ == "__main__":
    sys.exit(main())
