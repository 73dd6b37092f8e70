"""gen_pytorch_only_videos — transition videos between transformer styles.

Counterpart of ``neuralstyletransferv1_tpu/apps/gen_pytorch_only_videos.py``:
style one image with several transformer checkpoints through the port's
``engine/pipeline.main``, then render
- sequential transitions with animated wipe masks (spiral, blob, radial),
  the variants in brightness order;
- ``--dual_blob``: two morph sequences divided by an animated blob mask;
- ``--face_mode``: per-face zoom-out morphs and crossfades over
  SSD-detected (or ``--manual_faces``) faces, with ``morph_faces``' helpers.

The styling and the wipe transitions run on ``--device`` (``cuda`` unless
told ``cpu``; no GPU raises): a transition's frames are one batched blend
against its static mask field, ``chunk`` frames a pass; the dual-blob and
face compositing is host numpy/OpenCV, as in the JAX app. Run it as
``python -m neuralstyletransferv1_torch.apps.gen_pytorch_only_videos``.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys
import tempfile

import numpy as np
import torch


def _mask_fields(H, W, kind: str, seed: int, device="cpu"):
    """The static per-kind field in [0, 1] on ``device`` and its sharpness;
    the progress thresholds it per frame. The blob field's phases are numpy
    ``default_rng(seed)`` draws, as in the JAX app."""
    y = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    x = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    if kind == "spiral":
        cy, cx = H / 2, W / 2
        r = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2)
        theta = torch.atan2(y - cy, x - cx) + math.pi
        spiral = torch.remainder(theta + r / max(H, W) * 3.0 * 2 * math.pi, 2 * math.pi)
        return spiral / (2 * math.pi), 10.0
    if kind == "radial":
        cy, cx = H / 2, W / 2
        r = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2)
        return r / math.sqrt(cx**2 + cy**2), 8.0
    # blob: multi-octave sine noise blended with a linear wipe
    rng = np.random.default_rng(seed)
    yn = torch.linspace(0, 1, H, device=device)[:, None]
    xn = torch.linspace(0, 1, W, device=device)[None, :]
    noise = torch.zeros((H, W), dtype=torch.float32, device=device)
    for octave in range(3):
        freq = 3.0 * (2**octave)
        amp = 1.0 / (2**octave)
        phase_x = float(rng.random() * 2 * np.pi)
        phase_y = float(rng.random() * 2 * np.pi)
        noise = noise + amp * torch.sin(yn * freq * math.pi + phase_y)
        noise = noise + amp * torch.sin(xn * freq * math.pi + phase_x)
    noise = (noise - noise.min()) / (noise.max() - noise.min() + 1e-6)
    return xn * 0.6 + noise * 0.4, 8.0


def transition_frames(img_a, img_b, kind: str, num_frames: int, seed: int = 42, *,
                      device="cpu", chunk: int = 24):
    """Animated wipe from img_a to img_b (uint8 RGB in and out), the frames
    blended on ``device``, ``chunk`` a pass."""
    H, W = img_a.shape[:2]
    field, sharp = _mask_fields(H, W, kind, seed, device)
    a = torch.from_numpy(img_a.astype(np.float32)).to(device)
    b = torch.from_numpy(img_b.astype(np.float32)).to(device)
    ts = torch.linspace(0.0, 1.0, num_frames, device=device)[:, None, None]
    frames = []
    for c0 in range(0, num_frames, chunk):
        m = ((ts[c0:c0 + chunk] * 1.2 - 0.1 - field) * sharp + 0.5).clamp(0, 1)[..., None]
        out = (a * (1 - m) + b * m).clamp(0, 255).to(torch.uint8)
        frames.extend(out.cpu().numpy())
    return frames


def brightness_order(images):
    """Order variants by mean luma (reference: :724-752)."""
    lumas = [float(np.mean(im @ np.array([0.299, 0.587, 0.114]))) for im in images]
    return [im for _, im in sorted(zip(lumas, images), key=lambda p: p[0])]


def create_animated_blob_mask(H, W, frame_idx, frequency=3.0, speed=1.0, seed=42):
    """Morphing (non-wipe) blob mask, draw-order identical to the reference
    (gen_pytorch_only_videos.py:132-176)."""
    time_offset = frame_idx * speed * 0.03
    y_norm = np.linspace(0, 1, H, dtype=np.float32)[:, None]
    x_norm = np.linspace(0, 1, W, dtype=np.float32)[None, :]
    np.random.seed(seed)
    noise = np.zeros((H, W), dtype=np.float32)
    for octave in range(4):
        freq = frequency * (2 ** octave)
        amp = 1.0 / (1.5 ** octave)
        phase_x = np.random.random() * 2 * np.pi
        phase_y = np.random.random() * 2 * np.pi
        phase_t = np.random.random() * 2 * np.pi
        noise += amp * np.sin(y_norm * freq * np.pi + phase_y + time_offset * (1 + octave * 0.3))
        noise += amp * np.sin(x_norm * freq * np.pi + phase_x + time_offset * (1.2 + octave * 0.2))
        noise += amp * 0.5 * np.sin((x_norm + y_norm) * freq * np.pi + phase_t + time_offset * 1.5)
    noise = (noise - noise.min()) / (noise.max() - noise.min() + 1e-6)
    return (1 / (1 + np.exp(-8 * (noise - 0.5)))).astype(np.float32)


def create_dual_morph_blob(images, orig_img, *, target_size, min_zoom=1.0,
                           max_zoom=4.0, fps=24, duration=5.0, zoom_center=None,
                           blob_frequency=3.0, blob_speed=1.0):
    """Two independent morph groups divided by an animated blob mask.
    images/orig are BGR u8."""
    import cv2

    from .morph_faces import _blend_pair, _smootherstep, apply_zoom_crop, calculate_safe_zoom

    if len(images) < 2:
        return []
    group_a = images[0::2] or images[: len(images) // 2]
    group_b = images[1::2] or images[len(images) // 2 :]
    safe_min_zoom = calculate_safe_zoom(zoom_center, min_zoom)
    num_frames = int(duration * fps)
    morph_end = 0.8
    frames = []
    for frame_idx in range(num_frames):
        t = frame_idx / max(1, num_frames - 1)
        t_eased = _smootherstep(t)
        zoom = max_zoom - t_eased * (max_zoom - safe_min_zoom)
        W, H = target_size
        blob = create_animated_blob_mask(H, W, frame_idx, blob_frequency, blob_speed)[..., None]
        if t < morph_end:
            morph_t = t / morph_end
            styled_a = _blend_pair(group_a, morph_t * (len(group_a) - 1))
            styled_b = _blend_pair(group_b, (1.0 - morph_t) * (len(group_b) - 1))
            frame_a = apply_zoom_crop(styled_a, zoom, zoom_center, target_size)
            frame_b = apply_zoom_crop(styled_b, zoom, zoom_center, target_size)
        else:
            blend_t = _smootherstep((t - morph_end) / (1.0 - morph_end))
            orig_frame = apply_zoom_crop(orig_img, zoom, zoom_center, target_size)
            sa = apply_zoom_crop(group_a[-1], zoom, zoom_center, target_size)
            sb = apply_zoom_crop(group_b[-1], zoom, zoom_center, target_size)
            frame_a = cv2.addWeighted(sa, 1 - blend_t, orig_frame, blend_t, 0)
            frame_b = cv2.addWeighted(sb, 1 - blend_t, orig_frame, blend_t, 0)
        frames.append((frame_a.astype(np.float32) * (1 - blob)
                       + frame_b.astype(np.float32) * blob).astype(np.uint8))
    return frames


def _face_mode(args, device) -> int:
    """Per-face zoom-out morphs and crossfades over transformer-styled face
    sets, with morph_faces' helpers."""
    import cv2

    from ..io.frames import write_mp4
    from .morph_faces import (
        _parse_manual_faces,
        _pytorch_style,
        create_face_crossfade,
        create_face_zoom_out,
        extract_face_crop,
        filter_overlapping_faces,
    )

    orig = cv2.imread(str(args.image))
    if orig is None:
        print("[gpov][error] cannot read image")
        return 2
    H, W = orig.shape[:2]
    if args.manual_faces:
        faces = _parse_manual_faces(args.manual_faces, (W, H))
    else:
        from ..models.caffe_ssd import detect_faces

        faces = detect_faces(args.image, args.detector_prototxt, args.detector_model,
                             device=device)
    faces = [f for f in faces if f["coverage"] >= args.min_coverage]
    faces = filter_overlapping_faces(faces)
    if not faces:
        print("[gpov][skip] no faces found")
        return 1

    target_size = (args.size, int(args.size * 16 / 9) // 2 * 2)
    all_frames = []
    sets = {}
    centers = {}
    for f in faces:
        crop = extract_face_crop(orig, f["bbox"], padding_pct=0.6)
        crop01 = crop[..., ::-1].astype(np.float32) / 255.0
        styled = [crop]
        for m in args.models:
            y01 = _pytorch_style(crop01, m, args.size, 0.95, device=device)
            styled.append((np.clip(y01, 0, 1)[..., ::-1] * 255).astype(np.uint8))
        sets[f["id"]] = styled
        cx, cy = f["center"]
        centers[f["id"]] = (cx / W, cy / H)
    ids = sorted(sets)
    for i, fid in enumerate(ids):
        all_frames.extend(create_face_zoom_out(
            sets[fid], orig, target_size, 1.0, args.max_zoom, args.fps,
            args.duration, centers[fid],
        ))
        if i < len(ids) - 1:
            all_frames.extend(create_face_crossfade(
                orig, sets[ids[i + 1]], target_size, 1.0, args.max_zoom,
                args.fps, 1.0, centers[fid], centers[ids[i + 1]],
            ))
    write_mp4(args.output, all_frames, args.fps, rgb=False)
    print(f"[gpov] face mode: wrote {args.output} ({len(all_frames)} frames, "
          f"{len(ids)} faces)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True)
    ap.add_argument("--models", nargs="+", required=True, help="transformer checkpoints")
    ap.add_argument("--output", required=True)
    ap.add_argument("--io_preset", default="auto")
    ap.add_argument("--size", type=int, default=720)
    ap.add_argument("--fps", type=int, default=24)
    ap.add_argument("--transition_frames", type=int, default=36)
    ap.add_argument("--hold_frames", type=int, default=12)
    ap.add_argument("--masks", type=str, default="spiral,blob,radial",
                    help="cycle of transition kinds")
    ap.add_argument("--order", choices=["given", "brightness"], default="brightness")
    ap.add_argument("--dual_blob", action="store_true",
                    help="dual morph groups split by an animated blob mask")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="dual_blob/face clip duration (seconds)")
    ap.add_argument("--max_zoom", type=float, default=4.0)
    ap.add_argument("--face_mode", action="store_true",
                    help="render per-face zoom-out morphs (SSD or --manual_faces)")
    ap.add_argument("--manual_faces", default=None, help="'x,y,w,h;…'")
    ap.add_argument("--detector_prototxt", default="models/face_detector/deploy.prototxt")
    ap.add_argument("--detector_model",
                    default="models/face_detector/res10_300x300_ssd_iter_140000.caffemodel")
    ap.add_argument("--min_coverage", type=float, default=3.0)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    device = resolve_device(args.device)
    if args.face_mode:
        return _face_mode(args, device)

    from PIL import Image

    from ..engine.pipeline import main as pipeline_main
    from ..io.frames import write_mp4

    im = Image.open(args.image).convert("RGB")
    w0, h0 = im.size
    s = args.size / max(w0, h0)
    if s < 1.0:
        im = im.resize((int(w0 * s) // 2 * 2, int(h0 * s) // 2 * 2), Image.LANCZOS)

    variants = [np.asarray(im)]
    with tempfile.TemporaryDirectory(prefix="gpov_") as td:
        td = pathlib.Path(td)
        src = td / "src.png"
        im.save(src)
        for mi, mpath in enumerate(args.models):
            outp = td / f"v{mi}.png"
            rc = pipeline_main([
                "--input_image", str(src), "--output_image", str(outp),
                "--model", mpath, "--io_preset", args.io_preset,
                "--no-smooth_lightness", "--work_dir", str(td / "_w"),
                "--device", args.device,
            ])
            if rc == 0 and outp.exists():
                variants.append(np.asarray(Image.open(outp).convert("RGB")))
            else:
                print(f"[gpov][warn] {mpath} failed; skipping")

    if len(variants) < 2:
        print("[gpov][error] fewer than 2 variants")
        return 2
    if args.order == "brightness":
        variants = brightness_order(variants)

    if args.dual_blob:
        # dual-blob morph treatment; BGR for the OpenCV path
        bgr = [v[..., ::-1].copy() for v in variants[1:]] or [variants[0][..., ::-1].copy()]
        orig_bgr = variants[0][..., ::-1].copy()
        h, w = variants[0].shape[:2]
        frames_bgr = create_dual_morph_blob(
            bgr, orig_bgr, target_size=(w, h), max_zoom=args.max_zoom,
            fps=args.fps, duration=args.duration,
        )
        frames = [f[..., ::-1] for f in frames_bgr]
    else:
        kinds = args.masks.split(",")
        frames = []
        for i, (a, b) in enumerate(zip(variants, variants[1:])):
            frames.extend([a] * args.hold_frames)
            frames.extend(transition_frames(a, b, kinds[i % len(kinds)], args.transition_frames,
                                            seed=42 + i, device=device))
        frames.extend([variants[-1]] * args.hold_frames)

    write_mp4(args.output, frames, args.fps)
    print(f"[gpov] wrote {args.output} ({len(frames)} frames, {len(variants)} variants)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
