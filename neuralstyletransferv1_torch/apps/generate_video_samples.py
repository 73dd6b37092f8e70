"""generate_video_samples — short video previews for DB presets.

Counterpart of ``neuralstyletransferv1_tpu/apps/generate_video_samples.py``
(reference: scripts/generate_video_samples.py): region presets render on a
short real-video clip; morph presets render on a synthetic zoom video built
from a still (:206-227) so organic region morphs are visible without source
footage. One mp4 per preset, skip-existing. Clip synthesis uses OpenCV;
styling calls the port's engine in process on ``--device`` (``cuda``
unless told ``cpu``; no GPU raises).

    python -m neuralstyletransferv1_torch.apps.generate_video_samples --db presets.db \
        --input_image in.jpg --limit 2
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from ..presets import load_presets, preset_to_argv
from .generate_preset_samples import safe_name

SAMPLE_FRAMES = 48
PREVIEW_SCALE = 480


def is_region_preset(preset: dict) -> bool:
    """(reference: generate_video_samples.py:132-136)"""
    return bool(preset["params"].get("region_mode"))


def is_morph_preset(preset: dict) -> bool:
    return bool(preset["params"].get("region_morph"))


def create_synthetic_zoom_video(image_path, out_path, num_frames=SAMPLE_FRAMES,
                                fps=12, zoom_to=1.35):
    """Slow zoom into a still (reference: :206-227)."""
    import cv2

    img = cv2.imread(str(image_path))
    if img is None:
        return False
    h, w = img.shape[:2]
    vw = cv2.VideoWriter(str(out_path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for i in range(num_frames):
        z = 1.0 + (zoom_to - 1.0) * i / max(1, num_frames - 1)
        cw, ch = int(w / z), int(h / z)
        x0, y0 = (w - cw) // 2, (h - ch) // 2
        crop = img[y0 : y0 + ch, x0 : x0 + cw]
        vw.write(cv2.resize(crop, (w, h), interpolation=cv2.INTER_LINEAR))
    vw.release()
    return out_path.exists()


def extract_clip(video_path, out_path, max_frames=SAMPLE_FRAMES, start_pct=0.2):
    """Trim a short clip out of a real video (reference: :80-130)."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        return False
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) or 0
    fps = cap.get(cv2.CAP_PROP_FPS) or 12
    cap.set(cv2.CAP_PROP_POS_FRAMES, int(total * start_pct))
    vw = None
    n = 0
    while n < max_frames:
        ok, fr = cap.read()
        if not ok:
            break
        if vw is None:
            vw = cv2.VideoWriter(str(out_path), cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (fr.shape[1], fr.shape[0]))
        vw.write(fr)
        n += 1
    cap.release()
    if vw:
        vw.release()
    return n > 0


def render_preview(preset, input_clip, out_dir, *, scale, fps, work_dir, force,
                   device="cuda"):
    """(reference: :237-381)"""
    from ..engine.pipeline import main as pipeline_main

    out = out_dir / f"{safe_name(preset['name'])}.mp4"
    if out.exists() and not force:
        print(f"  [skip] {preset['name']}")
        return out
    argv = [
        "--input_video", str(input_clip), "--output_video", str(out),
        "--work_dir", str(work_dir / safe_name(preset["name"])),
        "--scale", str(scale), "--fps", str(fps), "--image_ext", "jpg", "--device", device,
    ] + preset_to_argv(preset["params"])
    try:
        rc = pipeline_main(argv)
    except SystemExit as e:
        rc = e.code or 0
    except Exception as e:
        print(f"  [ERROR] {preset['name']}: {type(e).__name__}: {e}")
        return None
    if rc == 0 and out.exists():
        print(f"  [OK] {preset['name']} -> {out.name}")
        return out
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Render preset video previews "
                                 "(reference: scripts/generate_video_samples.py)")
    ap.add_argument("--db", default="presets.db")
    ap.add_argument("--input_video", default=None)
    ap.add_argument("--input_image", default=None,
                    help="Still used to synthesize the morph-preview zoom clip")
    ap.add_argument("--output_dir", default="output/video_samples")
    ap.add_argument("--work_dir", default="_work/video_samples")
    ap.add_argument("--scale", type=int, default=PREVIEW_SCALE)
    ap.add_argument("--fps", type=int, default=12)
    ap.add_argument("--frames", type=int, default=SAMPLE_FRAMES)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--regions_only", action="store_true")
    ap.add_argument("--morphs_only", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    resolve_device(args.device)
    presets = [p for p in load_presets(args.db) if is_region_preset(p)]
    if args.morphs_only:
        presets = [p for p in presets if is_morph_preset(p)]
    elif args.regions_only:
        presets = [p for p in presets if not is_morph_preset(p)]
    if args.limit:
        presets = presets[: args.limit]
    if not presets:
        print("[video_samples] no matching presets")
        return 1

    out_dir = pathlib.Path(args.output_dir)
    work_dir = pathlib.Path(args.work_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    work_dir.mkdir(parents=True, exist_ok=True)

    clip = work_dir / "input_clip.mp4"
    if args.input_video:
        if not extract_clip(args.input_video, clip, args.frames):
            print("[video_samples][error] could not extract clip")
            return 2
    elif args.input_image:
        if not create_synthetic_zoom_video(args.input_image, clip, args.frames, args.fps):
            print("[video_samples][error] could not synthesize clip")
            return 2
    else:
        print("[video_samples][error] provide --input_video or --input_image")
        return 2

    ok = 0
    for preset in presets:
        ok += render_preview(preset, clip, out_dir, scale=args.scale,
                             fps=args.fps, work_dir=work_dir,
                             force=args.force, device=args.device) is not None
    print(f"[video_samples] rendered {ok}/{len(presets)} -> {out_dir}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
