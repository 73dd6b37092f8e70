"""generate_morph_samples — animated GIF previews of morph presets.

Counterpart of ``neuralstyletransferv1_tpu/apps/generate_morph_samples.py``
(reference: scripts/generate_morph_samples.py): for each morph preset,
render a short styled clip on a synthetic zoom video (:206-227), convert it
to a looping GIF (:249-293 — the reference shells to ffmpeg palettegen;
here PIL's adaptive-palette GIF writer replaces it), and write a JSON index
of the generated previews (:403-430). Styling runs the port's engine in
process on ``--device`` (``cuda`` unless told ``cpu``; no GPU raises).

    python -m neuralstyletransferv1_torch.apps.generate_morph_samples --db presets.db \
        --input_image in.jpg --limit 2
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from ..presets import load_presets
from .generate_preset_samples import safe_name
from .generate_video_samples import (
    create_synthetic_zoom_video,
    is_morph_preset,
    render_preview,
)

GIF_FRAMES = 36
GIF_SCALE = 360


def video_to_gif(video_path, gif_path, fps=10, max_width=GIF_SCALE):
    """mp4 → looping GIF via PIL adaptive palette (reference: :249-293)."""
    import cv2
    from PIL import Image

    cap = cv2.VideoCapture(str(video_path))
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        h, w = fr.shape[:2]
        if w > max_width:
            fr = cv2.resize(fr, (max_width, int(h * max_width / w)))
        frames.append(Image.fromarray(fr[..., ::-1]).convert(
            "P", palette=Image.ADAPTIVE, colors=128))
    cap.release()
    if not frames:
        return False
    frames[0].save(
        gif_path, save_all=True, append_images=frames[1:],
        duration=int(1000 / fps), loop=0, optimize=True,
    )
    return gif_path.exists()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Render morph preset GIF previews "
                                 "(reference: scripts/generate_morph_samples.py)")
    ap.add_argument("--db", default="presets.db")
    ap.add_argument("--input_image", required=True)
    ap.add_argument("--output_dir", default="output/morph_samples")
    ap.add_argument("--work_dir", default="_work/morph_samples")
    ap.add_argument("--scale", type=int, default=GIF_SCALE)
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--frames", type=int, default=GIF_FRAMES)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    resolve_device(args.device)
    presets = [p for p in load_presets(args.db) if is_morph_preset(p)]
    if args.limit:
        presets = presets[: args.limit]
    if not presets:
        print("[morph_samples] no morph presets in DB")
        return 1

    out_dir = pathlib.Path(args.output_dir)
    work_dir = pathlib.Path(args.work_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    work_dir.mkdir(parents=True, exist_ok=True)

    clip = work_dir / "input_clip.mp4"
    if not create_synthetic_zoom_video(args.input_image, clip, args.frames, args.fps):
        print("[morph_samples][error] could not synthesize input clip")
        return 2

    index = []
    ok = 0
    for preset in presets:
        gif = out_dir / f"{safe_name(preset['name'])}.gif"
        if gif.exists() and not args.force:
            print(f"  [skip] {preset['name']}")
            index.append({"id": preset["id"], "name": preset["name"], "gif": gif.name})
            ok += 1
            continue
        mp4 = render_preview(preset, clip, work_dir, scale=args.scale,
                             fps=args.fps, work_dir=work_dir, force=True,
                             device=args.device)
        if mp4 and video_to_gif(mp4, gif, fps=args.fps):
            print(f"  [OK] {preset['name']} -> {gif.name}")
            index.append({"id": preset["id"], "name": preset["name"], "gif": gif.name})
            ok += 1
    (out_dir / "morph_samples.json").write_text(json.dumps(index, indent=2))
    print(f"[morph_samples] {ok}/{len(presets)} GIFs -> {out_dir}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
