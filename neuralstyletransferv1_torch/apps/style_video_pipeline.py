"""style_video_pipeline — extract → ladder-style frame ranges → walk JSONs.

Counterpart of ``neuralstyletransferv1_tpu/apps/style_video_pipeline.py``:
extract frames at a fixed fps, style the frame range with each weight of
the selected model families (``style_all_weights`` on ``--device``:
``cuda`` unless told ``cpu``; no GPU raises), and write
``walk_{family}.json`` files for ``multi_model_video``. The walk is an
unseeded ``random.choice`` walk, as in the JAX app. Run it as
``python -m neuralstyletransferv1_torch.apps.style_video_pipeline``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import random
import sys


def create_walk_file(output_dir: pathlib.Path, style_name: str, weights, frame_start: int, frame_end: int):
    """A gentle bounded random walk over the ladder rungs."""
    num_frames = frame_end - frame_start + 1
    if len(weights) == 1:
        walk = [0] * num_frames
    else:
        walk = []
        pos = len(weights) // 2
        for _ in range(num_frames):
            walk.append(pos)
            pos += random.choice([-1, 0, 0, 1])
            pos = max(0, min(len(weights) - 1, pos))
    walk_file = output_dir / f"walk_{style_name}.json"
    walk_file.write_text(
        json.dumps({"walk": walk, "weights": list(weights), "frame_start": frame_start, "frame_end": frame_end})
    )
    print(f"  Created {walk_file}")
    return walk_file


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--video", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--weights_dir", required=True, help="ladder checkpoints (*.pth)")
    ap.add_argument("--families", type=str, default=None,
                    help="comma prefixes, e.g. candy,mosaic (default: every checkpoint)")
    ap.add_argument("--fps", type=int, default=8)
    ap.add_argument("--frame_start", type=int, default=1)
    ap.add_argument("--frame_end", type=int, default=None)
    ap.add_argument("--scale", type=int, default=1080)
    ap.add_argument("--io_preset", default="auto")
    ap.add_argument("--frame_batch", type=int, default=4)
    ap.add_argument("--work_dir", default="./_work_svp")
    ap.add_argument("--device", choices=["cpu", "cuda", "mps", "tpu"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..io.frames import extract_frames
    from .style_all_weights import main as saw_main

    resolve_device(args.device)
    out_dir = pathlib.Path(args.output_dir)
    frames_dir = out_dir / "frames"
    frames_dir.mkdir(parents=True, exist_ok=True)
    print(f"[svp] extracting {args.video} at {args.fps} fps")
    extract_frames(pathlib.Path(args.video), frames_dir, args.fps, args.scale, "png", 90)

    families: dict[str, list[str]] = {}
    for wf in sorted(pathlib.Path(args.weights_dir).glob("*.pth")):
        fam = wf.stem.split("_style")[0]
        if args.families and fam not in args.families.split(","):
            continue
        families.setdefault(fam, []).append(wf.stem)

    if not families:
        print("[svp][error] no matching ladder checkpoints")
        return 2

    rc = saw_main([
        "--frames_dir", str(frames_dir), "--weights_dir", args.weights_dir,
        "--out_root", str(out_dir / "styled"), "--io_preset", args.io_preset,
        "--frame_batch", str(args.frame_batch), "--work_dir", args.work_dir,
        "--device", args.device,
    ] + (["--start", str(args.frame_start)] if args.frame_start else [])
      + (["--end", str(args.frame_end)] if args.frame_end else []))
    if rc != 0:
        return rc

    n_frames = len(list(frames_dir.glob("frame_*.png")))
    frame_end = args.frame_end or n_frames
    for fam, weights in families.items():
        create_walk_file(out_dir, fam, weights, args.frame_start, frame_end)
    print(f"[svp] done: {len(families)} families, frames {args.frame_start}..{frame_end}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
