"""style_all_weights — batch-style a frame range with every weight variant of
a model family (the weight ladder, BASELINE config #2), resumable: a rung
whose output directory already holds an output for every selected frame is
skipped.

Counterpart of ``neuralstyletransferv1_tpu/apps/style_all_weights.py``.
Each rung's checkpoint loads once and all selected frames run through the
port's batch-image pipeline (``engine/pipeline.main``) on ``--device``
(``cuda`` unless told ``cpu``; no GPU raises). Run it as
``python -m neuralstyletransferv1_torch.apps.style_all_weights``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames_dir", required=True, help="directory of frame_*.png/jpg")
    ap.add_argument("--weights_dir", required=True, help="directory of *.pth weight-ladder checkpoints")
    ap.add_argument("--out_root", required=True, help="output root; one subdir per weight")
    ap.add_argument("--pattern", default="*.pth")
    ap.add_argument("--start", type=int, default=None, help="first frame index (inclusive)")
    ap.add_argument("--end", type=int, default=None, help="last frame index (inclusive)")
    ap.add_argument("--io_preset", default="auto")
    ap.add_argument("--skip_existing", action="store_true", default=True)
    ap.add_argument("--frame_batch", type=int, default=4)
    ap.add_argument("--compute_dtype", default="float32")
    ap.add_argument("--work_dir", default="./_work_saw")
    ap.add_argument("--device", choices=["cpu", "cuda", "mps", "tpu"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..engine.pipeline import main as pipeline_main

    resolve_device(args.device)
    weight_files = sorted(Path(args.weights_dir).glob(args.pattern))
    if not weight_files:
        print(f"[error] no checkpoints match {args.weights_dir}/{args.pattern}")
        return 2
    frames = sorted(Path(args.frames_dir).glob("frame_*"))
    if args.start is not None or args.end is not None:
        def _idx(p):
            try:
                return int(p.stem.split("_")[-1])
            except ValueError:
                return -1
        frames = [p for p in frames
                  if (args.start is None or _idx(p) >= args.start)
                  and (args.end is None or _idx(p) <= args.end)]
    if not frames:
        print("[error] no frames selected")
        return 2
    print(f"[plan] {len(weight_files)} weights x {len(frames)} frames")

    for wf in weight_files:
        out_dir = Path(args.out_root) / wf.stem
        if args.skip_existing and out_dir.exists():
            done = len(list(out_dir.glob("*.png"))) + len(list(out_dir.glob("*.jpg")))
            if done >= len(frames):
                print(f"[skip] {wf.stem}: {done} outputs already present")
                continue
        out_dir.mkdir(parents=True, exist_ok=True)
        # Stage the selected frames through batch-image mode.
        rc = pipeline_main([
            "--input_dir", str(args.frames_dir), "--output_dir", str(out_dir),
            "--pattern", "frame_*", "--model", str(wf), "--io_preset", args.io_preset,
            "--frame_batch", str(args.frame_batch), "--compute_dtype", args.compute_dtype,
            "--work_dir", str(Path(args.work_dir) / wf.stem), "--device", args.device,
        ])
        if rc != 0:
            print(f"[warn] {wf.stem} failed (rc={rc}); continuing")
    return 0


if __name__ == "__main__":
    sys.exit(main())
