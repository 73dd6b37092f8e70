"""multi_model_video — compose pre-styled frame directories into one video.

Counterpart of ``neuralstyletransferv1_tpu/apps/multi_model_video.py`` (a
copy: the port imports nothing of the JAX package). Host work only, numpy
and OpenCV, as there: a base family follows an EMA-smoothed weight walk
drawn from ``np.random.default_rng(--walk_seed)``, overlay families fade in
and out on gaussian pulses, a saturation boost, and a run-parameters JSON
log is written next to the output. Run it as
``python -m neuralstyletransferv1_torch.apps.multi_model_video``.

Frame-dir layout (produced by style_all_weights + a rename, or any
``{frame}_{weight}.jpg`` set): ``styled_dir/{frame_name}_{weight}.jpg`` plus
``{frame_name}_original.jpg``.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
from datetime import datetime

import numpy as np


def smooth_walk_ema(walk, alpha=0.05):
    """Exponential moving average of the walk."""
    out = [float(walk[0])]
    for i in range(1, len(walk)):
        out.append(alpha * walk[i] + (1 - alpha) * out[-1])
    return out


def gaussian_pulse(t, num_pulses=4, width=0.15):
    """Sum of ``num_pulses`` gaussians in t ∈ [0, 1], capped at 1."""
    total = 0.0
    for i in range(num_pulses):
        center = (i + 0.5) / num_pulses
        total += math.exp(-((t - center) ** 2) / (2 * width**2))
    return min(1.0, total)


def adjust_saturation(img_rgb, factor=1.3):
    import cv2

    hsv = cv2.cvtColor(img_rgb, cv2.COLOR_RGB2HSV).astype(np.float32)
    hsv[:, :, 1] = np.clip(hsv[:, :, 1] * factor, 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


def _load(styled_dir, name, suffix, size_hw):
    from PIL import Image

    for ext in (".jpg", ".png"):
        p = styled_dir / f"{name}_{suffix}{ext}"
        if p.exists():
            im = Image.open(p).convert("RGB")
            if (im.height, im.width) != size_hw:
                im = im.resize((size_hw[1], size_hw[0]), Image.LANCZOS)
            return np.asarray(im, np.float32)
    return None


def get_styled_frame(styled_dir, name, weights, weight_pos, size_hw, orig_blend=0.4):
    """Weight-walk interpolation with the original blended in."""
    orig = _load(styled_dir, name, "original", size_hw)
    if orig is None:
        return None
    lo = int(weight_pos)
    hi = min(lo + 1, len(weights) - 1)
    b = weight_pos - lo
    s_lo = _load(styled_dir, name, weights[lo], size_hw)
    if s_lo is None:
        for w in weights:
            s_lo = _load(styled_dir, name, w, size_hw)
            if s_lo is not None:
                break
    if s_lo is None:
        return orig.astype(np.uint8)
    if b > 0.01 and hi != lo:
        s_hi = _load(styled_dir, name, weights[hi], size_hw)
        styled = s_lo * (1 - b) + s_hi * b if s_hi is not None else s_lo
    else:
        styled = s_lo
    return np.clip(orig * orig_blend + styled * (1 - orig_blend), 0, 255).astype(np.uint8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base_dir", required=True, help="base family styled dir")
    ap.add_argument("--base_weights", required=True, help="comma weight names, walk order")
    ap.add_argument("--pulse_dirs", nargs="*", default=[], help="overlay family styled dirs")
    ap.add_argument("--pulse_weights", nargs="*", default=[], help="one comma-list per pulse dir")
    ap.add_argument("--output", required=True)
    ap.add_argument("--fps", type=int, default=24)
    ap.add_argument("--hold_frames", type=int, default=8, help="frames per source still")
    ap.add_argument("--orig_blend", type=float, default=0.4)
    ap.add_argument("--saturation", type=float, default=1.3)
    ap.add_argument("--pulses", type=int, default=4)
    ap.add_argument("--pulse_max", type=float, default=0.5)
    ap.add_argument("--walk_seed", type=int, default=0)
    args = ap.parse_args(argv)

    import cv2
    from PIL import Image

    base_dir = pathlib.Path(args.base_dir)
    base_weights = args.base_weights.split(",")
    names = sorted(
        {f.stem.rsplit("_", 1)[0] for f in base_dir.glob("*_original.*")}
    )
    if not names:
        print(f"[mmv][error] no *_original stills in {base_dir}")
        return 2
    probe = next(base_dir.glob(f"{names[0]}_original.*"))
    im = Image.open(probe)
    size_hw = (im.height, im.width)

    total = len(names) * args.hold_frames
    rng = np.random.default_rng(args.walk_seed)
    walk = smooth_walk_ema(list(rng.uniform(0, len(base_weights) - 1, total)))

    pulse_sets = [
        (pathlib.Path(d), w.split(","))
        for d, w in zip(args.pulse_dirs, args.pulse_weights)
    ]

    frames = []
    for fi in range(total):
        name = names[min(fi // args.hold_frames, len(names) - 1)]
        t = fi / max(1, total - 1)
        fr = get_styled_frame(base_dir, name, base_weights, walk[fi], size_hw, args.orig_blend)
        if fr is None:
            continue
        fr = fr.astype(np.float32)
        for pi, (pdir, pweights) in enumerate(pulse_sets):
            amt = gaussian_pulse((t + pi / max(1, len(pulse_sets))) % 1.0, args.pulses) * args.pulse_max
            if amt > 0.01:
                over = get_styled_frame(pdir, name, pweights, walk[fi] % (len(pweights) - 1 or 1), size_hw, 0.0)
                if over is not None:
                    fr = fr * (1 - amt) + over.astype(np.float32) * amt
        frames.append(adjust_saturation(np.clip(fr, 0, 255).astype(np.uint8), args.saturation))

    if not frames:
        print("[mmv][error] nothing rendered")
        return 2
    h, w = frames[0].shape[:2]
    outp = pathlib.Path(args.output)
    for fourcc in ("avc1", "mp4v"):
        writer = cv2.VideoWriter(str(outp), cv2.VideoWriter_fourcc(*fourcc), args.fps, (w, h))
        if writer.isOpened():
            break
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()

    # run-parameters log
    log = {
        "timestamp": datetime.now().isoformat(),
        "base_dir": str(base_dir),
        "base_weights": base_weights,
        "pulse_dirs": args.pulse_dirs,
        "total_frames": len(frames),
        "fps": args.fps,
        "duration_sec": len(frames) / args.fps,
        "orig_blend": args.orig_blend,
        "saturation": args.saturation,
    }
    log_path = outp.parent / f"{outp.stem}_run.json"
    log_path.write_text(json.dumps(log, indent=2))
    print(f"[mmv] wrote {outp} ({len(frames)} frames) + {log_path.name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
