"""style_morph — weight-ladder interpolation videos.

Counterpart of ``neuralstyletransferv1_tpu/apps/style_morph.py``: composes
videos from pre-styled stills (one per ladder rung, made by
style_all_weights), drifting each style family's ladder position with a
slow sine and blending families with drifting weights; rung interpolation
is smoothstep; gentle saturation and warm filters (OpenCV and numpy on the
host); crossfades between source images.

The per-frame composition (the ladder gather and smoothstep mix over all
families) runs as torch on ``--device`` (``cuda`` unless told ``cpu``; no
GPU raises), in f32, a chunk of frames at a time, and ends in the JAX
app's truncating uint8 cast. Run it as
``python -m neuralstyletransferv1_torch.apps.style_morph``.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys

import numpy as np

# The ladder registry: each family's rungs in order.
def _ladder(prefix, rungs):
    return [prefix] + [f"{prefix}_style{r}" for r in rungs]


_STD = ["1e9", "5e9", "1e10", "5e10", "1e11", "5e11", "1e12"]
_TEN = [f"{i}e{e}" for e in (9, 10, 11) for i in range(1, 10)] + ["1e12"]

ALL_LADDERS = {
    "candy": _ladder("candy", _STD),
    "udnie": _ladder("udnie", _STD),
    "mosaic": _ladder("mosaic", _STD),
    "rain_princess": _ladder("rain_princess", _STD),
    "tenharmsel": [f"tenharmsel_style{r}" for r in _TEN],
}


def smoothstep(t):
    return t * t * (3 - 2 * t)


def boost_saturation(img_rgb: np.ndarray, factor=1.10) -> np.ndarray:
    """HSV S-channel scale."""
    import cv2

    hsv = cv2.cvtColor(img_rgb, cv2.COLOR_RGB2HSV).astype(np.float32)
    hsv[:, :, 1] = np.clip(hsv[:, :, 1] * factor, 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


def warm_filter(img_rgb: np.ndarray, strength=0.06) -> np.ndarray:
    """R/G channel lift."""
    img = img_rgb.astype(np.float32)
    img[:, :, 0] = np.clip(img[:, :, 0] * (1 + strength), 0, 255)
    img[:, :, 1] = np.clip(img[:, :, 1] * (1 + strength * 0.3), 0, 255)
    return img.astype(np.uint8)


def load_ladders(styled_dir: pathlib.Path, img_name: str, size_hw, families):
    """{family: [H,W,3] float32 stack} for every available rung image."""
    from PIL import Image

    out = {}
    for fam, ladder in ALL_LADDERS.items():
        if families and fam not in families:
            continue
        imgs = []
        for style in ladder:
            for ext in (".jpg", ".png"):
                p = styled_dir / f"{img_name}_{style}{ext}"
                if p.exists():
                    im = Image.open(p).convert("RGB")
                    if (im.height, im.width) != size_hw:
                        im = im.resize((size_hw[1], size_hw[0]), Image.LANCZOS)
                    imgs.append(np.asarray(im, np.float32))
                    break
        if len(imgs) >= 2:
            out[fam] = np.stack(imgs, 0)
    return out


def interpolate_ladder_np(stack: np.ndarray, position: float) -> np.ndarray:
    """Smoothstep rung interpolation."""
    n = stack.shape[0]
    if n == 1:
        return stack[0]
    f = position * (n - 1)
    lo = int(f)
    hi = min(lo + 1, n - 1)
    b = smoothstep(f - lo)
    return stack[lo] * (1 - b) + stack[hi] * b


def compose_frames(ladders: dict, orig: np.ndarray | None, num_frames: int,
                   orig_blend: float, seed_phase: float = 0.0, device="cpu",
                   chunk: int = 16):
    """Sine-drift ladder positions + family weights → per-frame composite
    (uint8 HWC list), on ``device``, ``chunk`` frames a pass."""
    import torch

    fams = sorted(ladders.keys())
    stacks = [torch.from_numpy(np.ascontiguousarray(ladders[f], np.float32)).to(device)
              for f in fams]
    norig = (torch.from_numpy(np.ascontiguousarray(orig, np.float32)).to(device)
             if orig is not None else None)
    ts_all = torch.linspace(0.0, 1.0, num_frames, dtype=torch.float32, device=device)
    frames = []
    for c0 in range(0, num_frames, chunk):
        ts = ts_all[c0:c0 + chunk]
        out = torch.zeros((ts.shape[0],) + tuple(stacks[0].shape[1:]), dtype=torch.float32,
                          device=device)
        wsum = torch.zeros_like(ts)
        for i, st in enumerate(stacks):
            # slow drifting position and weight per family, phase-spread
            pos = 0.5 + 0.5 * torch.sin(2 * math.pi * (ts * 0.9 + seed_phase) + i * 2.399)
            wgt = 0.5 + 0.5 * torch.sin(2 * math.pi * (ts * 0.6 + seed_phase) + i * 1.731 + 1.0)
            n = st.shape[0]
            f = pos * (n - 1)
            lo = torch.clamp(torch.floor(f).to(torch.int32), 0, n - 1)
            hi = torch.clamp(lo + 1, 0, n - 1)
            b = f - lo
            b = (b * b * (3 - 2 * b))[:, None, None, None]
            img = st[lo.long()] * (1 - b) + st[hi.long()] * b
            out = out + img * wgt[:, None, None, None]
            wsum = wsum + wgt
        out = out / torch.clamp(wsum, min=1e-6)[:, None, None, None]
        if norig is not None:
            out = out * (1 - orig_blend) + norig * orig_blend
        frames.extend(torch.clamp(out, 0, 255).to(torch.uint8).cpu().numpy())
    return frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--styled_dir", required=True,
                    help="directory of {image}_{style}.jpg stills (from style_all_weights)")
    ap.add_argument("--output", required=True)
    ap.add_argument("--frame_seconds", type=float, default=4.0)
    ap.add_argument("--fps", type=int, default=24)
    ap.add_argument("--families", type=str, default=None, help="comma list, e.g. candy,mosaic")
    ap.add_argument("--orig_blend", type=float, default=0.08)
    ap.add_argument("--orig_dir", type=str, default=None, help="directory of original stills")
    ap.add_argument("--skip_first", action="store_true", default=True)
    ap.add_argument("--saturation", type=float, default=1.10)
    ap.add_argument("--warm", type=float, default=0.06)
    ap.add_argument("--crossfade", type=float, default=0.5)
    ap.add_argument("--device", choices=["cpu", "cuda", "mps", "tpu"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    import cv2
    from PIL import Image

    from ..device import resolve_device

    device = resolve_device(args.device)
    styled_dir = pathlib.Path(args.styled_dir)
    families = args.families.split(",") if args.families else None
    all_files = list(styled_dir.glob("*.jpg")) + list(styled_dir.glob("*.png"))
    names = sorted(set(f.stem.rsplit("_", 1)[0] for f in all_files if "_" in f.stem))
    # Strip ladder suffix parts: names like img_candy_style1e9 → rsplit once is
    # insufficient for *_styleXeY; normalize by removing known style suffixes.
    base_names = set()
    for f in all_files:
        stem = f.stem
        for fam, ladder in ALL_LADDERS.items():
            for style in ladder:
                if stem.endswith("_" + style):
                    base_names.add(stem[: -(len(style) + 1)])
    names = sorted(base_names) or names
    if args.skip_first and len(names) > 1:
        names = names[1:]
    if not names:
        print(f"[style_morph][error] no styled stills in {styled_dir}")
        return 2

    seg_frames = max(2, int(round(args.frame_seconds * args.fps)))
    all_frames: list[np.ndarray] = []
    size_hw = None
    for i, name in enumerate(names):
        probe = next((f for f in all_files if f.stem.startswith(name + "_")), None)
        if size_hw is None:
            im = Image.open(probe)
            size_hw = (im.height, im.width)
        ladders = load_ladders(styled_dir, name, size_hw, families)
        if not ladders:
            print(f"[style_morph][warn] no ladder images for {name}; skipping")
            continue
        orig = None
        if args.orig_dir:
            for ext in (".jpg", ".png", ".jpeg"):
                p = pathlib.Path(args.orig_dir) / f"{name}{ext}"
                if p.exists():
                    im = Image.open(p).convert("RGB").resize((size_hw[1], size_hw[0]), Image.LANCZOS)
                    orig = np.asarray(im, np.float32)
                    break
        seg = compose_frames(ladders, orig, seg_frames, args.orig_blend, seed_phase=i * 0.37,
                             device=device)
        seg = [warm_filter(boost_saturation(f, args.saturation), args.warm) for f in seg]
        if all_frames and args.crossfade > 0:
            k = min(int(args.crossfade * args.fps), len(all_frames), len(seg))
            for j in range(k):
                a = all_frames[-k + j].astype(np.float32)
                b = seg[j].astype(np.float32)
                w = (j + 1) / (k + 1)
                all_frames[-k + j] = (a * (1 - w) + b * w).astype(np.uint8)
            seg = seg[k:]
        all_frames.extend(seg)

    if not all_frames:
        print("[style_morph][error] nothing rendered")
        return 2
    h, w = all_frames[0].shape[:2]
    for fourcc in ("avc1", "mp4v"):
        writer = cv2.VideoWriter(args.output, cv2.VideoWriter_fourcc(*fourcc), args.fps, (w, h))
        if writer.isOpened():
            break
    for f in all_frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    print(f"[style_morph] wrote {args.output} ({len(all_frames)} frames, {len(names)} images)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
