"""Optical-flow morph core + slideshow app.

Counterpart of ``neuralstyletransferv1_tpu/apps/morph.py``: bidirectional
Farneback flow with field smoothing, a min-flow radial boost so static
regions still morph, eased bidirectional warps and a smoothstep crossfade;
the slideshow CLI and the presets of the six ``optical_flow_*`` variants.

On ``--device`` (``cuda`` unless told ``cpu``; no GPU raises): both flows
run as one batch of two through ``ops/flow.farneback_flow``, and the
transition's frames render as batched gathers (``ops/warp.bilinear_sample``
over [T, H, W] coordinates), ``chunk`` frames a pass, cast to uint8 on the
device. Run it as ``python -m neuralstyletransferv1_torch.apps.morph``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def ease_in_out_cubic(t: float) -> float:
    if t < 0.5:
        return 4 * t * t * t
    return 1 - pow(-2 * t + 2, 3) / 2


def smoothstep(t: float) -> float:
    return t * t * (3 - 2 * t)


def smootherstep(t: float) -> float:
    return t * t * t * (t * (6 * t - 15) + 10)


def calculate_zoom_pulse(progress, pulse_amplitude=0.05, pulse_frequency=2.0):
    pulse = abs(math.sin(progress * pulse_frequency * 2 * math.pi))
    return 1.0 + pulse * pulse_amplitude


def temporal_smooth_frames(frames, kernel_size=3, sigma=1.0):
    """Gaussian-weighted temporal blend over neighbouring frames (host
    numpy, as the JAX app)."""
    if len(frames) < kernel_size:
        return frames
    half = kernel_size // 2
    weights = np.array([np.exp(-((i - half) ** 2) / (2 * sigma**2)) for i in range(kernel_size)])
    weights = weights / weights.sum()
    smoothed = []
    for i in range(len(frames)):
        blended = np.zeros_like(frames[i], np.float32)
        total = 0.0
        for j, w in enumerate(weights):
            idx = i + j - half
            if 0 <= idx < len(frames):
                blended += frames[idx].astype(np.float32) * w
                total += w
        smoothed.append((blended / total).astype(frames[i].dtype))
    return smoothed


def morph_flows(i1: torch.Tensor, i2: torch.Tensor, min_flow: float = 2.0) -> torch.Tensor:
    """The forward and backward flows [2, H, W, 2] of two [H, W, 3] float
    images (0..255): grey σ=1 k5 pre-blur, Farneback (0.5, 6 levels, win 21,
    5 iterations, poly 7/1.5) in one batch of two, the σ=3 k15 field blur,
    and the radial min-flow boost (outwards forward, inwards backward)."""
    from ..ops.blur import gaussian_blur
    from ..ops.color import rgb_to_gray
    from ..ops.flow import farneback_flow

    h, w = i1.shape[:2]
    g = gaussian_blur(rgb_to_gray(torch.stack([i1, i2]))[..., None], 1.0, ksize=5)[..., 0]
    flow = farneback_flow(g, g.flip(0), pyr_scale=0.5, levels=6, winsize=21, iterations=5,
                          poly_n=7, poly_sigma=1.5)
    flow = gaussian_blur(flow, 3.0, ksize=15)
    mag = torch.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    low = (mag < min_flow).float()
    sign = torch.tensor([1.0, -1.0], device=flow.device)[:, None, None]
    ry = ((torch.arange(h, dtype=torch.float32, device=flow.device)[:, None] - h / 2.0) / h
          ).expand(h, w)
    rx = ((torch.arange(w, dtype=torch.float32, device=flow.device)[None, :] - w / 2.0) / w
          ).expand(h, w)
    dx = flow[..., 0] + sign * low * rx * min_flow * 2
    dy = flow[..., 1] + sign * low * ry * min_flow * 2
    return torch.stack([dx, dy], -1)


def _reflect(c: torch.Tensor, size: int) -> torch.Tensor:
    """cv2.BORDER_REFLECT folding of coordinates into [0, size - 1]."""
    period = 2.0 * size
    c = torch.remainder(c, period)
    return torch.minimum(c, period - 1.0 - c).clamp(0.0, size - 1.0)


def render_morph(i1, i2, fwd, bwd, t_eased, alphas, chunk: int = 24) -> list[np.ndarray]:
    """Frames t of the morph as uint8 [H, W, 3] numpy: i1 warped forward by
    t·fwd and i2 backward by (1 − t)·bwd (reflected coordinates, bilinear),
    crossfaded by alpha; ``chunk`` frames a batched pass."""
    from ..ops.warp import bilinear_sample

    h, w = i1.shape[:2]
    dev = i1.device
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    ts = torch.as_tensor(np.asarray(t_eased, np.float32), device=dev)[:, None, None]
    al = torch.as_tensor(np.asarray(alphas, np.float32), device=dev)[:, None, None, None]
    frames = []
    for c0 in range(0, ts.shape[0], chunk):
        t, a = ts[c0:c0 + chunk], al[c0:c0 + chunk]
        w1 = bilinear_sample(i1, _reflect(gx + t * fwd[..., 0], w), _reflect(gy + t * fwd[..., 1], h))
        w2 = bilinear_sample(i2, _reflect(gx + (1 - t) * bwd[..., 0], w),
                             _reflect(gy + (1 - t) * bwd[..., 1], h))
        out = (w1 * (1 - a) + w2 * a).clamp(0, 255).to(torch.uint8)
        frames.extend(out.cpu().numpy())
    return frames


def optical_flow_morph(img1_rgb: np.ndarray, img2_rgb: np.ndarray, num_interp_frames: int = 72,
                       easing: str = "smooth", *, min_flow: float = 2.0, device="cpu",
                       chunk: int = 24) -> list[np.ndarray]:
    """Morph img1 → img2 (uint8 RGB, img2 resized bilinearly to img1's size
    where it differs); returns ``num_interp_frames`` uint8 RGB frames, the
    flows and the warps computed on ``device``."""
    h, w = img1_rgb.shape[:2]
    if img2_rgb.shape[:2] != (h, w):
        from PIL import Image

        img2_rgb = np.asarray(Image.fromarray(img2_rgb).resize((w, h), Image.BILINEAR))
    i1 = torch.from_numpy(img1_rgb.astype(np.float32)).to(device)
    i2 = torch.from_numpy(img2_rgb.astype(np.float32)).to(device)
    with torch.no_grad():
        fwd, bwd = morph_flows(i1, i2, min_flow)

        ease = {"smoother": smootherstep, "smooth": ease_in_out_cubic}.get(easing, lambda x: x)
        t_lin = np.array([i / (num_interp_frames - 1) if num_interp_frames > 1 else 0.0
                          for i in range(num_interp_frames)], np.float32)
        t_eased = np.array([ease(float(t)) for t in t_lin], np.float32)
        alphas = np.array([smoothstep(float(t)) for t in t_lin], np.float32)
        return render_morph(i1, i2, fwd, bwd, t_eased, alphas, chunk)


# The six optical_flow_* scripts of the JAX package's app differ only in
# input selection, ordering and canvas; each is a preset of the flags below.
VARIANTS = {
    "slideshow": {},
    "batch_img1": {"name_filter": r"^img1_tile.*\.jpg$", "target_size": "1280x720",
                   "morph_frames": 120, "hold_frames": 0},
    "canyon_vertical": {"name_filter": "canyon", "exclude": "wave|magenta_starry",
                        "max_images": 50, "order": "shuffle",
                        "target_size": "720x1280"},
    "resmix": {"target_size": "1280x720"},
    "selfstyle": {"glob": "**/Final Image.*,**/final image.*",
                  "order": "shuffle"},
    "batch_all": {"name_filter": r"^img[23567]_", "target_size": "720x1280"},
}


def select_images(args) -> list[str]:
    """Directory selection and ordering shared by the variant presets."""
    import glob as _glob
    import os
    import random
    import re

    pats = [p.strip() for p in args.glob.split(",") if p.strip()]
    files: list[str] = []
    for p in pats:
        files.extend(_glob.glob(os.path.join(args.image_dir, p), recursive="**" in p))
    files = sorted(set(files))
    if args.name_filter:
        files = [f for f in files if re.search(args.name_filter, os.path.basename(f))]
    if args.exclude:
        files = [f for f in files
                 if not re.search(args.exclude, os.path.basename(f), re.IGNORECASE)]
    rng = random.Random(args.seed)
    if args.max_images and len(files) > args.max_images:
        files = rng.sample(files, args.max_images)
    if args.order == "shuffle":
        rng.shuffle(files)
    return files


def _load_cover(path, target_wh, zoom=1.0):
    """Optional centre zoom crop, cover-mode Lanczos scale, centre crop to
    the exact canvas."""
    from PIL import Image

    im = Image.open(path).convert("RGB")
    w, h = im.size
    tw, th = target_wh
    if zoom > 1.0:
        cw, ch = int(w / zoom), int(h / zoom)
        sx, sy = (w - cw) // 2, (h - ch) // 2
        im = im.crop((sx, sy, sx + cw, sy + ch))
        w, h = im.size
    s = max(tw / w, th / h)
    nw, nh = int(w * s), int(h * s)
    im = im.resize((nw, nh), Image.LANCZOS)
    sx, sy = (nw - tw) // 2, (nh - th) // 2
    return np.asarray(im.crop((sx, sy, sx + tw, sy + th)))


def main(argv=None) -> int:
    """Morph slideshow CLI: a sequence of images → crossfade-morph video."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--images", nargs="+", help="explicit image list")
    ap.add_argument("--image_dir", help="directory selection (see --variant)")
    ap.add_argument("--glob", default="*.jpg,*.png",
                    help="comma-separated patterns under --image_dir")
    ap.add_argument("--name_filter", help="regex on basename (keep matches)")
    ap.add_argument("--exclude", help="regex on basename (drop matches)")
    ap.add_argument("--order", choices=["sorted", "shuffle"], default="sorted")
    ap.add_argument("--max_images", type=int, default=0,
                    help="random-sample down to N before ordering")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--variant", choices=sorted(VARIANTS), help="optical_flow_* script preset")
    ap.add_argument("--output", required=True)
    ap.add_argument("--fps", type=int, default=24)
    ap.add_argument("--morph_frames", type=int, default=48)
    ap.add_argument("--hold_frames", type=int, default=12)
    ap.add_argument("--easing", choices=["linear", "smooth", "smoother"], default="smooth")
    ap.add_argument("--size", type=int, default=720, help="long-side resize")
    ap.add_argument("--target_size",
                    help="WxH canvas: cover-mode resize + center crop "
                    "(vertical videos use e.g. 720x1280)")
    ap.add_argument("--zoom", type=float, default=1.0,
                    help="center zoom crop before the cover resize")
    ap.add_argument("--temporal_smooth", action="store_true")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    if args.variant:
        for k, v in VARIANTS[args.variant].items():
            if getattr(args, k) == ap.get_default(k):  # explicit CLI wins
                setattr(args, k, v)
    if not args.images and not args.image_dir:
        ap.error("one of --images / --image_dir is required")

    from PIL import Image

    from ..device import resolve_device
    from ..io.frames import write_mp4

    device = resolve_device(args.device)
    paths = args.images or select_images(args)
    if len(paths) < 2:
        print(f"[morph] need at least 2 images, found {len(paths)}")
        return 1

    if args.target_size:
        tw, th = (int(v) for v in args.target_size.lower().split("x"))
        imgs = [_load_cover(p, (tw, th), args.zoom) for p in paths]
    else:
        imgs = []
        for p in paths:
            im = Image.open(p).convert("RGB")
            iw, ih = im.size
            s = args.size / max(iw, ih)
            if s < 1.0:
                im = im.resize((int(iw * s) // 2 * 2, int(ih * s) // 2 * 2), Image.LANCZOS)
            imgs.append(np.asarray(im))
    base = imgs[0].shape[:2]
    imgs = [i if i.shape[:2] == base else np.asarray(Image.fromarray(i).resize((base[1], base[0])))
            for i in imgs]

    frames: list[np.ndarray] = []
    for a, b in zip(imgs, imgs[1:]):
        frames.extend([a] * args.hold_frames)
        frames.extend(optical_flow_morph(a, b, args.morph_frames, args.easing, device=device))
    frames.extend([imgs[-1]] * args.hold_frames)
    if args.temporal_smooth:
        frames = temporal_smooth_frames(frames)

    write_mp4(args.output, frames, args.fps)
    print(f"[morph] wrote {args.output} ({len(frames)} frames)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
