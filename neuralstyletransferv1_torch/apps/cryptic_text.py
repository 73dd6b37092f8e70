"""cryptic_text — artistic animated text overlays on video.

Counterpart of ``neuralstyletransferv1_tpu/apps/cryptic_text.py``:
per-phrase PIL font masks, gradient / neon / chrome / NST-texture fills,
ripple / melt / breathe / glitch / wave distortions, seven path
animations, rotate/scale/alpha compositing, and the per-phrase video
pipeline with fade in/out. Python's ``random`` draws in the JAX app's
order, so a ``--seed`` picks the same animations, fills and glitches.

The distortion warps (cv2.remap with a constant zero border) run on
``--device`` (``cuda`` unless told ``cpu``; no GPU raises) through
``ops/warp.bilinear_sample(border="constant")``; the rest is host PIL /
OpenCV on the small text sprites, as in the JAX app. Run it as
``python -m neuralstyletransferv1_torch.apps.cryptic_text``.
"""

from __future__ import annotations

import argparse
import glob as globmod
import math
import pathlib
import random
import sys

import numpy as np

FONTS = [
    "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf",
    "/usr/share/fonts/truetype/liberation/LiberationSans-Bold.ttf",
    "/usr/share/fonts/truetype/ubuntu/Ubuntu-B.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSerif-Bold.ttf",
]
ANIMATIONS = ["orbit", "wave_path", "diagonal", "edge_crawl", "float",
              "zoom_travel", "spiral_in"]
DISTORTIONS = ["ripple", "melt", "breathe", "glitch_warp", "wave_distort", "none"]
FILLS = ["gradient_fire", "gradient_ice", "gradient_rainbow", "neon_glow",
         "chrome", "nst_texture"]


def ease_in_out(t):
    if t < 0.5:
        return 4 * t * t * t
    return 1 - pow(-2 * t + 2, 3) / 2


def ease_out(t):
    return 1 - pow(1 - t, 3)


def ease_in(t):
    return t * t * t


# ---------------------------------------------------------------------------
# Text masks
# ---------------------------------------------------------------------------


def _load_font(font_path, font_size):
    from PIL import ImageFont

    try:
        return ImageFont.truetype(font_path, font_size)
    except Exception:
        return ImageFont.load_default()


def render_text_mask(text, font_path, font_size):
    from PIL import Image, ImageDraw

    font = _load_font(font_path, font_size)
    dummy = Image.new("L", (1, 1))
    draw = ImageDraw.Draw(dummy)
    bbox = draw.textbbox((0, 0), text, font=font)
    tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
    padding = font_size // 2
    img = Image.new("L", (max(1, tw + padding * 2), max(1, th + padding * 2)), 0)
    ImageDraw.Draw(img).text((padding - bbox[0], padding - bbox[1]), text,
                             font=font, fill=255)
    return np.array(img)


def render_letter_masks(text, font_path, font_size):
    """Per-letter masks with advance offsets."""
    from PIL import Image, ImageDraw

    font = _load_font(font_path, font_size)
    dummy = Image.new("L", (1, 1))
    draw = ImageDraw.Draw(dummy)
    letters = []
    x_offset = 0
    for char in text:
        bbox = draw.textbbox((0, 0), char, font=font)
        cw, ch = bbox[2] - bbox[0], bbox[3] - bbox[1]
        if cw > 0 and ch > 0:
            padding = 10
            img = Image.new("L", (cw + padding * 2, ch + padding * 2), 0)
            ImageDraw.Draw(img).text((padding - bbox[0], padding - bbox[1]),
                                     char, font=font, fill=255)
            letters.append({"char": char, "mask": np.array(img),
                            "x_offset": x_offset, "width": cw, "height": ch})
        adv = draw.textbbox((0, 0), char + " ", font=font)
        x_offset += (adv[2] - adv[0]) - draw.textbbox((0, 0), " ", font=font)[2]
    return letters


# ---------------------------------------------------------------------------
# Fills (reference: :181-321; per-column loops vectorized)
# ---------------------------------------------------------------------------


def apply_gradient_fill(mask, gradient_type, progress=0):
    h, w = mask.shape
    ratio = np.arange(w, dtype=np.float32) / max(1, w - 1)
    r = np.zeros(w)
    g = np.zeros(w)
    b = np.zeros(w)
    if gradient_type == "fire":
        s1, s2 = ratio < 0.33, (ratio >= 0.33) & (ratio < 0.66)
        s3 = ratio >= 0.66
        r[s1], g[s1], b[s1] = 200, 50 + ratio[s1] * 300, 0
        r[s2], g[s2], b[s2] = 255, 150 + (ratio[s2] - 0.33) * 300, (ratio[s2] - 0.33) * 150
        r[s3], g[s3], b[s3] = 255, 255, 50 + (ratio[s3] - 0.66) * 600
    elif gradient_type == "ice":
        s1 = ratio < 0.5
        r[s1], g[s1], b[s1] = ratio[s1] * 100, 100 + ratio[s1] * 300, 255
        s2 = ~s1
        r[s2] = 50 + (ratio[s2] - 0.5) * 400
        g[s2] = 250 + (ratio[s2] - 0.5) * 10
        b[s2] = 255
    elif gradient_type == "rainbow":
        hue = (ratio + progress) % 1.0
        hv = hue * 6
        segs = [
            (hv < 1, 255, hv * 255, 0),
            ((hv >= 1) & (hv < 2), (2 - hv) * 255, 255, 0),
            ((hv >= 2) & (hv < 3), 0, 255, (hv - 2) * 255),
            ((hv >= 3) & (hv < 4), 0, (4 - hv) * 255, 255),
            ((hv >= 4) & (hv < 5), (hv - 4) * 255, 0, 255),
            (hv >= 5, 255, 0, (6 - hv) * 255),
        ]
        for m, rr, gg, bb in segs:
            r[m] = rr[m] if isinstance(rr, np.ndarray) else rr
            g[m] = gg[m] if isinstance(gg, np.ndarray) else gg
            b[m] = bb[m] if isinstance(bb, np.ndarray) else bb
    elif gradient_type == "chrome":
        base = 0.5 + 0.5 * np.sin((ratio * 4 + progress * 2) * np.pi)
        r = 180 + 75 * base
        g = 180 + 75 * base
        b = 200 + 55 * base
    else:
        r[:], g[:], b[:] = 255, 255, 255
    result = np.zeros((h, w, 4), np.uint8)
    result[:, :, 0] = np.minimum(255, r)[None, :]
    result[:, :, 1] = np.minimum(255, g)[None, :]
    result[:, :, 2] = np.minimum(255, b)[None, :]
    result[:, :, 3] = mask
    return result


def apply_neon_glow(rgba, glow_color, glow_size=20):
    """(reference: :242-271)"""
    from PIL import Image, ImageFilter

    pil_img = Image.fromarray(rgba)
    alpha = pil_img.split()[3]
    glow = alpha.filter(ImageFilter.GaussianBlur(glow_size))
    glow2 = alpha.filter(ImageFilter.GaussianBlur(glow_size // 2))
    glow_rgba = Image.new("RGBA", pil_img.size, tuple(glow_color) + (0,))
    glow_rgba.putalpha(glow)
    inner = tuple(min(255, c + 100) for c in glow_color)
    inner_rgba = Image.new("RGBA", pil_img.size, inner + (0,))
    inner_rgba.putalpha(glow2)
    result = Image.new("RGBA", pil_img.size, (0, 0, 0, 0))
    result = Image.alpha_composite(result, glow_rgba)
    result = Image.alpha_composite(result, inner_rgba)
    result = Image.alpha_composite(result, pil_img)
    return np.array(result)


def apply_nst_texture(mask, texture_path, progress=0):
    """(reference: :273-321)"""
    import cv2

    h, w = mask.shape
    texture = cv2.imread(str(texture_path))
    if texture is None:
        return apply_gradient_fill(mask, "rainbow", progress)
    th, tw = texture.shape[:2]
    offset_x = int((progress * tw * 2) % tw)
    offset_y = int((progress * th) % th)
    if tw < w or th < h:
        texture = np.tile(texture, ((h // th) + 2, (w // tw) + 2, 1))
        th, tw = texture.shape[:2]
    x1 = offset_x % (tw - w) if tw > w else 0
    y1 = offset_y % (th - h) if th > h else 0
    cropped = texture[y1 : y1 + h, x1 : x1 + w]
    if cropped.shape[:2] != (h, w):
        cropped = cv2.resize(cropped, (w, h))
    result = np.zeros((h, w, 4), np.uint8)
    result[:, :, :3] = cropped[:, :, ::-1]
    result[:, :, 3] = mask
    return result


# ---------------------------------------------------------------------------
# Distortions (the remap runs on the device)
# ---------------------------------------------------------------------------


def _remap_rgba(rgba, map_x, map_y, device="cpu"):
    """cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0) as a gather on ``device``."""
    import torch

    from ..ops.warp import bilinear_sample

    out = bilinear_sample(
        torch.from_numpy(np.ascontiguousarray(rgba, np.float32)).to(device),
        torch.from_numpy(np.ascontiguousarray(map_x, np.float32)).to(device),
        torch.from_numpy(np.ascontiguousarray(map_y, np.float32)).to(device),
        border="constant", border_value=0.0,
    )
    return np.clip(out.cpu().numpy(), 0, 255).astype(np.uint8)


def apply_distortion(rgba, distortion_type, progress, intensity=1.0, rng=random, device="cpu"):
    h, w = rgba.shape[:2]
    if distortion_type == "none":
        return rgba
    y_coords, x_coords = np.mgrid[0:h, 0:w].astype(np.float32)

    if distortion_type == "ripple":
        freq, amp = 8, 15 * intensity
        phase = progress * 4 * math.pi
        map_x = x_coords + amp * np.sin(y_coords / h * freq * math.pi + phase)
        map_y = y_coords + amp * np.sin(x_coords / w * freq * math.pi + phase * 0.7)
    elif distortion_type == "melt":
        melt_amount = progress * 50 * intensity
        melt_factor = (y_coords / h) ** 2
        map_x = x_coords + np.sin(x_coords / 30 + progress * 5) * 10 * melt_factor * intensity
        map_y = y_coords + melt_factor * melt_amount + np.sin(x_coords / 20) * 5
    elif distortion_type == "breathe":
        scale = 1.0 + 0.1 * math.sin(progress * 4 * math.pi) * intensity
        cx, cy = w / 2, h / 2
        map_x = cx + (x_coords - cx) * scale
        map_y = cy + (y_coords - cy) * scale
    elif distortion_type == "glitch_warp":
        map_x, map_y = x_coords.copy(), y_coords.copy()
        for _ in range(5):
            if rng.random() < 0.3:
                y_start = rng.randint(0, max(0, h - 20))
                y_end = y_start + rng.randint(10, 30)
                map_x[y_start:y_end] += rng.randint(-30, 30) * intensity
    elif distortion_type == "wave_distort":
        freq_x = 3 + 2 * math.sin(progress * 2)
        freq_y = 2 + math.cos(progress * 3)
        amp = 20 * intensity
        map_x = x_coords + amp * np.sin(y_coords / h * freq_x * math.pi + progress * 6)
        map_y = y_coords + amp * 0.5 * np.sin(x_coords / w * freq_y * math.pi + progress * 4)
    else:
        return rgba
    map_x = np.clip(map_x, 0, w - 1)
    map_y = np.clip(map_y, 0, h - 1)
    return _remap_rgba(rgba, map_x, map_y, device)


# ---------------------------------------------------------------------------
# Path animations (reference: :408-516)
# ---------------------------------------------------------------------------


def get_animation_position(animation_type, progress, frame_size, text_size):
    w, h = frame_size
    margin = 50
    if animation_type == "orbit":
        angle = progress * 2 * math.pi
        cx = w / 2 + w * 0.3 * math.cos(angle)
        cy = h / 2 + h * 0.25 * math.sin(angle)
        return (int(cx), int(cy)), math.degrees(angle) + 90, 1.0
    if animation_type == "wave_path":
        x = margin + progress * (w - 2 * margin)
        y = h / 2 + h * 0.2 * math.sin(progress * 4 * math.pi)
        return (int(x), int(y)), 15 * math.cos(progress * 4 * math.pi), 1.0
    if animation_type == "diagonal":
        if progress < 0.5:
            t = progress * 2
            x = margin + t * (w / 2 - margin)
            y = margin + t * (h / 2 - margin)
        else:
            t = (progress - 0.5) * 2
            x = w / 2
            y = h / 2 + t * (h - margin - h / 2)
        return (int(x), int(y)), -15, 1.0
    if animation_type == "edge_crawl":
        perimeter = 2 * w + 2 * h
        pos = progress * perimeter
        if pos < w:
            x, y, rot = pos, margin, 0
        elif pos < w + h:
            x, y, rot = w - margin, pos - w, 90
        elif pos < 2 * w + h:
            x, y, rot = w - (pos - w - h), h - margin, 180
        else:
            x, y, rot = margin, h - (pos - 2 * w - h), 270
        return (int(x), int(y)), rot, 0.8
    if animation_type == "float":
        x = w / 2 + 100 * math.sin(progress * 3 * math.pi)
        y = h / 2 + 50 * math.cos(progress * 2 * math.pi)
        return (int(x), int(y)), 10 * math.sin(progress * 4 * math.pi), \
            1.0 + 0.1 * math.sin(progress * 2 * math.pi)
    if animation_type == "zoom_travel":
        t = ease_in_out(progress)
        x = margin + t * (w - 2 * margin)
        y = h / 2 + 100 * math.sin(t * 2 * math.pi)
        return (int(x), int(y)), 360 * progress, 0.3 + t * 0.7
    if animation_type == "spiral_in":
        radius = min(w, h) * 0.4 * (1 - progress)
        angle = progress * 6 * math.pi
        x = w / 2 + radius * math.cos(angle)
        y = h / 2 + radius * math.sin(angle)
        return (int(x), int(y)), math.degrees(angle), 0.5 + 0.5 * progress
    return (w // 2, h // 2), 0, 1.0


# ---------------------------------------------------------------------------
# Compositing (reference: :519-600)
# ---------------------------------------------------------------------------


def rotate_and_scale_rgba(rgba, angle, scale):
    import cv2

    h, w = rgba.shape[:2]
    new_w, new_h = int(w * scale), int(h * scale)
    if new_w < 1 or new_h < 1:
        return np.zeros((1, 1, 4), np.uint8)
    scaled = cv2.resize(rgba, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    if abs(angle) > 0.1:
        M = cv2.getRotationMatrix2D((new_w // 2, new_h // 2), angle, 1.0)
        cos, sin = abs(M[0, 0]), abs(M[0, 1])
        bw = int(new_h * sin + new_w * cos)
        bh = int(new_h * cos + new_w * sin)
        M[0, 2] += (bw - new_w) / 2
        M[1, 2] += (bh - new_h) / 2
        return cv2.warpAffine(scaled, M, (bw, bh), flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_CONSTANT,
                              borderValue=(0, 0, 0, 0))
    return scaled


def composite_rgba_on_frame(frame, rgba, center_pos):
    fh, fw = frame.shape[:2]
    th, tw = rgba.shape[:2]
    cx, cy = center_pos
    x1, y1 = cx - tw // 2, cy - th // 2
    x2, y2 = x1 + tw, y1 + th
    src_x1, src_y1 = max(0, -x1), max(0, -y1)
    src_x2, src_y2 = tw - max(0, x2 - fw), th - max(0, y2 - fh)
    dst_x1, dst_y1 = max(0, x1), max(0, y1)
    dst_x2, dst_y2 = min(fw, x2), min(fh, y2)
    if dst_x2 <= dst_x1 or dst_y2 <= dst_y1:
        return frame
    result = frame.copy()
    text_region = rgba[src_y1:src_y2, src_x1:src_x2]
    frame_region = result[dst_y1:dst_y2, dst_x1:dst_x2]
    alpha = text_region[:, :, 3:4].astype(float) / 255
    text_bgr = text_region[:, :, :3][:, :, ::-1]
    result[dst_y1:dst_y2, dst_x1:dst_x2] = (
        frame_region * (1 - alpha) + text_bgr * alpha
    ).astype(np.uint8)
    return result


def apply_text_to_frame(frame, text, font_path, font_size, animation,
                        distortion, fill_style, progress, texture_path=None,
                        rng=random, device="cpu"):
    """One frame's overlay: fade, fill, distortion, path, composite."""
    h, w = frame.shape[:2]
    if progress < 0.1:
        alpha = ease_out(progress / 0.1)
    elif progress > 0.9:
        alpha = ease_in((1 - progress) / 0.1)
    else:
        alpha = 1.0
    mask = render_text_mask(text, font_path, font_size)
    th, tw = mask.shape
    if fill_style == "nst_texture" and texture_path:
        rgba = apply_nst_texture(mask, texture_path, progress)
    elif fill_style == "neon_glow":
        base = apply_gradient_fill(mask, "rainbow", progress)
        neon = [(255, 0, 128), (0, 255, 255), (255, 255, 0), (128, 0, 255)]
        rgba = apply_neon_glow(base, rng.choice(neon))
    elif fill_style.startswith("gradient_"):
        rgba = apply_gradient_fill(mask, fill_style.replace("gradient_", ""), progress)
    elif fill_style == "chrome":
        rgba = apply_gradient_fill(mask, "chrome", progress)
    else:
        rgba = apply_gradient_fill(mask, "rainbow", progress)
    rgba = apply_distortion(rgba, distortion, progress, rng=rng, device=device)
    pos, rotation, scale = get_animation_position(animation, progress, (w, h), (tw, th))
    rgba = rotate_and_scale_rgba(rgba, rotation, scale)
    rgba[:, :, 3] = (rgba[:, :, 3] * alpha).astype(np.uint8)
    return composite_rgba_on_frame(frame, rgba, pos)


# ---------------------------------------------------------------------------
# Video pipeline (reference: :656-753)
# ---------------------------------------------------------------------------


def find_nst_textures(output_dir="output"):
    import cv2

    textures = []
    for pat in (f"{output_dir}/**/*tile*.jpg", f"{output_dir}/**/*styled*.jpg",
                f"{output_dir}/**/*candy*.jpg", f"{output_dir}/**/*mosaic*.jpg"):
        textures.extend(globmod.glob(pat, recursive=True))
    valid = []
    for t in textures[:50]:
        img = cv2.imread(t)
        if img is not None and img.shape[0] > 200 and img.shape[1] > 200:
            valid.append(t)
    return valid or None


def process_video(input_path, output_path, phrases, seed=None, animation=None,
                  distortion=None, fill=None, texture_dir="output", device="cpu"):
    import cv2

    from ..io.frames import write_mp4

    rng = random.Random(seed)
    textures = find_nst_textures(texture_dir)

    cap = cv2.VideoCapture(str(input_path))
    frames = []
    fps = cap.get(cv2.CAP_PROP_FPS) or 24
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(fr)
    cap.release()
    if not frames:
        print("[error] No frames")
        return None
    size = (frames[0].shape[1], frames[0].shape[0])
    frames_per_phrase = len(frames) // len(phrases)

    for i, phrase in enumerate(phrases):
        p_anim = animation or rng.choice(ANIMATIONS)
        p_dist = distortion or rng.choice(DISTORTIONS)
        p_fill = fill or rng.choice(FILLS)
        fonts = [f for f in FONTS if pathlib.Path(f).exists()] or [FONTS[0]]
        p_font = rng.choice(fonts)
        p_tex = rng.choice(textures) if textures and p_fill == "nst_texture" else None
        font_size = max(48, min(min(size[0] // max(1, len(phrase)), size[1] // 4), 200))
        print(f"  [{i + 1}/{len(phrases)}] '{phrase}' animation={p_anim} "
              f"distortion={p_dist} fill={p_fill}")
        start = i * frames_per_phrase
        end = min(start + frames_per_phrase, len(frames))
        for f in range(start, end):
            progress = (f - start) / max(1, frames_per_phrase)
            frames[f] = apply_text_to_frame(
                frames[f], phrase, p_font, font_size, p_anim, p_dist, p_fill,
                progress, p_tex, rng=rng, device=device,
            )

    write_mp4(output_path, frames, fps, rgb=False)
    print(f"COMPLETE: {output_path} ({len(frames)} frames)")
    return output_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Artistic text overlays")
    ap.add_argument("--input", help="Input video")
    ap.add_argument("--output", help="Output video")
    ap.add_argument("--phrases", help="Comma-separated phrases")
    ap.add_argument("--animation", choices=ANIMATIONS)
    ap.add_argument("--distortion", choices=DISTORTIONS)
    ap.add_argument("--fill", choices=FILLS)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--texture_dir", default="output")
    ap.add_argument("--list", action="store_true", help="List options")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    if args.list:
        print("animations:", ", ".join(ANIMATIONS))
        print("distortions:", ", ".join(DISTORTIONS))
        print("fills:", ", ".join(FILLS))
        return 0
    if not (args.input and args.output and args.phrases):
        print("Provide --input, --output, --phrases (or --list)")
        return 2
    from ..device import resolve_device

    device = resolve_device(args.device)
    phrases = [p.strip() for p in args.phrases.split(",") if p.strip()]
    out = process_video(args.input, args.output, phrases, seed=args.seed,
                        animation=args.animation, distortion=args.distortion,
                        fill=args.fill, texture_dir=args.texture_dir, device=device)
    return 0 if out else 1


if __name__ == "__main__":
    sys.exit(main())
