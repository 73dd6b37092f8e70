"""style_showcase — original → styles → blends → original showcase videos.

Counterpart of ``neuralstyletransferv1_tpu/apps/style_showcase.py``: for
each input image, stylize with up to MAX_MODELS models (discovered in
PYTORCH_DIR, TORCH_DIR and, with INCLUDE_MAGENTA=1, MAGENTA_STYLE_DIR)
through the port's ``engine/pipeline.main``, optionally insert 50/50 blends
between consecutive styles, render a motion clip (zoom_in / zoom_out /
pan_* / ken_burns) per still, then crossfade the chain original → style1 →
blend → style2 → … → original (``apps/drive_videos.crossfade_concat``).
Configured by environment variables, as the JAX app (``_cfg``).

The stylizations and the motion clips run on ``DEVICE`` (``cuda`` unless
told ``cpu``; no GPU raises): a clip's frames render as one batched
bilinear resample of the still (``ops/warp.bilinear_sample`` over [T, H, W]
coordinates), ``chunk`` frames a pass. The JAX function samples each frame
at a [1, W] × [H, 1] coordinate pair that its gather cannot reshape, so it
raises for every motion but ``none``; the port samples the [H, W]
broadcast of those coordinates, which is what the function describes. Run
it as ``DEVICE=cpu python -m neuralstyletransferv1_torch.apps.style_showcase``.
"""

from __future__ import annotations

import os
import pathlib
import sys
import tempfile

import numpy as np
import torch


def _cfg(name, default):
    return os.environ.get(name, default)


def find_images(directory: pathlib.Path):
    exts = {".jpg", ".jpeg", ".png"}
    return sorted(f for f in directory.iterdir() if f.is_file() and f.suffix.lower() in exts)


def discover_models(max_models: int):
    """The (name, type, path, magenta style) list from the model dirs, at
    most ``max_models``."""
    out = []
    pytorch_dir = pathlib.Path(_cfg("PYTORCH_DIR", "/app/models/pytorch"))
    torch_dir = pathlib.Path(_cfg("TORCH_DIR", "/app/models/torch"))
    magenta_styles = pathlib.Path(_cfg("MAGENTA_STYLE_DIR", "/app/models/magenta_styles"))
    for p in sorted(pytorch_dir.glob("*.pth")):
        out.append((p.stem, "transformer", str(p), None))
    for p in sorted(torch_dir.glob("*.t7")):
        out.append((p.stem, "torch7", str(p), None))
    if _cfg("INCLUDE_MAGENTA", "0") == "1":
        for p in sorted(magenta_styles.glob("*.jpg"))[:2]:
            out.append((p.stem, "magenta", "magenta", str(p)))
    return out[:max_models]


MOTIONS = ("zoom_in", "zoom_out", "pan_left", "pan_right", "pan_up", "pan_down", "ken_burns")


def _motion_params(motion: str, t: torch.Tensor, strength: float):
    """(zoom, pan_x, pan_y) of each progress ``t`` (a [T] tensor)."""
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    if motion == "zoom_in":
        return 1.0 + strength * t, zero, zero
    if motion == "zoom_out":
        return (1.0 + strength) - strength * t, zero, zero
    if motion == "pan_left":
        return 1.1 * one, 0.1 * (1 - t), zero
    if motion == "pan_right":
        return 1.1 * one, 0.1 * t, zero
    if motion == "pan_up":
        return 1.1 * one, zero, 0.1 * (1 - t)
    if motion == "pan_down":
        return 1.1 * one, zero, 0.1 * t
    return 1.0 + 0.5 * strength * t, 0.05 * t, 0.05 * t  # ken_burns


def motion_clip_frames(img_rgb: np.ndarray, motion: str, duration: float, fps: int,
                       strength: float, *, device="cpu", chunk: int = 24):
    """A zoom/pan clip of one still as uint8 RGB frames: frame t samples the
    still at (x / zoom + pan_x·W, y / zoom + pan_y·H), bilinear with a
    replicate border, on ``device``; ``motion`` none (or unknown) holds the
    still."""
    from ..ops.warp import bilinear_sample

    h, w = img_rgb.shape[:2]
    n = max(1, int(round(duration * fps)))
    if motion not in MOTIONS:
        return [img_rgb.astype(np.uint8)] * n
    img = torch.from_numpy(img_rgb.astype(np.float32)).to(device)
    gx = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    z, px, py = (v[:, None, None] for v in
                 _motion_params(motion, torch.linspace(0.0, 1.0, n, device=device), strength))
    frames = []
    for c0 in range(0, n, chunk):
        sl = slice(c0, c0 + chunk)
        sx = (gx / z[sl] + px[sl] * w).expand(-1, h, w)
        sy = (gy / z[sl] + py[sl] * h).expand(-1, h, w)
        out = bilinear_sample(img, sx, sy).clamp(0, 255).to(torch.uint8)
        frames.extend(out.cpu().numpy())
    return frames


def main(argv=None) -> int:
    from PIL import Image

    from ..device import resolve_device
    from ..engine.pipeline import main as pipeline_main
    from ..io.frames import write_mp4
    from .drive_videos import crossfade_concat

    device_name = _cfg("DEVICE", "cuda")
    device = resolve_device(device_name)  # no GPU with DEVICE=cuda raises here
    in_dir = pathlib.Path(_cfg("IN_DIR", "/app/input"))
    out_dir = pathlib.Path(_cfg("OUT_DIR", "/app/output"))
    scale = int(_cfg("SCALE", "720"))
    fps = int(_cfg("FPS", "24"))
    hold_model = float(_cfg("HOLD_MODEL", "1.5"))
    hold_start = float(_cfg("HOLD_ORIG_START", "2.0"))
    hold_end = float(_cfg("HOLD_ORIG_END", "2.0"))
    trans = float(_cfg("TRANS", "1.0"))
    max_models = int(_cfg("MAX_MODELS", "10"))
    max_blends = int(_cfg("MAX_BLENDS", "5"))
    include_blends = _cfg("INCLUDE_BLENDS", "1") == "1"
    motion = _cfg("MOTION", "none")
    strength = float(_cfg("MOTION_STRENGTH", "0.1"))
    io_preset = _cfg("IO_PRESET", "auto")
    extra = _cfg("PIPELINE_ARGS", "")

    out_dir.mkdir(parents=True, exist_ok=True)
    models = discover_models(max_models)
    if not models:
        print("[showcase][error] no models found")
        return 2
    images = find_images(in_dir)
    if not images:
        print(f"[showcase][error] no images in {in_dir}")
        return 2
    print(f"[showcase] {len(images)} image(s) × {len(models)} model(s), motion={motion}")

    import shlex

    for src in images:
        with tempfile.TemporaryDirectory(prefix="showcase_") as td:
            td = pathlib.Path(td)
            orig = Image.open(src).convert("RGB")
            w0, h0 = orig.size
            s = scale / max(w0, h0)
            if s < 1.0:
                orig = orig.resize((int(w0 * s) // 2 * 2, int(h0 * s) // 2 * 2), Image.LANCZOS)
            orig_path = td / "orig.png"
            orig.save(orig_path)

            stills = [np.asarray(orig)]
            prev_styled = None
            for name, mtype, mpath, mstyle in models:
                outp = td / f"styled_{name}.png"
                cmd = ["--input_image", str(orig_path), "--output_image", str(outp),
                       "--io_preset", io_preset, "--work_dir", str(td / "_w"),
                       "--no-smooth_lightness", "--device", device_name]
                if mtype == "magenta":
                    cmd += ["--model_type", "magenta", "--magenta_style", mstyle]
                else:
                    cmd += ["--model", mpath, "--model_type", mtype]
                if extra:
                    cmd += shlex.split(extra)
                if pipeline_main(cmd) != 0 or not outp.exists():
                    print(f"[showcase][warn] {name} failed; skipping")
                    continue
                styled = np.asarray(Image.open(outp).convert("RGB"))
                if include_blends and prev_styled is not None and max_blends > 0:
                    blend = ((prev_styled.astype(np.float32) + styled.astype(np.float32)) / 2).astype(np.uint8)
                    stills.append(blend)
                    max_blends -= 1
                stills.append(styled)
                prev_styled = styled
            stills.append(np.asarray(orig))

            clips = []
            for i, still in enumerate(stills):
                dur = hold_start if i == 0 else (hold_end if i == len(stills) - 1 else hold_model)
                frames = motion_clip_frames(still, motion, dur + trans, fps, strength,
                                            device=device)
                cp = td / f"clip_{i:03d}.mp4"
                write_mp4(cp, frames, fps)
                clips.append(cp)

            final = out_dir / f"{src.stem}_showcase.mp4"
            n = crossfade_concat(clips, final, trans, fps=fps)
            print(f"[showcase] wrote {final} ({n} frames, {len(clips)} clips)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
