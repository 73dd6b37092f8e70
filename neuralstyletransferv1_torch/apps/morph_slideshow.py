"""morph_slideshow — per-image styled-stills slideshow with crossfades.

Counterpart of ``neuralstyletransferv1_tpu/apps/morph_slideshow.py`` (the
reference's morph.sh script): for every image under IN_DIR, build stills —
the original, each model style (transformer/.t7/magenta), every 2-model
50/50 blend, optionally the 'allfour' 25% composite — then assemble a
hold/crossfade slideshow (original → models → blends → original) with the
env-tunable holds, transition type and duration.

Stills render through the port's ``engine/pipeline.main`` on ``--device``
(``DEVICE``; ``cuda`` unless told ``cpu``, no GPU raises); the blends are
PIL and the transitions numpy (fade, dissolve, wipeleft, wiperight,
smoothleft, smoothright), as in the JAX app. Run it as
``python -m neuralstyletransferv1_torch.apps.morph_slideshow``.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import random
import sys

import numpy as np


def _transition_mask(kind, t, H, W, rng):
    """Per-frame blend weight map for the supported xfade kinds."""
    if kind == "dissolve":
        return (rng.random((H, W, 1)) < t).astype(np.float32)
    x = np.linspace(0, 1, W, dtype=np.float32)[None, :, None]
    if kind == "wipeleft":
        return (x < t).astype(np.float32)
    if kind == "wiperight":
        return (x > 1 - t).astype(np.float32)
    if kind == "smoothleft":
        return np.clip((t * 1.4 - x) * 6 + 0.5, 0, 1)
    if kind == "smoothright":
        return np.clip((t * 1.4 - (1 - x)) * 6 + 0.5, 0, 1)
    return np.full((1, 1, 1), t, np.float32)  # fade


def crossfade_frames(img_a, img_b, kind, num_frames, seed=0):
    rng = np.random.default_rng(seed)
    H, W = img_a.shape[:2]
    a = img_a.astype(np.float32)
    b = img_b.astype(np.float32)
    out = []
    for i in range(num_frames):
        t = (i + 1) / (num_frames + 1)
        m = _transition_mask(kind, t, H, W, rng)
        out.append((a * (1 - m) + b * m).astype(np.uint8))
    return out


def build_slideshow(stills, *, fps, hold_start, hold_end, hold_model, trans,
                    transition, seed=0):
    """original → models → blends → original with holds + transitions
    (reference: morph.sh:471-519, 640-740)."""
    frames = []
    holds = [hold_start] + [hold_model] * (len(stills) - 2) + [hold_end]
    for i, (img, hold) in enumerate(zip(stills, holds)):
        frames.extend([img] * int(hold * fps))
        if i < len(stills) - 1 and trans > 0:
            frames.extend(crossfade_frames(img, stills[i + 1], transition,
                                           int(trans * fps), seed + i))
    return frames


def _style_still(src_png, model_path, model_type, io_preset, scale, work,
                 magenta_style=None, magenta_root=None, target_res=None, device="cuda"):
    """One single-image call of the port's engine on ``device``."""
    from PIL import Image

    from ..engine.pipeline import main as pipeline_main

    outp = work / f"still_{pathlib.Path(str(model_path or magenta_style)).stem}.png"
    argv = [
        "--input_image", str(src_png), "--output_image", str(outp),
        "--model_type", model_type, "--io_preset", io_preset,
        "--scale", str(scale), "--no-smooth_lightness",
        "--work_dir", str(work / "_w"), "--device", device,
    ]
    if model_path:
        argv += ["--model", str(model_path)]
    if magenta_style:
        argv += ["--magenta_style", str(magenta_style)]
    if magenta_root:
        argv += ["--magenta_model_root", str(magenta_root)]
    if target_res:
        argv += ["--magenta_target_res", str(target_res)]
    try:
        rc = pipeline_main(argv)
    except SystemExit as e:
        rc = e.code or 0
    if rc == 0 and outp.exists():
        return np.asarray(Image.open(outp).convert("RGB"))
    print(f"[morph_slideshow][warn] still failed: {model_path or magenta_style}")
    return None


def process_image(image_path, out_dir, models, *, scale, fps, hold_start,
                  hold_end, hold_model, trans, transition, max_models,
                  randomize, max_combos, include_allfour, seed, work_root,
                  io_preset, magenta_root, device="cuda"):
    import itertools

    from PIL import Image

    from ..io.frames import write_mp4

    base = pathlib.Path(image_path).stem
    work = pathlib.Path(work_root) / base
    work.mkdir(parents=True, exist_ok=True)

    # seeded per-image selection (reference: morph.sh:28-31, 420-470)
    rng = random.Random(seed if seed is not None else base)
    pool = list(models)
    if randomize:
        rng.shuffle(pool)
    pool = pool[:max_models]

    pil = Image.open(image_path).convert("RGB")
    w0, h0 = pil.size
    s = scale / max(w0, h0)
    if s < 1.0:
        pil = pil.resize((int(w0 * s) // 2 * 2, int(h0 * s) // 2 * 2), Image.LANCZOS)
    orig = np.asarray(pil)
    src_png = work / "orig.png"
    pil.save(src_png)

    named = {}
    for tag, mpath, mtype, mstyle in pool:
        img = _style_still(src_png, mpath, mtype, io_preset, scale, work,
                           magenta_style=mstyle, magenta_root=magenta_root, device=device)
        if img is not None:
            if img.shape != orig.shape:
                img = np.asarray(Image.fromarray(img).resize(pil.size))
            named[tag] = img
    if not named:
        print(f"[morph_slideshow][skip] {base}: no stills")
        return None

    # 2-model 50/50 PIL blends (reference: :520-592)
    combos = list(itertools.combinations(sorted(named), 2))
    if randomize:
        rng.shuffle(combos)
    if max_combos > 0:
        combos = combos[:max_combos]
    blends = {
        f"{a}_{b}": np.asarray(
            Image.blend(Image.fromarray(named[a]), Image.fromarray(named[b]), 0.5))
        for a, b in combos
    }

    stills = [orig] + [named[k] for k in sorted(named)] + \
        [blends[k] for k in sorted(blends)]
    if include_allfour and len(named) >= 4:
        four = list(named.values())[:4]
        stills.append(np.mean(np.stack(four, 0), 0).astype(np.uint8))
    stills.append(orig)

    frames = build_slideshow(stills, fps=fps, hold_start=hold_start,
                             hold_end=hold_end, hold_model=hold_model,
                             trans=trans, transition=transition)
    outp = pathlib.Path(out_dir) / f"{base}_morph.mp4"
    write_mp4(outp, frames, fps)
    print(f"[morph_slideshow] {base}: {len(stills)} stills -> {outp.name} "
          f"({len(frames)} frames)")
    return outp


def main(argv=None) -> int:
    env = os.environ
    ap = argparse.ArgumentParser(description="Styled-stills crossfade slideshows")
    ap.add_argument("--in_dir", default=env.get("IN_DIR", "input"))
    ap.add_argument("--out_dir", default=env.get("OUT_DIR", "output"))
    ap.add_argument("--work_root", default=env.get("TMP", "_work/morph_sh"))
    ap.add_argument("--models", nargs="+", required=True,
                    help="model specs 'tag:path[:type]' or 'tag:magenta:<style.jpg>'")
    ap.add_argument("--io_preset", default="auto")
    ap.add_argument("--magenta_model_root", default=env.get("MAGENTA_STYLE_DIR", "models/magenta"))
    ap.add_argument("--scale", type=int, default=int(env.get("SCALE", 720)))
    ap.add_argument("--fps", type=int, default=int(env.get("FPS", 24)))
    ap.add_argument("--hold_orig_start", type=float, default=float(env.get("HOLD_ORIG_START", 1)))
    ap.add_argument("--hold_orig_end", type=float, default=float(env.get("HOLD_ORIG_END", 1)))
    ap.add_argument("--hold_model", type=float, default=float(env.get("HOLD_MODEL", 1)))
    ap.add_argument("--trans", type=float, default=float(env.get("TRANS", 1)))
    ap.add_argument("--transition", default=env.get("TRANSITION", "fade"))
    ap.add_argument("--max_models", type=int, default=int(env.get("MAX_MODELS", 20)))
    ap.add_argument("--randomize_models", type=int, default=int(env.get("RANDOMIZE_MODELS", 1)))
    ap.add_argument("--max_combos", type=int, default=int(env.get("MAX_COMBOS", 0)))
    ap.add_argument("--include_allfour", type=int, default=int(env.get("INCLUDE_ALLFOUR", 0)))
    ap.add_argument("--seed", default=env.get("RANDOM_SEED") or None)
    ap.add_argument("--device", choices=["cpu", "cuda"], default=env.get("DEVICE", "cuda"),
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    resolve_device(args.device)  # no GPU with --device cuda raises here

    models = []
    for spec in args.models:
        parts = spec.split(":")
        tag = parts[0]
        if len(parts) >= 2 and parts[1] == "magenta":
            models.append((tag, None, "magenta", parts[2]))
        else:
            path = parts[1]
            mtype = parts[2] if len(parts) > 2 else (
                "torch7" if path.endswith(".t7") else "transformer")
            models.append((tag, path, mtype, None))

    images = sorted(
        p for p in pathlib.Path(args.in_dir).iterdir()
        if p.suffix.lower() in (".jpg", ".jpeg", ".png")
    )
    if not images:
        print(f"[morph_slideshow] no images under {args.in_dir}")
        return 1
    pathlib.Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    done = 0
    for img in images:
        out = process_image(
            img, args.out_dir, models, scale=args.scale, fps=args.fps,
            hold_start=args.hold_orig_start, hold_end=args.hold_orig_end,
            hold_model=args.hold_model, trans=args.trans,
            transition=args.transition, max_models=args.max_models,
            randomize=bool(args.randomize_models), max_combos=args.max_combos,
            include_allfour=bool(args.include_allfour), seed=args.seed,
            work_root=args.work_root, io_preset=args.io_preset,
            magenta_root=args.magenta_model_root, device=args.device,
        )
        done += out is not None
    print(f"[morph_slideshow] {done}/{len(images)} slideshows")
    return 0 if done else 1


if __name__ == "__main__":
    sys.exit(main())
