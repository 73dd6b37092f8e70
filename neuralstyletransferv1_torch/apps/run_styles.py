"""run_styles — fixed 4-slot env-driven batch styling over input videos.

Counterpart of ``neuralstyletransferv1_tpu/apps/run_styles.py``, a port of
the reference's run_styles.sh (a Python script despite the name, reference:
run_styles.sh:1-376): per video under IN_DIR, one engine invocation with up
to four slots (MODEL_A..D / *_TYPE / IO_PRESET_* / MAGENTA_STYLE_*),
USE_B/C/D toggles, random slot selection from the model pools when a slot
is unset, BLEND_WEIGHTS / RANDOM_WEIGHTS / LAB blending, smoothing and flow
env knobs. ``DEVICE`` (``cuda`` unless told ``cpu``; no GPU raises)
reaches the engine as ``--device``. Each video calls the port's
``engine.pipeline.main`` in process (reference: :317-376 spawns
pipeline.py).

    DEVICE=cpu IN_DIR=videos OUT_DIR=out PYTORCH_DIR=models python -m \
        neuralstyletransferv1_torch.apps.run_styles
"""

from __future__ import annotations

import os
import pathlib
import random
import sys

from ..device import resolve_device


def _getbool(name, default="0"):
    return os.getenv(name, default) == "1"


def generate_blend_weights(num_models, blend_weights_env, random_weights, rng):
    """(reference: run_styles.sh:100-118)"""
    if blend_weights_env:
        weights = [float(w) for w in blend_weights_env.split(",")]
        if len(weights) != num_models:
            raise ValueError(f"BLEND_WEIGHTS must have {num_models} values, got {len(weights)}")
        if abs(sum(weights) - 1.0) > 1e-6:
            raise ValueError(f"BLEND_WEIGHTS must sum to 1.0, got {sum(weights):.6f}")
        return weights
    if random_weights:
        weights = [rng.random() for _ in range(num_models)]
        total = sum(weights)
        weights = [round(w / total, 3) for w in weights]
        if num_models > 1:
            weights[-1] = round(1.0 - sum(weights[:-1]), 3)
        return weights
    return [1.0 / num_models] * num_models


def main(argv=None) -> int:
    env = os.environ
    in_dir = pathlib.Path(env.get("IN_DIR", "/app/input_videos"))
    out_dir = pathlib.Path(env.get("OUT_DIR", "/app/output"))
    work_root = pathlib.Path(env.get("WORK_ROOT", "/app/_work"))
    pytorch_dir = pathlib.Path(env.get("PYTORCH_DIR", "/app/models/pytorch"))
    torch_dir = pathlib.Path(env.get("TORCH_DIR", "/app/models/torch"))
    magenta_dir = env.get("MAGENTA_DIR", "/app/models/magenta")
    styles_dir = pathlib.Path(env.get("MAGENTA_STYLES_DIR", "/app/models/magenta_styles"))

    scale = env.get("SCALE", "720")
    fps = env.get("FPS", "24")
    pre_fps = env.get("PRE_FPS", "")
    img_ext = env.get("IMG_EXT", "jpg")
    jpeg_quality = env.get("JPEG_QUALITY", "85")
    blend = env.get("BLEND", "1.0")
    smooth_light = _getbool("SMOOTH_LIGHTNESS", "1")
    smooth_alpha = env.get("SMOOTH_ALPHA", "0.7")
    flow_ema = _getbool("FLOW_EMA")
    flow_alpha = env.get("FLOW_ALPHA", "0.85")
    flow_method = env.get("FLOW_METHOD", "dis")
    flow_downscale = env.get("FLOW_DOWNSCALE", "1")
    max_frames = env.get("MAX_FRAMES", "")
    extra = env.get("PIPELINE_ARGS", "")
    device = env.get("DEVICE", "cuda")
    resolve_device(device)  # no GPU with DEVICE=cuda raises here

    io_a = env.get("IO_PRESET_A", "imagenet_255")
    ios = {"b": env.get("IO_PRESET_B", io_a), "c": env.get("IO_PRESET_C", io_a),
           "d": env.get("IO_PRESET_D", io_a)}
    types = {s: env.get(f"MODEL_{s.upper()}_TYPE",
                        "magenta" if s == "d" else "transformer")
             for s in "abcd"}
    names = {s: env.get(f"MODEL_{s.upper()}", "") for s in "abcd"}
    mstyles = {s: env.get("MAGENTA_STYLE" + ("" if s == "a" else f"_{s.upper()}"), "")
               for s in "abcd"}
    use = {"b": _getbool("USE_B", "1"), "c": _getbool("USE_C", "1"),
           "d": _getbool("USE_D", "1")}

    rng = random.Random(int(env["SEED"])) if env.get("SEED") else random.Random()

    pools = {
        "transformer": sorted(pytorch_dir.glob("*.pth")),
        "torch7": sorted(torch_dir.glob("*.t7")),
        "magenta": sorted(styles_dir.glob("*.jpg")),
    }

    def resolve(slot):
        """Slot env → (model_path, style_path) or (None, None) if empty
        (reference pool fallback: run_styles.sh:180-260)."""
        t = types[slot]
        if t == "magenta":
            style = mstyles[slot]
            if style:
                p = pathlib.Path(style)
                return None, str(p if p.is_absolute() else styles_dir / style)
            if pools["magenta"]:
                return None, str(rng.choice(pools["magenta"]))
            return None, None
        name = names[slot]
        if name:
            p = pathlib.Path(name)
            root = pytorch_dir if t == "transformer" else torch_dir
            return str(p if p.is_absolute() else root / name), None
        if pools[t]:
            return str(rng.choice(pools[t])), None
        return None, None

    videos = sorted(p for p in in_dir.glob("*") if p.suffix.lower() in (".mp4", ".mov"))
    if not videos:
        print(f"[run_styles] no videos under {in_dir}")
        return 1
    out_dir.mkdir(parents=True, exist_ok=True)

    from ..engine.pipeline import main as pipeline_main

    done = 0
    for vid in videos:
        m_a, style_a = resolve("a")
        slots = []
        for s in "bcd":
            if not use[s]:
                slots.append((s, None, None))
                continue
            slots.append((s, *resolve(s)))
        active = [(s, m, st) for s, m, st in slots if m or st]
        num_models = 1 + len(active)
        weights = generate_blend_weights(
            num_models, env.get("BLEND_WEIGHTS", ""), _getbool("RANDOM_WEIGHTS"), rng)
        weight_str = ",".join(f"{w:.3f}" for w in weights)

        outp = out_dir / f"{vid.stem}_styled_{num_models}m_w-{weight_str}.mp4"
        work = work_root / vid.stem
        argv_v = [
            "--model_type", types["a"],
            "--io_preset", io_a, "--blend", blend,
            "--input_video", str(vid), "--output_video", str(outp),
            "--work_dir", str(work),
            "--image_ext", img_ext, "--jpeg_quality", jpeg_quality,
            "--scale", scale, "--fps", fps,
            "--smooth_alpha", smooth_alpha,
            "--flow_method", flow_method, "--flow_downscale", flow_downscale,
            "--magenta_model_root", magenta_dir, "--device", device,
        ]
        if m_a:
            argv_v += ["--model", m_a]
        if types["a"] == "magenta" and style_a:
            argv_v += ["--magenta_style", style_a]
        if pre_fps:
            argv_v += ["--pre_fps", pre_fps]
        if max_frames:
            argv_v += ["--max_frames", max_frames]
        if not smooth_light:
            argv_v += ["--no-smooth_lightness"]
        if flow_ema:
            argv_v += ["--flow_ema", "--flow_alpha", flow_alpha]
        for s, m, st in active:
            argv_v += [f"--model_{s}_type", types[s], f"--io_preset_{s}", ios[s]]
            if m:
                argv_v += [f"--model_{s}", m]
            if st:
                argv_v += [f"--magenta_style_{s}", st]
        if num_models > 1:
            argv_v += ["--blend_models_weights", weight_str]
            if _getbool("BLEND_LAB"):
                argv_v += ["--blend_models_lab", "--blend_models_lab_weights",
                           env.get("BLEND_LAB_WEIGHTS", "0.5,0.5")]
        if extra:
            import shlex

            argv_v += shlex.split(extra)

        print(f"[run_styles] {vid.name} -> {outp.name} ({num_models} slots)")
        try:
            rc = pipeline_main(argv_v)
        except SystemExit as e:
            rc = e.code or 0
        done += rc == 0
    print(f"[run_styles] {done}/{len(videos)} videos styled")
    return 0 if done else 1


if __name__ == "__main__":
    sys.exit(main())
