"""run_videos — env→flags adapter between the planner and the pipeline engine.

Counterpart of ``neuralstyletransferv1_tpu/apps/run_videos.py``, with the
reference's env contract (reference: run_videos.py:39-274): MODEL_A..D
(+_TYPE), MAGENTA_STYLE(_B.._D), IO_PRESET(_A.._D), SCALE/FPS/PRE_FPS/BLEND,
FLOW_*, SMOOTH_*, MAX_FRAMES/STRIDE/JPEG_QUALITY, BLEND_*, free-form
PIPELINE_ARGS, model-dir resolution (PYTORCH_DIR/TORCH_DIR/
MAGENTA_STYLES_DIR) and the pytorch→transformer type mapping. ``DEVICE``
(``cuda`` unless told ``cpu``; no GPU raises) reaches the engine as
``--device``. The video goes through the port's ``engine.pipeline.main``
in process, not a subprocess per video (reference: run_videos.py:295).

    DEVICE=cpu MODEL_A=_testdata/test_johnson.pth python -m \
        neuralstyletransferv1_torch.apps.run_videos in.mp4
"""

from __future__ import annotations

import os
import pathlib
import shlex
import sys


def getenv(name, default=None):
    v = os.getenv(name)
    return v if v is not None and v != "" else default


def getbool(name, default=False):
    v = os.getenv(name)
    if v is None:
        return default
    return v.lower() in {"1", "true", "yes", "on"}


def canonical_model_type(t):
    t = (t or "").lower()
    return "transformer" if t == "pytorch" else t


def resolve_nonmagenta_model(path_or_name, model_type):
    p = pathlib.Path(path_or_name)
    if p.is_absolute():
        return str(p)
    mt = canonical_model_type(model_type)
    pytorch_dir = getenv("PYTORCH_DIR", "/app/models/pytorch")
    torch_dir = getenv("TORCH_DIR", "/app/models/torch")
    transformer_dir = getenv("TRANSFORMER_DIR", "/app/models/transformers")
    if mt in {"pytorch", "transformer"}:
        return str(pathlib.Path(pytorch_dir) / (path_or_name if p.suffix else f"{path_or_name}.pth"))
    if mt == "torch7":
        return str(pathlib.Path(torch_dir) / (path_or_name if p.suffix else f"{path_or_name}.t7"))
    if mt == "reconet":
        return str(pathlib.Path(transformer_dir) / path_or_name)
    return str(p)


def resolve_magenta_style(style_name):
    if not style_name:
        return None
    p = pathlib.Path(style_name)
    styles_dir = getenv("MAGENTA_STYLES_DIR", "/app/models/magenta_styles")
    return str(p if p.is_absolute() else pathlib.Path(styles_dir) / style_name)


def _add_slot(cmd, slot_suffix, model_val, model_type, magenta_style, io_preset):
    """(reference: run_videos.py:115-142)"""
    if not (model_val or model_type or magenta_style):
        return
    t = canonical_model_type(model_type)
    if t == "magenta":
        cmd += [f"--model{slot_suffix}", "magenta", f"--model{slot_suffix}_type", "magenta"]
        sty_flag = "--magenta_style" if slot_suffix == "" else f"--magenta_style{slot_suffix}"
        resolved = resolve_magenta_style(magenta_style)
        if resolved:
            cmd += [sty_flag, resolved]
    else:
        if not model_val:
            return
        cmd += [f"--model{slot_suffix}", resolve_nonmagenta_model(model_val, t),
                f"--model{slot_suffix}_type", t]
    if io_preset:
        flag = "--io_preset" if slot_suffix == "" else f"--io_preset{slot_suffix}"
        cmd += [flag, io_preset]


def build_pipeline_args(video_path: str) -> list[str]:
    """(reference: run_videos.py:144-274)"""
    out_dir = getenv("OUT_DIR", "/app/output")
    stem = pathlib.Path(video_path).stem
    output_suffix = getenv("OUTPUT_SUFFIX", "")
    output_video = str(pathlib.Path(out_dir) / f"{stem}{output_suffix}.mp4")

    cmd = [
        "--input_video", video_path,
        "--output_video", output_video,
        "--scale", str(getenv("SCALE", "720")),
        "--fps", str(getenv("FPS", "24")),
        "--blend", str(getenv("BLEND", "0.9")),
        "--flow_method", getenv("FLOW_METHOD", "dis"),
        "--flow_downscale", str(getenv("FLOW_DOWNSCALE", "1")),
    ]
    if getenv("PRE_FPS"):
        cmd += ["--pre_fps", str(getenv("PRE_FPS"))]
    if getbool("SMOOTH_LIGHTNESS", False):
        cmd += ["--smooth_lightness"]
    else:
        cmd += ["--no-smooth_lightness"]
    if getenv("SMOOTH_ALPHA", "0.65") is not None:
        cmd += ["--smooth_alpha", str(getenv("SMOOTH_ALPHA", "0.65"))]
    if getbool("SMOOTH_CHROMA", False):
        cmd += ["--smooth_chroma"]
    if getenv("CHROMA_ALPHA"):
        cmd += ["--chroma_alpha", str(getenv("CHROMA_ALPHA"))]
    if getbool("FLOW_EMA", False):
        cmd += ["--flow_ema", "--flow_alpha", str(getenv("FLOW_ALPHA", "0.7"))]
    for env, flag in [
        ("MAX_FRAMES", "--max_frames"),
        ("STRIDE", "--stride"),
        ("JPEG_QUALITY", "--jpeg_quality"),
        ("MAGENTA_TILE", "--magenta_tile"),
        ("MAGENTA_OVERLAP", "--magenta_overlap"),
        ("MAGENTA_TARGET_RES", "--magenta_target_res"),
        ("MAGENTA_MODEL_ROOT", "--magenta_model_root"),
        ("IMAGE_EXT", "--image_ext"),
    ]:
        if getenv(env):
            cmd += [flag, str(getenv(env))]
    if getbool("CLEAN_FRAMES", False):
        cmd += ["--clean_frames"]
    if getenv("BLEND_WEIGHTS"):
        cmd += ["--blend_models_weights", getenv("BLEND_WEIGHTS")]
    if getbool("BLEND_MODELS_LAB", False):
        cmd += ["--blend_models_lab"]
    if getenv("BLEND_MODELS_LAB_WEIGHTS"):
        cmd += ["--blend_models_lab_weights", getenv("BLEND_MODELS_LAB_WEIGHTS")]
    if getbool("MOTION_BLEND", False):
        cmd += ["--motion_blend"]
    if getenv("PIPELINE_ARGS"):
        cmd += shlex.split(getenv("PIPELINE_ARGS"))
    cmd += ["--device", getenv("DEVICE", "cuda")]

    io_global = getenv("IO_PRESET")
    _add_slot(cmd, "", getenv("MODEL_A"), getenv("MODEL_A_TYPE"), getenv("MAGENTA_STYLE"),
              getenv("IO_PRESET_A", io_global))
    _add_slot(cmd, "_b", getenv("MODEL_B"), getenv("MODEL_B_TYPE"), getenv("MAGENTA_STYLE_B"),
              getenv("IO_PRESET_B"))
    _add_slot(cmd, "_c", getenv("MODEL_C"), getenv("MODEL_C_TYPE"), getenv("MAGENTA_STYLE_C"),
              getenv("IO_PRESET_C"))
    _add_slot(cmd, "_d", getenv("MODEL_D"), getenv("MODEL_D_TYPE"), getenv("MAGENTA_STYLE_D"),
              getenv("IO_PRESET_D"))
    return cmd


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: run_videos.py <video_path>")
        return 2
    from ..device import resolve_device

    resolve_device(getenv("DEVICE", "cuda"))  # no GPU with DEVICE=cuda raises here
    args = build_pipeline_args(argv[0])
    print("[run]", " ".join(shlex.quote(x) for x in args))
    from ..engine.pipeline import main as pipeline_main

    return pipeline_main(args)


if __name__ == "__main__":
    sys.exit(main())
