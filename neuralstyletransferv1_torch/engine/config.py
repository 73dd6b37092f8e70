"""CLI flag surface of the PyTorch port: the same flags, choices and
defaults as the JAX engine's ``engine/config.py``, of which this is a copy
(the port imports nothing of the JAX package). ``pipeline.build_parser``
sets ``--device`` to default to cuda; ``pipeline.check_supported`` raises
for the flags whose paths are not ported yet.
"""

from __future__ import annotations

import argparse

MODEL_TYPES = ["transformer", "torch7", "magenta", "reconet"]
IO_PRESET_CHOICES = ["auto", "raw_255", "raw_01", "imagenet_255", "imagenet_01", "tanh", "caffe_bgr"]


def _add_slot(ap: argparse.ArgumentParser, letter: str):
    l = letter.lower()
    ap.add_argument(f"--model_{l}", type=str, default=None)
    ap.add_argument(f"--model_{l}_type", choices=MODEL_TYPES, default="transformer")
    ap.add_argument(f"--io_preset_{l}", choices=IO_PRESET_CHOICES, default="auto")
    ap.add_argument(f"--magenta_style_{l}", type=str, default=None)


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Extract → Style → Assemble (with temporal smoothing) — PyTorch/CUDA engine"
    )
    ap.add_argument("--input_video", default=None)
    ap.add_argument("--output_video", default=None)
    ap.add_argument("--model", default=None)
    ap.add_argument("--work_dir", default="./_work")
    ap.add_argument("--fps", type=int, default=None)
    ap.add_argument("--pre_fps", type=int, default=None)
    ap.add_argument("--scale", type=int, default=None)
    ap.add_argument("--canvas", type=str, default=None)
    ap.add_argument("--image_ext", choices=["png", "jpg"], default="png")
    ap.add_argument("--jpeg_quality", type=int, default=85)
    ap.add_argument("--threads", type=int, default=4)  # accepted, XLA owns threading
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--device", choices=["cpu", "mps", "cuda", "tpu"], default="tpu")
    ap.add_argument("--gpu_memory_limit", type=int, default=32000)  # accepted, unused
    ap.add_argument("--inference_res", type=int, default=0)
    ap.add_argument("--io_preset", choices=IO_PRESET_CHOICES, default="auto")
    # image modes
    ap.add_argument("--input_image", type=str)
    ap.add_argument("--output_image", type=str)
    ap.add_argument("--input_dir", type=str)
    ap.add_argument("--output_dir", type=str)
    ap.add_argument("--pattern", type=str, default=None)
    ap.add_argument("--keep_ext", action="store_true")
    ap.add_argument("--output_suffix", type=str, default="")
    ap.add_argument("--output_prefix", type=str, default="styled_frame")
    # temporal smoothing
    ap.add_argument("--smooth_lightness", action="store_true", default=True)
    ap.add_argument("--no-smooth_lightness", action="store_false", dest="smooth_lightness")
    ap.add_argument("--smooth_alpha", type=float, default=0.7)
    ap.add_argument("--smooth_chroma", action="store_true", default=False)
    ap.add_argument("--chroma_alpha", type=float, default=0.85)
    ap.add_argument("--blend", type=float, default=1.0)
    # masks
    ap.add_argument("--mask", type=str, default=None)
    ap.add_argument("--mask_invert", action="store_true")
    ap.add_argument("--mask_feather", type=int, default=0)
    ap.add_argument("--mask_dir", type=str, default=None)
    ap.add_argument("--mask_feather_pct", type=float, default=0.0)
    ap.add_argument("--mask_autofix", action="store_true", default=True)
    ap.add_argument("--mask_force_transpose", action="store_true")
    ap.add_argument("--mask_debug_overlay", action="store_true")
    ap.add_argument("--mask_debug_alpha", action="store_true")
    ap.add_argument("--fit_mask_to", choices=["input", "output"], default="input")
    ap.add_argument("--composite_mode", choices=["keep", "replace"], default="keep")
    # flow
    ap.add_argument("--flow_ema", action="store_true", default=False)
    ap.add_argument("--flow_alpha", type=float, default=0.85)
    ap.add_argument("--flow_method", choices=["farneback", "dis"], default="dis")
    # Deviation from the reference's fixed default 1 (pipeline.py:2232):
    # 0 = auto — flow computes at half resolution when the frame is large
    # enough to keep the full DIS pyramid depth (min dim >= 512). Measured:
    # ds2 flow passes the full-res cv2 oracle at 0.26-0.36 px mean vs the
    # 0.5 px bound (tests/test_dis_flow.py::test_dis_ds2_close_to_cv2)
    # while costing ~1/6 of full-res DIS @1080p (PERF.md round-4). The
    # orchestration apps still pass the reference's env default 1.
    ap.add_argument("--flow_downscale", type=int, default=0)
    # Deviation knob (ADVICE round-4): the batched/sharded temporal chain
    # defaults to the corner-packed bf16 warp (2.3x faster, bounded drift —
    # temporal.ema docstring). --exact_warp recovers bit-parity with the
    # per-frame/reference warp on those paths.
    ap.add_argument("--exact_warp", action="store_true", default=False)
    # slot A type + slots B..H
    ap.add_argument("--model_type", choices=MODEL_TYPES, default="transformer")
    for letter in "bcdefgh":
        _add_slot(ap, letter)
    ap.add_argument("--blend_models_weights", type=str, default=None)
    ap.add_argument("--blend_models_lab", action="store_true", default=False)
    ap.add_argument("--blend_models_lab_weights", type=str, default=None)
    # regions
    ap.add_argument("--region_mode", type=str, default=None)
    ap.add_argument("--region_count", type=int, default=None)
    ap.add_argument("--region_sizes", type=str, default=None)
    ap.add_argument("--region_seed", type=str, default=None)
    ap.add_argument("--region_feather", type=int, default=20)
    ap.add_argument("--region_assignment", type=str, default="random")
    ap.add_argument("--region_original", type=float, default=0.0)
    ap.add_argument("--region_rotate", type=float, default=0.0)
    ap.add_argument("--region_blend_spec", type=str, default=None)
    ap.add_argument("--region_scales", type=str, default=None)
    ap.add_argument("--region_optimize", action="store_true", default=False)
    ap.add_argument("--region_padding", type=int, default=64)
    ap.add_argument("--blend_animate", type=str, default=None)
    ap.add_argument("--blend_animate_regions", type=str, default=None)
    ap.add_argument("--scale_animate", type=str, default=None)
    ap.add_argument("--scale_animate_regions", type=str, default=None)
    ap.add_argument("--region_morph", type=str, default=None)
    # magenta
    ap.add_argument("--magenta_style", type=str, default=None)
    ap.add_argument("--magenta_model_root", type=str, default="/app/models/magenta")
    ap.add_argument("--magenta_tile", type=int, default=256)
    ap.add_argument("--magenta_overlap", type=int, default=32)
    ap.add_argument("--magenta_target_res", type=int, default=None)
    # motion / cleanup
    ap.add_argument("--motion_blend", action="store_true", default=False)
    ap.add_argument("--clean_frames", action="store_true")
    ap.add_argument("--clean_work_dir", action="store_true", default=False)
    # engine additions
    ap.add_argument("--compute_dtype", choices=["float32", "bfloat16"], default="float32",
                    help="bfloat16 runs weights and activations in bf16 (parity path is float32).")
    ap.add_argument("--profile_dir", type=str, default=None,
                    help="Write a profiler trace of the styling loop here "
                    "(not ported yet).")
    ap.add_argument("--frame_batch", type=int, default=1,
                    help="Process video frames in device batches of this size: "
                    "stylize runs batched and the temporal chain runs as one "
                    "in-graph scan per batch. Region modes fall back to "
                    "per-frame processing.")
    ap.add_argument("--quantize",
                    choices=["none", "int8", "bf16_static", "int8_static"],
                    default="none",
                    help="int8: Johnson slots run the res and deconv1/2 "
                    "convs as per-out-channel int8 convs on hand-written "
                    "CUDA kernels, calibrated on the first frame. "
                    "bf16_static / int8_static: additionally freeze every "
                    "instance norm to the first frame's statistics. "
                    "Static modes trade per-frame adaptivity for speed; "
                    "quality depends on how stationary the video's "
                    "statistics are. Needs --compute_dtype bfloat16.")
    ap.add_argument("--stream", choices=["auto", "off"], default="auto",
                    help="Video jobs with --frame_batch stream decode → "
                    "device → encode with NO per-frame files (threaded "
                    "overlap of video IO with device compute; same fps "
                    "select/scale/resample math as extract+assemble). "
                    "'off' restores the extract → frame files → assemble "
                    "flow, e.g. to keep intermediate frames in the work dir.")
    ap.add_argument("--mesh_devices", type=int, default=0,
                    help="Shard each stylize batch across the first N devices "
                    "(data-parallel over a 1-D ICI mesh; params replicate). "
                    "Requires --frame_batch; the batch is rounded up to a "
                    "multiple of N. 0/1 = single device. Temporal smoothing "
                    "(flow/LAB EMA) then runs CHUNKED: each device scans its "
                    "local time chunk seeded by its neighbor's boundary frame "
                    "over the ICI ring — chunk seams restart the EMA one "
                    "frame back (error decays like (1-alpha)^t into the "
                    "chunk).")
    return ap
