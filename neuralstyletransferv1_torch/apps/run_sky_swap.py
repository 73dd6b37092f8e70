"""run_sky_swap — the masked-stylization video workflow.

Counterpart of ``neuralstyletransferv1_tpu/apps/run_sky_swap.py``, the same
environment contract in the same order: extract frames on a fixed canvas →
DeepLab masks (per label group: person / vehicle with ``STYLE_BY_LABEL``,
else ``MASK_TARGET_LABELS`` or the scan-sky guess) → with
``STYLE_BY_LABEL``, a BASE pass styling the whole frame (skipped with
``BASE_AS_ORIGINAL=1``) → one ``engine/pipeline.main`` pass per group with
``--mask_dir`` and the group's ``--mask_invert``, each on the previous
pass's output. ``PIPELINE_ARGS`` is appended to every group pass.

``DEVICE`` (default ``cuda``; ``cpu`` for an explicit CPU run) reaches the
segmentation model and every pipeline pass as ``--device``. Run it as
``python -m neuralstyletransferv1_torch.apps.run_sky_swap``.
"""

from __future__ import annotations

import os
import pathlib
import shlex
import shutil
import sys


def getenv(name, default=None):
    v = os.getenv(name)
    return v if v is not None and v != "" else default


def getbool(name, default=False):
    v = os.getenv(name)
    if v is None:
        return default
    return v.lower() in {"1", "true", "yes", "on"}


def main(argv=None) -> int:
    input_video = getenv("INPUT_VIDEO", "/app/input_videos/input.mp4")
    output_video = getenv("OUTPUT_VIDEO")
    style_model = getenv("STYLE_MODEL", "/app/models/pytorch/mosaic.pth")
    style_model_type = getenv("STYLE_MODEL_TYPE", "transformer")
    io_preset = getenv("IO_PRESET", "auto")
    weights = getenv("DEEPLAB_WEIGHTS", "/app/models/deeplab/deeplab-resnet.pth.tar")
    fps = getenv("FPS", "24")
    canvas_w = int(getenv("CANVAS_W", "1920"))
    canvas_h = int(getenv("CANVAS_H", "1080"))
    infer_res = getenv("INFER_RES", "1280")
    work_root = pathlib.Path(getenv("WORK_ROOT", "./_work_skyswap")).resolve()
    out_dir = pathlib.Path(getenv("OUT_DIR", "./output")).resolve()
    device_name = getenv("DEVICE", "cuda")

    mask_res = getenv("MASK_RES", "512")
    mask_expand_pct = getenv("MASK_EXPAND_PCT", "3.0")
    mask_feather_pct = getenv("MASK_FEATHER_PCT", "3.0")
    mask_target_labels = getenv("MASK_TARGET_LABELS")
    scan_sky = getbool("SCAN_SKY", mask_target_labels is None)

    style_by_label = getbool("STYLE_BY_LABEL", False)
    base_as_original = getbool("BASE_AS_ORIGINAL", False)
    mask_invert = getbool("MASK_INVERT", True)

    from ..device import resolve_device

    device = resolve_device(device_name)  # no GPU with DEVICE=cuda raises here
    frames_dir = work_root / "frames"
    masks_dir = work_root / "masks"
    if frames_dir.exists():
        shutil.rmtree(frames_dir)
    frames_dir.mkdir(parents=True, exist_ok=True)
    out_dir.mkdir(parents=True, exist_ok=True)

    # 1/3 extract on the fixed canvas
    from ..io.frames import extract_frames

    print(f"[1/3] extract {input_video} → {frames_dir} (canvas {canvas_w}x{canvas_h})")
    extract_frames(
        pathlib.Path(input_video), frames_dir, int(fps) if fps else None, None,
        "png", 85, (canvas_w, canvas_h),
        int(getenv("MAX_FRAMES", "0")) or None,
    )

    # 2/3 masks
    from .sky_swap import SegmentationModel, batch_masks_from_frames, guess_sky_id, load_deeplab, lookup_label_ids

    params, nc, bb = load_deeplab(weights, getenv("BACKBONE", "auto"))
    model = SegmentationModel(params, nc, bb, device=device)

    def gen_masks(label_csv: str | None, dst: pathlib.Path, use_scan: bool):
        target_ids = None
        sky_id = 10
        if label_csv:
            target_ids = lookup_label_ids(label_csv.replace("|", ",").split(","), nc)
        elif use_scan:
            from PIL import Image

            first = sorted(frames_dir.glob("frame_*.png"))[0]
            im = Image.open(first).convert("RGB")
            w, h = im.size
            s = int(mask_res) / max(w, h)
            if s < 1.0:
                im = im.resize((int(w * s), int(h * s)), Image.LANCZOS)
            sky_id, _, _ = guess_sky_id(model, im, nc)
        batch_masks_from_frames(
            frames_dir, dst, model, sky_id,
            expand_pct=float(mask_expand_pct), feather_pct=float(mask_feather_pct),
            resolution=int(mask_res), target_ids=target_ids,
            debug_overlay=getbool("MASK_DEBUG_OVERLAY", False),
        )

    if style_by_label:
        person_labels = getenv("PERSON_LABELS", "person")
        vehicle_labels = getenv("VEHICLE_LABELS", "bicycle,motorbike")
        person_model = getenv("PERSON_MODEL") or style_model
        vehicle_model = getenv("VEHICLE_MODEL") or style_model
        pm_dir, vm_dir = work_root / "masks_person", work_root / "masks_vehicle"
        print(f"[2/3] masks: person={person_labels} vehicle={vehicle_labels}")
        gen_masks(person_labels, pm_dir, False)
        gen_masks(vehicle_labels, vm_dir, False)
        groups = [
            ("person", person_model, getenv("PERSON_MODEL_TYPE", "transformer"), pm_dir,
             getbool("PERSON_MASK_INVERT", True)),
            ("vehicle", vehicle_model, getenv("VEHICLE_MODEL_TYPE", "transformer"), vm_dir,
             getbool("VEHICLE_MASK_INVERT", True)),
        ]
    else:
        print(f"[2/3] masks: labels={mask_target_labels or ('scan_sky' if scan_sky else 'sky_id=10')}")
        gen_masks(mask_target_labels, masks_dir, scan_sky)
        groups = [("masked", style_model, style_model_type, masks_dir, mask_invert)]

    # 3/3 stylize per group
    from ..engine.pipeline import main as pipeline_main

    stem = pathlib.Path(input_video).stem
    current_input = pathlib.Path(input_video)
    base_model = getenv("BASE_MODEL")
    if style_by_label and not base_as_original:
        base = base_model or style_model
        base_out = out_dir / f"{stem}_base.mp4"
        print(f"[3/3] BASE pass: {base}")
        rc = pipeline_main([
            "--input_video", str(current_input), "--output_video", str(base_out),
            "--model", base, "--model_type", getenv("BASE_MODEL_TYPE", "transformer"),
            "--io_preset", io_preset, "--fps", fps, "--canvas", f"{canvas_w}x{canvas_h}",
            "--inference_res", infer_res, "--work_dir", str(work_root / "_base"),
            "--device", device_name,
        ])
        if rc != 0:
            return rc
        current_input = base_out

    final_out = pathlib.Path(output_video) if output_video else out_dir / f"{stem}_skyswap.mp4"
    for i, (name, model_path, model_type, mdir, invert) in enumerate(groups):
        is_last = i == len(groups) - 1
        outp = final_out if is_last else out_dir / f"{stem}_{name}.mp4"
        print(f"[3/3] group '{name}': model={model_path} mask_dir={mdir} invert={invert}")
        cmd = [
            "--input_video", str(current_input), "--output_video", str(outp),
            "--model", str(model_path), "--model_type", model_type,
            "--io_preset", io_preset, "--fps", fps, "--canvas", f"{canvas_w}x{canvas_h}",
            "--inference_res", infer_res, "--mask_dir", str(mdir),
            "--work_dir", str(work_root / f"_g{i}"), "--device", device_name,
        ]
        if invert:
            cmd.append("--mask_invert")
        if getenv("MAX_FRAMES"):
            cmd += ["--max_frames", getenv("MAX_FRAMES")]
        extra = getenv("PIPELINE_ARGS")
        if extra:
            cmd += shlex.split(extra)
        rc = pipeline_main(cmd)
        if rc != 0:
            return rc
        current_input = outp
    print(f"[done] {final_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
