"""generate_mask_samples — before/mask/after comparison sheets per class.

Counterpart of ``neuralstyletransferv1_tpu/apps/generate_mask_samples.py``:
for each sample config, a DeepLab mask of the target VOC class ids (the
port's ``apps/sky_swap``), a stylize through ``engine/pipeline.main``'s
``--mask`` path, an original|mask|styled comparison sheet, a preset JSON
and a metadata index.

DeepLab and the engine run on ``--device`` (``cuda`` unless told ``cpu``;
no GPU raises), in process. Run it as
``python -m neuralstyletransferv1_torch.apps.generate_mask_samples``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

VOC21_CLASSES = {
    "background": 0, "aeroplane": 1, "bicycle": 2, "bird": 3, "boat": 4,
    "bottle": 5, "bus": 6, "car": 7, "cat": 8, "chair": 9,
    "cow": 10, "diningtable": 11, "dog": 12, "horse": 13,
    "motorbike": 14, "person": 15, "pottedplant": 16, "sheep": 17,
    "sofa": 18, "train": 19, "tvmonitor": 20,
}

# Default sample configs mirror the reference's MASK_SAMPLES table
# (generate_mask_samples.py:54-225): per input photo, one config per class.
DEFAULT_SAMPLES = [
    {"input_prefix": "bike-dog-person", "target_ids": "15", "invert": False,
     "name": "person_styled", "description": "Style the person only",
     "preset_name": "Mask: Style Person", "tags": ["person", "semantic", "mask"]},
    {"input_prefix": "bike-dog-person", "target_ids": "12", "invert": True,
     "name": "dog_protected", "description": "Keep dog original, style everything else",
     "preset_name": "Mask: Protect Dog", "tags": ["dog", "invert", "mask"]},
    {"input_prefix": "cat-sheep-plant", "target_ids": "8", "invert": False,
     "name": "cat_styled", "description": "Style the cat only",
     "preset_name": "Mask: Style Cat", "tags": ["cat", "mask"]},
    {"input_prefix": "cat-sheep-plant", "target_ids": "8,17", "invert": False,
     "name": "animals_styled", "description": "Style cat and sheep together",
     "preset_name": "Mask: Style Animals", "tags": ["cat", "sheep", "mask"]},
]


def generate_deeplab_mask(input_image, target_ids, output_mask, *, weights,
                          backbone="auto", resolution=513, feather_pct=1.0, device="cpu"):
    """The sky_swap mask of ``target_ids`` at a working resolution on
    ``device``, upsampled back to the input size and saved; returns the
    share of the mask above 127."""
    from PIL import Image

    from .sky_swap import SegmentationModel, infer_mask, load_deeplab

    params, num_classes, backbone = load_deeplab(weights, backbone=backbone)
    seg = SegmentationModel(params, num_classes, backbone, device=device)
    pil = Image.open(input_image).convert("RGB")
    w0, h0 = pil.size
    if max(w0, h0) > resolution:
        r = resolution / max(w0, h0)
        work = pil.resize((max(1, int(w0 * r)), max(1, int(h0 * r))), Image.LANCZOS)
    else:
        work = pil
    ids = [int(t) for t in str(target_ids).split(",")]
    mask = infer_mask(seg, work, target_ids=ids,
                      feather_px=max(1, int(work.height * feather_pct / 100)))
    mask_img = Image.fromarray(mask).resize((w0, h0), Image.BILINEAR)
    mask_img.save(output_mask)
    return float((np.asarray(mask_img) > 127).mean())


def apply_style(input_image, output_image, mask, style, *, invert, work_dir, scale=720,
                device="cuda"):
    """The engine's --mask composite of one image on ``device``."""
    from ..engine.pipeline import main as pipeline_main

    argv = [
        "--input_image", str(input_image), "--output_image", str(output_image),
        "--mask", str(mask), "--work_dir", str(work_dir), "--scale", str(scale),
        "--model", style["model"], "--model_type", style.get("type", "transformer"),
        "--io_preset", style.get("io", "auto"), "--mask_feather_pct", "1.0",
        "--device", str(device),
    ]
    if invert:
        argv.append("--mask_invert")
    try:
        rc = pipeline_main(argv)
    except SystemExit as e:
        rc = e.code or 0
    return rc == 0 and pathlib.Path(output_image).exists()


def create_comparison_image(original, mask, styled, output):
    """original | mask | styled strip."""
    from PIL import Image

    imgs = [Image.open(p).convert("RGB") for p in (original, mask, styled)]
    h = min(im.height for im in imgs)
    imgs = [im.resize((int(im.width * h / im.height), h)) for im in imgs]
    sheet = Image.new("RGB", (sum(im.width for im in imgs) + 2 * 4, h), (20, 20, 20))
    x = 0
    for im in imgs:
        sheet.paste(im, (x, 0))
        x += im.width + 4
    sheet.save(output, quality=90)
    return True


def generate_sample(cfg, *, input_dir, output_dir, work_dir, weights, style,
                    scale, backbone="auto", force=False, device="cpu"):
    """One sample: mask, masked stylize, comparison sheet, preset JSON."""
    name = cfg["name"]
    out_comparison = output_dir / f"{name}_comparison.jpg"
    if out_comparison.exists() and not force:
        print(f"  [skip] {name}")
        return True
    # find the input photo by prefix (reference: :228-238)
    photo = None
    for ext in (".png", ".jpg", ".jpeg"):
        cand = input_dir / f"{cfg['input_prefix']}{ext}"
        if cand.exists():
            photo = cand
            break
    if photo is None:
        print(f"  [skip] {name}: no input {cfg['input_prefix']}.* under {input_dir}")
        return False
    mask_p = work_dir / f"{name}_mask.png"
    styled_p = output_dir / f"{name}.jpg"
    coverage = generate_deeplab_mask(photo, cfg["target_ids"], mask_p,
                                     weights=weights, backbone=backbone, device=device)
    print(f"  [mask] {name}: ids={cfg['target_ids']} coverage={coverage:.1%}")
    st = cfg.get("style", style)
    if not apply_style(photo, styled_p, mask_p, st, invert=cfg.get("invert", False),
                       work_dir=work_dir, scale=scale, device=device.type):
        print(f"  [FAIL] {name}: styling failed")
        return False
    create_comparison_image(photo, mask_p, styled_p, out_comparison)
    # preset JSON next to the sample (reference: :305-353)
    (output_dir / f"{name}_preset.json").write_text(json.dumps({
        "name": cfg.get("preset_name", name),
        "description": cfg.get("description", ""),
        "tags": cfg.get("tags", []),
        "params": {
            "model": st["model"], "model_type": st.get("type", "transformer"),
            "io_preset": st.get("io", "auto"),
            "target_ids": cfg["target_ids"], "mask_invert": cfg.get("invert", False),
        },
        "sample_image": styled_p.name,
    }, indent=2))
    print(f"  [OK] {name}")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Before/mask/after sample sheets")
    ap.add_argument("--input_dir", default="input/mask_samples")
    ap.add_argument("--output_dir", default="output/mask_samples")
    ap.add_argument("--work_dir", default="_work/mask_samples")
    ap.add_argument("--deeplab_weights", required=True)
    ap.add_argument("--backbone",
                    choices=["auto", "resnet", "xception", "drn", "mobilenet"],
                    default="auto", help="auto = detect from the checkpoint")
    ap.add_argument("--model", required=True, help="Default style checkpoint")
    ap.add_argument("--model_type", default="transformer")
    ap.add_argument("--io_preset", default="auto")
    ap.add_argument("--samples_json", default=None,
                    help="JSON list of sample configs (defaults mirror the reference table)")
    ap.add_argument("--scale", type=int, default=720)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    device = resolve_device(args.device)

    input_dir = pathlib.Path(args.input_dir)
    output_dir = pathlib.Path(args.output_dir)
    work_dir = pathlib.Path(args.work_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    work_dir.mkdir(parents=True, exist_ok=True)

    samples = (json.loads(pathlib.Path(args.samples_json).read_text())
               if args.samples_json else DEFAULT_SAMPLES)
    style = {"model": args.model, "type": args.model_type, "io": args.io_preset}

    ok = 0
    results = []
    for cfg in samples:
        good = generate_sample(cfg, input_dir=input_dir, output_dir=output_dir,
                               work_dir=work_dir, weights=args.deeplab_weights,
                               style=style, scale=args.scale,
                               backbone=args.backbone, force=args.force, device=device)
        ok += good
        results.append({"name": cfg["name"], "ok": bool(good)})
    # metadata index (reference: :453-478)
    (output_dir / "mask_samples_metadata.json").write_text(json.dumps(results, indent=2))
    print(f"[mask_samples] {ok}/{len(samples)} sheets -> {output_dir}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
