"""style_mask — foreground/background masked stills + crossfade slideshow.

Counterpart of ``neuralstyletransferv1_tpu/apps/style_mask.py``: for each
input image, a DeepLab mask of the target labels (the port's
``apps/sky_swap``), the foreground and the background stylized separately
through ``engine/pipeline.main`` (``--mask`` / ``--mask_invert``), and the
variants (original, FG-styled, BG-styled) assembled into a crossfade
slideshow (``apps/drive_videos.crossfade_concat``).

DeepLab and the engine run on ``--device`` (``cuda`` unless told ``cpu``;
no GPU raises). Run it as ``python -m neuralstyletransferv1_torch.apps.style_mask``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", nargs="+", required=True)
    ap.add_argument("--output", required=True, help="slideshow video path")
    ap.add_argument("--deeplab_weights", required=True)
    ap.add_argument("--backbone",
                    choices=["auto", "resnet", "xception", "drn", "mobilenet"],
                    default="auto", help="auto = detect from the checkpoint")
    ap.add_argument("--target_labels", default="person")
    ap.add_argument("--fg_model", required=True, help="checkpoint for the masked region")
    ap.add_argument("--bg_model", default=None, help="checkpoint for the background (default: fg_model)")
    ap.add_argument("--io_preset", default="auto")
    ap.add_argument("--size", type=int, default=720)
    ap.add_argument("--mask_res", type=int, default=512)
    ap.add_argument("--mask_feather", type=int, default=6)
    ap.add_argument("--hold_secs", type=float, default=1.5)
    ap.add_argument("--fade_secs", type=float, default=0.6)
    ap.add_argument("--fps", type=int, default=24)
    ap.add_argument("--out_stills", default=None, help="also keep the styled stills here")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from PIL import Image

    from ..device import resolve_device
    from ..engine.pipeline import main as pipeline_main
    from ..io.frames import write_mp4
    from .drive_videos import crossfade_concat
    from .sky_swap import SegmentationModel, infer_mask, load_deeplab, lookup_label_ids

    device = resolve_device(args.device)
    params, nc, bb = load_deeplab(args.deeplab_weights, args.backbone)
    model = SegmentationModel(params, nc, bb, device=device)
    target_ids = lookup_label_ids(args.target_labels.replace("|", ",").split(","), nc)
    bg_model = args.bg_model or args.fg_model

    stills_dir = pathlib.Path(args.out_stills) if args.out_stills else None
    if stills_dir:
        stills_dir.mkdir(parents=True, exist_ok=True)

    hold_n = max(1, int(round(args.hold_secs * args.fps)))
    clips = []
    with tempfile.TemporaryDirectory(prefix="style_mask_") as td:
        td = pathlib.Path(td)
        for ii, img_path in enumerate(args.images):
            im = Image.open(img_path).convert("RGB")
            w0, h0 = im.size
            s = args.size / max(w0, h0)
            if s < 1.0:
                im = im.resize((int(w0 * s) // 2 * 2, int(h0 * s) // 2 * 2), Image.LANCZOS)
            src = td / f"src_{ii}.png"
            im.save(src)

            # mask at working res, upsample to the still size
            work = im
            sw, sh = im.size
            ms = args.mask_res / max(sw, sh)
            if ms < 1.0:
                work = im.resize((int(sw * ms), int(sh * ms)), Image.LANCZOS)
            m = infer_mask(model, work, target_ids=target_ids, feather_px=args.mask_feather)
            if (m.shape[1], m.shape[0]) != im.size:
                m = np.array(Image.fromarray(m).resize(im.size, Image.BILINEAR), np.uint8)
            mask_path = td / f"mask_{ii}.png"
            Image.fromarray(m).save(mask_path)

            variants = [np.asarray(im)]
            for name, mdl, invert in (("fg", args.fg_model, False), ("bg", bg_model, True)):
                outp = td / f"{ii}_{name}.png"
                cmd = [
                    "--input_image", str(src), "--output_image", str(outp),
                    "--model", mdl, "--io_preset", args.io_preset,
                    "--mask", str(mask_path), "--no-smooth_lightness",
                    "--work_dir", str(td / "_w"), "--device", args.device,
                ]
                if invert:
                    cmd.append("--mask_invert")
                if pipeline_main(cmd) == 0 and outp.exists():
                    v = np.asarray(Image.open(outp).convert("RGB"))
                    variants.append(v)
                    if stills_dir:
                        Image.fromarray(v).save(stills_dir / f"{pathlib.Path(img_path).stem}_{name}.png")
                else:
                    print(f"[style_mask][warn] {name} pass failed for {img_path}")

            for vi, v in enumerate(variants):
                cp = td / f"clip_{ii}_{vi}.mp4"
                write_mp4(cp, [v] * hold_n, args.fps)
                clips.append(cp)

        if not clips:
            print("[style_mask][error] nothing rendered")
            return 2
        n = crossfade_concat(clips, pathlib.Path(args.output), args.fade_secs, fps=args.fps)
    print(f"[style_mask] wrote {args.output} ({n} frames, {len(clips)} clips)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
