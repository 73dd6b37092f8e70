"""generate_style_selfstyle — hi-res center-crop self-style gallery samples.

Counterpart of ``neuralstyletransferv1_tpu/apps/generate_style_selfstyle.py``:
center-crop each source image, magenta self-style it (content == style) at
a hi-res tile config through the port's ``models/magenta`` (the SavedModel
graph where ``models/magenta`` holds one, else the compact CIN net from
``magenta.init_tree(--seed)``), paste a thumbnail of the original in the
corner, write an original|styled comparison, and record the sample path in
the presets DB (``--db``).

The self-style runs on ``--device`` (``cuda`` unless told ``cpu``; no GPU
raises). Run it as
``python -m neuralstyletransferv1_torch.apps.generate_style_selfstyle``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

HIGH_RES_SCALE = 1440
CENTER_CROP_RATIO = 0.75


def extract_center_crop(img, crop_ratio=CENTER_CROP_RATIO):
    """The centred ``crop_ratio`` crop."""
    h, w = img.shape[:2]
    ch, cw = int(h * crop_ratio), int(w * crop_ratio)
    y0, x0 = (h - ch) // 2, (w - cw) // 2
    return img[y0 : y0 + ch, x0 : x0 + cw]


def self_style(img01, tile, overlap, blend, scale=HIGH_RES_SCALE, seed=0, *, device="cpu",
               magenta_tree=None):
    """Magenta self-style (content == style) of an HWC [0, 1] numpy image at
    one tile config on ``device``, the long side capped at ``scale`` and the
    result resized back, blended with the image by ``blend``. Without a
    SavedModel the compact net takes ``magenta_tree`` (a ``magenta.init``
    tree), else ``magenta.init_tree(seed)``."""
    import torch
    from PIL import Image

    from ..models import magenta
    from ..ops.resize import resize_bilinear

    h, w = img01.shape[:2]
    work = torch.from_numpy(np.ascontiguousarray(img01, np.float32)).to(device)
    if max(h, w) > scale:
        s = scale / max(h, w)
        work = resize_bilinear(work, (int(h * s), int(w * s)))
    t = min(tile, min(int(work.shape[0]), int(work.shape[1])))
    style = torch.from_numpy(np.asarray(
        Image.fromarray((img01 * 255).astype(np.uint8)).resize((t, t), Image.LANCZOS),
        np.float32) / 255.0).to(device)
    sm_dir = magenta.find_savedmodel("models/magenta")
    transfer = magenta.savedmodel_transfer_fn(sm_dir, style) if sm_dir else None
    net = None
    if transfer is None:
        tree = magenta_tree if magenta_tree is not None else magenta.init_tree(seed)
        net = magenta.compact_from_jax(tree, device)
    with torch.no_grad():
        y = magenta.stylize_tiled(net, work, style, tile_size=t, overlap=min(overlap, t // 2),
                                  transfer_fn=transfer)
        if y.shape[:2] != (h, w):
            y = resize_bilinear(y, (h, w))
    return blend * y.cpu().numpy() + (1 - blend) * img01


def add_thumbnail_overlay(styled_u8, original_u8, thumb_frac=0.22, margin=12):
    """Paste a bordered thumbnail of the original bottom-left."""
    import cv2

    h, w = styled_u8.shape[:2]
    tw = max(32, int(w * thumb_frac))
    th = max(32, int(original_u8.shape[0] * tw / original_u8.shape[1]))
    thumb = cv2.resize(original_u8, (tw, th), interpolation=cv2.INTER_AREA)
    out = styled_u8.copy()
    y0 = h - th - margin
    x0 = margin
    cv2.rectangle(out, (x0 - 3, y0 - 3), (x0 + tw + 3, y0 + th + 3), (255, 255, 255), -1)
    out[y0 : y0 + th, x0 : x0 + tw] = thumb
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Hi-res self-style gallery samples")
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--output_dir", default="output/style_selfstyle")
    ap.add_argument("--db", default=None, help="presets.db to record sample paths in")
    ap.add_argument("--tile", type=int, default=512)
    ap.add_argument("--overlap", type=int, default=64)
    ap.add_argument("--blend", type=float, default=0.95)
    ap.add_argument("--scale", type=int, default=HIGH_RES_SCALE)
    ap.add_argument("--crop_ratio", type=float, default=CENTER_CROP_RATIO)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    import cv2

    from ..device import resolve_device

    device = resolve_device(args.device)

    srcs = sorted(
        p for p in pathlib.Path(args.input_dir).iterdir()
        if p.suffix.lower() in (".jpg", ".jpeg", ".png")
    )
    if args.limit:
        srcs = srcs[: args.limit]
    if not srcs:
        print(f"[selfstyle][error] no images under {args.input_dir}")
        return 2
    out_dir = pathlib.Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    conn = None
    if args.db:
        from ..presets import connect, create_schema, insert_preset

        conn = connect(args.db)
        create_schema(conn)

    ok = 0
    for src in srcs:
        out = out_dir / f"{src.stem}_selfstyle.jpg"
        comparison = out_dir / f"{src.stem}_comparison.jpg"
        if out.exists() and not args.force:
            print(f"  [skip] {src.name}")
            ok += 1
            continue
        img = cv2.imread(str(src))
        if img is None:
            continue
        crop = extract_center_crop(img, args.crop_ratio)
        crop01 = crop[..., ::-1].astype(np.float32) / 255.0
        styled01 = self_style(crop01, args.tile, args.overlap, args.blend,
                              scale=args.scale, seed=args.seed, device=device)
        styled_u8 = (np.clip(styled01, 0, 1)[..., ::-1] * 255).astype(np.uint8)
        final = add_thumbnail_overlay(styled_u8, crop)
        cv2.imwrite(str(out), final, [cv2.IMWRITE_JPEG_QUALITY, 92])
        comp = np.concatenate([crop, styled_u8], axis=1)
        cv2.imwrite(str(comparison), comp, [cv2.IMWRITE_JPEG_QUALITY, 88])
        if conn is not None:
            from ..presets import insert_preset

            pid = insert_preset(
                conn, name=f"SelfStyle {src.stem}"[:60],
                description="Hi-res center-crop self-style",
                model_type="magenta", magenta_style=str(src),
                magenta_tile=args.tile, magenta_overlap=args.overlap,
                blend=args.blend, sample_image_path=str(out),
            )
            conn.commit()
            print(f"  [OK] {src.name} -> {out.name} (preset #{pid})")
        else:
            print(f"  [OK] {src.name} -> {out.name}")
        ok += 1
    if conn is not None:
        conn.close()
    print(f"[selfstyle] {ok}/{len(srcs)} samples -> {out_dir}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
