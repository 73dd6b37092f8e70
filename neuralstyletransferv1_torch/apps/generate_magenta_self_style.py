"""generate_magenta_self_style — seeded-random magenta self-style sample set.

Counterpart of ``neuralstyletransferv1_tpu/apps/generate_magenta_self_style.py``:
pick ``--count`` images (``random.seed(--seed)``, ``random.sample`` over the
SORTED pool, so a seed picks the same images on every machine) from a
directory, magenta-stylize each with itself as the style image (tile 512 /
overlap 64, long side scaled to ``--scale``; the SavedModel under
``--magenta_root`` where one is complete, else the compact CIN net from
``--seed``), blend with the original by ``--blend`` and write
``selfstyle_<stem>.jpg``, skipping existing files. One process, on
``--device`` (``cuda`` unless told ``cpu``; no GPU raises). Run it as
``python -m neuralstyletransferv1_torch.apps.generate_magenta_self_style``.
"""

from __future__ import annotations

import argparse
import pathlib
import random
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input_dir", required=True,
                    help="sample pool")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--count", type=int, default=30)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--scale", type=int, default=720,
                    help="long-side target before styling")
    ap.add_argument("--magenta_tile", type=int, default=512)
    ap.add_argument("--magenta_overlap", type=int, default=64)
    ap.add_argument("--blend", type=float, default=0.95,
                    help="style weight vs original")
    ap.add_argument("--magenta_root", default="models/magenta")
    ap.add_argument("--no_skip_existing", action="store_true")
    ap.add_argument("--device", choices=["cpu", "cuda", "mps", "tpu"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    from PIL import Image

    from ..device import resolve_device
    from .selfstyle_blob import self_style_variants

    device = resolve_device(args.device)
    in_dir = pathlib.Path(args.input_dir)
    pool = sorted(
        [p for p in in_dir.glob("*.jpg")] + [p for p in in_dir.glob("*.png")]
    )
    if not pool:
        print(f"[generate_magenta_self_style][error] no images in {in_dir}")
        return 2
    n = args.count
    if len(pool) < n:
        print(f"[warn] only {len(pool)} images, using all")
        n = len(pool)
    random.seed(args.seed)
    picks = random.sample(pool, n)

    out_dir = pathlib.Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    ok = 0
    for i, src in enumerate(picks, 1):
        out_path = out_dir / f"selfstyle_{src.stem}.jpg"
        if out_path.exists() and not args.no_skip_existing:
            print(f"[{i}/{n}] skip (exists): {out_path.name}")
            ok += 1
            continue
        print(f"[{i}/{n}] {src.name}")
        im = Image.open(src).convert("RGB")
        w, h = im.size
        if max(w, h) > args.scale:
            s = args.scale / max(w, h)
            im = im.resize((max(1, round(w * s)), max(1, round(h * s))),
                           Image.LANCZOS)
        content = np.asarray(im, np.float32) / 255.0
        tile = min(args.magenta_tile, min(content.shape[:2]))
        variants = self_style_variants(
            content, [(tile, args.magenta_overlap)], seed=args.seed,
            magenta_root=args.magenta_root, device=device)
        styled = variants[0].cpu().numpy()
        outv = args.blend * styled + (1.0 - args.blend) * content
        Image.fromarray(
            np.clip(outv * 255.0, 0, 255).astype(np.uint8)).save(
                out_path, quality=92)
        ok += 1
        print(f"  -> {out_path.name}")

    print(f"[generate_magenta_self_style] {ok}/{n} done -> {out_dir}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
