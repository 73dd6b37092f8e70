"""batch_selfstyle — magenta self-style a directory at the tile ladder
(self-style: the content is its own style image).

Counterpart of ``neuralstyletransferv1_tpu/apps/batch_selfstyle.py``, on the
port's ``selfstyle_blob.self_style_variants`` and ``--device`` (``cuda``
unless told ``cpu``; no GPU raises). Writes ``{stem}_t{tile}o{overlap}.png``
for each image and config, skipping images whose outputs all exist. Run it
as ``python -m neuralstyletransferv1_torch.apps.batch_selfstyle``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--size", type=int, default=720)
    ap.add_argument("--tile_configs", type=str, default="128:16,256:32,512:64")
    ap.add_argument("--skip_existing", action="store_true", default=True)
    ap.add_argument("--device", choices=["cpu", "cuda", "mps", "tpu"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from PIL import Image

    from ..device import resolve_device
    from .selfstyle_blob import self_style_variants

    device = resolve_device(args.device)
    configs = [tuple(int(v) for v in c.split(":")) for c in args.tile_configs.split(",")]
    out_dir = pathlib.Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    images = sorted(
        p for p in pathlib.Path(args.input_dir).iterdir()
        if p.suffix.lower() in (".jpg", ".jpeg", ".png")
    )
    if not images:
        print(f"[batch_selfstyle][error] no images in {args.input_dir}")
        return 2
    for src in images:
        done = all(
            (out_dir / f"{src.stem}_t{t}o{o}.png").exists() for t, o in configs
        )
        if args.skip_existing and done:
            print(f"[skip] {src.name}")
            continue
        im = Image.open(src).convert("RGB")
        w0, h0 = im.size
        s = args.size / max(w0, h0)
        if s < 1.0:
            im = im.resize((int(w0 * s) // 2 * 2, int(h0 * s) // 2 * 2), Image.LANCZOS)
        content01 = np.asarray(im, np.float32) / 255.0
        usable = [(t, o) for t, o in configs if t <= min(content01.shape[:2])]
        if not usable:
            print(f"[warn] {src.name}: no tile config fits; skipping")
            continue
        variants = self_style_variants(content01, usable, device=device).cpu().numpy()
        for (t, o), v in zip(usable, variants):
            outp = out_dir / f"{src.stem}_t{t}o{o}.png"
            Image.fromarray((np.clip(v, 0, 1) * 255).astype(np.uint8)).save(outp)
        print(f"[ok] {src.name}: {len(usable)} variants")
    return 0


if __name__ == "__main__":
    sys.exit(main())
