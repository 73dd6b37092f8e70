"""Optimization-based (Gram-matrix) neural style transfer CLI.

Counterpart of the root ``slow_nst.py`` (BASELINE config #3), on the port's
``engine/gram_nst.py``: the whole optimization runs on ``--device``
(``cuda`` unless told ``cpu``; no GPU raises). Run it as

    python -m neuralstyletransferv1_torch.apps.slow_nst --content in.jpg \\
        --style style.jpg --output out.png [--steps 500] [--size 512] \\
        [--vgg_weights vgg16.pth] [--device cpu]

Images are downscaled (LANCZOS) so that their long side is at most
``--size``; smaller ones keep their size. ``--vgg_weights`` is a torchvision
``vgg16`` state dict; without it the VGG is random (seed 0), with a warning.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
from PIL import Image

from ..device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--content", required=True)
    ap.add_argument("--style", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--content_weight", type=float, default=1.0)
    ap.add_argument("--style_weight", type=float, default=1e4)
    ap.add_argument("--tv_weight", type=float, default=1e-4)
    ap.add_argument("--init_from", choices=["content", "random"], default="content")
    ap.add_argument("--vgg_weights", type=str, default=None,
                    help="torchvision-format vgg16 state-dict (.pth). Random init if absent.")
    ap.add_argument("--device", choices=["cpu", "cuda", "mps", "tpu"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from ..engine import gram_nst
    from ..models import vgg

    def load(path):
        img = Image.open(path).convert("RGB")
        w, h = img.size
        s = args.size / max(w, h)
        if s < 1.0:
            img = img.resize((int(w * s), int(h * s)), Image.LANCZOS)
        return torch.from_numpy(np.asarray(img, np.float32) / 255.0)[None].to(device)

    content = load(args.content)
    style = load(args.style)

    if args.vgg_weights:
        sd = torch.load(args.vgg_weights, map_location="cpu")
        net = vgg.load(vgg.import_torchvision_vgg16(sd), device)
        print(f"[vgg] loaded {args.vgg_weights}")
    else:
        net = vgg.load(vgg.init(0), device)
        print("[vgg][warn] no --vgg_weights given; using random VGG features "
              "(structure testing only — stylization quality needs pretrained weights)")

    t0 = time.time()
    out, history = gram_nst.optimize(
        net, content, style,
        steps=args.steps, lr=args.lr,
        content_weight=args.content_weight, style_weight=args.style_weight,
        tv_weight=args.tv_weight, init_from=args.init_from,
    )
    out_np = out[0].cpu().numpy()
    hist = history.cpu().numpy()
    dt = time.time() - t0
    print(f"[nst] {args.steps} steps in {dt:.1f}s ({args.steps / dt:.1f} steps/s)  "
          f"loss {hist[0]:.4f} -> {hist[-1]:.4f}")
    Image.fromarray((np.clip(out_np, 0, 1) * 255).astype(np.uint8)).save(args.output)
    print(f"[ok] wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
