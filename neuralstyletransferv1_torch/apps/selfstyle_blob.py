"""selfstyle_blob — magenta self-style variants + blob-mask morph video.

Counterpart of ``neuralstyletransferv1_tpu/apps/selfstyle_blob.py``: the
input image is self-styled (content == style) at a ladder of magenta tile
configs, then composited into a video where soft gaussian blobs drift
across the frame, each blob revealing a different self-style variant.

The variants run through the port's tiled magenta driver
(``models/magenta.py``) with the SavedModel graph where ``find_savedmodel``
finds one under ``magenta_root``, else the compact CIN net from a seed
(never the colour transfer: for content == style it is the identity). The
blob composite runs as torch, a chunk of frames at a time. Both run on
``--device`` (``cuda`` unless told ``cpu``; no GPU raises). Run it as
``python -m neuralstyletransferv1_torch.apps.selfstyle_blob``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

# (tile, overlap) ladder
TILE_CONFIGS = [(128, 16), (192, 24), (256, 32), (384, 48), (512, 64)]


def self_style_variants(content01, tile_configs, seed=0, magenta_root="models/magenta", *,
                        magenta_tree=None, device="cpu") -> torch.Tensor:
    """Magenta self-style of an HWC [0, 1] numpy image at each tile config
    that fits; returns [V, H, W, 3] f32 on ``device`` (the content itself
    when none fits).

    The SavedModel graph runs when complete weights exist under
    ``magenta_root``; otherwise the compact CIN net with the weights of
    ``magenta_tree`` (a ``magenta.init`` tree) or of
    ``magenta.init_tree(seed)``."""
    from PIL import Image

    from ..models import magenta

    sm_dir = magenta.find_savedmodel(magenta_root)
    net = None
    if not sm_dir:
        tree = magenta_tree if magenta_tree is not None else magenta.init_tree(seed)
        net = magenta.compact_from_jax(tree, device)
    outs = []
    H, W = content01.shape[:2]
    c = torch.from_numpy(np.ascontiguousarray(content01, np.float32)).to(device)
    for tile, overlap in tile_configs:
        if tile > min(H, W):
            continue
        style = np.asarray(
            Image.fromarray((content01 * 255).astype(np.uint8)).resize((tile, tile), Image.LANCZOS),
            np.float32,
        ) / 255.0
        style = torch.from_numpy(style).to(device)
        transfer = magenta.savedmodel_transfer_fn(sm_dir, style) if sm_dir else None
        with torch.no_grad():
            outs.append(magenta.stylize_tiled(net, c, style, tile_size=tile, overlap=overlap,
                                              transfer_fn=transfer))
    if not outs:
        outs = [c]
    return torch.stack(outs, 0)


def blob_morph_frames(variants, base01, num_frames, fps, n_blobs=2, blob_sigma_frac=0.22,
                      speed=1.0, chunk: int = 16):
    """Animated soft-blob composite (uint8 HWC list): blob k drifts on a
    lissajous path and its gaussian field selects variant (k mod V); the
    remainder shows the base image. ``variants`` [V, H, W, 3] (a tensor on
    the device to run on, or numpy), ``base01`` HWC."""
    variants = torch.as_tensor(variants, dtype=torch.float32)
    dev = variants.device
    V, H, W, _ = variants.shape
    sigma = blob_sigma_frac * min(H, W)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    base = torch.as_tensor(base01, dtype=torch.float32).to(dev)
    ts_all = torch.arange(num_frames, dtype=torch.float32, device=dev) / fps * speed
    frames = []
    for c0 in range(0, num_frames, chunk):
        t = ts_all[c0:c0 + chunk][:, None, None]
        weights = []
        for k in range(n_blobs):
            cx = W * (0.5 + 0.33 * torch.sin(t * (0.55 + 0.13 * k) + k * 2.1))
            cy = H * (0.5 + 0.33 * torch.cos(t * (0.42 + 0.11 * k) + k * 1.3))
            d2 = (xs - cx) ** 2 + (ys - cy) ** 2
            weights.append(torch.exp(-d2 / (2 * sigma * sigma)))
        wsum = sum(weights)
        base_w = torch.clamp(1.0 - wsum, 0.0, 1.0)
        out = base * base_w[..., None]
        total = base_w
        for k, wgt in enumerate(weights):
            out = out + variants[k % V] * wgt[..., None]
            total = total + wgt
        out = out / torch.clamp(total, min=1e-6)[..., None]
        frames.extend(torch.clamp(out * 255, 0, 255).to(torch.uint8).cpu().numpy())
    return frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--fps", type=int, default=24)
    ap.add_argument("--blobs", type=int, default=2)
    ap.add_argument("--tile_configs", type=str, default=None,
                    help="e.g. '128:16,256:32' (default: full ladder that fits)")
    ap.add_argument("--device", choices=["cpu", "cuda", "mps", "tpu"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    import cv2
    from PIL import Image

    from ..device import resolve_device

    device = resolve_device(args.device)
    im = Image.open(args.image).convert("RGB")
    w0, h0 = im.size
    s = args.size / max(w0, h0)
    if s < 1.0:
        im = im.resize((int(w0 * s) // 2 * 2, int(h0 * s) // 2 * 2), Image.LANCZOS)
    content01 = np.asarray(im, np.float32) / 255.0

    configs = TILE_CONFIGS
    if args.tile_configs:
        configs = [tuple(int(v) for v in c.split(":")) for c in args.tile_configs.split(",")]
    print(f"[selfstyle_blob] rendering {len(configs)} self-style variants…")
    variants = self_style_variants(content01, configs, device=device)
    print(f"[selfstyle_blob] {variants.shape[0]} variants; composing blob morph…")

    frames = blob_morph_frames(
        variants, content01, int(args.seconds * args.fps), args.fps, n_blobs=args.blobs
    )
    h, w = frames[0].shape[:2]
    for fourcc in ("avc1", "mp4v"):
        writer = cv2.VideoWriter(args.output, cv2.VideoWriter_fourcc(*fourcc), args.fps, (w, h))
        if writer.isOpened():
            break
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    print(f"[selfstyle_blob] wrote {args.output} ({len(frames)} frames)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
