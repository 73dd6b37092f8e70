"""mk7 on the card: the d3 rows site, K9e ``d3_rows``.

Port of ``experiments/mk7_d3site.py``: the in5 affine + ReLU on deconv2's
raw output at the 540×960 block grid of a 1080p batch (B=8, 128 channels =
4 phases × 32), then deconv3's tap-packed 1×5 conv to 60 lanes over the
4-pixel reflect halo → bf16 rows [B, 544, 960, 60]. The script's fused
kernel reads an XLA-built padded buffer (B, 544, 968, 128) and writes 64
lanes; K9e reads the raw grid through the halo's index map and writes the
60, which is the same function. Timed against the script's XLA reference
in eager PyTorch (pad, prologue pass, cuDNN 1×5 conv) and the cuDNN conv
alone.

    python -m neuralstyletransferv1_torch.experiments.mk7_d3site
    python -m neuralstyletransferv1_torch.experiments.mk7_d3site --device cpu --small
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import bf16_sites as k9
from ..models.s2d import pad_reflect_f2_4px
from . import _bench

FULL = (8, 540, 960)       # B, H2, W2 of the block grid
SMALL = (1, 8, 12)


def inputs(shape, seed: int, dev) -> dict:
    """mk7's operands from a numpy seed: x [B,H2,W2,128] bf16 normal, stat
    [B,2,128] f32 normal·0.1, w_row [1,5,128,60] bf16 normal·0.05."""
    b, h, w = shape
    rng = np.random.default_rng(seed)
    return {"x": _bench.normal(rng, (b, h, w, k9.D3_C), 1.0, dev),
            "stat": _bench.normal(rng, (b, 2, k9.D3_C), 0.1, dev, torch.float32),
            "w_row": _bench.normal(rng, (1, 5, k9.D3_C, k9.D3_LANES), 0.05, dev)}


def rows(x, stat, w_row):
    """K9e on mk7's operands → bf16 rows [B,H2+4,W2,60]."""
    a, c = stat[:, 0].contiguous(), stat[:, 1].contiguous()
    return k9.d3_rows(x, a, c, k9.pack_rows_weights(w_row))


def eager_path(x, stat, w_oihw):
    """The XLA reference in eager PyTorch: the phase-reflect pad, the
    prologue pass, the cuDNN bf16 1×5 conv (channels-last)."""
    xa = k9._activate(pad_reflect_f2_4px(x, 32), stat[:, 0], stat[:, 1])
    return F.conv2d(xa.permute(0, 3, 1, 2), w_oihw)


def main(argv=None) -> dict:
    args = _bench.parser(__doc__).parse_args(argv)
    dev, head = _bench.setup(args)
    shape = SMALL if args.small else FULL
    ins = inputs(shape, args.seed, dev)
    x, stat, w_row = ins["x"], ins["stat"], ins["w_row"]
    a, c, wp = stat[:, 0].contiguous(), stat[:, 1].contiguous(), k9.pack_rows_weights(w_row)
    out, again = rows(x, stat, w_row), rows(x, stat, w_row)
    rec = {"experiment": "mk7_d3site", **head, "shape": list(shape), "kernel_name": "d3_rows",
           **_bench.check("d3_rows", out, again, k9.d3_rows_plain(x, a, c, wp))}
    del out, again
    if dev.type == "cuda":
        b, h, w = shape
        flops = 2.0 * b * (h + 4) * w * 5 * k9.D3_C * k9.D3_LANES
        moved = 2.0 * (x.numel() + b * (h + 4) * w * k9.D3_LANES + w_row.numel()) + 4.0 * (
            stat.numel())
        rec.update(_bench.bound(moved, flops))
        w_oihw = w_row[0].permute(2, 1, 0)[:, :, None, :].contiguous(
            memory_format=torch.channels_last)
        xa = k9._activate(pad_reflect_f2_4px(x, 32), a, c).permute(0, 3, 1, 2)
        t = _bench.in_turns({
            "ms": (lambda: k9.d3_rows(x, a, c, wp), 10),
            "plain_ms": (lambda: k9.d3_rows_plain(x, a, c, wp), 2),
            "library_ms": (lambda: F.conv2d(xa, w_oihw), 10),
            "eager_path_ms": (lambda: eager_path(x, stat, w_oihw), 3)})
        rec.update({k: v["ms"] for k, v in t.items()})
        rec["spread"] = {k: v["spread"] for k, v in t.items()}
        rec["kernel_tflops"] = flops / rec["ms"] / 1e9
        del xa
        torch.cuda.empty_cache()
    _bench.emit(rec)
    return rec


if __name__ == "__main__":
    main()
