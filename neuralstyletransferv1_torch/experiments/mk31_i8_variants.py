"""mk31 on the card: the int8 res site's cost-accounting variants, K4
``res_site`` in three forms.

Port of ``experiments/mk31_i8_variants.py`` at x [16, 270, 480, 128] bf16
(normal·2), the reflect 3×3 res site 128 → 128 with the script's weights,
dequant row and statistics, built as its ``main`` builds them from numpy
seed 0 (a = 127/4, c = 0, floor −127):

  v0  full: quantize → conv → dequant → bf16 raw + [Σ, Σ²] (K4 as is)
  v1  noaffine: the quantize is a bare saturating cast of x to s8 (XLA's
      convert: NaN → 0, truncate, clamp to [−128, 127]) (K4
      ``prologue="cast"``)
  v2  nostats: the full prologue, raw out, zero sums (K4 ``stats=False``)
  v3  pingpong: v0's function with a TPU schedule (the script does not run
      it: "TPU backend Internal crash"); listed as v0, not run

The script's TS = 54, MT = 16 are TPU tilings. Each form is held bit for
bit against its plain version (sums within 1e-5; v2's exactly zero) and
timed in turns beside its plain version and the cuDNN bf16 3×3 conv of the
same shape (``cudnn_bf16_ms``, a yardstick; ``library_ms`` is null). The script's timing, a chain of
10 sites minus a chain of 1 on the host clock, becomes per-call CUDA events
(``_bench.cuda_ms``).

    python -m neuralstyletransferv1_torch.experiments.mk31_i8_variants [v0 v1 v2]
    python -m neuralstyletransferv1_torch.experiments.mk31_i8_variants --device cpu --small
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import int8_sites as k8
from . import _bench

FULL = (16, 270, 480, 128)  # B, H4, W0, C
SMALL = (2, 12, 16, 128)
#: variant → (prologue, stats, K4's LAUNCHES name, what it is on the TPU)
VARIANTS = {"v0": ("quant", True, "res_site", "v0 full (si8.res_site)"),
            "v1": ("cast", True, "res_site_cast", "k_v1_noaffine: bare astype(int8)"),
            "v2": ("quant", False, "res_site_nostats", "k_v2_nostats: zero sums")}
NOT_RUN = {"v3": "k_v3_pingpong: v0's function; the script skips it (TPU backend crash)"}


def operands(b: int, c: int, seed: int, dev) -> tuple:
    """K4's operands as the script's ``main`` builds them: w normal·0.05
    [3,3,C,C], ws = max|w| per output channel / 127, w9 its s8 codes, dequant
    row ws·4/127 and bias normal·0.02; a = 127/4, c = 0 per (image, channel);
    floor −127."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, (3, 3, c, c)).astype(np.float32)
    ws_ = np.maximum(np.max(np.abs(w), axis=(0, 1, 2)) / 127.0, 1e-12)
    w9 = np.clip(np.round(w / ws_), -127, 127).astype(np.int8)
    ws = torch.from_numpy((ws_ * (4.0 / 127.0)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.02, c).astype(np.float32))
    a = torch.full((b, c), 127.0 / 4.0)
    return (a.to(dev), torch.zeros((b, c), device=dev), -127.0,
            k8.pack_weights(torch.from_numpy(w9)).to(dev), ws.to(dev), bias.to(dev))


def main(argv=None) -> dict:
    p = _bench.parser(__doc__)
    p.add_argument("variants", nargs="*", help=f"of {', '.join(VARIANTS)} (default: all)")
    args = p.parse_args(argv)
    names = args.variants or list(VARIANTS)
    unknown = [v for v in names if v not in VARIANTS]
    if unknown:
        p.error(f"unknown variant(s) {unknown}: mk31 runs {', '.join(VARIANTS)}")
    dev, head = _bench.setup(args)
    b, h, w, c = SMALL if args.small else FULL
    ops = operands(b, c, args.seed, dev)
    x = _bench.normal(np.random.default_rng(args.seed + 100), (b, h, w, c), 2.0, dev)
    conv = {"cudnn_bf16_ms": _bench.conv3x3(x, c, 1)} if dev.type == "cuda" else None
    nbytes = 2.0 * (x.numel() + b * h * w * c) + 9 * c * c + 4.0 * (2 * b * c + 2 * c)
    recs = []
    for v in names:
        pro, stats, kname, tpu = VARIANTS[v]
        kw = {"prologue": pro, "stats": stats}
        rec = _bench.measure(f"res_site[mk31 {v}]", lambda: k8.res_site(x, *ops, **kw),
                             lambda: k8.res_site_plain(x, *ops, **kw), dev,
                             check_kw={"zero_sums": not stats},
                             work=(nbytes + (8.0 * b * c if stats else 0.0),
                                   2.0 * b * h * w * 9 * c * c, _bench.PEAK_INT8_OPS),
                             yardsticks=conv, reps=5)
        recs.append({"variant": v, "tpu": tpu, "prologue": pro, "stats": stats,
                     "kernel_name": kname, **rec})
    record = {"experiment": "mk31_i8_variants", **head, "shape": [b, h, w, c],
              "variants": recs, "not_run": NOT_RUN}
    _bench.emit(record)
    return record


if __name__ == "__main__":
    main()
