"""mk21 on the card: the int8 res-site structure sweep, K12 ``shift_dot``.

Port of ``experiments/mk21_int8_res_sweep.py`` at B=8, x [8, 274, 488,
128] → [8, 272, 488, 128]: mk20's strip dot (strips of 8 rows flattened,
then a zero row; the dx taps run into the next row, there is no column
halo), out bf16(acc·2^-8). Its variants, as K12's strip form:

  tap9   9 shifted K = 128 dots: int8 (quantize x·16 in the prologue) and
         bf16 (no quantize, f32 sums)
  k384   3 dots of K = 384 on a dx-concatenated scratch: the same function
         as tap9 on the weights [3, 3C, C] regrouped to [9, C, C]. The
         script's k384 kernel does not trace (it stores (TS+2)·W rows into
         a (TS+2)·W + 2-row scratch), so on the TPU it only printed FAILED
  noq    int8 with no quantize: s8 x, the chain's quantized input

MT ∈ {2W, 4W} is a TPU tiling of one function: each variant is checked and
timed once. The script's XLA bf16 conv reference becomes the cuDNN bf16 3×3
conv on [8, 272, 488, 128] (``cudnn_bf16_ms``, a yardstick: no PyTorch
call computes the strip function, ``library_ms`` is null).

    python -m neuralstyletransferv1_torch.experiments.mk21_int8_res_sweep [tap9-int8 ...]
    python -m neuralstyletransferv1_torch.experiments.mk21_int8_res_sweep --device cpu --small

The script's timing, a chain of 8 minus a chain of 1 on the host clock,
becomes per-call CUDA events in turns (``_bench.cuda_ms``), K12's previous
core beside each variant (``prev_ms``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import int8_probes as k12
from . import _bench
from .mk20_int8_smoke import strip_work

FULL = (8, 272, 488, 128)    # B, H (output rows), W (padded), C
SMALL = (1, 16, 21, 128)
OSCALE = 2.0 ** -8
#: variant → (weights layout, form, what it is on the TPU); the script's
#: MT = 2W / 4W tilings of each are one form
VARIANTS = {
    "tap9-bf16": ("tap9", "bf16", "tap9, MT = 2W and 4W"),
    "tap9-int8": ("tap9", "int8", "tap9i8, MT = 2W and 4W"),
    "k384-bf16": ("k384", "bf16", "k384, MT = 2W and 4W: does not trace"),
    "k384-int8": ("k384", "int8", "k384i8, MT = 2W and 4W: does not trace"),
    "tap9-int8-noquant": ("tap9", "noq", "tap9i8 on s8 input, MT = 4W"),
    "k384-int8-noquant": ("k384", "noq", "k384i8 on s8 input, MT = 4W: does not trace"),
}
FORMS = {"int8": {"pro": "quant", "oscale": OSCALE},
         "bf16": {"oscale": OSCALE},
         "noq": {"oscale": OSCALE}}


def weights(rng, layout: str, form: str, c: int, dev) -> torch.Tensor:
    """The script's weights: s8 integers in [−127, 127) (int8, noq) or bf16
    normals, [9, C, C] (tap9) or [3, 3C, C] regrouped to [9, C, C] (k384);
    packed for K12."""
    shape = (9, c, c) if layout == "tap9" else (3, 3 * c, c)
    if form == "bf16":
        w = _bench.normal(rng, shape, 1.0, dev)
    else:
        w = torch.from_numpy(rng.integers(-127, 127, shape).astype(np.int8)).to(dev)
    return k12.pack_taps(w if layout == "tap9" else k12.regroup_k384(w))


def main(argv=None) -> dict:
    p = _bench.parser(__doc__)
    p.add_argument("variants", nargs="*", help=f"of {', '.join(VARIANTS)} (default: all)")
    args = p.parse_args(argv)
    names = args.variants or list(VARIANTS)
    unknown = [v for v in names if v not in VARIANTS]
    if unknown:
        p.error(f"unknown variant(s) {unknown}: mk21 has {', '.join(VARIANTS)}")
    dev, head = _bench.setup(args)
    b, h, w, c = SMALL if args.small else FULL
    rng = np.random.default_rng(args.seed)
    x = _bench.normal(rng, (b, h + 2, w, c), 1.0, dev)
    xq = k12.quant_s8(x, k12.QSCALE_DOT).to(torch.int8)
    conv = ({"cudnn_bf16_ms": _bench.conv3x3(x[:, 1:-1].contiguous(), c, 1)}
            if dev.type == "cuda" else None)
    recs = []
    for v in names:
        layout, form, tpu = VARIANTS[v]
        wt = weights(rng, layout, form, c, dev)
        xin = xq if form == "noq" else x
        kw = FORMS[form]
        exact = form != "bf16"
        peak = _bench.PEAK_BF16_OPS if form == "bf16" else _bench.PEAK_INT8_OPS
        rec = _bench.measure(
            f"shift_dot[mk21 {v}]", lambda: k12.strip_dot(xin, wt, **kw),
            lambda: k12.strip_dot_plain(xin, wt, **kw), dev,
            exact=exact,
            work=(*strip_work(xin, wt), peak), yardsticks=conv,
            prev=lambda: k12.strip_dot_prev(xin, wt, **kw), reps=5)
        recs.append({"variant": v, "tpu": tpu, "form": form, "kernel_name": "shift_dot", **rec})
        del wt
    record = {"experiment": "mk21_int8_res_sweep", **head, "shape": [b, h, w, c],
              "variants": recs}
    _bench.emit(record)
    return record


if __name__ == "__main__":
    main()
