"""mk27 on the card: the s8 shifted-dot throughput probe, K12 ``shift_dot``.

Port of ``experiments/mk27_pallas_s8_dot.py``: out[m] = Σ_{r<6} A[m +
off_r] · W[r], A [8256, 128], W [6, 128, 128], out [8192, 128] bf16, on
K12's flat form. Its kernels:

  bf16          bf16 operands, f32 sums, bf16(acc); off_r = r
  s8_unaligned  s8 operands, s32 sums, bf16(f32(acc)); off_r = r
  s8_aligned    the same at off_r = 32r (defined by the script, never run by
                its ``main``: its A block of 8256 rows is too short for the
                last tile's 32·5 offset, so it does not trace; here A has
                8352 rows)
  bf16cast      bf16 operands holding integers, cast to s8 (XLA's
                saturating convert) in the prologue, then as s8_unaligned

The TPU grid ran 32 programs on one block, writing one output 32 times;
here the same work is G = 32 distinct seeded slices, [32, 8256, 128] →
[32, 8192, 128], with W shared. The operands stay in the script's range,
integers in [−100, 100): every accumulator stays below 2^24, so the
script's direct s32 → bf16 equals f32 → bf16 and the bf16 form is exact
too. The function is a 1-D convolution over the rows: for the bf16 form
one PyTorch call computes it, ``F.conv1d`` (cuDNN, bf16, f32 sums) of A's
[G, K, MA] view with W as [N, K, R] at dilation = the offset step, its
first ROWS outputs (``library_ms``; its largest difference from the plain
version is ``library_max_abs_err``). PyTorch has no int8 convolution on
the card, so the s8 forms' ``library_ms`` is null. The yardsticks beside
each form (``im2col_mm_ms``): ``torch._int_mm`` (s8 forms; s32 out) or a
bf16 ``torch.matmul`` on the pre-gathered (and, for bf16cast, pre-cast)
im2col [32·8192, 768] × [768, 128], with the gather left out of their
timing.

    python -m neuralstyletransferv1_torch.experiments.mk27_pallas_s8_dot [bf16 ...]
    python -m neuralstyletransferv1_torch.experiments.mk27_pallas_s8_dot --device cpu --small

The script's timing, a chain of 20 minus a chain of 1 on the host clock,
becomes CUDA graph replay in turns (``_bench.graph_ms``: a call is near
its wrapper's host time), K12's previous core beside it (``prev_ms``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import int8_probes as k12
from . import _bench

FULL = (32, 8192)     # G slices, ROWS
SMALL = (2, 256)
C = CO = 128
REPS = 6              # taps
PAD = 64              # A rows past ROWS (the script's block)
#: variant → (A dtype, prologue, offset step, W dtype)
VARIANTS = {"bf16": (torch.bfloat16, "none", 1, torch.bfloat16),
            "s8_unaligned": (torch.int8, "none", 1, torch.int8),
            "s8_aligned": (torch.int8, "none", 32, torch.int8),
            "bf16cast": (torch.bfloat16, "cast", 1, torch.int8)}


def im2col(a: torch.Tensor, offsets, rows: int) -> torch.Tensor:
    """[G, MA, K] → [G·rows, R·K]: row m holds A[m + off_r] for every tap."""
    g, _, k = a.shape
    return torch.cat([a[:, o:o + rows] for o in offsets], -1).reshape(g * rows, len(offsets) * k)


def conv1d_call(a: torch.Tensor, w: torch.Tensor, step: int, rows: int):
    """The flat dot as one PyTorch call: ``F.conv1d`` of a [G, MA, K]'s
    [G, K, MA] view with w [R, K, N] as [N, K, R] at dilation ``step``, its
    first ``rows`` outputs, [G, N, rows] (a view)."""
    at, wc = a.transpose(1, 2), w.permute(2, 1, 0).contiguous()
    return lambda: F.conv1d(at, wc, dilation=step)[..., :rows]


def main(argv=None) -> dict:
    p = _bench.parser(__doc__)
    p.add_argument("variants", nargs="*", help=f"of {', '.join(VARIANTS)} (default: all)")
    args = p.parse_args(argv)
    names = args.variants or list(VARIANTS)
    unknown = [v for v in names if v not in VARIANTS]
    if unknown:
        p.error(f"unknown variant(s) {unknown}: mk27 has {', '.join(VARIANTS)}")
    dev, head = _bench.setup(args)
    g, rows = SMALL if args.small else FULL
    rng = np.random.default_rng(args.seed)
    extra = 32 * (REPS - 1) - PAD  # s8_aligned's rows past the script's block
    a_int = torch.from_numpy(rng.integers(-100, 100, (g, rows + PAD + extra, C)).astype(np.int8))
    w_int = torch.from_numpy(rng.integers(-100, 100, (REPS, C, CO)).astype(np.int8))
    recs = []
    for v in names:
        adt, pro, step, wdt = VARIANTS[v]
        offsets = [step * r for r in range(REPS)]
        ma = rows + (PAD if step == 1 else PAD + extra)
        a = a_int[:, :ma].contiguous().to(dev).to(adt)
        w = w_int.to(dev).to(wdt)
        wt = k12.pack_taps(w)
        yard = library = lib_err = None
        if dev.type == "cuda":
            cols = im2col(a, offsets, rows)
            if wdt == torch.int8:
                cols = k12.saturate_s8(cols).to(torch.int8) if pro == "cast" else cols
                wcol = wt.permute(1, 0, 2).reshape(CO, REPS * C)  # [N, R·K]
                yard = {"im2col_mm_ms": lambda: torch._int_mm(cols, wcol.t())}
            else:
                wcol = w.reshape(REPS * C, CO)
                yard = {"im2col_mm_ms": lambda: torch.matmul(cols, wcol)}
                library = conv1d_call(a, w, step, rows)
                ref = k12.flat_dot_plain(a, wt, offsets, rows, pro=pro)
                lib_err = float((library().transpose(1, 2).float() - ref.float()).abs().max())
                del ref
        nbytes = a.numel() * a.element_size() + w.numel() * w.element_size() + 2.0 * g * rows * CO
        peak = _bench.PEAK_BF16_OPS if wdt == torch.bfloat16 else _bench.PEAK_INT8_OPS
        rec = _bench.measure(f"shift_dot[mk27 {v}]",
                             lambda: k12.flat_dot(a, wt, offsets, rows, pro=pro),
                             lambda: k12.flat_dot_plain(a, wt, offsets, rows, pro=pro), dev,
                             work=(nbytes, 2.0 * g * rows * C * CO * REPS, peak),
                             library=library, yardsticks=yard,
                             prev=lambda: k12.flat_dot_prev(a, wt, offsets, rows, pro=pro),
                             graph=True)
        if lib_err is not None:
            rec["library_max_abs_err"] = lib_err
        recs.append({"variant": v, "kernel_name": "shift_dot", "offsets": offsets,
                     "a_shape": list(a.shape), **rec})
        del a, w, wt, yard, library
    record = {"experiment": "mk27_pallas_s8_dot", **head, "slices": g, "rows": rows,
              "variants": recs}
    _bench.emit(record)
    return record


if __name__ == "__main__":
    main()
