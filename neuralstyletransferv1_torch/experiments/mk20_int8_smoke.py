"""mk20 on the card: the int8 smoke probes, K12 ``shift_dot``.

Port of ``experiments/mk20_int8_smoke.py``. Three probes:

 1. the res conv as an im2col matmul, [8·270·480, 1152] × [1152, 128],
    s8 → s32 and bf16 → f32: a library call on the TPU (XLA's dot) and
    here (``torch._int_mm``, ``torch.mm``); its operands are drawn on the
    device from a seeded ``torch.Generator`` (1.2 G elements), and
    ``_int_mm`` is spot-checked against an exact f64 product;
 2. the plain dot [16384, 512] × [512, 256] (the script's Pallas kernel,
    TM = 512), s8 → s32 and bf16 → f32, on K12's flat form (one tap, K =
    512), beside ``torch._int_mm`` / ``torch.mm`` (the library calls that
    compute the same function);
 3. the 9-tap res-site dot of the script's kernel on x [8, 274, 488, 128]
    → [8, 272, 488, 128], strips of 8 rows flattened (no column halo: the
    dx taps run into the next row), on K12's strip form: int8 (quantize
    x·16 in the prologue, out ·2^-8) and its bf16 twin (no scale), beside
    the cuDNN bf16 3×3 conv (``cudnn_bf16_ms``, a yardstick).

    python -m neuralstyletransferv1_torch.experiments.mk20_int8_smoke
    python -m neuralstyletransferv1_torch.experiments.mk20_int8_smoke --device cpu --small

The script's timing, a chain of 8 calls minus a chain of 1 on the host
clock, becomes per-call CUDA events in turns (``_bench.cuda_ms``,
``_bench.in_turns``); probe 2, shorter than its wrapper's host time, is
timed by CUDA graph replay (``_bench.graph_ms``), its library calls too.
Probes 2 and 3 time K12's previous core in the same turns (``prev_ms``).
Probe 2's bf16 form sums f32 products in the MMA's order: it is held
within 1e-5·Σ_k |a_k b_k| of the plain version; every other form is exact
and held bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import int8_probes as k12
from . import _bench

P1 = (8 * 270 * 480, 9 * 128, 128)   # M, K, N
P2 = (1024 * 16, 512, 256)
P3 = (8, 272, 488, 128)              # B, H (output rows), W (padded), C
SMALL_P1, SMALL_P2, SMALL_P3 = (256, 1152, 128), (256, 512, 256), (1, 16, 24, 128)
F32_TOL = 1e-5   # probe 2 bf16: of Σ_k |a_k b_k| per element
SPOT_ROWS = 4096  # probe 1: rows of _int_mm checked against the f64 product


def check_f32(scale: torch.Tensor):
    """Probe 2's bf16 → f32 check: two launches bit-identical, every
    element within ``F32_TOL``·``scale`` (Σ_k |a_k b_k|) of the plain
    version (both sum exact products in f32, in different orders)."""
    def check(name, out, again, ref):
        if not torch.equal(out, again):
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        err = (out.double() - ref.double()).abs()
        worst = float((err / scale.double().clamp_min(1e-30)).max())
        if worst > F32_TOL:
            raise AssertionError(f"{name}: {worst:.3g} of Σ|ab| from the plain version "
                                 f"(limit {F32_TOL})")
        return {"max_abs_err": float(err.max()), "rel_to_abs_sum": worst}
    return check


def _ints(rng, shape, lo, hi, dev, dtype=torch.int8):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8)).to(dev).to(dtype)


def probe1(shape, seed, dev) -> list:
    """XLA's int8 and bf16 dot at the res conv's im2col shape: the library
    calls, timed (no kernel of the port)."""
    m, k, n = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randint(-127, 127, (m, k), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 127, (n, k), generator=g, device=dev, dtype=torch.int8).t()
    spot = torch._int_mm(a[:SPOT_ROWS], b)
    if not torch.equal(spot, (a[:SPOT_ROWS].double() @ b.double()).round().int()):
        raise AssertionError("probe1: torch._int_mm differs from the exact product")
    recs = [{"probe": 1, "form": "int8", "shape": list(shape), "library": "torch._int_mm"},
            {"probe": 1, "form": "bf16", "shape": list(shape), "library": "torch.mm, f32 out"}]
    if dev.type == "cuda":
        ab = torch.randn((m, k), generator=g, device=dev, dtype=torch.bfloat16)
        bb = torch.randn((n, k), generator=g, device=dev, dtype=torch.bfloat16).t()
        t = _bench.in_turns({"int8": (lambda: torch._int_mm(a, b), 10),
                             "bf16": (lambda: torch.mm(ab, bb, out_dtype=torch.float32), 10)})
        for rec in recs:
            rec.update(library_ms=t[rec["form"]]["ms"], spread=t[rec["form"]]["spread"],
                       tops=2.0 * m * k * n / t[rec["form"]]["ms"] / 1e9)
        del ab, bb
    del a, b
    return recs


def probe2(shape, seed, dev) -> list:
    """The script's Pallas dot on K12's flat form: s8 → s32, bf16 → f32."""
    m, k, n = shape
    rng = np.random.default_rng(seed)
    recs = []
    for form in ("int8", "bf16"):
        if form == "int8":
            a, b = _ints(rng, (m, k), -127, 127, dev), _ints(rng, (k, n), -127, 127, dev)
            out, check, nbytes = "s32", None, m * k + k * n + 4 * m * n
            peak = _bench.PEAK_INT8_OPS
        else:
            a, b = _bench.normal(rng, (m, k), 1.0, dev), _bench.normal(rng, (k, n), 1.0, dev)
            scale = a.abs().float() @ b.abs().float()
            out, check, nbytes = "f32", check_f32(scale), 2 * m * k + 2 * k * n + 4 * m * n
            peak = _bench.PEAK_BF16_OPS
        bt = k12.pack_taps(b[None])
        if form == "int8":
            library = lambda: torch._int_mm(a, bt[0].t())  # noqa: E731
        else:
            library = lambda: torch.mm(a, b, out_dtype=torch.float32)  # noqa: E731
        rec = _bench.measure(f"shift_dot[flat {form}]", lambda: k12.flat_dot(a, bt, [0], out=out),
                             lambda: k12.flat_dot_plain(a, bt, [0], out=out), dev, check_fn=check,
                             work=(nbytes, 2.0 * m * k * n, peak),
                             library=library if dev.type == "cuda" else None,
                             prev=lambda: k12.flat_dot_prev(a, bt, [0], out=out), graph=True)
        recs.append({"probe": 2, "form": form, "kernel_name": "shift_dot", "shape": list(shape),
                     **rec})
        del a, b, bt
    return recs


def strip_work(x, wt) -> tuple:
    """(bytes, operations) of K12's strip form: x and the weights read once,
    the bf16 output written once, and every one of the H·W output rows' 9
    dots (all W columns, as the TPU kernel computes them)."""
    b, h2, w, c = x.shape
    n = wt.shape[1]
    return (x.numel() * x.element_size() + wt.numel() * wt.element_size()
            + 2.0 * b * (h2 - 2) * w * n, 2.0 * b * (h2 - 2) * w * 9 * c * n)


def probe3(shape, seed, dev) -> list:
    """The script's res-shaped kernel on K12's strip form: int8 and bf16."""
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    x = _bench.normal(rng, (b, h + 2, w, c), 1.0, dev)
    conv = {"cudnn_bf16_ms": _bench.conv3x3(x, c, 0)} if dev.type == "cuda" else None
    recs = []
    for form in ("int8", "bf16"):
        if form == "int8":
            wt = k12.pack_taps(_ints(rng, (9, c, c), -127, 127, dev))
            kw = {"pro": "quant", "oscale": 2.0 ** -8}
            exact, peak = True, _bench.PEAK_INT8_OPS
        else:
            wt = k12.pack_taps(_bench.normal(rng, (9, c, c), 1.0, dev))
            kw = {}
            exact, peak = False, _bench.PEAK_BF16_OPS
        rec = _bench.measure(f"shift_dot[strip {form}]", lambda: k12.strip_dot(x, wt, **kw),
                             lambda: k12.strip_dot_plain(x, wt, **kw), dev, exact=exact,
                             work=(*strip_work(x, wt), peak), yardsticks=conv,
                             prev=lambda: k12.strip_dot_prev(x, wt, **kw), reps=5)
        recs.append({"probe": 3, "form": form, "kernel_name": "shift_dot", "shape": list(shape),
                     **rec})
        del wt
    return recs


def main(argv=None) -> dict:
    args = _bench.parser(__doc__).parse_args(argv)
    dev, head = _bench.setup(args)
    p1, p2, p3 = (SMALL_P1, SMALL_P2, SMALL_P3) if args.small else (P1, P2, P3)
    rec = {"experiment": "mk20_int8_smoke", **head,
           "probes": probe1(p1, args.seed, dev) + probe2(p2, args.seed, dev)
           + probe3(p3, args.seed, dev)}
    _bench.emit(rec)
    return rec


if __name__ == "__main__":
    main()
