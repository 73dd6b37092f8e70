"""mk28 on the card: the int8 res-site lowering probes, K13 ``pad_inject``
and K4 ``res_site``.

Port of ``experiments/mk28_probe.py``, one strip of 8 rows at the 1080p res
width (480 → 488 columns, 128 channels):

  P1  ``p1_pad``: bf16 [1, 8, 480, 128] → [1, 8, 488, 128], columns 1..480
      the input, the others 0 (K13; held against its plain version on a
      seeded normal input, and the script's column-sum check on its input
      of ones)
  P2  ``p2_inject``: clamp(round(x·4), ±127) → s8, the same pad, then column
      0 ← input column 1 and column 482 ← input column 478 (the probe's own
      indices; column 481 stays 0) (K13 with ``inject``, x normal·8)
  P5  ``p5_mini_site``: quantize x·4, reflect column halo, 9-tap s8 conv,
      bf16(f32(acc)) on a [1, 10, 480, 128] strip → its 8 interior rows:
      K4 in its no-statistics form on the 10-row strip (a = 4, c = 0, lo =
      −127, ws = 1, bias = 0), rows 1..8 (interior rows read no row halo)

Each is held bit for bit against its plain version and, on the card's
outputs, the script's own numpy asserts (P1's column sums, P2's injected
columns, P5's int64 conv oracle) are rerun. The probes are single strips
of about 1 MB, far from their bound on the device (the bound is printed
all the same). Beside them: ``F.pad`` (P1, the same function: ``library_ms``), the
cuDNN bf16 3×3 conv on the strip (P5, a yardstick: ``cudnn_bf16_ms``); P2
has no one-call counterpart. K13 also runs on its previous core
(``pad_inject_prev``: ``prev_ms``, held bit for bit against the plain
version), and beside the strip, in the same turns, at its launch floor
(``floor_ms``, ``floor_prev_ms``: the smallest legal call, B = R = 1, W0 =
3, WP = 4, or 6 with the inject, C = 8); and P1 and P2 again at the shape
P5 stands for, the int8 res site's input at 1080p B=8, [8, 270, 480, 128]
→ 488 columns (``P1 res``, ``P2 res``; timed by CUDA events, each call
hundreds of microseconds).

    python -m neuralstyletransferv1_torch.experiments.mk28_probe
    python -m neuralstyletransferv1_torch.experiments.mk28_probe --device cpu --small

Times are CUDA graph replay in turns (``_bench.measure(graph=True)``): each
call, its plain version and ``F.pad`` or the cuDNN yardstick captured
``reps`` times into one graph and the replay timed, the device time a
call. A per-call CUDA event around one of these strips would time the
wrapper's host work (allocation, checks, ctypes: tens of microseconds), not
the kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import int8_probes as k13
from ..kernels import int8_sites as k8
from . import _bench

FULL = (8, 480, 128)   # R, W0, C
SMALL = (8, 20, 128)
RES_FULL = (8, 270, 480, 128)   # B, R, W0, C: the int8 res site's input at 1080p B=8
RES_SMALL = (2, 6, 20, 128)
FLOOR = (1, 1, 3, 8)   # K13's smallest legal call
QSCALE = 4.0


def wp_of(w0: int) -> int:
    """The padded width: W0 + 2 rounded up to 8 (488 at 480)."""
    return (w0 + 2 + 7) // 8 * 8


def p1_assert(out: torch.Tensor, w0: int) -> None:
    """The script's check of P1 on a ones input: column sums zero at 0 and
    W0 + 1, nonzero at 1 and W0."""
    s = out.float().sum(dim=(0, 1, 3)).cpu().numpy()
    assert s[0] == 0 and s[1] != 0 and s[w0] != 0 and s[w0 + 1] == 0, s[:4]


def p2_assert(out: torch.Tensor, x: torch.Tensor, w0: int) -> None:
    """The script's check of P2: the codes at columns 1..W0, 0 and W0 + 2."""
    o = out.cpu().numpy().astype(np.int32)[0]
    qs = np.clip(np.round(x.float().cpu().numpy() * QSCALE), -127, 127).astype(np.int32)[0]
    assert (o[:, 1:w0 + 1] == qs).all()
    assert (o[:, 0] == qs[:, 1]).all()
    assert (o[:, w0 + 2] == qs[:, w0 - 2]).all()


def p5_oracle(x: torch.Tensor, wn: np.ndarray) -> np.ndarray:
    """The script's numpy oracle: quantize, reflect-pad 1 column, the 9-tap
    int64 conv over the strip's interior rows, bf16."""
    ts = x.shape[1] - 2
    w0 = x.shape[2]
    xq = np.clip(np.round(x.float().cpu().numpy() * QSCALE), -127, 127).astype(np.int64)[0]
    xp = np.pad(xq, ((0, 0), (1, 1), (0, 0)), mode="reflect")
    ref = np.zeros((ts, w0, wn.shape[-1]), np.int64)
    for dy in range(3):
        for dx in range(3):
            ref += np.einsum("hwc,cd->hwd", xp[dy:dy + ts, dx:dx + w0],
                             wn[dy * 3 + dx].astype(np.int64))
    return torch.from_numpy(ref.astype(np.float32)).to(torch.bfloat16).float().numpy()


def p5_operands(x: torch.Tensor, wn: np.ndarray) -> tuple:
    """K4's operands for P5: a = 4, c = 0 (B, C), lo = −127, the weights
    packed, ws = 1, bias = 0."""
    b, c, dev = x.shape[0], x.shape[-1], x.device
    wk = k8.pack_weights(torch.from_numpy(wn).reshape(3, 3, c, -1)).to(dev)
    co = wn.shape[-1]
    return (torch.full((b, c), QSCALE, device=dev), torch.zeros((b, c), device=dev), -127.0, wk,
            torch.ones(co, device=dev), torch.zeros(co, device=dev))


def pad_calls(x: torch.Tensor, wp: int, inject: bool, dev) -> tuple:
    """(K13, its plain version, and on the card its previous core) of one
    form on x."""
    prev = (lambda: k13.pad_inject_prev(x, wp, inject=inject)) if dev.type == "cuda" else None
    return (lambda: k13.pad_inject(x, wp, inject=inject),
            lambda: k13.pad_inject_plain(x, wp, inject=inject), prev)


def pad_work(x: torch.Tensor, wp: int, inject: bool) -> tuple:
    """(bytes, operations) of K13 on x: x read once, the bf16 (P1) or s8
    (P2) output written once."""
    b, r, _, c = x.shape
    return 2.0 * x.numel() + (1 if inject else 2) * b * r * wp * c, 0.0


def floor_calls(xf: torch.Tensor, inject: bool, dev) -> dict | None:
    """K13 and its previous core at the launch floor (``FLOOR``), each held
    bit for bit against the plain version first: timed beside the strip."""
    if dev.type != "cuda":
        return None
    wp = xf.shape[2] + (3 if inject else 1)
    ref = k13.pad_inject_plain(xf, wp, inject=inject)
    for fn in (k13.pad_inject, k13.pad_inject_prev):
        if not torch.equal(fn(xf, wp, inject=inject), ref):
            raise AssertionError(f"pad_inject at the launch floor ({fn.__name__}) differs from "
                                 "the plain version")
    return {"floor_ms": lambda: k13.pad_inject(xf, wp, inject=inject),
            "floor_prev_ms": lambda: k13.pad_inject_prev(xf, wp, inject=inject)}


def main(argv=None) -> dict:
    args = _bench.parser(__doc__).parse_args(argv)
    dev, head = _bench.setup(args)
    r, w0, c = SMALL if args.small else FULL
    wp = wp_of(w0)
    on_card = dev.type == "cuda"
    recs = []

    xf = _bench.normal(np.random.default_rng(args.seed + 3), FLOOR, 8.0, dev)
    x1 = _bench.normal(np.random.default_rng(args.seed + 2), (1, r, w0, c), 1.0, dev)
    call, plain, prev = pad_calls(x1, wp, False, dev)
    rec = _bench.measure("pad_inject[P1]", call, plain, dev, prev=prev,
                         work=pad_work(x1, wp, False),
                         library=(lambda: F.pad(x1, (0, 0, 1, wp - w0 - 1))) if on_card else None,
                         yardsticks=floor_calls(xf, False, dev), graph=True)
    p1_assert(k13.pad_inject(torch.ones_like(x1), wp), w0)
    recs.append({"probe": "P1 pad", "form": "P1", "kernel_name": "pad_inject", **rec})

    rng = np.random.default_rng(args.seed)
    x2 = _bench.normal(rng, (1, r, w0, c), 8.0, dev)
    call, plain, prev = pad_calls(x2, wp, True, dev)
    rec = _bench.measure("pad_inject[P2]", call, plain, dev, prev=prev,
                         work=pad_work(x2, wp, True), yardsticks=floor_calls(xf, True, dev),
                         graph=True)
    p2_assert(k13.pad_inject(x2, wp, inject=True), x2, w0)
    recs.append({"probe": "P2 inject", "form": "P2", "kernel_name": "pad_inject", **rec})

    # P1 and P2 at the res site's input, the shape P5 stands for
    rb, rr, rw0, rc = RES_SMALL if args.small else RES_FULL
    rwp = wp_of(rw0)
    for inject, probe in ((False, "P1"), (True, "P2")):
        x = _bench.normal(np.random.default_rng(args.seed + 4 + inject), (rb, rr, rw0, rc),
                          8.0 if inject else 1.0, dev)
        lib = (lambda: F.pad(x, (0, 0, 1, rwp - rw0 - 1))) if on_card and not inject else None
        call, plain, prev = pad_calls(x, rwp, inject, dev)
        rec = _bench.measure(f"pad_inject[{probe} res]", call, plain, dev, prev=prev,
                             work=pad_work(x, rwp, inject), library=lib)
        recs.append({"probe": f"{probe} res-site shape", "form": f"{probe} res",
                     "shape": [rb, rr, rw0, rc], "wp": rwp, "kernel_name": "pad_inject", **rec})
        del x, lib, call, plain, prev

    rng = np.random.default_rng(args.seed + 1)
    x5 = _bench.normal(rng, (1, r + 2, w0, c), 8.0, dev)
    wn = rng.integers(-20, 20, (9, c, c)).astype(np.int8)
    ops = p5_operands(x5, wn)

    def site():
        return k8.res_site(x5, *ops, stats=False)

    def plain():
        return k8.res_site_plain(x5, *ops, stats=False)

    nb = 2.0 * (x5.numel() + x5.numel()) + wn.size
    rec = _bench.measure("res_site[P5, no stats]", site, plain, dev,
                         check_kw={"zero_sums": True},
                         work=(nb, 2.0 * x5.numel() * 9 * c, _bench.PEAK_INT8_OPS),
                         yardsticks={"cudnn_bf16_ms": _bench.conv3x3(x5, c, 1)} if on_card
                         else None, graph=True)
    got = site()[0][0, 1:r + 1].float().cpu().numpy()
    if not np.array_equal(got, p5_oracle(x5, wn)):
        raise AssertionError("P5: rows 1..8 differ from the script's int64 oracle")
    recs.append({"probe": "P5 mini site", "form": "P5", "kernel_name": "res_site_nostats", **rec})

    for rec in recs:
        if "res" not in rec["form"]:
            rec["note"] = "one strip of about 1 MB, timed by CUDA graph replay"
    record = {"experiment": "mk28_probe", **head, "shape": [r, w0, c], "wp": wp, "probes": recs}
    _bench.emit(record)
    return record


if __name__ == "__main__":
    main()
