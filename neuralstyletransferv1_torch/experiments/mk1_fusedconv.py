"""mk1 on the card: the fused res-block conv site, K10 ``fused_conv``.

Port of ``experiments/mk1_fusedconv.py``. One res-block conv site at the
Johnson res grid of a 1080p batch (B=8, 270×480, 128 → 128, bf16
activations, f32 accumulation): the deferred per-(image, channel) affine +
ReLU applied to every position read of the padded raw input, a 3×3 conv,
+ bias, bf16 out and the f32 [Σ, Σ²] that the next norm needs. The XLA
reference it is timed against is three passes: prologue, conv, statistics;
here the cuDNN conv between a prologue and a statistics pass, eager
(``eager_path``) and under ``torch.compile`` (``compiled_path``).

    python -m neuralstyletransferv1_torch.experiments.mk1_fusedconv
    python -m neuralstyletransferv1_torch.experiments.mk1_fusedconv --device cpu --small

As the script's bench, x_pad is (B, H+2, W+8, C) of seeded normals: its
halo and junk columns are random, the prologue is applied to the halo, and
the 6 columns past W+2 are never read. mk2, mk3 and mk5 run their variants
through ``run_variants``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import bf16_sites as k9
from . import _bench

FULL = (8, 270, 480, 128, 128)     # B, H, W, C, CO
SMALL = (2, 8, 16, 128, 128)
JUNK = 6                           # columns of x_pad past W + 2 (mk1: W + 8)


def inputs(shape, seed: int, dev) -> dict:
    """mk1's operands from a numpy seed: x_pad [B,H+2,W+8,C] bf16 normal,
    stat [B,2,C] f32 normal·0.1, w9 [9,C,CO] bf16 normal·0.05, cb [CO] f32
    normal."""
    b, h, w, c, co = shape
    rng = np.random.default_rng(seed)
    return {"x_pad": _bench.normal(rng, (b, h + 2, w + 2 + JUNK, c), 1.0, dev),
            "stat": _bench.normal(rng, (b, 2, c), 0.1, dev, torch.float32),
            "w9": _bench.normal(rng, (9, c, co), 0.05, dev),
            "cb": _bench.normal(rng, (co,), 1.0, dev, torch.float32)}


def eager_path(ins: dict, hw, prologue: str, stats: bool):
    """The XLA reference's three passes in eager PyTorch: the prologue pass,
    the cuDNN bf16 conv (channels-last, bf16 bias) and the statistics pass
    over its output, each op its own kernel (f32 intermediates). A yardstick
    of time, not of the function: cuDNN rounds to bf16 before the
    statistics and rounds the bias."""
    h, w = hw
    x = ins["x_pad"][:, :h + 2, :w + 2]
    xa = k9._prologue(x, ins["stat"], prologue).permute(0, 3, 1, 2)
    y = F.conv2d(xa, _oihw(ins["w9"]), ins["cb"].to(torch.bfloat16))
    if not stats:
        return y
    yf = y.float()
    return y, torch.stack([yf.sum((2, 3)), yf.square().sum((2, 3))], 1)


@functools.cache
def _compiled_path():
    return torch.compile(eager_path, dynamic=False)


def compiled_path(ins: dict, hw, prologue: str, stats: bool):
    """``eager_path`` under ``torch.compile``: the prologue and the
    statistics become one generated kernel each, the conv stays cuDNN's.
    The three-pass path at its best; a yardstick only."""
    return _compiled_path()(ins, hw, prologue, stats)


def _oihw(w9: torch.Tensor) -> torch.Tensor:
    c, co = w9.shape[1], w9.shape[2]
    return w9.reshape(3, 3, c, co).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def cudnn_conv(ins: dict, hw):
    """The cuDNN bf16 3×3 conv alone, on a channels-last input of the
    padded tile's size (the library call that computes the conv)."""
    h, w = hw
    x = ins["x_pad"][:, :h + 2, :w + 2].permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    wc, cb = _oihw(ins["w9"]), ins["cb"].to(torch.bfloat16)
    return lambda: F.conv2d(x, wc, cb)


def work(ins: dict, hw, stats: bool) -> tuple[float, float]:
    """(bytes, FLOP) of K10's function: the padded tile read once, the
    output (and sums) written once, and the 3×3 conv's operations."""
    b, h, w = ins["x_pad"].shape[0], *hw
    c, co = ins["w9"].shape[1], ins["w9"].shape[2]
    moved = 2.0 * (b * (h + 2) * (w + 2) * c + b * h * w * co + 9 * c * co) + 4.0 * (
        ins["stat"].numel() + co + (2 * b * co if stats else 0))
    return moved, 2.0 * b * h * w * 9 * c * co


def path_bytes(ins: dict, hw, prologue: str, stats: bool) -> float:
    """The least bytes the three-pass path moves: the prologue pass reads
    and writes the padded tile, the conv reads it and writes the output,
    the statistics pass reads the output again."""
    b, h, w = ins["x_pad"].shape[0], *hw
    c, co = ins["w9"].shape[1], ins["w9"].shape[2]
    tile, out = 2.0 * b * (h + 2) * (w + 2) * c, 2.0 * b * h * w * co
    moved, _ = work(ins, hw, stats)
    return moved + (2 * tile if prologue != "none" else 0.0) + (out if stats else 0.0)


def run_form(ins: dict, hw, prologue: str, stats: bool, dev) -> dict:
    """K10 in one functional form: checked against the plain version and,
    on the card, timed in turns beside it, K10's previous core
    (``prev_ms``), the cuDNN conv alone (the library call), and the
    three-pass path eager and compiled."""
    name = f"fused_conv[{prologue}{'' if stats else ',no stats'}]"
    call = (ins["x_pad"], ins["stat"], ins["w9"], ins["cb"], hw)
    kw = {"prologue": prologue, "stats": stats}
    (y, s), (y2, s2) = k9.fused_conv(*call, **kw), k9.fused_conv(*call, **kw)
    yr, sr = k9.fused_conv_plain(*call, **kw)
    rec = {"prologue": prologue, "stats": stats,
           **_bench.check(name, y, y2, yr, sums=s, sums_again=s2, sums_ref=sr)}
    del y, y2, yr, s, s2, sr
    if dev.type != "cuda":
        return rec
    moved, flops = work(ins, hw, stats)
    rec.update(_bench.bound(moved, flops))
    rec["path_bound_ms"] = _bench.bound(path_bytes(ins, hw, prologue, stats), flops)["bound_ms"]
    path = (ins, hw, prologue, stats)
    (yp, sp), (yp2, sp2) = k9.fused_conv_prev(*call, **kw), k9.fused_conv_prev(*call, **kw)
    yr, sr = k9.fused_conv_plain(*call, **kw)
    _bench.check(name + " (previous core)", yp, yp2, yr, sums=sp, sums_again=sp2, sums_ref=sr)
    del yp, yp2, sp, sp2, yr, sr
    t = _bench.in_turns({
        "ms": (lambda: k9.fused_conv(*call, **kw), 10),
        "prev_ms": (lambda: k9.fused_conv_prev(*call, **kw), 10),
        "plain_ms": (lambda: k9.fused_conv_plain(*call, **kw), 2),
        "library_ms": (cudnn_conv(ins, hw), 10),
        "eager_path_ms": (lambda: eager_path(*path), 10),
        "compiled_path_ms": (lambda: compiled_path(*path), 10)})
    rec.update({k: v["ms"] for k, v in t.items()})
    rec["spread"] = {k: v["spread"] for k, v in t.items()}
    rec["kernel_tflops"] = flops / rec["ms"] / 1e9
    rec["blocks_per_sm"], rec["smem_bytes"] = k9.occupancy()["fused_conv"]
    torch.cuda.empty_cache()
    return rec


def run_variants(experiment: str, doc: str, variants: dict, argv=None, default=None) -> dict:
    """Parse ``argv``, run K10 once in each functional form that the named
    variants (``{name: (prologue, stats, what it is on the TPU)}``) take,
    and print one JSON line listing every variant with its form's record.
    ``doc``: the entry point's docstring."""
    p = _bench.parser(doc)
    p.add_argument("variants", nargs="*", help=f"of {', '.join(variants)} "
                   f"(default: {', '.join(default or variants)})")
    args = p.parse_args(argv)
    names = args.variants or list(default or variants)
    unknown = [v for v in names if v not in variants]
    if unknown:
        p.error(f"unknown variant(s) {unknown}: {experiment} has {', '.join(variants)}")
    dev, head = _bench.setup(args)
    shape = SMALL if args.small else FULL
    ins = inputs(shape, args.seed, dev)
    hw = shape[1:3]
    forms = {}
    for v in names:
        form = variants[v][:2]
        if form not in forms:
            forms[form] = run_form(ins, hw, *form, dev)
    record = {"experiment": experiment, **head, "shape": list(shape),
              "variants": [{"variant": v, "tpu": variants[v][2], **forms[variants[v][:2]]}
                           for v in names]}
    _bench.emit(record)
    return record


#: mk1's unit: the f32 prologue (``prologue="affine_relu"``, timed by the
#: script) or none (any other ``prologue``), with statistics
VARIANTS = {"fused": ("f32", True, "fused_conv, TH=18 strips, 9 tap dots"),
            "noprologue": ("none", True, "fused_conv with prologue != 'affine_relu'")}


def main(argv=None) -> dict:
    return run_variants("mk1_fusedconv", __doc__, VARIANTS, argv, default=["fused"])


if __name__ == "__main__":
    main()
