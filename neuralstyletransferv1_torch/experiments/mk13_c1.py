"""mk13 on the card: Johnson's conv1 as a block site, K11 ``c1_site``.

Port of ``experiments/mk13_c1.py``. Conv1 (9×9, 3 → 32, reflect pad 4) at
1080p B=8 in its f=2 block form: the image space-to-depth'd to 540×960×12
and phase-reflect-padded by two blocks a side, y12 [8, 544, 964, 12], then a
5×5 conv 12 → 128 (4 phases × 32) with f32 accumulation + bias → bf16
[8, 540, 960, 128]. The script's three modes (roll64, roll128, edot) are TPU
lane packings of this one function; K11 packs the five dx taps of a kernel
row into K = 64 instead. Timed against the cuDNN conv of the same block
tensor (bf16, channels-last: the library call that computes the function)
and the pixel-form conv1 it stands for (NCHW, as the bf16 net runs it, and
channels-last).

    python -m neuralstyletransferv1_torch.experiments.mk13_c1 [--ckpt PATH]
    python -m neuralstyletransferv1_torch.experiments.mk13_c1 --device cpu --small

Weights: Johnson's conv1 from a checkpoint (default: the repository's
full-width ``_testdata/test_johnson.pth``), carried to the block form by
``block_conv1_weights``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..io.checkpoints import import_transformer, load_state_dict
from ..kernels import bf16_sites as k9
from ..models.s2d import pad_reflect_f2_4px, s2d, scatter_k9_f2
from . import _bench

CKPT = Path(__file__).resolve().parents[2] / "_testdata" / "test_johnson.pth"
FULL = (8, 1080, 1920)     # B, H, W of the image
SMALL = (1, 16, 32)


def block_conv1_weights(w: np.ndarray, b: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """Johnson's conv1 (HWIO [9,9,3,32], bias [32]) → K11's operands: w
    [5,5,12,128] bf16 (``scatter_k9_f2``) and cb [128] f32 holding the bias
    tiled over the 4 phases and rounded to bf16, i.e. the JAX
    ``from_johnson_params``' ``c1_w`` / ``c1_b`` cast to bf16, as mk13 runs
    them."""
    wb = torch.from_numpy(scatter_k9_f2(np.asarray(w, np.float32))).to(torch.bfloat16)
    cb = torch.from_numpy(np.tile(np.asarray(b, np.float32), 4)).to(torch.bfloat16).float()
    return wb, cb


def conv1_params(ckpt: Path) -> tuple[np.ndarray, np.ndarray]:
    """Conv1's HWIO weights and bias from a Johnson checkpoint."""
    p = import_transformer(load_state_dict(str(ckpt)))["conv1"]
    return p["w"], p["b"]


def block_input(x01: torch.Tensor) -> torch.Tensor:
    """Image [B,H,W,3] (H, W even) → y12 [B,H/2+4,W/2+4,12]: space-to-depth,
    then the 4-pixel reflect on the block grid (mk13's ``mk_x12``)."""
    return pad_reflect_f2_4px(s2d(x01, 2), 3).contiguous()


def work(y12: torch.Tensor, wb: torch.Tensor) -> tuple[float, float]:
    """(bytes, FLOP) of K11's function: y12 and the weights read once, the
    [B,H,W,128] output written once, the 5×5×12 conv's operations."""
    b, hp, wp, _ = y12.shape
    out = b * (hp - 4) * (wp - 4) * k9.C1_OUT
    return (2.0 * (y12.numel() + out + wb.numel()) + 4.0 * k9.C1_OUT,
            2.0 * out * 25 * k9.C1_IN)


def yardsticks(y12, wb, cb, x01, w_hwio, bias) -> dict:
    """The cuDNN calls K11 is timed beside: the conv of the same block
    tensor (bf16, channels-last), and the pixel conv1 on the reflect-padded
    image, NCHW and channels-last."""
    dev = y12.device
    yb = y12.permute(0, 3, 1, 2)                     # NCHW view, channels-last memory
    wbo = wb.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    cbb = cb.to(torch.bfloat16)                      # exact: cb holds bf16 values
    xp = F.pad(x01.permute(0, 3, 1, 2), (4, 4, 4, 4), mode="reflect").contiguous()
    wp = torch.from_numpy(np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1)))).to(dev).to(
        torch.bfloat16)
    bp = torch.from_numpy(np.asarray(bias, np.float32)).to(dev).to(torch.bfloat16)
    xpl, wpl = (t.contiguous(memory_format=torch.channels_last) for t in (xp, wp))
    return {"cudnn_block": lambda: F.conv2d(yb, wbo, cbb),
            "cudnn_pixel_nchw": lambda: F.conv2d(xp, wp, bp),
            "cudnn_pixel_channels_last": lambda: F.conv2d(xpl, wpl, bp)}


def main(argv=None) -> dict:
    p = _bench.parser(__doc__)
    p.add_argument("--ckpt", type=Path, default=CKPT, help="a Johnson .pth (default: %(default)s)")
    args = p.parse_args(argv)
    dev, head = _bench.setup(args)
    shape = SMALL if args.small else FULL
    w_hwio, bias = conv1_params(args.ckpt)
    wb, cb = (t.to(dev) for t in block_conv1_weights(w_hwio, bias))
    b, h, w = shape
    rng = np.random.default_rng(args.seed)
    x01 = torch.from_numpy(rng.random((b, h, w, 3), dtype=np.float32)).to(dev).to(torch.bfloat16)
    y12 = block_input(x01)
    out, again = k9.c1_site(y12, wb, cb), k9.c1_site(y12, wb, cb)
    rec = {"experiment": "mk13_c1", **head, "shape": [b, h // 2 + 4, w // 2 + 4, 12],
           "weights": args.ckpt.name, "kernel_name": "c1_site",
           **_bench.check("c1_site", out, again, k9.c1_site_plain(y12, wb, cb))}
    del out, again
    if dev.type == "cuda":
        moved, flops = work(y12, wb)
        rec.update(_bench.bound(moved, flops))
        lib = yardsticks(y12, wb, cb, x01, w_hwio, bias)
        t = _bench.in_turns({
            "ms": (lambda: k9.c1_site(y12, wb, cb), 10),
            "plain_ms": (lambda: k9.c1_site_plain(y12, wb, cb), 2),
            "library_ms": (lib["cudnn_block"], 10),
            "cudnn_pixel_nchw_ms": (lib["cudnn_pixel_nchw"], 3),
            "cudnn_pixel_channels_last_ms": (lib["cudnn_pixel_channels_last"], 3)})
        rec.update({k: v["ms"] for k, v in t.items()})
        rec["spread"] = {k: v["spread"] for k, v in t.items()}
        rec["kernel_tflops"] = flops / rec["ms"] / 1e9
        rec["blocks_per_sm"], rec["smem_bytes"] = k9.occupancy()["c1_site"]
        del lib
        torch.cuda.empty_cache()
    _bench.emit(rec)
    return rec


if __name__ == "__main__":
    main()
