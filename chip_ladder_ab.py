#!/usr/bin/env python3
"""Design A/B of the weight ladder and the Gram NST on one NVIDIA GPU.

    python3 chip_ladder_ab.py

Run from the root of a checkout on a machine with a CUDA GPU. Two choices
of ``chip_smoke.py`` phase 13's cells, each timed in turns on the card and
printed as one JSON line with the card's name and power limit:

1. the ladder bank (8 random full-width Johnson slots, bf16, 1080×1920 B=2)
   as ``jit_ladder_stylizer``'s loop over the nets against a ``vmap`` of
   ``functional_call`` over their stacked weights (CUDA events, 5 rounds;
   the two outputs' MAE and the vmap's peak memory);
2. the Gram NST (VGG16 from seed 0, 512², f32) over 100 steps with the VGG
   trunk on contiguous NCHW (``vgg.extract_features``) against the same
   trunk on the channels-last view of the NHWC input, each with and
   without ``cudnn.benchmark`` (host clock around synchronized calls, each
   variant twice in the order a b c d d c b a, after a 5-step warm-up).
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))


def ladder_ab(dev, res: dict) -> None:
    import numpy as np
    import torch
    from torch.func import functional_call, stack_module_state, vmap

    from chip_smoke import moving_frames
    from neuralstyletransferv1_torch.engine import stylizer as tst
    from neuralstyletransferv1_torch.experiments._bench import in_turns
    from neuralstyletransferv1_torch.models import io_presets as iop

    x = torch.from_numpy(np.stack(moving_frames(2, 1080, 1920, 40))).to(dev).float() / 255.0
    bank = [tst.make_random_model("johnson", seed=s, device=dev) for s in range(8)]
    loop = tst.jit_ladder_stylizer(bank, dtype=torch.bfloat16)
    params, bufs = stack_module_state([copy.deepcopy(m.net).to(torch.bfloat16) for m in bank])
    base = copy.deepcopy(bank[0].net).to("meta")
    preset = bank[0].io_preset

    @torch.no_grad()
    def vm(x01):
        xin = iop.preprocess(preset, x01.to(torch.bfloat16))
        y = vmap(lambda p, b: functional_call(base, (p, b), (xin,)))(params, bufs)
        return iop.postprocess(preset, y).float()

    res["vmap_vs_loop_mae"] = (loop(x) - vm(x)).abs().mean().item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vm(x)
    torch.cuda.synchronize()
    res["vmap_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    t = in_turns({"loop": (lambda: loop(x), 1), "vmap": (lambda: vm(x), 1)}, 5)
    for k in ("loop", "vmap"):
        res[f"ladder_{k}_ms"], res[f"ladder_{k}_spread"] = t[k]["ms"], t[k]["spread"]


def gram_ab(dev, res: dict) -> None:
    import torch
    from torch import nn

    from neuralstyletransferv1_torch.engine import gram_nst
    from neuralstyletransferv1_torch.models import vgg

    net = vgg.load(vgg.init(0), dev)
    gen = torch.Generator(device=dev).manual_seed(42)
    c, s = (torch.rand((1, 512, 512, 3), generator=gen, device=dev) for _ in range(2))
    nchw = vgg.extract_features

    def channels_last(net_, x01, layers):
        """``extract_features`` on the channels-last view (no ``contiguous``)."""
        y = (x01.permute(0, 3, 1, 2) - net_.mean) / net_.std
        want, feats, i = set(layers), {}, 0
        for m in net_.features:
            y = m(y)
            if isinstance(m, nn.ReLU):
                name = vgg.RELU_NAMES[i]
                i += 1
                if name in want:
                    feats[name] = y.permute(0, 2, 3, 1)
                    if len(feats) == len(want):
                        break
        return feats

    def run(variant, steps):
        vgg.extract_features = channels_last if variant.startswith("nhwc") else nchw
        torch.backends.cudnn.benchmark = variant.endswith("bench")
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, hist = gram_nst.optimize(net, c, s, steps=steps)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, out, hist
        finally:
            vgg.extract_features = nchw
            torch.backends.cudnn.benchmark = False

    variants = ("nchw", "nhwc", "nchw_bench", "nhwc_bench")
    for v in variants:
        run(v, 5)
    secs, outs = {v: [] for v in variants}, {}
    for v in variants + variants[::-1]:
        t, out, hist = run(v, 100)
        secs[v].append(t)
        outs[v] = (out, hist)
    ref_out, ref_hist = outs["nchw"]
    for v in variants:
        res[f"gram100_{v}_s"] = secs[v]
        res[f"gram100_{v}_vs_nchw_img_mae"] = (outs[v][0] - ref_out).abs().mean().item()
        res[f"gram100_{v}_vs_nchw_hist_rel"] = ((outs[v][1] - ref_hist).abs()
                                                / ref_hist.abs()).max().item()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ladder_ab: no CUDA GPU is visible", file=sys.stderr)
        return 1
    from neuralstyletransferv1_torch.device import resolve_device

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    res = {"card": smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None}
    dev = resolve_device("cuda")
    ladder_ab(dev, res)
    gram_ab(dev, res)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
