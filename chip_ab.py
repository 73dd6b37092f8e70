#!/usr/bin/env python3
"""Parts of ``chip_smoke.py`` run on one tree, for comparing two trees on one
card in turns.

    python3 chip_ab.py ROOT slices [--nst-chain]
    python3 chip_ab.py ROOT kernels
    python3 chip_ab.py ROOT bf16
    python3 chip_ab.py ROOT k1
    python3 chip_ab.py ROOT experiments
    python3 chip_ab.py ROOT profile
    python3 chip_ab.py ROOT reco
    python3 chip_ab.py ROOT convs

ROOT is the root of a checkout (for example the parent commit unpacked with
``git archive`` into a gitignored directory); its own ``chip_smoke.py`` and
package are imported and its kernels built from its sources. ``slices``
runs the 1080p B=8 Johnson slices (``chip_smoke.slice_phase``: plain bf16
and every quantized or fused-site slice) and prints their frames/s; with
``--nst-chain`` it then runs the NST int8_static chain phase and the slices
again. ``kernels`` runs phase 5, K2-K8b against their plain versions with
their device times (each in turns with its previous ``__dp4a`` core);
``bf16`` the same for K9a-K9e (each in turns with its previous core);
``k1`` runs phase 4, K1 at the slice's four pyramid levels against its
plain version (the change's tree also against its previous core), level by
level. ``experiments`` runs the entry points of mk5 (K10's six
forms), mk20 and mk27 (K12's flat forms), mk13 (K11) and mk28 (K13, and
K4's P5) at their full shapes, each printing its JSON line. ``profile``
runs ``chip_smoke.py --profile``'s torch.profiler pass over the 1080p
Johnson slices only (plain bf16,
``bf16_static`` and the quantized or fused-site slices): device time by
kind of kernel; ``reco`` the same over the ReCoNet slices (``chip_smoke.py
--profile reco``'s: IN and FRN under bf16, ``bf16_static``, ``int8`` and
``int8_static``, and the IN net's ``s8_sites`` set). ``convs`` replays each
conv (``F.conv2d`` call) of one steady 1080p B=8 batch of the ReCoNet IN and
the Johnson bf16 slices alone under torch.profiler and prints its dtype,
shapes and device kernels, flagging kernels named TF32, and its largest
error relative to a float64 conv of the same operands. Run parent, change,
change, parent in one call:

    for r in PARENT . . PARENT; do python3 chip_ab.py $r kernels; done
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path


def main() -> int:
    if len(sys.argv) < 3 or sys.argv[2] not in ("slices", "kernels", "bf16", "k1",
                                                 "experiments", "profile", "reco", "convs"):
        print(__doc__)
        return 2
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from neuralstyletransferv1_torch.device import resolve_device
    from neuralstyletransferv1_torch.kernels import _build
    from neuralstyletransferv1_torch.kernels import bf16_sites as k9
    from neuralstyletransferv1_torch.kernels import dis_iter as k1
    from neuralstyletransferv1_torch.kernels import int8_probes as k12
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    print(f"tree {root}", flush=True)
    resolve_device("cuda")
    dev = torch.device("cuda", 0)
    if sys.argv[2] == "experiments":
        import importlib

        _build.build([k8._SOURCE, k9._SOURCE, k12._SOURCE])
        for name in ("mk5_ablate", "mk20_int8_smoke", "mk27_pallas_s8_dot", "mk13_c1",
                     "mk28_probe"):
            importlib.import_module(f"neuralstyletransferv1_torch.experiments.{name}").main([])
        return 0
    _build.build([k1._SOURCE, k8._SOURCE, k9._SOURCE])
    for mod in (k1, k8, k9):
        mod._lib()
    if sys.argv[2] == "kernels":
        cs.int8_kernel_phase(dev)
        return 0
    if sys.argv[2] == "bf16":
        cs.bf16_kernel_phase(dev)
        return 0
    if sys.argv[2] == "k1":
        cs.k1_phase(dev)
        return 0
    if sys.argv[2] == "convs":
        with tempfile.TemporaryDirectory() as tmp:
            conv_kernels(cs, dev, Path(tmp))
        return 0
    if sys.argv[2] in ("profile", "reco"):
        frames = cs.moving_frames(3 * cs.B, cs.H, cs.W, cs.SEED + 6)
        if sys.argv[2] == "profile":
            for mode, fused in (("none", None), ("bf16_static", None)) + cs.SLICES:
                cs._profile_slice(dev, mode, fused, cs.CKPT, "", frames)
            return 0
        with tempfile.TemporaryDirectory() as tmp:
            ckpts = {frn: cs.reco_checkpoint(Path(tmp) / f"reco_{frn}.pth", frn)
                     for frn in (False, True)}
            for mode, frn in cs.RECO_SLICES:
                cs._profile_slice(dev, mode, None, ckpts[frn], f"reco {'frn' if frn else 'in'}",
                                  frames)
            cs._profile_slice(dev, "int8_static", cs.RECO_S8, ckpts[False], "reco in", frames)
        return 0
    for mode, fused in (("none", None),) + cs.SLICES:
        cs.slice_phase(dev, mode, fused)
    if "--nst-chain" in sys.argv[3:]:
        with tempfile.TemporaryDirectory() as tmp:
            cs.nst_chain_phase(dev, cs.nst_checkpoint(Path(tmp) / "nst.pth"))
        print("--- after the NST chain phase", flush=True)
        for mode, fused in (("none", None),) + cs.SLICES:
            cs.slice_phase(dev, mode, fused)
    return 0


def conv_kernels(cs, dev, tmp: Path) -> None:
    """``convs``: the slices' convs one by one, their kernels and errors."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from neuralstyletransferv1_torch.engine import pipeline as tpipe

    print(f"cuDNN allow_tf32 {torch.backends.cudnn.allow_tf32}, matmul allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    frames = cs.moving_frames(3 * cs.B, cs.H, cs.W, cs.SEED + 6)
    conv2d = F.conv2d
    for label, ckpt, extra in (("reco in", cs.reco_checkpoint(tmp / "reco.pth", False),
                                ["--model_type", "reconet"]), ("johnson", cs.CKPT, [])):
        argv = ["--input_video", "in.mp4", "--output_video", "out.mp4", "--model", str(ckpt),
                "--frame_batch", str(cs.B), "--flow_ema", "--compute_dtype", "bfloat16"] + extra
        _, proc = tpipe.make_batched_core(tpipe.build_parser().parse_args(argv), dev)
        proc(frames[:cs.B])
        proc(frames[cs.B:2 * cs.B])
        calls = {}

        def spy(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
            key = (str(x.dtype), tuple(x.shape), tuple(w.shape), stride, padding, dilation,
                   groups)
            calls.setdefault(key, (x.clone(), w.clone(), None if b is None else b.clone()))
            return conv2d(x, w, b, stride, padding, dilation, groups)

        F.conv2d = spy
        try:
            proc(frames[2 * cs.B:])
        finally:
            F.conv2d = conv2d
        print(f"== {label} bf16 slice: {len(calls)} distinct convs", flush=True)
        for key, (x, w, b) in calls.items():
            dt, xs, ws, stride, padding, dilation, groups = key

            def run():
                return conv2d(x, w, b, stride, padding, dilation, groups)

            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            names = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            ref = conv2d(x.double(), w.double(), None if b is None else b.double(), stride,
                         padding, dilation, groups)
            err = float((run().double() - ref).abs().max() / ref.abs().max())
            tf32 = any("tf32" in n.lower() for n, _ in names)
            print(f"{'TF32-named ' if tf32 else ''}{dt} x{xs} w{ws}: max error {err:.3g} of "
                  f"the largest |f64| of the same operands; " +
                  "; ".join(f"{n[:110]} {ms:.3f} ms" for n, ms in names), flush=True)


if __name__ == "__main__":
    sys.exit(main())
