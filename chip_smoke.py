#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and nvcc. In
order, and any failed phase exits non-zero:

1. require CUDA and the port's package beside this file;
2. print the card's name and power limit (nvidia-smi);
3. build K1 (``csrc/dis_iter.cu``), K2–K8b (``csrc/int8_sites.cu``) and
   K9a–K9e (``csrc/bf16_sites.cu``), one nvcc each, started together, and
   print ptxas' registers and spills of every kernel, and the dynamic
   shared memory of K3's and K4's tensor-core core (``mma_kernel``);
4. hold K1 against its plain PyTorch version at the four DIS pyramid levels
   of the 1080p slice (8 frame pairs, flow at half resolution), and time
   both;
5. hold K2–K8b against their plain versions at the int8 sites' 1080p B=8
   shapes (res 270×480 128→128; d1 270×480 128→256; d2 540×960 64→128;
   K3 also with YAFF, with the s8 emit at floor −127 and as the s8 decoder's
   d1/d2; c2 1080×1920 32→64 and c3 540×960 64→128 at stride 2; deconv3's
   rows 540×960 128→60 and its s8 form →12): s8 codes and bf16 outputs
   bit-identical, sums within 1e-5; time each beside its plain version and
   the cuDNN bf16 conv it stands for (3×3 of the same shape; the stride-2
   c2/c3; the 9×9 32→3 deconv3 at 1080p, whose cuDNN kernels are named);
   K3 and K4 also beside their previous ``__dp4a`` design (``*_prev``, held
   to the same outputs), in turns: plain, kernel, previous, kernel,
   previous, plain;
   then K9a–K9e, the bf16 fused sites, at their 1080p B=8 shapes (d2 540×960
   64→128; c2 1080×1920 32→64 and c3 540×960 64→128 at stride 2; deconv3's
   rows 540×960 128→60 on the reflect-padded grid and their 5-row sum →12):
   two launches bit-identical, bf16 outputs within 1 bf16 ulp of the plain
   version everywhere (an ulp taken at no less than 2^-8 of the tensor's
   largest magnitude; the 5-row sum: within 2 ulp of its largest term) and
   equal on ≥ 99%, sums within 1e-5; timed like the int8 sites;
6. check the CUDA slice against the port's CPU path on a small input: f32
   with the exact warp; then ``--quantize int8_static``, its int8 chains
   bit for bit from one head output — under the adopted set and under the
   all-s8 set A (head K8a/K8b, s8 res chain, s8 decoder, K6 tail) from one
   conv1 output — and the whole slice to a stated bound;
7. drive the slice — ``make_batched_core`` with the CLI's own parsed argv:
   1920×1080 frames, batches of 8, flow EMA, bf16, the repo's full-width
   random-weight Johnson checkpoint — over 3 batches of synthesized moving
   frames, once plain, once for each of ``--quantize int8_static`` and
   ``int8`` with the adopted site sets, and once for each with the sets A
   (int8_static) and B (int8: head K8a/K8b, K4/K5 chains, K7 deconv3), and
   once for each of the bf16 fused-site sets ``("head", "tail")`` (K9c, K9d,
   K9a, K9b) and ``("d3",)`` (K9e); check every kernel's launch count of each
   run exactly, and that each quantized or fused stylize stays within the
   1e-2 MAE gate of the plain bf16 one;
8. when OpenCV is installed, run the CLI ``main()`` end to end on a
   synthesized 1080p mp4.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --profile

instead profiles one steady 1080p B=8 batch of each slice (plain bf16,
``bf16_static``, ``int8_static``, ``int8``, the two under sets A and B, and the
two bf16 fused-site sets) with torch.profiler and prints where its device
time goes, grouped by kind of kernel (PERF.md section 5).

    python3 chip_smoke.py --phases

instead builds K3's and K4's tensor-core core with ``-DMMA_PHASE_CLOCKS``
and prints, for each of their 1080p B=8 cases, the share of each phase of
the tile loop in the clock of every block's thread 0.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "_testdata" / "test_johnson.pth"
SEED = 0
B, H, W = 8, 1080, 1920
N_BATCHES = 3
K1_OFFSET_TOL = 1e-3   # px, on at least K1_SHARE of the patches
K1_SHARE = 0.99
K1_RES_TOL = 1e-3      # grey levels (0..255), on those patches
SLICE_MAE_TOL = 1e-3   # [0,1] frames, CUDA slice vs CPU slice, f32 + exact warp
QUANT_MAE_TOL = 1e-2   # [0,1] frames: the repo's gate (quantized vs bf16, CUDA vs CPU)
QUANT_BROKEN_TOL = 5e-2  # [0,1] raw-scale stylize: beyond this the path is broken
SUM_TOL = 1e-5         # relative, the int8 sites' [Σ, Σ²] against the plain sums
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet (the bound's memory rate)
PEAK_INT8_OPS = 1979e12     # dense int8 tensor-core ops/s, same sheet
PEAK_BF16_OPS = 989e12      # dense bf16 tensor-core FLOP/s, same sheet
BF16_EQUAL_SHARE = 0.99     # K9: share of bf16 outputs equal to the plain version's
PEAK_F32_OPS = 67e12        # f32 outside the tensor cores, same sheet

# the int8 sites of the 1080p B=8 slice: (B, H, W, C, CO, halo); the c2/c3
# sites are stride 2 (H, W are their input's), d3 is deconv3's rows conv
SITE_SHAPES = {"res": (B, H // 4, W // 4, 128, 128, "reflect"),
               "d1": (B, H // 4, W // 4, 128, 256, "edge"),
               "d2": (B, H // 2, W // 2, 64, 128, "edge"),
               "c2": (B, H, W, 32, 64, "reflect"),
               "c3": (B, H // 2, W // 2, 64, 128, "reflect"),
               "d3": (B, H // 2, W // 2, 128, 64, None)}
_SITES_I8 = "neuralstyletransferv1_tpu/models/s2d2_sites_i8.py"
# K2-K8b: the (shape, form) cases each runs on the main path, and the TPU
# kernel it replaces. K3's forms: "aff_add" (frozen affine + residual),
# "yaff" (+ the raw residual's frozen affine and ReLU), "emit" (+ the s8 emit
# at floor -127: the bridge into d1), "s8out" (the s8 decoder's d1/d2)
INT8_KERNELS = {
    "res_site_s8o": ((("res", ""),), f"{_SITES_I8}:507"),
    "site_s8": ((("res", "aff_add"), ("res", "yaff"), ("res", "emit"), ("d1", "s8out"),
                 ("d2", "s8out")), f"{_SITES_I8}:670"),
    "res_site": ((("res", ""), ("d1", ""), ("d2", "")), f"{_SITES_I8}:139"),
    "res_site_skip": ((("res", ""), ("d1", "")), f"{_SITES_I8}:299"),
    "c2_site": ((("c2", ""),), f"{_SITES_I8}:1147"),
    "c3_site": ((("c3", ""),), f"{_SITES_I8}:1271"),
    "d3_rows_site": ((("d3", ""),), f"{_SITES_I8}:858"),
    "d3_s8_site": ((("d3", ""),), f"{_SITES_I8}:939"),
}
_SITES_BF16 = "neuralstyletransferv1_tpu/models/s2d2_sites.py"
# K9a-K9e: the input shape (B, H, W, C) each runs at on the main path, and the
# TPU kernel it replaces
BF16_KERNELS = {
    "d2_site": ((B, H // 2, W // 2, 64), f"{_SITES_BF16}:131"),
    "d3_sum_site": ((B, H // 2, W // 2, 128), f"{_SITES_BF16}:283"),
    "c2_site_bf16": ((B, H, W, 32), f"{_SITES_BF16}:462"),
    "c3_site_bf16": ((B, H // 2, W // 2, 64), f"{_SITES_BF16}:594"),
    "d3_rows": ((B, H // 2, W // 2, 128), f"{_SITES_BF16}:58"),
}
# the all-int8 head and tail sets (ROADMAP Queue 1, item 11)
SET_A = ("head_i8", "res_i8", "res_s8", "dec_i8", "dec_s8", "tail_s8")
SET_B = ("head_i8", "res_i8", "dec_i8", "tail_s8", "d3_i8")
# the quantized slices, (--quantize, fused set or None for the adopted one),
# and the launches of each int8 kernel per batch
HEAD_TAIL = ("head", "tail")
D3 = ("d3",)
SLICES = (("int8_static", None), ("int8", None), ("int8_static", SET_A), ("int8", SET_B),
          ("none", HEAD_TAIL), ("none", D3))
PER_BATCH = {("int8_static", None): {"res_site_s8o": 5, "site_s8": 5, "res_site": 2},
             ("int8", None): {"res_site": 7, "res_site_skip": 5},
             ("int8_static", SET_A): {"c2_site": 1, "c3_site": 1, "res_site_s8o": 5,
                                      "site_s8": 7, "d3_s8_site": 1},
             ("int8", SET_B): {"c2_site": 1, "c3_site": 1, "res_site": 7, "res_site_skip": 5,
                               "d3_rows_site": 1},
             ("none", HEAD_TAIL): {"c2_site_bf16": 1, "c3_site_bf16": 1, "d2_site": 1,
                                   "d3_sum_site": 1},
             ("none", D3): {"d3_rows": 1}}
SET_NAMES = {SET_A: "setA", SET_B: "setB", HEAD_TAIL: "head,tail", D3: "d3"}
# K3 and K4 run on the int8 tensor cores (mma_kernel); their previous __dp4a
# design (site_kernel) stays callable for the comparison
REDESIGNED = ("site_s8", "res_site")


def slice_name(quantize: str, fused) -> str:
    return quantize if fused is None else f"{quantize}+{SET_NAMES[fused]}"


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Per-call time on the device timeline (CUDA events), host gaps included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 10) -> float | None:
    """Per-call sum of the device time of every kernel and copy ``fn``
    launches (torch.profiler); None when the profiler records no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / reps / 1e3 if total_us > 0 else None


def dev_time(fn, reps: int = 10) -> float:
    """Device ms per call: the profiler's device time, or CUDA events when
    the profiler records none."""
    d = device_ms(fn, reps)
    return d if d is not None else cuda_ms(fn, reps)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def moving_frames(n: int, h: int, w: int, seed: int):
    """n uint8 RGB frames of a textured scene panning by (3, 1) px a frame."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pad = 4 * n
    yy, xx = np.mgrid[0:h + pad, 0:w + pad].astype(np.float32)
    tex = (110 + 60 * np.sin(0.031 * xx + 0.017 * yy) + 40 * np.cos(0.023 * xx - 0.041 * yy))
    scene = np.clip(tex[..., None] + rng.normal(0, 12, (h + pad, w + pad, 3)), 0, 255)
    scene = scene.astype(np.uint8)
    return [np.ascontiguousarray(scene[pad - t:pad - t + h, pad - 3 * t:pad - 3 * t + w])
            for t in range(n)]


def k1_phase(dev):
    """K1 against its plain version at the slice's pyramid levels."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.kernels import dis_iter as k1
    from neuralstyletransferv1_torch.ops import dis_flow as tdis
    from neuralstyletransferv1_torch.ops.color import rgb_to_gray
    from neuralstyletransferv1_torch.ops.resize import resize_bilinear

    frames = moving_frames(B + 1, H, W, SEED)
    x = torch.from_numpy(np.stack(frames)).to(dev).float()
    gray = resize_bilinear(rgb_to_gray(x)[..., None], (H // 2, W // 2))[..., 0]
    prev, curr = gray[:-1], gray[1:]
    worst, ms_total, plain_total, bound_total = 0.0, 0.0, 0.0, 0.0
    for lh, lw, k in tdis._level_sizes(H // 2, W // 2, 2):
        a = resize_bilinear(prev[..., None], (lh, lw))[..., 0]
        c = resize_bilinear(curr[..., None], (lh, lw))[..., 0]
        # a plausible coarse init: the true pan at this level, plus noise
        g = torch.Generator(device=dev).manual_seed(SEED + k)
        init = torch.randn((B, lh, lw, 2), generator=g, device=dev) * 0.5
        init[..., 0] += 1.5 / 2 ** k
        init[..., 1] += 0.5 / 2 ** k
        ins = tdis._level_inputs(a, c, init)
        n = B * ins["t"].shape[1] * ins["t"].shape[2]
        flat = {key: v.reshape((n,) + v.shape[3:]).contiguous() for key, v in ins.items()}
        u, res = k1.dis_iter(**flat)
        pu, pres = k1.dis_iter_plain(**flat)
        torch.cuda.synchronize()
        du = (u - pu).abs().max(dim=1).values
        same = du <= K1_OFFSET_TOL
        share = float(same.float().mean())
        res_err = float((res - pres).abs()[same].max())
        if not (torch.isfinite(u).all() and torch.isfinite(res).all()):
            fail(f"K1 produced non-finite values at level {lh}x{lw}")
        kernel, plain = (lambda: k1.dis_iter(**flat)), (lambda: k1.dis_iter_plain(**flat))
        # in turns: plain, kernel, kernel, plain
        t_plain = cuda_ms(plain, reps=5)
        t_k = (cuda_ms(kernel) + cuda_ms(kernel)) / 2
        t_plain = (t_plain + cuda_ms(plain, reps=5)) / 2
        d_k, d_plain = device_ms(kernel), device_ms(plain, reps=3)
        ms_total += d_k if d_k is not None else t_k
        plain_total += d_plain if d_plain is not None else t_plain
        # bound: every input read once, u and res written once; ~16 f32
        # operations per pixel of the patch in each of the iters + 1 samples
        ops = n * (16 + 1) * 64 * 16
        bound_total += max(nbytes(*flat.values(), u, res) / HBM_BYTES_PER_S,
                           ops / PEAK_F32_OPS) * 1e3
        worst = max(worst, float(du.max()))
        log(f"K1 level {lh}x{lw}: {n} patches, offsets within {K1_OFFSET_TOL} px on "
            f"{share:.4%} (bound {K1_SHARE:.0%}), max offset err {float(du.max()):.3g} px, "
            f"residual err {res_err:.3g} (bound {K1_RES_TOL}); per call {t_k:.4f} ms "
            f"(plain {t_plain:.4f} ms); device time {d_k} ms (plain {d_plain} ms)")
        if share < K1_SHARE or res_err > K1_RES_TOL:
            fail(f"K1 disagrees with its plain version at level {lh}x{lw}")
    return worst, ms_total, plain_total, bound_total


def site_inputs(dev, b, h, w, c, co, seed):
    """Random operands of an int8 site at realistic scales: codes span the
    int8 range, f = acc·ws + bias is O(1). Also deconv3's tap-packed 1×5
    weights (60 lanes padded to 64), dequant row and 12-lane bias."""
    import torch

    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0, lo=None):
        t = torch.rand(shape, generator=g, device=dev) * scale + lo if lo is not None \
            else torch.randn(shape, generator=g, device=dev) * scale
        return t.contiguous()

    def codes(*shape, lo=-127):
        return torch.randint(lo, 128, shape, generator=g, device=dev,
                             dtype=torch.int32).to(torch.int8)

    ws5 = rnd(64, scale=1.0e-5, lo=0.3e-5)
    ws5[k8.D3_LANES:] = 0.0
    return {
        "x": rnd(b, h, w, c, scale=2.0).to(torch.bfloat16),
        "y": rnd(b, h, w, c).to(torch.bfloat16),
        "a": rnd(b, c, scale=35.0, lo=5.0), "c": rnd(b, c, scale=8.0),
        "a2": rnd(b, c, scale=1.0, lo=0.5), "c2": rnd(b, c, scale=0.3),
        "wk": k8.pack_weights(codes(3, 3, c, co)), "ws": rnd(co, scale=1.5e-5, lo=0.5e-5),
        "bias": rnd(co, scale=0.2), "qa": rnd(co, scale=50.0, lo=10.0), "qc": rnd(co, scale=10.0),
        "codes": codes(b, h, w, c, lo=0),
        "wk5": k8.pack_weights(codes(1, 5, c, k8.D3_LANES), co_pad=k8.CO_TILE), "ws5": ws5,
        "bias12": rnd(k8.D3_OUT, scale=0.2),
    }


def site_calls(name, t, shape, form, prev=False):
    """(kernel call, plain call, bytes moved, int8 ops) of one int8 site;
    with ``prev`` the kernel call is K3's or K4's previous ``__dp4a`` core."""
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    b, h, w, c = t["x"].shape
    co = t["wk"].shape[2]
    kw, outs, pix = {}, 2, b * h * w
    if name == "res_site_s8o":
        args = (t["x"], t["a"], t["c"], -127.0, t["wk"], t["ws"], t["bias"], t["qa"], t["qc"])
        ins, outs = (t["x"], t["a"], t["c"], t["wk"], t["ws"], t["bias"], t["qa"], t["qc"]), 1
    elif name == "site_s8":
        aff = (t["qa"] / 40, t["qc"] / 40)
        if form == "s8out":
            args, kw = (t["codes"], t["wk"], t["ws"], t["bias"]), dict(qa=t["qa"], qc=t["qc"])
            ins, outs = (t["codes"], t["wk"], t["ws"], t["bias"], t["qa"], t["qc"]), 1
        else:
            args = (t["codes"], t["wk"], t["ws"], t["bias"], *aff, t["y"])
            ins = (t["codes"], t["wk"], t["ws"], t["bias"], t["qa"], t["qc"], t["y"])
            if form == "yaff":
                kw = dict(yaff=(t["a2"][0], t["c2"][0]))
            elif form == "emit":
                kw, outs = dict(qa=t["qa"] / 4, qc=t["qc"], qlo=-127.0), 1
    elif name == "res_site":
        args = (t["x"], t["a"], t["c"], -127.0, t["wk"], t["ws"], t["bias"])
        ins = (t["x"], t["a"], t["c"], t["wk"], t["ws"], t["bias"])
    elif name == "res_site_skip":
        args = (t["x"], t["y"], t["a"], t["c"], t["a2"], t["c2"], 0.0, t["wk"], t["ws"],
                t["bias"])
        ins = (t["x"], t["y"], t["a"], t["c"], t["a2"], t["c2"], t["wk"], t["ws"], t["bias"])
        kw = dict(yout=shape == "res")
    elif name in ("c2_site", "c3_site"):
        args = (t["x"], t["a"], t["c"], 0.0, t["wk"], t["ws"], t["bias"])
        ins, pix = (t["x"], t["a"], t["c"], t["wk"], t["ws"], t["bias"]), b * (h // 2) * (w // 2)
    elif name == "d3_rows_site":
        args = (t["x"], t["a"], t["c"], t["wk5"], t["ws5"])
        ins, co = (t["x"], t["a"], t["c"], t["wk5"], t["ws5"]), k8.D3_LANES
    else:  # d3_s8_site
        args = (t["codes"], t["wk5"], t["ws5"], t["bias12"])
        ins, co = (t["codes"], t["wk5"], t["ws5"], t["bias12"]), k8.D3_OUT
    if SITE_SHAPES[shape][5] is not None and name not in ("c2_site", "c3_site"):
        kw["halo"] = SITE_SHAPES[shape][5]
    kernel = getattr(k8, f"{name}_prev" if prev else name)
    plain = getattr(k8, f"{name}_plain")
    moved = nbytes(*ins) + pix * co * outs
    if name in ("res_site", "res_site_skip", "c2_site", "c3_site"):
        moved += b * 2 * co * 4  # the sums
    if name == "res_site_skip" and kw["yout"]:
        moved += b * h * w * c * 2  # v
    taps = 5 if name.startswith("d3") else 9
    lanes = k8.D3_LANES if name.startswith("d3") else co
    ops = 2 * pix * c * lanes * taps
    return (lambda: kernel(*args, **kw)), (lambda: plain(*args, **kw)), moved, ops


def check_site(name, out, ref, n):
    """Max |kernel − plain| over every output; fails unless the codes and
    bf16 values are identical and the sums agree within SUM_TOL."""
    import torch

    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    worst = 0.0
    for o, r in zip(outs, refs):
        if o is None and r is None:
            continue
        if o.dtype == torch.float32:  # [Σ, Σ²] [B,2,CO]
            s2 = r[:, 1].double()
            ok = ((o[:, 1].double() - s2).abs() <= SUM_TOL * s2).all() and \
                ((o[:, 0].double() - r[:, 0].double()).abs() <= SUM_TOL * (n * s2).sqrt()).all()
            if not bool(ok):
                fail(f"{name}: the kernel's sums disagree with the plain sums")
            continue
        worst = max(worst, float((o.float() - r.float()).abs().max()))
        if not torch.equal(o, r):
            fail(f"{name}: the kernel's {o.dtype} output is not bit-identical to the plain "
                 f"version's ({int((o != r).sum())} elements differ)")
    return worst


def kernel_names(fn, top: int = 3) -> list:
    """The device kernels ``fn`` launches, longest first (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ks = sorted(((e.self_device_time_total, e.key) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                reverse=True)
    return [f"{k[:90]} ({us / 1e3:.3f} ms)" for us, k in ks[:top]]


def library_conv(dev, t, name, shape):
    """The cuDNN bf16 conv a site stands for, on tensors of its shape: a 3×3
    conv (stride 2 for c2/c3) or, for deconv3's sites, the pixel 9×9 32→3
    conv at the 1080p output size."""
    import torch
    import torch.nn.functional as F

    if name.startswith("d3"):
        b, h2, w2, _ = t["x"].shape
        xc = torch.randn((b, 32, 2 * h2, 2 * w2), device=dev).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        wc = torch.randn((3, 32, 9, 9), device=dev).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        return lambda: F.conv2d(xc, wc, padding=4)
    b, h, w, c, co, _ = SITE_SHAPES[shape]
    xc = t["x"].permute(0, 3, 1, 2)  # NHWC memory: a channels-last NCHW view
    wc = torch.randn((co, c, 3, 3), device=dev).to(torch.bfloat16).to(
        memory_format=torch.channels_last)
    stride = 2 if name in ("c2_site", "c3_site") else 1
    return lambda: F.conv2d(xc, wc, stride=stride, padding=1)


def int8_kernel_phase(dev):
    """K2-K8b against their plain versions at the slice's shapes, timed in
    turns (plain, kernel, kernel, plain; K3 and K4: plain, kernel, previous
    core, kernel, previous core, plain) beside the cuDNN bf16 conv each site
    stands for."""
    import torch

    results = {}
    for name, (cases, _replaces) in INT8_KERNELS.items():
        rec = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "cudnn_bf16_ms": 0.0,
               "max_abs_err": 0.0, "bound_by": "bytes", "per_case": {}}
        redesigned = name in REDESIGNED
        if redesigned:
            rec["prev_ms"] = 0.0
        for shape, form in cases:
            b, h, w, c, co, halo = SITE_SHAPES[shape]
            t = site_inputs(dev, b, h, w, c, co, seed=len(results) * 7 + len(rec["per_case"]))
            kernel, plain, moved, ops = site_calls(name, t, shape, form)
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            first = out[0] if isinstance(out, tuple) else out
            n = first.shape[1] * first.shape[2]
            err = check_site(name, out, ref, n)
            del out, first
            if redesigned:
                prev = site_calls(name, t, shape, form, prev=True)[0]
                check_site(f"{name} (previous core)", prev(), ref, n)
            del ref
            t_plain = dev_time(plain, reps=2)
            if redesigned:
                t_k, t_prev = dev_time(kernel), dev_time(prev, reps=3)
                t_k, t_prev = (t_k + dev_time(kernel)) / 2, (t_prev + dev_time(prev, reps=3)) / 2
            else:
                t_k = (dev_time(kernel) + dev_time(kernel)) / 2
            t_plain = (t_plain + dev_time(plain, reps=2)) / 2
            lib = library_conv(dev, t, name, shape)
            t_lib = dev_time(lib)
            if name.startswith("d3") and "d3_9x9" not in results:
                results["d3_9x9"] = kernel_names(lib)
                log(f"cuDNN bf16 9x9 32->3 conv at 1080p B={b}: kernels {results['d3_9x9']}")
            t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_INT8_OPS * 1e3
            bound = max(t_bytes, t_ops)
            case = f"{shape}{'/' + form if form else ''}"
            per = {"ms": t_k, "plain_ms": t_plain, "cudnn_bf16_ms": t_lib, "bound_ms": bound}
            if redesigned:
                per.update(prev_ms=t_prev, bound_share=bound / t_k)
                rec["prev_ms"] += t_prev
            log(f"{name} @ {case} {b}x{h}x{w}x{c}->{co} {halo}: bit-identical to plain; "
                f"kernel {t_k:.4f} ms, plain {t_plain:.4f} ms, cuDNN bf16 conv "
                f"{t_lib:.4f} ms; bound {bound:.4f} ms "
                f"({moved / 1e6:.1f} MB, {ops:.3e} int8 ops)" +
                (f"; previous __dp4a core {t_prev:.4f} ms ({t_prev / t_k:.2f}x the kernel), "
                 f"kernel at {bound / t_k:.1%} of the bound" if redesigned else ""))
            rec["ms"] += t_k
            rec["plain_ms"] += t_plain
            rec["cudnn_bf16_ms"] += t_lib
            rec["bound_ms"] += bound
            rec["per_case"][case] = per
            if t_ops > t_bytes:
                rec["bound_by"] = "operations"
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            del t, lib, kernel, plain
            if redesigned:
                del prev
            torch.cuda.empty_cache()
        if redesigned:
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        results[name] = rec
    return results


def bf16_site_inputs(dev, name, shape, seed):
    """Random operands of a bf16 site at realistic scales: raw activations
    O(1), an affine that leaves about half of them above the ReLU, weights
    of a fan-in-scaled net."""
    import torch

    from neuralstyletransferv1_torch.kernels import bf16_sites as k9

    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, w, c = shape
    x = (torch.randn(shape, generator=g, device=dev) * 1.5).to(torch.bfloat16)
    a = torch.rand((b, c), generator=g, device=dev) + 0.5
    cc = torch.randn((b, c), generator=g, device=dev) * 0.3
    if name.startswith("d3"):
        wt = torch.randn((1, 5, c, k9.D3_LANES), generator=g, device=dev) * (5 * c) ** -0.5
        args = [x, a, cc, k9.pack_rows_weights(wt)]
        if name == "d3_sum_site":
            args.append(torch.randn(k9.D3_OUT, generator=g, device=dev) * 0.2)
    else:
        co = k9.SITES[name][1]
        wt = torch.randn((3, 3, c, co), generator=g, device=dev) * (9 * c) ** -0.5
        args = [x, a, cc, k9.pack_site_weights(wt), torch.randn(co, generator=g, device=dev) * 0.2]
    return args


def check_bf16_site(name, out, again, ref, args):
    """Kernel vs plain version: two launches bit-identical; every bf16 output
    within 1 ulp and BF16_EQUAL_SHARE of them equal; the sums within SUM_TOL.
    The two differ by the order of their f32 accumulation, an error that does
    not shrink with the element, so an ulp is taken at no less than 2^-8 of
    the tensor's largest magnitude. d3_sum_site adds five bf16 rows that may
    each differ by an ulp of their own size: it is held to 2 ulp of the
    largest of the element and its five terms."""
    import torch

    from neuralstyletransferv1_torch.kernels import bf16_sites as k9

    outs = out if isinstance(out, tuple) else (out,)
    for o, o2 in zip(outs, again if isinstance(again, tuple) else (again,)):
        if not torch.equal(o, o2):
            fail(f"{name}: two launches on the same inputs differ")
    refs = ref if isinstance(ref, tuple) else (ref,)
    o, r = outs[0], refs[0]
    if o.shape != r.shape or o.dtype != torch.bfloat16:
        fail(f"{name}: output {tuple(o.shape)} {o.dtype}, expected {tuple(r.shape)} bfloat16")
    if not bool(torch.isfinite(o.float()).all()):
        fail(f"{name}: non-finite output")
    scale, limit = None, 1.0
    if name == "d3_sum_site":
        scale, limit = k9.d3_sum_scale_plain(*args[:4]), 2.0
    worst, equal = k9.bf16_ulp_error(o, r, scale=scale)
    if worst > limit or equal < BF16_EQUAL_SHARE:
        fail(f"{name}: {worst:.3g} ulp from the plain version at worst (limit {limit}), equal on "
             f"{equal:.4%}")
    if len(outs) > 1:
        n = o.shape[1] * o.shape[2]
        s, sr = outs[1].double(), refs[1].double()
        ok = ((s[:, 1] - sr[:, 1]).abs() <= SUM_TOL * sr[:, 1]).all() and \
            ((s[:, 0] - sr[:, 0]).abs() <= SUM_TOL * (n * sr[:, 1]).sqrt()).all()
        if not bool(ok):
            fail(f"{name}: the kernel's sums disagree with the plain sums")
    return float((o.float() - r.float()).abs().max()), worst, equal


def bf16_library_conv(dev, name, shape):
    """The cuDNN bf16 conv a bf16 site stands for (for scale): the 3×3 of its
    shape, or for deconv3's sites the tap-packed 1×5 128→60 conv."""
    import torch
    import torch.nn.functional as F

    from neuralstyletransferv1_torch.kernels import bf16_sites as k9

    b, h, w, c = shape
    x = torch.randn(shape, device=dev).to(torch.bfloat16).permute(0, 3, 1, 2)
    if name.startswith("d3"):
        wc = torch.randn((k9.D3_LANES, c, 1, 5), device=dev).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        return lambda: F.conv2d(x, wc, padding=(0, 2))
    _, co, stride, _, _ = k9.SITES[name]
    wc = torch.randn((co, c, 3, 3), device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    return lambda: F.conv2d(x, wc, stride=stride, padding=1)


def bf16_kernel_phase(dev):
    """K9a-K9e against their plain versions at the slice's shapes, timed in
    turns (plain, kernel, kernel, plain) beside the cuDNN bf16 conv of the
    same shape."""
    import torch

    from neuralstyletransferv1_torch.kernels import bf16_sites as k9

    results = {}
    for i, (name, (shape, _replaces)) in enumerate(BF16_KERNELS.items()):
        args = bf16_site_inputs(dev, name, shape, seed=100 + i)
        kernel, plain = getattr(k9, name), getattr(k9, f"{name}_plain")
        out, again, ref = kernel(*args), kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err, worst, equal = check_bf16_site(name, out, again, ref, args)
        outs = out if isinstance(out, tuple) else (out,)
        b, h, w, c = shape
        pix = outs[0].shape[0] * outs[0].shape[1] * outs[0].shape[2]
        if name == "d3_sum_site":  # the rows are computed for every output row
            pix = b * h * w
        lanes = k9.D3_LANES if name.startswith("d3") else outs[0].shape[3]
        taps = 5 if name.startswith("d3") else 9
        flops = 2 * pix * c * lanes * taps
        moved = nbytes(*args, *outs)
        del out, again, ref, outs
        torch.cuda.empty_cache()
        t_plain = dev_time(lambda: plain(*args), reps=2)
        t_k = (dev_time(lambda: kernel(*args)) + dev_time(lambda: kernel(*args))) / 2
        t_plain = (t_plain + dev_time(lambda: plain(*args), reps=2)) / 2
        lib = bf16_library_conv(dev, name, shape)
        t_lib = dev_time(lib)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, flops / PEAK_BF16_OPS * 1e3
        log(f"{name} @ {b}x{h}x{w}x{c}: two launches bit-identical; vs plain max |err| "
            f"{err:.4g}, worst {worst:.3g} ulp, equal on {equal:.4%}; kernel {t_k:.4f} ms, plain "
            f"{t_plain:.4f} ms, cuDNN bf16 conv {t_lib:.4f} ms; bound {max(t_bytes, t_ops):.4f} ms "
            f"({moved / 1e6:.1f} MB, {flops:.3e} bf16 FLOP)")
        results[name] = {"ms": t_k, "plain_ms": t_plain, "cudnn_bf16_ms": t_lib,
                         "bound_ms": max(t_bytes, t_ops), "max_abs_err": err,
                         "bound_by": "operations" if t_ops > t_bytes else "bytes"}
        del args, lib
        torch.cuda.empty_cache()
    return results


def reference_phase(dev):
    """The CUDA slice vs the port's CPU path on a small input."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.engine import pipeline as tpipe

    argv = ["--input_video", "in.mp4", "--output_video", "out.mp4", "--model", str(CKPT),
            "--io_preset", "raw_01", "--frame_batch", "4", "--flow_ema", "--exact_warp"]
    frames = moving_frames(8, 128, 192, SEED + 1)
    outs = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        args = tpipe.build_parser().parse_args(argv + ["--device", d.type])
        _, proc = tpipe.make_batched_core(args, d)
        outs[name] = [proc(frames[b0:b0 + 4]).cpu().numpy() for b0 in (0, 4)]
    mae = max(float(np.abs(a.astype(np.float64) - c).mean()) / 255.0
              for a, c in zip(outs["cuda"], outs["cpu"]))
    log(f"slice f32 + exact warp, CUDA vs CPU at 128x192: MAE {mae:.3g} (bound {SLICE_MAE_TOL})")
    if not mae <= SLICE_MAE_TOL:
        fail("the CUDA slice disagrees with the CPU slice")
    if outs["cuda"][0].std() < 1.0:
        fail("the small-input slice output is constant")
    return mae


def quant_reference_phase(dev):
    """--quantize int8_static on the card against the port's CPU path.

    First the int8 chains alone: from one head output and one calibration,
    the s8-carry res chain and the decoder sites on the card (K2-K4) and on
    the CPU (their plain versions) must agree bit for bit. Then the whole
    slice at 128×256, 2 batches of 4, each device calibrating itself: the
    bf16 head convs round differently in cuDNN and on the CPU, a flipped code
    moves this random-weight net's output by about its int8 noise (~1e-2 on
    the raw_01 scale), so the slice is held to QUANT_BROKEN_TOL and its MAE
    recorded."""
    import copy

    import numpy as np
    import torch

    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.engine import stylizer as st
    from neuralstyletransferv1_torch.models import sites_i8
    from neuralstyletransferv1_torch.models import transformer_net_quant as tq
    from neuralstyletransferv1_torch.models.transformer_net import NormHooks

    cpu = torch.device("cpu")
    frames = moving_frames(8, 128, 256, SEED + 5)
    model = st.load_model(CKPT, io_preset="raw_01")
    x = torch.from_numpy(np.stack(frames[:4])).float() / 255.0
    stats = tq.calibrate_in_stats(model.net, x[:1])
    scales = tq.calibrate_act_scales(model.net, x[:1], sites=tq.QUANT_SITES_PALLAS,
                                     static_stats=stats)
    quant = tq.quantize_net(model.net, {k: v for k, v in scales.items() if k in tq.INT8_SITES})
    nb = copy.deepcopy(model.net).to(torch.bfloat16)
    with torch.no_grad():
        y = nb.encode(x.to(torch.bfloat16), NormHooks(static_stats=stats)).contiguous()
        chains = []
        for d in (dev, cpu):
            net_d = copy.deepcopy(nb).to(d)
            sites = sites_i8.prepare_sites(net_d, quant, d)
            st_d = {k: (m.to(d), inv.to(d)) for k, (m, inv) in stats.items()}
            yr = sites_i8.res_chain_s8_static(y.to(d), net_d, sites, st_d)
            r2, _, _ = sites_i8.dec_chain(yr, net_d, sites, static_stats=st_d)
            chains.append((yr.cpu(), r2.cpu()))
    same = all(torch.equal(a, b) for a, b in zip(*chains))
    log(f"int8_static chains from one head output at 128x256, card vs CPU: "
        f"{'bit-identical' if same else 'DIFFERENT'} (res output and d2 raw)")
    if not same:
        fail("the int8_static chains differ between the card and the CPU")
    set_a_chain_phase(dev, model, x, stats)

    argv = ["--input_video", "in.mp4", "--output_video", "out.mp4", "--model", str(CKPT),
            "--io_preset", "raw_01", "--frame_batch", "4", "--flow_ema", "--exact_warp",
            "--compute_dtype", "bfloat16", "--quantize", "int8_static"]
    outs = {}
    for name, d in (("cuda", dev), ("cpu", cpu)):
        args = tpipe.build_parser().parse_args(argv + ["--device", d.type])
        _, proc = tpipe.make_batched_core(args, d)
        outs[name] = [proc(frames[b0:b0 + 4]).cpu().numpy() for b0 in (0, 4)]
    mae = max(float(np.abs(a.astype(np.float64) - c).mean()) / 255.0
              for a, c in zip(outs["cuda"], outs["cpu"]))
    log(f"slice --quantize int8_static, CUDA vs CPU at 128x256: MAE {mae:.6f} "
        f"(the repo's gate {QUANT_MAE_TOL}; bound {QUANT_BROKEN_TOL})")
    if not mae <= QUANT_BROKEN_TOL:
        fail("the CUDA int8_static slice disagrees with the CPU slice")
    return mae


def set_a_chain_phase(dev, model, x, stats):
    """Set A's int8 chains on the card and on the CPU from one conv1 output
    and one calibration (frozen norms; head, s8 res chain with the deferred
    in3 and the d1 bridge, s8 decoder, the K6 tail): bit-identical."""
    import copy

    import torch

    from neuralstyletransferv1_torch.models import sites_i8
    from neuralstyletransferv1_torch.models import transformer_net_quant as tq
    from neuralstyletransferv1_torch.models.s2d import d2s, in_affine

    scales = tq.calibrate_act_scales(model.net, x[:1], sites=tq.QUANT_SITES_PALLAS,
                                     static_stats=stats)
    scales = tq.site_filter(scales, x.shape[1], x.shape[2], SET_A)
    quant = tq.quantize_net(model.net, scales, io_preset=model.io_preset)
    if not {"c2", "c3", "d3"} <= set(quant):
        fail(f"set A did not quantize c2, c3 and d3 at {x.shape[1]}x{x.shape[2]}")
    d3 = tq.baked_d3(model.net, model.io_preset)
    nb = copy.deepcopy(model.net).to(torch.bfloat16)
    with torch.no_grad():
        y1 = nb.conv1(x.to(torch.bfloat16)).contiguous()
        outs = []
        for d in (dev, torch.device("cpu")):
            net_d = copy.deepcopy(nb).to(d)
            sites = sites_i8.prepare_sites(net_d, quant, d, d3=d3)
            st_d = {k: (m.to(d), inv.to(d)) for k, (m, inv) in stats.items()}
            y3, m3, inv3 = sites_i8.head_chain(y1.to(d), *st_d["in1"], net_d, sites, st_d)
            in_aff = in_affine(m3, inv3, net_d.in3.weight.float(), net_d.in3.bias.float())
            yq = sites_i8.res_chain_s8_static(y3, net_d, sites, st_d, in_aff=in_aff,
                                              emit_qo=sites["d1"].qin)
            y12 = sites_i8.dec_chain_s8_static(yq, net_d, sites, st_d, tail=True)
            outs.append((y3.cpu(), yq.cpu(), d2s(y12, 2, 3).cpu()))
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    log(f"set A chains (K8a, K8b, K2, K3, K6 and the strips) from one conv1 output at "
        f"{x.shape[1]}x{x.shape[2]}, card vs CPU: {'bit-identical' if same else 'DIFFERENT'} "
        f"(head output, d1 codes, deconv3 output)")
    if not same:
        fail("the set A chains differ between the card and the CPU")
    if not bool(torch.isfinite(outs[0][2].float()).all()):
        fail("the set A chain output is not finite")


def zero_counts():
    from neuralstyletransferv1_torch.kernels import bf16_sites as k9
    from neuralstyletransferv1_torch.kernels import dis_iter as k1
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    k1.LAUNCHES = 0
    for counts in (k8.LAUNCHES, k9.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    from neuralstyletransferv1_torch.kernels import bf16_sites as k9
    from neuralstyletransferv1_torch.kernels import dis_iter as k1
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    return {"dis_iter": k1.LAUNCHES, **k8.LAUNCHES, **k9.LAUNCHES}


def slice_phase(dev, quantize: str = "none", fused=None):
    """The 1080p bf16 flow-EMA slice through make_batched_core, plain, with
    a --quantize mode and fused-site set, or with a set of bf16 fused sites;
    returns the run's launch counts."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.ops.dis_flow import _level_sizes

    argv = ["--input_video", "in.mp4", "--output_video", "out.mp4", "--model", str(CKPT),
            "--frame_batch", str(B), "--flow_ema", "--compute_dtype", "bfloat16"]
    if quantize != "none":
        argv += ["--quantize", quantize]
    args = tpipe.build_parser().parse_args(argv)
    if args.device != "cuda":
        fail(f"the CLI's default device is {args.device}, expected cuda")
    frames = moving_frames(B * N_BATCHES, H, W, SEED + 2)
    batch_size, process_batch = tpipe.make_batched_core(args, dev, fused_sites=fused)
    if batch_size != B:
        fail(f"batch size {batch_size}, expected {B}")
    ds = tpipe.effective_flow_downscale(args.flow_downscale, H, W)
    levels = len(_level_sizes(H // ds, W // ds, 2))

    zero_counts()
    torch.cuda.synchronize()
    t_batches = []
    outs = []
    for b in range(N_BATCHES):
        t0 = time.perf_counter()
        out = process_batch(frames[b * B:(b + 1) * B])
        torch.cuda.synchronize()
        t_batches.append(time.perf_counter() - t0)
        outs.append(out)
    counts = read_counts()

    name = slice_name(quantize, fused)
    expected = {"dis_iter": levels * N_BATCHES}
    for k in counts:
        if k != "dis_iter":
            expected[k] = PER_BATCH.get((quantize, fused), {}).get(k, 0) * N_BATCHES
    used = {k: v for k, v in counts.items() if v}
    log(f"slice 1080p B={B} bf16 --quantize {name}: batch seconds "
        f"{', '.join(f'{t:.4f}' for t in t_batches)}; launches {used} (every other kernel 0), "
        f"{'as' if counts == expected else 'NOT as'} expected")
    if counts != expected:
        fail(f"the main path's launches {counts} are not the expected {expected}")
    last = outs[-1]
    if tuple(last.shape) != (B, H, W, 3) or last.dtype != torch.uint8 or last.device != dev:
        fail(f"slice output {tuple(last.shape)} {last.dtype} on {last.device}")
    host = last.cpu().numpy()
    if host.min() == host.max():
        fail("the slice output is constant")
    steady = (N_BATCHES - 1) * B / sum(t_batches[1:])
    overall = N_BATCHES * B / sum(t_batches)
    log(f"slice --quantize {name} frames/s: {steady:.2f} steady (batches 2..{N_BATCHES}), "
        f"{overall:.2f} including the first batch")
    if quantize != "none" or fused:
        quant_quality(dev, args, frames[:B], quantize, fused)
    return counts


def quant_quality(dev, args, frames, quantize, fused=None):
    """The quantized (or fused-site) stylize of the slice's first batch
    against the plain dynamic bf16 stylize of the same frames: within the repo's 1e-2 gate with the
    slot's IO preset (what the main path ran), and, as a check that the path
    is not broken, within QUANT_BROKEN_TOL on the raw_01 scale, where this
    random-weight net's outputs spread over [0, 1] (there int8 noise alone
    is ~1e-2; PERF.md)."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.engine import stylizer as st

    model = tpipe.load_slot_bank(args, dev)[0]
    x = torch.from_numpy(np.stack(frames)).to(dev).float() / 255.0
    for preset, bound in ((model.io_preset, QUANT_MAE_TOL), ("raw_01", QUANT_BROKEN_TOL)):
        m = st.StyleModel(model.arch, model.net, preset, model.name)
        ref = st.jit_stylizer(m, dtype=torch.bfloat16)(x)
        got = st.jit_stylizer(m, dtype=torch.bfloat16, quantize=quantize, fused_sites=fused)(x)
        mae = float((got - ref).abs().mean())
        first = float((got[0] - ref[0]).abs().mean())
        log(f"stylize --quantize {slice_name(quantize, fused)} vs bf16, preset {preset}: "
            f"MAE {mae:.6f} (first frame {first:.6f}; bound {bound})")
        if not (torch.isfinite(got).all() and mae <= bound):
            fail(f"the {slice_name(quantize, fused)} stylize is not within {bound} of the bf16 "
                 f"stylize ({preset})")


def cli_phase(dev, workdir: Path):
    """main() end to end on a synthesized 1080p mp4."""
    import cv2

    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.kernels import dis_iter as k1

    src, dst = workdir / "in.mp4", workdir / "out.mp4"
    vw = cv2.VideoWriter(str(src), cv2.VideoWriter_fourcc(*"mp4v"), 24, (W, H))
    n = 12
    for fr in moving_frames(n, H, W, SEED + 3):
        vw.write(fr[..., ::-1])
    vw.release()
    before = k1.LAUNCHES
    t0 = time.perf_counter()
    rc = tpipe.main(["--input_video", str(src), "--output_video", str(dst),
                     "--model", str(CKPT), "--frame_batch", str(B), "--flow_ema",
                     "--compute_dtype", "bfloat16", "--work_dir", str(workdir / "_work")])
    secs = time.perf_counter() - t0
    cap = cv2.VideoCapture(str(dst))
    got = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
    cap.release()
    log(f"main() on a {n}-frame 1080p mp4: rc {rc}, {got} frames written, {secs:.2f} s, "
        f"K1 launches {k1.LAUNCHES - before}")
    if rc != 0 or got != n or k1.LAUNCHES == before:
        fail("main() did not style the clip end to end")


def ptxas_report(text: str, k8) -> None:
    """ptxas' registers and spills of every kernel entry of one build log,
    and the dynamic shared memory of the tensor-core core's instantiations
    (mma_kernel<C, prologue, epilogue>: <C, 0, 0> is K4, <C, 2, 2> K3)."""
    import re

    name, spill = None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif name and "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif name and "registers" in line:
            # the kernel's own name among the mangled name's length-prefixed
            # identifiers, and its int template arguments
            base = next((m.group(2) for m in re.finditer(r"(?=(\d+)([a-z][a-z0-9_]*?)(?=[IE]))", name)
                         if len(m.group(2)) == int(m.group(1))), name)
            targs = re.findall(r"Li(-?\d+)E", name)
            short = f"{base}<{', '.join(targs)}>" if targs else base
            extra = ""
            if base == "mma_kernel":
                c = int(targs[0])
                short += " (K4)" if targs[1] == "0" else " (K3)"
                extra = f", {k8._lib().mma_kernel_smem_bytes(c)} bytes dynamic shared memory"
            log(f"ptxas: {short}: {line.split(':', 1)[-1].strip()}; {spill}{extra}")
            name = None


PHASES = ("next tile's loads issued", "MMAs issued", "fragment epilogue (MMA drain incl.)",
          "stores and sums", "next tile's quantize / copy")


def phases_phase(dev):
    """--phases: K3's and K4's mma_kernel built with MMA_PHASE_CLOCKS, each
    of their 1080p B=8 cases run once; the share of each phase of the tile
    loop in the clock of every block's thread 0, averaged over blocks."""
    import ctypes

    import numpy as np
    import torch

    from neuralstyletransferv1_torch.kernels import _build
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    src = _build.CSRC / k8._SOURCE
    so = _build.BUILD_DIR / "libint8_sites_phases.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DMMA_PHASE_CLOCKS", "-o", str(so), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        fail(f"nvcc -DMMA_PHASE_CLOCKS failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(so))
    base = k8._lib
    for name in ("res_site_launch", "site_s8_launch"):
        getattr(lib, name).argtypes = getattr(base(), name).argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.mma_phase_clocks_read.argtypes = [ctypes.c_void_p]
    clocks = np.zeros((1024, len(PHASES)), dtype=np.uint64)  # every launch rewrites its blocks'
    k8._lib = lambda: lib  # the wrappers launch the instrumented build
    try:
        for name in REDESIGNED:
            for shape, form in INT8_KERNELS[name][0]:
                t = site_inputs(dev, *SITE_SHAPES[shape][:5], seed=11)
                kernel = site_calls(name, t, shape, form)[0]
                kernel()
                torch.cuda.synchronize()
                if lib.mma_phase_clocks_read(clocks.ctypes.data) != 0:
                    fail("reading mma_phase_clocks failed")
                used = clocks[clocks.sum(axis=1) > 0].astype(np.float64)
                share = used.mean(axis=0) / used.sum(axis=1).mean()
                log(f"phases {name} @ {shape}{'/' + form if form else ''}: {len(used)} blocks, "
                    f"{used.sum(axis=1).mean():.0f} cycles a block; " +
                    ", ".join(f"{ph} {sh:.1%}" for ph, sh in zip(PHASES, share)))
                del t, kernel
                torch.cuda.empty_cache()
    finally:
        k8._lib = base


def kernel_group(name: str) -> str:
    """A device kernel's kind, from its name."""
    n = name.lower()
    if "kernel_bf16" in n or "stats_reduce_bf16" in n:
        return "bf16 sites K9a-K9e"
    if any(k in n for k in ("site_kernel", "mma_kernel", "stats_reduce", "rows_kernel")):
        return "int8 sites K2-K8b"
    if "dis_iter" in n:
        return "K1 (DIS)"
    if any(k in n for k in ("conv", "xmma", "cutlass", "sm90_", "implicit", "gemm", "cudnn")):
        return "cuDNN conv"
    if any(k in n for k in ("memcpy", "memset", "copy", "cat", "transpose", "pad",
                            "index", "gather", "repeat")):
        return "copies, pads, layout, gathers"
    if any(k in n for k in ("reduce", "norm", "sum", "mean")):
        return "reductions (norm statistics)"
    return "elementwise"


def profile_phase(dev):
    """Device time of one steady 1080p B=8 batch of each slice, by kind of
    kernel and by kernel (torch.profiler after two warm-up batches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from neuralstyletransferv1_torch.engine import pipeline as tpipe

    frames = moving_frames(3 * B, H, W, SEED + 6)
    for mode, fused in (("none", None), ("bf16_static", None)) + SLICES:
        argv = ["--input_video", "in.mp4", "--output_video", "out.mp4", "--model", str(CKPT),
                "--frame_batch", str(B), "--flow_ema", "--compute_dtype", "bfloat16",
                "--quantize", mode]
        _, proc = tpipe.make_batched_core(tpipe.build_parser().parse_args(argv), dev,
                                          fused_sites=fused)
        proc(frames[:B])
        proc(frames[B:2 * B])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            proc(frames[2 * B:])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(ms for _, ms, _ in kernels)
        groups: dict = {}
        for name, ms, _ in kernels:
            groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + ms
        log(f"profile --quantize {slice_name(mode, fused)}: batch wall {wall:.2f} ms, "
            f"device busy {busy:.2f} ms "
            f"({busy / wall:.1%}), {sum(c for _, _, c in kernels)} device kernels and copies")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            log(f"  {g}: {ms:.2f} ms")
        for name, ms, count in sorted(kernels, key=lambda k: -k[1])[:12]:
            log(f"    {ms:8.3f} ms  x{count:<4d} {name[:110]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA GPU is visible")
    if not (ROOT / "neuralstyletransferv1_torch").is_dir() or not CKPT.exists():
        fail("run from the root of a checkout (neuralstyletransferv1_torch/ and _testdata/)")
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else None
    if card is None:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card, flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    from neuralstyletransferv1_torch.device import resolve_device
    from neuralstyletransferv1_torch.kernels import _build
    from neuralstyletransferv1_torch.kernels import bf16_sites as k9
    from neuralstyletransferv1_torch.kernels import dis_iter as k1
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    resolve_device("cuda")  # TF32 off for the f32 paths
    t0 = time.perf_counter()
    _build.build([k1._SOURCE, k8._SOURCE, k9._SOURCE])
    k1._lib()
    k8._lib()
    k9._lib()
    log(f"built K1, K2-K8b and K9a-K9e with nvcc (in parallel) in "
        f"{time.perf_counter() - t0:.2f} s")
    if sys.argv[1:] in (["--profile"], ["--phases"]):
        (profile_phase if sys.argv[1] == "--profile" else phases_phase)(dev)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0
    for txt in sorted(_build.BUILD_DIR.glob("*.ptxas.txt")):
        ptxas_report(txt.read_text(), k8)

    worst, k1_ms, k1_plain_ms, k1_bound_ms = k1_phase(dev)
    int8 = int8_kernel_phase(dev)
    bf16 = bf16_kernel_phase(dev)
    reference_phase(dev)
    quant_reference_phase(dev)
    launches = {k: 0 for k in read_counts()}
    for mode, fused in (("none", None),) + SLICES:
        for k, v in slice_phase(dev, mode, fused).items():
            launches[k] += v
    if "jax" in sys.modules:
        fail("jax was imported")
    try:
        import cv2  # noqa: F401
    except ImportError:
        log("OpenCV is not installed: the main() video phase does not run")
    else:
        with tempfile.TemporaryDirectory() as tmp:
            cli_phase(dev, Path(tmp))
        if "jax" in sys.modules:
            fail("jax was imported")

    kernels = [{
        "name": "dis_iter", "route": "cuda",
        "source": "neuralstyletransferv1_torch/csrc/dis_iter.cu",
        "replaces": "neuralstyletransferv1_tpu/ops/dis_flow.py:113",
        "launches": launches["dis_iter"], "max_abs_err": worst,
        "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms, "bound_by": "bytes",
        "library_ms": None,
    }]
    for name, (_cases, replaces) in INT8_KERNELS.items():
        rec = int8[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "neuralstyletransferv1_torch/csrc/int8_sites.cu", "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            "cudnn_bf16_ms": rec["cudnn_bf16_ms"],
            **{k: rec[k] for k in ("prev_ms", "bound_share") if k in rec},
            "per_case": rec["per_case"],
        })
    for name, (_shape, replaces) in BF16_KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "neuralstyletransferv1_torch/csrc/bf16_sites.cu", "replaces": replaces,
            "launches": launches[name], "library_ms": None, **bf16[name],
        })
    for name in (*INT8_KERNELS, *BF16_KERNELS):
        if launches[name] == 0:
            fail(f"{name} was launched no time on the main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
