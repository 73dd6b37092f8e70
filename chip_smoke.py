#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and nvcc. In
order, and any failed phase exits non-zero:

1. require CUDA and the port's package beside this file;
2. print the card's name and power limit (nvidia-smi);
3. build K1 (``neuralstyletransferv1_torch/csrc/dis_iter.cu``) with nvcc;
4. hold K1 against its plain PyTorch version at the four DIS pyramid levels
   of the 1080p slice (8 frame pairs, flow at half resolution), and time
   both;
5. check the CUDA slice against the port's CPU path (plain K1) on a small
   input, in f32 with the exact warp;
6. drive the slice — ``make_batched_core`` with the CLI's own parsed argv:
   1920×1080 frames, batches of 8, flow EMA, bf16, the repo's full-width
   random-weight Johnson checkpoint — over 3 batches of synthesized moving
   frames, and check that every K1 launch of the path happened;
7. when OpenCV is installed, run the CLI ``main()`` end to end on a
   synthesized 1080p mp4.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
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
    worst, ms_total, plain_total = 0.0, 0.0, 0.0
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
        worst = max(worst, float(du.max()))
        log(f"K1 level {lh}x{lw}: {n} patches, offsets within {K1_OFFSET_TOL} px on "
            f"{share:.4%} (bound {K1_SHARE:.0%}), max offset err {float(du.max()):.3g} px, "
            f"residual err {res_err:.3g} (bound {K1_RES_TOL}); per call {t_k:.4f} ms "
            f"(plain {t_plain:.4f} ms); device time {d_k} ms (plain {d_plain} ms)")
        if share < K1_SHARE or res_err > K1_RES_TOL:
            fail(f"K1 disagrees with its plain version at level {lh}x{lw}")
    return worst, ms_total, plain_total


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


def slice_phase(dev):
    """The 1080p bf16 flow-EMA slice through make_batched_core."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.kernels import dis_iter as k1
    from neuralstyletransferv1_torch.ops.dis_flow import _level_sizes

    argv = ["--input_video", "in.mp4", "--output_video", "out.mp4", "--model", str(CKPT),
            "--frame_batch", str(B), "--flow_ema", "--compute_dtype", "bfloat16"]
    args = tpipe.build_parser().parse_args(argv)
    if args.device != "cuda":
        fail(f"the CLI's default device is {args.device}, expected cuda")
    frames = moving_frames(B * N_BATCHES, H, W, SEED + 2)
    batch_size, process_batch = tpipe.make_batched_core(args, dev)
    if batch_size != B:
        fail(f"batch size {batch_size}, expected {B}")
    ds = tpipe.effective_flow_downscale(args.flow_downscale, H, W)
    levels = len(_level_sizes(H // ds, W // ds, 2))

    k1.LAUNCHES = 0
    torch.cuda.synchronize()
    t_batches = []
    outs = []
    for b in range(N_BATCHES):
        t0 = time.perf_counter()
        out = process_batch(frames[b * B:(b + 1) * B])
        torch.cuda.synchronize()
        t_batches.append(time.perf_counter() - t0)
        outs.append(out)
    launches = k1.LAUNCHES

    expected = levels * N_BATCHES
    log(f"slice 1080p B={B} bf16: batch seconds {', '.join(f'{t:.4f}' for t in t_batches)}; "
        f"K1 launches {launches} (expected {levels} levels x {N_BATCHES} batches)")
    if launches != expected:
        fail(f"K1 launched {launches} times on the main path, expected {expected}")
    last = outs[-1]
    if tuple(last.shape) != (B, H, W, 3) or last.dtype != torch.uint8 or last.device != dev:
        fail(f"slice output {tuple(last.shape)} {last.dtype} on {last.device}")
    host = last.cpu().numpy()
    if host.min() == host.max():
        fail("the slice output is constant")
    steady = (N_BATCHES - 1) * B / sum(t_batches[1:])
    overall = N_BATCHES * B / sum(t_batches)
    log(f"slice frames/s: {steady:.2f} steady (batches 2..{N_BATCHES}), "
        f"{overall:.2f} including the first batch")
    return launches


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
    from neuralstyletransferv1_torch.kernels import dis_iter as k1

    resolve_device("cuda")  # TF32 off for the f32 paths
    t0 = time.perf_counter()
    k1._lib()
    log(f"built K1 with nvcc in {time.perf_counter() - t0:.2f} s")
    for txt in sorted(_build.BUILD_DIR.glob("*.ptxas.txt")):
        for line in txt.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas: {line.strip()}")

    worst, k1_ms, k1_plain_ms = k1_phase(dev)
    reference_phase(dev)
    launches = slice_phase(dev)
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

    print(json.dumps({"kernels": [{
        "name": "dis_iter", "route": "cuda",
        "source": "neuralstyletransferv1_torch/csrc/dis_iter.cu",
        "replaces": "neuralstyletransferv1_tpu/ops/dis_flow.py:113",
        "launches": launches, "max_abs_err": worst,
        "ms": k1_ms, "plain_ms": k1_plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
