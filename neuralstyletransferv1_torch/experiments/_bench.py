"""The experiments' timing protocol on the card and what they share with
``chip_smoke.py``: the card's peak rates, the bf16 check's limits and the
CUDA-event timer.

The TPU scripts' ``_bench.py`` chains K calls and subtracts one (its relay
memoized calls). On the card a call is timed with CUDA events around
``reps`` warm launches (``cuda_ms``); ``in_turns`` times several calls that
way in rounds, one of each a round, and keeps each one's median over the
rounds and its spread, (max − min) / median.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from statistics import median

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import bf16_sites as k9

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet (the bound's memory rate)
PEAK_INT8_OPS = 1979e12     # dense int8 tensor-core ops/s, same sheet
PEAK_BF16_OPS = 989e12      # dense bf16 tensor-core FLOP/s, same sheet
PEAK_F32_OPS = 67e12        # f32 outside the tensor cores, same sheet
BF16_EQUAL_SHARE = 0.99     # share of bf16 outputs equal to the plain version's
SUM_TOL = 1e-5              # relative, [Σ, Σ²] against the plain sums


def cuda_ms(fn, reps: int = 20) -> float:
    """Per-call time on the device timeline (CUDA events), host gaps included."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(calls: dict, rounds: int = 5) -> dict:
    """``{name: (fn, reps)}`` timed in ``rounds`` rounds, each call once a
    round by ``cuda_ms``: ``{name: {"ms": median, "spread": ...}}``."""
    runs = {name: [] for name in calls}
    for _ in range(rounds):
        for name, (fn, reps) in calls.items():
            runs[name].append(cuda_ms(fn, reps))
    out = {}
    for name, r in runs.items():
        mid = median(r)
        out[name] = {"ms": mid, "spread": (max(r) - min(r)) / mid}
    return out


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    bf16 operations over the tensor-core peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_BF16_OPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "operations" if t_ops > t_bytes
            else "bytes", "gbytes": nbytes / 1e9, "flop": flops}


def card() -> str:
    """``name, power.limit`` of the card as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default: the kernels, timed) or cpu (the plain versions, "
                        "not timed)")
    p.add_argument("--small", action="store_true", help="a small shape (a CPU rehearsal)")
    p.add_argument("--seed", type=int, default=0, help="numpy seed of the inputs")
    return p


def setup(args) -> tuple[torch.device, dict]:
    """The device (TF32 off on CUDA) and the record's header."""
    dev = resolve_device(args.device)
    head = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if dev.type == "cuda":
        head["card"] = card()
    return dev, head


def normal(rng: np.random.Generator, shape, scale: float, dev, dtype=torch.bfloat16):
    """A seeded normal tensor made on the host, on ``dev`` in ``dtype``."""
    a = rng.standard_normal(shape, dtype=np.float32)
    if scale != 1.0:
        a *= np.float32(scale)
    return torch.from_numpy(a).to(dev).to(dtype)


def check(name: str, out, again, ref, *, sums=None, sums_again=None, sums_ref=None) -> dict:
    """Kernel (``out``, ``again``: two launches) against its plain version
    ``ref``: the launches bit-identical; every bf16 output within 1 ulp, an
    ulp taken at no less than 2^-8 of the largest magnitude (the two differ
    by the order of their f32 accumulation), and ``BF16_EQUAL_SHARE`` of them
    equal; the sums within ``SUM_TOL``. Raises on a failure."""
    if not torch.equal(out, again) or (sums is not None and not torch.equal(sums, sums_again)):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    if out.shape != ref.shape or out.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: output {tuple(out.shape)} {out.dtype}, expected "
                             f"{tuple(ref.shape)} bfloat16")
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    worst, equal = k9.bf16_ulp_error(out, ref)
    rec = {"max_abs_err": float((out.float() - ref.float()).abs().max()), "worst_ulp": worst,
           "equal_share": equal}
    if worst > 1.0 or equal < BF16_EQUAL_SHARE:
        raise AssertionError(f"{name}: {worst:.3g} ulp from the plain version at worst (limit "
                             f"1), equal on {equal:.4%}")
    if sums is not None:
        n = out.shape[1] * out.shape[2]
        s, sr = sums.double(), sums_ref.double()
        e2 = ((s[:, 1] - sr[:, 1]).abs() / sr[:, 1].clamp_min(1e-30)).max()
        e1 = ((s[:, 0] - sr[:, 0]).abs() / (n * sr[:, 1]).sqrt().clamp_min(1e-30)).max()
        rec["sums_rel_err"] = float(max(e1, e2))
        if rec["sums_rel_err"] > SUM_TOL:
            raise AssertionError(f"{name}: sums {rec['sums_rel_err']:.3g} from the plain sums "
                                 f"(limit {SUM_TOL})")
    return rec


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)
