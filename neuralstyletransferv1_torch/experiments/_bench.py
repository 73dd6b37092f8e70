"""The experiments' timing protocol on the card and what they share with
``chip_smoke.py``: the card's peak rates, the bf16 check's limits and the
CUDA-event timer.

The TPU scripts' ``_bench.py`` chains K calls and subtracts one (its relay
memoized calls). On the card a call is timed with CUDA events around
``reps`` warm launches (``cuda_ms``); ``in_turns`` times several calls that
way in rounds, one of each a round, and keeps each one's median over the
rounds and its spread, (max − min) / median. A call shorter than its
wrapper's host time (K12's flat forms: tens of microseconds of Python and
ctypes a launch) would time the host that way: with ``graph`` every call
is captured ``reps`` times into one CUDA graph and the graph's replay is
timed instead (``graph_ms``), the device time a call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from statistics import median

import numpy as np
import torch
import torch.nn.functional as F

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


def capture(fn, reps: int):
    """``reps`` calls of ``fn`` captured in one CUDA graph (after a warm call
    on a side stream, as capture wants)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return graph


def graph_ms(graph, reps: int) -> float:
    """Per-call time of a graph of ``reps`` captured calls: CUDA events
    around one replay, after a warm one."""
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(calls: dict, rounds: int = 5, graph: bool = False) -> dict:
    """``{name: (fn, reps)}`` timed in ``rounds`` rounds, each call once a
    round by ``cuda_ms`` (or, with ``graph``, its captured graph by
    ``graph_ms``): ``{name: {"ms": median, "spread": ...}}``."""
    runs = {name: [] for name in calls}
    graphs = {name: capture(fn, reps) for name, (fn, reps) in calls.items()} if graph else {}
    for _ in range(rounds):
        for name, (fn, reps) in calls.items():
            runs[name].append(graph_ms(graphs[name], reps) if graph else cuda_ms(fn, reps))
    out = {}
    for name, r in runs.items():
        mid = median(r)
        out[name] = {"ms": mid, "spread": (max(r) - min(r)) / mid}
    return out


def bound(nbytes: float, flops: float, peak: float = PEAK_BF16_OPS) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the tensor-core peak of their type (``peak``: bf16 by
    default, ``PEAK_INT8_OPS`` for the s8 forms), whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
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


def _sums_error(out, sums, sums_ref) -> float:
    """[Σ, Σ²] against the plain sums: Σ² relative to itself, Σ relative to
    sqrt(n·Σ²) (n the pixels an image)."""
    n = out.shape[1] * out.shape[2]
    s, sr = sums.double(), sums_ref.double()
    e2 = ((s[:, 1] - sr[:, 1]).abs() / sr[:, 1].clamp_min(1e-30)).max()
    e1 = ((s[:, 0] - sr[:, 0]).abs() / (n * sr[:, 1]).sqrt().clamp_min(1e-30)).max()
    return float(max(e1, e2))


def check(name: str, out, again, ref, *, exact: bool = False, sums=None, sums_again=None,
          sums_ref=None, zero_sums: bool = False) -> dict:
    """Kernel (``out``, ``again``: two launches) against its plain version
    ``ref``: the launches bit-identical; with ``exact`` (both compute the same
    exact function: integer sums, one rounding) the output bit-identical to
    the plain one, of any dtype; else every bf16 output within 1 ulp, an ulp
    taken at no less than 2^-8 of the largest magnitude (the two differ by
    the order of their f32 accumulation), and ``BF16_EQUAL_SHARE`` of them
    equal. The sums within ``SUM_TOL`` (they run in another order), or all
    zero with ``zero_sums``. Raises on a failure."""
    if not torch.equal(out, again) or (sums is not None and not torch.equal(sums, sums_again)):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    dtype = ref.dtype if exact else torch.bfloat16
    if out.shape != ref.shape or out.dtype != dtype:
        raise AssertionError(f"{name}: output {tuple(out.shape)} {out.dtype}, expected "
                             f"{tuple(ref.shape)} {dtype}")
    if exact:
        if not torch.equal(out, ref):
            diff = (out.double() - ref.double()).abs()
            raise AssertionError(f"{name}: differs from the plain version on "
                                 f"{int((diff > 0).sum())} elements, by {float(diff.max()):.4g} "
                                 "at most")
        rec = {"max_abs_err": 0.0, "bit_identical": True}
    else:
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"{name}: non-finite output")
        worst, equal = k9.bf16_ulp_error(out, ref)
        rec = {"max_abs_err": float((out.float() - ref.float()).abs().max()),
               "worst_ulp": worst, "equal_share": equal}
        if worst > 1.0 or equal < BF16_EQUAL_SHARE:
            raise AssertionError(f"{name}: {worst:.3g} ulp from the plain version at worst "
                                 f"(limit 1), equal on {equal:.4%}")
    if zero_sums:
        if not bool((sums == 0).all()):
            raise AssertionError(f"{name}: the no-statistics form wrote nonzero sums")
    elif sums is not None:
        rec["sums_rel_err"] = _sums_error(out, sums, sums_ref)
        if rec["sums_rel_err"] > SUM_TOL:
            raise AssertionError(f"{name}: sums {rec['sums_rel_err']:.3g} from the plain sums "
                                 f"(limit {SUM_TOL})")
    return rec


def _pair(x):
    return (x, None) if isinstance(x, torch.Tensor) else x


def measure(name: str, call, plain, dev, *, exact=True, check_fn=None, check_kw=None,
            work=None, library=None, yardsticks=None, prev=None, graph=False, reps: int = 10,
            plain_reps: int = 2) -> dict:
    """One kernel form: ``call`` (the kernel's wrapper) launched twice and
    ``plain`` (its plain version) once, held by ``check`` (``exact`` or not;
    tensors, or (out, sums) pairs) or by ``check_fn`` where a form needs its
    own (mk20's f32 out); on the card also its bound
    (``work`` = (bytes, operations[, peak])) and, in turns (``graph``: by
    CUDA graph replay), the times of the kernel (``ms``), its previous core
    (``prev``, the same function: ``prev_ms``, checked like the kernel), the
    plain version (``plain_ms``), ``library`` (one PyTorch call that computes
    the same function, or None: ``library_ms``) and the ``yardsticks``
    ({key: call} of PyTorch calls that do not)."""
    (out, s), (again, s2), (ref, sr) = _pair(call()), _pair(call()), _pair(plain())
    kw = dict(check_kw or {})
    if s is not None:
        kw.update(sums=s, sums_again=s2, sums_ref=sr)
    rec = (check_fn(name, out, again, ref, **kw) if check_fn is not None
           else check(name, out, again, ref, exact=exact, **kw))
    if prev is not None and dev.type == "cuda":
        (po, ps), (po2, ps2) = _pair(prev()), _pair(prev())
        kw.update({} if ps is None else {"sums": ps, "sums_again": ps2})
        (check_fn(name + " (previous core)", po, po2, ref, **kw) if check_fn is not None
         else check(name + " (previous core)", po, po2, ref, exact=exact, **kw))
        del po, po2, ps, ps2
    del out, again, ref, s, s2, sr
    if dev.type != "cuda":
        return rec
    if work is not None:
        rec.update(bound(*work))
    calls = {"ms": (call, reps), "plain_ms": (plain, plain_reps)}
    if prev is not None:
        calls["prev_ms"] = (prev, reps)
    if library is not None:
        calls["library_ms"] = (library, reps)
    calls.update({k: (fn, reps) for k, fn in (yardsticks or {}).items()})
    t = in_turns(calls, graph=graph)
    rec.update({k: v["ms"] for k, v in t.items()})
    if graph:
        rec["timing"] = "CUDA graph replay"
    rec["library_ms"] = rec.get("library_ms")
    rec["spread"] = {k: v["spread"] for k, v in t.items()}
    if work is not None:
        rec["tops"] = work[1] / rec["ms"] / 1e9
    torch.cuda.empty_cache()
    return rec


def conv3x3(x: torch.Tensor, co: int, padding: int, seed: int = 0):
    """The cuDNN bf16 3×3 conv of x [B,H,W,C] bf16 (a channels-last view) to
    ``co`` channels, seeded weights: the library call a conv site stands
    for, a yardstick of speed (it does not compute the site's function)."""
    w = normal(np.random.default_rng(seed), (co, x.shape[-1], 3, 3), 0.05, x.device)
    w = w.contiguous(memory_format=torch.channels_last)
    xc = x.permute(0, 3, 1, 2)
    return lambda: F.conv2d(xc, w, padding=padding)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)
