"""K12 ``shift_dot`` and K13 ``pad_inject``: the int8 probes of
``experiments/`` (``csrc/int8_probes.cu``).

K12 is the shifted dot the probe scripts time, over flat rows:

    out[g, m, :] = epi(Σ_r pro(A)[g, src(m, r), :] · W[r])

with A [G, MA, K], W [R, K, N] (packed [R, N, K] by ``pack_taps``), out
[G, M, N]. Two layouts:

  flat   ``flat_dot``: src = m + off[r] inside slice g (mk20's probe-2 dot,
         one tap of K = 512; mk27's six shifted K = 128 dots, offsets r or
         32r, over G slices)
  strip  ``strip_dot``: x [B, H+2, W, C], strip j of TS output rows reads
         S_j = rows [TS·j, TS·j + TS + 2) of x flattened to (TS+2)·W rows,
         then zeros; out[b, TS·j + r, col] = epi(Σ_{dy,dx} S_j[r·W + col +
         dy·W + dx] · w9[3dy + dx]) for every one of the W columns: the dx
         taps run off the end of a row into the next, there is no column
         halo (mk20's probe 3, mk21's tap9, k384 and noq)

Prologues (``pro``): "none" (the s8 or bf16 operands as given), "quant"
(bf16 → s8 clamp(round(x·16), −127, 127), half to even) and "cast"
(bf16 → s8 as XLA converts: NaN → 0, else clamp(trunc(x), −128, 127)).
Epilogues (``out``): "s32" and "f32" (the accumulator), or "bf16":
bf16(f32(acc)·oscale). The s8 forms are exact integer sums; the bf16 forms
sum exact products in f32 in their own order. Forms the kernel is built
for: s8 → s32 or bf16; bf16 → f32 or bf16; bf16 "quant" or "cast" → bf16.

K13 ``pad_inject`` is mk28's column pad: x [B, R, W0, C] bf16 → [B, R, WP,
C], column c holds input column c − 1 for 1 ≤ c ≤ W0, else 0 (P1, bf16);
with ``inject`` the s8 codes clamp(round(x·4), −127, 127) in the same
places, column 0 ← input column 1 and column W0 + 2 ← input column W0 − 2
(P2, the probe's own indices).

Each wrapper dispatches on the tensors' device: CPU → the ``*_plain``
version, CUDA → the kernel or an error, no fallback. ``LAUNCHES[name]``
counts kernel launches. The plain versions compute s8 products as an f64
matmul of the codes (exact) and bf16 products in f32.

On the card K12 runs on ``shift_wgmma_kernel``: a persistent block an SM,
tiles of 128 rows × 128 channels, the A rows and the weights brought by
TMA through rings of shared memory (``smem_plan`` mirrors how many slots
fit), warpgroup MMAs with A from registers at each tap's shifted row.
``flat_dot_prev`` / ``strip_dot_prev`` launch the same function on the
previous core (``shift_dot_kernel``), CUDA tensors only, for timing the
two in turns: they count no launch.

K13 runs on ``pad_inject_v2_kernel``: a 2-D grid of (column chunk, output
row), 32-bit offsets with no division, each thread's ``PAD_UNITS`` loads in
flight before its first store (one, where that leaves fewer than two blocks
an SM); P1 is a row copy shifted by one pixel, P2's codes leave 16 bytes a
store where a row holds an even number of 8-channel pieces
(``pad_source_piece`` and ``pad_grid`` mirror it).
``pad_inject_prev`` launches its first core (``pad_inject_kernel``), CUDA
tensors only, counting no launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

_SOURCE = "int8_probes.cu"
LAUNCHES = {"shift_dot": 0, "pad_inject": 0}
PROLOGUES = {"none": 0, "quant": 1, "cast": 2}
EPILOGUES = {"s32": 0, "f32": 1, "bf16": 2}
#: (A dtype, prologue, epilogue) forms K12 is built for
FORMS = ((torch.int8, "none", "s32"), (torch.int8, "none", "bf16"),
         (torch.bfloat16, "none", "f32"), (torch.bfloat16, "none", "bf16"),
         (torch.bfloat16, "quant", "bf16"), (torch.bfloat16, "cast", "bf16"))
K_CHUNK = N_TILE = 128   # K and N are multiples of these
MAX_TAPS = 9
SMEM_MAX = 232448        # dynamic shared memory a block may take on an H100
STRIP_TS = 8             # mk20's and mk21's strip height
TILE_M = 128             # output rows of a tile; taps within 128 rows share a staged segment
SPAN = 128               # bytes of a staged k-chunk row (the 128-byte swizzle span)
EPI_BYTES = 2 * 2 * 64 * SPAN   # two 64-row epilogue slices in flight per warpgroup
BAR_BYTES, ZERO_BYTES, MAX_SLOTS = 256, 128, 6
QSCALE_DOT = 16.0        # K12's "quant" prologue: x·16 (mk20's probe 3, mk21)
QSCALE_PAD = 4.0         # K13's quantize with ``inject``: x·4 (mk28's P2)
PAD_THREADS, PAD_UNITS = 256, 4   # K13's block and the most units a thread loads before it stores


def pack_taps(w: torch.Tensor) -> torch.Tensor:
    """The taps' weights [R, K, N] (the scripts' layout) → [R, N, K]
    contiguous, k innermost (the rows the tensor cores read)."""
    return w.transpose(1, 2).contiguous()


def regroup_k384(w3: torch.Tensor) -> torch.Tensor:
    """mk21's k384 weights [3, 3C, C] (row dx·C + k of dy's matrix) → the
    tap9 weights [9, C, C]: k384 is tap9 with the dx taps concatenated."""
    _, c3, c = w3.shape
    return w3.reshape(9, c3 // 3, c)


def strip_offsets(w: int) -> list:
    """The 9 taps' row offsets dy·W + dx of the strip form."""
    return [dy * w + dx for dy in range(3) for dx in range(3)]


def _segments(offsets) -> list:
    """The staged segments [base, rows] of a tile: taps whose offsets lie
    within ``TILE_M`` of the previous one share a segment of TILE_M + span
    rows (``make_plan`` in the source)."""
    segs, end = [], None
    for o in sorted(offsets):
        if not segs or o - end > TILE_M:
            segs.append([o, TILE_M])
        end = o
        segs[-1][1] = TILE_M + o - segs[-1][0]
    return segs


def smem_plan(offsets, pro: str = "none") -> dict:
    """What ``shift_wgmma_kernel`` stages for these offsets
    (``make_wplan``, ``wbudget``): each segment in TMA boxes of
    ``box`` rows (a multiple of 8, at most 256), ``rows`` staged rows a
    k-chunk of 128 bytes, and as many ring slots as fit the block's shared
    memory, at least two A slots (``a_slots``) and two weight slots
    (``w_slots``); ``bytes`` above ``SMEM_MAX`` means the form cannot run."""
    segs = _segments(offsets)
    most = max(r for _, r in segs)
    nb = -(-most // 256)
    box = 8 * -(-most // (8 * nb))
    rows = sum(-(-r // box) * box for _, r in segs)
    a, w = rows * SPAN, N_TILE * SPAN

    def total(na, nw):
        return (1024 + a * (na + (pro != "none")) + w * nw + EPI_BYTES + BAR_BYTES
                + ZERO_BYTES)

    na = nw = 2
    grew = True
    while grew:
        grew = False
        if nw < MAX_SLOTS and total(na, nw + 1) <= SMEM_MAX:
            nw, grew = nw + 1, True
        if na < 4 and total(na + 1, nw) <= SMEM_MAX:
            na, grew = na + 1, True
    return {"bytes": total(na, nw), "a_slots": na, "w_slots": nw, "rows": rows, "box": box}


# ---------------------------------------------------------------------------
# plain versions (PyTorch ops; the CPU path and the card's yardstick)
# ---------------------------------------------------------------------------


def saturate_s8(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 → s8 convert as float codes: NaN → 0, truncate, clamp to
    [−128, 127] (PyTorch's ``.to(torch.int8)`` wraps instead)."""
    x = x.float()
    return torch.where(torch.isnan(x), 0.0, torch.clamp(torch.trunc(x), -128.0, 127.0))


def quant_s8(x: torch.Tensor, scale: float) -> torch.Tensor:
    """clamp(round(x·scale), −127, 127), half to even, as float codes."""
    return torch.clamp(torch.round(x.float() * scale), -127.0, 127.0)


def _mma_bf16(a: torch.Tensor, pro: str) -> bool:
    return a.dtype == torch.bfloat16 and pro == "none"


def _prologue(a: torch.Tensor, pro: str) -> torch.Tensor:
    """The operands the products take: f64 codes for the s8 forms (exact),
    f32 values for the bf16 form."""
    if pro == "quant":
        return quant_s8(a, QSCALE_DOT).double()
    if pro == "cast":
        return saturate_s8(a).double()
    return a.float() if a.dtype == torch.bfloat16 else a.double()


def _epilogue(acc: torch.Tensor, out: str, oscale: float) -> torch.Tensor:
    if out == "s32":
        return acc.round().to(torch.int32)
    if out == "f32":
        return acc.float()
    return (acc.float() * oscale).to(torch.bfloat16)


def _check_form(kernel: str, a: torch.Tensor, pro: str, out: str):
    if pro not in PROLOGUES or out not in EPILOGUES:
        raise ValueError(f"{kernel}: prologue {pro!r} / epilogue {out!r} unknown")
    if (a.dtype, pro, out) not in FORMS:
        raise ValueError(f"{kernel}: no kernel form for {a.dtype} operands, prologue {pro!r}, "
                         f"{out} out (built: {FORMS})")


def flat_dot_plain(a, wt, offsets, rows=None, *, pro="none", out="bf16", oscale=1.0):
    """K12's flat form, plain: a [G, MA, K] (or [MA, K]), wt [R, N, K] →
    [G, M, N] (or [M, N]); M = ``rows``, default MA − max(offsets)."""
    _check_form("shift_dot", a, pro, out)
    flat = a.dim() == 2
    a3 = a[None] if flat else a
    m = a3.shape[1] - max(offsets) if rows is None else rows
    ops = _prologue(a3, pro)
    w = wt.to(ops.dtype)
    acc = None
    for r, off in enumerate(offsets):
        src = ops[:, off:off + m]
        if src.shape[1] < m:
            raise ValueError(f"shift_dot: offset {off} reads past A's {a3.shape[1]} rows")
        p = src @ w[r].T
        acc = p if acc is None else acc + p
    res = _epilogue(acc, out, oscale)
    return res[0] if flat else res


def strip_dot_plain(x, wt, *, pro="none", out="bf16", oscale=1.0):
    """K12's strip form, plain: x [B, H+2, W, C], wt [9, N, C] → [B, H, W, N].
    It builds each strip S_j (its TS + 2 rows flattened, then W zero rows)
    and sums the 9 shifted products of every strip row."""
    _check_form("shift_dot", x, pro, out)
    b, h2, w, c = x.shape
    h, ts = h2 - 2, STRIP_TS
    if h % ts:
        raise ValueError(f"shift_dot: H={h} is not a multiple of TS={ts}")
    nj = h // ts
    ops = _prologue(x, pro)
    strips = torch.stack([ops[:, ts * j:ts * j + ts + 2] for j in range(nj)], 1)
    s = F.pad(strips.reshape(b, nj, (ts + 2) * w, c), (0, 0, 0, w))
    wv = wt.to(ops.dtype)
    acc = None
    for r, off in enumerate(strip_offsets(w)):
        p = s[:, :, off:off + ts * w] @ wv[r].T
        acc = p if acc is None else acc + p
    return _epilogue(acc, out, oscale).reshape(b, h, w, -1)


def pad_inject_plain(x, wp, *, inject=False):
    """K13, plain: x [B, R, W0, C] bf16 → [B, R, WP, C] (bf16, or s8 codes
    with ``inject``)."""
    w0 = x.shape[2]
    v = quant_s8(x, QSCALE_PAD) if inject else x
    o = F.pad(v, (0, 0, 1, wp - w0 - 1))
    if inject:
        o[:, :, 0] = v[:, :, 1]
        o[:, :, w0 + 2] = v[:, :, w0 - 2]
        return o.to(torch.int8)
    return o


def pad_source_piece(i: int, w0: int, cpp: int, inject: bool) -> int | None:
    """The input piece (8 channels; cpp a pixel) that piece i of an output
    row of K13 reads, as ``pad_src`` computes it, or None (zero): i − cpp
    for cpp ≤ i < (W0 + 1)·cpp; with ``inject`` also i + cpp for i < cpp
    (column 0 ← column 1) and i − 4·cpp for (W0 + 2)·cpp ≤ i < (W0 + 3)·cpp
    (column W0 + 2 ← column W0 − 2)."""
    if inject and i < cpp:
        return i + cpp
    if 0 <= i - cpp < w0 * cpp:
        return i - cpp
    if inject and 0 <= i - (w0 + 2) * cpp < cpp:
        return i - 4 * cpp
    return None


def pad_grid(rows: int, wp: int, c: int, inject: bool, sms: int = 132) -> tuple:
    """K13's launch on [rows, WP, C] out: (grid x, grid y, pieces a unit,
    units a thread). A unit is one 16-byte piece of bf16 (P1), or the 8-byte
    codes of 2 pieces (P2, where WP·C/8 is even; else 1); a block takes
    PAD_THREADS × U units of one row, U = PAD_UNITS where that still gives
    two blocks an SM, else 1."""
    nout = wp * c // 8
    pc = 2 if inject and nout % 2 == 0 else 1
    gy = min(rows, 65535)
    u = PAD_UNITS if -(-(nout // pc) // (PAD_THREADS * PAD_UNITS)) * gy >= 2 * sms else 1
    return -(-(nout // pc) // (PAD_THREADS * u)), gy, pc, u


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


@functools.cache
def _lib():
    from ._build import load_library

    lib = load_library(_SOURCE)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dot = [P] * 3 + [I] * 6 + [P, I, I, Fl, Fl, I, I, I, P]
    sigs = {"shift_dot_launch": dot, "shift_dot_prev_launch": dot,
            "shift_dot_smem_bytes": [P, I, I],
            "pad_inject_launch": [P, P] + [I] * 6 + [Fl, P],
            "pad_inject_prev_launch": [P, P] + [I] * 6 + [Fl, P]}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(kernel, name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} must start on a 16-byte boundary")


def _run(kernel, fn, *args, count=True):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    if count:
        LAUNCHES[kernel] += 1


def _launch_dot(a3, wt, offsets, m, strip, zlim, pro, out, oscale, prev=False):
    """Check a3 [G, MA, K] and wt against a built form and launch K12 (on
    its previous core with ``prev``, counting no launch)."""
    k = "shift_dot"
    dev = a3.device
    if dev.type != "cuda":
        raise NotImplementedError(f"{k}: no kernel for device {dev}")
    _check_form(k, a3, pro, out)
    g, ma, kk = a3.shape
    r = len(offsets)
    if not 1 <= r <= MAX_TAPS or min(offsets) < 0:
        raise ValueError(f"{k}: {r} taps at offsets {offsets}: 1 to {MAX_TAPS}, none negative")
    n = wt.shape[1]
    if kk % K_CHUNK or n % N_TILE or kk > 4 * K_CHUNK:
        raise ValueError(f"{k}: K={kk}, N={n}: the kernel takes K in 128..512 and N in "
                         f"multiples of 128")
    mma_bf16 = _mma_bf16(a3, pro)
    wdt = torch.bfloat16 if mma_bf16 else torch.int8
    _check(k, "a", a3, a3.dtype, a3.shape, dev)
    _check(k, "wt", wt, wdt, (r, n, kk), dev)
    if strip == 0 and m + max(offsets) > ma:
        raise ValueError(f"{k}: {m} rows at offset {max(offsets)} read past A's {ma} rows")
    offs = (ctypes.c_int * r)(*offsets)
    lib = _lib()
    smem = lib.shift_dot_smem_bytes(offs, r, int(pro != "none"))
    if not prev and not 0 < smem <= SMEM_MAX:
        raise ValueError(f"{k}: offsets {offsets} need {smem} bytes of shared "
                         f"memory a block (at most {SMEM_MAX})")
    dt = {"s32": torch.int32, "f32": torch.float32, "bf16": torch.bfloat16}[out]
    res = torch.empty((g, m, n), dtype=dt, device=dev)
    fn = lib.shift_dot_prev_launch if prev else lib.shift_dot_launch
    with torch.cuda.device(dev):
        _run(k, fn, a3.data_ptr(), wt.data_ptr(), res.data_ptr(), g, m, ma, kk, n, r, offs,
             strip, zlim, QSCALE_DOT, float(oscale), int(a3.dtype == torch.bfloat16),
             PROLOGUES[pro], EPILOGUES[out], torch.cuda.current_stream(dev).cuda_stream,
             count=not prev)
    return res


def flat_dot(a, wt, offsets, rows=None, *, pro="none", out="bf16", oscale=1.0):
    """K12, flat form: out[g, m] = epi(Σ_r pro(a)[g, m + offsets[r]] · wt[r]ᵀ)
    for m < ``rows`` (default MA − max(offsets)); a [G, MA, K] or [MA, K] s8
    or bf16, wt [R, N, K] (``pack_taps``) s8, or bf16 for bf16 operands with
    no prologue."""
    if a.device.type == "cpu":
        return flat_dot_plain(a, wt, offsets, rows, pro=pro, out=out, oscale=oscale)
    return _flat(a, wt, offsets, rows, pro, out, oscale, False)


def flat_dot_prev(a, wt, offsets, rows=None, *, pro="none", out="bf16", oscale=1.0):
    """``flat_dot`` on K12's previous core, CUDA tensors only (timing)."""
    return _flat(a, wt, offsets, rows, pro, out, oscale, True)


def _flat(a, wt, offsets, rows, pro, out, oscale, prev):
    flat = a.dim() == 2
    a3 = a[None] if flat else a
    m = a3.shape[1] - max(offsets) if rows is None else rows
    res = _launch_dot(a3, wt, list(offsets), m, 0, 0, pro, out, oscale, prev)
    return res[0] if flat else res


def strip_dot(x, wt, *, pro="none", out="bf16", oscale=1.0):
    """K12, strip form: x [B, H+2, W, C] → [B, H, W, N], strips of
    ``STRIP_TS`` output rows (H % STRIP_TS == 0), wt [9, N, C]."""
    if x.device.type == "cpu":
        return strip_dot_plain(x, wt, pro=pro, out=out, oscale=oscale)
    return _strip(x, wt, pro, out, oscale, False)


def strip_dot_prev(x, wt, *, pro="none", out="bf16", oscale=1.0):
    """``strip_dot`` on K12's previous core, CUDA tensors only (timing)."""
    return _strip(x, wt, pro, out, oscale, True)


def _strip(x, wt, pro, out, oscale, prev):
    b, h2, w, c = x.shape
    h, ts = h2 - 2, STRIP_TS
    if h < ts or h % ts:
        raise ValueError(f"shift_dot: H={h} is not a multiple of TS={ts}")
    res = _launch_dot(x.view(b, h2 * w, c), wt, strip_offsets(w), h * w, ts * w, (ts + 2) * w,
                      pro, out, oscale, prev)
    return res.view(b, h, w, -1)


def pad_inject(x, wp, *, inject=False):
    """K13: mk28's column pad of x [B, R, W0, C] bf16 to width ``wp`` (bf16),
    or with ``inject`` its s8 codes with the two injected halo columns. On
    the card: ``pad_inject_v2_kernel`` (x 16-byte aligned)."""
    if x.device.type == "cpu":
        return pad_inject_plain(x, wp, inject=inject)
    return _pad_inject(x, wp, inject, prev=False)


def pad_inject_prev(x, wp, *, inject=False):
    """K13 on its previous core (``pad_inject_kernel``), CUDA tensors only:
    mk28 times it beside ``pad_inject``. Nothing on the main path calls it,
    and it counts no launch."""
    return _pad_inject(x, wp, inject, prev=True)


def _pad_inject(x, wp, inject, prev):
    k = "pad_inject"
    dev = x.device
    if dev.type != "cuda":
        raise NotImplementedError(f"{k}: no kernel for device {dev}")
    b, r, w0, c = x.shape
    if w0 < 3 or wp < w0 + (3 if inject else 1) or c % 8:
        raise ValueError(f"{k}: W0={w0}, WP={wp}, C={c}: needs W0 >= 3, WP > W0 "
                         f"(+2 to inject) and C % 8 == 0")
    _check(k, "x", x, torch.bfloat16, x.shape, dev)
    res = torch.empty((b, r, wp, c), dtype=torch.int8 if inject else torch.bfloat16, device=dev)
    fn = _lib().pad_inject_prev_launch if prev else _lib().pad_inject_launch
    with torch.cuda.device(dev):
        _run(k, fn, x.data_ptr(), res.data_ptr(), b, r, w0, wp, c, int(inject), QSCALE_PAD,
             torch.cuda.current_stream(dev).cuda_stream, count=not prev)
    return res
