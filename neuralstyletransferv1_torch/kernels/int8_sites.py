"""K2–K5: the int8 3×3 site convs of the quantized Johnson path
(``csrc/int8_sites.cu``).

Each replaces one Pallas kernel of ``neuralstyletransferv1_tpu/models/
s2d2_sites_i8.py``. All four are one operation — a 3×3 conv of int8 codes
with int32 accumulation, over a 1-pixel halo (``"reflect"`` for the residual
sites, ``"edge"`` for the decoder sites) — between different prologues and
epilogues:

  K2 ``res_site_s8o``  quantize bf16 x → conv → bf16 → emit s8 codes ≥ 0
                       (``res_site_s8o`` / ``_site_kernel_s8o``)
  K3 ``site_s8``       s8 codes → conv → bf16 → frozen affine → + y → bf16
                       (``site_s8`` / ``_site_kernel_s8g``, AFF + YADD)
  K4 ``res_site``      quantize bf16 x → conv → bf16 raw + [Σ, Σ²]
                       (``res_site`` / ``_site_kernel``)
  K5 ``res_site_skip`` v = bf16(bf16(r2·a2 + c2) + y), quantize v → conv →
                       bf16 raw + [Σ, Σ²], and v itself
                       (``res_site_skip`` / ``_site_kernel_skip``)

Rounding contract, every step a separate IEEE f32 operation:
quantize q = clamp(round_half_even(x·a + c), lo, 127); dequant
f = acc·ws + bias, rounded to bf16; the statistics sum the bf16-rounded
values. Shapes: x [B,H,W,C] bf16, a/c/a2/c2 [B,C] f32, ws/bias/qa/qc [CO]
f32, weights packed by ``pack_weights``. Each wrapper dispatches on the
tensors' device: CPU → the ``*_plain`` version, CUDA → the kernel or an
error; no fallback between the two. ``LAUNCHES[name]`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..ops.conv import conv2d_i8

_SOURCE = "int8_sites.cu"
LAUNCHES = {"res_site_s8o": 0, "site_s8": 0, "res_site": 0, "res_site_skip": 0}
HALOS = {"reflect": 0, "edge": 1}
KERNEL_C = (64, 128)  # input channel counts the CUDA kernels are built for
CO_TILE = 64          # output channels per thread block


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """int8 site weights [3,3,C,CO] (HWIO) → int32 words [9, C/4, CO]; word
    (t, k, o) packs channels 4k..4k+3 of tap t for output o, little-endian
    (the operand layout of ``__dp4a``)."""
    kh, kw, c, co = w.shape
    assert w.dtype == torch.int8 and kh * kw == 9 and c % 4 == 0, (w.shape, w.dtype)
    words = w.reshape(9, c // 4, 4, co).permute(0, 1, 3, 2).contiguous()
    return words.view(torch.int32).reshape(9, c // 4, co)


def unpack_weights(wk: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_weights``: [9, C/4, CO] int32 → [3,3,C,CO] int8."""
    _, cw, co = wk.shape
    b = wk.contiguous().view(torch.int8).reshape(9, cw, co, 4).permute(0, 1, 3, 2)
    return b.reshape(3, 3, 4 * cw, co)


# ---------------------------------------------------------------------------
# plain versions (PyTorch ops; the CPU path and the card's yardstick)
# ---------------------------------------------------------------------------


def _rows(v: torch.Tensor) -> torch.Tensor:
    """[B,C] per-(image, channel) row → broadcastable over [B,H,W,C]."""
    return v[:, None, None, :]


def _quantize(x32: torch.Tensor, a: torch.Tensor, c: torch.Tensor, lo: float) -> torch.Tensor:
    """q = clamp(round(x·a + c), lo, 127), half to even, as f32 codes."""
    return torch.clamp(torch.round(x32 * _rows(a) + _rows(c)), lo, 127.0)


def _halo(q: torch.Tensor, halo: str) -> torch.Tensor:
    """1-pixel halo around NHWC codes (float64, exact): pixel reflect or edge
    copy. Quantize is pointwise, so haloing the codes equals quantizing the
    haloed input."""
    mode = {"reflect": "reflect", "edge": "replicate"}[halo]
    return F.pad(q.double().permute(0, 3, 1, 2), (1, 1, 1, 1), mode=mode).permute(0, 2, 3, 1)


def _conv_dequant(q: torch.Tensor, wk: torch.Tensor, ws: torch.Tensor, bias: torch.Tensor,
                  halo: str) -> torch.Tensor:
    """bf16(acc·ws + bias) of the 3×3 int8 conv of codes q [B,H,W,C]."""
    acc = conv2d_i8(_halo(q, halo), unpack_weights(wk).to(q.device))
    return (acc.float() * ws + bias).to(torch.bfloat16)


def _sums(fv: torch.Tensor) -> torch.Tensor:
    """[B,2,CO] f32 [Σ, Σ²] over H, W of the bf16-rounded values."""
    f = fv.double()
    return torch.stack([f.sum(dim=(1, 2)), f.square().sum(dim=(1, 2))], dim=1).float()


def res_site_s8o_plain(x, a, c, lo, wk, ws, bias, qa, qc, *, halo="reflect"):
    """K2's plain version → s8 codes [B,H,W,CO]."""
    fv = _conv_dequant(_quantize(x.float(), a, c, lo), wk, ws, bias, halo)
    return torch.clamp(torch.round(fv.float() * qa + qc), 0.0, 127.0).to(torch.int8)


def site_s8_plain(xq, wk, ws, bias, aa, ac, y, *, halo="reflect"):
    """K3's plain version → bf16 [B,H,W,CO]."""
    fv = _conv_dequant(xq, wk, ws, bias, halo)
    fv = (fv.float() * aa + ac).to(torch.bfloat16)
    return (fv.float() + y.float()).to(torch.bfloat16)


def res_site_plain(x, a, c, lo, wk, ws, bias, *, halo="reflect"):
    """K4's plain version → (bf16 raw [B,H,W,CO], f32 [B,2,CO] sums)."""
    fv = _conv_dequant(_quantize(x.float(), a, c, lo), wk, ws, bias, halo)
    return fv, _sums(fv)


def _combine(r2, yp, a2, c2):
    t = (r2.float() * _rows(a2) + _rows(c2)).to(torch.bfloat16)
    return (t.float() + yp.float()).to(torch.bfloat16)


def res_site_skip_plain(r2, yp, a, c, a2, c2, lo, wk, ws, bias, *, halo="reflect",
                        yout=True):
    """K5's plain version → (bf16 raw, f32 sums, v or None)."""
    v = _combine(r2, yp, a2, c2)
    fv = _conv_dequant(_quantize(v.float(), a, c, lo), wk, ws, bias, halo)
    return fv, _sums(fv), (v if yout else None)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


@functools.cache
def _lib():
    from ._build import load_library

    lib = load_library(_SOURCE)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [I] * 5  # B, H, W, C, CO
    sigs = {
        "res_site_s8o_launch": [P] * 9 + dims + [Fl, I, P],
        "site_s8_launch": [P] * 8 + dims + [I, P],
        "res_site_launch": [P] * 9 + dims + [Fl, I, P],
        "res_site_skip_launch": [P] * 13 + dims + [Fl, I, P],
    }
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


def _check_site(kernel, x, wk, ws, bias, halo):
    """Validate the shared operands; returns (dev, B, H, W, C, CO)."""
    dev = x.device
    if dev.type != "cuda":
        raise NotImplementedError(f"{kernel}: no kernel for device {dev}")
    B, H, W, C = x.shape
    if C not in KERNEL_C:
        raise ValueError(f"{kernel}: C={C}, the kernel is built for C in {KERNEL_C}")
    if wk.dim() != 3 or wk.shape[0] != 9 or wk.shape[1] * 4 != C:
        raise ValueError(f"{kernel}: weights {tuple(wk.shape)} do not match C={C}")
    CO = wk.shape[2]
    if CO % CO_TILE:
        raise ValueError(f"{kernel}: CO={CO} is not a multiple of {CO_TILE}")
    if H < 2 or W < 2:
        raise ValueError(f"{kernel}: H={H}, W={W}: the halo needs at least 2 pixels")
    if halo not in HALOS:
        raise ValueError(f"{kernel}: halo {halo!r} not in {tuple(HALOS)}")
    _check(kernel, "weights", wk, torch.int32, (9, C // 4, CO), dev)
    _check(kernel, "ws", ws, torch.float32, (CO,), dev)
    _check(kernel, "bias", bias, torch.float32, (CO,), dev)
    return dev, B, H, W, C, CO


def _run(kernel, fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    LAUNCHES[kernel] += 1


def res_site_s8o(x, a, c, lo, wk, ws, bias, qa, qc, *, halo="reflect"):
    """K2: quantize x (a, c, lo) → 3×3 int8 conv → bf16(acc·ws + bias) →
    s8 codes clamp(round(f·qa + qc), 0, 127) [B,H,W,CO]: the next site's
    input, its norm and ReLU folded into qa, qc and the floor."""
    if x.device.type == "cpu":
        return res_site_s8o_plain(x, a, c, lo, wk, ws, bias, qa, qc, halo=halo)
    k = "res_site_s8o"
    dev, B, H, W, C, CO = _check_site(k, x, wk, ws, bias, halo)
    _check(k, "x", x, torch.bfloat16, (B, H, W, C), dev)
    for name, t in (("a", a), ("c", c)):
        _check(k, name, t, torch.float32, (B, C), dev)
    for name, t in (("qa", qa), ("qc", qc)):
        _check(k, name, t, torch.float32, (CO,), dev)
    out = torch.empty((B, H, W, CO), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _run(k, _lib().res_site_s8o_launch, x.data_ptr(), a.data_ptr(), c.data_ptr(),
             wk.data_ptr(), ws.data_ptr(), bias.data_ptr(), qa.data_ptr(), qc.data_ptr(),
             out.data_ptr(), B, H, W, C, CO, float(lo), HALOS[halo], stream)
    return out


def site_s8(xq, wk, ws, bias, aa, ac, y, *, halo="reflect"):
    """K3: 3×3 int8 conv of s8 codes → bf16(acc·ws + bias) → bf16(f·aa + ac)
    → bf16(f + y) [B,H,W,CO] (CO == C)."""
    if xq.device.type == "cpu":
        return site_s8_plain(xq, wk, ws, bias, aa, ac, y, halo=halo)
    k = "site_s8"
    dev, B, H, W, C, CO = _check_site(k, xq, wk, ws, bias, halo)
    _check(k, "xq", xq, torch.int8, (B, H, W, C), dev)
    for name, t in (("aa", aa), ("ac", ac)):
        _check(k, name, t, torch.float32, (CO,), dev)
    _check(k, "y", y, torch.bfloat16, (B, H, W, CO), dev)
    out = torch.empty((B, H, W, CO), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _run(k, _lib().site_s8_launch, xq.data_ptr(), wk.data_ptr(), ws.data_ptr(),
             bias.data_ptr(), aa.data_ptr(), ac.data_ptr(), y.data_ptr(), out.data_ptr(),
             B, H, W, C, CO, HALOS[halo], stream)
    return out


def _stats_buffers(B, H, W, CO, dev):
    from math import ceil

    tiles = ceil(H / 8) * ceil(W / 16)  # the kernel's 8×16-pixel output tiles
    part = torch.empty((B, tiles, 2, CO), dtype=torch.float32, device=dev)
    return part, torch.empty((B, 2, CO), dtype=torch.float32, device=dev)


def res_site(x, a, c, lo, wk, ws, bias, *, halo="reflect"):
    """K4: quantize x → 3×3 int8 conv → bf16 raw [B,H,W,CO] and the f32
    [Σ, Σ²] [B,2,CO] of the bf16-rounded raw."""
    if x.device.type == "cpu":
        return res_site_plain(x, a, c, lo, wk, ws, bias, halo=halo)
    k = "res_site"
    dev, B, H, W, C, CO = _check_site(k, x, wk, ws, bias, halo)
    _check(k, "x", x, torch.bfloat16, (B, H, W, C), dev)
    for name, t in (("a", a), ("c", c)):
        _check(k, name, t, torch.float32, (B, C), dev)
    out = torch.empty((B, H, W, CO), dtype=torch.bfloat16, device=dev)
    part, sums = _stats_buffers(B, H, W, CO, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _run(k, _lib().res_site_launch, x.data_ptr(), a.data_ptr(), c.data_ptr(),
             wk.data_ptr(), ws.data_ptr(), bias.data_ptr(), out.data_ptr(), part.data_ptr(),
             sums.data_ptr(), B, H, W, C, CO, float(lo), HALOS[halo], stream)
    return out, sums


def res_site_skip(r2, yp, a, c, a2, c2, lo, wk, ws, bias, *, halo="reflect", yout=True):
    """K5: v = bf16(bf16(r2·a2 + c2) + yp) in the prologue, then K4 on v.
    Returns (bf16 raw, f32 sums, v) — v is None when ``yout`` is False."""
    if r2.device.type == "cpu":
        return res_site_skip_plain(r2, yp, a, c, a2, c2, lo, wk, ws, bias, halo=halo,
                                   yout=yout)
    k = "res_site_skip"
    dev, B, H, W, C, CO = _check_site(k, r2, wk, ws, bias, halo)
    for name, t in (("r2", r2), ("yp", yp)):
        _check(k, name, t, torch.bfloat16, (B, H, W, C), dev)
    for name, t in (("a", a), ("c", c), ("a2", a2), ("c2", c2)):
        _check(k, name, t, torch.float32, (B, C), dev)
    out = torch.empty((B, H, W, CO), dtype=torch.bfloat16, device=dev)
    v = torch.empty((B, H, W, C), dtype=torch.bfloat16, device=dev) if yout else None
    part, sums = _stats_buffers(B, H, W, CO, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _run(k, _lib().res_site_skip_launch, r2.data_ptr(), yp.data_ptr(), a.data_ptr(),
             c.data_ptr(), a2.data_ptr(), c2.data_ptr(), wk.data_ptr(), ws.data_ptr(),
             bias.data_ptr(), out.data_ptr(), None if v is None else v.data_ptr(),
             part.data_ptr(), sums.data_ptr(),
             B, H, W, C, CO, float(lo), HALOS[halo], stream)
    return out, sums, v
