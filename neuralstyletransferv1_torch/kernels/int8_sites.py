"""K2–K8b: the int8 site convs of the quantized Johnson, NST_Train and ReCoNet
paths (``csrc/int8_sites.cu``).

Each replaces one Pallas kernel of ``neuralstyletransferv1_tpu/models/
s2d2_sites_i8.py``. K2–K5 and K8 are one operation — a 3×3 conv of int8
codes with int32 accumulation, over a 1-pixel halo (``"reflect"`` for the
residual and head sites, ``"edge"`` for the decoder sites) — between
different prologues and epilogues. K2–K5 also take the zero halo of the
NST and Torch7 nets' zero-padded convs (``halo="zero"``: code 0 at every
position outside the image, whatever the quantize affine, as
``_quant_zero`` writes it; K2, K4 and K5 at C = 64 and 128, without a
floor);
K2–K5 with ``sw``: the content width of a grid padded up to an aligned
width, beyond which K2 zeroes its input codes and its output codes, K4 and
K5 their input codes (K5 still returns v there) and leave those columns out
of their sums, and K3 zeroes its output codes (``_quant_zero`` and the SW
masks of the TPU kernels), so no padding column enters a dot. Under the
zero halo K4 and K3 also take the Pallas sites' 2×2 tap geometries
(``kh = kw = 2``; output (r, c) sums taps (dy, dx) at (r + dy − pt,
c + dx − pl)): K4 with ``pt = pl = 1``, conv2 of the NST and Torch7 nets as
a block conv on its input's space-to-depth grid, and K4 and K3 with
``pt = pl = 0``, a k3 stride-2 transposed conv scattered to its four output
phases (their deconvs); each is its own kernel instance, counted in
``FORM_LAUNCHES`` under ``GEO_FORMS``' name. K3's ``halo_out="zero2"`` names the deconv3 tail's
input, which here is K3's s8 emit as it is: the port's carries hold no
halo columns, K6 pads its own:

  K2  ``res_site_s8o``  quantize bf16 x → conv → bf16 → emit s8 codes ≥ 0
                        (``res_site_s8o`` / ``_site_kernel_s8o``)
  K3  ``site_s8``       s8 codes → conv → bf16 → [frozen affine] → [+ y, y
                        optionally activated first] → bf16 or s8 codes
                        (``site_s8`` / ``_site_kernel_s8g``: AFF, YADD, YAFF,
                        S8OUT)
  K4  ``res_site``      quantize bf16 x → conv → bf16 raw + [Σ, Σ²]
                        (``res_site`` / ``_site_kernel``); the int8 probes'
                        forms (``experiments/mk31_i8_variants.py`` v1, v2,
                        ``mk28_probe.py`` P5): ``prologue="cast"`` (XLA's
                        saturating bf16 → s8 convert, no affine) and
                        ``stats=False`` (raw out, zero sums)
  K5  ``res_site_skip`` v = bf16(bf16(r2·a2 + c2) + y), quantize v → conv →
                        bf16 raw + [Σ, Σ²], and v itself
                        (``res_site_skip`` / ``_site_kernel_skip``)
  K8a ``c2_site``       K4 at stride 2, C = 32 → 64: conv2 (``c2p_site`` /
                        ``_c2p_kernel``)
  K8b ``c3_site``       K4 at stride 2, C = 64 → 128: conv3 (``c3p_site`` /
                        ``_c3p_kernel``)

ReCoNet's forms, at its res width C = 192 (and 96 at its deconv2): K4 at
C = 192 → 192 (reflect) and → 384 (edge), and 96 → 192 (edge), with an
optional ``tau`` floor, a (B, C) row applied to x·a + c before the round
(FRN's TLU folded into the quantize); K5 at C = 192 with ``act`` = "relu" or
"tau", the post-add activation max(v, 0) or max(v, bf16(tau_act)) applied to
v before it is written and quantized; K2 at C = 192, also with the emit
floor ``qlo`` and a (CO,) pre-round ``tau`` floor on bf16(f)·qa + qc; K3 at
C = 192. ReCoNet's static-norm decoder (``dec_s8``) adds two forms under
the edge halo, counted in ``FORM_LAUNCHES`` under ``RECO_DEC_FORMS``' names:
K2 at C = 192 → CO = 384 (d1 emitting d2's codes, its rows tiled over the
four phases; either emit) and K3 at C = 96 → CO = 192 (d2's bare bf16 raw:
no affine, residual or emit). A channel count or form a kernel is not built
for raises.

On the card K2–K5 run on the int8 tensor cores (``mma_kernel``: 8×16
output tiles, [Σ, Σ²] partials per such tile, ``TILE_MMA``); K4 and K3 at
ReCoNet's widths (``WG_C``) with bf16 operands on their Hopper core
(``csrc/int8_wgmma.cu``: the same tiles and partials, all output channels
of a tile in one block, ``wgmma`` on weights streamed by tap in the layout
``wgmma_weights`` makes, ``wgmma_smem_bytes`` its shared memory), K8a and K8b on
their stride-2 form (``mma_s2_kernel``, the same tiles; K8b one block on all
128 output channels), K6 on its own (``d3s8_mma_kernel``: warps walk
32-column strips down the image) and K7 on its sibling
(``d3rows_mma_kernel``: warps walk the (image, 32-column strip, row) items,
quantizing each one item ahead; ``d3_rows_schedule`` mirrors the walk,
``d3_rows_smem_bytes`` its shared memory). ``res_site_s8o_prev``,
``site_s8_prev``, ``res_site_prev``, ``res_site_skip_prev``,
``c2_site_prev``, ``c3_site_prev``, ``d3_s8_site_prev`` and
``d3_rows_site_prev`` launch K2–K8b on their previous cores (the ``__dp4a``
``site_kernel``, ``TILE_DP4A``, and ``rows_kernel``; for K4 and K3 at
``WG_C``, ``mma_kernel``), for timing the two designs side by side; nothing
on the main path calls them, they take CUDA tensors only, and they count no
launch.

The TPU's K8a/K8b run on a column-pair packing with phase-permutation dots;
that is layout only: the pair weights hold each pixel tap once, and the
phase halo is the pixel reflect at the top and left (a stride-2 3×3 conv
over an even size never reads the bottom or right pad). Here they are pixel
convs.

K6 and K7 are deconv3 in its tap-packed form: a 1×5 conv of the 128-channel
space-to-depth tensor (4 phases × 32) to 60 lanes (5 kernel rows × 12),
with zero column pads; the weights, ``ws`` and lanes are zero-padded to 64
(exact: the padded lanes are never read):

  K7  ``d3_rows_site``  quantize bf16 or f32 y (floor 0) → 1×5 conv → bf16(acc·ws)
                        rows [B,H,W,60] (``d3_rows_site`` / ``_d3_kernel``)
  K6  ``d3_s8_site``    s8 codes → the same rows, K[r] = bf16(acc·ws), then
                        out[r] = bf16(Σ_dy K[r+dy−2][12·dy + o] + bias), f32
                        in dy order, rows outside the image zero
                        (``d3_s8_site`` / ``_d3s8_kernel``)

The float32 chains hand an f32 tensor to the first sites of the res chain
(K2's and K4's x, K5's residual yp, K3's residual y), to conv2's site
(K8a's x: conv1's f32 output; K4's 2×2 pad-1 form on the NST and Torch7
nets), to deconv1's (K4's 2×2 pad-0 form, ReCoNet's K2 at CO = 384) and,
on the XLA-form decoder, to deconv3's rows site (K7's y: the d2 raw);
the Pallas bodies read it with ``astype(float32)``, so it enters the
arithmetic unrounded. Each wrapper takes that operand as bf16 or f32 and,
on the card, launches the matching form (``F32_FORMS``: the f32 forms are
their own instances of the tensor-core cores, counted in ``F32_LAUNCHES``); the plain versions compute both. K3's
2×2 form has no f32 form: its one f32 operand would be the residual, which
no 2×2 site adds.

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
from .int8_probes import saturate_s8

_SOURCE = "int8_sites.cu"
_SOURCE_WG = "int8_wgmma.cu"
LAUNCHES = {"res_site_s8o": 0, "site_s8": 0, "res_site": 0, "res_site_skip": 0,
            "c2_site": 0, "c3_site": 0, "d3_rows_site": 0, "d3_s8_site": 0}
#: the tap geometries (kh, kw, pt, pl) and the ``Geo`` index of each in
#: ``csrc/int8_sites.cu``
GEOS = {(3, 3, 1, 1): 0, (2, 2, 1, 1): 1, (2, 2, 0, 0): 2}
#: the 2×2 forms (wrapper, ``Geo`` index) built, under the zero halo at
#: ``KERNEL_C``, and the name each counts its launches under in
#: ``FORM_LAUNCHES`` (``LAUNCHES``' keys name the wrapper functions); a K4
#: or K5 launch with ``sw`` < W counts there as ``res_site_sw`` /
#: ``res_site_skip_sw``
GEO_FORMS = {("res_site", 1): "res_site_k2p1", ("res_site", 2): "res_site_k2p0",
             ("site_s8", 2): "site_s8_k2p0"}
#: ReCoNet's static-norm decoder forms (edge halo): wrapper → (C, CO, the
#: name each counts its launches under in ``FORM_LAUNCHES``); K2 at C = 192 is
#: otherwise built for CO = 192, and K3's C = 96 form takes no affine,
#: residual or emit
RECO_DEC_FORMS = {"res_site_s8o": (192, 384, "res_site_s8o_co384"),
                  "site_s8": (96, 192, "site_s8_c96")}
FORM_LAUNCHES = dict.fromkeys((*GEO_FORMS.values(), "res_site_sw", "res_site_skip_sw",
                               *(f[2] for f in RECO_DEC_FORMS.values())), 0)
_QUEUE2 = "ROADMAP.md Queue 2"
#: K4's forms of the int8 probes (``res_site(prologue=, stats=)``; C = 128,
#: reflect halo, no floor): the saturating cast (mk31's v1) and no
#: statistics (mk31's v2, mk28's mini site), each counted under its own name
#: in ``PROBE_LAUNCHES`` (``LAUNCHES``' keys name the wrapper functions)
K4_PROBE_FORMS = {("cast", True): "res_site_cast", ("quant", False): "res_site_nostats"}
PROBE_LAUNCHES = dict.fromkeys(K4_PROBE_FORMS.values(), 0)
#: the f32-operand forms, which the float32 chains' first sites run (K2's,
#: K4's and K8a's x, K5's yp, K3's y f32; each wrapper takes them by the
#: operand's dtype): (wrapper, form) → (the name each counts its launches
#: under in ``F32_LAUNCHES``, the input channel counts built under the
#: reflect or edge halo, and under the zero halo). Forms: "3x3" (K8a: its
#: stride-2 conv), "floor" (K2's floored emit, K5's ``act``), K4's 2×2
#: "k2p1" (conv2 of the NST and Torch7 nets) and "k2p0" (their deconv1, with
#: or without ``sw``), "co384" (ReCoNet's static-norm d1: K2 at C = 192 →
#: CO = 384, either emit), "rows" (K7: the 1×5 rows conv on the XLA-form
#: decoder's f32 d2 raw; its halo argument is None). K3's 2×2 form has none:
#: its one f32 operand would be the residual, which no chain adds to a 2×2
#: site
F32_FORMS = {("res_site_s8o", "3x3"): ("res_site_s8o_f32", (128, 192), (128,)),
             ("res_site_s8o", "floor"): ("res_site_s8o_f32", (192,), ()),
             ("res_site_s8o", "co384"): ("res_site_s8o_co384_f32", (192,), ()),
             ("site_s8", "3x3"): ("site_s8_f32", (128, 192), (128, 192)),
             ("res_site", "3x3"): ("res_site_f32", (128, 192), (64, 128)),
             ("res_site", "k2p1"): ("res_site_k2p1_f32", (), (128,)),
             ("res_site", "k2p0"): ("res_site_k2p0_f32", (), (128,)),
             ("res_site_skip", "3x3"): ("res_site_skip_f32", (128,), (64, 128)),
             ("res_site_skip", "floor"): ("res_site_skip_f32", (192,), ()),
             ("c2_site", "3x3"): ("c2_site_f32", (32,), ()),
             ("d3_rows_site", "rows"): ("d3_rows_site_f32", (128,), ())}
F32_LAUNCHES = dict.fromkeys((name for name, *_ in F32_FORMS.values()), 0)
HALOS = {"reflect": 0, "edge": 1, "zero": 2}
#: the halos of K8 and of K4's and K5's floored forms (``tau``, ``act``)
HALOS_RE = ("reflect", "edge")
KERNEL_C = (64, 128)  # input channel counts of the Johnson / NST 3×3 kernels
RECO_C = 192          # ReCoNet's res width: K2's floored emit, K5's activation
#: the input channel counts K4, K3 and K2 are built for (K4's tau floor only
#: at 96 and 192; K5 at KERNEL_C, with ``act`` at RECO_C)
SITE_C = {"res_site": (64, 96, 128, 192), "site_s8": (64, 128, 192),
          "res_site_s8o": (64, 128, 192)}
TAU_C = (96, 192)
#: the input channel counts at which K4 and K3 with bf16 operands (ReCoNet's
#: widths) run on the wgmma core (``csrc/int8_wgmma.cu``), in passes of
#: WG_NP output channels over weight units of WG_KU input channels
WG_C, WG_NP, WG_KU = (96, 192), 192, 96
HEAD_C = (32, 64)     # and of the stride-2 head kernels (K8a, K8b)
CO_TILE = 64          # output channels per thread block of the __dp4a core
#: output tile (rows, columns) of each core: the [Σ, Σ²] partials are per tile
TILE_DP4A = (8, 16)   # site_kernel: the _prev forms
TILE_MMA = (8, 16)    # mma_kernel, mma_s2_kernel (int8 tensor cores): K2-K5, K8a, K8b
D3_C, D3_LANES, D3_OUT = 128, 60, 12  # deconv3's tap-packed rows conv
D3_STRIP, D3_WARPS = 32, 8            # K6's and K7's strips, warps a block
D3_WARPS_F32 = 6                      # K7's f32 form's warps a block
_S8_FLAGS = {"aff": 1, "yadd": 2, "yaff": 4, "s8out": 8}  # K3 epilogue steps


def pack_weights(w: torch.Tensor, co_pad: int | None = None) -> torch.Tensor:
    """int8 site weights [KH,KW,C,CO] (HWIO) → int32 words [KH·KW, C/4, CO];
    word (t, k, o) packs channels 4k..4k+3 of tap t for output o,
    little-endian (the operand layout of ``__dp4a``). ``co_pad`` zero-pads
    the output channels to that count (deconv3's 60 lanes → 64)."""
    kh, kw, c, co = w.shape
    assert w.dtype == torch.int8 and c % 4 == 0, (w.shape, w.dtype)
    if co_pad is not None and co_pad > co:
        w = F.pad(w, (0, co_pad - co))
        co = co_pad
    words = w.reshape(kh * kw, c // 4, 4, co).permute(0, 1, 3, 2).contiguous()
    return words.view(torch.int32).reshape(kh * kw, c // 4, co)


def wgmma_weights(wk: torch.Tensor) -> torch.Tensor:
    """``pack_weights``' 3×3 words [9, C/4, CO] → the wgmma core's weight
    units int8 [CO/192, 9, C/96, 6, 192, 16]: unit (pass, tap, k) is input
    channels 96k.. of the tap for output channels 192·pass.., K-major in
    core-matrix columns: byte i of row n of column j is the weight of input
    channel 96k + 16j + i for output channel 192·pass + n."""
    taps, cw, co = wk.shape
    c = 4 * cw
    w = wk.contiguous().view(torch.int8).reshape(taps, cw, co, 4).permute(0, 1, 3, 2)
    w = w.reshape(taps, c // WG_KU, WG_KU // 16, 16, co // WG_NP, WG_NP)
    return w.permute(4, 0, 1, 2, 5, 3).contiguous()


def wgmma_smem_bytes(C: int) -> int:
    """The wgmma core's dynamic shared memory at C input channels
    (``WgSmem``): the weight ring (4 slots of a 96 × 192-byte unit), two
    code buffers of the 10 × 18 haloed tile at C + 16 bytes a pixel, the 128
    staged output pixels of 2 × 192 + 16 bytes, 8 epilogue rows of 384 f32,
    [Σ, Σ²] of 192 channels for the 8 row warps (C = 192) or the 10 storing
    pixel groups (C = 96), 256 bytes of mbarriers."""
    groups = 8 if C == 192 else 10
    return (4 * WG_KU * WG_NP + 2 * 180 * (C + 16) + 128 * (2 * WG_NP + 16)
            + 8 * 2 * WG_NP * 4 + groups * 2 * WG_NP * 4 + 256)


def unpack_weights(wk: torch.Tensor, kh: int = 3, kw: int = 3) -> torch.Tensor:
    """Inverse of ``pack_weights``: [KH·KW, C/4, CO] int32 → [KH,KW,C,CO] int8."""
    taps, cw, co = wk.shape
    b = wk.contiguous().view(torch.int8).reshape(taps, cw, co, 4).permute(0, 1, 3, 2)
    return b.reshape(kh, kw, 4 * cw, co)


# ---------------------------------------------------------------------------
# plain versions (PyTorch ops; the CPU path and the card's yardstick)
# ---------------------------------------------------------------------------


def _rows(v: torch.Tensor) -> torch.Tensor:
    """[B,C] per-(image, channel) row → broadcastable over [B,H,W,C]."""
    return v[:, None, None, :]


def _quantize(x32: torch.Tensor, a: torch.Tensor, c: torch.Tensor, lo: float,
              tau: torch.Tensor | None = None) -> torch.Tensor:
    """q = clamp(round(x·a + c), lo, 127), half to even, as f32 codes; with
    the (B, C) floor ``tau``, clamp(round(max(x·a + c, tau)), lo, 127)."""
    v = x32 * _rows(a) + _rows(c)
    if tau is not None:
        v = torch.maximum(v, _rows(tau))
    return torch.clamp(torch.round(v), lo, 127.0)


def _emit(f: torch.Tensor, qa: torch.Tensor, qc: torch.Tensor, qlo: float,
          tau: torch.Tensor | None = None) -> torch.Tensor:
    """s8 codes clamp(round(f·qa + qc), qlo, 127) of bf16 values f; with the
    (CO,) floor ``tau``, clamp(round(max(f·qa + qc, tau)), qlo, 127)."""
    v = f.float() * qa + qc
    if tau is not None:
        v = torch.maximum(v, tau)
    return torch.clamp(torch.round(v), qlo, 127.0).to(torch.int8)


def _halo(q: torch.Tensor, halo: str, pads=(1, 1, 1, 1)) -> torch.Tensor:
    """Halo of ``pads`` = (top, bottom, left, right) pixels around NHWC codes
    (float64, exact): pixel reflect, edge copy or zero codes. Quantize is
    pointwise, so haloing the codes equals quantizing the haloed input."""
    mode = {"reflect": "reflect", "edge": "replicate", "zero": "constant"}[halo]
    t, b, l, r = pads
    return F.pad(q.double().permute(0, 3, 1, 2), (l, r, t, b), mode=mode).permute(0, 2, 3, 1)


def _conv_dequant(q: torch.Tensor, wk: torch.Tensor, ws: torch.Tensor, bias: torch.Tensor,
                  halo: str, stride: int = 1, geo=(3, 3, 1, 1)) -> torch.Tensor:
    """bf16(acc·ws + bias) of the int8 conv of codes q [B,H,W,C] with the
    taps ``geo`` = (kh, kw, pt, pl): output (r, c) sums taps (dy, dx) at
    (r + dy − pt, c + dx − pl)."""
    kh, kw, pt, pl = geo
    acc = conv2d_i8(_halo(q, halo, (pt, kh - 1 - pt, pl, kw - 1 - pl)),
                    unpack_weights(wk, kh, kw).to(q.device), stride=stride)
    return (acc.float() * ws + bias).to(torch.bfloat16)


def _sums(fv: torch.Tensor, sw: int | None = None) -> torch.Tensor:
    """[B,2,CO] f32 [Σ, Σ²] over H, W (the columns < ``sw``) of the
    bf16-rounded values."""
    f = fv.double() if sw is None else fv[:, :, :sw].double()
    return torch.stack([f.sum(dim=(1, 2)), f.square().sum(dim=(1, 2))], dim=1).float()


def _check_sw(kernel, halo, sw, w):
    if sw is not None and (halo != "zero" or not 0 < sw <= w):
        raise ValueError(f"{kernel}: sw={sw} needs the zero halo and 0 < sw <= W={w}")


def _geo(kernel: str, halo: str, kh: int, kw: int, pt: int, pl: int) -> int:
    """The ``Geo`` index of ``kernel``'s taps; a geometry it is not built
    for raises, on every device: the 3×3 taps at pad 1, and the 2×2 forms of
    ``GEO_FORMS`` under the zero halo."""
    g = GEOS.get((kh, kw, pt, pl))
    if g == 0 or (g is not None and (kernel, g) in GEO_FORMS and halo == "zero"):
        return g
    raise NotImplementedError(f"{kernel}: no form with {kh}x{kw} taps at pads ({pt}, {pl}) "
                              f"and the {halo} halo: {_QUEUE2}")


def _sw_form(kernel: str, sw, w: int) -> str | None:
    """``FORM_LAUNCHES``' key of K4's or K5's masked form, where ``sw``
    masks."""
    return f"{kernel}_sw" if sw is not None and sw < w else None


def _check_halo_out(halo, halo_out, qa):
    """K3's emitted layout: as the input's, or ``"zero2"`` (the deconv3
    tail's input: the s8 emit under the zero halo)."""
    if halo_out is not None and (halo_out != "zero2" or halo != "zero" or qa is None):
        raise ValueError(f"site_s8: halo_out={halo_out!r} needs 'zero2', the zero halo and "
                         "the s8 emit")


def _mask_sw(q: torch.Tensor, sw: int | None) -> torch.Tensor:
    """Zero the codes of the columns >= sw (none when sw is None)."""
    if sw is None or sw >= q.shape[2]:
        return q
    q = q.clone()
    q[:, :, sw:] = 0
    return q


def res_site_s8o_plain(x, a, c, lo, wk, ws, bias, qa, qc, *, qlo=0.0, tau=None,
                       halo="reflect", sw=None):
    """K2's plain version → s8 codes [B,H,W,CO]."""
    _check_sw("res_site_s8o", halo, sw, x.shape[2])
    fv = _conv_dequant(_mask_sw(_quantize(x.float(), a, c, lo), sw), wk, ws, bias, halo)
    return _mask_sw(_emit(fv, qa, qc, qlo, tau), sw)


def site_s8_plain(xq, wk, ws, bias, aa=None, ac=None, y=None, *, yaff=None, qa=None, qc=None,
                  qlo=0.0, halo="reflect", sw=None, kh=3, kw=3, pt=1, pl_=1, halo_out=None):
    """K3's plain version → bf16 [B,H,W,CO], or s8 codes when ``qa``/``qc``
    are given (zero in the columns >= ``sw``)."""
    _check_sw("site_s8", halo, sw, xq.shape[2])
    _check_halo_out(halo, halo_out, qa)
    _geo("site_s8", halo, kh, kw, pt, pl_)
    fv = _conv_dequant(xq, wk, ws, bias, halo, geo=(kh, kw, pt, pl_))
    if aa is not None:
        fv = (fv.float() * aa + ac).to(torch.bfloat16)
    if y is not None:
        yv = y.float()
        if yaff is not None:
            yv = torch.clamp(yv * yaff[0] + yaff[1], min=0.0).to(torch.bfloat16).float()
        fv = (fv.float() + yv).to(torch.bfloat16)
    return fv if qa is None else _mask_sw(_emit(fv, qa, qc, qlo), sw)


def res_site_plain(x, a, c, lo, wk, ws, bias, *, halo="reflect", tau=None, prologue="quant",
                   stats=True, kh=3, kw=3, pt=1, pl_=1, sw=None):
    """K4's plain version → (bf16 raw [B,H,W,CO], f32 [B,2,CO] sums of the
    columns < ``sw``; zero without ``stats``). ``prologue="cast"``: the codes
    are the saturating cast of x (a, c, lo unused)."""
    _check_sw("res_site", halo, sw, x.shape[2])
    _geo("res_site", halo, kh, kw, pt, pl_)
    q = saturate_s8(x) if prologue == "cast" else _quantize(x.float(), a, c, lo, tau)
    fv = _conv_dequant(_mask_sw(q, sw), wk, ws, bias, halo, geo=(kh, kw, pt, pl_))
    if not stats:
        return fv, torch.zeros((x.shape[0], 2, fv.shape[-1]), dtype=torch.float32,
                               device=x.device)
    return fv, _sums(fv, sw)


def _combine(r2, yp, a2, c2):
    t = (r2.float() * _rows(a2) + _rows(c2)).to(torch.bfloat16)
    return (t.float() + yp.float()).to(torch.bfloat16)


ACTS = ("relu", "tau")  # K5's post-add activations (ReCoNet)


def act_floor(act, tau_act, like: torch.Tensor) -> torch.Tensor:
    """K5's post-add floor row [B,C] f32: 0 for a ReLU, bf16(tau_act) for a
    TLU (the Pallas kernel maxes bf16 v with the floor cast to bf16)."""
    if act not in ACTS:
        raise ValueError(f"act {act!r} not in {ACTS}")
    if act == "relu":
        return torch.zeros((like.shape[0], like.shape[-1]), dtype=torch.float32,
                           device=like.device)
    if tau_act is None:
        raise ValueError("act='tau' needs tau_act")
    return tau_act.to(torch.bfloat16).float().contiguous()


def res_site_skip_plain(r2, yp, a, c, a2, c2, lo, wk, ws, bias, *, halo="reflect",
                        yout=True, act=None, tau_act=None, sw=None, kh=3, kw=3, pt=1, pl_=1):
    """K5's plain version → (bf16 raw, f32 sums of the columns < ``sw``, v
    or None)."""
    _check_sw("res_site_skip", halo, sw, r2.shape[2])
    _geo("res_site_skip", halo, kh, kw, pt, pl_)
    v = _combine(r2, yp, a2, c2)
    if act is not None:
        v = torch.maximum(v.float(), _rows(act_floor(act, tau_act, r2))).to(torch.bfloat16)
    fv = _conv_dequant(_mask_sw(_quantize(v.float(), a, c, lo), sw), wk, ws, bias, halo)
    return fv, _sums(fv, sw), (v if yout else None)


def site_s2_plain(x, a, c, lo, wk, ws, bias):
    """K8a's and K8b's plain version: K4 at stride 2 with a pixel-reflect
    halo → (bf16 raw [B,H/2,W/2,CO], f32 sums)."""
    fv = _conv_dequant(_quantize(x.float(), a, c, lo), wk, ws, bias, "reflect", stride=2)
    return fv, _sums(fv)


c2_site_plain = c3_site_plain = site_s2_plain


def _rows_conv(q: torch.Tensor, wk: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """deconv3's K rows: bf16(acc·ws) [B,H,W,64] of the 1×5 int8 conv of
    codes q (zero column pads)."""
    acc = conv2d_i8(q, unpack_weights(wk, 1, 5).to(q.device), padding=(0, 2))
    return (acc.float() * ws).to(torch.bfloat16)


def d3_rows_site_plain(y, a, c, wk, ws):
    """K7's plain version → bf16 rows [B,H,W,60]."""
    return _rows_conv(_quantize(y.float(), a, c, 0.0), wk, ws)[..., :D3_LANES].contiguous()


def quantize_i(v: torch.Tensor, a: float, c: float, lo: float = 0.0) -> torch.Tensor:
    """K7's quantize as the card computes it (``quantize_i`` of
    ``csrc/int8_sites.cu``), in f32 operations: clamp(v·a + c, lo, 127) +
    1.5·2^23, whose low mantissa bits are the code (the add rounds half to
    even) → int32 codes. Equal to ``_quantize``'s round for finite v."""
    f = torch.float32
    t = (v.to(f) * torch.tensor(a, dtype=f) + torch.tensor(c, dtype=f)).clamp(lo, 127.0)
    return (t + torch.tensor(12582912.0, dtype=f)).view(torch.int32) - 0x4B400000


def d3_rows_warps(f32: bool = False) -> int:
    """K7's warps a block: 8, or 6 for the f32 form, whose landing rows are
    twice the size."""
    return D3_WARPS_F32 if f32 else D3_WARPS


def d3_rows_smem_bytes(f32: bool = False) -> int:
    """K7's dynamic shared memory (``D3RowsSmem``): the weights [5][64] rows
    of 144 bytes, then per warp a landing row of 36 raw pixels (bf16, or f32
    for the f32 form) and two code slots of 36 pixels × 144 bytes."""
    px, cols, es = D3_C + 16, D3_STRIP + 4, 4 if f32 else 2
    return 5 * CO_TILE * px + d3_rows_warps(f32) * (cols * es * D3_C + 2 * cols * px)


def d3_rows_schedule(B: int, H: int, W: int, sms: int = 132, f32: bool = False) -> list:
    """K7's walk, as ``launch_d3rows_mma`` and the kernel take it: per warp
    of the grid, its list of (image, strip, row) items: a contiguous share
    of the B·strips·H items, rows down a strip."""
    strips = -(-W // D3_STRIP)
    total = B * strips * H
    warps = d3_rows_warps(f32)
    nw = min(-(-total // warps), sms) * warps
    out = []
    for gw in range(nw):
        items = range(total * gw // nw, total * (gw + 1) // nw)
        out.append([(r // H // strips, r // H % strips, r % H) for r in items])
    return out


def d3_s8_site_plain(xq, wk, ws, bias):
    """K6's plain version → bf16 [B,H,W,12]: the zero-SAME deconv3 interior
    (its 2-block border frame is the caller's strips)."""
    H = xq.shape[1]
    kp = F.pad(_rows_conv(xq, wk, ws), (0, 0, 0, 0, 2, 2))
    y = sum(kp[:, dy:dy + H, :, dy * D3_OUT:(dy + 1) * D3_OUT].float() for dy in range(5))
    return (y + bias).to(torch.bfloat16)


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
        "res_site_s8o_launch": [P] * 10 + dims + [Fl, Fl, I, I, P],
        "res_site_s8o_prev_launch": [P] * 10 + dims + [Fl, Fl, I, I, P],
        "site_s8_launch": [P] * 12 + dims + [I, Fl, I, I, I, P],
        "site_s8_prev_launch": [P] * 12 + dims + [I, Fl, I, I, P],
        "res_site_launch": [P] * 10 + dims + [Fl, I, I, I, P],
        "res_site_prev_launch": [P] * 10 + dims + [Fl, I, P],
        "res_site_form_launch": [P] * 9 + dims + [Fl, I, I, P],
        "res_site_skip_launch": [P] * 14 + dims + [Fl, I, I, P],
        "res_site_skip_prev_launch": [P] * 14 + dims + [Fl, I, P],
        "res_site_s8o_f32_launch": [P] * 10 + dims + [Fl, Fl, I, I, P],
        "site_s8_f32_launch": [P] * 12 + dims + [I, Fl, I, I, P],
        "res_site_f32_launch": [P] * 10 + dims + [Fl, I, I, I, P],
        "res_site_skip_f32_launch": [P] * 14 + dims + [Fl, I, I, P],
        "site_s2_launch": [P] * 9 + dims + [Fl, P],
        "site_s2_f32_launch": [P] * 9 + dims + [Fl, P],
        "site_s2_prev_launch": [P] * 9 + dims + [Fl, P],
        "d3_rows_launch": [P] * 6 + [I] * 3 + [P],
        "d3_rows_prev_launch": [P] * 6 + [I] * 3 + [P],
        "d3_rows_f32_launch": [P] * 6 + [I] * 3 + [P],
        "d3_s8_launch": [P] * 5 + [I] * 3 + [P],
        "d3_s8_prev_launch": [P] * 5 + [I] * 3 + [P],
        "mma_kernel_smem_bytes": [I],
        "mma_s2_smem_bytes": [I],
        "d3s8_mma_smem_bytes": [],
        "d3rows_mma_smem_bytes": [],
        "d3rows_mma_f32_smem_bytes": [],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_wg():
    """The wgmma core of K4 and K3 at ``WG_C`` (``csrc/int8_wgmma.cu``)."""
    from ._build import load_library

    lib = load_library(_SOURCE_WG)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {"res_site_wg_launch": [P] * 10 + [I] * 5 + [Fl, I, P],
            "site_s8_wg_launch": [P] * 12 + [I] * 6 + [Fl, I, I, P],
            "site_wgmma_smem_bytes": [I]}
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


def _check_site(kernel, x, wk, ws, bias, halo, kernel_c=None, halos=HALOS_RE, taps=9):
    """Validate the shared operands; returns (dev, B, H, W, C, CO).
    ``kernel_c``: the input channel counts the kernel's form is built for
    (default: ``SITE_C[kernel]``); ``taps``: kh·kw."""
    dev = x.device
    if dev.type != "cuda":
        raise NotImplementedError(f"{kernel}: no kernel for device {dev}")
    B, H, W, C = x.shape
    kernel_c = SITE_C[kernel] if kernel_c is None else kernel_c
    if C not in kernel_c:
        raise ValueError(f"{kernel}: C={C}, the kernel is built for C in {kernel_c}")
    if wk.dim() != 3 or wk.shape[0] != taps or wk.shape[1] * 4 != C:
        raise ValueError(f"{kernel}: weights {tuple(wk.shape)} do not match C={C}")
    CO = wk.shape[2]
    if CO % CO_TILE:
        raise ValueError(f"{kernel}: CO={CO} is not a multiple of {CO_TILE}")
    if H < 2 or W < 2:
        raise ValueError(f"{kernel}: H={H}, W={W}: the halo needs at least 2 pixels")
    if halo not in halos:
        raise ValueError(f"{kernel}: halo {halo!r} not in {tuple(halos)}")
    _check(kernel, "weights", wk, torch.int32, (taps, C // 4, CO), dev)
    _check(kernel, "ws", ws, torch.float32, (CO,), dev)
    _check(kernel, "bias", bias, torch.float32, (CO,), dev)
    return dev, B, H, W, C, CO


def _check_aligned(kernel, name, t):
    """The tensor-core core reads and writes 16 bytes a thread."""
    if t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} must start on a 16-byte boundary")


def _run(kernel, fn, *args, count=True, counts=LAUNCHES, name=None):
    """Launch; count it in ``counts[name or kernel]``."""
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    if count:
        counts[name or kernel] += 1


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _f32_form(kernel, t, halo, floored=False, form="3x3"):
    """``_run``'s counter of ``kernel``'s f32 form ``form`` (its "floor" form
    where ``floored``) where operand ``t`` is float32, None where it is
    bf16; a channel count or halo that ``F32_FORMS`` does not list for the
    form raises."""
    if t.dtype == torch.bfloat16:
        return None
    if t.dtype != torch.float32:
        raise TypeError(f"{kernel}: the operand must be bf16 or f32, got {t.dtype}")
    if floored and form == "3x3":
        form = "floor"
    name, *built = F32_FORMS.get((kernel, form), (None, (), ()))
    built = built[halo == "zero"]
    C = t.shape[-1]
    if C not in built:
        raise ValueError(f"{kernel}: no f32 form at C={C} with the {halo} halo"
                         + (" and a floor" if floored else "")
                         + ("" if form in ("3x3", "floor") else f" ({form})")
                         + f" (built: {built})")
    return {"name": name, "counts": F32_LAUNCHES}


def res_site_s8o(x, a, c, lo, wk, ws, bias, qa, qc, *, qlo=0.0, tau=None, halo="reflect",
                 sw=None):
    """K2: quantize x (a, c, lo) → 3×3 int8 conv → bf16(acc·ws + bias) →
    s8 codes clamp(round(f·qa + qc), qlo, 127) [B,H,W,CO]: the next site's
    input, its norm and ReLU folded into qa, qc and the floor 0. ``tau``
    (CO,): a floor on f·qa + qc before the round (FRN's TLU, with qlo −127;
    the floored emit is built for C = 192). ``sw`` (zero halo, C = 64 or
    128): the codes of x and of the output in columns >= sw are 0. On the
    card: the int8 tensor-core core."""
    if x.device.type == "cpu":
        return res_site_s8o_plain(x, a, c, lo, wk, ws, bias, qa, qc, qlo=qlo, tau=tau,
                                  halo=halo, sw=sw)
    co384 = x.shape[-1] == RECO_C and ws.shape[0] != RECO_C
    f32 = _f32_form("res_site_s8o", x, halo, tau is not None or qlo != 0.0,
                    "co384" if co384 else "3x3")
    if f32:
        return _res_site_s8o("res_site_s8o_f32_launch", True, x, a, c, lo, wk, ws, bias, qa,
                             qc, qlo, tau, halo, sw, f32=f32)
    return _res_site_s8o("res_site_s8o_launch", True, x, a, c, lo, wk, ws, bias, qa, qc, qlo,
                         tau, halo, sw)


def res_site_s8o_prev(x, a, c, lo, wk, ws, bias, qa, qc, *, qlo=0.0, tau=None, halo="reflect",
                      sw=None):
    """K2 on the previous ``__dp4a`` core, CUDA tensors only: ``chip_smoke.py``
    times it beside ``res_site_s8o``. Nothing on the main path calls it, and
    it counts no launch."""
    return _res_site_s8o("res_site_s8o_prev_launch", False, x, a, c, lo, wk, ws, bias, qa, qc,
                         qlo, tau, halo, sw)


def _res_site_s8o(fn, count, x, a, c, lo, wk, ws, bias, qa, qc, qlo, tau, halo, sw,
                  f32=None):
    k = "res_site_s8o"
    floored = tau is not None or qlo != 0.0
    dev, B, H, W, C, CO = _check_site(k, x, wk, ws, bias, halo,
                                      halos=_zero_halos(x.shape[-1], floored),
                                      kernel_c=(RECO_C,) if floored else None)
    _check_sw(k, halo, sw, W)
    counter = f32 or {}
    if C == RECO_C and CO != C:
        form = _reco_dec_form(k, C, CO, halo)
        counter = f32 or {"name": form, "counts": FORM_LAUNCHES}
    _check(k, "x", x, torch.float32 if f32 else torch.bfloat16, (B, H, W, C), dev)
    _check_aligned(k, "x", x)
    for name, t in (("a", a), ("c", c)):
        _check(k, name, t, torch.float32, (B, C), dev)
    for name, t in (("qa", qa), ("qc", qc), ("tau", tau)):
        if t is not None:
            _check(k, name, t, torch.float32, (CO,), dev)
    out = torch.empty((B, H, W, CO), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        _run(k, getattr(_lib(), fn), x.data_ptr(), a.data_ptr(), c.data_ptr(), wk.data_ptr(),
             ws.data_ptr(), bias.data_ptr(), qa.data_ptr(), qc.data_ptr(), _ptr(tau),
             out.data_ptr(), B, H, W, C, CO, float(lo), float(qlo), HALOS[halo], sw or W,
             _stream(dev), count=count, **counter)
    return out


def _reco_dec_form(kernel, C, CO, halo, bare=True) -> str:
    """``FORM_LAUNCHES``' name of ``kernel``'s ReCoNet decoder form at
    C → CO under ``halo``; any other such form raises. ``bare``: K3's form
    has no affine, residual or emit."""
    c, co, name = RECO_DEC_FORMS[kernel]
    if (C, CO, halo) != (c, co, "edge") or not bare:
        raise ValueError(f"{kernel}: no form at C={C} -> CO={CO} with the {halo} halo"
                         + ("" if bare else " and an epilogue step")
                         + f" (built: CO == {c}, and the edge-halo {c} -> {co}"
                         + (" bare bf16 raw)" if kernel == "site_s8" else ")"))
    return name


def site_s8(xq, wk, ws, bias, aa=None, ac=None, y=None, *, yaff=None, qa=None, qc=None,
            qlo=0.0, halo="reflect", sw=None, kh=3, kw=3, pt=1, pl_=1, halo_out=None):
    """K3: int8 conv of s8 codes (3×3, or under the zero halo 2×2 at pads
    ``pt = pl_ = 0``) → f = bf16(acc·ws + bias); then
    f = bf16(f·aa + ac) with the frozen affine (aa, ac); f = bf16(f + y) with
    the residual y [B,H,W,CO] (CO == C), itself first replaced by
    bf16(max(y·ya + yc, 0)) when ``yaff`` = (ya, yc); returns bf16 f, or the
    s8 codes clamp(round(f·qa + qc), qlo, 127) when ``qa``/``qc`` are given,
    zero in the columns >= ``sw`` (zero halo only; ``halo_out="zero2"``
    names that emit as deconv3's input). Rows are [CO] f32. On the card:
    the int8 tensor-core core."""
    if xq.device.type == "cpu":
        return site_s8_plain(xq, wk, ws, bias, aa, ac, y, yaff=yaff, qa=qa, qc=qc, qlo=qlo,
                             halo=halo, sw=sw, kh=kh, kw=kw, pt=pt, pl_=pl_, halo_out=halo_out)
    _check_halo_out(halo, halo_out, qa)
    geo = _geo("site_s8", halo, kh, kw, pt, pl_)
    if y is not None and geo and y.dtype == torch.float32:
        raise NotImplementedError("site_s8: no f32 form with 2x2 taps: the residual is its "
                                  "one f32 operand, and no chain adds one to a 2x2 site")
    f32 = None if y is None else _f32_form("site_s8", y, halo)
    if f32:
        return _site_s8("site_s8_f32_launch", True, xq, wk, ws, bias, aa, ac, y, yaff, qa, qc,
                        qlo, halo, sw, f32=f32)
    if xq.shape[-1] in WG_C and not geo and halo != "zero":
        return _site_s8("site_s8_wg_launch", True, xq, wk, ws, bias, aa, ac, y, yaff, qa, qc,
                        qlo, halo, sw)
    return _site_s8("site_s8_launch", True, xq, wk, ws, bias, aa, ac, y, yaff, qa, qc, qlo, halo,
                    sw, geo=geo)


def site_s8_prev(xq, wk, ws, bias, aa=None, ac=None, y=None, *, yaff=None, qa=None, qc=None,
                 qlo=0.0, halo="reflect", sw=None):
    """K3 on its previous core, CUDA tensors only: at C = 64, 128 the
    ``__dp4a`` core, at ``WG_C`` the ``mma_kernel`` core the wgmma core
    replaces. ``chip_smoke.py`` times it beside ``site_s8``. Nothing on the
    main path calls it, and it counts no launch."""
    fn = "site_s8_launch" if xq.shape[-1] in WG_C and halo != "zero" else "site_s8_prev_launch"
    return _site_s8(fn, False, xq, wk, ws, bias, aa, ac, y, yaff, qa, qc, qlo, halo, sw)


def _site_s8(fn, count, xq, wk, ws, bias, aa, ac, y, yaff, qa, qc, qlo, halo, sw, f32=None,
             geo=0):
    k = "site_s8"
    c96 = RECO_DEC_FORMS[k][0]
    dev, B, H, W, C, CO = _check_site(k, xq, wk, ws, bias, halo, halos=tuple(HALOS),
                                      kernel_c=KERNEL_C if geo or fn == "site_s8_prev_launch"
                                      else (*SITE_C[k], c96), taps=4 if geo else 9)
    if fn == "site_s8_wg_launch":
        _check_wg_co(k, CO)
    _check_sw(k, halo, sw, W)
    _check(k, "xq", xq, torch.int8, (B, H, W, C), dev)
    _check_aligned(k, "xq", xq)
    flags = 0
    ya = yc = None
    if aa is not None:
        flags |= _S8_FLAGS["aff"]
        for name, t in (("aa", aa), ("ac", ac)):
            _check(k, name, t, torch.float32, (CO,), dev)
    if y is not None:
        flags |= _S8_FLAGS["yadd"]
        if CO != C:
            raise ValueError(f"{k}: the residual add needs CO == C, got {CO} != {C}")
        _check(k, "y", y, torch.float32 if f32 else torch.bfloat16, (B, H, W, CO), dev)
        _check_aligned(k, "y", y)
        if yaff is not None:
            flags |= _S8_FLAGS["yaff"]
            ya, yc = yaff
            for name, t in (("ya", ya), ("yc", yc)):
                _check(k, name, t, torch.float32, (CO,), dev)
    elif yaff is not None:
        raise ValueError(f"{k}: yaff needs the residual y")
    if qa is not None:
        flags |= _S8_FLAGS["s8out"]
        for name, t in (("qa", qa), ("qc", qc)):
            _check(k, name, t, torch.float32, (CO,), dev)
    dtype = torch.int8 if qa is not None else torch.bfloat16
    out = torch.empty((B, H, W, CO), dtype=dtype, device=dev)
    extra = (geo,) if fn == "site_s8_launch" else ()
    counter = {"name": GEO_FORMS[(k, geo)], "counts": FORM_LAUNCHES} if geo else f32 or {}
    if C == c96:
        counter = {"name": _reco_dec_form(k, C, CO, halo, bare=flags == 0 and sw is None),
                   "counts": FORM_LAUNCHES}
    wg = fn == "site_s8_wg_launch"
    lib, w = (_lib_wg(), wgmma_weights(wk)) if wg else (_lib(), wk)
    with torch.cuda.device(dev):
        _run(k, getattr(lib, fn), xq.data_ptr(), w.data_ptr(), ws.data_ptr(),
             bias.data_ptr(), _ptr(aa), _ptr(ac), _ptr(y), _ptr(ya), _ptr(yc), _ptr(qa),
             _ptr(qc), out.data_ptr(), B, H, W, C, CO, flags, float(qlo), HALOS[halo], sw or W,
             *extra, _stream(dev), count=count, **counter)
    return out


def _stats_buffers(B, H, W, CO, dev, tile):
    """The [B, tiles, 2, CO] partials of a core whose output tile is
    ``tile`` = (rows, columns), and the [B, 2, CO] sums."""
    from math import ceil

    tiles = ceil(H / tile[0]) * ceil(W / tile[1])
    part = torch.empty((B, tiles, 2, CO), dtype=torch.float32, device=dev)
    return part, torch.empty((B, 2, CO), dtype=torch.float32, device=dev)


def res_site(x, a, c, lo, wk, ws, bias, *, halo="reflect", tau=None, prologue="quant",
             stats=True, kh=3, kw=3, pt=1, pl_=1, sw=None):
    """K4: quantize x → 3×3 int8 conv → bf16 raw [B,H,W,CO] and the f32
    [Σ, Σ²] [B,2,CO] of the bf16-rounded raw. ``tau`` (B, C): a floor on
    x·a + c before the round (FRN's TLU; C = 96 or 192). ``halo="zero"``
    (C = 64, 128, no ``tau``): code 0 outside the image and, with ``sw``, in
    the columns >= sw, which the sums leave out; the 2×2 taps at pads
    ``pt = pl_ = 1`` or 0 (``GEO_FORMS``). The int8 probes'
    forms (``K4_PROBE_FORMS``; C = 128, reflect halo, no ``tau``):
    ``prologue="cast"``, the codes are XLA's saturating cast of x (a, c, lo
    unused); ``stats=False``, the sums are zero. On the card: the int8
    tensor-core core."""
    if prologue not in ("quant", "cast"):
        raise ValueError(f"res_site: prologue {prologue!r} not in ('quant', 'cast')")
    if x.device.type == "cpu":
        return res_site_plain(x, a, c, lo, wk, ws, bias, halo=halo, tau=tau, prologue=prologue,
                              stats=stats, kh=kh, kw=kw, pt=pt, pl_=pl_, sw=sw)
    geo = _geo("res_site", halo, kh, kw, pt, pl_)
    _check_sw("res_site", halo, sw, x.shape[2])
    if (prologue, stats) != ("quant", True):
        return _res_site_probe(x, a, c, lo, wk, ws, bias, halo, tau, prologue, stats)
    f32 = _f32_form("res_site", x, halo, tau is not None, ("3x3", "k2p1", "k2p0")[geo])
    if f32:
        return _res_site("res_site_f32_launch", TILE_MMA, True, x, a, c, lo, wk, ws, bias, halo,
                         None, f32=f32, geo=geo, sw=sw)
    if x.shape[-1] in WG_C:
        return _res_site_wg(x, a, c, lo, wk, ws, bias, halo, tau)
    return _res_site("res_site_launch", TILE_MMA, True, x, a, c, lo, wk, ws, bias, halo, tau,
                     geo=geo, sw=sw)


def _res_site_probe(x, a, c, lo, wk, ws, bias, halo, tau, prologue, stats):
    k = K4_PROBE_FORMS.get((prologue, stats))
    if k is None:
        raise ValueError(f"res_site: no kernel form with prologue {prologue!r} and "
                         f"stats={stats} (built: {sorted(K4_PROBE_FORMS)})")
    if tau is not None:
        raise ValueError(f"res_site: the {prologue!r}/stats={stats} form takes no tau")
    dev, B, H, W, C, CO = _check_site("res_site", x, wk, ws, bias, halo, kernel_c=(128,),
                                      halos=("reflect",))
    _check("res_site", "x", x, torch.bfloat16, (B, H, W, C), dev)
    _check_aligned("res_site", "x", x)
    if prologue == "quant":
        for name, t in (("a", a), ("c", c)):
            _check("res_site", name, t, torch.float32, (B, C), dev)
    out = torch.empty((B, H, W, CO), dtype=torch.bfloat16, device=dev)
    if stats:
        part, sums = _stats_buffers(B, H, W, CO, dev, TILE_MMA)
    else:  # the kernel zeroes the sums; no partials
        part, sums = None, torch.empty((B, 2, CO), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _run(k, _lib().res_site_form_launch, x.data_ptr(), _ptr(a), _ptr(c), wk.data_ptr(),
             ws.data_ptr(), bias.data_ptr(), out.data_ptr(), _ptr(part), sums.data_ptr(),
             B, H, W, C, CO, float(lo), int(prologue == "cast"), int(stats), _stream(dev),
             counts=PROBE_LAUNCHES)
    return out, sums


def res_site_prev(x, a, c, lo, wk, ws, bias, *, halo="reflect", tau=None):
    """K4 on its previous core, CUDA tensors only: at C = 64, 128 the
    ``__dp4a`` core (no floor), at ``WG_C`` the ``mma_kernel`` core the
    wgmma core replaces (``tau`` there as ``res_site``'s). ``chip_smoke.py``
    times it beside ``res_site``. Nothing on the main path calls it, and it
    counts no launch."""
    if x.shape[-1] in WG_C:
        return _res_site("res_site_launch", TILE_MMA, False, x, a, c, lo, wk, ws, bias, halo,
                         tau)
    return _res_site("res_site_prev_launch", TILE_DP4A, False, x, a, c, lo, wk, ws, bias, halo,
                     tau, kernel_c=KERNEL_C)


def _zero_halos(C: int, floored: bool) -> tuple:
    """The halos K2, K4 and K5 take at C input channels: the zero halo too
    at KERNEL_C without a floor."""
    return tuple(HALOS) if C in KERNEL_C and not floored else HALOS_RE


def _res_site(fn, tile, count, x, a, c, lo, wk, ws, bias, halo, tau, kernel_c=None,
              f32=None, geo=0, sw=None):
    k = "res_site"
    if tau is not None:
        kernel_c = TAU_C
    if geo:
        kernel_c = KERNEL_C
    dev, B, H, W, C, CO = _check_site(k, x, wk, ws, bias, halo, kernel_c=kernel_c,
                                      halos=_zero_halos(x.shape[-1], tau is not None),
                                      taps=4 if geo else 9)
    _check(k, "x", x, torch.float32 if f32 else torch.bfloat16, (B, H, W, C), dev)
    _check_aligned(k, "x", x)
    for name, t in (("a", a), ("c", c), ("tau", tau)):
        if t is not None:
            _check(k, name, t, torch.float32, (B, C), dev)
    out = torch.empty((B, H, W, CO), dtype=torch.bfloat16, device=dev)
    part, sums = _stats_buffers(B, H, W, CO, dev, tile)
    extra = () if fn == "res_site_prev_launch" else (geo, sw or W)
    name = GEO_FORMS.get((k, geo)) or _sw_form(k, sw, W)
    counter = f32 or ({"name": name, "counts": FORM_LAUNCHES} if name else {})
    with torch.cuda.device(dev):
        _run(k, getattr(_lib(), fn), x.data_ptr(), a.data_ptr(), c.data_ptr(), _ptr(tau),
             wk.data_ptr(), ws.data_ptr(), bias.data_ptr(), out.data_ptr(), part.data_ptr(),
             sums.data_ptr(), B, H, W, C, CO, float(lo), HALOS[halo], *extra, _stream(dev),
             count=count, **counter)
    return out, sums


def _check_wg_co(kernel, CO):
    if CO % WG_NP or CO > 2 * WG_NP:
        raise ValueError(f"{kernel}: CO={CO}; at C in {WG_C} the kernel is built for CO = "
                         f"{WG_NP} and {2 * WG_NP}")


def _res_site_wg(x, a, c, lo, wk, ws, bias, halo, tau):
    """K4 at ``WG_C`` on the wgmma core (reflect or edge halo, optional
    ``tau``; CO = 192 or 384)."""
    k = "res_site"
    dev, B, H, W, C, CO = _check_site(k, x, wk, ws, bias, halo)
    _check_wg_co(k, CO)
    _check(k, "x", x, torch.bfloat16, (B, H, W, C), dev)
    _check_aligned(k, "x", x)
    for name, t in (("a", a), ("c", c), ("tau", tau)):
        if t is not None:
            _check(k, name, t, torch.float32, (B, C), dev)
    out = torch.empty((B, H, W, CO), dtype=torch.bfloat16, device=dev)
    part, sums = _stats_buffers(B, H, W, CO, dev, TILE_MMA)
    wg = wgmma_weights(wk)
    with torch.cuda.device(dev):
        _run(k, _lib_wg().res_site_wg_launch, x.data_ptr(), a.data_ptr(), c.data_ptr(),
             _ptr(tau), wg.data_ptr(), ws.data_ptr(), bias.data_ptr(), out.data_ptr(),
             part.data_ptr(), sums.data_ptr(), B, H, W, C, CO, float(lo), HALOS[halo],
             _stream(dev))
    return out, sums


def res_site_skip(r2, yp, a, c, a2, c2, lo, wk, ws, bias, *, halo="reflect", yout=True,
                  act=None, tau_act=None, sw=None, kh=3, kw=3, pt=1, pl_=1):
    """K5: v = bf16(bf16(r2·a2 + c2) + yp) in the prologue, then K4 on v.
    ``act`` (ReCoNet, C = 192): the post-add activation on v before it is
    written and quantized, "relu" (max(v, 0)) or "tau" (max(v,
    bf16(tau_act)), tau_act (B, C) f32). ``halo="zero"`` (C = 64, 128, no
    ``act``): code 0 outside the image and, with ``sw``, in the columns >= sw
    (v is written there), which the sums leave out. 3×3 taps only. Returns
    (bf16 raw, f32 sums, v) — v is None when ``yout`` is False. On the card:
    the int8 tensor-core core."""
    if r2.device.type == "cpu":
        return res_site_skip_plain(r2, yp, a, c, a2, c2, lo, wk, ws, bias, halo=halo,
                                   yout=yout, act=act, tau_act=tau_act, sw=sw, kh=kh, kw=kw,
                                   pt=pt, pl_=pl_)
    _geo("res_site_skip", halo, kh, kw, pt, pl_)
    _check_sw("res_site_skip", halo, sw, r2.shape[2])
    f32 = _f32_form("res_site_skip", yp, halo, act is not None)
    if f32:
        return _res_site_skip("res_site_skip_f32_launch", TILE_MMA, True, r2, yp, a, c, a2, c2,
                              lo, wk, ws, bias, halo, yout, act, tau_act, f32=f32, sw=sw)
    return _res_site_skip("res_site_skip_launch", TILE_MMA, True, r2, yp, a, c, a2, c2, lo, wk,
                          ws, bias, halo, yout, act, tau_act, sw=sw)


def res_site_skip_prev(r2, yp, a, c, a2, c2, lo, wk, ws, bias, *, halo="reflect", yout=True,
                       act=None, tau_act=None):
    """K5 on the previous ``__dp4a`` core, CUDA tensors only: ``chip_smoke.py``
    times it beside ``res_site_skip``. Nothing on the main path calls it, and
    it counts no launch."""
    return _res_site_skip("res_site_skip_prev_launch", TILE_DP4A, False, r2, yp, a, c, a2, c2,
                          lo, wk, ws, bias, halo, yout, act, tau_act)


def _res_site_skip(fn, tile, count, r2, yp, a, c, a2, c2, lo, wk, ws, bias, halo, yout, act,
                   tau_act, f32=None, sw=None):
    k = "res_site_skip"
    dev, B, H, W, C, CO = _check_site(k, r2, wk, ws, bias, halo,
                                      kernel_c=KERNEL_C if act is None else (RECO_C,),
                                      halos=_zero_halos(r2.shape[-1], act is not None))
    for name, t, dtype in (("r2", r2, torch.bfloat16),
                           ("yp", yp, torch.float32 if f32 else torch.bfloat16)):
        _check(k, name, t, dtype, (B, H, W, C), dev)
        _check_aligned(k, name, t)
    if act is not None and tau_act is not None:
        _check(k, "tau_act", tau_act, torch.float32, (B, C), dev)
    floor = None if act is None else act_floor(act, tau_act, r2)
    for name, t in (("a", a), ("c", c), ("a2", a2), ("c2", c2)):
        _check(k, name, t, torch.float32, (B, C), dev)
    out = torch.empty((B, H, W, CO), dtype=torch.bfloat16, device=dev)
    v = torch.empty((B, H, W, C), dtype=torch.bfloat16, device=dev) if yout else None
    part, sums = _stats_buffers(B, H, W, CO, dev, tile)
    extra = (sw or W,) if count else ()
    name = _sw_form(k, sw, W)
    counter = f32 or ({"name": name, "counts": FORM_LAUNCHES} if name else {})
    with torch.cuda.device(dev):
        _run(k, getattr(_lib(), fn), r2.data_ptr(), yp.data_ptr(), a.data_ptr(), c.data_ptr(),
             a2.data_ptr(), c2.data_ptr(), _ptr(floor), wk.data_ptr(), ws.data_ptr(),
             bias.data_ptr(), out.data_ptr(), _ptr(v), part.data_ptr(), sums.data_ptr(), B, H,
             W, C, CO, float(lo), HALOS[halo], *extra, _stream(dev), count=count, **counter)
    return out, sums, v


def _site_s2(k, fn, count, x, a, c, lo, wk, ws, bias, f32=None):
    """K8a (C = 32) and K8b (C = 64) on the int8 tensor cores
    (``site_s2_launch``; x 16-byte aligned), K8a with an f32 x
    (``site_s2_f32_launch``; ``f32``, its counter), or with ``count`` False on their
    previous ``__dp4a`` core (``site_s2_prev_launch``)."""
    dev, B, H, W, C, CO = _check_site(k, x, wk, ws, bias, "reflect", kernel_c=HEAD_C)
    if H % 2 or W % 2:
        raise ValueError(f"{k}: H={H}, W={W}: the stride-2 site needs an even size")
    _check(k, "x", x, torch.float32 if f32 else torch.bfloat16, (B, H, W, C), dev)
    if count:
        _check_aligned(k, "x", x)
        if H * W * C >= 2 ** 31:
            raise ValueError(f"{k}: an image of {H}x{W}x{C} is past the kernel's 32-bit offsets")
    for name, t in (("a", a), ("c", c)):
        _check(k, name, t, torch.float32, (B, C), dev)
    out = torch.empty((B, H // 2, W // 2, CO), dtype=torch.bfloat16, device=dev)
    part, sums = _stats_buffers(B, H // 2, W // 2, CO, dev, TILE_MMA if count else TILE_DP4A)
    with torch.cuda.device(dev):
        _run(k, getattr(_lib(), fn), x.data_ptr(), a.data_ptr(), c.data_ptr(),
             wk.data_ptr(), ws.data_ptr(), bias.data_ptr(), out.data_ptr(), part.data_ptr(),
             sums.data_ptr(), B, H, W, C, CO, float(lo), _stream(dev), count=count,
             **(f32 or {}))
    return out, sums


def c2_site(x, a, c, lo, wk, ws, bias):
    """K8a: conv2, quantize the conv1 raw x [B,H,W,32] (bf16, or f32 under
    float32, read unrounded) with the folded in1 affine (a, c; floor ``lo``)
    → 3×3 stride-2 int8 conv over the pixel reflect halo → bf16 raw
    [B,H/2,W/2,64] and its f32 [Σ, Σ²] [B,2,64]. On the card: the int8
    tensor cores (x 16-byte aligned)."""
    if x.device.type == "cpu":
        return c2_site_plain(x, a, c, lo, wk, ws, bias)
    f32 = _f32_form("c2_site", x, "reflect")
    if f32:
        return _site_s2("c2_site", "site_s2_f32_launch", True, x, a, c, lo, wk, ws, bias,
                        f32=f32)
    return _site_s2("c2_site", "site_s2_launch", True, x, a, c, lo, wk, ws, bias)


def c2_site_prev(x, a, c, lo, wk, ws, bias):
    """K8a on the previous ``__dp4a`` core, CUDA tensors only: ``chip_smoke.py``
    times it beside ``c2_site``. Nothing on the main path calls it, and it
    counts no launch."""
    return _site_s2("c2_site", "site_s2_prev_launch", False, x, a, c, lo, wk, ws, bias)


def c3_site(x, a, c, lo, wk, ws, bias):
    """K8b: conv3, as K8a from the conv2 raw [B,H,W,64] to [B,H/2,W/2,128].
    On the card: the int8 tensor cores (x 16-byte aligned), one block on
    all 128 output channels."""
    if x.device.type == "cpu":
        return c3_site_plain(x, a, c, lo, wk, ws, bias)
    return _site_s2("c3_site", "site_s2_launch", True, x, a, c, lo, wk, ws, bias)


def c3_site_prev(x, a, c, lo, wk, ws, bias):
    """K8b on the previous ``__dp4a`` core, CUDA tensors only: ``chip_smoke.py``
    times it beside ``c3_site``. Nothing on the main path calls it, and it
    counts no launch."""
    return _site_s2("c3_site", "site_s2_prev_launch", False, x, a, c, lo, wk, ws, bias)


def _check_rows(k, x, wk, ws):
    dev = x.device
    if dev.type != "cuda":
        raise NotImplementedError(f"{k}: no kernel for device {dev}")
    B, H, W, C = x.shape
    if C != D3_C:
        raise ValueError(f"{k}: C={C}, the kernel is built for C={D3_C}")
    _check(k, "weights", wk, torch.int32, (5, D3_C // 4, CO_TILE), dev)
    _check(k, "ws", ws, torch.float32, (CO_TILE,), dev)
    return dev, B, H, W


def d3_rows_site(y, a, c, wk, ws):
    """K7: quantize the d2 raw y [B,H,W,128] (a, c [B,128]: the in5 affine
    folded with d3's qin; floor 0 folds the ReLU) → 1×5 int8 conv with zero
    column pads → bf16(acc·ws) rows [B,H,W,60]. ``wk``/``ws``: the
    tap-packed deconv3 weights and dequant row, padded to 64 lanes. y is
    bf16, or f32 (the float32 chains' d2 raw, read unrounded: the f32 form,
    counted in ``F32_LAUNCHES``). On the card: the int8 tensor cores (y
    16-byte aligned)."""
    if y.device.type == "cpu":
        return d3_rows_site_plain(y, a, c, wk, ws)
    f32 = _f32_form("d3_rows_site", y, None, form="rows")
    if f32:
        return _d3_rows_site("d3_rows_f32_launch", True, y, a, c, wk, ws, f32=f32)
    return _d3_rows_site("d3_rows_launch", True, y, a, c, wk, ws)


def d3_rows_site_prev(y, a, c, wk, ws):
    """K7 on the previous ``__dp4a`` core (``rows_kernel``), CUDA tensors
    only: ``chip_smoke.py`` times it beside ``d3_rows_site``. Nothing on the
    main path calls it, and it counts no launch."""
    return _d3_rows_site("d3_rows_prev_launch", False, y, a, c, wk, ws)


def _d3_rows_site(fn, count, y, a, c, wk, ws, f32=None):
    k = "d3_rows_site"
    dev, B, H, W = _check_rows(k, y, wk, ws)
    _check(k, "y", y, torch.float32 if f32 else torch.bfloat16, (B, H, W, D3_C), dev)
    if count:
        _check_aligned(k, "y", y)
    for name, t in (("a", a), ("c", c)):
        _check(k, name, t, torch.float32, (B, D3_C), dev)
    out = torch.empty((B, H, W, D3_LANES), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        _run(k, getattr(_lib(), fn), y.data_ptr(), a.data_ptr(), c.data_ptr(), wk.data_ptr(),
             ws.data_ptr(), out.data_ptr(), B, H, W, _stream(dev), count=count, **(f32 or {}))
    return out


def d3_s8_site(xq, wk, ws, bias):
    """K6: deconv3 on the s8 codes xq [B,H,W,128] (the d2 site's emit, the
    frozen in5 affine and ReLU folded in): K rows bf16(acc·ws) of the 1×5
    conv, then out = bf16(Σ_dy K[r+dy−2] lanes 12·dy.. + bias) [B,H,W,12]
    with zero rows and columns outside the image (the zero-SAME interior;
    the caller strip-fixes the 2-block frame). On the card: the int8 tensor
    cores (xq 16-byte aligned)."""
    if xq.device.type == "cpu":
        return d3_s8_site_plain(xq, wk, ws, bias)
    return _d3_s8_site("d3_s8_launch", True, xq, wk, ws, bias)


def d3_s8_site_prev(xq, wk, ws, bias):
    """K6 on the previous ``__dp4a`` core (``rows_kernel``), CUDA tensors
    only: ``chip_smoke.py`` times it beside ``d3_s8_site``. Nothing on the
    main path calls it, and it counts no launch."""
    return _d3_s8_site("d3_s8_prev_launch", False, xq, wk, ws, bias)


def _d3_s8_site(fn, count, xq, wk, ws, bias):
    k = "d3_s8_site"
    dev, B, H, W = _check_rows(k, xq, wk, ws)
    _check(k, "xq", xq, torch.int8, (B, H, W, D3_C), dev)
    if count:
        _check_aligned(k, "xq", xq)
    _check(k, "bias", bias, torch.float32, (D3_OUT,), dev)
    out = torch.empty((B, H, W, D3_OUT), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        _run(k, getattr(_lib(), fn), xq.data_ptr(), wk.data_ptr(), ws.data_ptr(),
             bias.data_ptr(), out.data_ptr(), B, H, W, _stream(dev), count=count)
    return out
