"""K9a–K9e: the bf16 fused sites of the Johnson net (``csrc/bf16_sites.cu``).

Each replaces one Pallas kernel of ``neuralstyletransferv1_tpu/models/
s2d2_sites.py``. All five share one prologue, the pending instance-norm
affine and ReLU applied to the raw input in f32 and rounded to bf16,
x' = bf16(max(f32(x)·a + c, 0)), and run a conv of bf16 operands with f32
accumulation:

  K9a ``d2_site``       3×3 stride 1, 64 → 128, edge halo: deconv2 in its
                        phase form (``_d2_site`` / ``_d2_kernel``)
  K9c ``c2_site_bf16``  3×3 stride 2, 32 → 64, pixel reflect halo: conv2
                        (``_c2_site`` / ``_c2_kernel`` + ``_c2_fixup``)
  K9d ``c3_site_bf16``  3×3 stride 2, 64 → 128, pixel reflect halo: conv3
                        (``_c3_site`` / ``_c3_kernel``)
  K9e ``d3_rows``       deconv3's tap-packed 1×5 conv 128 → 60 lanes over the
                        4-pixel reflect halo (on the block grid: two halo
                        blocks a side, phases permuted) → bf16 rows for the
                        H+4 rows of the padded grid (``d3_rows`` /
                        ``_d3_kernel``)
  K9b ``d3_sum_site``   the same rows, then out[r] = bf16(Σ_dy rows[r+dy]
                        [12·dy + o] + bias[o]), f32 in dy order
                        (``_d3_sum_site`` / ``_d3s_kernel``)

Two more answer the JAX package's bf16 megakernel experiments
(``experiments/``); no product path calls them:

  K10 ``fused_conv``    the res-block site on a pre-padded input x_pad [B,
                        ≥H+2, ≥W+2, 128]: a prologue on every position read
                        (``"f32"`` as above, ``"none"``, or ``"bf16"``: x·bf16(a)
                        → bf16, + bf16(c) → bf16, max 0) → 3×3 conv 128 → CO +
                        bias → bf16 and, unless ``stats=False``, [Σ f, Σ f²]
                        (``mk1_fusedconv.fused_conv``; mk2/mk3/mk5 ``build``)
  K11 ``c1_site``       Johnson's conv1 in its f=2 block form: the 5×5 conv
                        12 → 128 of the 4-pixel phase-reflect-padded space-to-
                        depth image y12 [B,H+4,W+4,12] → bf16(Σ + bias)
                        [B,H,W,128] (``mk13_c1.c1_site``); on the card
                        ``c1_wgmma_kernel``: persistent, one block an SM on
                        all 128 channels with the five kernel rows' weights
                        resident; 64-pixel tiles of one output row, walked
                        down column strips so that a producer warpgroup
                        lands each input row once for five output rows; two
                        consumer warpgroups on alternate tiles, 20
                        ``wgmma`` m64n128k16 a tile with A from registers in
                        a permuted k order (``c1_k_source``,
                        ``c1_fragment_word``), the outputs staged by
                        ``stmatrix`` for two TMA stores a tile
                        (``c1_site_smem_bytes``, ``c1_schedule`` and
                        ``c1_row_slots`` mirror it); ``c1_site_prev`` runs
                        its first core (``c1_kernel``)

On the card K9b runs on its own tensor-core core (``d3sum_mma_kernel``:
warps walk 16-column strips down the image, the dy-sum's partial sums in
registers; x 16-byte aligned), K9e on K9c's and K9d's warpgroup design
(``d3rows_wgmma_kernel``: persistent; a producer warpgroup lands each
(image, conv row, 64-column segment) item's 68 raw pixels by cp.async
through the reflect map and activates them in place; a consumer warpgroup
holds the five taps' weights in registers as the ``wgmma`` A and reads
the pixels as B through a descriptor, each tap's one-pixel shift 16
bytes of its start in a no-swizzle layout; one bulk copy stores the
item's contiguous outputs, plain stores on an odd W; x and w 16-byte
aligned;
``d3_rows_smem_bytes``, ``d3_rows_source``, ``d3_rows_offset``,
``d3_rows_core_matrix`` and ``d3_rows_schedule`` mirror it), K9a on K10's Hopper design at C = 64
(``d2_wgmma_kernel``: persistent, TMA, ``wgmma``, 4 × 32-pixel tiles, the
nine taps' weights resident; TMA fills the halo outside the image with
zeros, and border tiles copy the edge into it before the activation, as
``d2_halo_tile`` mirrors; x and w 16-byte aligned), and K9c and K9d on one
stride-2 core, K8a's and K8b's design in bf16 on ``wgmma``
(``s2_mma_bf16_kernel``: persistent, one block an SM on all output
channels with the nine taps' weights resident; the haloed input tile in
four parity planes, so each tap is a stride-1 shift that ``ldmatrix``
reads without bank conflicts; a producer warpgroup brings each tile's raw
bf16 in by cp.async, each 16-byte chunk from the pixel the reflect maps
it to, and activates it in place once, a few tiles ahead; a consumer
warpgroup runs ``wgmma`` a tap, stages the outputs for a TMA store and
keeps an image's [Σ, Σ²] in registers; x and w 16-byte aligned). They
move 1.59 and 0.80 GB at 1080p B=8 for 1.5e11 bf16 FLOP each: bound by
their bytes (0.475 and 0.238 ms), K9d near balance with its MMAs (0.155
ms at the tensor peak). ``s2_site_smem_bytes``, ``s2_plane_pixel``,
``s2_tap_pixel``, ``s2_swizzle``, ``s2_halo_tile``, ``s2_site_schedule``
and ``s2_part_slots`` mirror the core's geometry. ``d3_sum_site_prev``,
``d2_site_prev``, ``c2_site_bf16_prev``, ``c3_site_bf16_prev`` and
``d3_rows_prev`` launch them on their previous cores (``rows_kernel_bf16``,
``site_kernel_bf16``),
CUDA tensors only, for timing the two designs side by side: nothing on
the main path calls them, and they count no launch.

K9a/K9c/K9d return (bf16(f), [Σ f, Σ f²]) with f = acc + bias in f32: the
sums are of the f32 values before the bf16 round, as the TPU kernels take
them (the int8 sites sum the rounded values). The TPU's K9c/K9d run 2×2
block convs on space-to-depth tensors; each pixel tap sits exactly once in
those block weights, so here they are pixel convs. Products of two bf16
values are exact in f32: implementations differ only in the order of the f32
accumulation, i.e. by isolated bf16 ulps after the round.

Under float32 K9a and K9e read an f32 raw x (deconv1's raw on the 2× grid,
the d2 raw), which the Pallas prologue reads unrounded, x' =
bf16(max(x·a + c, 0)): each wrapper takes x as bf16 or f32 and, on the
card, launches the matching form (``F32_FORMS``, counted in
``F32_LAUNCHES``). K9a's f32 tile does not fit twice beside its resident
weights, so its f32 form has no TMA for x: the consumers' activation reads
each piece's eight f32 channels from device memory into the bf16 tile
(the edge halo as clamped source pixels). K9e's producer copies the f32
raw row by cp.async into an f32 staging slot beside each bf16 row buffer
and activates from there. K9b reads K9a's bf16 output and has no such form.

Shapes: x [B,H,W,C] bf16 (K9a, K9e: or f32), a/c [B,C] f32, site weights
``pack_site_weights`` [9,CO,C] bf16, rows weights ``pack_rows_weights``
[5,64,128] bf16 (lanes 60..63 zero), bias [CO] / [12] f32; K10 takes the experiments' operands as
they are: stat [B,2,C] f32 (a, c), w9 [9,C,CO] bf16; K11 w [5,5,12,128]
bf16 (HWIO). Each wrapper dispatches on the tensors'
device: CPU → the ``*_plain`` version, CUDA → the kernel or an error; no
fallback between the two. ``LAUNCHES[name]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from math import ceil

import torch
import torch.nn.functional as F

from ..models.s2d import pad_reflect_f2_4px
from .int8_sites import _check, _check_aligned, _ptr, _stream

_SOURCE = "bf16_sites.cu"
LAUNCHES = {"d2_site": 0, "d3_sum_site": 0, "c2_site_bf16": 0, "c3_site_bf16": 0, "d3_rows": 0,
            "fused_conv": 0, "c1_site": 0}
#: the f32-raw forms of K9a and K9e (float32), each counted under its own
#: name in ``F32_LAUNCHES``
F32_FORMS = {"d2_site": "d2_site_f32", "d3_rows": "d3_rows_f32"}
F32_LAUNCHES = dict.fromkeys(F32_FORMS.values(), 0)
D3_C, D3_LANES, D3_PAD, D3_OUT = 128, 60, 64, 12
#: K10's prologue forms, as the kernel numbers them
PROLOGUES = {"f32": 0, "none": 1, "bf16": 2}
FUSED_C, C1_IN, C1_OUT = 128, 12, 128
#: K11's tile on the card (``c1_wgmma_kernel``): C1_SEG pixels of one output
#: row; C1_BUFFERS tiles in flight; C1_CONSUMERS warpgroups on alternate
#: tiles; the ring's input rows, 5 for each tile in flight and for each
#: other warpgroup's unfinished tile before them
C1_SEG, C1_BUFFERS, C1_CONSUMERS = 64, 4, 2
C1_ROWS = 5 * (C1_BUFFERS + C1_CONSUMERS)
FUSED_TILE = (4, 32)   # K10's output tile on the card: rows x columns (128 pixels)
#: per site: (C, CO, stride, halo, output tile of a block: the [Σ, Σ²]
#: partials are per tile)
SITES = {"d2_site": (64, 128, 1, "edge", FUSED_TILE),
         "c2_site_bf16": (32, 64, 2, "reflect", (8, 16)),
         "c3_site_bf16": (64, 128, 2, "reflect", (4, 16))}
#: site_kernel_bf16's output tile by stride: the previous cores of K9a, K9c,
#: K9d and K10
PREV_TILE = {1: (8, 32), 2: (8, 16)}
#: K9c's and K9d's plane buffers in the ring of a block on the card
#: (``s2_mma_bf16_kernel``: one consumer and one producer warpgroup)
S2_BUFFERS = {"c2_site_bf16": 4, "c3_site_bf16": 2}
#: K9e's item on the card (``d3rows_wgmma_kernel``): one conv row over
#: D3_SEG output columns, its raw input D3_SEG + 4 staged pixels; the ring's
#: input buffers
D3_SEG, D3_BUFFERS = 64, 4


def pack_site_weights(w: torch.Tensor) -> torch.Tensor:
    """3×3 site weights [3,3,C,CO] (HWIO, any float dtype) → bf16 [9,CO,C]:
    tap-major, the input channels innermost (the MMA's B operand)."""
    kh, kw, c, co = w.shape
    assert (kh, kw) == (3, 3), w.shape
    return w.to(torch.bfloat16).reshape(9, c, co).permute(0, 2, 1).contiguous()


def pack_rows_weights(w_row: torch.Tensor) -> torch.Tensor:
    """deconv3's tap-packed weights [1,5,128,60] (any float dtype) → bf16
    [5,64,128], the 60 lanes zero-padded to 64."""
    assert tuple(w_row.shape) == (1, 5, D3_C, D3_LANES), w_row.shape
    w = F.pad(w_row[0].to(torch.bfloat16), (0, D3_PAD - D3_LANES))
    return w.permute(0, 2, 1).contiguous()


# ---------------------------------------------------------------------------
# plain versions (PyTorch ops; the CPU path and the card's yardstick)
# ---------------------------------------------------------------------------


def _activate(x: torch.Tensor, a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """bf16(max(f32(x)·a + c, 0)) with per-(image, channel) rows a, c [B,C]."""
    return torch.relu(x.float() * a[:, None, None, :] + c[:, None, None, :]).to(torch.bfloat16)


def _conv_f32(xa: torch.Tensor, w_oihw: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The f32 conv (VALID) of bf16 activations NHWC with bf16 weights."""
    return F.conv2d(xa.float().permute(0, 3, 1, 2), w_oihw.float(), stride=stride).permute(
        0, 2, 3, 1)


def site_bf16_plain(x, a, c, w, bias, *, stride: int, halo: str):
    """K9a/K9c/K9d's plain version → (bf16 raw [B,H/s,W/s,CO], f32 [B,2,CO]
    sums of the f32 conv results)."""
    mode = {"reflect": "reflect", "edge": "replicate"}[halo]
    xa = F.pad(_activate(x, a, c).permute(0, 3, 1, 2), (1, 1, 1, 1), mode=mode).permute(0, 2, 3, 1)
    co, cin = w.shape[1], w.shape[2]
    f = _conv_f32(xa, w.reshape(3, 3, co, cin).permute(2, 3, 0, 1), stride) + bias
    if stride == 2:  # an even size never reads the bottom/right pad
        f = f[:, :x.shape[1] // 2, :x.shape[2] // 2]
    fd = f.double()
    sums = torch.stack([fd.sum(dim=(1, 2)), fd.square().sum(dim=(1, 2))], dim=1).float()
    return f.to(torch.bfloat16), sums


def d2_site_plain(x, a, c, w, bias):
    return site_bf16_plain(x, a, c, w, bias, stride=1, halo="edge")


def d2_site_smem_bytes() -> int:
    """K9a's dynamic shared memory (``kDSmem``): 1,024 bytes of alignment
    slack, two buffers of a tile's input (6 × 34 pixels × 128 bytes) or,
    larger, its staged output (4 × 32 × 128 bf16), the nine taps' weights
    [128][64] bf16, the affine by tile parity, the bias, the warps' sums and
    the barriers."""
    (th, tw), cin, co = FUSED_TILE, 64, 128
    buf = max((th + 2) * (tw + 2) * cin * 2, th * tw * co * 2)
    return 1024 + 2 * buf + 9 * co * cin * 2 + 4 * (2 * 2 * cin + co + 8 * 2 * co) + 64


def d2_halo_tile(x: torch.Tensor, ty0: int, tx0: int) -> torch.Tensor:
    """The haloed input of K9a's 4 × 32 output tile at (ty0, tx0) of one
    image x [H,W,C], as the card builds it before the activation: the TMA
    box of rows ty0−1..ty0+4 and columns tx0−1..tx0+32, zero outside the
    image, then (``d2_patch``) each position of the image's one-pixel frame
    (row −1 or H, column −1 or W) the pixel of the nearest row and column
    inside → [6, 34, C]. Positions farther out stay zero: they feed only
    outputs past the image."""
    (th, tw), (H, W) = FUSED_TILE, x.shape[:2]
    tile = x.new_zeros((th + 2, tw + 2, x.shape[2]))
    for hr in range(th + 2):
        for hc in range(tw + 2):
            gy, gx = ty0 - 1 + hr, tx0 - 1 + hc
            if 0 <= gy < H and 0 <= gx < W:
                tile[hr, hc] = x[gy, gx]
    for hr in range(th + 2):
        for hc in range(tw + 2):
            gy, gx = ty0 - 1 + hr, tx0 - 1 + hc
            if -1 <= gy <= H and -1 <= gx <= W and not (0 <= gy < H and 0 <= gx < W):
                sy, sx = min(max(gy, 0), H - 1), min(max(gx, 0), W - 1)
                tile[hr, hc] = tile[sy - ty0 + 1, sx - tx0 + 1]
    return tile


def _s2_geometry(name: str) -> tuple:
    """(C, CO, TH, HR, HC) of K9c's or K9d's block: TH × 16 output tiles,
    their (2TH + 1) × 33 haloed input."""
    cin, co, _, _, (th, tw) = SITES[name]
    return cin, co, th, 2 * th + 1, 2 * tw + 1


def s2_site_smem_bytes(name: str) -> int:
    """K9c's or K9d's dynamic shared memory (``S2Bf16::bytes``): 1,024 bytes
    of slack that align what follows for ``wgmma`` and TMA, the nine taps'
    weights [9][CO][C] bf16, the ring's plane buffers of the haloed tile (2C
    bytes a pixel, in whole kilobytes; each holds its tile's staged outputs
    after the MMAs) and the bias."""
    cin, co, _, hr, hc = _s2_geometry(name)
    return 1024 + 9 * co * 2 * cin + S2_BUFFERS[name] * (-(-hr * hc * 2 * cin // 1024) * 1024) + \
        4 * co


def _plane_dims(hr: int, hc: int, pr: int, pc: int) -> tuple:
    return (hr + 1 - pr) // 2, (hc + 1 - pc) // 2


def _plane_off(hr: int, hc: int, pr: int, pc: int) -> int:
    """The first staged pixel of plane (pr, pc): planes (0, 0), (0, 1), (1, 0),
    (1, 1) in that order."""
    r0, c0 = _plane_dims(hr, hc, 0, 0)
    _, c1 = _plane_dims(hr, hc, 0, 1)
    rp, _ = _plane_dims(hr, hc, pr, 0)
    return (r0 * (c0 + c1) if pr else 0) + (rp * c0 if pc else 0)


def s2_plane_pixel(name: str, hr: int, hc: int) -> int:
    """The staged pixel of haloed tile pixel (hr, hc) (``S2Bf16::pixel``):
    pixel (hr/2, hc/2) of parity plane (hr%2, hc%2)."""
    _, _, _, HR, HC = _s2_geometry(name)
    return _plane_off(HR, HC, hr & 1, hc & 1) + (hr >> 1) * _plane_dims(HR, HC, 0, hc & 1)[1] + \
        (hc >> 1)


def s2_tap_pixel(name: str, r: int, c: int, dy: int, dx: int) -> int:
    """The staged pixel that the A row of output pixel (r, c) of a tile reads
    at tap (dy, dx), as the kernel addresses it: pixel (r + dy/2, c + dx/2)
    of plane (dy%2, dx%2)."""
    _, _, _, HR, HC = _s2_geometry(name)
    return _plane_off(HR, HC, dy & 1, dx & 1) + (r + (dy >> 1)) * \
        _plane_dims(HR, HC, 0, dx & 1)[1] + (dx >> 1) + c


def s2_swizzle(name: str, p: int, k: int) -> int:
    """The byte offset of 16-byte chunk k of staged row p (a pixel of the
    planes or a weight row, 2C bytes) under the core's XOR swizzle
    (``S2Bf16::swz``): chunk k ^ f(p), f(p) = (p / (8 / CH)) mod CH for CH
    = C / 8 chunks a row."""
    ch = SITES[name][0] // 8
    return p * 16 * ch + 16 * (k ^ ((p >> (1 if ch == 4 else 0)) & (ch - 1)))


def s2_halo_tile(name: str, x: torch.Tensor, ty0: int, tx0: int) -> torch.Tensor:
    """The raw haloed input of K9c's or K9d's output tile at (ty0, tx0) of one
    image x [H,W,C], as the card brings it in: input rows 2·ty0 − 1 ..
    2·ty0 + 2TH − 1 and columns 2·tx0 − 1 .. 2·tx0 + 31, each position from
    the pixel the reflect maps it to (row −1 is row 1), clamped into the
    image (positions past the image feed only outputs that are not stored)
    → [2TH + 1, 33, C]."""
    _, _, _, HR, HC = _s2_geometry(name)
    H, W = x.shape[:2]

    def src(i, n):
        i = -i if i < 0 else i
        i = 2 * n - 2 - i if i >= n else i
        return min(max(i, 0), n - 1)

    rows = [src(2 * ty0 - 1 + hr, H) for hr in range(HR)]
    cols = [src(2 * tx0 - 1 + hc, W) for hc in range(HC)]
    return x[rows][:, cols]


def s2_part_slots(name: str, B: int, H: int, W: int, sms: int) -> int:
    """The [Σ, Σ²] partials a K9c or K9d launch writes per image on x
    [B,H,W,C]: one per block and consumer warp (each block sums its tiles
    of an image in its consumer threads and writes zeros for an image it
    has no tile of)."""
    ty, tx = _s2_tiles(name, H, W)
    return 4 * min(sms, B * ty * tx)


def _s2_tiles(name: str, H: int, W: int) -> tuple:
    """(tile rows, tile columns) of K9c's or K9d's output grid on an H × W
    input."""
    _, _, (th, tw) = SITES[name][2:]
    return -(-(H // 2) // th), -(-(W // 2) // tw)


def s2_site_schedule(name: str, B: int, H: int, W: int, sms: int = 132) -> list:
    """K9c's or K9d's persistent walk on x [B,H,W,C]: per block, the (image,
    tile row, tile column) it takes, in order. Block k takes tiles k, k +
    blocks, ... of the B·tiles output tiles; blocks = min(SMs, B·tiles),
    one an SM."""
    ty, tx = _s2_tiles(name, H, W)
    total = B * ty * tx
    blocks = min(sms, total)
    return [[(t // (ty * tx), t % (ty * tx) // tx, t % tx) for t in range(k, total, blocks)]
            for k in range(blocks)]


def c2_site_bf16_plain(x, a, c, w, bias):
    return site_bf16_plain(x, a, c, w, bias, stride=2, halo="reflect")


c3_site_bf16_plain = c2_site_bf16_plain


def d3_rows_plain(x, a, c, w):
    """K9e's plain version → bf16 rows [B,H+4,W,60]."""
    xa = _activate(pad_reflect_f2_4px(x, 32), a, c)
    rows = _conv_f32(xa, w.permute(1, 2, 0)[:, :, None, :])  # OIHW [64,128,1,5]
    return rows[..., :D3_LANES].to(torch.bfloat16).contiguous()


def d3_rows_smem_bytes() -> int:
    """K9e's dynamic shared memory (``D3RowsW::bytes``): 128 bytes of
    alignment slack, the ring's input buffers of an item's 68 raw pixels ×
    256 bytes and two output buffers of its 64 × 60 bf16 lanes (the
    weights live in the consumers' registers)."""
    return 128 + D3_BUFFERS * (D3_SEG + 4) * 2 * D3_C + 2 * D3_SEG * D3_LANES * 2


def _reflect_phase(R: int, u: int, n: int) -> tuple:
    """Block R, phase u of a padded grid over n blocks → (source block,
    source phase): pixel 2R + u mirrored around the first or last pixel,
    clamped into the image (``reflect_phase``)."""
    px = 2 * R + u
    px = -px if px < 0 else px
    px = 4 * n - 2 - px if px >= 2 * n else px
    px = min(max(px, 0), 2 * n - 1)
    return px >> 1, px & 1


def d3_rows_source(H: int, W: int, r: int, x0: int, j: int, k: int) -> tuple:
    """Where K9e's producer reads 16-byte chunk k (0..15: channels 8k..8k+7,
    phase k // 4) of staged pixel j (0..67) of the item at conv row r (0..H+3)
    and segment column x0: (source block row, block column, first channel) of
    the raw x [H,W,128]. Block row r − 2 and column x0 − 2 + j of the
    reflect-padded grid, each phase through the 4-pixel reflect; inside a
    segment whose 68 columns lie in the image, the columns are taken as they
    are (the kernel computes their map only at the halo)."""
    u, v = k >> 3, (k >> 2) & 1
    sy, uu = _reflect_phase(r - 2, u, H)
    sx, vv = x0 - 2 + j, v
    if not (x0 >= 2 and x0 + D3_SEG + 2 <= W):
        sx, vv = _reflect_phase(sx, v, W)
    return sy, sx, (2 * uu + vv) * 32 + 8 * (k & 3)


def d3_rows_offset(j: int, k: int) -> int:
    """The byte offset of 16-byte chunk k of K9e's staged pixel j in an
    input buffer: the no-swizzle K-major layout [16 chunks][68 pixels][16
    bytes], chunk k at k·CK + 16j with CK = 68·16."""
    return k * (D3_SEG + 4) * 16 + 16 * j


def d3_rows_core_matrix(dx: int, kc: int, m: int, h: int) -> int:
    """Where the wgmma B descriptor of tap dx, k16 step kc reads core matrix
    (pixel block m of 8, k half h): its start address plus h·LBO (CK) plus
    m·SBO (128) — the 8 pixels dx + 8m .. + 7 of chunk 2kc + h, 128
    contiguous bytes."""
    ck = (D3_SEG + 4) * 16
    return (2 * kc * ck + 16 * dx) + h * ck + m * 128


def d3_rows_schedule(B: int, H: int, W: int, sms: int = 132) -> list:
    """K9e's persistent walk on x [B,H,W,128]: per block, the (image, conv
    row, segment) items it takes, in order. Items are numbered segments
    fastest, then the H + 4 conv rows, then images; block k takes items k,
    k + blocks, ...; blocks = min(SMs, items), one an SM."""
    segs, rows = -(-W // D3_SEG), H + 4
    total = B * rows * segs
    blocks = min(sms, total)
    return [[(i // segs // rows, i // segs % rows, i % segs) for i in range(k, total, blocks)]
            for k in range(blocks)]


def _d3_terms(rows: torch.Tensor) -> list:
    """The five f32 terms [B,H,W,12] that K9b adds, from rows [B,H+4,W,60]."""
    H = rows.shape[1] - 4
    return [rows[:, dy:dy + H, :, dy * D3_OUT:(dy + 1) * D3_OUT].float() for dy in range(5)]


def d3_sum_site_plain(x, a, c, w, bias):
    """K9b's plain version → bf16 [B,H,W,12]."""
    return (sum(_d3_terms(d3_rows_plain(x, a, c, w))) + bias).to(torch.bfloat16)


def d3_sum_scale_plain(x, a, c, w):
    """Per output of K9b, the largest magnitude among its five row terms
    [B,H,W,12] f32: the scale at which two versions of K9b can differ."""
    return torch.stack(_d3_terms(d3_rows_plain(x, a, c, w))).abs().amax(0)


def _prologue(x, stat, prologue: str):
    """K10's prologue on x [B,h,w,C] with stat [B,2,C] → bf16."""
    if prologue == "none":
        return x
    a, c = stat[:, 0], stat[:, 1]
    if prologue == "f32":
        return _activate(x, a, c)
    if prologue == "bf16":  # each bf16 op rounds (PyTorch's bf16 elementwise)
        ab, cb = (v.to(torch.bfloat16)[:, None, None, :] for v in (a, c))
        return torch.relu(x * ab + cb)
    raise ValueError(f"fused_conv: prologue {prologue!r} not in {tuple(PROLOGUES)}")


def fused_conv_plain(x_pad, stat, w9, cb, hw, *, prologue: str = "f32", stats: bool = True):
    """K10's plain version → (bf16 [B,H,W,CO], f32 [B,2,CO] sums of the f32
    conv results, or None without ``stats``)."""
    H, W = hw
    xa = _prologue(x_pad[:, :H + 2, :W + 2], stat, prologue)
    c, co = w9.shape[1], w9.shape[2]
    f = _conv_f32(xa, w9.reshape(3, 3, c, co).permute(3, 2, 0, 1)) + cb
    if not stats:
        return f.to(torch.bfloat16), None
    fd = f.double()
    sums = torch.stack([fd.sum(dim=(1, 2)), fd.square().sum(dim=(1, 2))], dim=1).float()
    return f.to(torch.bfloat16), sums


def c1_site_plain(y12, w, cb):
    """K11's plain version → bf16 [B,H,W,128] from y12 [B,H+4,W+4,12]."""
    return (_conv_f32(y12, w.permute(3, 2, 0, 1)) + cb).to(torch.bfloat16)


def c1_site_smem_bytes() -> int:
    """K11's dynamic shared memory (``C1W::bytes``): 1,024 bytes of slack
    that align what follows for ``wgmma`` and TMA, the five kernel rows'
    weights [128][64] bf16, two output buffers a consumer warpgroup of a
    tile's 64 × 128 bf16, the ring's C1_ROWS input rows (68 pixels × 24
    bytes and zeros, 1,664 bytes each) and the bias."""
    return 1024 + 5 * C1_OUT * 64 * 2 + 2 * C1_CONSUMERS * C1_SEG * C1_OUT * 2 + \
        C1_ROWS * 1664 + 4 * C1_OUT


def c1_k_source(k: int) -> int | None:
    """The element (dx · 12 + channel) of a kernel row's five packed taps
    that ``wgmma`` k index k (0..63) of that row stands for, or None (a zero
    weight): logical word L = k // 2 = 8kc + 4h + t is read from physical
    word 8t + 2kc + h (``c1_k_source`` in the source)."""
    word = k >> 1
    kc, h, t = word >> 3, (word >> 2) & 1, word & 3
    q = 2 * (8 * t + 2 * kc + h) + (k & 1)
    return q if q < 5 * C1_IN else None


def c1_fragment_word(p: int, kc: int, t: int, h: int) -> int:
    """The 32-bit word of a staged input row that A fragment half h (a0/a1:
    0, a2/a3: 1) of lane t at k16 step kc reads for tile pixel p: word 6p +
    8t + 2kc + h (pixel p's 60 values start at element 12p)."""
    return 6 * p + 8 * t + 2 * kc + h


def c1_schedule(B: int, H: int, W: int, sms: int = 132) -> list:
    """K11's persistent walk: per block, its (image, segment, output row)
    tiles in order. Tiles are numbered output rows fastest, then the
    ceil(W/64) segments, then images; block k of G = min(SMs, tiles) takes
    the contiguous run [k·T/G, (k+1)·T/G)."""
    segs = -(-W // C1_SEG)
    total = B * segs * H
    blocks = min(sms, total)
    runs = [range(k * total // blocks, (k + 1) * total // blocks) for k in range(blocks)]
    return [[(t // H // segs, t // H % segs, t % H) for t in run] for run in runs]


def c1_row_slots(walk: list) -> list:
    """The ring slots (of C1_ROWS) that a block's tiles read for kernel rows
    dy = 0..4, as producer and consumers both count (``C1Tile``): a tile at
    the start of the walk or of a strip (output row 0) lands five rows, any
    other one one, and a tile reads the five rows landed last."""
    out, ld = [], -1
    for j, (_, _, y) in enumerate(walk):
        ld += 5 if j == 0 or y == 0 else 1
        out.append([(ld - 4 + dy) % C1_ROWS for dy in range(5)])
    return out


def bf16_ulp_error(out: torch.Tensor, ref: torch.Tensor, *, floor: float = 2.0 ** -8,
                   scale: torch.Tensor | None = None) -> tuple[float, float]:
    """How far two versions of a site are apart: (the largest |out − ref| in
    bf16 ulps, the share of equal elements). Versions differ by the order of
    their f32 accumulation, an error that does not shrink with the element,
    so an element's ulp is taken at no less than ``floor`` times the largest
    magnitude of ``ref`` (and no less than ``scale``, where given)."""
    o, r = out.float(), ref.float()
    big = r.abs().clamp_min(float(r.abs().max()) * floor)
    if scale is not None:
        big = torch.maximum(big, scale)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return float(((o - r).abs() / ulp).max()), float((o == r).float().mean())


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


@functools.cache
def _lib():
    from ._build import load_library

    lib = load_library(_SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    site = [P] * 8 + [I] * 3 + [P]
    sigs = {"d2_site_launch": site, "d2_site_prev_launch": site, "d2_wgmma_smem_bytes": [],
            "d2_site_f32_launch": site, "d3_rows_f32_launch": [P] * 5 + [I] * 3 + [P],
            "d3_rows_f32_smem_bytes": [],
            "c2_site_bf16_launch": site, "c3_site_bf16_launch": site,
            "c2_site_bf16_prev_launch": site, "c3_site_bf16_prev_launch": site,
            "s2_bf16_smem_bytes": [I],
            "d3_rows_launch": [P] * 5 + [I] * 3 + [P],
            "d3_rows_prev_launch": [P] * 5 + [I] * 3 + [P], "d3_rows_smem_bytes": [],
            "d3_sum_site_launch": [P] * 6 + [I] * 3 + [P],
            "d3_sum_site_prev_launch": [P] * 6 + [I] * 3 + [P],
            "d3sum_mma_smem_bytes": [],
            "fused_conv_launch": [P] * 7 + [I] * 8 + [P],
            "fused_conv_prev_launch": [P] * 7 + [I] * 8 + [P],
            "c1_site_launch": [P] * 4 + [I] * 3 + [P],
            "c1_site_prev_launch": [P] * 4 + [I] * 3 + [P], "c1_wgmma_smem_bytes": [],
            "bf16_occupancy": [I, P, P]}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _run(kernel, fn, *args, count=True, f32=None):
    """Launch; count it in ``LAUNCHES[kernel]``, or in ``F32_LAUNCHES[f32]``
    for an f32 form."""
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    if count:
        (F32_LAUNCHES if f32 else LAUNCHES)[f32 or kernel] += 1


def _f32_form(kernel: str, x: torch.Tensor, prev: bool = False) -> str | None:
    """The name ``kernel``'s f32 form counts under where x is float32, None
    where it is bf16; other dtypes, and an f32 x for a kernel or core
    without that form, raise."""
    if x.dtype == torch.bfloat16:
        return None
    if x.dtype != torch.float32:
        raise TypeError(f"{kernel}: x must be bf16 or f32, got {x.dtype}")
    if kernel not in F32_FORMS or prev:
        raise TypeError(f"{kernel}{'_prev' if prev else ''}: no form with an f32 x "
                        f"(built: {sorted(F32_FORMS)}, on the current cores)")
    return F32_FORMS[kernel]


def _site(k, x, a, c, w, bias, prev=False):
    cin, co, stride, halo, (th, tw) = SITES[k]
    if x.device.type == "cpu" and not prev:
        return site_bf16_plain(x, a, c, w, bias, stride=stride, halo=halo)
    if prev:
        th, tw = PREV_TILE[stride]
    dev = x.device
    if dev.type != "cuda":
        raise NotImplementedError(f"{k}: no kernel for device {dev}")
    B, H, W, C = x.shape
    if C != cin:
        raise ValueError(f"{k}: C={C}, the kernel is built for C={cin}")
    if H < 2 or W < 2 or (stride == 2 and (H % 2 or W % 2)):
        raise ValueError(f"{k}: H={H}, W={W}: needs at least 2 pixels"
                         + (" and an even size" if stride == 2 else ""))
    f32 = _f32_form(k, x, prev)
    _check(k, "x", x, torch.float32 if f32 else torch.bfloat16, (B, H, W, C), dev)
    for name, t in (("a", a), ("c", c)):
        _check(k, name, t, torch.float32, (B, C), dev)
    _check(k, "weights", w, torch.bfloat16, (9, co, C), dev)
    _check(k, "bias", bias, torch.float32, (co,), dev)
    if not prev:  # read by TMA (K9a) or in 16-byte pieces by cp.async (K9c, K9d)
        for name, t in (("x", x), ("weights", w)):
            _check_aligned(k, name, t)
    ho, wo = H // stride, W // stride
    out = torch.empty((B, ho, wo, co), dtype=torch.bfloat16, device=dev)
    slots = ceil(ho / th) * ceil(wo / tw)  # a partial a tile, or a block's and row warp's
    if k in S2_BUFFERS and not prev:
        slots = s2_part_slots(k, B, H, W, torch.cuda.get_device_properties(dev).multi_processor_count)
    part = torch.empty((B, slots, 2, co), dtype=torch.float32, device=dev)
    sums = torch.empty((B, 2, co), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        fn = f"{k}_prev_launch" if prev else f"{k}_f32_launch" if f32 else f"{k}_launch"
        _run(k, getattr(_lib(), fn), x.data_ptr(),
             a.data_ptr(), c.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
             part.data_ptr(), sums.data_ptr(), B, H, W, _stream(dev), count=not prev, f32=f32)
    return out, sums


def d2_site(x, a, c, w, bias):
    """K9a: deconv2 in its phase form. x: deconv1's raw output on the 2×
    grid [B,H,W,64] (bf16, or f32 under float32); a, c: the in4 affine; w:
    ``pack_site_weights`` of the phase weights [3,3,64,128]; bias [128] (the
    conv bias tiled over the 4 phases). Returns (bf16 raw [B,H,W,128], f32 [B,2,128] sums of the f32
    results over H, W; the caller folds the 4 phases). On the card:
    ``d2_wgmma_kernel`` (x and w 16-byte aligned)."""
    return _site("d2_site", x, a, c, w, bias)


def d2_site_prev(x, a, c, w, bias):
    """K9a on its previous core (``site_kernel_bf16<64, 1>``), CUDA tensors
    only: ``chip_smoke.py`` times it beside ``d2_site``. Nothing on the main
    path calls it, and it counts no launch."""
    return _site("d2_site", x, a, c, w, bias, prev=True)


def c2_site_bf16(x, a, c, w, bias):
    """K9c: conv2 on conv1's raw output x [B,H,W,32] (H, W even) with the in1
    affine → (bf16 raw [B,H/2,W/2,64], f32 [B,2,64] sums). On the card:
    ``s2_mma_bf16_kernel`` (x and w 16-byte aligned)."""
    return _site("c2_site_bf16", x, a, c, w, bias)


def c2_site_bf16_prev(x, a, c, w, bias):
    """K9c on its previous core (``site_kernel_bf16<32, 2>``), CUDA tensors
    only: ``chip_smoke.py`` times it beside ``c2_site_bf16``. Nothing on the
    main path calls it, and it counts no launch."""
    return _site("c2_site_bf16", x, a, c, w, bias, prev=True)


def c3_site_bf16(x, a, c, w, bias):
    """K9d: conv3 on conv2's raw output x [B,H,W,64] with the in2 affine →
    (bf16 raw [B,H/2,W/2,128], f32 [B,2,128] sums). On the card:
    ``s2_mma_bf16_kernel`` (x and w 16-byte aligned)."""
    return _site("c3_site_bf16", x, a, c, w, bias)


def c3_site_bf16_prev(x, a, c, w, bias):
    """K9d on its previous core (``site_kernel_bf16<64, 2>``), CUDA tensors
    only, counting no launch: for timing the two cores in turns."""
    return _site("c3_site_bf16", x, a, c, w, bias, prev=True)


def _check_rows(k, x, a, c, w, f32=False):
    dev = x.device
    if dev.type != "cuda":
        raise NotImplementedError(f"{k}: no kernel for device {dev}")
    B, H, W, C = x.shape
    if C != D3_C:
        raise ValueError(f"{k}: C={C}, the kernel is built for C={D3_C}")
    if H < 3 or W < 3:
        raise ValueError(f"{k}: H={H}, W={W}: the 4-pixel reflect halo needs at least 3 blocks")
    _check(k, "x", x, torch.float32 if f32 else torch.bfloat16, (B, H, W, D3_C), dev)
    for name, t in (("a", a), ("c", c)):
        _check(k, name, t, torch.float32, (B, D3_C), dev)
    _check(k, "weights", w, torch.bfloat16, (5, D3_PAD, D3_C), dev)
    return dev, B, H, W


def d3_rows(x, a, c, w):
    """K9e: the d2 raw x [B,H,W,128] (4 phases × 32; bf16, or f32 under
    float32) with the in5 affine
    (a, c [B,128], tiled over the phases) → the tap-packed 1×5 conv's bf16
    rows [B,H+4,W,60] on the reflect-padded grid (no bias; row R+2 is block
    row R of the unpadded grid). On the card: ``d3rows_wgmma_kernel`` (x and
    w 16-byte aligned)."""
    if x.device.type == "cpu":
        return d3_rows_plain(x, a, c, w)
    return _d3_rows(x, a, c, w, prev=False)


def d3_rows_prev(x, a, c, w):
    """K9e on its previous core (``rows_kernel_bf16<false>``), CUDA tensors
    only: ``chip_smoke.py`` times it beside ``d3_rows``. Nothing on the main
    path calls it, and it counts no launch."""
    return _d3_rows(x, a, c, w, prev=True)


def _d3_rows(x, a, c, w, prev):
    k = "d3_rows"
    f32 = _f32_form(k, x, prev) if x.device.type == "cuda" else None
    dev, B, H, W = _check_rows(k, x, a, c, w, f32)
    if not prev:  # read 16 bytes at a time by cp.async
        for name, t in (("x", x), ("weights", w)):
            _check_aligned(k, name, t)
    out = torch.empty((B, H + 4, W, D3_LANES), dtype=torch.bfloat16, device=dev)
    fn = (_lib().d3_rows_prev_launch if prev else
          _lib().d3_rows_f32_launch if f32 else _lib().d3_rows_launch)
    with torch.cuda.device(dev):
        _run(k, fn, x.data_ptr(), a.data_ptr(), c.data_ptr(), w.data_ptr(), out.data_ptr(), B,
             H, W, _stream(dev), count=not prev, f32=f32)
    return out


def d3_sum_site(x, a, c, w, bias):
    """K9b: as K9e, then the 5-row dy-sum in f32 and the bias [12] → deconv3's
    block output bf16 [B,H,W,12]. On the card: the bf16 tensor cores, warps
    walking 16-column strips down the image (x 16-byte aligned)."""
    if x.device.type == "cpu":
        return d3_sum_site_plain(x, a, c, w, bias)
    return _d3_sum_site("d3_sum_site_launch", True, x, a, c, w, bias)


def d3_sum_site_prev(x, a, c, w, bias):
    """K9b on its previous core (``rows_kernel_bf16``), CUDA tensors only:
    ``chip_smoke.py`` times it beside ``d3_sum_site``. Nothing on the main
    path calls it, and it counts no launch."""
    return _d3_sum_site("d3_sum_site_prev_launch", False, x, a, c, w, bias)


def _d3_sum_site(fn, count, x, a, c, w, bias):
    k = "d3_sum_site"
    dev, B, H, W = _check_rows(k, x, a, c, w)
    _check(k, "bias", bias, torch.float32, (D3_OUT,), dev)
    if count:
        _check_aligned(k, "x", x)
    out = torch.empty((B, H, W, D3_OUT), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        _run(k, getattr(_lib(), fn), x.data_ptr(), a.data_ptr(), c.data_ptr(), w.data_ptr(),
             bias.data_ptr(), out.data_ptr(), B, H, W, _stream(dev), count=count)
    return out


def fused_conv(x_pad, stat, w9, cb, hw, *, prologue: str = "f32", stats: bool = True):
    """K10: the experiments' fused res-block site. x_pad [B,Hp,Wp,128] bf16
    with Hp ≥ H+2, Wp ≥ W+2 for the output grid ``hw`` = (H, W), read as
    given (its halo is whatever the caller padded; the prologue applies to
    it too); stat [B,2,128] f32 (a, c); w9 [9,128,CO] bf16 (tap, c, co); cb
    [CO] f32. Returns (bf16 [B,H,W,CO], f32 [B,2,CO] [Σ, Σ²] of the f32
    results, or None with ``stats=False``). On the card CO = 128
    (``fused_wgmma_kernel``: tiles of ``FUSED_TILE`` output pixels on all
    128 channels)."""
    if prologue not in PROLOGUES:
        raise ValueError(f"fused_conv: prologue {prologue!r} not in {tuple(PROLOGUES)}")
    if x_pad.device.type == "cpu":
        return fused_conv_plain(x_pad, stat, w9, cb, hw, prologue=prologue, stats=stats)
    return _fused_conv(x_pad, stat, w9, cb, hw, prologue, stats, prev=False)


def fused_conv_prev(x_pad, stat, w9, cb, hw, *, prologue: str = "f32", stats: bool = True):
    """``fused_conv`` on K10's previous core (``site_kernel_bf16<128, 1,
    true>``, 8 × 32 tiles on 64 channels), CUDA tensors only, counting no
    launch: for timing the two cores in turns."""
    if prologue not in PROLOGUES:
        raise ValueError(f"fused_conv: prologue {prologue!r} not in {tuple(PROLOGUES)}")
    return _fused_conv(x_pad, stat, w9, cb, hw, prologue, stats, prev=True)


def _fused_conv(x_pad, stat, w9, cb, hw, prologue, stats, prev):
    k, dev = "fused_conv", x_pad.device
    if dev.type != "cuda":
        raise NotImplementedError(f"{k}: no kernel for device {dev}")
    B, Hp, Wp, C = x_pad.shape
    H, W = hw
    if C != FUSED_C:
        raise ValueError(f"{k}: C={C}, the kernel is built for C={FUSED_C}")
    if not (0 < H <= Hp - 2 and 0 < W <= Wp - 2):
        raise ValueError(f"{k}: output {H}x{W} needs x_pad of at least {H + 2}x{W + 2}, "
                         f"got {Hp}x{Wp}")
    co = w9.shape[-1]
    if prev and co % 64:
        raise ValueError(f"{k}: CO={co} is not a multiple of 64")
    if not prev and co != FUSED_C:
        raise ValueError(f"{k}: CO={co}, the kernel is built for CO={FUSED_C}")
    _check(k, "x_pad", x_pad, torch.bfloat16, (B, Hp, Wp, C), dev)
    _check(k, "stat", stat, torch.float32, (B, 2, C), dev)
    _check(k, "weights", w9, torch.bfloat16, (9, C, co), dev)
    _check(k, "bias", cb, torch.float32, (co,), dev)
    for name, t in (("x_pad", x_pad), ("weights", w9)):
        _check_aligned(k, name, t)
    out = torch.empty((B, H, W, co), dtype=torch.bfloat16, device=dev)
    part = sums = None
    if stats:
        th, tw = PREV_TILE[1] if prev else FUSED_TILE
        part = torch.empty((B, ceil(H / th) * ceil(W / tw), 2, co), dtype=torch.float32,
                           device=dev)
        sums = torch.empty((B, 2, co), dtype=torch.float32, device=dev)
    fn = _lib().fused_conv_prev_launch if prev else _lib().fused_conv_launch
    with torch.cuda.device(dev):
        _run(k, fn, x_pad.data_ptr(), stat.data_ptr(), w9.data_ptr(), cb.data_ptr(),
             out.data_ptr(), _ptr(part), _ptr(sums), B, Hp, Wp, H, W, co, PROLOGUES[prologue],
             int(stats), _stream(dev), count=not prev)
    return out, sums


def c1_site(y12, w, cb):
    """K11: Johnson's conv1 as the f=2 block conv. y12 [B,H+4,W+4,12] bf16
    (the space-to-depth image, phase-reflect-padded by two blocks a side);
    w [5,5,12,128] bf16 (``scatter_k9_f2`` of the 9×9 3→32 weights); cb
    [128] f32 → bf16(Σ y12·w in f32 + cb) [B,H,W,128]. On the card:
    ``c1_wgmma_kernel`` (y12 16-byte aligned)."""
    if y12.device.type == "cpu":
        return c1_site_plain(y12, w, cb)
    return _c1_site(y12, w, cb, prev=False)


def c1_site_prev(y12, w, cb):
    """K11 on its previous core (``c1_kernel``), CUDA tensors only:
    ``chip_smoke.py`` times it beside ``c1_site``. Nothing on the main path
    calls it, and it counts no launch."""
    return _c1_site(y12, w, cb, prev=True)


def _c1_site(y12, w, cb, prev):
    k, dev = "c1_site", y12.device
    if dev.type != "cuda":
        raise NotImplementedError(f"{k}: no kernel for device {dev}")
    B, Hp, Wp, C = y12.shape
    if C != C1_IN or Hp < 5 or Wp < 5:
        raise ValueError(f"{k}: y12 {tuple(y12.shape)}: needs 12 channels and at least 5x5")
    _check(k, "y12", y12, torch.bfloat16, (B, Hp, Wp, C1_IN), dev)
    _check(k, "weights", w, torch.bfloat16, (5, 5, C1_IN, C1_OUT), dev)
    _check(k, "bias", cb, torch.float32, (C1_OUT,), dev)
    _check_aligned(k, "y12", y12)
    out = torch.empty((B, Hp - 4, Wp - 4, C1_OUT), dtype=torch.bfloat16, device=dev)
    fn = _lib().c1_site_prev_launch if prev else _lib().c1_site_launch
    with torch.cuda.device(dev):
        _run(k, fn, y12.data_ptr(), w.data_ptr(), cb.data_ptr(), out.data_ptr(), B, Hp - 4,
             Wp - 4, _stream(dev), count=not prev)
    return out


def occupancy() -> dict:
    """{kernel: (resident blocks per SM, dynamic shared memory bytes)} of
    K10 (f32 prologue, statistics), K11 and their previous cores on the
    current card."""
    out = {}
    for which, name in enumerate(("fused_conv", "c1_site", "fused_conv_prev", "c1_site_prev")):
        blocks, smem = ctypes.c_int(), ctypes.c_int()
        rc = _lib().bf16_occupancy(which, ctypes.byref(blocks), ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError(f"occupancy query of {name} failed: CUDA error {rc}")
        out[name] = (blocks.value, smem.value)
    return out
