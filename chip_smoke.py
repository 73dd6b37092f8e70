#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and nvcc. In
order, and any failed phase exits non-zero:

1. require CUDA and the port's package beside this file (imported first:
   elsewhere the script stops there);
2. print the card's name and power limit (nvidia-smi);
3. build K1 (``csrc/dis_iter.cu``), K2–K8b (``csrc/int8_sites.cu``),
   K9a–K11 (``csrc/bf16_sites.cu``) and K12–K13 (``csrc/int8_probes.cu``),
   one nvcc each, started together, and
   print ptxas' registers, spills and warnings of every kernel, and the
   dynamic shared memory of the tensor-core cores (K2–K5's ``mma_kernel``,
   K8a's and K8b's ``mma_s2_kernel``, K6's ``d3s8_mma_kernel``, K7's
   ``d3rows_mma_kernel``, K9a's ``d2_wgmma_kernel``, K9b's
   ``d3sum_mma_kernel``, K9c's and K9d's ``s2_mma_bf16_kernel``, K9e's
   ``d3rows_wgmma_kernel``, K10's ``fused_wgmma_kernel``, K11's
   ``c1_wgmma_kernel``, K12's ``shift_wgmma_kernel``) and of K1's
   ``dis_iter_kernel``;
4. hold K1 against its plain PyTorch version, and bit for bit against its
   previous core (``dis_iter_prev``), at the four DIS pyramid levels of the
   1080p slice (8 frame pairs, flow at half resolution), two launches
   bit-identical,
   and time the three level by level in turns, with the time of one
   Gauss–Newton step (the kernel at 0 iterations beside 16);
5. hold K2–K8b against their plain versions at the int8 sites' 1080p B=8
   shapes (res 270×480 128→128; d1 270×480 128→256; d2 540×960 64→128;
   K3 also with YAFF, with the s8 emit at floor −127 and as the s8 decoder's
   d1/d2; c2 1080×1920 32→64 and c3 540×960 64→128 at stride 2; deconv3's
   rows 540×960 128→60 and its s8 form →12; K2 and K3 also in the NST_Train
   chain's zero-halo form at its res grid 290×504 with the content width
   sw = 500, K3 with the frozen affine and residual; K4 (floors −127 and 0)
   and K5 (floor −127) in the Torch7 chain's zero-halo form at its res grid
   270×480 128→128, then timed in turns against their reflect forms on the
   same inputs): s8 codes and bf16 outputs
   bit-identical, sums within 1e-5; time each beside its plain version and
   the cuDNN bf16 conv it stands for (3×3 of the same shape; the stride-2
   c2/c3; the 9×9 32→3 deconv3 at 1080p, whose cuDNN kernels are named);
   K2–K8b also beside their previous ``__dp4a`` design (``*_prev``,
   held to the same outputs; K3 and K4 at the Johnson and NST widths, the
   others at every case), in turns: plain, kernel, previous, kernel,
   previous, plain, and two launches of each bit-identical;
   then K9a–K9e, the bf16 fused sites, at their 1080p B=8 shapes (d2 540×960
   64→128; c2 1080×1920 32→64 and c3 540×960 64→128 at stride 2; deconv3's
   rows 540×960 128→60 on the reflect-padded grid and their 5-row sum →12):
   two launches bit-identical, bf16 outputs within 1 bf16 ulp of the plain
   version everywhere (an ulp taken at no less than 2^-8 of the tensor's
   largest magnitude; the 5-row sum: within 2 ulp of its largest term) and
   equal on ≥ 99%, sums within 1e-5; timed like the int8 sites (K9a–K9e
   also beside their previous designs, ``d2_site_prev``,
   ``d3_sum_site_prev``, ``c2_site_bf16_prev``, ``c3_site_bf16_prev`` and
   ``d3_rows_prev``,
   each held to the same bounds against the plain version and against each
   other); then K7 and K9a at ragged shapes (W off the 32-column strip and
   tile, H below the 8-row tile, B = 1 and 3) against their plain versions
   and previous cores (K7 bit for bit, K9a within the K9 bounds, two
   launches bit-identical), and K9c and K9d likewise (outputs off the
   16-column tile and the 8- and 4-row tiles, a 1 × 1 output), and K9e
   (an odd W, widths off the 64-column segment) and K1 (tails of 1–3
   patches in the last warp, a partial block) likewise, and K11 (widths off
   the 64-pixel tile, an odd W + 4, H below a strip, B = 1 and 3, a 1 × 1
   output; within the K9 bounds of its plain version and previous core)
   and K13 (ragged widths, C = 8, 64 and 128, P1 and P2: bit-identical to
   its plain version and previous core); then K2
   and K3 at a ragged sw (29 of 32, 36 of 40) at small shapes: bit-identical
   to their plain versions, two launches bit-identical, the masked columns'
   codes 0; then each of the port's experiment entry points
   (``neuralstyletransferv1_torch/experiments/``: mk1, mk2, mk3, mk5, mk7
   on K9e, mk13) once at its script's full shape, counts zeroed before and
   read after (K10 and K11 must have been launched): K10 (``fused_conv``,
   the fused res-block site; mk5 runs its six forms, prologue f32 / none /
   bf16 × statistics on / off) at 270×480 128→128 on mk1's padded
   (B, H+2, W+8, C) buffer, and K11 (``c1_site``, conv1 as the f=2 block
   conv) at [8, 544, 964, 12] → [8, 540, 960, 128] with the repository's
   Johnson conv1, held against their plain versions like K9 (K11 also
   against its previous core ``c1_site_prev``) and timed in turns beside
   the cuDNN conv alone and their previous cores (``prev_ms``), for K10 the
   three-pass path (prologue, conv, statistics) eager and under
   ``torch.compile``, for K11 the pixel conv1 (NCHW and channels-last);
   then the int8 probes' entry
   points (mk20, mk21, mk27, mk28, mk31): K12 (``shift_dot``, the shifted
   dot over flat rows) in every built form — mk20's s8 → s32 and bf16 → f32
   dot [16384, 512] × [512, 256], the 8-row-strip 9-tap dot [8, 274, 488,
   128] → [8, 272, 488, 128] int8 (quantize ·16) and bf16 (mk20's probe 3,
   mk21's tap9, k384 on regrouped weights, noq on s8 input), mk27's six
   shifted dots over G = 32 slices [32, 8256, 128] → [32, 8192, 128] (s8 at
   offsets r and 32r, bf16, the saturating cast); K13 (``pad_inject``,
   mk28's P1 pad and P2 quantize + inject on one [1, 8, 480, 128] strip,
   timed with ``F.pad`` and mk28's P5 by CUDA graph replay, beside K13's
   launch floor (B = R = 1, W0 = 3, C = 8) in the same turns, and at the
   res site's input [8, 270, 480, 128] → 488 by CUDA events; each also on
   its previous core ``pad_inject_prev``, bit for bit);
   K4's new forms at mk31's [16, 270, 480, 128] (``prologue="cast"``, v1;
   ``stats=False``, v2 and mk28's P5), counts zeroed around them (K12, K13
   and both K4 forms must launch): the integer-valued outputs bit-identical
   to the plain versions, the bf16 strips within 1 ulp on ≥ 99%, mk20's f32
   dot within 1e-5·Σ|ab|, mk28's own numpy asserts on the card's outputs;
   timed in turns beside their plain versions, K12's previous core
   (``prev_ms``; the flat forms by CUDA graph replay), the library call
   where one computes the same function (``torch._int_mm``, ``torch.mm``,
   ``F.pad``) and the yardsticks (the cuDNN bf16 3×3 conv; mk27's im2col
   products);
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
8. the NST_Train slot: a full-width net (3→32→64→128, 5 res blocks,
   128→64→32→3) from a seed, saved in the reference key layout to a
   temporary ``.pth``; its ``int8_static`` res chain on one 1080p frame,
   card vs CPU, bit-identical; then the same 1080p B=8 flow-EMA slice over
   3 batches under bf16, ``bf16_static``, ``int8`` and ``int8_static`` (the
   adopted ``nst_static`` set: 5 × K2 + 5 × K3 a batch, no site kernel in
   the others), with exact launch counts; each quantized stylize within the
   1e-2 MAE gate of bf16 (int8_static: of bf16_static) on seeded
   uniform-noise frames, as the JAX tests hold it, and within 5e-2 on the
   slice's frames; then the ReCoNet slots (IN and FRN) the same way; then
   the Torch7 slots: full-width eccv16 nets (3→32→64→128, 5 res blocks,
   transposed convs 128→64→32, 9×9 →3, tanh·150), BN-folded and
   instance-norm, from the seed, written to temporary ``.t7`` files by this
   script's own writer (``write_t7``); the BN graph's res chain forced onto
   ``res_i8`` (6 × K4 + 4 × K5, zero halo) card vs CPU bit for bit on one
   1080p frame; the slice under IN bf16, ``bf16_static``, ``int8`` (the
   adopted ``t7``: 6 × K4 + 4 × K5 a batch) and ``int8_static`` (the
   folded graph on ``t7_bn`` = []: no site kernel), BN bf16 and ``int8``
   (no site kernel), held as NST's;
9. the CLI ``main()`` end to end on synthesized 1080p mp4s (OpenCV
   required): the streamed batched path (``--frame_batch 8``; then a
   ReCoNet FRN slot and a ``.t7`` slot at ``--quantize int8``); the default
   invocation (no ``--device``, no ``--frame_batch``: the per-frame f32
   loop), without and with ``--flow_ema``, checking the encoded frame count
   and K1's launches, and timing the per-frame loop; the same with
   ``--flow_ema`` on a 256×448 crop against ``--device cpu`` (MAE ≤ 1e-3);
   the single-image mode; and ``--stream off --frame_batch 8`` (extract →
   batches over frame files → assemble).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --profile

instead profiles one steady 1080p B=8 batch of each slice (plain bf16,
``bf16_static``, ``int8_static``, ``int8``, the two under sets A and B, the
two bf16 fused-site sets, the four NST_Train, six ReCoNet and six Torch7
slices) with
torch.profiler and prints where its device time goes, grouped by kind of
kernel (PERF.md section 5).

    python3 chip_smoke.py --phases

instead builds the tensor-core cores (K2–K8b; K9a–K9e; K10, K11, K12) with
``-DMMA_PHASE_CLOCKS`` and prints, for each of their 1080p B=8 cases (K12:
the probes' shapes; K11: mk13's), the share of each phase of the tile loop
(K6, K7, K9b: of the row loop) in the clock of every block's thread 0.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from neuralstyletransferv1_torch.experiments._bench import (
    BF16_EQUAL_SHARE, HBM_BYTES_PER_S, PEAK_BF16_OPS, PEAK_F32_OPS, PEAK_INT8_OPS, SUM_TOL,
    cuda_ms)

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

# the int8 sites of the 1080p B=8 slice: (B, H, W, C, CO, halo); the c2/c3
# sites are stride 2 (H, W are their input's), d3 is deconv3's rows conv
SITE_SHAPES = {"res": (B, H // 4, W // 4, 128, 128, "reflect"),
               "d1": (B, H // 4, W // 4, 128, 256, "edge"),
               "d2": (B, H // 2, W // 2, 64, 128, "edge"),
               "c2": (B, H, W, 32, 64, "reflect"),
               "c3": (B, H // 2, W // 2, 64, 128, "reflect"),
               "d3": (B, H // 2, W // 2, 128, 64, None),
               # the NST_Train res grid: the frame reflect-padded by 40, /4
               # (290 × 500), its width zero-padded to %8 with sw = 500
               "nst": (B, (H + 80) // 4, ((W + 80) // 4 + 7) // 8 * 8, 128, 128, "zero"),
               # ReCoNet: its res grid at 192 channels, d1 192 -> 4·96 at the
               # same grid, d2 96 -> 4·48 at twice it (1080 % 8 = 0, 1920 % 32
               # = 0: the int8 modes do not pad the frame)
               "reco_res": (B, H // 4, W // 4, 192, 192, "reflect"),
               "reco_d1": (B, H // 4, W // 4, 192, 384, "edge"),
               "reco_d2": (B, H // 2, W // 2, 96, 192, "edge"),
               # the Torch7 res grid (zero padding; 1080 % 8 = 0, 1920 % 32 = 0:
               # the int8 modes do not pad the frame)
               "t7": (B, H // 4, W // 4, 128, 128, "zero")}
SITE_SW = {"nst": (W + 80) // 4}
_SITES_I8 = "neuralstyletransferv1_tpu/models/s2d2_sites_i8.py"
# K2-K8b: the (shape, form) cases each runs on the main path, and the TPU
# kernel it replaces. K3's forms: "aff_add" (frozen affine + residual),
# "yaff" (+ the raw residual's frozen affine and ReLU), "emit" (+ the s8 emit
# at floor -127: the bridge into d1), "s8out" (the s8 decoder's d1/d2).
# ReCoNet's forms: K2 "in" (emit floor 0) and "frn" (the tau floor, qlo -127);
# K4 "tau" (the TLU floor, floor -127); K5 "relu" / "tau" (the post-add
# activation). Torch7's zero-halo forms: K4 "a" (floor -127) and "b" (floor 0,
# the IN affine), K5 "a" (floor -127)
INT8_KERNELS = {
    "res_site_s8o": ((("res", ""), ("nst", ""), ("reco_res", "in"), ("reco_res", "frn")),
                     f"{_SITES_I8}:507"),
    "site_s8": ((("res", "aff_add"), ("res", "yaff"), ("res", "emit"), ("d1", "s8out"),
                 ("d2", "s8out"), ("nst", "aff_add"), ("reco_res", "aff_add")),
                f"{_SITES_I8}:670"),
    "res_site": ((("res", ""), ("d1", ""), ("d2", ""), ("reco_res", ""), ("reco_res", "tau"),
                  ("reco_d1", ""), ("reco_d2", "tau"), ("t7", "a"), ("t7", "b")),
                 f"{_SITES_I8}:139"),
    "res_site_skip": ((("res", ""), ("d1", ""), ("reco_res", "relu"), ("reco_res", "tau"),
                       ("t7", "a")), f"{_SITES_I8}:299"),
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
# the experiments' kernels: (source, the TPU kernel each replaces); K10 and
# K11 (bf16), K12 and K13 (the int8 probes) and K4's two forms of the int8
# probes; the entry points run once each (mk5's default covers K10's six
# forms, mk20 + mk21 + mk27 K12's six, mk28 K13's two, mk31 K4's two new)
_BF16_SRC = "neuralstyletransferv1_torch/csrc/bf16_sites.cu"
_PROBE_SRC = "neuralstyletransferv1_torch/csrc/int8_probes.cu"
_INT8_SRC = "neuralstyletransferv1_torch/csrc/int8_sites.cu"
EXP_KERNELS = {"fused_conv": (_BF16_SRC, "experiments/mk1_fusedconv.py:32"),
               "c1_site": (_BF16_SRC, "experiments/mk13_c1.py:36"),
               "shift_dot": (_PROBE_SRC, "experiments/mk21_int8_res_sweep.py:36"),
               "pad_inject": (_PROBE_SRC, "experiments/mk28_probe.py:41"),
               "res_site_cast": (_INT8_SRC, "experiments/mk31_i8_variants.py:57"),
               "res_site_nostats": (_INT8_SRC, "experiments/mk31_i8_variants.py:99")}
EXP_ENTRY_POINTS = ("mk1_fusedconv", "mk2_variants", "mk3_variants", "mk5_ablate",
                    "mk7_d3site", "mk13_c1", "mk20_int8_smoke", "mk21_int8_res_sweep",
                    "mk27_pallas_s8_dot", "mk28_probe", "mk31_i8_variants")
# the TPU kernel bodies each K12 / K13 / K4 form of the probes replaces
PROBE_REPLACES = {"mk20 P2": "experiments/mk20_int8_smoke.py:75",
                  "mk20 P3": "experiments/mk20_int8_smoke.py:137",
                  "mk21": "experiments/mk21_int8_res_sweep.py:36",
                  "mk27 bf16": "experiments/mk27_pallas_s8_dot.py:42",
                  "mk27 s8_aligned": "experiments/mk27_pallas_s8_dot.py:52",
                  "mk27 s8_unaligned": "experiments/mk27_pallas_s8_dot.py:63",
                  "mk27 bf16cast": "experiments/mk27_pallas_s8_dot.py:74",
                  "mk28 P1": "experiments/mk28_probe.py:41",
                  "mk28 P2": "experiments/mk28_probe.py:61",
                  "mk28 P1 res": "experiments/mk28_probe.py:41",
                  "mk28 P2 res": "experiments/mk28_probe.py:61",
                  "mk28 P5": "experiments/mk28_probe.py:93"}
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
# the NST_Train slices (adopted sets: nst = [] runs the XLA-form int8 chain,
# nst_static = res_i8, res_s8 the s8 chain) and their site launches a batch
NST_SLICES = ("none", "bf16_static", "int8", "int8_static")
NST_PER_BATCH = {"int8_static": {"res_site_s8o": 5, "site_s8": 5}}
# the stylize each NST or ReCoNet slice's quality is held against (as the JAX
# tests do)
NST_BASE = {"int8": "none", "int8_static": "bf16_static", "bf16_static": "none"}
# the ReCoNet slices, (--quantize, FRN net), and their site launches a batch
# (adopted sets: reco = res_i8, dec_i8 with reco_skip: 7 × K4 + 3 × K5;
# reco_static = res_i8, res_s8, dec_i8: 4 × K2 + 4 × K3 + 2 × K4)
RECO_SLICES = (("none", False), ("bf16_static", False), ("int8", False), ("int8_static", False),
               ("int8", True), ("int8_static", True))
RECO_PER_BATCH = {"int8": {"res_site": 7, "res_site_skip": 3},
                  "int8_static": {"res_site_s8o": 4, "site_s8": 4, "res_site": 2}}
RECO_CROP = (256, 480)        # the int8_static chains card vs CPU: a 64 × 120 res grid
# the Torch7 slices, (graph, --quantize), and their site launches a batch
# (adopted sets: t7 = res_i8 on instance-norm graphs: 6 × K4 + 4 × K5; t7_bn
# = [] on BN-folded graphs and on the static modes' folded graphs: none)
T7_SLICES = (("in", "none"), ("in", "bf16_static"), ("in", "int8"), ("in", "int8_static"),
             ("bn", "none"), ("bn", "int8"))
T7_PER_BATCH = {("in", "int8"): {"res_site": 6, "res_site_skip": 4}}
PF_FRAMES = 6                 # frames of the per-frame CLI clip
PF_CROP = (256, 448)          # its crop for the card vs CPU comparison
PF_MAE_TOL = 1e-3             # [0,1] frames, per-frame f32 CLI card vs CPU
# K2-K5 run on the int8 tensor cores (mma_kernel), K8a and K8b on its
# stride-2 form (mma_s2_kernel), K6 on d3s8_mma_kernel and K7 on
# d3rows_mma_kernel; their previous __dp4a design (site_kernel, rows_kernel)
# stays callable for the comparison, K2's and K5's also at ReCoNet's C = 192
# (K3's and K4's previous design was built without it); K9b runs on
# d3sum_mma_kernel, K9a on d2_wgmma_kernel, K9c and K9d on
# s2_mma_bf16_kernel, K9e on d3rows_wgmma_kernel, their previous designs
# (rows_kernel_bf16, site_kernel_bf16) likewise
REDESIGNED = ("res_site_s8o", "site_s8", "res_site", "res_site_skip", "c2_site", "c3_site",
              "d3_s8_site", "d3_rows_site")
PREV_C192 = ("res_site_s8o", "res_site_skip")


def slice_name(quantize: str, fused) -> str:
    return quantize if fused is None else f"{quantize}+{SET_NAMES[fused]}"


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def log(msg: str) -> None:
    """One line of the log, stamped with the seconds since the script began."""
    print(f"[chip_smoke {time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


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


def k1_level_inputs(dev):
    """K1's flat inputs at the slice's four pyramid levels (8 frame pairs,
    flow at half resolution), coarse to fine: (level height, width, inputs,
    patches)."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.ops import dis_flow as tdis
    from neuralstyletransferv1_torch.ops.color import rgb_to_gray
    from neuralstyletransferv1_torch.ops.resize import resize_bilinear

    frames = moving_frames(B + 1, H, W, SEED)
    x = torch.from_numpy(np.stack(frames)).to(dev).float()
    gray = resize_bilinear(rgb_to_gray(x)[..., None], (H // 2, W // 2))[..., 0]
    prev, curr = gray[:-1], gray[1:]
    levels = []
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
        levels.append((lh, lw, {key: v.reshape((n,) + v.shape[3:]).contiguous()
                                for key, v in ins.items()}, n))
    return levels


def check_k1(label, u, res, ref_u, ref_res):
    """K1's bound against another version: offsets within K1_OFFSET_TOL px
    on K1_SHARE of the patches, residuals within K1_RES_TOL there. Returns
    (share, max offset error, residual error)."""
    import torch

    if not (torch.isfinite(u).all() and torch.isfinite(res).all()):
        fail(f"K1 produced non-finite values ({label})")
    du = (u - ref_u).abs().max(dim=1).values
    same = du <= K1_OFFSET_TOL
    share = float(same.float().mean())
    res_err = float((res - ref_res).abs()[same].max())
    if share < K1_SHARE or res_err > K1_RES_TOL:
        fail(f"K1 disagrees ({label}): offsets within {K1_OFFSET_TOL} px on {share:.4%}, "
             f"residual err {res_err:.3g}")
    return share, float(du.max()), res_err


def k1_phase(dev):
    """K1 against its plain version and bit for bit against its previous
    core at the slice's pyramid levels, timed level by level in turns (plain; three rounds of
    kernel, previous core and the kernel at 0 iterations, their medians;
    plain: device time, the previous core's including its two PyTorch ops
    for 1/det and u0 − lo); each level's time of one Gauss–Newton step, from
    the kernel at 0 iterations and at its 16. Returns the kernels-line
    record."""
    import torch

    from neuralstyletransferv1_torch.kernels import dis_iter as k1

    worst, per_level = 0.0, []
    for lh, lw, flat, n in k1_level_inputs(dev):
        u, res = k1.dis_iter(**flat)
        u2, res2 = k1.dis_iter(**flat)
        pu, pres = k1.dis_iter_plain(**flat)
        qu, qres = k1.dis_iter_prev(**flat)
        torch.cuda.synchronize()
        if not (torch.equal(u, u2) and torch.equal(res, res2)):
            fail(f"K1: two launches on the same inputs differ at level {lh}x{lw}")
        if not (torch.equal(u, qu) and torch.equal(res, qres)):
            fail(f"K1: not bit-identical to its previous core at level {lh}x{lw}")
        share, du, res_err = check_k1(f"level {lh}x{lw}, plain", u, res, pu, pres)
        kernel, plain = (lambda: k1.dis_iter(**flat)), (lambda: k1.dis_iter_plain(**flat))
        prev = lambda: k1.dis_iter_prev(**flat)  # noqa: E731
        idle = lambda: k1.dis_iter(**flat, iters=0)  # noqa: E731
        # plain, then three rounds of kernel, previous core, 0 iterations
        # (medians: a level's first profile can catch host-side stalls),
        # then plain
        t_plain = dev_time(plain, reps=3)
        rounds = [[dev_time(f, reps=20) for f in (kernel, prev, idle)] for _ in range(3)]
        t_k, t_prev, t_idle = (statistics.median(r[i] for r in rounds) for i in range(3))
        t_plain = (t_plain + dev_time(plain, reps=3)) / 2
        step = (t_k - t_idle) / 16
        # bound: every input read once, u and res written once; ~16 f32
        # operations per pixel of the patch in each of the iters + 1 samples
        ops = n * (16 + 1) * 64 * 16
        bound = max(nbytes(*flat.values(), u, res) / HBM_BYTES_PER_S, ops / PEAK_F32_OPS) * 1e3
        worst = max(worst, du)
        per_level.append({"level": f"{lh}x{lw}", "patches": n, "ms": t_k, "prev_ms": t_prev,
                          "plain_ms": t_plain, "bound_ms": bound, "step_ms": step,
                          "latency_floor_ms": 17 * step})
        log(f"K1 level {lh}x{lw}: {n} patches, two launches bit-identical; offsets within "
            f"{K1_OFFSET_TOL} px of plain on {share:.4%} (bound {K1_SHARE:.0%}), max offset "
            f"err {du:.3g} px, residual err {res_err:.3g} (bound {K1_RES_TOL}), bit-identical "
            f"to the previous core; device ms: kernel {t_k:.4f}, previous core "
            f"{t_prev:.4f} ({t_prev / t_k:.2f}x), plain {t_plain:.4f}, bound {bound:.4f} "
            f"({bound / t_k:.1%}); 0 iterations {t_idle:.4f}: a step {step * 1e3:.3f} us, "
            f"17 steps {17 * step:.4f} ms")
    tot = {k: sum(v[k] for v in per_level) for k in ("ms", "prev_ms", "plain_ms", "bound_ms")}
    log(f"K1, the four levels: kernel {tot['ms']:.4f} ms, previous core {tot['prev_ms']:.4f} ms "
        f"({tot['prev_ms'] / tot['ms']:.2f}x), plain {tot['plain_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms ({tot['bound_ms'] / tot['ms']:.1%}); the coarsest level's "
        f"17 steps {per_level[0]['latency_floor_ms']:.4f} ms")
    return {"max_abs_err": worst, **tot, "bound_share": tot["bound_ms"] / tot["ms"],
            "per_level": per_level}


def site_inputs(dev, b, h, w, c, co, seed):
    """Random operands of an int8 site at realistic scales: codes span the
    int8 range, f = acc·ws + bias is O(1); the TLU floors of ReCoNet's forms
    on their operands' scales (``tau`` on x·a + c, ``tau_act`` on v,
    ``tauo`` on f·qa + qc), biting on a share of them. Also deconv3's
    tap-packed 1×5 weights (60 lanes padded to 64), dequant row and 12-lane
    bias."""
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
        "wk": k8.pack_weights(codes(3, 3, c, co)),
        "ws": rnd(co, scale=1.5e-5, lo=0.5e-5) * (1.0 if c <= 128 else (128 / c) ** 0.5),
        "bias": rnd(co, scale=0.2), "qa": rnd(co, scale=50.0, lo=10.0), "qc": rnd(co, scale=10.0),
        "codes": codes(b, h, w, c, lo=0),
        "tau": rnd(b, c, scale=20.0) - 10.0, "tau_act": rnd(b, c, scale=0.5) - 0.3,
        "tauo": rnd(co, scale=20.0) - 20.0,
        "wk5": k8.pack_weights(codes(1, 5, c, k8.D3_LANES), co_pad=k8.CO_TILE), "ws5": ws5,
        "bias12": rnd(k8.D3_OUT, scale=0.2),
    }


def site_calls(name, t, shape, form, prev=False, halo=None):
    """(kernel call, plain call, bytes moved, int8 ops) of one int8 site;
    with ``prev`` the kernel call is K3's or K4's previous ``__dp4a`` core;
    ``halo`` replaces the shape's halo."""
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    b, h, w, c = t["x"].shape
    co = t["wk"].shape[2]
    kw, outs, pix = {}, 2, b * h * w
    if name == "res_site_s8o":
        args = (t["x"], t["a"], t["c"], -127.0, t["wk"], t["ws"], t["bias"], t["qa"], t["qc"])
        ins, outs = (t["x"], t["a"], t["c"], t["wk"], t["ws"], t["bias"], t["qa"], t["qc"]), 1
        if form == "frn":
            kw = dict(qlo=-127.0, tau=t["tauo"])
            ins += (t["tauo"],)
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
        args = (t["x"], t["a"], t["c"], 0.0 if form == "b" else -127.0, t["wk"], t["ws"],
                t["bias"])
        ins = (t["x"], t["a"], t["c"], t["wk"], t["ws"], t["bias"])
        if form == "tau":
            kw = dict(tau=t["tau"])
            ins += (t["tau"],)
    elif name == "res_site_skip":
        args = (t["x"], t["y"], t["a"], t["c"], t["a2"], t["c2"], -127.0 if form == "a" else 0.0,
                t["wk"], t["ws"], t["bias"])
        ins = (t["x"], t["y"], t["a"], t["c"], t["a2"], t["c2"], t["wk"], t["ws"], t["bias"])
        kw = dict(yout=shape in ("res", "reco_res", "t7"))
        if form in ("relu", "tau"):
            kw.update(act=form, tau_act=t["tau_act"] if form == "tau" else None)
            ins += (t["tau_act"],) if form == "tau" else ()
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
        kw["halo"] = halo or SITE_SHAPES[shape][5]
    # the zero-halo form: no output column >= sw is needed (K2 writes zero
    # codes there, and the chain crops K3's), so the operations count sw
    pix_ops = pix
    if shape in SITE_SW:
        kw["sw"] = SITE_SW[shape]
        pix_ops = pix // w * kw["sw"]
    kernel = getattr(k8, f"{name}_prev" if prev else name)
    plain = getattr(k8, f"{name}_plain")
    moved = nbytes(*ins) + pix * co * outs
    if name in ("res_site", "res_site_skip", "c2_site", "c3_site"):
        moved += b * 2 * co * 4  # the sums
    if name == "res_site_skip" and kw["yout"]:
        moved += b * h * w * c * 2  # v
    taps = 5 if name.startswith("d3") else 9
    lanes = k8.D3_LANES if name.startswith("d3") else co
    ops = 2 * pix_ops * c * lanes * taps
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


def _same(a, b) -> bool:
    """Two kernel results (a tensor or a tuple, None for an absent output)
    bit-identical; [Σ, Σ²] included."""
    import torch

    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


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
    turns (plain, kernel, kernel, plain; K2-K5: plain, kernel, previous
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
            if (redesigned or shape in SITE_SW or shape.startswith("reco") or shape == "t7") \
                    and not _same(kernel(), out):
                fail(f"{name} @ {shape}/{form}: two launches on the same inputs differ")
            del out, first
            # K3's and K4's previous __dp4a core takes the Johnson / NST widths
            # only
            prev_case = redesigned and (name in PREV_C192 or not shape.startswith("reco"))
            if prev_case:
                prev = site_calls(name, t, shape, form, prev=True)[0]
                check_site(f"{name} (previous core)", prev(), ref, n)
            del ref
            t_plain = dev_time(plain, reps=2)
            if prev_case:
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
            per = {"ms": t_k, "plain_ms": t_plain, "cudnn_bf16_ms": t_lib, "bound_ms": bound,
                   "bound_share": bound / t_k}
            if prev_case:
                per["prev_ms"] = t_prev
                rec["prev_ms"] += t_prev
            if shape in SITE_SW:
                halo = f"{halo}, sw {SITE_SW[shape]}"
            log(f"{name} @ {case} {b}x{h}x{w}x{c}->{co} {halo}: bit-identical to plain; "
                f"kernel {t_k:.4f} ms, plain {t_plain:.4f} ms, cuDNN bf16 conv "
                f"{t_lib:.4f} ms; bound {bound:.4f} ms "
                f"({moved / 1e6:.1f} MB, {ops:.3e} int8 ops)" +
                (f"; previous __dp4a core {t_prev:.4f} ms ({t_prev / t_k:.2f}x the kernel)"
                 if prev_case else "") + f"; kernel at {bound / t_k:.1%} of the bound")
            rec["ms"] += t_k
            rec["plain_ms"] += t_plain
            rec["cudnn_bf16_ms"] += t_lib
            rec["bound_ms"] += bound
            rec["per_case"][case] = per
            if t_ops > t_bytes:
                rec["bound_by"] = "operations"
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            del t, lib, kernel, plain
            if prev_case:
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
    if name.startswith("d3_sum_site"):
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
    """K9a-K9e against their plain versions and their previous cores (held
    to the same bounds) at the slice's shapes, timed in turns (plain,
    kernel, previous core, kernel, previous core, plain) beside the cuDNN
    bf16 conv of the same shape."""
    import torch

    from neuralstyletransferv1_torch.kernels import bf16_sites as k9

    results = {}
    for i, (name, (shape, _replaces)) in enumerate(BF16_KERNELS.items()):
        args = bf16_site_inputs(dev, name, shape, seed=100 + i)
        kernel, plain = getattr(k9, name), getattr(k9, f"{name}_plain")
        out, again, ref = kernel(*args), kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err, worst, equal = check_bf16_site(name, out, again, ref, args)
        prev = getattr(k9, f"{name}_prev")
        p1, p2 = prev(*args), prev(*args)
        torch.cuda.synchronize()
        check_bf16_site(f"{name} (previous core)", p1, p2, ref, args)
        check_bf16_site(f"{name} against its previous core", out, again, p1, args)
        del p1, p2
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
        t_k, t_prev = dev_time(lambda: kernel(*args)), dev_time(lambda: prev(*args), reps=3)
        t_k = (t_k + dev_time(lambda: kernel(*args))) / 2
        t_prev = (t_prev + dev_time(lambda: prev(*args), reps=3)) / 2
        t_plain = (t_plain + dev_time(lambda: plain(*args), reps=2)) / 2
        lib = bf16_library_conv(dev, name, shape)
        t_lib = dev_time(lib)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, flops / PEAK_BF16_OPS * 1e3
        bound = max(t_bytes, t_ops)
        log(f"{name} @ {b}x{h}x{w}x{c}: two launches bit-identical; vs plain max |err| "
            f"{err:.4g}, worst {worst:.3g} ulp, equal on {equal:.4%}; kernel {t_k:.4f} ms, plain "
            f"{t_plain:.4f} ms, cuDNN bf16 conv {t_lib:.4f} ms; bound {bound:.4f} ms "
            f"({moved / 1e6:.1f} MB, {flops:.3e} bf16 FLOP); previous core {t_prev:.4f} ms "
            f"({t_prev / t_k:.2f}x the kernel); kernel at {bound / t_k:.1%} of the bound")
        results[name] = {"ms": t_k, "plain_ms": t_plain, "cudnn_bf16_ms": t_lib,
                         "bound_ms": bound, "max_abs_err": err,
                         "bound_by": "operations" if t_ops > t_bytes else "bytes",
                         "prev_ms": t_prev, "bound_share": bound / t_k}
        del args, lib, prev
        torch.cuda.empty_cache()
    return results


def experiments_phase(dev) -> tuple[dict, dict]:
    """Each experiment entry point once at its script's full shape, as a
    user runs it (``main([])``: kernel against plain version, then timed in
    turns beside its yardsticks), with the launch counts zeroed before and
    read after; its JSON line goes to the log. Returns the launches and
    the kernels-line records of K10 and K11 (mk5's, whose default variants
    take K10's six forms: the f32 form's numbers, the largest error, every
    form under ``per_form``, each with its previous core's time
    ``prev_ms``; mk13's), of K12 (mk21's tap9-int8 strip, every form of
    mk20, mk21 and mk27 under ``per_form``, each with ``prev_ms``; the flat
    forms timed by CUDA graph replay), K13 (mk28's P1 at the res site's
    shape, with P2 there and both on mk28's strip beside the launch floor)
    and K4's cast and no-statistics forms (mk31's v1; v2, with mk28's P5)."""
    import contextlib
    import importlib
    import io

    zero_counts()
    t0 = time.perf_counter()
    recs = {}
    for name in EXP_ENTRY_POINTS:
        mod = importlib.import_module(f"neuralstyletransferv1_torch.experiments.{name}")
        buf = io.StringIO()
        t1 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                recs[name] = mod.main([])
        except AssertionError as e:
            fail(f"experiments.{name}: {e}")
        log(f"entry {name} ({time.perf_counter() - t1:.1f} s): {buf.getvalue().strip()}")
    counts = read_counts()
    log(f"experiment entry points in {time.perf_counter() - t0:.1f} s; launches "
        + ", ".join(f"{k} {counts[k]}" for k in (*EXP_KERNELS, "d3_rows")))
    for name in EXP_KERNELS:
        if counts[name] == 0:
            fail(f"{name} was launched no time by the experiment entry points")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "library_ms")
    forms = {f"{v['prologue']}{'' if v['stats'] else '/ns'}": v
             for v in recs["mk5_ablate"]["variants"]}
    if len(forms) != 6:
        fail(f"mk5_ablate ran K10 in {sorted(forms)}, not its six forms")
    k10 = {**{k: forms["f32"][k] for k in (*keys, "prev_ms")},
           "max_abs_err": max(v["max_abs_err"] for v in forms.values()),
           "per_form": {f: {k: v[k] for k in (*keys, "prev_ms", "eager_path_ms",
                                               "compiled_path_ms", "path_bound_ms")}
                        for f, v in forms.items()}}
    k11 = {k: recs["mk13_c1"][k] for k in (*keys, "prev_ms", "bound_share", "cudnn_pixel_nchw_ms",
                                           "cudnn_pixel_channels_last_ms")}
    k11["worst_ulp"], k11["vs_prev_worst_ulp"] = (recs["mk13_c1"]["worst_ulp"],
                                                  recs["mk13_c1"]["vs_prev"]["worst_ulp"])
    extra = ("cudnn_bf16_ms", "im2col_mm_ms", "tops", "prev_ms", "timing", "floor_ms",
             "floor_prev_ms")

    def row(v: dict, replaces: str | None = None) -> dict:
        r = {**{k: v.get(k) for k in keys}, **{k: v[k] for k in extra if k in v}}
        return r if replaces is None else {**r, "replaces": replaces}

    k12 = {f"mk20 P{v['probe']} {v['form']}": row(v, PROBE_REPLACES[f"mk20 P{v['probe']}"])
           for v in recs["mk20_int8_smoke"]["probes"] if v["probe"] != 1}
    k12.update({f"mk21 {v['variant']}": row(v, PROBE_REPLACES["mk21"])
                for v in recs["mk21_int8_res_sweep"]["variants"]})
    k12.update({f"mk27 {v['variant']}": row(v, PROBE_REPLACES[f"mk27 {v['variant']}"])
                for v in recs["mk27_pallas_s8_dot"]["variants"]})
    mk28 = {v["form"]: v for v in recs["mk28_probe"]["probes"]}
    k13 = {f"mk28 {p}": row(mk28[p], PROBE_REPLACES[f"mk28 {p}"])
           for p in ("P1", "P2", "P1 res", "P2 res")}
    mk31 = {v["variant"]: v for v in recs["mk31_i8_variants"]["variants"]}
    nostats = {"mk31 v2": row(mk31["v2"], "experiments/mk31_i8_variants.py:99"),
               "mk28 P5": row(mk28["P5"], PROBE_REPLACES["mk28 P5"])}

    def main_row(per_form: dict, main: str) -> dict:
        return {**{k: per_form[main][k] for k in keys},
                **({"prev_ms": per_form[main]["prev_ms"]} if "prev_ms" in per_form[main] else {}),
                "max_abs_err": max(v["max_abs_err"] for v in per_form.values()),
                "main_form": main, "per_form": per_form}

    return counts, {"fused_conv": k10, "c1_site": k11,
                    "shift_dot": main_row(k12, "mk21 tap9-int8"),
                    "pad_inject": main_row(k13, "mk28 P1 res"),
                    "res_site_cast": {**row(mk31["v1"]), "form": "mk31 v1",
                                      "v0_ms": mk31["v0"]["ms"]},
                    "res_site_nostats": main_row(nostats, "mk31 v2")}


# K2/K3's zero-halo form at ragged content widths: (B, H, W, C, CO, sw)
RAGGED_SW = ((2, 13, 32, 128, 128, 29), (3, 19, 40, 64, 64, 36))


def ragged_sw_phase(dev):
    """K2 and K3 (frozen affine + residual, and the s8 emit) in the zero-halo
    form at ragged content widths, K3 on K2's codes as the NST chain runs
    them: bit-identical to their plain versions, two launches bit-identical,
    the codes of the columns >= sw zero."""
    import torch

    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    for i, (b, h, w, c, co, sw) in enumerate(RAGGED_SW):
        t = site_inputs(dev, b, h, w, c, co, seed=200 + i)
        kargs = (t["x"], t["a"], t["c"], -127.0, t["wk"], t["ws"], t["bias"], t["qa"], t["qc"])
        q = k8.res_site_s8o(*kargs, halo="zero", sw=sw)
        same = torch.equal(q, k8.res_site_s8o(*kargs, halo="zero", sw=sw))
        ref = k8.res_site_s8o_plain(*kargs, halo="zero", sw=sw)
        if not (same and torch.equal(q, ref)) or bool(q[:, :, sw:].any()):
            fail(f"res_site_s8o at {b}x{h}x{w}x{c}, sw {sw}: not bit-identical to its plain "
                 "version, to itself, or not zero beyond sw")
        aff = dict(aa=t["qa"] / 40, ac=t["qc"] / 40, y=t["y"])
        for form, kw in (("aff_add", aff), ("emit", dict(aff, qa=t["qa"] / 4, qc=t["qc"],
                                                         qlo=-127.0))):
            args = (q, t["wk"], t["ws"], t["bias"])
            o = k8.site_s8(*args, halo="zero", sw=sw, **kw)
            same = torch.equal(o, k8.site_s8(*args, halo="zero", sw=sw, **kw))
            if not (same and torch.equal(o, k8.site_s8_plain(*args, halo="zero", sw=sw, **kw))):
                fail(f"site_s8/{form} at {b}x{h}x{w}x{c}, sw {sw}: not bit-identical to its "
                     "plain version or to itself")
            if form == "emit" and bool(o[:, :, sw:].any()):
                fail(f"site_s8/emit at sw {sw}: codes beyond sw are not zero")
        torch.cuda.synchronize()
        log(f"K2 and K3 (aff_add, emit), zero halo, {b}x{h}x{w}x{c}->{co} sw {sw}: "
            f"bit-identical to their plain versions and across two launches, zero beyond sw")
        del t, q, ref


# ReCoNet's forms at ragged shapes (8×16 output tiles, 64-channel blocks at
# C = 192): (B, H, W, C); at 192 the res forms and d1's 192 -> 384, at 96
# d2's 96 -> 192
RAGGED_RECO = ((3, 13, 21, 192), (1, 11, 30, 96))


def ragged_reco_phase(dev):
    """ReCoNet's kernel forms at ragged shapes: K4 (with and without the TLU
    floor; 192 -> 192 reflect and -> 384 edge, 96 -> 192 edge), K5 (relu,
    tau), K2 (the IN and FRN emit) and K3 on K2's codes: outputs
    bit-identical to the plain versions (sums within 1e-5) and two launches
    bit-identical, sums included."""
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    for i, (b, h, w, c) in enumerate(RAGGED_RECO):
        co = 192
        cases = []
        t = site_inputs(dev, b, h, w, c, co, seed=300 + i)
        x3 = (t["x"], t["a"], t["c"])
        for tau in (None, t["tau"]):
            halo = "reflect" if c == 192 else "edge"
            cases.append((f"res_site {c}->{co} {halo}{' tau' if tau is not None else ''}",
                          "res_site", x3 + (-127.0 if tau is not None else 0.0, t["wk"], t["ws"],
                                            t["bias"]), dict(halo=halo, tau=tau)))
        if c == 192:
            t4 = site_inputs(dev, b, h, w, c, 2 * co, seed=310)
            cases.append(("res_site 192->384 edge", "res_site",
                          (t4["x"], t4["a"], t4["c"], -127.0, t4["wk"], t4["ws"], t4["bias"]),
                          dict(halo="edge")))
            skip = (t["x"], t["y"], t["a"], t["c"], t["a2"], t["c2"], -127.0, t["wk"], t["ws"],
                    t["bias"])
            cases += [("res_site_skip relu", "res_site_skip", skip, dict(act="relu")),
                      ("res_site_skip tau", "res_site_skip", skip,
                       dict(act="tau", tau_act=t["tau_act"]))]
            s8o = x3 + (-127.0, t["wk"], t["ws"], t["bias"], t["qa"], t["qc"])
            cases += [("res_site_s8o in", "res_site_s8o", s8o, {}),
                      ("res_site_s8o frn", "res_site_s8o", s8o, dict(qlo=-127.0, tau=t["tauo"]))]
        for label, name, args, kw in cases:
            out, again = getattr(k8, name)(*args, **kw), getattr(k8, name)(*args, **kw)
            ref = getattr(k8, f"{name}_plain")(*args, **kw)
            check_site(f"{name} ragged {b}x{h}x{w}", out, ref, h * w)
            if not _same(out, again):
                fail(f"{label} at {b}x{h}x{w}: two launches on the same inputs differ")
            if name == "res_site_s8o":
                aff = (t["qa"] / 40, t["qc"] / 40, t["y"])
                o = k8.site_s8(out, t["wk"], t["ws"], t["bias"], *aff)
                if not (_same(o, k8.site_s8(out, t["wk"], t["ws"], t["bias"], *aff)) and
                        _same(o, k8.site_s8_plain(out, t["wk"], t["ws"], t["bias"], *aff))):
                    fail(f"site_s8 192 on the {label} codes at {b}x{h}x{w}: not bit-identical")
        log(f"ReCoNet forms at {b}x{h}x{w}x{c}: {', '.join(c_[0] for c_ in cases)}"
            f"{' (+ site_s8 on each emit)' if c == 192 else ''}: bit-identical to their plain "
            "versions and across two launches")


# K7's and K9a's tensor-core cores at ragged shapes (B, H, W): widths off
# the 32-column strip and tile, heights below the 8-row tile (K9a's 4-row
# tile: a partial bottom tile), one image and three
RAGGED_K7_K9A = ((1, 5, 45), (3, 7, 70), (1, 3, 33), (3, 13, 100), (1, 2, 2))


def ragged_k7_k9a_phase(dev):
    """K7 (``d3_rows_site``) and K9a (``d2_site``) at ragged shapes against
    their plain versions and their previous cores: K7 bit-identical to both,
    K9a within the K9 bounds of ``check_bf16_site`` (1 ulp, 99% equal, sums
    within 1e-5) of both; two launches bit-identical."""
    import torch

    from neuralstyletransferv1_torch.kernels import bf16_sites as k9
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    for i, (b, h, w) in enumerate(RAGGED_K7_K9A):
        t = site_inputs(dev, b, h, w, k8.D3_C, k8.CO_TILE, seed=400 + i)
        args = (t["x"], t["a"], t["c"], t["wk5"], t["ws5"])
        rows, again = k8.d3_rows_site(*args), k8.d3_rows_site(*args)
        prev, ref = k8.d3_rows_site_prev(*args), k8.d3_rows_site_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(rows, again) and torch.equal(rows, ref) and torch.equal(prev, ref)):
            fail(f"d3_rows_site at {b}x{h}x{w}: not bit-identical to its plain version, its "
                 "previous core or itself")
        del t, args, rows, again, prev, ref
        args = bf16_site_inputs(dev, "d2_site", (b, h, w, 64), seed=410 + i)
        out, again, ref = k9.d2_site(*args), k9.d2_site(*args), k9.d2_site_plain(*args)
        p1, p2 = k9.d2_site_prev(*args), k9.d2_site_prev(*args)
        torch.cuda.synchronize()
        _, worst, equal = check_bf16_site(f"d2_site ragged {b}x{h}x{w}", out, again, ref, args)
        check_bf16_site(f"d2_site (previous core) ragged {b}x{h}x{w}", p1, p2, ref, args)
        check_bf16_site(f"d2_site against its previous core ragged {b}x{h}x{w}", out, again, p1,
                        args)
        log(f"K7 and K9a at {b}x{h}x{w}: K7 bit-identical to its plain version and previous "
            f"core; K9a {worst:.3g} ulp at worst, equal on {equal:.4%}, within the K9 bounds "
            "of its plain version and previous core; two launches bit-identical")
        del args, out, again, ref, p1, p2


# K9c's and K9d's stride-2 core at ragged input shapes (B, H, W), even:
# outputs off the 16-column tile, below and off K9c's 8-row and K9d's
# 4-row tiles, a 1 × 1 output, one image and three
RAGGED_K9C_K9D = ((1, 2, 2), (1, 6, 34), (3, 14, 70), (3, 26, 100), (1, 34, 66))


def ragged_k9c_k9d_phase(dev):
    """K9c (``c2_site_bf16``) and K9d (``c3_site_bf16``) at ragged shapes
    against their plain versions and their previous cores, within the K9
    bounds of ``check_bf16_site`` (1 ulp, 99% equal, sums within 1e-5);
    two launches bit-identical. At a 1 × 1 output a channel's [Σ, Σ²] is
    one f and its square, whose accumulation-order error no other pixel
    dilutes (both cores differ from the plain version's there by more
    than 1e-5, PERF.md, PR 16): the sums are held bit-identical to the
    previous core's, which adds the same products in the same order."""
    import torch

    from neuralstyletransferv1_torch.kernels import bf16_sites as k9

    for i, (b, h, w) in enumerate(RAGGED_K9C_K9D):
        worst = {}
        for name in ("c2_site_bf16", "c3_site_bf16"):
            args = bf16_site_inputs(dev, name, (b, h, w, k9.SITES[name][0]), seed=420 + i)
            kernel, prev = getattr(k9, name), getattr(k9, f"{name}_prev")
            out, again, ref = kernel(*args), kernel(*args), getattr(k9, f"{name}_plain")(*args)
            p1, p2 = prev(*args), prev(*args)
            torch.cuda.synchronize()
            label = f"{name} ragged {b}x{h}x{w}"
            if h == w == 2:
                if not torch.equal(out[1], p1[1]):
                    fail(f"{label}: the 1 x 1 output's sums differ from the previous core's")
                out, again, ref, p1, p2 = out[0], again[0], ref[0], p1[0], p2[0]
            _, worst[name], _ = check_bf16_site(label, out, again, ref, args)
            check_bf16_site(f"{name} (previous core) ragged {b}x{h}x{w}", p1, p2, ref, args)
            check_bf16_site(f"{name} against its previous core ragged {b}x{h}x{w}", out, again,
                            p1, args)
            del args, out, again, ref, p1, p2
        log(f"K9c and K9d at {b}x{h}x{w}: {worst['c2_site_bf16']:.3g} and "
            f"{worst['c3_site_bf16']:.3g} ulp at worst, within the K9 bounds of their plain "
            "versions and previous cores; two launches bit-identical")


# K9e's core at ragged shapes (B, H, W): the smallest image, an odd W
# (plain stores), W off the 64-column segment, one segment, one past it
RAGGED_K9E = ((1, 3, 3), (1, 5, 67), (3, 7, 130), (2, 9, 64), (1, 4, 65))
# K1 at ragged patch counts: level images (B, h, w) of 1, 2, 3 and 5
# patches (tails of 3, 2, 1 and 3 in the last warp) and 126 (a partial block)
RAGGED_K1 = ((1, 8, 8), (1, 8, 12), (1, 8, 16), (1, 8, 24), (1, 40, 60))


def ragged_k9e_k1_phase(dev):
    """K9e (``d3_rows``) at ragged shapes against its plain version and its
    previous core, within the K9 bounds of ``check_bf16_site`` (1 ulp, 99%
    equal); K1 at ragged patch counts against its plain version (offsets
    within 1e-3 px on 99% of patches, residuals within 1e-3) and bit for bit
    against its previous core; two launches of each bit-identical."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.kernels import bf16_sites as k9
    from neuralstyletransferv1_torch.kernels import dis_iter as k1
    from neuralstyletransferv1_torch.ops import dis_flow as tdis

    for i, (b, h, w) in enumerate(RAGGED_K9E):
        args = bf16_site_inputs(dev, "d3_rows", (b, h, w, k9.D3_C), seed=430 + i)
        out, again, ref = k9.d3_rows(*args), k9.d3_rows(*args), k9.d3_rows_plain(*args)
        p1, p2 = k9.d3_rows_prev(*args), k9.d3_rows_prev(*args)
        torch.cuda.synchronize()
        _, worst, equal = check_bf16_site(f"d3_rows ragged {b}x{h}x{w}", out, again, ref, args)
        check_bf16_site(f"d3_rows (previous core) ragged {b}x{h}x{w}", p1, p2, ref, args)
        check_bf16_site(f"d3_rows against its previous core ragged {b}x{h}x{w}", out, again, p1,
                        args)
        log(f"K9e at {b}x{h}x{w}: {worst:.3g} ulp at worst, equal on {equal:.4%}, within the K9 "
            "bounds of its plain version and previous core; two launches bit-identical")
        del args, out, again, ref, p1, p2
    for i, (b, h, w) in enumerate(RAGGED_K1):
        rng = np.random.default_rng(440 + i)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = 128 + 50 * np.sin(0.23 * xx + 0.11 * yy) + 30 * np.cos(0.13 * xx - 0.29 * yy)
        pair = [torch.from_numpy(np.stack([np.roll(img, s, 1) + rng.normal(0, 2, (h, w))
                                           for _ in range(b)]).astype(np.float32)).to(dev)
                for s in (0, 2)]
        init = torch.from_numpy(rng.normal(0.5, 0.6, (b, h, w, 2)).astype(np.float32)).to(dev)
        ins = tdis._level_inputs(*pair, init)
        n = b * ins["t"].shape[1] * ins["t"].shape[2]
        flat = {k: v.reshape((n,) + v.shape[3:]).contiguous() for k, v in ins.items()}
        (u, res), (u2, res2) = k1.dis_iter(**flat), k1.dis_iter(**flat)
        pu, pres = k1.dis_iter_plain(**flat)
        qu, qres = k1.dis_iter_prev(**flat)
        torch.cuda.synchronize()
        if not (torch.equal(u, u2) and torch.equal(res, res2)):
            fail(f"K1 at {n} patches: two launches on the same inputs differ")
        if not (torch.equal(u, qu) and torch.equal(res, qres)):
            fail(f"K1 at {n} patches: not bit-identical to its previous core")
        share, du, _ = check_k1(f"{n} patches, plain", u, res, pu, pres)
        log(f"K1 at {n} patches (a tail of {-n % 4} in the last warp): offsets within "
            f"{K1_OFFSET_TOL} px of plain on {share:.4%}, max err {du:.3g} px; bit-identical to "
            "its previous core; two launches bit-identical")


# K11's output grids (B, H, W): a 1 × 1 output, W off the 64-pixel tile
# with B = 3, an odd W + 4 (8-byte input rows), one whole tile, strips of
# 2-7 rows (a block's run crosses strips), a W two tiles and a bit
RAGGED_K11 = ((1, 1, 1), (3, 2, 70), (1, 5, 131), (2, 7, 64), (3, 4, 129), (1, 6, 200))
# K13's (B, R, W0, C, WP): the launch floor, W0 and WP off everything at C
# = 8 (an odd count of pieces a row: P2 stores 8 bytes a unit), 64 and 128
RAGGED_K13 = ((1, 1, 3, 8, 6), (2, 3, 17, 8, 21), (2, 3, 17, 64, 23), (1, 4, 33, 8, 37),
              (3, 2, 7, 128, 11), (1, 5, 61, 8, 64))


def ragged_k11_k13_phase(dev):
    """K11 (``c1_site``) at ragged output grids against its plain version
    and its previous core, within the K9 bounds of ``check_bf16_site`` (1
    ulp, 99% equal); K13 (``pad_inject``, P1 and P2) at ragged widths and C
    = 8, 64, 128, bit-identical to its plain version and its previous core;
    two launches of each bit-identical."""
    import torch

    from neuralstyletransferv1_torch.kernels import bf16_sites as k9
    from neuralstyletransferv1_torch.kernels import int8_probes as k13

    for i, (b, h, w) in enumerate(RAGGED_K11):
        g = torch.Generator(device=dev).manual_seed(450 + i)
        y12 = torch.rand((b, h + 4, w + 4, k9.C1_IN), generator=g, device=dev).to(torch.bfloat16)
        wt = (torch.randn((5, 5, k9.C1_IN, k9.C1_OUT), generator=g, device=dev) * 0.1).to(
            torch.bfloat16)
        cb = torch.randn(k9.C1_OUT, generator=g, device=dev) * 0.2
        out, again, ref = k9.c1_site(y12, wt, cb), k9.c1_site(y12, wt, cb), \
            k9.c1_site_plain(y12, wt, cb)
        p1, p2 = k9.c1_site_prev(y12, wt, cb), k9.c1_site_prev(y12, wt, cb)
        torch.cuda.synchronize()
        _, worst, equal = check_bf16_site(f"c1_site ragged {b}x{h}x{w}", out, again, ref, None)
        check_bf16_site(f"c1_site (previous core) ragged {b}x{h}x{w}", p1, p2, ref, None)
        check_bf16_site(f"c1_site against its previous core ragged {b}x{h}x{w}", out, again, p1,
                        None)
        log(f"K11 at {b}x{h}x{w}: {worst:.3g} ulp at worst, equal on {equal:.4%}, within the K9 "
            "bounds of its plain version and previous core; two launches bit-identical")
        del y12, out, again, ref, p1, p2
    for i, (b, r, w0, c, wp) in enumerate(RAGGED_K13):
        g = torch.Generator(device=dev).manual_seed(460 + i)
        x = (torch.randn((b, r, w0, c), generator=g, device=dev) * 8).to(torch.bfloat16)
        for inject in (False, True):
            if wp < w0 + (3 if inject else 1):
                continue
            out, again = k13.pad_inject(x, wp, inject=inject), k13.pad_inject(x, wp, inject=inject)
            ref = k13.pad_inject_plain(x, wp, inject=inject)
            prev = k13.pad_inject_prev(x, wp, inject=inject)
            torch.cuda.synchronize()
            form = f"P{2 if inject else 1} at {b}x{r}x{w0}x{c} -> {wp}"
            if not torch.equal(out, again):
                fail(f"K13 {form}: two launches on the same inputs differ")
            if not (torch.equal(out, ref) and torch.equal(prev, ref)):
                fail(f"K13 {form}: the core or its previous core differs from the plain version")
        log(f"K13 at {b}x{r}x{w0}x{c} -> {wp}: P1"
            f"{' and P2' if wp >= w0 + 3 else ''} bit-identical to the plain version and the "
            "previous core; two launches bit-identical")


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
    from neuralstyletransferv1_torch.kernels import int8_probes as k12
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    k1.LAUNCHES = 0
    for counts in (k8.LAUNCHES, k8.PROBE_LAUNCHES, k9.LAUNCHES, k12.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    from neuralstyletransferv1_torch.kernels import bf16_sites as k9
    from neuralstyletransferv1_torch.kernels import dis_iter as k1
    from neuralstyletransferv1_torch.kernels import int8_probes as k12
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    return {"dis_iter": k1.LAUNCHES, **k8.LAUNCHES, **k8.PROBE_LAUNCHES, **k9.LAUNCHES,
            **k12.LAUNCHES}


def slice_phase(dev, quantize: str = "none", fused=None, nst_ckpt: Path | None = None,
                reco: tuple | None = None, t7: tuple | None = None):
    """The 1080p bf16 flow-EMA slice through make_batched_core, plain, with
    a --quantize mode and fused-site set, or with a set of bf16 fused sites;
    with ``nst_ckpt``, of that NST_Train checkpoint under the adopted sets;
    with ``reco`` = (checkpoint, frn), of that ReCoNet slot
    (``--model_type reconet``) under the adopted sets; with ``t7`` = (.t7
    file, "in" or "bn"), of that Torch7 slot under the adopted sets;
    returns the run's launch counts."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.ops.dis_flow import _level_sizes

    argv = ["--input_video", "in.mp4", "--output_video", "out.mp4",
            "--model", str(nst_ckpt or (reco[0] if reco else (t7[0] if t7 else CKPT))),
            "--frame_batch", str(B), "--flow_ema", "--compute_dtype", "bfloat16"]
    if reco is not None:
        argv += ["--model_type", "reconet"]
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
    per_batch = PER_BATCH.get((quantize, fused), {})
    if nst_ckpt is not None:
        name, per_batch = f"nst {name}", NST_PER_BATCH.get(quantize, {})
    if reco is not None:
        name = f"reco {'frn' if reco[1] else 'in'} {name}"
        per_batch = RECO_PER_BATCH.get(quantize, {})
    if t7 is not None:
        name, per_batch = f"t7 {t7[1]} {name}", T7_PER_BATCH.get((t7[1], quantize), {})
    expected = {"dis_iter": levels * N_BATCHES}
    for k in counts:
        if k != "dis_iter":
            expected[k] = per_batch.get(k, 0) * N_BATCHES
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
        quant_quality(dev, args, frames[:B], quantize, fused, name)
    return counts


def quant_quality(dev, args, frames, quantize, fused, name):
    """The quantized (or fused-site) stylize of the slice's first batch
    against the plain dynamic bf16 stylize of the same frames: within the
    repo's 1e-2 gate with the slot's IO preset (what the main path ran),
    and, as a check that the path is not broken, within QUANT_BROKEN_TOL on
    the raw_01 scale, where this random-weight net's outputs spread over
    [0, 1] (there int8 noise alone is ~1e-2; PERF.md). An NST_Train slot
    (preset raw_01) is held as the JAX package's tests hold it
    (tests/test_static_norm.py): on seeded uniform-noise frames, int8
    against bf16, int8_static against bf16_static (the same frozen norms)
    and bf16_static against bf16, each within the 1e-2 gate; on the slice's
    smooth frames, where this random net amplifies the int8 noise to ~2e-2
    (PERF.md), within QUANT_BROKEN_TOL. A ReCoNet slot (preset imagenet_01)
    and a Torch7 slot (caffe_bgr) are held the same way."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.engine import stylizer as st

    model = tpipe.load_slot_bank(args, dev)[0]
    x = torch.from_numpy(np.stack(frames)).to(dev).float() / 255.0
    base = "none"
    checks = [(model.io_preset, x, "the slice's frames", QUANT_MAE_TOL)]
    if model.arch in ("nst", "reconet", "t7"):
        base = NST_BASE[quantize]
        noise = np.random.default_rng(SEED + 9).random(tuple(x.shape), np.float32)
        checks = [(model.io_preset, torch.from_numpy(noise).to(dev), "uniform-noise frames",
                   QUANT_MAE_TOL), (model.io_preset, x, "the slice's frames", QUANT_BROKEN_TOL)]
    elif model.io_preset != "raw_01":
        checks.append(("raw_01", x, "the slice's frames", QUANT_BROKEN_TOL))
    for preset, xin, what, bound in checks:
        m = st.StyleModel(model.arch, model.net, preset, model.name)
        ref = st.jit_stylizer(m, dtype=torch.bfloat16, quantize=base)(xin)
        got = st.jit_stylizer(m, dtype=torch.bfloat16, quantize=quantize, fused_sites=fused)(xin)
        mae = float((got - ref).abs().mean())
        first = float((got[0] - ref[0]).abs().mean())
        log(f"stylize --quantize {name} vs {'bf16' if base == 'none' else base}, preset "
            f"{preset}, {what}: MAE {mae:.6f} (first frame {first:.6f}; bound {bound})")
        if not (torch.isfinite(got).all() and mae <= bound):
            fail(f"the {name} stylize is not within {bound} of the {base} stylize ({preset}, "
                 f"{what})")
        del ref, got


def write_clip(path: Path, frames, fps: int = 24) -> None:
    """RGB uint8 frames → an mp4v file (OpenCV)."""
    import cv2
    import numpy as np

    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for fr in frames:
        vw.write(np.ascontiguousarray(fr[..., ::-1]))
    vw.release()


def clip_frame_count(path: Path) -> int:
    """Frames decoded from a video file."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def cli_phase(dev, workdir: Path):
    """main() end to end on a synthesized 1080p mp4 (the streamed batched
    path)."""
    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.kernels import dis_iter as k1

    src, dst = workdir / "in.mp4", workdir / "out.mp4"
    n = 12
    write_clip(src, moving_frames(n, H, W, SEED + 3))
    before = k1.LAUNCHES
    t0 = time.perf_counter()
    rc = tpipe.main(["--input_video", str(src), "--output_video", str(dst),
                     "--model", str(CKPT), "--frame_batch", str(B), "--flow_ema",
                     "--compute_dtype", "bfloat16", "--work_dir", str(workdir / "_work")])
    secs = time.perf_counter() - t0
    got = clip_frame_count(dst)
    log(f"main() on a {n}-frame 1080p mp4: rc {rc}, {got} frames written, {secs:.2f} s, "
        f"K1 launches {k1.LAUNCHES - before}")
    if rc != 0 or got != n or k1.LAUNCHES == before:
        fail("main() did not style the clip end to end")


def styled_pngs(work_dir: Path) -> list:
    """The styled frame files a per-frame or --stream off job left, [0,1]."""
    import numpy as np
    from PIL import Image

    files = sorted((work_dir / "frames").glob("styled_frame_*.png"))
    return [np.asarray(Image.open(f).convert("RGB"), np.float64) / 255.0 for f in files]


def per_frame_phase(dev, workdir: Path):
    """The CLI's default invocation — no --device, no --frame_batch: the
    per-frame f32 loop with extraction to and assembly from frame files —
    on a synthesized 1080p clip, without and with --flow_ema (K1 at every
    frame after the first); the per-frame loop timed again on the extracted
    frames in the warm process; the same with --flow_ema on a 256×448 crop
    against --device cpu; the single-image mode; --stream off with
    --frame_batch 8. The crop and the single image run with --io_preset
    raw_01: under the default preset this random-weight net's output sits
    near 0, where an MAE bound and a spread check say nothing."""
    import numpy as np
    import torch
    from PIL import Image

    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.ops.dis_flow import _level_sizes

    n = PF_FRAMES
    frames = moving_frames(n, H, W, SEED + 7)
    src = workdir / "pf_in.mp4"
    write_clip(src, frames)
    ds = tpipe.effective_flow_downscale(0, H, W)
    levels = len(_level_sizes(H // ds, W // ds, 2))

    launches: dict = {}

    def run(argv, want_k1, label):
        zero_counts()
        t0 = time.perf_counter()
        rc = tpipe.main([str(a) for a in argv])
        secs = time.perf_counter() - t0
        used = {k: v for k, v in read_counts().items() if v}
        for k, v in used.items():
            launches[k] = launches.get(k, 0) + v
        want = {"dis_iter": want_k1} if want_k1 else {}
        log(f"main() {label}: rc {rc}, {secs:.2f} s, launches {used}, "
            f"{'as' if used == want else 'NOT as'} expected ({want})")
        if rc != 0 or used != want:
            fail(f"main() {label} did not run as expected")

    fps = {}
    for label, extra in (("default", []), ("--flow_ema", ["--flow_ema"])):
        out, wd = workdir / f"pf{len(fps)}.mp4", workdir / f"_pf{len(fps)}"
        argv = ["--input_video", src, "--output_video", out, "--model", CKPT, *extra,
                "--work_dir", wd]
        run(argv, (n - 1) * levels if extra else 0, f"per-frame {label} on a {n}-frame 1080p mp4")
        if clip_frame_count(out) != n:
            fail(f"the per-frame {label} video holds {clip_frame_count(out)} frames, not {n}")
        args = tpipe.build_parser().parse_args([str(a) for a in argv])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written, _ = tpipe.style_frames(args, wd / "frames", False, {}, dev)
        torch.cuda.synchronize()
        fps[label] = written / (time.perf_counter() - t0)
        log(f"per-frame loop {label}, f32, 1080p: {fps[label]:.3f} frames/s ({written} frames, "
            "frame files read and written, warm process)")

    ch, cw = PF_CROP
    crop = workdir / "pf_crop.mp4"
    write_clip(crop, [np.ascontiguousarray(f[:ch, :cw]) for f in frames])
    outs = {}
    for d in ("cuda", "cpu"):
        wd = workdir / f"_pfc_{d}"
        argv = ["--input_video", crop, "--output_video", workdir / f"pfc_{d}.mp4",
                "--model", CKPT, "--io_preset", "raw_01", "--flow_ema", "--work_dir", wd]
        if d == "cpu":
            argv += ["--device", "cpu"]
        ds_c = tpipe.effective_flow_downscale(0, ch, cw)
        run(argv, (n - 1) * len(_level_sizes(ch // ds_c, cw // ds_c, 2)) if d == "cuda" else 0,
            f"per-frame --flow_ema on the {ch}x{cw} crop, --device {d}")
        outs[d] = styled_pngs(wd)
    if not len(outs["cuda"]) == len(outs["cpu"]) == n:
        fail("the crop runs did not write every styled frame")
    mae = max(float(np.abs(a - b).mean()) for a, b in zip(outs["cuda"], outs["cpu"]))
    log(f"per-frame --flow_ema, card vs CPU on the {ch}x{cw} crop: MAE {mae:.3g} "
        f"(bound {PF_MAE_TOL})")
    if not mae <= PF_MAE_TOL or outs["cuda"][-1].std() < 1e-2:
        fail("the per-frame path on the card disagrees with the CPU path")

    img, img_out = workdir / "pf_in.png", workdir / "pf_out.png"
    Image.fromarray(frames[0]).save(img)
    run(["--input_image", img, "--output_image", img_out, "--model", CKPT, "--io_preset",
         "raw_01", "--work_dir", workdir / "_pfi", "--clean_work_dir"], 0,
        "single-image mode at 1080p")
    styled = np.asarray(Image.open(img_out).convert("RGB"))
    if styled.shape != (H, W, 3) or styled.std() < 1.0:
        fail(f"the single-image output is {styled.shape}, std {styled.std():.3g}")

    out, wd = workdir / "pf_off.mp4", workdir / "_pfo"
    run(["--input_video", src, "--output_video", out, "--model", CKPT, "--stream", "off",
         "--frame_batch", B, "--flow_ema", "--work_dir", wd], levels * -(-n // B),
        f"--stream off --frame_batch {B} --flow_ema on a {n}-frame 1080p mp4")
    if clip_frame_count(out) != n or len(styled_pngs(wd)) != n:
        fail("--stream off did not write and assemble every frame")
    return launches


def nst_checkpoint(path: Path) -> Path:
    """A full-width NST_Train net from the seed, saved in the reference key
    layout (``down1.conv.weight`` …)."""
    import torch

    from neuralstyletransferv1_torch.models import transformer_net_nst as tn

    torch.save(tn.init(SEED), path)
    return path


def nst_chain_phase(dev, ckpt: Path):
    """The NST int8_static res chain (5 × K2 + 5 × K3, zero halo, sw = 500)
    on the card and on the CPU (their plain versions) from one 1080p frame's
    res-chain input and one calibration: bit-identical."""
    import copy

    import torch

    from neuralstyletransferv1_torch.engine import stylizer as st
    from neuralstyletransferv1_torch.models import transformer_net_nst_fast as nstf

    model = st.load_model(ckpt, device=dev)
    x = torch.from_numpy(moving_frames(1, H, W, SEED + 8)[0][None]).to(dev).float() / 255.0
    stats = nstf.calibrate_in_stats(model.net, x)
    quant = nstf.quantize_net(model.net, nstf.calibrate_act_scales(model.net, x,
                                                                    static_stats=stats))
    nb = copy.deepcopy(model.net).to(torch.bfloat16)
    grab = {}

    def tap(site, t):
        if site == "r1a":
            grab["y"] = t.contiguous()

    with torch.no_grad():
        nstf.apply(nb, x.to(torch.bfloat16), tap=tap, static_stats=stats)
        outs = []
        for d in (dev, torch.device("cpu")):
            net_d = copy.deepcopy(nb).to(d)
            st_d = {k: (m.to(d), inv.to(d)) for k, (m, inv) in stats.items()}
            sites = nstf.prepare_sites(net_d, quant, d)
            outs.append(nstf.res_chain_s8_static(grab["y"].to(d), net_d, sites, st_d).cpu())
    y = grab["y"]
    same = torch.equal(*outs)
    log(f"NST int8_static res chain on one 1080p frame (grid {y.shape[1]}x{y.shape[2]}, "
        f"padded to %8 with sw), card vs CPU: {'bit-identical' if same else 'DIFFERENT'}")
    if not same:
        fail("the NST int8_static chain differs between the card and the CPU")
    if not bool(torch.isfinite(outs[0].float()).all()) or outs[0].shape != y.shape:
        fail(f"the NST chain output is {tuple(outs[0].shape)} or not finite")


def reco_checkpoint(path: Path, frn: bool) -> Path:
    """A full-width ReCoNet net (3→48→96→192, 4 res blocks at 192,
    192→96→48→3; IN or FRN/TLU) from the seed, saved in the reference key
    layout (``encoder.layers.0.layers.0.layers.1.weight`` …)."""
    import torch

    from neuralstyletransferv1_torch.models import reconet as rn

    torch.save(rn.init(SEED, frn), path)
    return path


def reco_chain_phase(dev, ckpts: dict):
    """For the IN and the FRN net: the int8_static chains (the s8 res chain,
    4 × K2 + 4 × K3, then dec_i8's 2 × K4, frozen norms) on the card and on
    the CPU (their plain versions) from one res-chain input of a 256×480
    crop of a 1080p frame (a 64 × 120 res grid) and one calibration:
    bit-identical; then ``--quantize int8`` on one 1080p batch through
    ``jit_stylizer`` with ``RECO_SKIP`` 1 and 0: 7 × K4 + 3 × K5 and 10 × K4,
    the two stylizes bit-identical (the skip fold is exact)."""
    import copy
    import os

    import numpy as np
    import torch

    from neuralstyletransferv1_torch.engine import stylizer as st
    from neuralstyletransferv1_torch.models import io_presets as iop
    from neuralstyletransferv1_torch.models import reconet_fast as rf

    ch, cw = RECO_CROP
    frame = moving_frames(1, H, W, SEED + 10)[0]
    batch = torch.from_numpy(np.stack(moving_frames(B, H, W, SEED + 11))).to(dev).float() / 255.0
    for frn, ckpt in ckpts.items():
        label = "FRN" if frn else "IN"
        model = st.load_model(ckpt, model_type="reconet", device=dev)
        x = iop.preprocess(model.io_preset, torch.from_numpy(frame[None, :ch, :cw]).to(dev)
                           .float() / 255.0)
        fp32 = rf.FastReCoNet(model.net)
        stats = rf.calibrate_in_stats(fp32, x)
        quant = rf.quantize_net(fp32, rf.calibrate_act_scales(fp32, x, static_stats=stats))
        fpb = copy.deepcopy(fp32).to(torch.bfloat16)
        grab = {}

        def tap(site, t):
            if site == "r0a":
                grab["y"] = t.contiguous()

        with torch.no_grad():
            rf.apply(fpb, x.to(torch.bfloat16), tap=tap, static_stats=stats)
            outs = []
            for d in (dev, torch.device("cpu")):
                fpd = copy.deepcopy(fpb).to(d)
                st_d = {k: (m.to(d), inv.to(d)) for k, (m, inv) in stats.items()}
                sites = rf.prepare_sites(fpd, quant, d)
                yr = rf.res_chain_s8_static(grab["y"].to(d), fpd, sites, st_d)
                outs.append((yr.cpu(), rf.dec_i8(yr, fpd, sites, st_d).cpu()))
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        y = grab["y"]
        log(f"ReCoNet {label} int8_static chains (s8 res chain + dec_i8) on a {ch}x{cw} crop "
            f"(res grid {y.shape[1]}x{y.shape[2]}), card vs CPU: "
            f"{'bit-identical' if same else 'DIFFERENT'} (res output and d2 output)")
        if not same:
            fail(f"the ReCoNet {label} int8_static chains differ between the card and the CPU")
        if not all(bool(torch.isfinite(t.float()).all()) for t in outs[0]):
            fail(f"the ReCoNet {label} chain output is not finite")

        got = {}
        fn = st.jit_stylizer(model, dtype=torch.bfloat16, quantize="int8")
        fn(batch[:1])  # calibrates once: both runs take the same int8 sites
        for skip in ("1", "0"):
            os.environ["RECO_SKIP"] = skip  # read at every forward
            try:
                zero_counts()
                got[skip] = fn(batch)
                torch.cuda.synchronize()
                used = {k: v for k, v in read_counts().items() if v}
            finally:
                del os.environ["RECO_SKIP"]
            want = RECO_PER_BATCH["int8"] if skip == "1" else {"res_site": 10}
            log(f"ReCoNet {label} --quantize int8, RECO_SKIP={skip}, one 1080p batch: launches "
                f"{used}, {'as' if used == want else 'NOT as'} expected ({want})")
            if used != want:
                fail(f"ReCoNet int8 with RECO_SKIP={skip} launched {used}, not {want}")
        if not torch.equal(got["1"], got["0"]):
            fail(f"ReCoNet {label} int8 stylizes with and without RECO_SKIP differ")
        log(f"ReCoNet {label} int8 stylize with and without RECO_SKIP: bit-identical")


def reco_cli_phase(dev, workdir: Path, ckpt: Path) -> dict:
    """main() with a ReCoNet slot (``--model_type reconet``, the FRN net,
    ``--quantize int8``) on the synthesized 1080p mp4 of ``cli_phase``:
    every frame written, 7 × K4 + 3 × K5 a batch. Returns the launches."""
    from neuralstyletransferv1_torch.engine import pipeline as tpipe

    src, dst = workdir / "in.mp4", workdir / "reco_out.mp4"
    n = clip_frame_count(src)
    zero_counts()
    t0 = time.perf_counter()
    rc = tpipe.main(["--input_video", str(src), "--output_video", str(dst), "--model", str(ckpt),
                     "--model_type", "reconet", "--frame_batch", str(B), "--flow_ema",
                     "--compute_dtype", "bfloat16", "--quantize", "int8",
                     "--work_dir", str(workdir / "_reco")])
    secs = time.perf_counter() - t0
    used = {k: v for k, v in read_counts().items() if v}
    batches = -(-n // B)
    want = {k: v * batches for k, v in RECO_PER_BATCH["int8"].items()}
    got = clip_frame_count(dst)
    log(f"main() --model_type reconet (FRN) --quantize int8 on a {n}-frame 1080p mp4: rc {rc}, "
        f"{got} frames written, {secs:.2f} s, launches {used}")
    if rc != 0 or got != n or {k: used.get(k, 0) for k in want} != want or \
            not used.get("dis_iter"):
        fail(f"main() did not style the clip with the ReCoNet slot as expected ({want})")
    return used


def t7_checkpoint(path: Path, norm: str) -> Path:
    """A full-width eccv16 Torch7 net (``t7_net_layers``, seed SEED) written
    to a ``.t7`` file."""
    return write_t7(path, t7_net_layers(SEED, norm))


def t7_kernel_phase(dev, int8: dict):
    """K4 (a- and b-site forms) and K5 with the zero halo against their
    reflect forms at the Torch7 res grid (1080p B=8, 270 × 480 × 128), on
    the same inputs, in turns: reflect, zero, zero, reflect. Both forms'
    outputs are checked against their plain versions in phase 5; here the
    zero form's border must differ from the reflect form's. The times join
    the kernels line's "t7/…" cases."""
    import torch

    for i, (name, form) in enumerate((("res_site", "a"), ("res_site", "b"),
                                      ("res_site_skip", "a"))):
        b, h, w, c, co, _ = SITE_SHAPES["t7"]
        t = site_inputs(dev, b, h, w, c, co, seed=400 + i)
        zero = site_calls(name, t, "t7", form)[0]
        refl = site_calls(name, t, "t7", form, halo="reflect")[0]
        oz, orf = zero()[0], refl()[0]
        torch.cuda.synchronize()
        if torch.equal(oz[:, 0], orf[:, 0]) or not torch.equal(oz[:, 1:-1, 1:-1],
                                                               orf[:, 1:-1, 1:-1]):
            fail(f"{name}/{form}: the zero and reflect halos do not differ only on the border")
        del oz, orf
        t_r = dev_time(refl)
        t_z = (dev_time(zero) + dev_time(zero)) / 2
        t_r = (t_r + dev_time(refl)) / 2
        per = int8[name]["per_case"][f"t7/{form}"]
        per.update(zero_turns_ms=t_z, reflect_turns_ms=t_r)
        log(f"{name}/{form} 1080p B={b} {h}x{w}x{c}: zero halo {t_z:.4f} ms, reflect halo "
            f"{t_r:.4f} ms in turns ({t_z / t_r - 1:+.2%}); the borders differ, the interiors "
            "agree")
        del t, zero, refl
        torch.cuda.empty_cache()


def t7_chain_phase(dev, ckpt: Path):
    """The BN-folded Torch7 graph's res chain forced onto ``res_i8`` (6 × K4
    + 4 × K5, zero halo; every quantize affine a constant) on the card and
    on the CPU (the plain versions) from one 1080p frame's res-chain input
    and one calibration: bit-identical."""
    import torch

    from neuralstyletransferv1_torch.engine import stylizer as st
    from neuralstyletransferv1_torch.io import t7_fast as tf
    from neuralstyletransferv1_torch.models import io_presets as iop

    model = st.load_model(ckpt, device=dev)
    p32 = tf.params_to(tf.try_fast_johnson(model.net), dev)
    x = torch.from_numpy(moving_frames(1, H, W, SEED + 12)[0][None]).to(dev).float() / 255.0
    xin = iop.preprocess(model.io_preset, x)
    quant = tf.quantize_t7(p32, tf.calibrate_t7_scales(p32, xin))
    pb = tf.params_to(p32, dev, torch.bfloat16)
    grab = {}
    with torch.no_grad():
        tf.t7_fast_apply(pb, xin.to(torch.bfloat16),
                         tap=lambda site, t: grab.setdefault(site, t.contiguous()))
        outs = []
        for d in (dev, torch.device("cpu")):
            p_d = tf.params_to(pb, d, torch.bfloat16)
            zero_counts()
            outs.append(tf._t7_res_chain_i8(grab["r0a"].to(d), p_d["res"],
                                            tf.prepare_sites(p_d, quant, d)).cpu())
            if d.type == "cuda":
                torch.cuda.synchronize()
                used = {k: v for k, v in read_counts().items() if v}
                if used != {"res_site": 6, "res_site_skip": 4}:
                    fail(f"the t7 BN res_i8 chain launched {used}")
    y = grab["r0a"]
    same = torch.equal(*outs)
    log(f"t7 BN res_i8 chain (6 x K4 + 4 x K5, zero halo) on one 1080p frame (grid "
        f"{y.shape[1]}x{y.shape[2]}x{y.shape[3]}), card vs CPU: "
        f"{'bit-identical' if same else 'DIFFERENT'}")
    if not same:
        fail("the t7 BN res_i8 chain differs between the card and the CPU")
    if not bool(torch.isfinite(outs[0].float()).all()) or outs[0].shape != y.shape:
        fail(f"the t7 chain output is {tuple(outs[0].shape)} or not finite")


def t7_cli_phase(dev, workdir: Path, ckpt: Path) -> dict:
    """main() with a ``.t7`` slot (the instance-norm net, by its suffix;
    ``--quantize int8``) on the synthesized 1080p mp4 of ``cli_phase``:
    every frame written, 6 × K4 + 4 × K5 a batch. Returns the launches."""
    from neuralstyletransferv1_torch.engine import pipeline as tpipe

    src, dst = workdir / "in.mp4", workdir / "t7_out.mp4"
    n = clip_frame_count(src)
    zero_counts()
    t0 = time.perf_counter()
    rc = tpipe.main(["--input_video", str(src), "--output_video", str(dst), "--model", str(ckpt),
                     "--frame_batch", str(B), "--flow_ema", "--compute_dtype", "bfloat16",
                     "--quantize", "int8", "--work_dir", str(workdir / "_t7")])
    secs = time.perf_counter() - t0
    used = {k: v for k, v in read_counts().items() if v}
    batches = -(-n // B)
    want = {k: v * batches for k, v in T7_PER_BATCH[("in", "int8")].items()}
    got = clip_frame_count(dst)
    log(f"main() on a .t7 slot (IN) --quantize int8 on a {n}-frame 1080p mp4: rc {rc}, {got} "
        f"frames written, {secs:.2f} s, launches {used}")
    if rc != 0 or got != n or {k: used.get(k, 0) for k in want} != want or \
            not used.get("dis_iter"):
        fail(f"main() did not style the clip with the .t7 slot as expected ({want})")
    return used


def t7_net_layers(seed: int, norm: str, c0: int = 32, nres: int = 5) -> list:
    """The eccv16 Johnson topology as a layer list (the dicts of
    ``io/t7.build_t7_layers``): conv 9×9 3→c0, 3×3 s2 c0→2c0, 3×3 s2
    2c0→4c0, ``nres`` residual blocks at 4c0 (zero pad 1), transposed convs
    k3 s2 pad 1 adj 1 4c0→2c0→c0, conv 9×9 c0→3, Tanh, MulConstant(150);
    every conv followed by ``norm`` ("bn": SpatialBatchNormalization with
    running statistics, "in": InstanceNormalization). Random weights from
    the numpy ``seed``, scaled so that the activations stay O(1) and the
    output spreads over the tanh."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def conv(ci, co, k, s, p, gain=1.4):
        return {"op": "conv", "w": rng.normal(0, gain / np.sqrt(k * k * ci), (k, k, ci, co))
                .astype(np.float32), "b": rng.normal(0, 0.05, co).astype(np.float32),
                "stride": (s, s), "pad": (p, p)}

    def convT(ci, co):
        return {"op": "conv_transpose", "w": rng.normal(0, 2.0 / np.sqrt(9 * ci), (3, 3, co, ci))
                .astype(np.float32), "b": rng.normal(0, 0.05, co).astype(np.float32),
                "stride": 2, "pad": 1, "adj": 1}

    def nrm(c):
        d = {"op": "batchnorm" if norm == "bn" else "instancenorm",
             "weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
             "bias": rng.normal(0, 0.1, c).astype(np.float32),
             "running_mean": None, "running_var": None, "eps": 1e-5}
        if norm == "bn":
            d["running_mean"] = rng.normal(0, 0.2, c).astype(np.float32)
            d["running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        return d

    relu = {"op": "relu"}
    first = conv(3, c0, 9, 1, 4)
    first["w"] /= 60.0  # the caffe_bgr input spans about ±128
    ls = [first, nrm(c0), relu, conv(c0, 2 * c0, 3, 2, 1), nrm(2 * c0), relu,
          conv(2 * c0, 4 * c0, 3, 2, 1), nrm(4 * c0), relu]
    for _ in range(nres):
        body = [conv(4 * c0, 4 * c0, 3, 1, 1), nrm(4 * c0), dict(relu),
                conv(4 * c0, 4 * c0, 3, 1, 1, gain=0.5), nrm(4 * c0)]
        ls += [{"op": "concat_table", "branches": [body, []]}, {"op": "add_table"}]
    ls += [convT(4 * c0, 2 * c0), nrm(2 * c0), dict(relu), convT(2 * c0, c0), nrm(c0),
           dict(relu), conv(c0, 3, 9, 1, 4, gain=1.0), {"op": "tanh"},
           {"op": "mul", "c": 150.0}]
    return ls


def t7_modules(layers: list) -> tuple:
    """A layer list as the Torch7 module tree it flattens from: an
    ``nn.Sequential`` of ("module", class name, state table) entries, tensors
    numpy (conv weights OIHW, transposed-conv weights [Cin, Cout, kH, kW])."""
    import numpy as np

    def seq(ls):
        return ("module", "nn.Sequential",
                {"modules": {float(i + 1): module(l) for i, l in enumerate(ls)}})

    def module(l):
        op = l["op"]
        if op in ("conv", "conv_transpose"):
            w = np.transpose(l["w"], (3, 2, 0, 1))  # HWIO → OIHW; [k,k,Co,Ci] → [Ci,Co,k,k]
            st, pd = l["stride"], l["pad"]
            st = st if isinstance(st, tuple) else (st, st)
            pd = pd if isinstance(pd, tuple) else (pd, pd)
            state = {"weight": w, "bias": l["b"], "dH": st[0], "dW": st[1], "padH": pd[0],
                     "padW": pd[1], "kH": w.shape[2], "kW": w.shape[3]}
            if op == "conv":
                return ("module", "nn.SpatialConvolution", state)
            state.update(adjH=l["adj"], adjW=l["adj"])
            return ("module", "nn.SpatialFullConvolution", state)
        if op in ("batchnorm", "instancenorm"):
            state = {k: l[k] for k in ("weight", "bias", "running_mean", "running_var")
                     if l.get(k) is not None}
            state["eps"] = l["eps"]
            return ("module", "nn.SpatialBatchNormalization" if op == "batchnorm"
                    else "nn.InstanceNormalization", state)
        if op == "concat_table":
            return ("module", "nn.ConcatTable",
                    {"modules": {float(i + 1): seq(b) if b else ("module", "nn.Identity", {})
                                 for i, b in enumerate(l["branches"])}})
        if op == "mul":
            return ("module", "nn.MulConstant", {"constant_scalar": l["c"]})
        if op in ("zero_pad", "reflect_pad"):
            return ("module", "nn.SpatialZeroPadding" if op == "zero_pad"
                    else "nn.SpatialReflectionPadding",
                    {f"pad_{s}": l["pad"] for s in "lrtb"})
        names = {"relu": "nn.ReLU", "tanh": "nn.Tanh", "add_table": "nn.CAddTable"}
        return ("module", names[op], {})

    return seq(layers)


def write_t7(path: Path, layers: list) -> Path:
    """Serialize a layer list (``t7_modules``) in the Torch7 binary format
    of ``torch/File.c``: little-endian, every table and object with a heap
    index, classes as "V 1" + name, float tensors on float storages."""
    import struct

    import numpy as np

    out = bytearray()
    heap = [0]

    def i32(v):
        out.extend(struct.pack("<i", v))

    def i64(v):
        out.extend(struct.pack("<q", v))

    def text(v):
        b = v.encode()
        i32(len(b))
        out.extend(b)

    def index():
        heap[0] += 1
        i32(heap[0])

    def value(v):
        if isinstance(v, str):
            i32(2)
            text(v)
        elif isinstance(v, (int, float)):
            i32(1)
            out.extend(struct.pack("<d", float(v)))
        elif isinstance(v, np.ndarray):
            a = np.ascontiguousarray(v, np.float32)
            i32(4)
            index()
            text("V 1")
            text("torch.FloatTensor")
            i32(a.ndim)
            for n in a.shape:
                i64(n)
            for st in a.strides:
                i64(st // 4)
            i64(1)  # storage offset, 1-based
            i32(4)
            index()
            text("V 1")
            text("torch.FloatStorage")
            i64(a.size)
            out.extend(a.tobytes())
        elif isinstance(v, dict):
            i32(3)
            index()
            i32(len(v))
            for k, e in v.items():
                value(k)
                value(e)
        else:  # ("module", typename, state)
            i32(4)
            index()
            text("V 1")
            text(v[1])
            value(v[2])

    value(t7_modules(layers))
    path.write_bytes(bytes(out))
    return path


MMA_FORMS = {("0", "0"): "K4", ("2", "2"): "K3", ("0", "1"): "K2", ("0", "3"): "K2 floored emit",
             ("1", "0"): "K5", ("3", "0"): "K5 act", ("4", "0"): "K4 cast",
             ("0", "4"): "K4 no stats"}


def ptxas_report(text: str, k1, k8, k9, k12) -> None:
    """ptxas' registers and spills of every kernel entry of one build log,
    and the dynamic shared memory of the tensor-core cores' instantiations
    (mma_kernel<C, prologue, epilogue, tau, zero>: <C, 0, 0> is K4, <C, 2, 2> K3,
    <C, 0, 1> K2, <192, 0, 3> K2's floored emit, <C, 1, 0> K5, <192, 3, 0> K5
    with the post-add activation, <128, 4, 0> K4's cast form, <128, 0, 4> its
    no-statistics form; tau 1: K4 with the TLU floor; zero 1: K2, K4 or K5
    under the zero halo; mma_s2_kernel<C, MCO> is K8a at C = 32, K8b at 64;
    d3s8_mma_kernel K6 and d3rows_mma_kernel K7 (rows_kernel<2, 2>, <0, 1>
    their previous cores); d3sum_mma_kernel K9b and d3rows_wgmma_kernel K9e
    (rows_kernel_bf16<1>, <0> their previous cores); dis_iter_kernel K1 (at
    R = 6; dis_iter_prev_kernel its previous core); d2_wgmma_kernel K9a
    (site_kernel_bf16<64, 1, ...> its previous core); s2_mma_bf16_kernel<C,
    CO, TH, buffers> K9c at C = 32, K9d at 64 (site_kernel_bf16<C, 2, ...>
    their previous cores); shift_wgmma_kernel<A bf16,
    prologue, epilogue, 128> K12 and shift_dot_kernel its previous core, at
    probe 2's and the strip form's shared memory; fused_wgmma_kernel<prologue,
    statistics, 128> K10 and site_kernel_bf16<128, 1, 1, ...> its previous
    core; c1_wgmma_kernel K11 and c1_kernel its previous core;
    pad_inject_v2_kernel<inject, pieces a unit> K13 and pad_inject_kernel
    its previous core), and ptxas' warnings (a serialized wgmma)."""
    import re

    name, spill = None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif "C75" in line:  # e.g. wgmma serialized
            log("ptxas warning:" + re.sub(r"_ZN\w*?_cu_[0-9a-f]+", "", line.split(":", 1)[-1]))
        elif name and "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif name and "registers" in line:
            # the kernel's own name: the last of the mangled name's
            # length-prefixed identifiers (the anonymous namespace's hashed
            # name may hold a digit run that looks like one), and its int
            # template arguments
            base = ([m.group(2) for m in re.finditer(r"(?=(\d+)([a-z][a-z0-9_]*?)(?=[IE]))", name)
                     if len(m.group(2)) == int(m.group(1))] or [name])[-1]
            targs = re.findall(r"L[ib](-?\d+)E", name)
            short = f"{base}<{', '.join(targs)}>" if targs else base
            smem = None
            if base == "mma_kernel":
                short += f" ({MMA_FORMS[targs[1], targs[2]]})"
                smem = k8._lib().mma_kernel_smem_bytes(int(targs[0]))
            elif base == "mma_s2_kernel":
                short += " (K8a)" if targs[0] == "32" else " (K8b)"
                smem = k8._lib().mma_s2_smem_bytes(int(targs[0]))
            elif base == "d3s8_mma_kernel":
                short += " (K6)"
                smem = k8._lib().d3s8_mma_smem_bytes()
            elif base == "d3rows_mma_kernel":
                short += " (K7)"
                smem = k8._lib().d3rows_mma_smem_bytes()
            elif base == "rows_kernel":
                short += " (K7, previous core)" if targs == ["0", "1"] else \
                    " (K6, previous core)"
            elif base == "rows_kernel_bf16":
                short += " (K9b, previous core)" if targs == ["1"] else " (K9e, previous core)"
            elif base == "d3rows_wgmma_kernel":
                short += " (K9e)"
                smem = k9._lib().d3_rows_smem_bytes()
            elif base == "dis_iter_kernel":
                short += " (K1)"
                smem = k1._lib().dis_iter_smem_bytes(20)
            elif base == "dis_iter_prev_kernel":
                short += " (K1, previous core)"
            elif base == "d3sum_mma_kernel":
                short += " (K9b)"
                smem = k9._lib().d3sum_mma_smem_bytes()
            elif base == "d2_wgmma_kernel":
                short += " (K9a)"
                smem = k9._lib().d2_wgmma_smem_bytes()
            elif base == "site_kernel_bf16" and targs[:2] == ["64", "1"]:
                short += " (K9a, previous core)"
            elif base == "s2_mma_bf16_kernel":
                short += " (K9c)" if targs[0] == "32" else " (K9d)"
                smem = k9._lib().s2_bf16_smem_bytes(int(targs[0]))
            elif base == "site_kernel_bf16" and targs[1:2] == ["2"]:
                short += " (K9c, previous core)" if targs[0] == "32" else " (K9d, previous core)"
            elif base == "shift_wgmma_kernel":
                pro = "none" if targs[1] == "0" else "quant"
                short += " (K12)"
                smem = (f"{k12.smem_plan([0], pro)['bytes']} (probe 2) / "
                        f"{k12.smem_plan(k12.strip_offsets(488), pro)['bytes']} (strip)")
            elif base == "shift_dot_kernel":
                short += " (K12, previous core)"
            elif base == "fused_wgmma_kernel":
                short += " (K10)"
                smem = k9.occupancy()["fused_conv"][1]
            elif base == "c1_wgmma_kernel":
                short += " (K11)"
                smem = k9._lib().c1_wgmma_smem_bytes()
            elif base == "c1_kernel":
                short += " (K11, previous core)"
            elif base == "pad_inject_v2_kernel":
                short += " (K13)"
            elif base == "pad_inject_kernel":
                short += " (K13, previous core)"
            elif base == "site_kernel_bf16" and targs[:3] == ["128", "1", "1"]:
                short += " (K10, previous core)"
            extra = "" if smem is None else f", {smem} bytes dynamic shared memory"
            log(f"ptxas: {short}: {line.split(':', 1)[-1].strip()}; {spill}{extra}")
            name = None


PHASES = ("next tile's loads issued", "MMAs issued", "fragment epilogue (MMA drain incl.)",
          "stores and sums", "next tile's quantize / copy")
# K8a's and K8b's tile loop, and K6's and K9b's row loop (warp 0 of each block)
PHASES_S2 = ("quantize, loads ahead issued", "MMAs issued", "fragment epilogue (MMA drain incl.)",
             "stores and sums", "wait for the tile's raw input")
PHASES_D3 = ("next rows' loads issued", "wait for the row's codes", "MMAs issued",
             "K lanes and dy-sum (MMA drain incl.)", "the row's stores")
PHASES_D3_BF16 = ("next row's loads issued", "wait for the row's raw input", "activation",
                  "MMAs issued", "K lanes, dy-sum and stores (MMA drain incl.)")
# K7's item loop (warp 0 of each block)
PHASES_D3_ROWS = ("wait for the next item's raw input", "its quantize, the loads after issued",
                  "MMAs issued", "fragment epilogue (MMA drain incl.)", "the item's stores")
# K12's (shift_wgmma_kernel) and K10's (fused_wgmma_kernel) tile loops
PHASES_K12 = ("wait for a k-chunk's rows", "wait for a tap's weights", "prologue conversion",
              "fragments and MMAs issued", "epilogue (MMA drain incl.)")
PHASES_K10 = ("wait for the tile's input", "activation", "wait for a tap's weights",
              "fragments and MMAs issued", "epilogue and statistics (MMA drain incl.)")
# K9c's and K9d's tile loop (s2_mma_bf16_kernel: its consumer warp 0)
PHASES_S2_BF16 = ("wait for the tile's activated input (the producer warps)",
                  "wgmma groups issued (the tile before's buffer released)",
                  "fragment epilogue: staging and sums (MMA drain incl.)",
                  "the TMA stores issued", "the last image's sums (once)")
# K9e's item loop (d3rows_wgmma_kernel: its consumer warp 0)
PHASES_K9E = ("wait for the item's activated input (the producer warps)",
              "the wgmma group and the item before's store issued", "MMA drain",
              "staging the bf16 lanes", "the last item's store (once)")
# K11's tile loop (c1_wgmma_kernel: the first consumer warpgroup's warp 0)
PHASES_K11 = ("wait for the tile's input rows (the producer warps)",
              "A loads and wgmma groups (their drain and the tile before's store issue incl.)",
              "wait for the output buffer (the store two tiles back)",
              "staging bf16(acc + bias) by stmatrix",
              "the other warpgroup's tile skipped, the next tile's place")
PHASES_K9A = ("wait for the tile's input", "the first tile's halo patch and activation",
              "wait for the weights (once)",
              "fragments and MMAs issued (the next tile's patch and activation between)",
              "epilogue and statistics (MMA drain incl.)")


def _phase_build(module):
    """nvcc of ``module``'s source with MMA_PHASE_CLOCKS, started: (the
    library's path, the process)."""
    from neuralstyletransferv1_torch.kernels import _build

    src = _build.CSRC / module._SOURCE
    so = _build.BUILD_DIR / f"lib{src.stem}_phases.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DMMA_PHASE_CLOCKS", "-o", str(so), str(src)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _phase_lib(module, so, proc, names):
    """The instrumented build, once nvcc is done, its launch functions
    ``names`` given the argtypes of the module's own build."""
    import ctypes

    out = proc.communicate(timeout=600)[0]
    if proc.returncode != 0:
        fail(f"nvcc -DMMA_PHASE_CLOCKS failed for {module._SOURCE}:\n{out}")
    lib = ctypes.CDLL(str(so))
    for name in names:
        getattr(lib, name).argtypes = getattr(module._lib(), name).argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.mma_phase_clocks_read.argtypes = [ctypes.c_void_p]
    return lib


def _phase_shares(lib, kernel, label, labels):
    """Run ``kernel`` once between two reads (and zeroings) of the clocks;
    log the share of each phase, averaged over the blocks that ran."""
    import numpy as np
    import torch

    clocks = np.zeros((1024, 5), dtype=np.uint64)  # the source's [kPhaseBlocks][kPhases]
    if lib.mma_phase_clocks_read(clocks.ctypes.data) != 0:
        fail("reading mma_phase_clocks failed")
    kernel()
    torch.cuda.synchronize()
    if lib.mma_phase_clocks_read(clocks.ctypes.data) != 0:
        fail("reading mma_phase_clocks failed")
    used = clocks[clocks.sum(axis=1) > 0].astype(np.float64)
    share = used.mean(axis=0) / used.sum(axis=1).mean()
    log(f"phases {label}: {len(used)} blocks, {used.sum(axis=1).mean():.0f} cycles a block; " +
        ", ".join(f"{ph} {sh:.1%}" for ph, sh in zip(labels, share)))


def phases_phase(dev):
    """--phases: the tensor-core cores (K2-K8b; K9a-K9e; K12, K10, K11) built
    with MMA_PHASE_CLOCKS, each of their 1080p B=8 cases (K12: the probes'
    shapes) run once; the share of each phase of the tile loop (K6, K7, K9b:
    of warp 0's row loop) in the clock of every block's thread 0, averaged
    over blocks."""
    import torch

    from neuralstyletransferv1_torch.kernels import bf16_sites as k9
    from neuralstyletransferv1_torch.kernels import int8_probes as k12
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    builds = [_phase_build(k8), _phase_build(k9), _phase_build(k12)]  # all nvcc at once
    lib8 = _phase_lib(k8, *builds[0], ("res_site_s8o_launch", "site_s8_launch",
                                       "res_site_launch", "res_site_skip_launch",
                                       "site_s2_launch", "d3_s8_launch", "d3_rows_launch"))
    lib9 = _phase_lib(k9, *builds[1], ("d3_sum_site_launch", "fused_conv_launch",
                                       "d2_site_launch", "c2_site_bf16_launch",
                                       "c3_site_bf16_launch", "d3_rows_launch",
                                       "c1_site_launch"))
    lib12 = _phase_lib(k12, *builds[2], ("shift_dot_launch", "shift_dot_smem_bytes"))
    base8, base9, base12 = k8._lib, k9._lib, k12._lib
    # the wrappers launch the instrumented builds
    k8._lib, k9._lib, k12._lib = (lambda: lib8), (lambda: lib9), (lambda: lib12)
    try:
        for name in REDESIGNED:
            for shape, form in INT8_KERNELS[name][0]:
                t = site_inputs(dev, *SITE_SHAPES[shape][:5], seed=11)
                kernel = site_calls(name, t, shape, form)[0]
                labels = {"d3_s8_site": PHASES_D3, "d3_rows_site": PHASES_D3_ROWS,
                          "c2_site": PHASES_S2, "c3_site": PHASES_S2}.get(name, PHASES)
                _phase_shares(lib8, kernel, f"{name} @ {shape}{'/' + form if form else ''}",
                              labels)
                del t, kernel
                torch.cuda.empty_cache()
        for name in BF16_KERNELS:
            shape = BF16_KERNELS[name][0]
            args = bf16_site_inputs(dev, name, shape, seed=11)
            _phase_shares(lib9, lambda: getattr(k9, name)(*args), f"{name} @ {shape}",
                          {"d2_site": PHASES_K9A, "c2_site_bf16": PHASES_S2_BF16,
                           "c3_site_bf16": PHASES_S2_BF16,
                           "d3_rows": PHASES_K9E}.get(name, PHASES_D3_BF16))
            del args
            torch.cuda.empty_cache()
        for label, call in k12_phase_cases(dev, k12):
            _phase_shares(lib12, call, f"shift_dot {label}", PHASES_K12)
        torch.cuda.empty_cache()
        from neuralstyletransferv1_torch.experiments import mk1_fusedconv as mk1

        ins = mk1.inputs(mk1.FULL, 11, dev)
        for prologue, stats in (("f32", True), ("none", False)):
            _phase_shares(lib9, lambda: k9.fused_conv(ins["x_pad"], ins["stat"], ins["w9"],
                                                      ins["cb"], mk1.FULL[1:3],
                                                      prologue=prologue, stats=stats),
                          f"fused_conv {prologue}{'' if stats else '/ns'} @ {mk1.FULL}",
                          PHASES_K10)
        del ins
        torch.cuda.empty_cache()
        import numpy as np

        from neuralstyletransferv1_torch.experiments import mk13_c1 as mk13

        wb, cb = (t.to(dev) for t in mk13.block_conv1_weights(*mk13.conv1_params(mk13.CKPT)))
        b, h, w = mk13.FULL
        x01 = torch.from_numpy(np.random.default_rng(11).random((b, h, w, 3), dtype=np.float32))
        y12 = mk13.block_input(x01.to(dev).to(torch.bfloat16))
        _phase_shares(lib9, lambda: k9.c1_site(y12, wb, cb),
                      f"c1_site @ {tuple(y12.shape)}", PHASES_K11)
        del y12, x01
        torch.cuda.empty_cache()
    finally:
        k8._lib, k9._lib, k12._lib = base8, base9, base12


def k12_phase_cases(dev, k12):
    """(label, call) of K12 at the probes' shapes: mk20's probe 2 (s8 → s32,
    bf16 → f32), mk27's s8 form at G = 32, mk21's tap9 strip (int8, bf16)."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.experiments import _bench

    rng = np.random.default_rng(11)

    def ints(*shape):
        return torch.from_numpy(rng.integers(-100, 100, shape).astype(np.int8)).to(dev)

    a8, w8 = ints(16384, 512), k12.pack_taps(ints(1, 512, 256))
    ab, wb = _bench.normal(rng, (16384, 512), 1.0, dev), k12.pack_taps(
        _bench.normal(rng, (1, 512, 256), 1.0, dev))
    g8, gw = ints(32, 8256, 128), k12.pack_taps(ints(6, 128, 128))
    x = _bench.normal(rng, (8, 274, 488, 128), 1.0, dev)
    w9, w9b = k12.pack_taps(ints(9, 128, 128)), k12.pack_taps(
        _bench.normal(rng, (9, 128, 128), 1.0, dev))
    return [("mk20 P2 int8", lambda: k12.flat_dot(a8, w8, [0], out="s32")),
            ("mk20 P2 bf16", lambda: k12.flat_dot(ab, wb, [0], out="f32")),
            ("mk27 s8_unaligned", lambda: k12.flat_dot(g8, gw, list(range(6)), 8192)),
            ("mk21 tap9-int8", lambda: k12.strip_dot(x, w9, pro="quant", oscale=2.0 ** -8)),
            ("mk21 tap9-bf16", lambda: k12.strip_dot(x, w9b, oscale=2.0 ** -8))]


def kernel_group(name: str) -> str:
    """A device kernel's kind, from its name."""
    n = name.lower()
    if any(k in n for k in ("kernel_bf16", "stats_reduce_bf16", "d3sum_mma", "d2_wgmma",
                            "s2_mma_bf16", "stats_reduce_s2", "d3rows_wgmma")):
        return "bf16 sites K9a-K9e"
    if any(k in n for k in ("site_kernel", "mma_kernel", "mma_s2_kernel", "stats_reduce",
                            "rows_kernel")):
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


def profile_phase(dev, nst_ckpt: Path, reco_ckpts: dict, t7_ckpts: dict):
    """Device time of one steady 1080p B=8 batch of each slice (Johnson,
    NST_Train, ReCoNet, Torch7), by kind of kernel and by kernel
    (torch.profiler after two warm-up batches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from neuralstyletransferv1_torch.engine import pipeline as tpipe

    frames = moving_frames(3 * B, H, W, SEED + 6)
    runs = ([(mode, fused, CKPT, "") for mode, fused in (("none", None), ("bf16_static", None))
             + SLICES] + [(mode, None, nst_ckpt, "nst") for mode in NST_SLICES]
            + [(mode, None, reco_ckpts[frn], f"reco {'frn' if frn else 'in'}")
               for mode, frn in RECO_SLICES]
            + [(mode, None, t7_ckpts[norm], f"t7 {norm}") for norm, mode in T7_SLICES])
    for mode, fused, ckpt, label in runs:
        argv = ["--input_video", "in.mp4", "--output_video", "out.mp4", "--model", str(ckpt),
                "--frame_batch", str(B), "--flow_ema", "--compute_dtype", "bfloat16",
                "--quantize", mode]
        if label.startswith("reco"):
            argv += ["--model_type", "reconet"]
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
        name = f"{label} {mode}" if label else slice_name(mode, fused)
        log(f"profile --quantize {name}: batch wall {wall:.2f} ms, "
            f"device busy {busy:.2f} ms "
            f"({busy / wall:.1%}), {sum(c for _, _, c in kernels)} device kernels and copies")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            log(f"  {g}: {ms:.2f} ms")
        for name, ms, count in sorted(kernels, key=lambda k: -k[1])[:12]:
            log(f"    {ms:8.3f} ms  x{count:<4d} {name[:110]}")


def main() -> int:
    import torch

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
    from neuralstyletransferv1_torch.kernels import int8_probes as k12
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    resolve_device("cuda")  # TF32 off for the f32 paths
    t0 = time.perf_counter()
    _build.build([k1._SOURCE, k8._SOURCE, k9._SOURCE, k12._SOURCE])
    for mod in (k1, k8, k9, k12):
        mod._lib()
    log(f"built K1, K2-K8b, K9a-K11 and K12-K13 with nvcc (in parallel) in "
        f"{time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        return run_phases(dev, Path(tmp), k8)


def run_phases(dev, tmp: Path, k8) -> int:
    import torch

    nst_ckpt = nst_checkpoint(tmp / "nst_random.pth")
    reco_ckpts = {frn: reco_checkpoint(tmp / f"reco_{'frn' if frn else 'in'}.pth", frn)
                  for frn in (False, True)}
    t7_ckpts = {norm: t7_checkpoint(tmp / f"eccv16_{norm}.t7", norm) for norm in ("in", "bn")}
    if sys.argv[1:] in (["--profile"], ["--phases"]):
        if sys.argv[1] == "--profile":
            profile_phase(dev, nst_ckpt, reco_ckpts, t7_ckpts)
        else:
            phases_phase(dev)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0
    try:
        import cv2  # noqa: F401
    except ImportError:
        fail("OpenCV is not installed: the CLI phases need it to synthesize their videos")
    from neuralstyletransferv1_torch.kernels import _build
    from neuralstyletransferv1_torch.kernels import bf16_sites as k9
    from neuralstyletransferv1_torch.kernels import dis_iter as k1
    from neuralstyletransferv1_torch.kernels import int8_probes as k12

    for txt in sorted(_build.BUILD_DIR.glob("*.ptxas.txt")):
        ptxas_report(txt.read_text(), k1, k8, k9, k12)

    k1_rec = k1_phase(dev)
    int8 = int8_kernel_phase(dev)
    bf16 = bf16_kernel_phase(dev)
    exp_launches, exp = experiments_phase(dev)
    ragged_sw_phase(dev)
    ragged_reco_phase(dev)
    ragged_k7_k9a_phase(dev)
    ragged_k9c_k9d_phase(dev)
    ragged_k9e_k1_phase(dev)
    ragged_k11_k13_phase(dev)
    reference_phase(dev)
    quant_reference_phase(dev)
    nst_chain_phase(dev, nst_ckpt)
    reco_chain_phase(dev, reco_ckpts)
    t7_kernel_phase(dev, int8)
    t7_chain_phase(dev, t7_ckpts["bn"])
    launches = {k: 0 for k in read_counts()}
    runs = ([dict(quantize=mode, fused=fused) for mode, fused in (("none", None),) + SLICES]
            + [dict(quantize=mode, nst_ckpt=nst_ckpt) for mode in NST_SLICES]
            + [dict(quantize=mode, reco=(reco_ckpts[frn], frn)) for mode, frn in RECO_SLICES]
            + [dict(quantize=mode, t7=(t7_ckpts[norm], norm)) for norm, mode in T7_SLICES])
    for run in runs:
        for k, v in slice_phase(dev, **run).items():
            launches[k] += v
    cli_phase(dev, tmp)
    for k, v in reco_cli_phase(dev, tmp, reco_ckpts[True]).items():
        launches[k] += v
    for k, v in t7_cli_phase(dev, tmp, t7_ckpts["in"]).items():
        launches[k] += v
    for k, v in per_frame_phase(dev, tmp).items():
        launches[k] += v
    if "jax" in sys.modules:
        fail("jax was imported")

    kernels = [{
        "name": "dis_iter", "route": "cuda",
        "source": "neuralstyletransferv1_torch/csrc/dis_iter.cu",
        "replaces": "neuralstyletransferv1_tpu/ops/dis_flow.py:113",
        "launches": launches["dis_iter"], "bound_by": "bytes", "library_ms": None, **k1_rec,
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
    for name, (source, replaces) in EXP_KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": exp_launches[name], **exp[name],
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
