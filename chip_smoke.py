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
   K2–K8b also beside their previous design (``*_prev``, held to the same
   outputs: the ``__dp4a`` core, and for K4 and K3 at ReCoNet's widths,
   which run on the wgmma core ``csrc/int8_wgmma.cu``, the ``mma_kernel``
   core), in turns: plain, kernel, previous, kernel, previous, plain, and
   two launches of each bit-identical;
   then the f32-operand forms of K2–K5 (the float32 chains' first sites:
   K2 and K3 at Johnson's and NST_Train's res grids and ReCoNet's, K4 at
   Johnson's, ReCoNet's res grid and d1 and the Torch7 grid, K5 at Johnson's,
   ReCoNet's with both activations and the Torch7 grid) with an f32 operand
   that is not bf16-representable: bit-identical to their plain versions,
   two launches bit-identical, timed in turns beside the bf16 form on the
   same shape and beside the plain version; then at ragged shapes (W off
   the 16-column tile, H off the 8-row tile, B = 1 and 3, C = 64 under the
   zero halo, a ragged sw), bit for bit; likewise the float32 forms of
   conv2's and deconv1's sites (K4's 2×2 pad-1 form at NST's conv2 grid
   584×1000 128→64 and its pad-0 form at NST's d1 292×504 128→256 with
   sw 500, K2 at ReCoNet's d1 192→384 with both emits, K8a at
   1080×1920 32→64 on an f32 conv1 output, K7 at deconv3's rows 540×960
   128→60 on an f32 d2 raw), beside the cuDNN f32 conv of the shape (TF32
   off; a yardstick);
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
   other); K9a and K9e with an f32 raw (float32) at the same shapes and at
   ragged ones, held to the K9 bounds, timed beside their bf16 forms; the
   float32 chains of the new f32 forms card vs CPU on a 256×480 crop
   (``f32_chains_phase``); then K7 and K9a at ragged shapes (W off the 32-column strip and
   tile, H below the 8-row tile, B = 1 and 3) against their plain versions
   and previous cores (K7 bit for bit, also its f32 form, K9a within the K9
   bounds, two launches bit-identical), and K9c and K9d likewise (outputs off the
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
   K9a, K9b) and ``("d3",)`` (K9e), and under ``--compute_dtype float32``
   for each of ``int8`` and ``int8_static`` (the f32 forms take block 1's
   sites) and for the sets the JAX forwards run under f32 params that reach
   the other float32 forms (``F32_SETS``: Johnson's ``head_i8`` s8 set
   ending in ``tail_s8``, its ``tail,d3`` and ``d3``, its ``tail_s8`` +
   ``d3_i8`` on the XLA-form decoder (K7 on the f32 d2 raw); NST_Train's and an IN
   Torch7 net's ``c2_i8`` + ``res_i8`` + ``dec_i8``; ReCoNet's s8 set);
   check every kernel's launch count of each
   run exactly, and that each quantized or fused stylize stays within the
   1e-2 MAE gate of the plain stylize in its dtype;
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
   batches over frame files → assemble);
10. regions, masks and the LAB blend at 1080p with two slots: the batched
   core over 2 batches with rotating voronoi regions and ``--mask_dir``,
   then with the LAB blend and ``--mask_dir``, the per-frame loop through
   ``main()`` with the regions and masks, exact launch counts and times;
   then both under float32 on a 128×224 cut-down, card vs CPU within 1e-3;
11. DeepLabV3+ and the sky-swap workflow: the full-width ResNet-101 DeepLab
   (output stride 16, 21 classes, ``init_state_dict`` seed 0) written as a
   ``.pth.tar`` (``state_dict`` wrapper, ``module.`` prefixes) and read
   back through ``apps/sky_swap.load_deeplab``; card vs CPU under f32 at
   129×129 (relative logits MAE ≤ 1e-4, argmax ≥ 99.9% equal); one bf16
   forward at 513² with B = 4 (finite, timed by CUDA events); the
   masked-stylize step at 1080×1920, B = 4, infer_res 513 with the Johnson
   checkpoint: bf16 vs f32 on 2 frames within the 1e-2 gate, steady
   batches timed (CUDA-event median and spread), card vs CPU on a
   1×128×224 cut-down at infer_res 65 (composite ≤ 1e-2, pre-upsample
   alpha ≥ 99% equal); the MobileNetV2, Xception and DRN backbones
   likewise (card vs CPU, a bf16 forward); then ``run_sky_swap.main`` on a
   synthesized 16-frame 1080p mp4 with the workflow's defaults and
   ``PIPELINE_ARGS="--frame_batch 8 --flow_ema --quantize int8_static"``:
   one mask per extracted frame, every frame encoded, K1, K2, K3 and K4
   launched exactly as predicted, the wall time split into extract, masks
   and the stylize pass;
12. the magenta slot, Farneback flow and the Caffe SSD detector, on a
   synthesized 16-frame 1080p mp4: ``main()`` with ``--model_type magenta``
   (the colour transfer: no SavedModel is in the repo; tile 256, overlap
   32: 45 tiles a frame, 360 a batch), ``--frame_batch 8 --flow_ema``, every
   frame encoded, K1's launches exact, the wall split into extract,
   stylize, flow, temporal and encode, the slot's stylize card vs CPU; the
   compact CIN net at full width (``cin_tree``, seeded) on a 1080p B=8
   batch through ``stylize_tiled_batch``, timed, card vs CPU on 6 tiles;
   ``main()`` with ``--flow_method farneback --quantize int8_static`` and
   the Johnson checkpoint on the same clip, K1 0 and K2–K4's launches exact
   (f32 forms included), Farneback's ms a pair at 540×960, card vs CPU on
   one pair and the clip's pan recovered; the SSD detector on a graph and
   seeded caffemodel this script writes (``SSD_PROTOTXT``, ``write_ssd``),
   heads, detections and ``detect_faces`` card vs CPU;
13. the weight ladder and the Gram NST (BASELINE configs #2 and #3, as
   ``bench.py``'s ``_ladder`` and ``_gram_nst`` set them up): a bank of 8
   random full-width Johnson slots (``make_random_model("johnson",
   seed=s)``) through ``jit_ladder_stylizer`` in bf16 on 1080×1920 B=2,
   steady calls timed by CUDA events over rounds with their spread, peak
   memory, the device's busy share (torch.profiler); an NST_Train bank of 4
   rungs likewise; the f32 bank against its models one by one (1e-5), bf16
   against f32 (1e-2 under the bench's ``imagenet_255``, 5e-2 under
   ``raw_01``), card against CPU on a small f32 bank (1e-4); the Gram NST
   (VGG16 from seed 0, content and style uniform at 512², 500 steps, f32):
   a first and a second whole call timed, steps/s, peak memory, the history
   finite and falling, 10 steps profiled (busy share, launches a step),
   card vs CPU over 10 steps at 64²; then ``slow_nst.main`` (20 steps at
   256²) and ``style_all_weights.main`` (two rungs, 4 frames) on the card;
   no kernel of K1–K13 is on this path, and none may launch;
14. ``--mesh_devices``, the job queue and the presets apps: the batched
   core on an explicit 2-shard mesh with both shards on the one card
   against the single-device core (the 1080p slice, 3 batches of 8, bf16,
   ``int8_static`` and ``int8``; the sharded chain alone bit-identical to
   its chunk semantics): smoothing off within 1/255 on ≥ 99.9%; flow EMA +
   LAB EMA each frame's mean |d| within 0.05 of the range (the frames above
   JAX's 4-level engine gate counted), the launches exact (K1 4 a batch; ``int8_static`` K2 10, K3 10, K4 4; ``int8`` K4
   14, K5 10), both cores' s/batch by CUDA events (two shards on one card
   measure the split's overhead, not scaling); ``main()`` with
   ``--mesh_devices 2 --frame_batch 3`` on a 16-frame 1080p clip (JAX's
   clamp line with one card); ``gram_nst.sharded_optimize_step`` on the
   2-shard mesh (2 images at 128², VGG16 from seed 0) within 1e-5 relative
   of the unsharded step; ``run_videos`` and ``drive_videos`` (queue mode,
   one worker) on the clip with their default device, K1's launches exact;
   ``generate_multimodel_presets``, then ``generate_preset_samples --limit
   2``;
15. the threaded frame loader, ``--profile_dir`` and the last ten apps:
   g++, jpeglib.h and png.h looked up on the card's host (a missing one
   printed, and the engine's PIL fallback held instead); the loader built
   with g++ into ``_build/`` (the compiler's last lines printed), 64
   synthesized 1080p PNG frames decoded equal to PIL's and 64 JPEG frames
   within 1 level, native (4 threads) vs serial PIL frames/s; ``main()``
   with ``--stream off --frame_batch 8 --quantize int8_static`` (bf16, flow
   EMA) on 24 JPEG frames: the loader's line printed (not its fallback's),
   K1 4 a batch, K2 5, K3 5, K4 2 exact, the wall split (extract, decode,
   stylize, flow, temporal, encode); the same on 24 PNG frames with the
   loader and without it (no compiler): the styled frames bit-identical;
   ``--profile_dir`` on 16 frames writes a trace; ``optical_flow_morph`` of
   two 1080p images, 72 frames, timed, and card vs CPU at 270×480 (mean
   |Δ| ≤ 1 level, ≥ 99% within 1); each of the ten apps' CLI once on the
   card (``morph``, ``morph_faces``, ``morph_v2 --face`` on the seeded SSD,
   ``morph_slideshow``, ``gen_pytorch_only_videos``,
   ``generate_style_selfstyle``, ``style_mask``, ``generate_mask_samples``,
   ``style_showcase``, ``cryptic_text``) writing its outputs, none
   launching a kernel; ``native/_frameloader.so`` left as it was.

The line before the kernels' record holds the bench's ladder and Gram NST
keys (``ladder_passes_per_sec``, ``ladder_sec_per_pass``,
``gram_nst_500steps_512_sec``); the line before the last is the kernels'
JSON record; the last line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --profile

instead profiles one steady 1080p B=8 batch of each slice (plain bf16,
``bf16_static``, ``int8_static``, ``int8``, the two under sets A and B, the
two bf16 fused-site sets, the four NST_Train, six ReCoNet and six Torch7
slices, the f32 and region slices), one steady batch of the masked-stylize
step (B = 4, 1080p, infer_res 513) and the ResNet-101 DeepLab's forward alone
with torch.profiler and prints where its device time goes, grouped by kind of
kernel (PERF.md section 5); then it times ASPP's atrous convs on
channels-last and on NCHW input; then one batch each of the magenta slot,
the Farneback int8_static slice and the compact CIN net, whose convs it also
times on NCHW copies of their inputs.

    python3 chip_smoke.py --profile reco

profiles the ReCoNet slices alone.

    python3 chip_smoke.py --phases

instead builds the tensor-core cores (K2–K8b and K3/K4's wgmma core;
K9a–K9e; K10, K11, K12) with ``-DMMA_PHASE_CLOCKS`` and prints, for each of
their 1080p B=8 cases (K12: the probes' shapes; K11: mk13's), the share of
each phase of the tile loop (K6, K7, K9b: of the row loop) in the clock of
every block's thread 0; K4's and K3's ReCoNet cases on the wgmma core and
on their previous core.
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
STEADY_BATCHES = 5  # the s8 bench sets' timed batches
K1_OFFSET_TOL = 1e-3   # px, on at least K1_SHARE of the patches
K1_SHARE = 0.99
K1_RES_TOL = 1e-3      # grey levels (0..255), on those patches
SLICE_MAE_TOL = 1e-3   # [0,1] frames, CUDA slice vs CPU slice, f32 + exact warp
QUANT_MAE_TOL = 1e-2   # [0,1] frames: the repo's gate (quantized vs bf16, CUDA vs CPU)
QUANT_BROKEN_TOL = 5e-2  # [0,1] raw-scale stylize: beyond this the path is broken
# the NST_Train sets that quantize the decoder (and conv2 or deconv3) besides
# the res chain: each int8 site adds its noise (1.08-1.33e-2 against bf16 on
# uniform-noise frames at 1080p on the card, against 8.9e-3 for the res chain
# alone; this script's own check, PERF.md), so they are held to
# QUANT_BROKEN_TOL on both inputs

NST_HP = (H + 31) // 32 * 32 + 80         # NST_Train's padded frame height
NST_W8 = ((W + 80) // 4 + 7) // 8 * 8      # and its res grid's width padded to %8
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
               "t7": (B, H // 4, W // 4, 128, 128, "zero"),
               # NST_Train's sites as its int8 path runs them: the frame padded
               # to the int8 8 × 32 multiple (1088 × 1920) and reflect-padded
               # by 40; conv2 on conv1's space-to-depth grid (584 × 1000, 4 ·
               # 32 → 64), the res grid 292 × 504 (sw 500), deconv1 on it
               # (128 → 4 · 64), deconv2 at twice it, 584 × 1008 (sw 1000, 64
               # → 4 · 32)
               "nst_c2": (B, NST_HP // 2, (W + 80) // 2, 128, 64, "zero"),
               "nst_res": (B, NST_HP // 4, NST_W8, 128, 128, "zero"),
               "nst_d1": (B, NST_HP // 4, NST_W8, 128, 256, "zero"),
               "nst_d2": (B, NST_HP // 2, 2 * NST_W8, 64, 128, "zero")}
SITE_SW = {"nst": (W + 80) // 4, "nst_res": (W + 80) // 4, "nst_d1": (W + 80) // 4,
           "nst_d2": (W + 80) // 2}
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
    # the NST_Train int8 path's forms: K4 and K5 with sw (the res chain's a-
    # and b-sites), K4's 2×2 taps at pad 1 (conv2) and pad 0 (the deconvs,
    # floor -127 / 0), K3's at pad 0 (dec_s8's d1 emit, d2's zero2 emit)
    "res_site_sw": ((("nst_res", ""), ("nst_res", "b")), f"{_SITES_I8}:139"),
    "res_site_skip_sw": ((("nst_res", "a"),), f"{_SITES_I8}:299"),
    "res_site_k2p1": ((("nst_c2", ""),), f"{_SITES_I8}:139"),
    "res_site_k2p0": ((("nst_d1", ""), ("nst_d2", "b")), f"{_SITES_I8}:139"),
    "site_s8_k2p0": ((("nst_d1", "s8out"), ("nst_d2", "zero2")), f"{_SITES_I8}:670"),
    # ReCoNet's static-norm decoder (dec_s8): K2 at d1, 192 -> 384 under the
    # edge halo, emitting d2's codes (IN: floor 0; FRN: the tau floor row,
    # qlo -127), and K3 at d2, 96 -> 192, its bare bf16 raw ("raw")
    "res_site_s8o_co384": ((("reco_d1", "in"), ("reco_d1", "frn")), f"{_SITES_I8}:507"),
    "site_s8_c96": ((("reco_d2", "raw"),), f"{_SITES_I8}:670"),
}
# those forms' wrappers and tap geometries (kh, kw, pt, pl); a form counts
# its launches under its own name in k8.FORM_LAUNCHES
FORM_OF = {"res_site_sw": ("res_site", None), "res_site_skip_sw": ("res_site_skip", None),
           "res_site_k2p1": ("res_site", (2, 2, 1, 1)),
           "res_site_k2p0": ("res_site", (2, 2, 0, 0)),
           "site_s8_k2p0": ("site_s8", (2, 2, 0, 0)),
           "res_site_s8o_co384": ("res_site_s8o", None), "site_s8_c96": ("site_s8", None)}
# the f32-operand forms of K2-K5: (the wrapper, its (shape, form) cases where
# the float32 chains run it: Johnson's res grid (block 1's a-site K4 or K2,
# block 2's K5 or block 1's K3), NST_Train's (K2, K3 under the zero halo with
# sw), ReCoNet's (K4 block 0 and d1, K5 with its post-add activation, K2 IN
# and FRN, K3) and the Torch7 one (K4, K5 under the zero halo))
F32_KERNELS = {
    "res_site_s8o_f32": ("res_site_s8o", (("res", ""), ("nst", ""), ("reco_res", "in"),
                                          ("reco_res", "frn"))),
    "site_s8_f32": ("site_s8", (("res", "aff_add"), ("nst", "aff_add"),
                                ("reco_res", "aff_add"))),
    "res_site_f32": ("res_site", (("res", ""), ("reco_res", ""), ("reco_d1", ""), ("t7", "a"))),
    "res_site_skip_f32": ("res_site_skip", (("res", ""), ("reco_res", "relu"),
                                            ("reco_res", "tau"), ("t7", "a"))),
    # the float32 forms of conv2's and deconv1's sites: K4's 2×2 pad-1 form
    # (NST_Train's and Torch7's conv2 on conv1's f32 output, at NST's grid),
    # its pad-0 form (their k3 deconv1 on the f32 res output, NST's with
    # sw), K2 at CO = 384 (ReCoNet's static-norm d1, IN and FRN emits) and
    # K8a (Johnson's conv2 under head_i8, on conv1's f32 output)
    "res_site_k2p1_f32": ("res_site_k2p1", (("nst_c2", ""),)),
    "res_site_k2p0_f32": ("res_site_k2p0", (("nst_d1", ""),)),
    "res_site_s8o_co384_f32": ("res_site_s8o_co384", (("reco_d1", "in"), ("reco_d1", "frn"))),
    "c2_site_f32": ("c2_site", (("c2", ""),)),
    # K7 with the f32 d2 raw (Johnson's d3_i8 on the XLA-form decoder under
    # float32)
    "d3_rows_site_f32": ("d3_rows_site", (("d3", ""),)),
}
# their ragged cases: (B, H, W, C, CO, halo, form, sw)
F32_RAGGED = {
    "res_site_s8o": ((1, 9, 21, 128, 128, "reflect", "", None),
                     (3, 17, 50, 192, 192, "reflect", "frn", None),
                     (2, 11, 40, 128, 128, "zero", "", 36)),
    "site_s8": ((1, 9, 21, 128, 128, "reflect", "", None),
                (3, 13, 37, 192, 192, "reflect", "yaff", None),
                (2, 11, 40, 128, 128, "zero", "", None)),
    "res_site": ((1, 9, 21, 128, 128, "reflect", "", None),
                 (3, 17, 50, 192, 384, "edge", "", None),
                 (2, 11, 37, 64, 64, "zero", "", None)),
    "res_site_skip": ((1, 9, 21, 128, 128, "reflect", "", None),
                      (3, 13, 37, 192, 192, "reflect", "tau", None),
                      (2, 11, 37, 64, 64, "zero", "", None)),
    "res_site_k2p1": ((1, 9, 21, 128, 64, "zero", "", None),
                      (3, 17, 40, 128, 64, "zero", "", None)),
    "res_site_k2p0": ((2, 11, 40, 128, 256, "zero", "b", 36),
                      (1, 9, 21, 128, 256, "zero", "", None)),
    "res_site_s8o_co384": ((1, 9, 24, 192, 384, "edge", "in", None),
                           (3, 17, 40, 192, 384, "edge", "frn", None)),
    "c2_site": ((1, 18, 42, 32, 64, None, "", None), (3, 34, 66, 32, 64, None, "", None)),
}
# K9a and K9e with an f32 raw (float32: deconv1's raw on the 2× grid, the d2
# raw): each form's name and the bf16 site it is a form of (its shape there
# is BF16_KERNELS'); and their ragged shapes (B, H, W)
BF16_F32_KERNELS = {"d2_site_f32": "d2_site", "d3_rows_f32": "d3_rows"}
BF16_F32_RAGGED = ((1, 13, 37), (3, 9, 66), (2, 24, 130))
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
# the NST_Train slices, (--quantize, fused set or None for the adopted one,
# whether the adoption file is absent: the built-in defaults), and their
# site launches a batch: the adopted sets (nst = [] runs the XLA-form int8
# chain, nst_static = res_i8, res_s8 the s8 chain); the defaults (res_i8 in
# both modes: K4/K5 with sw); every other name the JAX NST forward routes on,
# in three sets (the K4 chain with c2_i8 and dec_i8; the s8 chain with c2_i8,
# dec_s8 and tail_s8; the XLA-form references)
NST_I8 = ("c2_i8", "res_i8", "dec_i8")
NST_S8 = ("c2_i8", "res_i8", "res_s8", "dec_s8", "tail_s8")
NST_XLA = ("dec_xla_i8", "tail_xla_i8")
NST_SLICES = (("none", None, False), ("bf16_static", None, False), ("int8", None, False),
              ("int8_static", None, False), ("int8", None, True), ("int8_static", None, True),
              ("int8", NST_I8, False), ("int8_static", NST_S8, False), ("int8", NST_XLA, False))
NST_RES_I8 = {"res_site_sw": 6, "res_site_skip_sw": 4}
NST_PER_BATCH = {("int8_static", None, False): {"res_site_s8o": 5, "site_s8": 5},
                 ("int8", None, True): NST_RES_I8, ("int8_static", None, True): NST_RES_I8,
                 ("int8", NST_I8, False): {"res_site_k2p1": 1, **NST_RES_I8, "res_site_k2p0": 2},
                 ("int8_static", NST_S8, False): {"res_site_k2p1": 1, "res_site_s8o": 5,
                                                  "site_s8": 5, "site_s8_k2p0": 2,
                                                  "d3_s8_site": 1}}
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
# and, in sets of their own, every other name the JAX t7 forward routes on that
# the port runs: c2_i8 and dec_i8 with res_i8 on the IN graph (k3 deconvs)
# and on a BN graph with k4 deconvs (no res name: the PyTorch-int8 chain; its
# deconvs on K4's 3×3 zero-halo form), and the XLA-form references
T7_I8 = ("c2_i8", "res_i8", "dec_i8")
T7_DEC = ("c2_i8", "dec_i8")
T7_XLA = ("dec_xla_i8", "tail_xla_i8")
# the s8 carries of BN-folded graphs, the three sets bench.py times
# (t7_int8_s8carry / decs8 / tails8_fps_1080) on the BN graph (k3 deconvs)
T7_RES_S8 = ("res_s8",)
T7_DEC_S8 = ("res_s8", "dec_s8")
T7_TAIL_S8 = ("res_s8", "dec_s8", "tail_s8")
T7_SLICES = (("in", "none", None), ("in", "bf16_static", None), ("in", "int8", None),
             ("in", "int8_static", None), ("bn", "none", None), ("bn", "int8", None),
             ("in", "int8", T7_I8), ("bn k4", "int8", T7_DEC), ("in", "int8", T7_XLA),
             ("bn", "int8", T7_RES_S8), ("bn", "int8", T7_DEC_S8), ("bn", "int8", T7_TAIL_S8))
T7_S8_RES = {"res_site_s8o": 5, "site_s8": 5}
T7_PER_BATCH = {("in", "int8", None): {"res_site": 6, "res_site_skip": 4},
                ("in", "int8", T7_I8): {"res_site_k2p1": 1, "res_site": 6, "res_site_skip": 4,
                                        "res_site_k2p0": 2},
                ("bn k4", "int8", T7_DEC): {"res_site_k2p1": 1, "res_site": 2},
                ("bn", "int8", T7_RES_S8): T7_S8_RES,
                ("bn", "int8", T7_DEC_S8): {**T7_S8_RES, "site_s8_k2p0": 2},
                ("bn", "int8", T7_TAIL_S8): {**T7_S8_RES, "site_s8_k2p0": 2, "d3_s8_site": 1}}
# ReCoNet's s8 set, bench.py's s8_sites (reconet_int8_static_s8_fps_1080; an IN
# net, frozen norms): 4 × K2 + 4 × K3 on the res chain, then dec_s8's K2 at
# CO = 384 and K3 at C = 96
RECO_S8 = ("res_s8", "res_i8", "dec_s8", "dec_i8")
RECO_S8_PER_BATCH = {"res_site_s8o": 4, "site_s8": 4, "res_site_s8o_co384": 1,
                     "site_s8_c96": 1}
SET_NAMES = {SET_A: "setA", SET_B: "setB", HEAD_TAIL: "head,tail", D3: "d3",
             **{names: "+".join(names) for names in (NST_I8, NST_S8, NST_XLA, T7_DEC,
                                                     T7_RES_S8, T7_DEC_S8, T7_TAIL_S8,
                                                     RECO_S8)}}
# the Johnson slices under --compute_dtype float32 (the adopted sets): the res
# chain's first sites read the f32 res input, through the f32 forms
F32_SLICES = ("int8", "int8_static")
F32_PER_BATCH = {"int8": {"res_site": 6, "res_site_f32": 1, "res_site_skip": 4,
                          "res_site_skip_f32": 1},
                 "int8_static": {"res_site_s8o": 4, "res_site_s8o_f32": 1, "site_s8": 4,
                                 "site_s8_f32": 1, "res_site": 2}}
# the sets the JAX forwards run under f32 params that reach the float32 forms
# of conv2's and deconv1's sites and of K9a/K9e: Johnson's all-int8 static
# set (K8a on conv1's f32 output; the rest reads K8a's bf16 chain and ends
# in K6, bf16 out), its bf16 tail (K9a on deconv1's f32 raw; the tail
# returns before d3) and d3 (K9e on the f32 d2 raw), NST_Train's and an IN
# Torch7 net's c2_i8 + res_i8 + dec_i8 (K4 2×2 pad 1 and pad 0 on f32
# inputs; the res chain's first K4/K5 f32), ReCoNet's s8 set (every block's
# K2 and K3 read the f32 carry, which its chain keeps in y's dtype; then K2
# at CO = 384 on the chain's f32 output):
# (slot, --quantize, set) → launches a batch
J_S8_TAIL = ("head_i8", "res_s8", "dec_s8", "tail_s8")
J_D3_XLA = ("tail_s8", "d3_i8")
TAIL_D3 = ("tail", "d3")
F32_SETS = {
    ("johnson", "int8_static", J_S8_TAIL): {"c2_site_f32": 1, "c3_site": 1, "res_site_s8o": 5,
                                            "site_s8": 7, "d3_s8_site": 1},
    ("johnson", "none", TAIL_D3): {"d2_site_f32": 1, "d3_sum_site": 1},
    ("johnson", "none", D3): {"d3_rows_f32": 1},
    ("nst", "int8", NST_I8): {"res_site_k2p1_f32": 1, "res_site_f32": 1, "res_site_sw": 5,
                              "res_site_skip_f32": 1, "res_site_skip_sw": 3,
                              "res_site_k2p0_f32": 1, "res_site_k2p0": 1},
    ("t7 in", "int8", T7_I8): {"res_site_k2p1_f32": 1, "res_site_f32": 1, "res_site": 5,
                               "res_site_skip_f32": 1, "res_site_skip": 3,
                               "res_site_k2p0_f32": 1, "res_site_k2p0": 1},
    ("reco in", "int8_static", RECO_S8): {"res_site_s8o_f32": 4, "site_s8_f32": 4,
                                          "res_site_s8o_co384_f32": 1, "site_s8_c96": 1},
    # d3_i8 on the XLA-form decoder (no site chain; tail_s8 keeps the d3
    # site in the engine's filter): K7 on the f32 d2 raw
    ("johnson", "int8", J_D3_XLA): {"d3_rows_site_f32": 1},
}
SET_NAMES.update({J_S8_TAIL: "+".join(J_S8_TAIL), TAIL_D3: "tail,d3",
                  J_D3_XLA: "+".join(J_D3_XLA)})
PF_FRAMES = 6                 # frames of the per-frame CLI clip
PF_CROP = (256, 448)          # its crop for the card vs CPU comparison
PF_MAE_TOL = 1e-3             # [0,1] frames, per-frame f32 CLI card vs CPU
REGION_MAE_TOL = 1e-3         # [0,1] frames, f32 region / mask / LAB core card vs CPU
# K2-K5 run on the int8 tensor cores (mma_kernel), K8a and K8b on its
# stride-2 form (mma_s2_kernel), K6 on d3s8_mma_kernel and K7 on
# d3rows_mma_kernel; their previous __dp4a design (site_kernel, rows_kernel)
# stays callable for the comparison, K2's and K5's also at ReCoNet's C = 192.
# K4 and K3 at ReCoNet's widths (C = 192, 96; K3's C = 96 form is
# site_s8_c96) run on the wgmma core (csrc/int8_wgmma.cu), their previous
# core there mma_kernel (WG_PREV). K9b runs on d3sum_mma_kernel, K9a on d2_wgmma_kernel, K9c and
# K9d on s2_mma_bf16_kernel, K9e on d3rows_wgmma_kernel, their previous
# designs (rows_kernel_bf16, site_kernel_bf16) likewise
REDESIGNED = ("res_site_s8o", "site_s8", "res_site", "res_site_skip", "c2_site", "c3_site",
              "d3_s8_site", "d3_rows_site", "site_s8_c96")
WG_PREV = ("res_site", "site_s8", "site_s8_c96")
_WG_SRC = "neuralstyletransferv1_torch/csrc/int8_wgmma.cu"


def on_wgmma(name: str, c: int) -> bool:
    """Whether the int8 site ``name`` (a wrapper or one of its forms) at C
    input channels runs on the wgmma core."""
    return name in WG_PREV and c in (96, 192)


def slice_name(quantize: str, fused) -> str:
    return quantize if fused is None else f"{quantize}+{SET_NAMES[fused]}"


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()
CARD = "card not read"  # nvidia-smi's name and power limit, set by main()


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
    bias, and 2×2 weights (``wk4``) for the block forms."""
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
        "wk": k8.pack_weights(codes(3, 3, c, co)), "wk4": k8.pack_weights(codes(2, 2, c, co)),
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
    ``halo`` replaces the shape's halo. ``name`` is a wrapper or one of its
    forms (``FORM_OF``)."""
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    name, geo = FORM_OF.get(name, (name, None))
    if geo is not None:
        t = dict(t, wk=t["wk4"])
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
        if form == "raw":
            args = ins = (t["codes"], t["wk"], t["ws"], t["bias"])
        elif form in ("s8out", "zero2"):
            args, kw = (t["codes"], t["wk"], t["ws"], t["bias"]), dict(qa=t["qa"], qc=t["qc"])
            ins, outs = (t["codes"], t["wk"], t["ws"], t["bias"], t["qa"], t["qc"]), 1
            if form == "zero2":
                kw["halo_out"] = "zero2"
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
        kw = dict(yout=shape in ("res", "reco_res", "t7", "nst_res"))
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
    if geo is not None:
        kw.update(kh=geo[0], kw=geo[1], pt=geo[2], pl_=geo[3])
    kernel = getattr(k8, f"{name}_prev" if prev else name)
    plain = getattr(k8, f"{name}_plain")
    moved = nbytes(*ins) + pix * co * outs
    if name in ("res_site", "res_site_skip", "c2_site", "c3_site"):
        moved += b * 2 * co * 4  # the sums
    if name == "res_site_skip" and kw["yout"]:
        moved += b * h * w * c * 2  # v
    taps = 5 if name.startswith("d3") else 9 if geo is None else geo[0] * geo[1]
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
    conv (stride 2 for c2/c3), for deconv3's sites the pixel 9×9 32→3 conv
    at the 1080p output size, for the 2×2 pad-1 block form the pixel 3×3
    stride-2 conv (conv2), for the pad-0 one the k3 stride-2 transposed
    conv."""
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
    geo = FORM_OF.get(name, (name, None))[1]
    if geo == (2, 2, 1, 1):  # conv2 on the pixel grid: 3×3, stride 2
        xp = torch.randn((b, 2 * h, 2 * w, c // 4), device=dev).to(torch.bfloat16)
        wc = torch.randn((co, c // 4, 3, 3), device=dev).to(torch.bfloat16).to(
            memory_format=torch.channels_last)
        return lambda: F.conv2d(xp.permute(0, 3, 1, 2), wc, stride=2, padding=1)
    if geo == (2, 2, 0, 0):  # the k3 stride-2 transposed conv it scatters
        wc = torch.randn((c, co // 4, 3, 3), device=dev).to(torch.bfloat16).to(
            memory_format=torch.channels_last)
        return lambda: F.conv_transpose2d(xc, wc, stride=2, padding=1, output_padding=1)
    wc = torch.randn((co, c, 3, 3), device=dev).to(torch.bfloat16).to(
        memory_format=torch.channels_last)
    stride = 2 if name in ("c2_site", "c3_site") else 1
    return lambda: F.conv2d(xc, wc, stride=stride, padding=1)


def library_conv_f32(dev, shape, stride: int = 1):
    """The cuDNN f32 conv (TF32 off) an f32-operand site stands for: a 3×3
    conv of its shape (at ``stride``: K8a's conv2; deconv3's rows, K7: the
    1×5 128 → 60 conv with zero column pads) on channels-last f32 input. No
    int8 conv takes an f32 operand on the card, so this is a yardstick, not
    a library call of the same function."""
    import torch
    import torch.nn.functional as F

    b, h, w, c, co, _ = SITE_SHAPES[shape]
    xc = torch.randn((b, h, w, c), device=dev).permute(0, 3, 1, 2)
    ks, pad = ((1, 5), (0, 2)) if shape == "d3" else ((3, 3), 1)
    co = 60 if shape == "d3" else co
    wc = torch.randn((co, c, *ks), device=dev).to(memory_format=torch.channels_last)
    return lambda: F.conv2d(xc, wc, stride=stride, padding=pad)


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
            # every case of a redesigned kernel has its previous core: __dp4a
            # (K2, K5 also at C = 192), mma_kernel for K3 and K4 at ReCoNet's
            # widths
            prev_case = redesigned
            prev_core = "mma_kernel" if on_wgmma(name, c) else "__dp4a"
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
                per["prev_core"] = prev_core
                rec["prev_ms"] += t_prev
            if on_wgmma(name, c):
                per["source"] = _WG_SRC
            if shape in SITE_SW:
                halo = f"{halo}, sw {SITE_SW[shape]}"
            log(f"{name} @ {case} {b}x{h}x{w}x{c}->{co} {halo}: bit-identical to plain; "
                f"kernel {t_k:.4f} ms, plain {t_plain:.4f} ms, cuDNN bf16 conv "
                f"{t_lib:.4f} ms; bound {bound:.4f} ms "
                f"({moved / 1e6:.1f} MB, {ops:.3e} int8 ops)" +
                (f"; previous {prev_core} core {t_prev:.4f} ms ({t_prev / t_k:.2f}x the kernel)"
                 if prev_case else "") + f"; kernel at {bound / t_k:.1%} of the bound" +
                (" (the wgmma core)" if on_wgmma(name, c) else ""))
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


def f32_operand(t: dict, name: str, seed: int) -> dict:
    """``t`` with the operand the f32 form reads as f32 replaced by f32
    values that are not bf16-representable: K2's, K4's, K8a's and K7's x,
    K3's and K5's residual y."""
    import torch

    name = FORM_OF.get(name, (name, None))[0]
    key = "x" if name in ("res_site_s8o", "res_site", "c2_site", "d3_rows_site") else "y"
    g = torch.Generator(device=t[key].device).manual_seed(seed)
    scale = 2.0 if key == "x" else 1.0
    out = dict(t)
    out[key] = (torch.randn(tuple(t[key].shape), generator=g, device=t[key].device)
                * scale).contiguous()
    return out


def f32_kernel_phase(dev):
    """The f32-operand forms of K2-K5 against their plain versions at the
    slice's shapes where the float32 chains run them, bit for bit, two
    launches bit-identical; timed in turns beside the bf16 form on the same
    shape (bf16, f32, f32, bf16) and the plain version, with the cuDNN f32
    3×3 conv of the shape (TF32 off) as a yardstick; then at ragged
    shapes (widths off the 16-column tile, heights off the 8-row tile,
    B = 1 and 3, C = 64 under the zero halo, a ragged sw)."""
    import torch

    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    results = {}
    for form_name, (base, cases) in F32_KERNELS.items():
        rec = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bf16_ms": 0.0, "cudnn_f32_ms": 0.0,
               "max_abs_err": 0.0, "bound_by": "bytes", "per_case": {}}
        for i, (shape, form) in enumerate(cases):
            b, h, w, c, co, halo = SITE_SHAPES[shape]
            seed = 500 + 10 * len(results) + i
            t16 = site_inputs(dev, b, h, w, c, co, seed=seed)
            t = f32_operand(t16, base, seed)
            kernel, plain, moved, ops = site_calls(base, t, shape, form)
            bf16_form = site_calls(base, t16, shape, form)[0]
            before = dict(k8.F32_LAUNCHES)
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            if k8.F32_LAUNCHES[form_name] != before[form_name] + 1:
                fail(f"{form_name} @ {shape}/{form}: the f32 operand did not launch the f32 form")
            first = out[0] if isinstance(out, tuple) else out
            err = check_site(form_name, out, ref, first.shape[1] * first.shape[2])
            if not _same(kernel(), out):
                fail(f"{form_name} @ {shape}/{form}: two launches on the same inputs differ")
            del out, ref, first
            t_bf = dev_time(bf16_form)
            t_k = dev_time(kernel)
            t_k = (t_k + dev_time(kernel)) / 2
            t_bf = (t_bf + dev_time(bf16_form)) / 2
            t_plain = dev_time(plain, reps=2)
            t_lib = dev_time(library_conv_f32(dev, shape, 2 if base == "c2_site" else 1))
            t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_INT8_OPS * 1e3
            bound = max(t_bytes, t_ops)
            case = f"{shape}{'/' + form if form else ''}"
            if shape in SITE_SW:
                halo = f"{halo}, sw {SITE_SW[shape]}"
            by = "operations" if t_ops > t_bytes else "bytes"
            rec["per_case"][case] = {"ms": t_k, "bf16_ms": t_bf, "plain_ms": t_plain,
                                     "cudnn_f32_ms": t_lib, "bound_ms": bound, "bound_by": by,
                                     "bound_share": bound / t_k}
            log(f"{form_name} @ {case} {b}x{h}x{w}x{c}->{co} {halo}: bit-identical to plain; "
                f"f32 form {t_k:.4f} ms, bf16 form {t_bf:.4f} ms (same turns, "
                f"{t_k / t_bf:.3f}x), plain {t_plain:.4f} ms, cuDNN f32 conv (TF32 off, a "
                f"yardstick) {t_lib:.4f} ms; bound {bound:.4f} ms by {by} "
                f"({moved / 1e6:.1f} MB, {ops:.3e} int8 ops), f32 form at "
                f"{bound / t_k:.1%} of it")
            rec["ms"] += t_k
            rec["bf16_ms"] += t_bf
            rec["plain_ms"] += t_plain
            rec["cudnn_f32_ms"] += t_lib
            rec["bound_ms"] += bound
            if t_ops > t_bytes:
                rec["bound_by"] = "operations"
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            del t, t16, kernel, plain, bf16_form
            torch.cuda.empty_cache()
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        results[form_name] = rec
    ragged_f32_phase(dev)
    return results


def ragged_f32_phase(dev):
    """The f32 forms at ragged shapes, small: bit-identical to their plain
    versions, two launches bit-identical, K2's masked columns' codes 0."""
    import torch

    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    n = 0
    for form_name, (form_of, _cases) in F32_KERNELS.items():
        base, geo = FORM_OF.get(form_of, (form_of, None))
        for (b, h, w, c, co, halo, form, sw) in F32_RAGGED.get(form_of, ()):
            t = f32_operand(site_inputs(dev, b, h, w, c, co, seed=700 + n), base, 700 + n)
            if geo is not None:
                t["wk"] = t["wk4"]
            kw = {} if halo is None else {"halo": halo}
            if sw is not None:
                kw["sw"] = sw
            if geo is not None:
                kw.update(kh=geo[0], kw=geo[1], pt=geo[2], pl_=geo[3])
            if base == "c2_site":
                args = (t["x"], t["a"], t["c"], 0.0, t["wk"], t["ws"], t["bias"])
            elif base == "res_site":
                args = (t["x"], t["a"], t["c"], 0.0 if form == "b" else -127.0, t["wk"], t["ws"],
                        t["bias"])
            elif base == "res_site_s8o":
                args = (t["x"], t["a"], t["c"], -127.0, t["wk"], t["ws"], t["bias"], t["qa"],
                        t["qc"])
                if form == "frn":
                    kw.update(qlo=-127.0, tau=t["tauo"])
            elif base == "res_site_skip":
                args = (t["x"], t["y"], t["a"], t["c"], t["a2"], t["c2"], -127.0, t["wk"],
                        t["ws"], t["bias"])
                if form in ("relu", "tau"):
                    kw.update(act=form, tau_act=t["tau_act"] if form == "tau" else None)
            else:
                args = (t["codes"], t["wk"], t["ws"], t["bias"], t["qa"] / 40, t["qc"] / 40,
                        t["y"])
                if form == "yaff":
                    kw["yaff"] = (t["a2"][0], t["c2"][0])
            before = k8.F32_LAUNCHES[form_name]
            out = getattr(k8, base)(*args, **kw)
            again = getattr(k8, base)(*args, **kw)
            ref = getattr(k8, f"{base}_plain")(*args, **kw)
            torch.cuda.synchronize()
            if k8.F32_LAUNCHES[form_name] != before + 2:
                fail(f"{form_name} ragged {b}x{h}x{w}x{c}: the f32 form was not launched")
            first = out[0] if isinstance(out, tuple) else out
            check_site(f"{form_name} ragged", out, ref, first.shape[1] * first.shape[2])
            if not _same(out, again):
                fail(f"{form_name} ragged {b}x{h}x{w}x{c}: two launches differ")
            if sw is not None and base == "res_site_s8o" and bool((out[:, :, sw:] != 0).any()):
                fail(f"{form_name} ragged: a masked column's code is not 0")
            n += 1
    log(f"f32 forms at {n} ragged shapes (W off the 16-column tile, H off the 8-row tile, "
        f"B = 1 and 3, C = 64 and 128 under the zero halo, ragged sw; the 2×2 forms, K2 at "
        f"CO = 384 and K8a): bit-identical to their plain versions, two launches "
        f"bit-identical")


def f32_raw(x, seed: int):
    """bf16 raw activations ``x`` as f32 values that are not
    bf16-representable (each moved by up to a bf16 half ulp): the raw a
    float32 chain hands K9a or K9e."""
    import torch

    g = torch.Generator(device=x.device).manual_seed(seed)
    xf = x.float()
    ulp = xf.abs().clamp(min=2.0 ** -100) * 2.0 ** -8
    return (xf + (torch.rand(tuple(x.shape), generator=g, device=x.device) - 0.5) * ulp) \
        .contiguous()


def bf16_f32_phase(dev):
    """K9a and K9e with an f32 raw at their 1080p B=8 shapes against their
    plain versions (the K9 bounds: within 1 bf16 ulp, two launches
    bit-identical), timed in turns beside their bf16 forms on the same
    shape (bf16, f32, f32, bf16), the plain version and the cuDNN f32 conv
    of the shape (TF32 off; a yardstick); then at ragged shapes (K9a off
    its 4 × 32 tile, K9e off its 64-column segment, an odd W)."""
    import torch
    import torch.nn.functional as F

    from neuralstyletransferv1_torch.kernels import bf16_sites as k9

    results = {}
    for i, (form_name, base) in enumerate(BF16_F32_KERNELS.items()):
        shape = BF16_KERNELS[base][0]
        args16 = bf16_site_inputs(dev, base, shape, seed=300 + i)
        args = [f32_raw(args16[0], 300 + i), *args16[1:]]
        kernel, plain = getattr(k9, base), getattr(k9, f"{base}_plain")
        before = k9.F32_LAUNCHES[form_name]
        out, again, ref = kernel(*args), kernel(*args), plain(*args)
        torch.cuda.synchronize()
        if k9.F32_LAUNCHES[form_name] != before + 2:
            fail(f"{form_name}: the f32 raw did not launch the f32 form")
        err, worst, equal = check_bf16_site(form_name, out, again, ref, args)
        outs = out if isinstance(out, tuple) else (out,)
        b, h, w, c = shape
        pix = outs[0].shape[0] * outs[0].shape[1] * outs[0].shape[2]
        lanes = k9.D3_LANES if base.startswith("d3") else outs[0].shape[3]
        taps = 5 if base.startswith("d3") else 9
        flops = 2 * pix * c * lanes * taps
        moved = nbytes(*args, *outs)
        del out, again, ref, outs
        torch.cuda.empty_cache()
        t_bf = dev_time(lambda: kernel(*args16))
        t_k = dev_time(lambda: kernel(*args))
        t_k = (t_k + dev_time(lambda: kernel(*args))) / 2
        t_bf = (t_bf + dev_time(lambda: kernel(*args16))) / 2
        t_plain = dev_time(lambda: plain(*args), reps=2)
        x32 = torch.randn(shape, device=dev).permute(0, 3, 1, 2)
        co = k9.D3_LANES if base.startswith("d3") else k9.SITES[base][1]
        ks = (1, 5) if base.startswith("d3") else (3, 3)
        wc = torch.randn((co, c, *ks), device=dev).contiguous(memory_format=torch.channels_last)
        pad = (0, 2) if base.startswith("d3") else 1
        t_lib = dev_time(lambda: F.conv2d(x32, wc, padding=pad))
        t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, flops / PEAK_BF16_OPS * 1e3
        bound = max(t_bytes, t_ops)
        by = "operations" if t_ops > t_bytes else "bytes"
        log(f"{form_name} @ {b}x{h}x{w}x{c} f32 raw: two launches bit-identical; vs plain max "
            f"|err| {err:.4g}, worst {worst:.3g} ulp, equal on {equal:.4%}; f32 form "
            f"{t_k:.4f} ms, bf16 form {t_bf:.4f} ms (same turns, {t_k / t_bf:.3f}x), plain "
            f"{t_plain:.4f} ms, cuDNN f32 conv (TF32 off, a yardstick) {t_lib:.4f} ms; bound "
            f"{bound:.4f} ms by {by} ({moved / 1e6:.1f} MB, {flops:.3e} bf16 FLOP), f32 form "
            f"at {bound / t_k:.1%} of it")
        results[form_name] = {"ms": t_k, "bf16_form_ms": t_bf, "plain_ms": t_plain,
                              "cudnn_f32_ms": t_lib, "bound_ms": bound, "max_abs_err": err,
                              "bound_by": by, "bound_share": bound / t_k}
        del args, args16, x32, wc
        torch.cuda.empty_cache()
    n = 0
    for form_name, base in BF16_F32_KERNELS.items():
        c = BF16_KERNELS[base][0][3]
        for (b, h, w) in BF16_F32_RAGGED:
            args = bf16_site_inputs(dev, base, (b, h, w, c), seed=320 + n)
            args[0] = f32_raw(args[0], 320 + n)
            kernel = getattr(k9, base)
            out, again = kernel(*args), kernel(*args)
            ref = getattr(k9, f"{base}_plain")(*args)
            torch.cuda.synchronize()
            check_bf16_site(f"{form_name} ragged {b}x{h}x{w}", out, again, ref, args)
            n += 1
    log(f"K9a and K9e with an f32 raw at {n} ragged shapes: within the K9 bounds of their "
        f"plain versions, two launches bit-identical")
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
    tau), K2 (the IN and FRN emit), K3 on K2's codes and K3's C = 96 bare
    form: outputs bit-identical to the plain versions (sums within 1e-5) and
    two launches bit-identical, sums included; K4's and K3's (the wgmma
    core) also bit-identical to their previous core (mma_kernel), K4's sums
    included at C = 192 (at 96 the previous core sums in another order)."""
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
        if c == 96:
            cases.append(("site_s8 96->192 edge raw", "site_s8",
                          (t["codes"], t["wk"], t["ws"], t["bias"]), dict(halo="edge")))
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
            if name in WG_PREV:  # K4's sums at C = 96 in another order (checked above)
                prev = getattr(k8, f"{name}_prev")(*args, **kw)
                if not _same(out[0] if name == "res_site" and c == 96 else out,
                             prev[0] if name == "res_site" and c == 96 else prev):
                    fail(f"{label} at {b}x{h}x{w}: the wgmma core differs from its previous core")
            if name == "res_site_s8o":
                aff = (t["qa"] / 40, t["qc"] / 40, t["y"])
                o = k8.site_s8(out, t["wk"], t["ws"], t["bias"], *aff)
                if not (_same(o, k8.site_s8(out, t["wk"], t["ws"], t["bias"], *aff)) and
                        _same(o, k8.site_s8_plain(out, t["wk"], t["ws"], t["bias"], *aff)) and
                        _same(o, k8.site_s8_prev(out, t["wk"], t["ws"], t["bias"], *aff))):
                    fail(f"site_s8 192 on the {label} codes at {b}x{h}x{w}: not bit-identical")
        log(f"ReCoNet forms at {b}x{h}x{w}x{c}: {', '.join(c_[0] for c_ in cases)}"
            f"{' (+ site_s8 on each emit)' if c == 192 else ''}: bit-identical to their plain "
            "versions and across two launches, K4's and K3's also to their previous core")


# K7's and K9a's tensor-core cores at ragged shapes (B, H, W): widths off
# the 32-column strip and tile, heights below the 8-row tile (K9a's 4-row
# tile: a partial bottom tile), one image and three
RAGGED_K7_K9A = ((1, 5, 45), (3, 7, 70), (1, 3, 33), (3, 13, 100), (1, 2, 2))


def ragged_k7_k9a_phase(dev):
    """K7 (``d3_rows_site``) and K9a (``d2_site``) at ragged shapes against
    their plain versions and their previous cores: K7 bit-identical to both,
    K9a within the K9 bounds of ``check_bf16_site`` (1 ulp, 99% equal, sums
    within 1e-5) of both; two launches bit-identical. K7's f32 form (an f32
    raw, not bf16-representable) bit-identical to its plain version and
    across two launches, each counted as ``d3_rows_site_f32``."""
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
        args = (f32_operand(t, "d3_rows_site", 420 + i)["x"], *args[1:])
        before = k8.F32_LAUNCHES["d3_rows_site_f32"]
        rows, again, ref = k8.d3_rows_site(*args), k8.d3_rows_site(*args), \
            k8.d3_rows_site_plain(*args)
        torch.cuda.synchronize()
        if k8.F32_LAUNCHES["d3_rows_site_f32"] != before + 2:
            fail(f"d3_rows_site at {b}x{h}x{w} on an f32 raw: the f32 form was not launched")
        if not (torch.equal(rows, again) and torch.equal(rows, ref)):
            fail(f"d3_rows_site f32 at {b}x{h}x{w}: not bit-identical to its plain version or "
                 "itself")
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
            f"core, its f32 form to its plain version; K9a {worst:.3g} ulp at worst, equal on {equal:.4%}, within the K9 bounds "
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
    for counts in (k8.LAUNCHES, k8.PROBE_LAUNCHES, k8.F32_LAUNCHES, k8.FORM_LAUNCHES, k9.LAUNCHES,
                   k9.F32_LAUNCHES, k12.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    from neuralstyletransferv1_torch.kernels import bf16_sites as k9
    from neuralstyletransferv1_torch.kernels import dis_iter as k1
    from neuralstyletransferv1_torch.kernels import int8_probes as k12
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    return {"dis_iter": k1.LAUNCHES, **k8.LAUNCHES, **k8.PROBE_LAUNCHES, **k8.F32_LAUNCHES,
            **k8.FORM_LAUNCHES, **k9.LAUNCHES, **k9.F32_LAUNCHES, **k12.LAUNCHES}


def slice_phase(dev, quantize: str = "none", fused=None, nst_ckpt: Path | None = None,
                reco: tuple | None = None, t7: tuple | None = None, dtype: str = "bfloat16",
                defaults: bool = False):
    """The 1080p bf16 flow-EMA slice through make_batched_core, plain, with
    a --quantize mode and fused-site set, or with a set of bf16 fused sites;
    with ``nst_ckpt``, of that NST_Train checkpoint under the adopted sets;
    with ``reco`` = (checkpoint, frn), of that ReCoNet slot
    (``--model_type reconet``) under the adopted sets; with ``t7`` = (.t7
    file, "in" or "bn"), of that Torch7 slot under the adopted sets; with
    ``dtype`` "float32", the slice under --compute_dtype float32 (the f32
    forms take the sites that read an f32 tensor: the Johnson adopted sets'
    res chains, or a set of ``F32_SETS``); with
    ``defaults``, the adopted sets are the built-in defaults (the adoption
    file absent); returns the run's launch counts."""
    if defaults:
        with _without_adoption_file():
            return slice_phase(dev, quantize, fused, nst_ckpt, reco, t7, dtype)
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.ops.dis_flow import _level_sizes

    argv = ["--input_video", "in.mp4", "--output_video", "out.mp4",
            "--model", str(nst_ckpt or (reco[0] if reco else (t7[0] if t7 else CKPT))),
            "--frame_batch", str(B), "--flow_ema", "--compute_dtype", dtype]
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
    defaults = adopt_file_absent()
    if nst_ckpt is not None:
        name = f"nst {name}{' (defaults)' if defaults else ''}"
        per_batch = NST_PER_BATCH.get((quantize, fused, defaults), {})
    if reco is not None:
        name = f"reco {'frn' if reco[1] else 'in'} {name}"
        per_batch = RECO_S8_PER_BATCH if fused == RECO_S8 else RECO_PER_BATCH.get(quantize, {})
    if t7 is not None:
        name, per_batch = f"t7 {t7[1]} {name}", T7_PER_BATCH.get((t7[1], quantize, fused), {})
    if dtype == "float32":
        slot = ("nst" if nst_ckpt is not None else f"t7 {t7[1]}" if t7 is not None
                else f"reco {'frn' if reco[1] else 'in'}" if reco is not None else "johnson")
        per_batch = F32_PER_BATCH.get(quantize, {}) if fused is None \
            else F32_SETS[(slot, quantize, fused)]
        name = f"f32 {name}"
    expected = {"dis_iter": levels * N_BATCHES}
    for k in counts:
        if k != "dis_iter":
            expected[k] = per_batch.get(k, 0) * N_BATCHES
    used = {k: v for k, v in counts.items() if v}
    log(f"slice 1080p B={B} {'f32' if dtype == 'float32' else 'bf16'} --quantize {name}: "
        f"batch seconds "
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
        quant_quality(dev, args, frames[:B], quantize, fused, name,
                      torch.float32 if dtype == "float32" else torch.bfloat16)
    return counts


class _without_adoption_file:
    """The adoption file out of the engine's sight (``adopt_overrides.PATH``
    pointed at a name that does not exist) for the ``with`` block: every set
    is then the built-in default."""

    def __enter__(self):
        from neuralstyletransferv1_torch import adopt_overrides

        self.saved = adopt_overrides.PATH
        adopt_overrides.PATH = self.saved.with_name("absent_i8_adopt.json")
        if adopt_overrides.PATH.exists():
            fail(f"{adopt_overrides.PATH} exists")

    def __exit__(self, *exc):
        from neuralstyletransferv1_torch import adopt_overrides

        adopt_overrides.PATH = self.saved


def adopt_file_absent() -> bool:
    from neuralstyletransferv1_torch import adopt_overrides

    return not adopt_overrides.PATH.exists()


def quant_quality(dev, args, frames, quantize, fused, name, dtype=None):
    """The quantized (or fused-site) stylize of the slice's first batch
    against the plain dynamic stylize of the same frames in ``dtype`` (bf16;
    an f32 slice against the f32 one): within the
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

    dtype = dtype or torch.bfloat16
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
    if model.arch == "nst" and fused in (NST_I8, NST_S8, NST_XLA):
        checks[0] = checks[0][:3] + (QUANT_BROKEN_TOL,)
    for preset, xin, what, bound in checks:
        m = st.StyleModel(model.arch, model.net, preset, model.name)
        ref = st.jit_stylizer(m, dtype=dtype, quantize=base)(xin)
        got = st.jit_stylizer(m, dtype=dtype, quantize=quantize, fused_sites=fused)(xin)
        mae = float((got - ref).abs().mean())
        first = float((got[0] - ref[0]).abs().mean())
        plain = "f32" if dtype == torch.float32 else "bf16"
        bound = deep_bound(fused, mae, bound, base)
        log(f"stylize --quantize {name} vs {plain if base == 'none' else base}, preset "
            f"{preset}, {what}: MAE {mae:.6f} (first frame {first:.6f}; bound {bound})")
        if not (torch.isfinite(got).all() and mae <= bound):
            fail(f"the {name} stylize is not within {bound} of the {base} stylize ({preset}, "
                 f"{what})")
        del ref, got


def deep_bound(fused, mae: float, bound: float, base: str = "none") -> float:
    """The bound a quality check holds: ``bound``, except where a random net
    may land above the 1e-2 gate: Torch7's deep s8 sets (the decoder
    quantized too: ``T7_DEC_S8``, ``T7_TAIL_S8``; ROADMAP Queue 3, "deep int8
    sets"), and ReCoNet's ``RECO_S8`` against the plain bf16 stylize (its
    norms frozen from one frame, the plain ones measured per frame; against
    ``bf16_static`` it keeps the gate). There, said on the log,
    QUANT_BROKEN_TOL, as the deep NST sets are held."""
    deep = fused in (T7_DEC_S8, T7_TAIL_S8) or (fused == RECO_S8 and base == "none")
    if deep and bound == QUANT_MAE_TOL and mae > bound:
        log(f"  {SET_NAMES[fused]}: MAE {mae:.6f} vs {base} is above the {QUANT_MAE_TOL} gate "
            f"on a random net ({'frozen norms' if fused == RECO_S8 else 'a deep int8 set'}), "
            f"held to {QUANT_BROKEN_TOL}")
        return QUANT_BROKEN_TOL
    return bound


def s8_bench_phase(dev, t7_ckpts: dict, reco_ckpts: dict) -> dict:
    """The four s8 sets bench.py times (``t7_int8_s8carry_fps_1080``,
    ``t7_int8_decs8_fps_1080``, ``t7_int8_tails8_fps_1080`` on the BN graph at
    ``--quantize int8``, ``reconet_int8_static_s8_fps_1080`` on the IN net at
    ``int8_static``), as bench.py runs them: ``jit_stylizer`` on 1080p B=8
    batches of uniform random frames, calibrated on the first. For each:
    exact launches of one batch, frames/s over STEADY_BATCHES timed batches
    (host clock, synchronized), the device busy share of one batch
    (torch.profiler) beside the CUDA-event span of a batch (first to last
    kernel, gaps included) and the MAE against the plain bf16 stylize of the
    same batch, held to the 1e-2 gate (``deep_bound`` for the deep sets); the
    int8_static set also against the bf16_static stylize (the same frozen
    norms), at the gate. Returns the four keys' frames/s."""
    import torch

    from neuralstyletransferv1_torch.engine import stylizer as st

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    xs = [torch.rand((B, H, W, 3), generator=g, device=dev) for _ in range(2)]
    # (key, checkpoint, model_type: a .t7 file loads as Torch7 by its suffix)
    runs = (("t7_int8_s8carry_fps_1080", t7_ckpts["bn"], "transformer", "int8", T7_RES_S8,
             T7_PER_BATCH[("bn", "int8", T7_RES_S8)]),
            ("t7_int8_decs8_fps_1080", t7_ckpts["bn"], "transformer", "int8", T7_DEC_S8,
             T7_PER_BATCH[("bn", "int8", T7_DEC_S8)]),
            ("t7_int8_tails8_fps_1080", t7_ckpts["bn"], "transformer", "int8", T7_TAIL_S8,
             T7_PER_BATCH[("bn", "int8", T7_TAIL_S8)]),
            ("reconet_int8_static_s8_fps_1080", reco_ckpts[False], "reconet", "int8_static",
             RECO_S8, RECO_S8_PER_BATCH))
    keys = {}
    for key, ckpt, mtype, mode, fused, want in runs:
        model = st.load_model(ckpt, model_type=mtype, device=dev)
        plain = st.jit_stylizer(model, dtype=torch.bfloat16, quantize="none")
        fn = st.jit_stylizer(model, dtype=torch.bfloat16, quantize=mode, fused_sites=fused)
        with torch.no_grad():
            fn(xs[0])  # calibrates on the first frame
            fn(xs[1])
            zero_counts()
            fn(xs[0])
            torch.cuda.synchronize()
            used = {k: v for k, v in read_counts().items() if v}
            if used != want:
                fail(f"{key}: one batch launched {used}, not {want}")
            t0 = time.perf_counter()
            for i in range(STEADY_BATCHES):
                fn(xs[i % 2])
            torch.cuda.synchronize()
            fps = STEADY_BATCHES * B / (time.perf_counter() - t0)
            wall, busy, _ = profile_report(f"{key} ({SET_NAMES[fused]}, --quantize {mode})",
                                           lambda: fn(xs[1]))
            span = cuda_ms(lambda: fn(xs[1]), reps=3)
            got = fn(xs[0])
            mae = float((got - plain(xs[0])).abs().mean())
            mae_static = None
            if mode == "int8_static":
                static = st.jit_stylizer(model, dtype=torch.bfloat16, quantize="bf16_static")
                mae_static = float((got - static(xs[0])).abs().mean())
                del static
        bound = deep_bound(fused, mae, QUANT_MAE_TOL)
        log(f"{key}: {fps:.2f} frames/s (1080p B={B}, {STEADY_BATCHES} batches, host clock), "
            f"device busy {busy:.2f} of {wall:.2f} ms a batch ({busy / wall:.1%}; CUDA-event span "
            f"of a batch {span:.2f} ms), MAE vs plain "
            f"bf16 {mae:.6f} (bound {bound})"
            + ("" if mae_static is None else f", vs bf16_static {mae_static:.6f} (bound "
               f"{QUANT_MAE_TOL})") + f", launches {used}")
        if mae > bound or (mae_static is not None and mae_static > QUANT_MAE_TOL):
            fail(f"{key}: the stylize is not within its bound of plain bf16 or bf16_static")
        keys[key] = fps
        del model, plain, fn, got
        torch.cuda.empty_cache()
    return keys


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


def write_masks(mask_dir: Path, n: int, h: int, w: int, skip=(3,)) -> Path:
    """Per-frame masks ``mask_<n>.png`` for frames 1..n but those in
    ``skip`` (they pass through fully styled): a disc drifting right, with
    a soft ramp at its edge."""
    import numpy as np
    from PIL import Image

    mask_dir.mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(1, n + 1):
        if i in skip:
            continue
        r = np.hypot((yy - 0.5 * h) / h, (xx - (0.3 + 0.02 * i) * w) / w)
        m = np.clip((0.3 - r) * 4 * 255, 0, 255).astype(np.uint8)
        Image.fromarray(m).save(mask_dir / f"mask_{i:04d}.png")
    return mask_dir


REGION_FLAGS = ["--model_b", str(CKPT), "--io_preset_b", "raw_01", "--region_mode", "voronoi",
                "--region_seed", "7", "--region_rotate", "3"]


def region_phase(dev, workdir: Path):
    """Regions, masks and the LAB multi-slot blend at 1080p, two slots (the
    repository's Johnson checkpoint under its own preset and raw_01): the
    batched core (B=8, bf16, flow EMA) over 2 batches with voronoi regions
    rotating 3° a frame and ``--mask_dir`` (frame 3 without a mask), then
    with the LAB blend and ``--mask_dir``; the per-frame loop through
    ``main()`` on a 4-frame 1080p mp4 with the same regions and masks; each
    with exact launch counts (K1 only: these paths add no kernel) and its
    time; then the regions + masks and the LAB blend under float32 on a
    cut-down frame (8 frames, 128×224), card vs ``--device cpu``, within
    1e-3 on [0,1]."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch import region
    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.ops.dis_flow import _level_sizes

    n = 2 * B
    frames = moving_frames(n, H, W, SEED + 11)
    masks = write_masks(workdir / "rg_masks", n, H, W)
    launches: dict = {}

    def batched(extra, frames, device, dtype="bfloat16"):
        h, w = frames[0].shape[:2]
        # each run makes its own masks: the caches are keyed on the frame, not
        # the device, so the CPU side would otherwise reuse the card's
        region.clear_mask_cache()
        tpipe._crop_cache.clear()
        argv = ["--input_video", "in.mp4", "--output_video", "out.mp4", "--model", str(CKPT),
                "--frame_batch", str(B), "--flow_ema", "--compute_dtype", dtype,
                "--mask_dir", str(masks), *extra]
        args = tpipe.build_parser().parse_args(argv)
        _, process = tpipe.make_batched_core(args, device, frames_dir=workdir / "_rg" / "frames")
        ds = tpipe.effective_flow_downscale(0, h, w)
        levels = len(_level_sizes(h // ds, w // ds, 2))
        zero_counts()
        outs, secs = [], []
        for b0 in range(0, len(frames), B):
            chunk = frames[b0:b0 + B]
            t0 = time.perf_counter()
            out = process(chunk, [Path(f"frame_{b0 + i + 1:04d}.png") for i in range(len(chunk))],
                          b0)
            if device.type == "cuda":
                torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            outs.append(out[:len(chunk)].cpu().numpy())
        used = {k: v for k, v in read_counts().items() if v}
        want = {"dis_iter": levels * -(-len(frames) // B)} if device.type == "cuda" else {}
        if used != want:
            fail(f"the region/mask batched core ({extra}) launched {used}, not {want}")
        for k, v in used.items():
            launches[k] = launches.get(k, 0) + v
        return np.concatenate(outs), secs

    for label, extra in (("voronoi regions, rotating, --mask_dir", REGION_FLAGS),
                         ("--blend_models_lab, --mask_dir",
                          ["--model_b", str(CKPT), "--io_preset_b", "raw_01",
                           "--blend_models_lab"])):
        out, secs = batched(extra, frames, dev)
        if out.shape != (n, H, W, 3) or out.std() < 1.0:
            fail(f"the {label} batched output is {out.shape}, std {out.std():.3g}")
        log(f"batched 1080p B={B} bf16 two slots, {label}: batch seconds "
            f"{', '.join(f'{t:.4f}' for t in secs)} ({B / secs[-1]:.2f} frames/s the second)")

    src = workdir / "rg_in.mp4"
    write_clip(src, frames[:4])
    ds = tpipe.effective_flow_downscale(0, H, W)
    levels = len(_level_sizes(H // ds, W // ds, 2))
    zero_counts()
    t0 = time.perf_counter()
    rc = tpipe.main(["--input_video", str(src), "--output_video", str(workdir / "rg_pf.mp4"),
                     "--model", str(CKPT), "--flow_ema", "--mask_dir", str(masks),
                     "--work_dir", str(workdir / "_rgpf"), *REGION_FLAGS])
    secs = time.perf_counter() - t0
    used = {k: v for k, v in read_counts().items() if v}
    for k, v in used.items():
        launches[k] = launches.get(k, 0) + v
    log(f"main() per-frame f32, two slots, voronoi regions rotating, --mask_dir, 4 frames at "
        f"1080p: rc {rc}, {secs:.2f} s, launches {used}")
    if rc != 0 or used != {"dis_iter": 3 * levels} or clip_frame_count(
            workdir / "rg_pf.mp4") != 4:
        fail("the per-frame region/mask run did not run as expected")

    ch, cw = 128, 224
    crop = [np.ascontiguousarray(f[:ch, :cw]) for f in frames[:B]]
    for label, extra in (("regions + --mask_dir", REGION_FLAGS),
                         ("LAB blend + --mask_dir", ["--model_b", str(CKPT), "--io_preset_b",
                                                     "raw_01", "--blend_models_lab"])):
        card = batched(extra, crop, dev, "float32")[0]
        cpu = batched(extra, crop, torch.device("cpu"), "float32")[0]
        mae = float(np.abs(card.astype(np.float64) - cpu).mean() / 255.0)
        log(f"f32 {label}, {B} frames {ch}x{cw}, card vs CPU: MAE {mae:.3g} on [0,1] "
            f"(bound {REGION_MAE_TOL})")
        if not mae <= REGION_MAE_TOL or card.std() < 1.0:
            fail(f"the {label} path on the card disagrees with the CPU path")
    return launches


# phase 11: DeepLabV3+ (the configuration bench.py's _deeplab_masked measures:
# ResNet-101, output stride 16, 21 classes, the mask at infer_res 513, a
# Johnson slot stylizing 1080p frames in bf16), the masked-stylize step and
# the sky-swap workflow (its video pass with PIPELINE_ARGS below: K1, K2 → K3,
# K4 on the card)
DL_BACKBONES = ("resnet", "mobilenet", "xception", "drn")
DL_CMP_HW = 129               # card vs CPU, f32
DL_REL_TOL = 1e-4             # relative logits MAE, card vs CPU f32
DL_AGREE = 0.999              # argmax agreement, card vs CPU f32
DL_INFER, DL_B = 513, 4       # the masked step's mask resolution and batch
DL_STEP_BATCHES = 6           # timed steady batches (rounds) of the masked step
DL_ALPHA_AGREE = 0.99         # pre-upsample alpha, card vs CPU (bf16 both sides)
SKY_FRAMES = 16
SKY_PIPELINE_ARGS = "--frame_batch 8 --flow_ema --quantize int8_static"


def deeplab_checkpoint(path: Path, backbone: str) -> Path:
    """A full-width seeded DeepLab (``init_state_dict``, seed SEED, 21 classes)
    written as the reference does: ``{"state_dict": ...}`` with ``module.``
    prefixes."""
    import torch

    from neuralstyletransferv1_torch.models import deeplab as tdl

    sd = tdl.init_state_dict(backbone, 21, seed=SEED)
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, path)
    return path


def _timed(label: str, fn, rounds: int) -> float:
    """Median ms of ``fn`` over ``rounds`` rounds (``_bench.in_turns``: CUDA
    events around one call a round), logged with its spread."""
    from neuralstyletransferv1_torch.experiments._bench import in_turns

    t = in_turns({label: (fn, 1)}, rounds)[label]
    log(f"{label}: median {t['ms']:.3f} ms over {rounds} rounds, spread {t['spread']:.1%}")
    return t["ms"]


def deeplab_vs_cpu(dev, state, backbone: str) -> None:
    """The f32 DeepLab on the card vs the port on the CPU at DL_CMP_HW²."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.models.deeplab import DeepLab

    x = torch.from_numpy(np.random.default_rng(SEED + 21).standard_normal(
        (1, DL_CMP_HW, DL_CMP_HW, 3)).astype(np.float32))
    with torch.no_grad():
        want = DeepLab(state, backbone=backbone).eval()(x)
        got = DeepLab(state, backbone=backbone).to(dev).eval()(x.to(dev)).cpu()
    rel = ((got - want).abs().mean() / want.abs().mean()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"DeepLab {backbone} f32 {DL_CMP_HW}x{DL_CMP_HW}, card vs CPU: relative MAE {rel:.3g} "
        f"(bound {DL_REL_TOL}), argmax agreement {agree:.5f} (bound {DL_AGREE}), |logits| max "
        f"{want.abs().max().item():.4g}")
    if not (rel <= DL_REL_TOL and agree >= DL_AGREE):
        fail(f"DeepLab {backbone} on the card disagrees with the CPU")


def deeplab_forward_bf16(dev, state, backbone: str) -> None:
    """One full-width bf16 forward at DL_INFER² with B = DL_B, timed by CUDA
    events: finite logits."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.engine.masked_stylize import cast_params
    from neuralstyletransferv1_torch.models.deeplab import DeepLab

    net = cast_params(DeepLab(state, backbone=backbone).to(dev).eval(), torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(SEED + 22).uniform(
        -1, 1, (DL_B, DL_INFER, DL_INFER, 3)).astype(np.float32)).to(dev, torch.bfloat16)
    with torch.no_grad():
        y = net(x)
        _timed(f"DeepLab {backbone} bf16 forward {DL_B}x{DL_INFER}x{DL_INFER}", lambda: net(x), 5)
    log(f"DeepLab {backbone} bf16 logits {tuple(y.shape)}, |logits| max "
        f"{y.float().abs().max().item():.4g}, finite {bool(torch.isfinite(y).all())}")
    if tuple(y.shape) != (DL_B, DL_INFER, DL_INFER, 21) or not bool(torch.isfinite(y).all()):
        fail(f"the bf16 DeepLab {backbone} forward is not finite or has the wrong shape")


def masked_step_phase(dev, state) -> None:
    """The masked-stylize step at bench.py's shape (1080×1920, B = DL_B,
    infer_res DL_INFER, the Johnson checkpoint under its preset): bf16 vs
    f32 on 2 frames (the 1e-2 gate), steady batches timed; then card vs CPU
    on a 1×128×224 cut-down at infer_res 65."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.engine import stylizer as tst
    from neuralstyletransferv1_torch.engine.masked_stylize import cast_params, make_masked_stylize_step
    from neuralstyletransferv1_torch.models.deeplab import DeepLab
    from neuralstyletransferv1_torch.ops.resize import resize_bilinear

    net = DeepLab(state).to(dev).eval()
    slot = tst.load_model(CKPT, device=dev)
    frames = torch.from_numpy(np.stack(moving_frames(DL_B, H, W, SEED + 23))).to(dev).float() / 255
    step16 = make_masked_stylize_step(net, slot, (H, W), infer_res=DL_INFER)
    step32 = make_masked_stylize_step(net, slot, (H, W), infer_res=DL_INFER,
                                      compute_dtype=torch.float32)
    mae = (step16(frames[:2]) - step32(frames[:2])).abs().mean().item()
    log(f"masked step 2x{H}x{W} infer_res {DL_INFER}, bf16 vs f32: composite MAE {mae:.3g} "
        f"(bound {QUANT_MAE_TOL}, bench.py's gate)")
    if not mae <= QUANT_MAE_TOL:
        fail("the bf16 masked step is outside the 1e-2 gate of the f32 step")
    out = step16(frames)
    if tuple(out.shape) != (DL_B, H, W, 3) or not bool(torch.isfinite(out).all()):
        fail(f"masked step output {tuple(out.shape)} is not finite")
    med = _timed(f"masked step bf16 {DL_B}x{H}x{W} infer_res {DL_INFER}", lambda: step16(frames),
                 DL_STEP_BATCHES)
    log(f"masked step: {med / 1e3:.4f} s a steady batch, {DL_B * 1e3 / med:.2f} frames/s")

    ch, cw, small = 128, 224, 65
    x = frames[:1, :ch, :cw].contiguous()
    outs, alphas = [], []
    for d in (dev, torch.device("cpu")):
        netd = DeepLab(state).to(d).eval()
        step = make_masked_stylize_step(netd, tst.load_model(CKPT, device=d), (ch, cw),
                                        infer_res=small)
        xd = x.to(d)
        outs.append(step(xd).cpu())
        sm = resize_bilinear(xd.bfloat16().float(), (small, small)).bfloat16()
        with torch.no_grad():
            lg = cast_params(netd, torch.bfloat16)(sm * 2.0 - 1.0)
        alphas.append((lg.argmax(-1) != 0).cpu())
    mae = (outs[0] - outs[1]).abs().mean().item()
    agree = (alphas[0] == alphas[1]).float().mean().item()
    log(f"masked step bf16 1x{ch}x{cw} infer_res {small}, card vs CPU: composite MAE {mae:.3g} "
        f"(bound {QUANT_MAE_TOL}), pre-upsample alpha agreement {agree:.4f} (bound "
        f"{DL_ALPHA_AGREE}), alpha share {alphas[0].float().mean().item():.3f}")
    if not (mae <= QUANT_MAE_TOL and agree >= DL_ALPHA_AGREE):
        fail("the masked step on the card disagrees with the CPU")


def sky_swap_phase(dev, workdir: Path, ckpt: Path) -> dict:
    """``run_sky_swap.main`` end to end on a synthesized 16-frame 1920×1080
    mp4 with the workflow's defaults (MASK_RES 512, INFER_RES 1280,
    scan-sky, expand and feather 3%) and PIPELINE_ARGS: one mask per
    extracted frame, every frame encoded, the exact launches of K1, K2, K3
    and K4 (zeroed before, read after), the wall time split into extract,
    masks and the stylize pass. Returns the launches."""
    import os

    from neuralstyletransferv1_torch.apps import run_sky_swap, sky_swap
    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.io import frames as tframes
    from neuralstyletransferv1_torch.ops.dis_flow import _level_sizes

    src, dst = workdir / "sky_in.mp4", workdir / "sky_out.mp4"
    write_clip(src, moving_frames(SKY_FRAMES, H, W, SEED + 24))
    env = {"INPUT_VIDEO": str(src), "OUTPUT_VIDEO": str(dst), "STYLE_MODEL": str(CKPT),
           "DEEPLAB_WEIGHTS": str(ckpt), "WORK_ROOT": str(workdir / "_sky"),
           "OUT_DIR": str(workdir / "sky_out"), "PIPELINE_ARGS": SKY_PIPELINE_ARGS}
    old_env = {k: os.environ.get(k) for k in env}
    split = {"extract": 0.0, "masks": 0.0, "stylize pass": 0.0}

    def timed(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                split[key] += time.perf_counter() - t0
        return run

    patched = [(tframes, "extract_frames"), (sky_swap, "batch_masks_from_frames"),
               (tpipe, "main")]
    originals = [getattr(m, a) for m, a in patched]
    for (m, a), key, fn in zip(patched, split, originals):
        setattr(m, a, timed(key, fn))
    os.environ.update(env)
    zero_counts()
    t0 = time.perf_counter()
    try:
        rc = run_sky_swap.main()
    finally:
        secs = time.perf_counter() - t0
        for (m, a), fn in zip(patched, originals):
            setattr(m, a, fn)
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    used = {k: v for k, v in read_counts().items() if v}
    n_frames = len(list((workdir / "_sky" / "frames").glob("frame_*.png")))
    n_masks = len(list((workdir / "_sky" / "masks").glob("mask_*.png")))
    got = clip_frame_count(dst)
    ds = tpipe.effective_flow_downscale(0, H, W)
    batches = -(-SKY_FRAMES // B)
    # the pass sets no --compute_dtype: float32, so each res chain's first
    # sites take K2's and K3's f32-operand forms
    want = {"dis_iter": len(_level_sizes(H // ds, W // ds, 2)) * batches,
            **{k: v * batches for k, v in F32_PER_BATCH["int8_static"].items()}}
    log(f"run_sky_swap.main on a {SKY_FRAMES}-frame 1080p mp4 (PIPELINE_ARGS "
        f"'{SKY_PIPELINE_ARGS}'): rc {rc}, {n_frames} frames extracted, {n_masks} masks, {got} "
        f"frames encoded, {secs:.2f} s (extract {split['extract']:.2f}, masks "
        f"{split['masks']:.2f}, stylize pass {split['stylize pass']:.2f}, rest "
        f"{secs - sum(split.values()):.2f}); launches {used}, expected {want}")
    if rc != 0 or n_frames != SKY_FRAMES or n_masks != n_frames or got != SKY_FRAMES:
        fail("run_sky_swap did not write one mask per frame and every frame")
    if used != want:
        fail(f"run_sky_swap's launches {used} are not the expected {want}")
    return used


def deeplab_phase(dev, workdir: Path) -> dict:
    """Phase 11: the ResNet-101 DeepLab loaded through ``load_deeplab`` (a
    ``.pth.tar`` with the reference's wrapper and prefixes), card vs CPU and
    its bf16 forward; the masked step; the other backbones; the sky-swap
    workflow. Returns the workflow's launches."""
    from neuralstyletransferv1_torch.apps.sky_swap import load_deeplab

    t0 = time.perf_counter()
    ckpt = deeplab_checkpoint(workdir / "deeplab-resnet.pth.tar", "resnet")
    state, nc, bb = load_deeplab(str(ckpt))
    if (nc, bb) != (21, "resnet"):
        fail(f"load_deeplab read {nc} classes, backbone {bb}")
    deeplab_vs_cpu(dev, state, "resnet")
    deeplab_forward_bf16(dev, state, "resnet")
    masked_step_phase(dev, state)
    for backbone in DL_BACKBONES[1:]:
        sd_path = deeplab_checkpoint(workdir / f"deeplab-{backbone}.pth.tar", backbone)
        bstate, _, detected = load_deeplab(str(sd_path))
        if detected != backbone:
            fail(f"load_deeplab detected {detected}, expected {backbone}")
        deeplab_vs_cpu(dev, bstate, backbone)
        deeplab_forward_bf16(dev, bstate, backbone)
    launches = sky_swap_phase(dev, workdir, ckpt)
    log(f"phase 11 (DeepLab, masked step, sky-swap workflow) took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the magenta slot, Farneback flow and the Caffe SSD detector
# ---------------------------------------------------------------------------

ITEM6_FRAMES = 16             # frames of the magenta and Farneback clips
MAGENTA_TILE, MAGENTA_OVERLAP = 256, 32   # the CLI's defaults
MAGENTA_MAE_TOL = 1e-4        # [0,1], the colour-transfer slot card vs CPU (LAB a/b round)
CIN_CMP_HW = (256, 480)       # the compact net card vs CPU: one frame, 6 tiles of 256²
CIN_MAE_TOL = 1e-5            # [0,1], f32 card vs CPU
CIN_ROUNDS = 3                # timed rounds of the 1080p B=8 compact-net batch
FB_MEAN_TOL = 1e-2            # px, mean |Δflow| card vs CPU (one pair)
FB_SHARE = 0.999              # of the pixels within 0.5 px, card vs CPU
FB_PAN_TOL = 0.3              # px, the interior's mean flow vs the clip's pan
SSD_REL_TOL = 1e-4            # relative MAE of the SSD heads, card vs CPU
SSD_ROW_TOL = 1e-4            # detections after NMS (score, box), card vs CPU
LADDER_M, LADDER_B = 8, 2      # the bench's Johnson bank and batch (bench.py::_ladder)
LADDER_NST_M = 4              # rungs of the NST_Train bank
LADDER_ROUNDS = 5             # timed rounds of a ladder call
LADDER_CMP = (2, 64, 96)      # the small f32 bank's input, card vs CPU
LADDER_F32_TOL = 1e-5         # [0,1], the f32 bank against its models one by one (MAE)
LADDER_CARD_TOL = 1e-4        # [0,1], the f32 bank card vs CPU (MAE)
GRAM_HW, GRAM_STEPS = 512, 500  # the bench's Gram NST (bench.py::_gram_nst)
GRAM_CMP_HW, GRAM_CMP_STEPS = 64, 10  # its card vs CPU run
GRAM_HIST_TOL = 1e-4          # relative, each step's loss card vs CPU
GRAM_IMG_TOL = 1e-4           # the image's mean |Δ| card vs CPU (≥ GRAM_IMG_SHARE within 1e-3)
GRAM_IMG_SHARE = 0.999
SAW_FRAMES, SAW_HW = 4, (540, 960)  # style_all_weights on the card: frames, their size
# a res10-style SSD at narrow widths: BN + Scale on the input, a 7×7 stride-2
# conv, ceil-mode pool, one residual block, a stride-2 conv; heads on two
# maps (the first L2-normalized), PriorBox, the Reshape/Softmax/Flatten conf
# chain and DetectionOutput, as models/face_detector/deploy.prototxt has them
SSD_PROTOTXT = """
name: "ssd_small"
input: "data"
input_shape { dim: 1 dim: 3 dim: 300 dim: 300 }
layer { name: "data_bn" type: "BatchNorm" bottom: "data" top: "data_bn" }
layer { name: "data_scale" type: "Scale" bottom: "data_bn" top: "data_bn"
  scale_param { bias_term: true } }
layer { name: "conv1_h" type: "Convolution" bottom: "data_bn" top: "conv1_h"
  convolution_param { num_output: 16 pad: 3 kernel_size: 7 stride: 2 } }
layer { name: "conv1_bn_h" type: "BatchNorm" bottom: "conv1_h" top: "conv1_h" }
layer { name: "conv1_scale_h" type: "Scale" bottom: "conv1_h" top: "conv1_h"
  scale_param { bias_term: true } }
layer { name: "conv1_relu" type: "ReLU" bottom: "conv1_h" top: "conv1_h" }
layer { name: "conv1_pool" type: "Pooling" bottom: "conv1_h" top: "conv1_pool"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "layer_64_1_conv1_h" type: "Convolution" bottom: "conv1_pool"
  top: "layer_64_1_conv1_h"
  convolution_param { num_output: 16 bias_term: false pad: 1 kernel_size: 3 stride: 1 } }
layer { name: "layer_64_1_bn2_h" type: "BatchNorm" bottom: "layer_64_1_conv1_h"
  top: "layer_64_1_conv1_h" }
layer { name: "layer_64_1_scale2_h" type: "Scale" bottom: "layer_64_1_conv1_h"
  top: "layer_64_1_conv1_h" scale_param { bias_term: true } }
layer { name: "layer_64_1_relu2" type: "ReLU" bottom: "layer_64_1_conv1_h"
  top: "layer_64_1_conv1_h" }
layer { name: "layer_64_1_conv2_h" type: "Convolution" bottom: "layer_64_1_conv1_h"
  top: "layer_64_1_conv2_h"
  convolution_param { num_output: 16 bias_term: false pad: 1 kernel_size: 3 stride: 1 } }
layer { name: "layer_64_1_sum" type: "Eltwise" bottom: "layer_64_1_conv2_h"
  bottom: "conv1_pool" top: "layer_64_1_sum" }
layer { name: "conv2_h" type: "Convolution" bottom: "layer_64_1_sum" top: "conv2_h"
  convolution_param { num_output: 32 pad: 1 kernel_size: 3 stride: 2 } }
layer { name: "conv2_relu" type: "ReLU" bottom: "conv2_h" top: "conv2_h" }
layer { name: "f1_norm" type: "Normalize" bottom: "layer_64_1_sum" top: "f1_norm"
  norm_param { across_spatial: false channel_shared: false } }
layer { name: "f1_mbox_loc" type: "Convolution" bottom: "f1_norm" top: "f1_mbox_loc"
  convolution_param { num_output: 16 pad: 1 kernel_size: 3 stride: 1 } }
layer { name: "f1_mbox_loc_perm" type: "Permute" bottom: "f1_mbox_loc"
  top: "f1_mbox_loc_perm" permute_param { order: 0 order: 2 order: 3 order: 1 } }
layer { name: "f1_mbox_loc_flat" type: "Flatten" bottom: "f1_mbox_loc_perm"
  top: "f1_mbox_loc_flat" flatten_param { axis: 1 } }
layer { name: "f1_mbox_conf" type: "Convolution" bottom: "f1_norm" top: "f1_mbox_conf"
  convolution_param { num_output: 8 pad: 1 kernel_size: 3 stride: 1 } }
layer { name: "f1_mbox_conf_perm" type: "Permute" bottom: "f1_mbox_conf"
  top: "f1_mbox_conf_perm" permute_param { order: 0 order: 2 order: 3 order: 1 } }
layer { name: "f1_mbox_conf_flat" type: "Flatten" bottom: "f1_mbox_conf_perm"
  top: "f1_mbox_conf_flat" flatten_param { axis: 1 } }
layer { name: "f1_mbox_priorbox" type: "PriorBox" bottom: "f1_norm" bottom: "data"
  top: "f1_mbox_priorbox"
  prior_box_param { min_size: 30.0 max_size: 60.0 aspect_ratio: 2 flip: true clip: false
    variance: 0.1 variance: 0.1 variance: 0.2 variance: 0.2 step: 4 offset: 0.5 } }
layer { name: "f2_mbox_loc" type: "Convolution" bottom: "conv2_h" top: "f2_mbox_loc"
  convolution_param { num_output: 16 pad: 1 kernel_size: 3 stride: 1 } }
layer { name: "f2_mbox_loc_perm" type: "Permute" bottom: "f2_mbox_loc"
  top: "f2_mbox_loc_perm" permute_param { order: 0 order: 2 order: 3 order: 1 } }
layer { name: "f2_mbox_loc_flat" type: "Flatten" bottom: "f2_mbox_loc_perm"
  top: "f2_mbox_loc_flat" flatten_param { axis: 1 } }
layer { name: "f2_mbox_conf" type: "Convolution" bottom: "conv2_h" top: "f2_mbox_conf"
  convolution_param { num_output: 8 pad: 1 kernel_size: 3 stride: 1 } }
layer { name: "f2_mbox_conf_perm" type: "Permute" bottom: "f2_mbox_conf"
  top: "f2_mbox_conf_perm" permute_param { order: 0 order: 2 order: 3 order: 1 } }
layer { name: "f2_mbox_conf_flat" type: "Flatten" bottom: "f2_mbox_conf_perm"
  top: "f2_mbox_conf_flat" flatten_param { axis: 1 } }
layer { name: "f2_mbox_priorbox" type: "PriorBox" bottom: "conv2_h" bottom: "data"
  top: "f2_mbox_priorbox"
  prior_box_param { min_size: 60.0 max_size: 111.0 aspect_ratio: 2 flip: true clip: false
    variance: 0.1 variance: 0.1 variance: 0.2 variance: 0.2 step: 8 offset: 0.5 } }
layer { name: "mbox_loc" type: "Concat" bottom: "f1_mbox_loc_flat"
  bottom: "f2_mbox_loc_flat" top: "mbox_loc" concat_param { axis: 1 } }
layer { name: "mbox_conf" type: "Concat" bottom: "f1_mbox_conf_flat"
  bottom: "f2_mbox_conf_flat" top: "mbox_conf" concat_param { axis: 1 } }
layer { name: "mbox_priorbox" type: "Concat" bottom: "f1_mbox_priorbox"
  bottom: "f2_mbox_priorbox" top: "mbox_priorbox" concat_param { axis: 2 } }
layer { name: "mbox_conf_reshape" type: "Reshape" bottom: "mbox_conf"
  top: "mbox_conf_reshape" reshape_param { shape { dim: 0 dim: -1 dim: 2 } } }
layer { name: "mbox_conf_softmax" type: "Softmax" bottom: "mbox_conf_reshape"
  top: "mbox_conf_softmax" softmax_param { axis: 2 } }
layer { name: "mbox_conf_flatten" type: "Flatten" bottom: "mbox_conf_softmax"
  top: "mbox_conf_flatten" flatten_param { axis: 1 } }
layer { name: "detection_out" type: "DetectionOutput" bottom: "mbox_loc"
  bottom: "mbox_conf_flatten" bottom: "mbox_priorbox" top: "detection_out"
  include { phase: TEST }
  detection_output_param { num_classes: 2 share_location: true background_label_id: 0
    nms_param { nms_threshold: 0.45 top_k: 400 } code_type: CENTER_SIZE keep_top_k: 200
    confidence_threshold: 0.01 } }
"""


def ssd_blob_shapes(net) -> dict:
    """Each weighted layer's blob shapes, walked from the parsed prototxt:
    Convolution [co, ci, k, k] (+ [co]), BatchNorm mean, var, scale factor,
    Scale [c] (+ [c]), Normalize [c]."""
    from neuralstyletransferv1_torch.models.caffe_ssd import _bool1, _int1

    shapes = {}
    channels = {net.one("input", "data"): int(net.one("input_shape").many("dim")[1])}
    for l in net.many("layer"):
        ltype, name, bots, tops = l.one("type"), l.one("name"), l.many("bottom"), l.many("top")
        cin = channels.get(bots[0]) if bots else None
        if ltype == "Convolution":
            cp = l.one("convolution_param")
            cout, k = _int1(cp, "num_output", 1), _int1(cp, "kernel_size", 1)
            shapes[name] = [(cout, cin, k, k)] + ([(cout,)] if _bool1(cp, "bias_term", True)
                                                  else [])
            channels[tops[0]] = cout
        elif ltype == "BatchNorm":
            shapes[name] = [(cin,), (cin,), (1,)]
        elif ltype == "Scale":
            shapes[name] = [(cin,)] * (2 if _bool1(l.one("scale_param"), "bias_term", False)
                                       else 1)
        elif ltype == "Normalize":
            shapes[name] = [(cin,)]
        if ltype == "Concat":
            channels[tops[0]] = sum(channels.get(b, 0) for b in bots)
        elif tops and tops[0] not in channels:
            channels[tops[0]] = cin
    return shapes


def write_ssd(d: Path, seed: int) -> tuple:
    """SSD_PROTOTXT and a caffemodel of seeded weights (BatchNorm's running
    sums over a scale factor of 2, so the load's division shows) written to
    ``d``; returns (prototxt, caffemodel, blobs)."""
    import numpy as np

    from neuralstyletransferv1_torch.io import caffe as cio

    d.mkdir(parents=True, exist_ok=True)
    proto = d / "deploy.prototxt"
    proto.write_text(SSD_PROTOTXT)
    net = cio.parse_prototxt(SSD_PROTOTXT)
    types = {l.one("name"): l.one("type") for l in net.many("layer")}
    rng = np.random.default_rng(seed)
    blobs = {}
    for name, shapes in ssd_blob_shapes(net).items():
        c = shapes[0][0]
        if types[name] == "BatchNorm":
            # the blob's mean-subtracted input spans about ±128
            mean, var = ((rng.normal(0, 10, c), np.full(c, 60.0 ** 2)) if name == "data_bn"
                         else (rng.normal(0, 0.2, c), rng.uniform(0.5, 1.5, c)))
            arrs = [mean * 2.0, var * 2.0, np.full(1, 2.0)]
        elif types[name] == "Normalize":
            arrs = [rng.uniform(5.0, 15.0, c)]
        elif types[name] == "Scale":
            arrs = [rng.uniform(0.5, 1.5, c), rng.normal(0, 0.1, c)][:len(shapes)]
        else:
            arrs = [rng.normal(0, 1.4 / np.sqrt(np.prod(shapes[0][1:])), shapes[0]),
                    rng.normal(0, 0.1, c)][:len(shapes)]
        blobs[name] = [np.asarray(a, np.float32) for a in arrs]
    model = d / "weights.caffemodel"
    cio.write_caffemodel(model, blobs, types)
    return proto, model, blobs


def cin_tree(seed: int) -> dict:
    """A compact CIN net's weights as ``magenta.init``'s tree, drawn from
    the numpy ``seed`` (``models/magenta.init_tree``)."""
    from neuralstyletransferv1_torch.models import magenta as tm

    return tm.init_tree(seed)


def timed_main(argv) -> tuple:
    """``pipeline.main(argv)`` with its wall split by part: extract (the
    host blocked on the decode queue), stylize, flow and temporal (each
    call between two synchronizes, so the device work is inside), encode
    (the host in the encoder's write and close). Counts zeroed before.
    Returns (rc, seconds, split)."""
    import torch

    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.engine import stylizer as tst
    from neuralstyletransferv1_torch.io import frames as tframes
    from neuralstyletransferv1_torch.temporal import ema as tema

    split = dict.fromkeys(("extract", "stylize", "flow", "temporal", "encode"), 0.0)

    def timed(key, fn, sync):
        def run(*a, **k):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*a, **k)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                split[key] += time.perf_counter() - t0
        return run

    stream_iter = tframes.VideoFrameStream.__iter__
    jit_stylizer = tst.jit_stylizer

    def timed_iter(self):
        it = stream_iter(self)
        while True:
            t0 = time.perf_counter()
            f = next(it, None)
            split["extract"] += time.perf_counter() - t0
            if f is None:
                return
            yield f

    patches = [
        (tframes.VideoFrameStream, "__iter__", timed_iter),
        (tst, "jit_stylizer",
         lambda *a, **k: timed("stylize", jit_stylizer(*a, **k), True)),
        (tpipe, "flows_at_downscale", timed("flow", tpipe.flows_at_downscale, True)),
        (tema, "temporal_postprocess_split",
         timed("temporal", tema.temporal_postprocess_split, True)),
        (tframes.VideoStreamWriter, "write",
         timed("encode", tframes.VideoStreamWriter.write, False)),
        (tframes.VideoStreamWriter, "close",
         timed("encode", tframes.VideoStreamWriter.close, False)),
    ]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, fn in patches:
        setattr(obj, attr, fn)
    zero_counts()
    t0 = time.perf_counter()
    try:
        rc = tpipe.main([str(a) for a in argv])
    finally:
        secs = time.perf_counter() - t0
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    return rc, secs, split


def _split_text(secs: float, split: dict) -> str:
    return (f"{secs:.2f} s (" + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
            + f", rest {secs - sum(split.values()):.2f})")


def magenta_video_phase(dev, workdir: Path, src: Path) -> dict:
    """``main()`` with a magenta slot (the colour transfer: no SavedModel is
    in the repo) on the 16-frame 1080p clip, tile 256, overlap 32 (45 tiles
    a frame, 360 a B=8 batch), ``--frame_batch 8 --flow_ema`` (DIS): every
    frame encoded, K1's launches exact, the wall split; then the slot's
    stylize card vs CPU on a 256×480 crop. Returns the launches."""
    import numpy as np
    import torch
    from PIL import Image

    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.engine import stylizer as tst
    from neuralstyletransferv1_torch.ops.dis_flow import _level_sizes

    style = workdir / "magenta_style.png"
    Image.fromarray(moving_frames(1, 300, 400, SEED + 30)[0]).save(style)
    dst = workdir / "magenta_out.mp4"
    stride = MAGENTA_TILE - MAGENTA_OVERLAP
    tiles = len(range(0, H, stride)) * len(range(0, W, stride))
    argv = ["--input_video", src, "--output_video", dst, "--model_type", "magenta",
            "--magenta_style", style, "--frame_batch", B, "--flow_ema",
            "--magenta_model_root", workdir / "no_magenta_models", "--work_dir", workdir / "_mg"]
    rc, secs, split = timed_main(argv)
    used = {k: v for k, v in read_counts().items() if v}
    ds = tpipe.effective_flow_downscale(0, H, W)
    batches = -(-ITEM6_FRAMES // B)
    want = {"dis_iter": len(_level_sizes(H // ds, W // ds, 2)) * batches}
    got = clip_frame_count(dst)
    log(f"main() magenta slot (colour transfer, tile {MAGENTA_TILE}, overlap {MAGENTA_OVERLAP}: "
        f"{tiles} tiles a frame, {tiles * B} a batch) on a {ITEM6_FRAMES}-frame 1080p mp4, "
        f"--frame_batch {B} --flow_ema: rc {rc}, {got} frames encoded, {_split_text(secs, split)}; "
        f"launches {used}, expected {want}")
    if rc != 0 or got != ITEM6_FRAMES:
        fail("main() with a magenta slot did not encode every frame")
    if used != want:
        fail(f"the magenta video path's launches {used} are not the expected {want}")

    args = tpipe.build_parser().parse_args([str(a) for a in argv])
    x = torch.from_numpy(np.stack(moving_frames(2, 256, 480, SEED + 31))).float() / 255.0
    outs = [tst.jit_stylizer(tpipe.load_slot_bank(args, d)[0])(x.to(d)).cpu()
            for d in (dev, torch.device("cpu"))]
    mae = (outs[0] - outs[1]).abs().mean().item()
    log(f"magenta slot stylize 2x256x480, card vs CPU: MAE {mae:.3g} (bound {MAGENTA_MAE_TOL}), "
        f"max {(outs[0] - outs[1]).abs().max().item():.3g}, output std "
        f"{outs[0].std().item():.3f}")
    if not (mae <= MAGENTA_MAE_TOL and outs[0].std().item() > 1e-2):
        fail("the magenta slot on the card disagrees with the CPU")
    return used


def compact_cin_phase(dev) -> None:
    """The compact CIN net at full width (seeded ``cin_tree``) on a 1080p
    B=8 batch through ``stylize_tiled_batch`` (360 tiles of 256², f32, TF32
    off): finite, in [0, 1], device ms a batch (CUDA events), peak memory;
    card vs CPU on one 256×480 frame (6 tiles)."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.models import magenta as tm

    tree = cin_tree(SEED + 32)
    net = tm.compact_from_jax(tree, dev)
    x = torch.from_numpy(np.stack(moving_frames(B, H, W, SEED + 33))).to(dev).float() / 255.0
    style = torch.from_numpy(moving_frames(1, MAGENTA_TILE, MAGENTA_TILE, SEED + 34)[0]) \
        .to(dev).float() / 255.0
    stride = MAGENTA_TILE - MAGENTA_OVERLAP
    tiles = B * len(range(0, H, stride)) * len(range(0, W, stride))

    def run():
        return tm.stylize_tiled_batch(net, x, style, tile_size=MAGENTA_TILE,
                                      overlap=MAGENTA_OVERLAP)

    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        y = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if tuple(y.shape) != (B, H, W, 3) or not bool(torch.isfinite(y).all()) \
                or y.min().item() < 0 or y.max().item() > 1 or y.std().item() < 1e-3:
            fail(f"the compact net's 1080p batch {tuple(y.shape)} is not a finite [0, 1] image")
        ms = _timed(f"compact CIN net f32 {B}x{H}x{W} ({tiles} tiles of {MAGENTA_TILE}²)", run,
                    CIN_ROUNDS)
    t = MAGENTA_TILE
    flop_tile = 2 * sum(ho * ho * ci * co * k * k for ho, ci, co, k in (
        (t, 3, 32, 9), (t // 2, 32, 64, 3), (t // 4, 64, 128, 3), *[(t // 4, 128, 128, 3)] * 10,
        (t // 2, 128, 64, 3), (t, 64, 32, 3), (t, 32, 3, 9)))
    flop = flop_tile * tiles
    log(f"compact CIN net ({CARD}): {ms:.2f} ms a 1080p B={B} batch, "
        f"{flop_tile / 1e9:.2f} GFLOP a tile, "
        f"{flop / 1e12:.2f} TFLOP a batch, {flop / ms / 1e9:.1f} TFLOP/s (f32 peak "
        f"{PEAK_F32_OPS / 1e12:.0f}: {flop / PEAK_F32_OPS * 1e3:.1f} ms), peak memory "
        f"{peak:.2f} GiB")

    ch, cw = CIN_CMP_HW
    outs = []
    for d in (dev, torch.device("cpu")):
        with torch.no_grad():
            outs.append(tm.stylize_tiled_batch(
                tm.compact_from_jax(tree, d), x[:1, :ch, :cw].to(d), style.to(d),
                tile_size=MAGENTA_TILE, overlap=MAGENTA_OVERLAP).cpu())
    d_ = (outs[0] - outs[1]).abs()
    n_cmp = len(range(0, ch, stride)) * len(range(0, cw, stride))
    log(f"compact CIN net 1x{ch}x{cw} ({n_cmp} tiles), card vs CPU: MAE {d_.mean().item():.3g} "
        f"(bound {CIN_MAE_TOL}), max {d_.max().item():.3g}")
    if not d_.mean().item() <= CIN_MAE_TOL:
        fail("the compact CIN net on the card disagrees with the CPU")


def farneback_phase(dev, workdir: Path, src: Path) -> dict:
    """``main()`` with ``--flow_method farneback --quantize int8_static`` and
    the Johnson checkpoint (float32: K2 and K3 take their f32 forms at the
    res chain's first sites) on the 16-frame clip: K1 0 and K2–K4's
    launches exact, the wall split; Farneback's ms a pair at 540×960 (the
    auto downscale 2) over 8 pairs; card vs CPU on one pair (mean |Δflow|,
    the share within 0.5 px) and the clip's pan recovered. Returns the
    launches."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.ops.color import rgb_to_gray
    from neuralstyletransferv1_torch.ops.flow import farneback_flow
    from neuralstyletransferv1_torch.ops.resize import resize_bilinear

    dst = workdir / "fb_out.mp4"
    rc, secs, split = timed_main(
        ["--input_video", src, "--output_video", dst, "--model", CKPT, "--frame_batch", B,
         "--flow_ema", "--flow_method", "farneback", "--quantize", "int8_static",
         "--work_dir", workdir / "_fb"])
    used = {k: v for k, v in read_counts().items() if v}
    batches = -(-ITEM6_FRAMES // B)
    want = {k: v * batches for k, v in F32_PER_BATCH["int8_static"].items()}
    got = clip_frame_count(dst)
    log(f"main() --flow_method farneback --quantize int8_static on a {ITEM6_FRAMES}-frame 1080p "
        f"mp4, --frame_batch {B} --flow_ema: rc {rc}, {got} frames encoded, "
        f"{_split_text(secs, split)}; launches {used}, expected {want}")
    if rc != 0 or got != ITEM6_FRAMES:
        fail("main() with --flow_method farneback did not encode every frame")
    if used != want:
        fail(f"the Farneback path's launches {used} are not the expected {want}")

    ds = tpipe.effective_flow_downscale(0, H, W)
    u8 = torch.from_numpy(np.stack(moving_frames(B + 1, H, W, SEED + 35))).to(dev)
    g = resize_bilinear(rgb_to_gray(u8.float())[..., None], (H // ds, W // ds))[..., 0]
    prevs, currs = g[:-1].contiguous(), g[1:].contiguous()
    with torch.no_grad():
        ms = _timed(f"farneback_flow {B} pairs at {H // ds}x{W // ds}",
                    lambda: farneback_flow(prevs, currs), 5)
        card = farneback_flow(prevs[:1], currs[:1])[0].cpu()
        cpu = farneback_flow(prevs[:1].cpu(), currs[:1].cpu())[0]
    d = (card - cpu).abs()
    share = (d.amax(-1) <= 0.5).float().mean().item()
    m = min(H, W) // ds // 8
    pan = card[m:-m, m:-m].mean((0, 1)).tolist()
    log(f"farneback_flow at {H // ds}x{W // ds} ({CARD}): {ms / B:.3f} ms a pair ({ms:.2f} ms "
        f"for {B}); "
        f"card vs CPU on one pair: mean |dflow| {d.mean().item():.3g} px (bound {FB_MEAN_TOL}), "
        f"{share:.5f} within 0.5 px (bound {FB_SHARE}), max {d.max().item():.3g}; interior mean "
        f"flow ({pan[0]:.3f}, {pan[1]:.3f}) px, the pan ({3 / ds}, {1 / ds})")
    if not (d.mean().item() <= FB_MEAN_TOL and share >= FB_SHARE):
        fail("Farneback on the card disagrees with the CPU")
    if not (abs(pan[0] - 3 / ds) <= FB_PAN_TOL and abs(pan[1] - 1 / ds) <= FB_PAN_TOL):
        fail("Farneback does not recover the clip's pan")
    return used


def ssd_phase(dev, workdir: Path) -> None:
    """The port's SSD detector on the card on SSD_PROTOTXT and a seeded
    caffemodel that this phase writes: the heads (loc, conf) against the
    CPU run, the detections after NMS the same, ``detect_faces`` the same
    faces, the trunk timed."""
    import numpy as np
    import torch
    from PIL import Image

    from neuralstyletransferv1_torch.models import caffe_ssd as tssd

    proto, model, _ = write_ssd(workdir / "ssd", SEED + 36)
    img = moving_frames(1, 480, 640, SEED + 37)[0]
    path = workdir / "faces.png"
    Image.fromarray(img).save(path)
    blob = tssd.blob_from_image_bgr(np.ascontiguousarray(img[..., ::-1]))
    sides = {"card": dev, "cpu": torch.device("cpu")}
    nets = {s: tssd.load_caffe_ssd(proto, model, d) for s, d in sides.items()}
    heads = {s: {k: v.cpu() for k, v in n.trunk(blob).items()} for s, n in nets.items()}
    rel = {k: ((heads["card"][k] - heads["cpu"][k]).abs().mean()
               / heads["cpu"][k].abs().mean()).item() for k in ("__loc__", "__conf__")}
    a, b = (nets[s].forward(blob)[0, 0] for s in sides)
    same = a.shape == b.shape and a.shape[0] > 0 and bool(np.abs(a - b).max() <= SSD_ROW_TOL)
    faces = {s: tssd.detect_faces(path, proto, model, 0.5, device=d) for s, d in sides.items()}
    same_faces = [f["bbox"] for f in faces["card"]] == [f["bbox"] for f in faces["cpu"]]
    x = torch.from_numpy(blob).to(dev)
    ms = _timed("SSD trunk 1x3x300x300", lambda: nets["card"].trunk(x), 5)
    log(f"SSD ({len(nets['cpu'].layers)} layers, priors on {len(nets['cpu'].priorbox_layers)} "
        f"maps) card vs CPU: heads relative MAE loc {rel['__loc__']:.3g}, conf "
        f"{rel['__conf__']:.3g} (bound {SSD_REL_TOL}); {a.shape[0]} detections after NMS, "
        f"{'the same' if same else 'NOT the same'} (bound {SSD_ROW_TOL}); detect_faces "
        f"{len(faces['card'])} faces at 0.5, {'the same' if same_faces else 'NOT the same'}; "
        f"trunk {ms:.3f} ms")
    if not (max(rel.values()) <= SSD_REL_TOL and same and same_faces):
        fail("the SSD detector on the card disagrees with the CPU")


def backends_phase(dev, workdir: Path) -> dict:
    """Phase 12: the magenta video path, the compact CIN net at full width,
    the Farneback video path and the SSD detector. Returns the two video
    paths' launches."""
    t0 = time.perf_counter()
    src = workdir / "item6_in.mp4"
    write_clip(src, moving_frames(ITEM6_FRAMES, H, W, SEED + 29))
    launches = dict(magenta_video_phase(dev, workdir, src))
    compact_cin_phase(dev)
    for k, v in farneback_phase(dev, workdir, src).items():
        launches[k] = launches.get(k, 0) + v
    ssd_phase(dev, workdir)
    log(f"phase 12 (magenta, compact CIN net, Farneback, SSD) took "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def ladder_bank(arch: str, m: int, preset: str | None, dev) -> list:
    """``m`` random full-width slots of ``arch`` (seeds 0..m−1) on ``dev``."""
    from neuralstyletransferv1_torch.engine import stylizer as tst

    return [tst.make_random_model(arch, seed=s, io_preset=preset, device=dev) for s in range(m)]


def _peak_gib(fn) -> float:
    """GiB allocated at the peak of ``fn()`` beyond what was allocated before."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def ladder_phase(dev) -> dict:
    """The bench's ladder (8 Johnson slots, bf16, 1080×1920 B=2) timed, its
    memory and busy share; the NST bank; the f32 checks. Returns the
    bench's two ladder keys."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.engine import stylizer as tst

    x = torch.from_numpy(np.stack(moving_frames(LADDER_B, H, W, SEED + 40))).to(dev).float() \
        / 255.0
    bank = ladder_bank("johnson", LADDER_M, None, dev)
    f = tst.jit_ladder_stylizer(bank, dtype=torch.bfloat16)
    peak = _peak_gib(lambda: f(x))
    out = f(x)
    if tuple(out.shape) != (LADDER_M, LADDER_B, H, W, 3) or not bool(torch.isfinite(out).all()):
        fail(f"the ladder's output {tuple(out.shape)} is not finite [M, B, H, W, 3]")
    passes = LADDER_M * LADDER_B
    ms = _timed(f"ladder bf16, {LADDER_M} Johnson slots x {LADDER_B}x{H}x{W}", lambda: f(x),
                LADDER_ROUNDS)
    gflop = 2 * sum(ho * wo * ci * co * k * k for ho, wo, ci, co, k in (
        (H, W, 3, 32, 9), (H // 2, W // 2, 32, 64, 3), (H // 4, W // 4, 64, 128, 3),
        *[(H // 4, W // 4, 128, 128, 3)] * 10, (H // 2, W // 2, 128, 64, 3),
        (H, W, 64, 32, 3), (H, W, 32, 3, 9))) / 1e9
    wall, busy, n = profile_report("ladder call (bf16, 8 slots, B=2)", lambda: f(x))
    log(f"ladder ({CARD}): {ms:.2f} ms a call of {passes} passes, {passes / ms * 1e3:.2f} "
        f"passes/s, {ms / passes:.2f} ms a pass; {gflop:.1f} GFLOP a pass, "
        f"{gflop * passes / ms:.1f} TFLOP/s (bf16 bound {gflop * passes / PEAK_BF16_OPS * 1e12:.2f}"
        f" ms); peak {peak:.2f} GiB; busy {busy / wall:.1%} of the profiled call, {n} kernels")
    del out, f

    nbank = ladder_bank("nst", LADDER_NST_M, None, dev)
    fn = tst.jit_ladder_stylizer(nbank, dtype=torch.bfloat16)
    npeak = _peak_gib(lambda: fn(x))
    nms = _timed(f"NST ladder bf16, {LADDER_NST_M} rungs x {LADDER_B}x{H}x{W}", lambda: fn(x),
                 3)
    log(f"NST ladder ({CARD}): {nms:.2f} ms a call, "
        f"{LADDER_NST_M * LADDER_B / nms * 1e3:.2f} passes/s, peak {npeak:.2f} GiB")
    del fn

    # f32: the bank against its models one by one; bf16 against f32
    for preset, bf16_tol in (("imagenet_255", QUANT_MAE_TOL), ("raw_01", QUANT_BROKEN_TOL)):
        models = [tst.StyleModel(m.arch, m.net, preset, m.name) for m in bank]
        f32 = tst.jit_ladder_stylizer(models)(x)
        one = max((f32[i] - tst.jit_stylizer(m)(x)).abs().mean().item()
                  for i, m in enumerate(models))
        b16 = (tst.jit_ladder_stylizer(models, dtype=torch.bfloat16)(x) - f32).abs().mean().item()
        log(f"ladder {preset}: f32 bank vs its models one by one, worst MAE {one:.3g} (bound "
            f"{LADDER_F32_TOL}); bf16 vs f32 MAE {b16:.3g} (bound {bf16_tol}); f32 output std "
            f"{f32.std().item():.4f}")
        if not (one <= LADDER_F32_TOL and b16 <= bf16_tol):
            fail(f"the ladder bank ({preset}) disagrees with its models or with f32")
        del f32
    b, h, w = LADDER_CMP
    xs = x[:b, :h, :w].contiguous()
    outs = [tst.jit_ladder_stylizer(ladder_bank("johnson", 3, "raw_01", d))(xs.to(d)).cpu()
            for d in (dev, torch.device("cpu"))]
    mae = (outs[0] - outs[1]).abs().mean().item()
    log(f"ladder f32 3 slots {b}x{h}x{w} raw_01, card vs CPU: MAE {mae:.3g} (bound "
        f"{LADDER_CARD_TOL}), max {(outs[0] - outs[1]).abs().max().item():.3g}")
    if not mae <= LADDER_CARD_TOL:
        fail("the ladder bank on the card disagrees with the CPU")
    return {"ladder_passes_per_sec": passes / ms * 1e3, "ladder_sec_per_pass": ms / passes / 1e3}


def gram_check(dev) -> None:
    """10 Gram NST steps at 64² card vs CPU, with the CPU test's bounds."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.engine import gram_nst
    from neuralstyletransferv1_torch.models import vgg

    rng = np.random.default_rng(SEED + 41)
    c, s = (torch.from_numpy(rng.random((1, GRAM_CMP_HW, GRAM_CMP_HW, 3)).astype(np.float32))
            for _ in range(2))
    (card, hc), (cpu, hcpu) = [
        tuple(t.cpu() for t in gram_nst.optimize(vgg.load(vgg.init(0), d), c.to(d), s.to(d),
                                                 steps=GRAM_CMP_STEPS))
        for d in (dev, torch.device("cpu"))]
    rel = ((hc - hcpu).abs() / hcpu.abs()).max().item()
    d = (card - cpu).abs()
    share = (d <= 1e-3).float().mean().item()
    log(f"Gram NST {GRAM_CMP_STEPS} steps at {GRAM_CMP_HW}², card vs CPU: history relative "
        f"{rel:.3g} (bound {GRAM_HIST_TOL}), image mean |d| {d.mean().item():.3g} (bound "
        f"{GRAM_IMG_TOL}), {share:.5f} within 1e-3 (bound {GRAM_IMG_SHARE}), max "
        f"{d.max().item():.3g}")
    if not (rel <= GRAM_HIST_TOL and d.mean().item() <= GRAM_IMG_TOL and share >= GRAM_IMG_SHARE):
        fail("the Gram NST on the card disagrees with the CPU")


def gram_phase(dev) -> dict:
    """The bench's Gram NST: VGG16 from seed 0, content and style uniform at
    512², 500 steps, f32 — two whole calls timed, peak memory, 10 steps
    profiled; then the card vs CPU check. Returns the bench's key (the first
    call, as ``bench.py`` times its first, compiling call)."""
    import torch

    from neuralstyletransferv1_torch.engine import gram_nst
    from neuralstyletransferv1_torch.models import vgg

    net = vgg.load(vgg.init(0), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    content, style = (torch.rand((1, GRAM_HW, GRAM_HW, 3), generator=gen, device=dev)
                      for _ in range(2))
    secs, res = [], {}

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res["out"], res["hist"] = gram_nst.optimize(net, content, style, steps=GRAM_STEPS)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)

    peak = _peak_gib(run)
    run()
    hist = res["hist"].cpu()
    out = res["out"]
    if not (bool(torch.isfinite(hist).all()) and hist[-1] < hist[0]
            and tuple(out.shape) == (1, GRAM_HW, GRAM_HW, 3)
            and 0.0 <= out.min().item() and out.max().item() <= 1.0):
        fail(f"the Gram NST's history or image is wrong: loss {hist[0]:.4g} -> {hist[-1]:.4g}")
    gflop = 2 * sum(hw * hw * ci * co * 9 for hw, ci, co in (
        (512, 3, 64), (512, 64, 64), (256, 64, 128), (256, 128, 128), (128, 128, 256),
        (128, 256, 256), (128, 256, 256), (64, 256, 512), (64, 512, 512), (64, 512, 512))) / 1e9
    step_gflop = 2 * gflop  # the forward and the input-only backward
    wall, busy, n = profile_report(f"Gram NST, {GRAM_CMP_STEPS} steps at {GRAM_HW}²",
                                   lambda: gram_nst.optimize(net, content, style,
                                                             steps=GRAM_CMP_STEPS))
    log(f"Gram NST ({CARD}): {GRAM_STEPS} steps at {GRAM_HW}², first call {secs[0]:.3f} s, "
        f"second {secs[1]:.3f} s ({GRAM_STEPS / secs[1]:.1f} steps/s, "
        f"{step_gflop * GRAM_STEPS / secs[1] / 1e3:.1f} TFLOP/s at ~{step_gflop:.0f} GFLOP a "
        f"step; f32 bound {step_gflop * GRAM_STEPS / PEAK_F32_OPS * 1e9:.2f} s); peak "
        f"{peak:.2f} GiB; loss {hist[0]:.4g} -> {hist[-1]:.4g}; profiled: busy "
        f"{busy / wall:.1%}, {n / GRAM_CMP_STEPS:.0f} device kernels a step")
    gram_check(dev)
    return {"gram_nst_500steps_512_sec": secs[0], "gram_nst_500steps_512_sec_second": secs[1]}


def ladder_cli_phase(dev, workdir: Path) -> None:
    """``slow_nst.main`` (20 steps at 256², synthesized PNGs) and
    ``style_all_weights.main`` (two Johnson rungs, 4 frames) with their
    default device (the card)."""
    import torch
    from PIL import Image

    from neuralstyletransferv1_torch.apps import slow_nst, style_all_weights
    from neuralstyletransferv1_torch.models import transformer_net as ttn

    c, s, o = workdir / "nst_c.png", workdir / "nst_s.png", workdir / "nst_out.png"
    for path, seed in ((c, SEED + 43), (s, SEED + 44)):
        Image.fromarray(moving_frames(1, 300, 400, seed)[0]).save(path)
    t0 = time.perf_counter()
    rc = slow_nst.main([str(a) for a in ("--content", c, "--style", s, "--output", o,
                                         "--steps", 20, "--size", 256)])
    secs = time.perf_counter() - t0
    size = Image.open(o).size if o.exists() else None
    log(f"slow_nst.main 20 steps at 256 (card): rc {rc}, {secs:.2f} s, wrote {size}")
    if rc != 0 or size != (256, 192):
        fail("slow_nst.main did not write its 256x192 PNG")

    frames, wdir, out_root = workdir / "saw_frames", workdir / "saw_w", workdir / "saw_out"
    for d in (frames, wdir):
        d.mkdir(exist_ok=True)
    for i, fr in enumerate(moving_frames(SAW_FRAMES, *SAW_HW, SEED + 45), 1):
        Image.fromarray(fr).save(frames / f"frame_{i:04d}.png")
    for seed in (0, 1):
        torch.save(ttn.init(seed), wdir / f"candy_style{seed + 1}e9.pth")
    zero_counts()
    t0 = time.perf_counter()
    rc = style_all_weights.main([str(a) for a in (
        "--frames_dir", frames, "--weights_dir", wdir, "--out_root", out_root, "--io_preset",
        "raw_01", "--frame_batch", SAW_FRAMES, "--work_dir", workdir / "_saw")])
    secs = time.perf_counter() - t0
    counts = [len(list((out_root / f"candy_style{k}e9").glob("*.png"))) for k in (1, 2)]
    used = {k: v for k, v in read_counts().items() if v}
    log(f"style_all_weights.main, 2 rungs x {SAW_FRAMES} frames of {SAW_HW[0]}x{SAW_HW[1]} "
        f"(card): rc {rc}, {secs:.2f} s, outputs {counts}, launches {used}")
    if rc != 0 or counts != [SAW_FRAMES] * 2 or used:
        fail("style_all_weights.main did not style every frame with every rung")


def ladder_gram_phase(dev, workdir: Path) -> dict:
    """Phase 13: the weight ladder, the Gram NST and their CLIs. Returns
    the bench's keys."""
    t0 = time.perf_counter()
    zero_counts()
    keys = ladder_phase(dev)
    keys.update(gram_phase(dev))
    used = {k: v for k, v in read_counts().items() if v}
    log(f"ladder and Gram NST: launches {used}, expected {{}} (no kernel on this path)")
    if used:
        fail(f"the ladder or the Gram NST launched {used}")
    ladder_cli_phase(dev, workdir)
    log(f"phase 13 (ladder, Gram NST, their CLIs) took {time.perf_counter() - t0:.1f} s")
    return keys


# phase 14: --mesh_devices (two shards on the one card), the sharded Gram
# step, the job queue and the presets apps
MESH_ROUNDS = 3               # timed steady batches of each core
MESH_EQUAL_SHARE = 0.999      # of the pixels within 1/255, mesh vs single, smoothing off
MESH_ENGINE_GATE = 4.0        # grey levels, JAX's engine gate for the mesh chain
                              # (tests/test_batched_video.py:281), reported
MESH_CHAIN_TOL = 0.05 * 255   # grey levels, each frame's mean |d| with the chain on: the
                              # chunk seam's bound of tests/test_temporal_shard.py
MESH_GRAM_HW = 128            # the sharded Gram step: 2 images at 128²
MESH_GRAM_TOL = 1e-5          # relative, sharded vs unsharded step (images, loss)
APP_FRAMES = 16               # the apps' clip
APP_PIPELINE_ARGS = "--frame_batch 8"


def _env(env: dict):
    """Set ``env`` in os.environ; returns the restore function."""
    import os

    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})

    def restore():
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return restore


def mesh_chain_check(dev, mesh) -> None:
    """``temporal_postprocess_sharded`` on the card at the slice's shape (B
    seeded frames, flows and masks, the flow EMA, the LAB EMA, the motion
    blend; first batch and a carried one) against its chunk semantics run
    shard by shard through ``temporal_postprocess_split``: bit-identical."""
    import torch

    from neuralstyletransferv1_torch.ops.color import rgb_to_lab_u8
    from neuralstyletransferv1_torch.parallel.mesh import temporal_postprocess_sharded
    from neuralstyletransferv1_torch.temporal.ema import TemporalState, temporal_postprocess_split

    g = torch.Generator(device=dev).manual_seed(SEED + 64)
    styled, orig = (torch.rand((B, H, W, 3), generator=g, device=dev) for _ in range(2))
    flows = torch.randn((B, H, W, 2), generator=g, device=dev) * 1.5
    alphas = torch.rand((B, H, W, 1), generator=g, device=dev)
    has = torch.rand((B,), generator=g, device=dev) > 0.5
    state = TemporalState(torch.rand((H, W, 3), generator=g, device=dev),
                          torch.rand((H, W, 3), generator=g, device=dev) * 255.0)
    kw = dict(flow_ema=True, flow_alpha=0.6, motion_blend=True, blend=0.9)
    n, tl = len(mesh), B // len(mesh)
    for first in (True, False):
        got, gst = temporal_postprocess_sharded(mesh, styled, orig, flows, state=state,
                                                first=first, mask_alphas=alphas, mask_has=has,
                                                **kw)
        outs = []
        for k in range(n):
            sl = slice(k * tl, (k + 1) * tl)
            init = state if k == 0 else TemporalState(styled[k * tl - 1],
                                                      rgb_to_lab_u8(styled[k * tl - 1]))
            o, st = temporal_postprocess_split(styled[sl], orig[sl], flows[sl], init=init,
                                               warmup=first and k == 0, mask_alphas=alphas[sl],
                                               mask_has=has[sl], **kw)
            outs.append(o)
        same = torch.equal(got, torch.cat(outs)) and torch.equal(gst.prev_lab, st.prev_lab)
        log(f"sharded temporal chain on the card, {n} shards, {B}x{H}x{W}, first={first}: "
            f"{'bit-identical to' if same else 'NOT equal to'} its chunk semantics")
        if not same:
            fail("the sharded temporal chain disagrees with its chunk semantics on the card")


def mesh_core_phase(dev) -> dict:
    """The batched core on an explicit 2-shard mesh with both shards on the
    card against the single-device core: 3 batches of 8 1080p panning
    frames, the Johnson checkpoint under ``raw_01`` (its ``imagenet_255``
    output is ~0.001 everywhere, which would hide any difference), bf16,
    under ``int8_static`` and ``int8``. First the sharded chain alone against its chunk semantics
    (``mesh_chain_check``). Smoothing off: the outputs within 1/255 on ≥
    99.9% (the calibration is shared). The chain on (flow EMA + LAB EMA):
    each frame's mean |d| within the chunk seam's bound of
    ``tests/test_temporal_shard.py`` (0.05 of the range), the frames above
    JAX's 4-level engine gate counted; the launches exact (K1 as
    single-device, K2–K5 twice a shard's forward); each core's s/batch by
    CUDA events. Returns the mesh runs' launches."""
    import statistics as stats_

    import torch

    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.ops.dis_flow import _level_sizes
    from neuralstyletransferv1_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=[dev, dev])
    mesh_chain_check(dev, mesh)
    frames = moving_frames(B * N_BATCHES, H, W, SEED + 60)
    ds = tpipe.effective_flow_downscale(0, H, W)
    levels = len(_level_sizes(H // ds, W // ds, 2))
    launches = {k: 0 for k in read_counts()}

    def run(argv, m, timed=False):
        args = tpipe.build_parser().parse_args(
            ["--input_video", "in.mp4", "--output_video", "out.mp4", "--model", str(CKPT),
             "--io_preset", "raw_01", "--frame_batch", str(B), "--compute_dtype", "bfloat16"]
            + argv)
        b, process = tpipe.make_batched_core(args, dev, mesh=m)
        if b != B:
            fail(f"the mesh core's batch is {b}, expected {B}")
        zero_counts()
        outs, ms = [], []
        for i in range(N_BATCHES):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            outs.append(process(frames[i * B:(i + 1) * B]))
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        counts = read_counts()
        if timed:  # steady batches, the state carried on
            for r in range(MESH_ROUNDS):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                process(frames[(r % N_BATCHES) * B:(r % N_BATCHES + 1) * B])
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
        return torch.cat(outs).float(), counts, ms[1:]

    for quantize in ("int8_static", "int8"):
        per = PER_BATCH[(quantize, None)]
        off = ["--quantize", quantize, "--no-smooth_lightness"]
        a, _, _ = run(off, None)
        b, _, _ = run(off, mesh)
        d = (a - b).abs()
        share = (d <= 1.0).float().mean().item()
        log(f"mesh core (2 shards on {CARD}) vs single-device, --quantize {quantize}, smoothing "
            f"off, 1080p B={B} x {N_BATCHES} batches: {share:.6f} of the pixels within 1/255 "
            f"(bound {MESH_EQUAL_SHARE}), mean |d| {d.mean().item() / 255:.3g}, max "
            f"{d.max().item():.0f} levels")
        if share < MESH_EQUAL_SHARE:
            fail(f"the mesh core disagrees with the single-device core under {quantize}")
        on = ["--quantize", quantize, "--flow_ema"]
        a, ca, ta = run(on, None, timed=True)
        b, cb, tb = run(on, mesh, timed=True)
        per_frame = (a - b).abs().mean(dim=(1, 2, 3))
        want = {k: (levels * N_BATCHES if k == "dis_iter" else 2 * per.get(k, 0) * N_BATCHES)
                for k in cb}
        used = {k: v for k, v in cb.items() if v}
        over = int((per_frame > MESH_ENGINE_GATE).sum())
        log(f"mesh core, --quantize {quantize}, flow EMA + LAB EMA: per-frame mean |d| "
            f"{[round(v, 3) for v in per_frame.tolist()]} levels, max "
            f"{per_frame.max().item():.3f} (bound {MESH_CHAIN_TOL:.2f}; {over} of "
            f"{len(per_frame)} frames above JAX's {MESH_ENGINE_GATE}-level engine gate: the "
            f"chunk seam's seed is the raw boundary frame); launches {used} "
            f"({'as' if cb == want else 'NOT as'} expected: K1 {levels} a batch, the sites "
            f"twice a shard's {per}); single-device launches "
            f"{ {k: v for k, v in ca.items() if v} }")
        if per_frame.max().item() > MESH_CHAIN_TOL:
            fail(f"the mesh chain drifts from the single-device chain under {quantize}")
        if cb != want:
            fail(f"the mesh core's launches {cb} are not the expected {want}")
        for k, v in cb.items():
            launches[k] += v
        med_a, med_b = stats_.median(ta) / 1e3, stats_.median(tb) / 1e3
        log(f"mesh core s/batch ({CARD}), --quantize {quantize}, 1080p B={B}, CUDA events over "
            f"{len(ta)} steady batches: single-device {med_a:.4f} (spread "
            f"{(max(ta) - min(ta)) / 1e3:.4f}), 2 shards on the one card {med_b:.4f} (spread "
            f"{(max(tb) - min(tb)) / 1e3:.4f}), {med_b / med_a:.3f}x: two shards on one card "
            f"measure the split's overhead, not scaling")
        torch.cuda.empty_cache()
    return launches


def mesh_main_phase(dev, workdir: Path, src: Path) -> None:
    """``main(--mesh_devices 2 --frame_batch 3)`` on the 16-frame clip: with
    one card visible it prints JAX's clamp line and runs on one device (with
    two or more, the rounding to 4); exit 0, every frame written."""
    import contextlib
    import io

    import torch

    from neuralstyletransferv1_torch.engine import pipeline as tpipe

    dst = workdir / "mesh_out.mp4"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tpipe.main(["--input_video", str(src), "--output_video", str(dst), "--model",
                         str(CKPT), "--mesh_devices", "2", "--frame_batch", "3", "--flow_ema",
                         "--compute_dtype", "bfloat16", "--work_dir", str(workdir / "_mesh")])
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("[mesh]")]
    n = torch.cuda.device_count()
    got = clip_frame_count(dst)
    want = ("[mesh] only 1 device(s) visible; clamping --mesh_devices 2 -> 1" if n < 2
            else "[mesh] rounding --frame_batch 3 -> 4 (multiple of 2)")
    log(f"main(--mesh_devices 2 --frame_batch 3) with {n} card(s) visible: rc {rc}, {got} frames "
        f"written, its mesh lines {lines}")
    if rc != 0 or got != APP_FRAMES or want not in lines:
        fail("main() with --mesh_devices 2 did not clamp or round as the JAX engine does")


def mesh_gram_phase(dev) -> None:
    """``gram_nst.sharded_optimize_step`` on the 2-shard mesh on the card (2
    images at 128², VGG16 from seed 0) against the unsharded step on the
    whole batch: images and loss within 1e-5 relative."""
    import torch

    from neuralstyletransferv1_torch.engine import gram_nst
    from neuralstyletransferv1_torch.models import vgg
    from neuralstyletransferv1_torch.parallel.mesh import make_mesh

    net = vgg.load(vgg.init(0), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    imgs, targets = (torch.rand((2, MESH_GRAM_HW, MESH_GRAM_HW, 3), generator=gen, device=dev)
                     for _ in range(2))
    style = torch.rand((1, MESH_GRAM_HW, MESH_GRAM_HW, 3), generator=gen, device=dev)
    with torch.no_grad():
        feats = vgg.extract_features(net, targets, (vgg.CONTENT_LAYER,))[vgg.CONTENT_LAYER]
        grams = {k: vgg.gram_matrix(v) for k, v in
                 vgg.extract_features(net, style, vgg.STYLE_LAYERS).items()}
    got, _state, loss = gram_nst.sharded_optimize_step(
        net, imgs, feats, grams, gram_nst.adam_init(imgs), mesh=make_mesh(devices=[dev, dev]))
    with torch.inference_mode(False), torch.enable_grad():
        img = imgs.clone().requires_grad_(True)
        total, _ = gram_nst.nst_losses(net, img, feats, grams, content_weight=1.0,
                                       style_weight=1e4, tv_weight=1e-4)
        (g,) = torch.autograd.grad(total, img)
    upd, _ = gram_nst.adam_update(g, gram_nst.adam_init(imgs), 0.02)
    want = torch.clamp(imgs + upd, 0.0, 1.0)
    rel_img = ((got - want).abs().mean() / want.abs().mean()).item()
    rel_loss = abs(loss.item() - total.item()) / abs(total.item())
    log(f"sharded Gram step, 2 shards on the card, 2 x {MESH_GRAM_HW}²: vs the unsharded step, "
        f"images relative {rel_img:.3g}, loss relative {rel_loss:.3g} (bound {MESH_GRAM_TOL}); "
        f"loss {loss.item():.6g}")
    if not (rel_img <= MESH_GRAM_TOL and rel_loss <= MESH_GRAM_TOL):
        fail("the sharded Gram step disagrees with the unsharded step")


MAGENTA_POOL = "/app/models/magenta_styles"  # generate_multimodel_presets' style paths


def apps_phase(dev, workdir: Path, src: Path) -> dict:
    """On the card with their default device: ``run_videos`` (``DEVICE``
    unset, the flow EMA) and ``drive_videos`` in queue mode with one worker
    on the 16-frame clip, every frame written and K1's launches exact; then
    ``generate_multimodel_presets`` and ``generate_preset_samples --limit
    2`` (the populated DB's style paths pointed at style images this phase
    writes: the DB names the gallery's, which the repo lacks). Returns the
    video runs' launches."""
    import sqlite3

    from PIL import Image

    from neuralstyletransferv1_torch.apps import (drive_videos, generate_multimodel_presets,
                                                  generate_preset_samples, run_videos)
    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.ops.dis_flow import _level_sizes
    from neuralstyletransferv1_torch.parallel.jobqueue import JobQueue

    ds = tpipe.effective_flow_downscale(1, H, W)  # run_videos' FLOW_DOWNSCALE default
    want_k1 = len(_level_sizes(H // ds, W // ds, 2)) * -(-APP_FRAMES // B)
    launches = {k: 0 for k in read_counts()}
    common = {"SCALE": W, "FPS": 24, "FLOW_EMA": 1, "PIPELINE_ARGS": APP_PIPELINE_ARGS}
    in_dir = workdir / "app_in"
    in_dir.mkdir(exist_ok=True)
    vid = in_dir / "clip.mp4"
    vid.write_bytes(src.read_bytes())
    runs = (
        ("run_videos", lambda: run_videos.main([str(vid)]),
         {"MODEL_A": CKPT, "MODEL_A_TYPE": "pytorch", "IO_PRESET": "raw_01",
          "OUT_DIR": workdir / "rv_out"},
         workdir / "rv_out" / "clip.mp4"),
        ("drive_videos (queue, one worker)", lambda: drive_videos.main([]),
         {"IN_DIR": in_dir, "OUT_DIR": workdir / "dv_out", "QUEUE_DIR": workdir / "queue",
          "QUEUE_ROLE": "both", "WORKER_ID": "smoke", "MODELS": f"pytorch:{CKPT}"},
         workdir / "dv_out" / "clip.mp4"),
    )
    for name, call, env, out in runs:
        restore = _env({**common, **env})
        zero_counts()
        t0 = time.perf_counter()
        try:
            rc = call()
        finally:
            restore()
        secs = time.perf_counter() - t0
        counts = read_counts()
        used = {k: v for k, v in counts.items() if v}
        got = clip_frame_count(out) if out.exists() else 0
        log(f"{name} on the card ({APP_FRAMES}-frame 1080p clip, '{APP_PIPELINE_ARGS}', flow "
            f"EMA): rc {rc}, {got} frames written, {secs:.2f} s; launches {used}, K1 expected "
            f"{want_k1}")
        if rc != 0 or got != APP_FRAMES or used != {"dis_iter": want_k1}:
            fail(f"{name} did not style the clip on the card with the expected launches")
        for k, v in counts.items():
            launches[k] += v
    q = JobQueue(workdir / "queue").counts()
    if q != {"pending": 0, "running": 0, "done": 1, "failed": 0}:
        fail(f"drive_videos left the queue at {q}")

    db = workdir / "presets.db"
    if generate_multimodel_presets.main(["--db", str(db)]) != 0:
        fail("generate_multimodel_presets failed")
    styles = workdir / "styles"
    styles.mkdir(exist_ok=True)
    with sqlite3.connect(str(db)) as conn:
        names = {Path(r[0]).name for r in conn.execute(
            "SELECT magenta_style FROM presets WHERE magenta_style IS NOT NULL UNION "
            "SELECT magenta_style_b FROM presets WHERE magenta_style_b IS NOT NULL UNION "
            "SELECT magenta_style_c FROM presets WHERE magenta_style_c IS NOT NULL UNION "
            "SELECT magenta_style_d FROM presets WHERE magenta_style_d IS NOT NULL")}
        for col in ("magenta_style", "magenta_style_b", "magenta_style_c", "magenta_style_d"):
            conn.execute(f"UPDATE presets SET {col} = replace({col}, ?, ?)",
                         (MAGENTA_POOL, str(styles)))
    for i, n in enumerate(sorted(names)):
        Image.fromarray(moving_frames(1, 256, 256, SEED + 70 + i)[0]).save(styles / n)
    img = workdir / "preset_in.png"
    Image.fromarray(moving_frames(1, H, W, SEED + 62)[0]).save(img)
    t0 = time.perf_counter()
    rc = generate_preset_samples.main(["--db", str(db), "--input_image", str(img), "--limit",
                                       "2", "--output_dir", str(workdir / "samples"),
                                       "--work_dir", str(workdir / "_samples")])
    secs = time.perf_counter() - t0
    outs = sorted(p.name for p in (workdir / "samples").glob("*.jpg"))
    log(f"generate_multimodel_presets, then generate_preset_samples --limit 2 on the card: rc "
        f"{rc}, {secs:.2f} s, wrote {outs}")
    if rc != 0 or len(outs) != 2:
        fail("generate_preset_samples did not render two presets on the card")
    return launches


def mesh_apps_phase(dev, workdir: Path) -> dict:
    """Phase 14: the mesh core, main() with --mesh_devices, the sharded Gram
    step and the queue and presets apps. Returns the launches of its runs
    on the main path."""
    t0 = time.perf_counter()
    launches = mesh_core_phase(dev)
    src = workdir / "app_clip.mp4"
    write_clip(src, moving_frames(APP_FRAMES, H, W, SEED + 63))
    mesh_main_phase(dev, workdir, src)
    mesh_gram_phase(dev)
    for k, v in apps_phase(dev, workdir, src).items():
        launches[k] += v
    log(f"phase 14 (mesh, sharded Gram step, queue and presets apps) took "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# phase 15: the threaded frame loader on the batched video path,
# --profile_dir and the last ten apps
LOADER_FRAMES = 64            # 1080p frames a format, decoded native vs PIL
LOADER_THREADS = 4
LOADER_CLI_FRAMES = 24        # the batched path's clip
LOADER_ARGS = ["--stream", "off", "--frame_batch", str(B), "--quantize", "int8_static",
               "--compute_dtype", "bfloat16", "--flow_ema"]
PROFILE_FRAMES = 16
MORPH_FRAMES = 72             # optical_flow_morph at 1080p on the card
MORPH_CMP = (270, 480, 12)    # card vs CPU: h, w, frames
MORPH_MEAN_TOL = 1.0          # grey levels, mean |Δ| card vs CPU
MORPH_SHARE = 0.99            # of the values within 1 level, card vs CPU
LOADER_ACTIVE = "[batch] native frame loader active"
LOADER_FALLBACK = "[batch] native frame loader unavailable"


class _Tee:
    """stdout that is also kept, so a run's printed lines can be checked."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def _printed(fn):
    """(fn(), what it printed)."""
    tee = _Tee(sys.stdout)
    old, sys.stdout = sys.stdout, tee
    try:
        out = fn()
    finally:
        sys.stdout = old
    return out, tee.text()


def loader_toolchain() -> dict:
    """g++, jpeglib.h and png.h on this machine: each one's path, None where
    it is missing (the headers looked up in the compiler's include dirs)."""
    import shutil

    from neuralstyletransferv1_torch.io import native_loader as nl

    found = {"g++": shutil.which(nl.CXX)}
    dirs = [Path("/usr/include"), Path("/usr/local/include"),
            *sorted(Path("/usr/include").glob("*-linux-gnu"))]
    if found["g++"]:
        res = subprocess.run([found["g++"], "-xc++", "-E", "-v", "-"], input="",
                             capture_output=True, text=True, timeout=60)
        lines = res.stderr.splitlines()
        if "#include <...> search starts here:" in lines:
            i = lines.index("#include <...> search starts here:") + 1
            while i < len(lines) and lines[i].startswith(" "):
                dirs.insert(0, Path(lines[i].strip()))
                i += 1
    for h in ("jpeglib.h", "png.h"):
        found[h] = next((str(d / h) for d in dirs if (d / h).exists()), None)
    return found


def _shared_libs(*names) -> list:
    """The system's shared libraries whose names start with ``names``
    (``ldconfig -p``), for the record."""
    try:
        out = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                             timeout=60).stdout
    except OSError:
        return []
    return sorted({line.split()[0] for line in out.splitlines()[1:]
                   if line.split() and line.split()[0].startswith(names)})


def _decode_frames(workdir: Path) -> dict:
    """64 synthesized 1080p frames written as PNG (compress level 1) and as
    JPEG (quality 90): {format: files}."""
    from PIL import Image

    frames = moving_frames(LOADER_FRAMES, H, W, SEED + 80)
    out = {}
    for fmt, save in (("png", dict(compress_level=1)), ("jpg", dict(quality=90))):
        d = workdir / f"loader_{fmt}"
        d.mkdir(exist_ok=True)
        out[fmt] = []
        for i, f in enumerate(frames):
            out[fmt].append(d / f"frame_{i + 1:04d}.{fmt}")
            Image.fromarray(f).save(out[fmt][-1], **save)
    return out


def loader_decode_phase(workdir: Path) -> bool:
    """The loader's build and decode on the card's host: with g++,
    jpeglib.h and png.h present the build must succeed (the compiler's last
    lines printed), 64 1080p PNG frames must decode equal to PIL's and 64
    JPEG frames within 1 level, and native (4 threads) vs serial PIL frames
    a second are printed. Returns whether the loader is available; a
    missing tool is printed and the engine's fallback is then held."""
    import numpy as np
    from PIL import Image

    from neuralstyletransferv1_torch.io import native_loader as nl

    from neuralstyletransferv1_torch.io import frames as tframes

    tools = loader_toolchain()
    log(f"loader toolchain on this host: {tools}; shared libraries "
        f"{_shared_libs('libjpeg', 'libpng')}")
    missing = [k for k, v in tools.items() if v is None]
    if missing:
        log(f"LOADER UNVERIFIED: {', '.join(missing)} missing on this host; the engine's PIL "
            f"fallback is held instead")
        try:
            nl.build()
        except nl.LoaderUnavailable as e:
            log(f"the loader's build, as expected, failed: {e}")
        else:
            fail("the loader built although the toolchain check found parts missing")
        for fmt, files in _decode_frames(workdir).items():
            t0 = time.perf_counter()
            got = [np.asarray(tframes.load_image_exif_rgb(str(p)), np.uint8) for p in files]
            secs = time.perf_counter() - t0
            same = all(np.array_equal(g, np.asarray(Image.open(p).convert("RGB")))
                       for g, p in zip(got, files))
            log(f"the fallback's reads, {fmt.upper()} {LOADER_FRAMES} × 1080p: serial PIL "
                f"{LOADER_FRAMES / secs:.1f} frames/s, equal to PIL's decode {same} [{CARD}]")
            if not same:
                fail(f"the engine's fallback decodes {fmt} frames unlike PIL")
        return False
    t0 = time.perf_counter()
    try:
        path, cxx_log = nl.build()
    except nl.LoaderUnavailable as e:
        fail(f"the frame loader did not build with g++: {e}")
    tail = "\n".join(cxx_log.splitlines()[-5:]) or "(g++ printed nothing)"
    log(f"built the frame loader with g++ in {time.perf_counter() - t0:.2f} s -> "
        f"{path.relative_to(ROOT)}; compiler output: {tail}")
    if not nl.available():
        fail("the frame loader built but does not load")
    for fmt, files in _decode_frames(workdir).items():
        t0 = time.perf_counter()
        with nl.NativeFrameLoader(files, threads=LOADER_THREADS, capacity=2 * B) as ld:
            native = list(ld)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        pil = [np.asarray(Image.open(p).convert("RGB")) for p in files]
        t_pil = time.perf_counter() - t0
        diff = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
                   for a, b in zip(native, pil))
        log(f"loader {fmt.upper()} {LOADER_FRAMES} × 1080p: native ({LOADER_THREADS} threads) "
            f"{LOADER_FRAMES / t_native:.1f} frames/s vs serial PIL {LOADER_FRAMES / t_pil:.1f} "
            f"frames/s, max |Δ| vs PIL {diff} [{CARD}]")
        if len(native) != LOADER_FRAMES or any(a.shape != (H, W, 3) for a in native):
            fail(f"the loader returned {len(native)} {fmt} frames of the wrong shape")
        if diff > (1 if fmt == "jpg" else 0):
            fail(f"the loader's {fmt} frames differ from PIL's by {diff} levels")
    return True


def timed_batched_main(argv) -> tuple:
    """``pipeline.main(argv)`` on the ``--stream off`` batched path with its
    wall split by part: extract (video → frame files), decode (the loader's
    ``next``, or PIL's reads on the fallback), stylize, flow and temporal
    (each call between two synchronizes), encode (the styled frames'
    writes and the assembly). Counts zeroed before. Returns (rc, seconds,
    split, printed)."""
    import torch

    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.engine import stylizer as tst
    from neuralstyletransferv1_torch.io import frames as tframes
    from neuralstyletransferv1_torch.io import native_loader as nl
    from neuralstyletransferv1_torch.temporal import ema as tema

    split = dict.fromkeys(("extract", "decode", "stylize", "flow", "temporal", "encode"), 0.0)

    def timed(key, fn, sync=False):
        def run(*a, **k):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*a, **k)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                split[key] += time.perf_counter() - t0
        return run

    jit_stylizer = tst.jit_stylizer
    patches = [
        (tframes, "extract_frames", timed("extract", tframes.extract_frames)),
        (nl.NativeFrameLoader, "__next__", timed("decode", nl.NativeFrameLoader.__next__)),
        (tframes, "load_image_exif_rgb", timed("decode", tframes.load_image_exif_rgb)),
        (tst, "jit_stylizer", lambda *a, **k: timed("stylize", jit_stylizer(*a, **k), True)),
        (tpipe, "flows_at_downscale", timed("flow", tpipe.flows_at_downscale, True)),
        (tema, "temporal_postprocess_split",
         timed("temporal", tema.temporal_postprocess_split, True)),
        (tpipe, "_save", timed("encode", tpipe._save)),
        (tframes, "assemble_video", timed("encode", tframes.assemble_video)),
    ]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, fn in patches:
        setattr(obj, attr, fn)
    zero_counts()
    t0 = time.perf_counter()
    try:
        rc, printed = _printed(lambda: tpipe.main([str(a) for a in argv]))
    finally:
        secs = time.perf_counter() - t0
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    return rc, secs, split, printed


def _without_loader(fn):
    """fn() with the loader made unavailable (an empty build directory and
    no compiler), then the loader as it was."""
    import tempfile as tf

    from neuralstyletransferv1_torch.io import native_loader as nl

    saved = {k: getattr(nl, k) for k in ("BUILD_DIR", "CXX", "_lib", "_error")}
    with tf.TemporaryDirectory() as empty:
        nl.BUILD_DIR, nl.CXX, nl._lib, nl._error = Path(empty), "no-such-g++", None, None
        try:
            return fn()
        finally:
            for k, v in saved.items():
                setattr(nl, k, v)


def loader_main_phase(dev, workdir: Path, have_loader: bool) -> dict:
    """``main()`` at 1080p on the batched frame-file path (``--stream off
    --frame_batch 8 --quantize int8_static``, bf16, flow EMA) over 24 JPEG
    frames: the loader's line (its fallback's where it is unavailable), the
    launches of K1–K4 exact and the wall split; then over 24 PNG frames with
    the loader and without it: the styled frames bit-identical. Returns the
    launches of the JPEG run."""
    import numpy as np
    from PIL import Image

    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.ops.dis_flow import _level_sizes

    src = workdir / "loader_clip.mp4"
    write_clip(src, moving_frames(LOADER_CLI_FRAMES, H, W, SEED + 81))
    ds = tpipe.effective_flow_downscale(0, H, W)
    batches = -(-LOADER_CLI_FRAMES // B)
    want = {"dis_iter": len(_level_sizes(H // ds, W // ds, 2)) * batches,
            **{k: v * batches for k, v in PER_BATCH[("int8_static", None)].items()}}

    def run(tag, ext, check_line=True):
        wd = workdir / f"_loader_{tag}"
        argv = ["--input_video", src, "--output_video", workdir / f"loader_{tag}.mp4",
                "--model", CKPT, "--image_ext", ext, "--work_dir", wd, *LOADER_ARGS]
        rc, secs, split, printed = timed_batched_main(argv)
        used = {k: v for k, v in read_counts().items() if v}
        styled = sorted((wd / "frames").glob(f"styled_frame_*.{ext}"))
        got = clip_frame_count(workdir / f"loader_{tag}.mp4")
        line = LOADER_ACTIVE if have_loader and check_line else LOADER_FALLBACK
        log(f"main() --stream off on {LOADER_CLI_FRAMES} {ext.upper()} 1080p frames "
            f"({' '.join(LOADER_ARGS)}) [{tag}]: rc {rc}, {len(styled)} styled, {got} encoded, "
            f"{_split_text(secs, split)}; launches {used}, expected {want}; '{line}' printed: "
            f"{line in printed} [{CARD}]")
        if rc != 0 or len(styled) != LOADER_CLI_FRAMES or got != LOADER_CLI_FRAMES:
            fail(f"the batched path [{tag}] did not style and encode every frame")
        if used != want:
            fail(f"the batched path's launches {used} are not the expected {want}")
        if line not in printed or (line == LOADER_ACTIVE and LOADER_FALLBACK in printed):
            fail(f"the batched path [{tag}] did not print '{line}' (alone)")
        return used, styled

    used, _ = run("jpeg", "jpg")
    _, with_loader = run("png", "png")
    _, without = _without_loader(lambda: run("png_pil", "png", check_line=False))
    same = all(np.array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
               for a, b in zip(with_loader, without))
    log(f"PNG frames with the loader vs without it (PIL on the engine's thread): styled frames "
        f"bit-identical {same}")
    if not same:
        fail("the styled PNG frames differ with and without the loader")
    return used


def profile_dir_phase(workdir: Path) -> None:
    """``main(--profile_dir)`` on a 16-frame 1080p clip: the trace file and
    the JAX engine's printed line."""
    from neuralstyletransferv1_torch.engine import pipeline as tpipe

    src, prof = workdir / "profile_clip.mp4", workdir / "profile_dir"
    write_clip(src, moving_frames(PROFILE_FRAMES, H, W, SEED + 82))
    t0 = time.perf_counter()
    rc, printed = _printed(lambda: tpipe.main([
        "--input_video", str(src), "--output_video", str(workdir / "profile_out.mp4"),
        "--model", str(CKPT), "--frame_batch", str(B), "--compute_dtype", "bfloat16",
        "--profile_dir", str(prof), "--work_dir", str(workdir / "_profile")]))
    traces = sorted(prof.glob("*.pt.trace.json"))
    size = sum(t.stat().st_size for t in traces)
    log(f"main() --profile_dir on a {PROFILE_FRAMES}-frame 1080p clip: rc {rc}, "
        f"{time.perf_counter() - t0:.2f} s, {len(traces)} trace file(s), {size / 2**20:.1f} MiB")
    if rc != 0 or not traces or f"[profile] trace written to {prof}" not in printed:
        fail("--profile_dir wrote no trace")


def morph_phase(dev) -> float:
    """``optical_flow_morph`` of two 1080p images, 72 frames, on the card
    (a first call, then one timed), and card vs CPU at 270×480 over 12
    frames. Returns the timed call's ms."""
    import numpy as np
    import torch
    from PIL import Image

    from neuralstyletransferv1_torch.apps.morph import optical_flow_morph

    a, b = moving_frames(12, H, W, SEED + 83)[::11]
    optical_flow_morph(a, b, MORPH_FRAMES, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = optical_flow_morph(a, b, MORPH_FRAMES, device=dev)
    ms = (time.perf_counter() - t0) * 1e3
    log(f"optical_flow_morph 1080p, {MORPH_FRAMES} frames on the card: {ms:.1f} ms "
        f"(flows, render and the copy back) [{CARD}]")
    if len(frames) != MORPH_FRAMES or frames[0].shape != (H, W, 3):
        fail("optical_flow_morph returned the wrong frames")
    h, w, n = MORPH_CMP
    sa, sb = (np.asarray(Image.fromarray(x).resize((w, h), Image.BILINEAR)) for x in (a, b))
    got = np.stack(optical_flow_morph(sa, sb, n, device=dev)).astype(np.int16)
    want = np.stack(optical_flow_morph(sa, sb, n, device="cpu")).astype(np.int16)
    d = np.abs(got - want)
    log(f"optical_flow_morph card vs CPU at {h}×{w}, {n} frames: mean |Δ| {d.mean():.4f} "
        f"levels, within 1 level {(d <= 1).mean():.5f}, max {d.max()}")
    if d.mean() > MORPH_MEAN_TOL or (d <= 1).mean() < MORPH_SHARE:
        fail("optical_flow_morph on the card disagrees with the CPU")
    return ms


def morph_apps_phase(dev, workdir: Path) -> None:
    """Each of the ten apps' CLI once on the card with its default device,
    on small inputs: each must exit 0 and write its outputs. The DeepLab
    apps take a seeded full-width MobileNetV2, ``morph_faces`` and
    ``gen_pytorch_only_videos --face_mode`` manual faces, ``morph_v2
    --face`` the seeded SSD (``write_ssd``; without a detection it takes
    DeepLab's region)."""
    import json as js

    import cv2
    from PIL import Image

    from neuralstyletransferv1_torch.apps import (cryptic_text, gen_pytorch_only_videos,
                                                  generate_mask_samples,
                                                  generate_style_selfstyle, morph, morph_faces,
                                                  morph_slideshow, morph_v2, style_mask,
                                                  style_showcase)

    d = workdir / "apps15"
    d.mkdir(exist_ok=True)
    stills = moving_frames(3, 256, 384, SEED + 84)
    imgs = []
    for i, f in enumerate(stills):
        imgs.append(d / f"img{i}.png")
        Image.fromarray(f).save(imgs[-1])
    dl = deeplab_checkpoint(d / "deeplab-mobilenet.pth.tar", "mobilenet")
    proto, caffemodel, _ = write_ssd(d / "ssd", SEED + 85)
    for sub in ("in_dir", "pytorch"):
        (d / sub).mkdir(exist_ok=True)
    (d / "in_dir" / "bike-dog-person.png").write_bytes(imgs[0].read_bytes())
    (d / "pytorch" / "alpha.pth").write_bytes(CKPT.read_bytes())
    (d / "pytorch" / "beta.pth").write_bytes(CKPT.read_bytes())
    write_clip(d / "text_in.mp4", moving_frames(12, 240, 320, SEED + 86))
    samples = d / "samples.json"
    samples.write_text(js.dumps([{"input_prefix": "bike-dog-person", "target_ids": "15,0",
                                  "invert": False, "name": "styled"}]))
    runs = (
        ("morph", lambda: morph.main(["--images", *map(str, imgs[:2]), "--output",
                                      str(d / "morph.mp4"), "--morph_frames", "8",
                                      "--hold_frames", "2", "--size", "384"]),
         [d / "morph.mp4"]),
        ("morph_faces", lambda: morph_faces.main([
            "--image", str(imgs[1]), "--output_dir", str(d / "faces"), "--manual_faces",
            "40,40,100,100;200,60,90,90", "--tiles", "64", "--fps", "6", "--morph_time", "0.5",
            "--transition", "0.5", "--scale", "256"]),
         [d / "faces" / "img1" / "img1_faces_zoom.mp4", d / "faces" / "img1" /
          "img1_faces_zoom_run.json"]),
        ("morph_v2", lambda: morph_v2.main([
            "--image", str(imgs[2]), "--output", str(d / "v2.mp4"), "--deeplab_weights",
            str(dl), "--face", "--detector_prototxt", str(proto), "--detector_model",
            str(caffemodel), "--crop_size", "256", "--morph_frames", "6", "--pytorch_model",
            str(CKPT), "--pytorch_blends", "0,60", "--io_preset", "raw_01", "--pan_zoom",
            "1.5"]),
         [d / "v2.mp4"]),
        ("morph_slideshow", lambda: morph_slideshow.main([
            "--in_dir", str(d / "in_dir"), "--out_dir", str(d / "slides"), "--work_root",
            str(d / "_slides"), "--models", f"a:{CKPT}", f"b:{CKPT}", "--io_preset", "raw_01",
            "--scale", "384", "--fps", "6", "--hold_model", "0.5", "--trans", "0.5"]),
         [d / "slides" / "bike-dog-person_morph.mp4"]),
        ("gen_pytorch_only_videos", lambda: gen_pytorch_only_videos.main([
            "--image", str(imgs[0]), "--models", str(CKPT), str(CKPT), "--output",
            str(d / "gpov.mp4"), "--io_preset", "raw_01", "--size", "384",
            "--transition_frames", "6", "--hold_frames", "2"]),
         [d / "gpov.mp4"]),
        ("generate_style_selfstyle", lambda: generate_style_selfstyle.main([
            "--input_dir", str(d / "in_dir"), "--output_dir", str(d / "selfstyle"), "--tile",
            "128", "--overlap", "16", "--db", str(d / "selfstyle.db")]),
         [d / "selfstyle" / "bike-dog-person_selfstyle.jpg"]),
        ("style_mask", lambda: style_mask.main([
            "--images", str(imgs[0]), "--output", str(d / "mask.mp4"), "--deeplab_weights",
            str(dl), "--target_labels", "person,background", "--fg_model", str(CKPT),
            "--io_preset", "raw_01", "--size", "384", "--hold_secs", "0.5", "--fade_secs",
            "0.25", "--fps", "6"]),
         [d / "mask.mp4"]),
        ("generate_mask_samples", lambda: generate_mask_samples.main([
            "--input_dir", str(d / "in_dir"), "--output_dir", str(d / "mask_samples"),
            "--work_dir", str(d / "_mask_samples"), "--deeplab_weights", str(dl),
            "--model", str(CKPT), "--io_preset", "raw_01", "--samples_json", str(samples),
            "--scale", "384"]),
         [d / "mask_samples" / "styled_comparison.jpg"]),
        ("style_showcase", lambda: _env_call(style_showcase.main, {
            "IN_DIR": d / "in_dir", "OUT_DIR": d / "showcase", "PYTORCH_DIR": d / "pytorch",
            "TORCH_DIR": d / "none", "SCALE": 384, "FPS": 6, "MOTION": "ken_burns",
            "HOLD_MODEL": 0.5, "HOLD_ORIG_START": 0.5, "HOLD_ORIG_END": 0.5, "TRANS": 0.25,
            "IO_PRESET": "raw_01"}),
         [d / "showcase" / "bike-dog-person_showcase.mp4"]),
        ("cryptic_text", lambda: cryptic_text.main([
            "--input", str(d / "text_in.mp4"), "--output", str(d / "text.mp4"), "--phrases",
            "HELLO,WORLD", "--seed", "7", "--distortion", "ripple",
            "--texture_dir", str(d / "none")]),
         [d / "text.mp4"]),
    )
    for name, call, outs in runs:
        zero_counts()
        t0 = time.perf_counter()
        rc = call()
        secs = time.perf_counter() - t0
        used = {k: v for k, v in read_counts().items() if v}
        frames = [clip_frame_count(o) for o in outs if o.suffix == ".mp4" and o.exists()]
        log(f"{name} on the card: rc {rc}, {secs:.2f} s, outputs "
            f"{[o.name for o in outs if o.exists()]}, video frames {frames}")
        if rc != 0 or not all(o.exists() for o in outs) or not all(frames):
            fail(f"{name} did not write its outputs on the card")
        if used:
            fail(f"{name} launched {used}: no kernel of K1–K13 is on its path")
    del cv2


def _env_call(fn, env: dict):
    """fn([]) with ``env`` set (``DEVICE`` unset: the app's default)."""
    import os

    restore = _env(env)
    device = os.environ.pop("DEVICE", None)
    try:
        return fn([])
    finally:
        restore()
        if device is not None:
            os.environ["DEVICE"] = device


def loader_apps_phase(dev, workdir: Path) -> dict:
    """Phase 15: the frame loader (build, decode, the batched path on it),
    ``--profile_dir``, ``optical_flow_morph`` and the ten apps. Returns the
    launches of its run on the main path."""
    t0 = time.perf_counter()
    native_so = ROOT / "native" / "_frameloader.so"
    before = native_so.stat().st_mtime_ns if native_so.exists() else None
    have_loader = loader_decode_phase(workdir)
    launches = loader_main_phase(dev, workdir, have_loader)
    profile_dir_phase(workdir)
    morph_phase(dev)
    morph_apps_phase(dev, workdir)
    after = native_so.stat().st_mtime_ns if native_so.exists() else None
    if after != before:
        fail("native/_frameloader.so was written: the port builds its own loader in _build/")
    log(f"phase 15 (frame loader, --profile_dir, morph and the ten apps) took "
        f"{time.perf_counter() - t0:.1f} s")
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


NST_CROP = (256, 480)  # the new forms' chains card vs CPU: the res grid 84 × 140 (sw 140)


CHAIN_REL_TOL = 0.05  # measured-norm chains card vs CPU: mean |Δ| / mean |CPU| (JAX's bound)


def _chains_card_vs_cpu(dev, label: str, chains: dict, inputs) -> None:
    """Each chain of ``chains`` (name → (fn(d), the launches it must make on
    the card, whether every norm is static)) on the card and on the CPU,
    finite, with exact launch counts: bit-identical where every quantize
    affine is a constant (frozen or no norms); with measured norms the
    statistics come from the sites' sums, which the card adds in another
    order (f32 tiles, then double) than the plain versions (double), so a
    code can flip at a rounding boundary: there within CHAIN_REL_TOL of the
    output's mean magnitude (tests/test_int8.py's bound between the Pallas
    res chain and its XLA reference, whose sums also differ in order).
    ``inputs(d)`` builds a device's operands once."""
    import torch

    ops = {d.type: inputs(d) for d in (dev, torch.device("cpu"))}
    for name, (fn, want, static) in chains.items():
        outs = []
        for d in (dev, torch.device("cpu")):
            zero_counts()
            with torch.no_grad():
                out = fn(ops[d.type])
            if d.type == "cuda":
                torch.cuda.synchronize()
                used = {k: v for k, v in read_counts().items() if v}
                if used != want:
                    fail(f"{label} {name} launched {used}, not {want}")
            outs.append(out.cpu())
        same = torch.equal(*outs)
        rel = float((outs[0].float() - outs[1].float()).abs().mean()
                    / outs[1].float().abs().mean().clamp(min=1e-12))
        log(f"{label} {name} (launches {want}), card vs CPU: "
            f"{'bit-identical' if same else f'mean |d| / mean |CPU| {rel:.3e}'}, output "
            f"{tuple(outs[0].shape)}")
        if not (same if static else rel <= CHAIN_REL_TOL):
            fail(f"{label} {name} differs between the card and the CPU")
        if not bool(torch.isfinite(outs[0].float()).all()):
            fail(f"{label} {name}: the output is not finite")


def nst_forms_phase(dev, ckpt: Path) -> None:
    """The NST_Train chains of the new kernel forms on the card and on the
    CPU from one calibration and one forward's inputs on a 256×480 crop of
    a 1080p frame (conv2's block grid 168 × 280, the res grid 84 × 140, sw
    140 on the padded 144): ``c2_i8`` (one K4 2×2 pad 1), ``res_i8`` (6 × K4
    + 4 × K5 with sw), ``dec_i8`` (2 × K4 2×2 pad 0), each with frozen norms
    (bit-identical) and measured ones, and ``dec_s8`` through the fused tail
    after the s8 chain's emit (5 × K2 + 5 × K3, 2 × K3 2×2 pad 0, K6;
    bit-identical); exact launches (``_chains_card_vs_cpu``)."""
    import copy

    import torch

    from neuralstyletransferv1_torch.engine import stylizer as st
    from neuralstyletransferv1_torch.models import transformer_net_nst_fast as nstf

    ch, cw = NST_CROP
    model = st.load_model(ckpt, device=dev)
    x = torch.from_numpy(moving_frames(1, H, W, SEED + 13)[0][None, :ch, :cw]).to(dev)
    x = x.float() / 255.0
    stats = nstf.calibrate_in_stats(model.net, x)
    quant = nstf.quantize_net(model.net, nstf.calibrate_act_scales(model.net, x,
                                                                    static_stats=stats))
    nb = copy.deepcopy(model.net).to(torch.bfloat16)
    grab = {}
    with torch.no_grad():
        nstf.apply(nb, x.to(torch.bfloat16), tap=lambda k, t: grab.setdefault(k, t.contiguous()))

    def inputs(d):
        net = copy.deepcopy(nb).to(d)
        return {"net": net, "sites": nstf.prepare_sites(net, quant, d),
                "st": {k: (m.to(d), inv.to(d)) for k, (m, inv) in stats.items()},
                **{k: grab[k].to(d) for k in ("c2", "r1a", "d1")}}

    def s8_tail(o):
        xq = nstf.res_chain_s8_static(o["r1a"], o["net"], o["sites"], o["st"],
                                      emit_qo=o["sites"]["d1"].qin)
        return nstf.dec_s8_static(xq, o["net"], o["sites"], o["st"], o["r1a"].shape[2],
                                  torch.bfloat16, tail=True)

    chains = {"dec_s8 + tail_s8": (s8_tail, {"res_site_s8o": 5, "site_s8": 5,
                                             "site_s8_k2p0": 2, "d3_s8_site": 1}, True)}
    for static in (True, False):
        norms = "frozen" if static else "measured"

        def st(o, static=static):
            return o["st"] if static else None

        chains.update({
            f"c2_i8 ({norms} norms)": (lambda o, st=st: nstf.c2_i8(o["c2"], o["net"],
                                                                   o["sites"]["c2"], st(o)),
                                       {"res_site_k2p1": 1}, static),
            f"res_i8 ({norms} norms)": (lambda o, st=st: nstf.res_chain_i8(
                o["r1a"], o["net"], o["sites"], st(o)), NST_RES_I8, static),
            f"dec_i8 ({norms} norms)": (lambda o, st=st: nstf.dec_i8(o["d1"], o["net"],
                                                                     o["sites"], st(o)),
                                        {"res_site_k2p0": 2}, static)})
    _chains_card_vs_cpu(dev, "NST", chains, inputs)


def t7_forms_phase(dev, ckpts: dict) -> None:
    """The Torch7 ``c2_i8`` and ``dec_i8`` branches on the card and on the
    CPU, on the IN graph (k3 deconvs: 2 × K4 2×2 pad 0; its norms measured)
    and the BN graph with k4 deconvs (2 × K4 3×3, CO 256 and 128, zero halo;
    bit-identical); and the s8 carries on the BN graphs with k3 and with k4
    deconvs (bit-identical: every scale is static): ``res_s8`` (5 × K2 + 5 ×
    K3), with ``dec_s8`` (its last K3 emitting deconv1's codes, then 2 × K3:
    2×2 pad 0 for k3, 3×3 for k4) and with ``tail_s8`` (d2's ``zero2`` emit
    into K6); from one forward's inputs on a 256×480 crop of a 1080p frame
    and one calibration, exact launches (``_chains_card_vs_cpu``)."""
    import torch

    from neuralstyletransferv1_torch.engine import stylizer as st
    from neuralstyletransferv1_torch.io import t7_fast as tf
    from neuralstyletransferv1_torch.models import io_presets as iop

    ch, cw = NST_CROP
    for norm in (n for n in ("in", "bn", "bn k4") if n in ckpts):
        model = st.load_model(ckpts[norm], device=dev)
        p32 = tf.params_to(tf.try_fast_johnson(model.net), dev)
        x = torch.from_numpy(moving_frames(1, H, W, SEED + 14)[0][None, :ch, :cw]).to(dev)
        xin = iop.preprocess(model.io_preset, x.float() / 255.0)
        quant = tf.quantize_t7(p32, tf.calibrate_t7_scales(p32, xin))
        grab = {}
        with torch.no_grad():
            tf.t7_fast_apply(tf.params_to(p32, dev, torch.bfloat16), xin.to(torch.bfloat16),
                             tap=lambda k, t: grab.setdefault(k, t.contiguous()))

        def inputs(d):
            p = tf.params_to(p32, d, torch.bfloat16)
            return {"p": p, "sites": tf.prepare_sites(p, quant, d),
                    **{k: grab[k].to(d) for k in ("c2", "d1", "r0a")}}

        static = norm != "in"
        chains = {}
        if norm != "bn":
            dec = {"res_site_k2p0": 2} if norm == "in" else {"res_site": 2}
            chains = {
                "c2_i8": (lambda o: tf._t7_c2_i8(o["c2"], o["p"], o["sites"]["c2"]),
                          {"res_site_k2p1": 1}, static),
                "dec_i8": (lambda o: tf._t7_dec_i8(o["d1"], o["p"], o["sites"], o["p"]["c0"]),
                           dec, static)}
        if norm != "in":
            chains.update(t7_s8_chains(tf, deconv_k=4 if norm.endswith("k4") else 3))
        _chains_card_vs_cpu(dev, f"t7 {norm}", chains, inputs)


def t7_s8_chains(tf, deconv_k: int) -> dict:
    """``t7_forms_phase``'s s8-carry chains of a BN graph: name → (fn, the
    launches, static). The chain's input is the res blocks' (``r0a``)."""
    import torch

    dec = {"site_s8_k2p0": 2} if deconv_k == 3 else {"site_s8": 2}
    res = dict(T7_S8_RES)
    dec_want = {k: res.get(k, 0) + dec.get(k, 0) for k in (*res, *dec)}

    def run(o, dec_s8=False, tail=False):
        if not dec_s8:
            return tf._t7_res_chain_i8_s8c(o["r0a"], o["p"]["res"], o["sites"])
        xq = tf._t7_res_chain_i8_s8c(o["r0a"], o["p"]["res"], o["sites"],
                                     emit_qo=o["sites"]["d1"].qin)
        return tf._t7_dec_i8_s8(xq, o["p"], o["sites"], torch.bfloat16, tail=tail)

    return {"res_s8": (run, res, True),
            "res_s8 + dec_s8": (lambda o: run(o, True), dec_want, True),
            "res_s8 + dec_s8 + tail_s8": (lambda o: run(o, True, True),
                                          {**dec_want, "d3_s8_site": 1}, True)}


def f32_chains_phase(dev, workdir: Path) -> None:
    """The float32 chains of the new f32 forms on the card and on the CPU,
    from one f32 forward's inputs on a 256×480 crop of a 1080p frame and one
    calibration, with exact launches (``_chains_card_vs_cpu``): NST_Train's
    ``c2_i8`` (K4 2×2 pad 1 on conv1's f32 output) and ``dec_i8`` (K4 2×2
    pad 0 on the f32 res output, then its bf16 d2), frozen norms
    (bit-identical) and measured; an IN Torch7 net's ``c2_i8`` and
    ``dec_i8`` (measured norms); ReCoNet's ``dec_s8`` on the f32 res output
    (K2 at CO = 384, then K3 at C = 96; IN and FRN, frozen norms,
    bit-identical); Johnson's ``head_i8`` chain under frozen norms (K8a on
    conv1's f32 output, K8b; bit-identical), its ``tail`` (K9a on an f32
    deconv1 raw, K9b) and ``d3`` (K9e on an f32 d2 raw), whose K9 sums and
    bf16 outputs the card forms in another order (within the chains'
    bound)."""
    import copy

    import torch

    from neuralstyletransferv1_torch.engine import stylizer as st
    from neuralstyletransferv1_torch.io import t7_fast as tf
    from neuralstyletransferv1_torch.models import io_presets as iop
    from neuralstyletransferv1_torch.models import reconet_fast as rf
    from neuralstyletransferv1_torch.models import sites_bf16, sites_i8
    from neuralstyletransferv1_torch.models import transformer_net_nst_fast as nstf
    from neuralstyletransferv1_torch.models import transformer_net_quant as tq
    from neuralstyletransferv1_torch.models.s2d import d2s, in_stats

    ch, cw = NST_CROP
    frame = torch.from_numpy(moving_frames(1, H, W, SEED + 17)[0][None, :ch, :cw]).to(dev)
    x01 = frame.float() / 255.0
    grab = {}

    def tap(k, t):
        grab.setdefault(k, t.contiguous())

    # NST_Train: f32 net, frozen and measured norms
    model = st.load_model(nst_checkpoint(workdir / "nst_f32.pth"), device=dev)
    stats = nstf.calibrate_in_stats(model.net, x01)
    quant = nstf.quantize_net(model.net, nstf.calibrate_act_scales(model.net, x01,
                                                                    static_stats=stats))
    with torch.no_grad():
        nstf.apply(model.net, x01, tap=tap)
    nst_in = {k: grab.pop(k) for k in ("c2", "d1")}

    def nst_inputs(d):
        net = copy.deepcopy(model.net).to(d)
        return {"net": net, "sites": nstf.prepare_sites(net, quant, d),
                "st": {k: (m.to(d), inv.to(d)) for k, (m, inv) in stats.items()},
                **{k: v.to(d) for k, v in nst_in.items()}}

    chains = {}
    for static in (True, False):
        norms = "frozen" if static else "measured"

        def sts(o, static=static):
            return o["st"] if static else None

        chains.update({
            f"c2_i8 f32 ({norms} norms)": (
                lambda o, sts=sts: nstf.c2_i8(o["c2"], o["net"], o["sites"]["c2"], sts(o)),
                {"res_site_k2p1_f32": 1}, static),
            f"dec_i8 f32 ({norms} norms)": (
                lambda o, sts=sts: nstf.dec_i8(o["d1"], o["net"], o["sites"], sts(o)),
                {"res_site_k2p0_f32": 1, "res_site_k2p0": 1}, static)})
    _chains_card_vs_cpu(dev, "NST", chains, nst_inputs)

    # Torch7: an IN net (k3 deconvs), f32 params, measured norms
    model = st.load_model(t7_checkpoint(workdir / "eccv16_in_f32.t7", "in"), device=dev)
    p32 = tf.params_to(tf.try_fast_johnson(model.net), dev)
    xin = iop.preprocess(model.io_preset, x01)
    tquant = tf.quantize_t7(p32, tf.calibrate_t7_scales(p32, xin))
    with torch.no_grad():
        tf.t7_fast_apply(p32, xin, tap=tap)
    t7_in = {k: grab.pop(k) for k in ("c2", "d1")}
    grab.clear()

    def t7_inputs(d):
        p = tf.params_to(p32, d)
        return {"p": p, "sites": tf.prepare_sites(p, tquant, d),
                **{k: v.to(d) for k, v in t7_in.items()}}

    _chains_card_vs_cpu(dev, "t7 in", {
        "c2_i8 f32": (lambda o: tf._t7_c2_i8(o["c2"], o["p"], o["sites"]["c2"]),
                      {"res_site_k2p1_f32": 1}, False),
        "dec_i8 f32": (lambda o: tf._t7_dec_i8(o["d1"], o["p"], o["sites"], o["p"]["c0"]),
                       {"res_site_k2p0_f32": 1, "res_site_k2p0": 1}, False)}, t7_inputs)

    # ReCoNet: IN and FRN, frozen norms, dec_s8 on the f32 res output
    rh, rw = RECO_CROP
    for frn in (False, True):
        model = st.load_model(reco_checkpoint(workdir / f"reco_f32_{frn}.pth", frn),
                              model_type="reconet", device=dev)
        x = iop.preprocess(model.io_preset, frame[:, :rh, :rw].float() / 255.0)
        fp32 = rf.FastReCoNet(model.net)
        rstats = rf.calibrate_in_stats(fp32, x)
        rquant = rf.quantize_net(fp32, rf.calibrate_act_scales(fp32, x, static_stats=rstats))
        with torch.no_grad():
            rf.apply(fp32, x, tap=tap, static_stats=rstats)
        yd1 = grab.pop("d1")
        grab.clear()

        def reco_inputs(d, fp32=fp32, rstats=rstats, rquant=rquant, yd1=yd1):
            fpd = copy.deepcopy(fp32).to(d)
            return {"fp": fpd, "sites": rf.prepare_sites(fpd, rquant, d), "y": yd1.to(d),
                    "st": {k: (m.to(d), inv.to(d)) for k, (m, inv) in rstats.items()}}

        _chains_card_vs_cpu(dev, f"ReCoNet {'FRN' if frn else 'IN'}", {
            "dec_s8 f32": (lambda o: rf.dec_s8_static(o["y"], o["fp"], o["sites"], o["st"]),
                           {"res_site_s8o_co384_f32": 1, "site_s8_c96": 1}, True)}, reco_inputs)

    # Johnson: the head_i8 chain (frozen norms), the tail and d3 sites
    model = st.load_model(CKPT, io_preset="raw_01", device=dev)
    net = model.net
    jstats = tq.calibrate_in_stats(net, x01)
    jquant = tq.quantize_net(net, tq.calibrate_act_scales(net, x01, static_stats=jstats))
    with torch.no_grad():
        y1 = net.conv1(x01).contiguous()
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    raw_d1 = torch.randn((1, ch // 2, cw // 2, 64), generator=g, device=dev) * 1.5
    raw_d2 = torch.randn((1, ch // 2, cw // 2, 128), generator=g, device=dev) * 1.5

    def j_inputs(d):
        netd = copy.deepcopy(net).to(d)
        return {"net": netd, "sites": sites_i8.prepare_sites(netd, jquant, d),
                "sw": sites_bf16.prepare(netd, d, torch.float32), "y1": y1.to(d),
                "st": {k: (m.to(d), inv.to(d)) for k, (m, inv) in jstats.items()},
                "d1": raw_d1.to(d), "d2": raw_d2.to(d)}

    def head(o):
        m1, inv1 = o["st"]["in1"]
        return sites_i8.head_chain(o["y1"], m1, inv1, o["net"], o["sites"], o["st"])[0]

    _chains_card_vs_cpu(dev, "Johnson", {
        "head_i8 f32 (frozen norms)": (head, {"c2_site_f32": 1, "c3_site": 1}, True),
        "tail f32": (lambda o: sites_bf16.tail(o["d1"], *in_stats(o["d1"]), o["net"], o["sw"]),
                     {"d2_site_f32": 1, "d3_sum_site": 1}, False),
        "d3 f32": (lambda o: sites_bf16.d3_branch(o["d2"], *in_stats(d2s(o["d2"], 2, 32)),
                                                  o["net"], o["sw"]), {"d3_rows_f32": 1}, False)},
        j_inputs)


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
    bit-identical; the same for bench.py's ``s8_sites`` set (the s8 res chain,
    then ``dec_s8``: K2 at CO = 384 and K3 at C = 96), with exact launches;
    then ``--quantize int8`` on one 1080p batch through
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

        def inputs(d, fpb=fpb, stats=stats, quant=quant, y=grab["y"]):
            fpd = copy.deepcopy(fpb).to(d)
            st_d = {k: (m.to(d), inv.to(d)) for k, (m, inv) in stats.items()}
            return {"fp": fpd, "st": st_d, "sites": rf.prepare_sites(fpd, quant, d), "y": y.to(d)}

        def s8_sites(o):
            yr = rf.res_chain_s8_static(o["y"], o["fp"], o["sites"], o["st"])
            return rf.dec_s8_static(yr, o["fp"], o["sites"], o["st"])

        _chains_card_vs_cpu(dev, f"ReCoNet {label}", {
            "s8_sites (s8 res chain + dec_s8)": (s8_sites, RECO_S8_PER_BATCH, True)}, inputs)

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
    to a ``.t7`` file; ``norm`` "bn k4": the BN graph with k4 deconvs."""
    return write_t7(path, t7_net_layers(SEED, norm.split()[0],
                                        deconv_k=4 if norm.endswith("k4") else 3))


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
    want = {k: v * batches for k, v in T7_PER_BATCH[("in", "int8", None)].items()}
    got = clip_frame_count(dst)
    log(f"main() on a .t7 slot (IN) --quantize int8 on a {n}-frame 1080p mp4: rc {rc}, {got} "
        f"frames written, {secs:.2f} s, launches {used}")
    if rc != 0 or got != n or {k: used.get(k, 0) for k in want} != want or \
            not used.get("dis_iter"):
        fail(f"main() did not style the clip with the .t7 slot as expected ({want})")
    return used


def t7_net_layers(seed: int, norm: str, c0: int = 32, nres: int = 5, deconv_k: int = 3) -> list:
    """The eccv16 Johnson topology as a layer list (the dicts of
    ``io/t7.build_t7_layers``): conv 9×9 3→c0, 3×3 s2 c0→2c0, 3×3 s2
    2c0→4c0, ``nres`` residual blocks at 4c0 (zero pad 1), transposed convs
    4c0→2c0→c0 (``deconv_k`` 3: s2 pad 1 adj 1; 4: s2 pad 1 adj 0), conv
    9×9 c0→3, Tanh, MulConstant(150);
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
        k = deconv_k
        return {"op": "conv_transpose", "w": rng.normal(0, 2.0 / np.sqrt(9 * ci), (k, k, co, ci))
                .astype(np.float32), "b": rng.normal(0, 0.05, co).astype(np.float32),
                "stride": 2, "pad": 1, "adj": 1 if k == 3 else 0}

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
MMA_GEOS = {"0": "", "1": ", 2x2 taps pad 1", "2": ", 2x2 taps pad 0"}  # mma_kernel's GEO


def ptxas_report(text: str, k1, k8, k9, k12) -> None:
    """ptxas' registers and spills of every kernel entry of one build log,
    and the dynamic shared memory of the tensor-core cores' instantiations
    (mma_kernel<C, prologue, epilogue, tau, zero, f32, geo>: <C, 0, 0> is K4,
    <C, 2, 2> K3, <C, 0, 1> K2, <192, 0, 3> K2's floored emit, <C, 1, 0> K5,
    <192, 3, 0> K5 with the post-add activation, <128, 4, 0> K4's cast form,
    <128, 0, 4> its no-statistics form; tau 1: K4 with the TLU floor; zero 1:
    K2, K4 or K5 under the zero halo; f32 1: the f32-operand form of K2-K5;
    geo 1, 2: K4's 2×2 taps at pad 1, K4's and K3's at pad 0;
    mma_s2_kernel<C, MCO> is K8a at C = 32, K8b at 64;
    site_wgmma_kernel<C, prologue, epilogue, tau> K4 (<C, 0, 0>) and K3
    (<C, 2, 2>) at C = 192 and 96 (the wgmma core);
    d3s8_mma_kernel K6 and d3rows_mma_kernel K7 (<1>: its f32-input form;
    rows_kernel<2, 2>, <0, 1> their previous cores); d3sum_mma_kernel K9b and d3rows_wgmma_kernel K9e
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
                short += f" ({MMA_FORMS[targs[1], targs[2]]}{MMA_GEOS[targs[6]]}"
                short += ", f32 operand)" if targs[5:6] == ["1"] else ")"
                smem = k8._lib().mma_kernel_smem_bytes(int(targs[0]))
            elif base == "mma_s2_kernel":
                short += " (K8a)" if targs[0] == "32" else " (K8b)"
                if targs[2:3] == ["1"]:  # K8a's f32 form: its staging slot is twice the size
                    short += ", f32 operand"
                else:
                    smem = k8._lib().mma_s2_smem_bytes(int(targs[0]))
            elif base == "d3s8_mma_kernel":
                short += " (K6)"
                smem = k8._lib().d3s8_mma_smem_bytes()
            elif base == "d3rows_mma_kernel":
                f32 = targs[:1] == ["1"]
                short += " (K7, f32 input)" if f32 else " (K7)"
                smem = k8._lib().d3rows_mma_f32_smem_bytes() if f32 else \
                    k8._lib().d3rows_mma_smem_bytes()
            elif base == "site_wgmma_kernel":
                short += " (K4, wgmma core)" if targs[1:2] == ["0"] else " (K3, wgmma core)"
                smem = k8._lib_wg().site_wgmma_smem_bytes(int(targs[0]))
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
# the wgmma core's tile loop (site_wgmma_kernel: consumer warp 0)
PHASES_WG = ("wait for the tile's codes (the producer's fetch and quantize)",
             "waits for weight units (the ring's bulk copies)",
             "fragments, MMAs and the pass before's store steps issued",
             "MMA drain, the fragment epilogue (K4 at C = 192: the sums)",
             "the last pass's stores")
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


def _phase_build(module, source=None):
    """nvcc of ``module``'s source (or ``source``) with MMA_PHASE_CLOCKS,
    started: (the library's path, the process)."""
    from neuralstyletransferv1_torch.kernels import _build

    src = _build.CSRC / (source or module._SOURCE)
    so = _build.BUILD_DIR / f"lib{src.stem}_phases.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DMMA_PHASE_CLOCKS", "-o", str(so), str(src)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _phase_lib(module, so, proc, names, own=None):
    """The instrumented build, once nvcc is done, its launch functions
    ``names`` given the argtypes of the module's own build (``own``: the
    module's loader of that source, ``module._lib`` by default)."""
    import ctypes

    out = proc.communicate(timeout=600)[0]
    if proc.returncode != 0:
        fail(f"nvcc -DMMA_PHASE_CLOCKS failed for {so.name}:\n{out}")
    lib = ctypes.CDLL(str(so))
    for name in names:
        getattr(lib, name).argtypes = getattr((own or module._lib)(), name).argtypes
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

    builds = [_phase_build(k8), _phase_build(k9), _phase_build(k12),
              _phase_build(k8, k8._SOURCE_WG)]  # all nvcc at once
    lib8 = _phase_lib(k8, *builds[0], ("res_site_s8o_launch", "site_s8_launch",
                                       "res_site_launch", "res_site_skip_launch",
                                       "site_s2_launch", "d3_s8_launch", "d3_rows_launch"))
    libwg = _phase_lib(k8, *builds[3], ("res_site_wg_launch", "site_s8_wg_launch"),
                       own=k8._lib_wg)
    lib9 = _phase_lib(k9, *builds[1], ("d3_sum_site_launch", "fused_conv_launch",
                                       "d2_site_launch", "c2_site_bf16_launch",
                                       "c3_site_bf16_launch", "d3_rows_launch",
                                       "c1_site_launch"))
    lib12 = _phase_lib(k12, *builds[2], ("shift_dot_launch", "shift_dot_smem_bytes"))
    base8, base8wg, base9, base12 = k8._lib, k8._lib_wg, k9._lib, k12._lib
    # the wrappers launch the instrumented builds
    k8._lib, k8._lib_wg, k9._lib, k12._lib = (lambda: lib8), (lambda: libwg), (lambda: lib9), \
        (lambda: lib12)
    try:
        for name in REDESIGNED:
            for shape, form in INT8_KERNELS[name][0]:
                t = site_inputs(dev, *SITE_SHAPES[shape][:5], seed=11)
                kernel = site_calls(name, t, shape, form)[0]
                labels = {"d3_s8_site": PHASES_D3, "d3_rows_site": PHASES_D3_ROWS,
                          "c2_site": PHASES_S2, "c3_site": PHASES_S2}.get(name, PHASES)
                case = f"{name} @ {shape}{'/' + form if form else ''}"
                if on_wgmma(name, SITE_SHAPES[shape][3]):
                    _phase_shares(libwg, kernel, f"{case} (wgmma core)", PHASES_WG)
                    _phase_shares(lib8, site_calls(name, t, shape, form, prev=True)[0],
                                  f"{case} (previous core, mma_kernel)", labels)
                else:
                    _phase_shares(lib8, kernel, case, labels)
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
        k8._lib, k8._lib_wg, k9._lib, k12._lib = base8, base8wg, base9, base12


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
    if any(k in n for k in ("conv", "xmma", "cutlass", "sm90_", "implicit", "gemm", "cudnn",
                            "fft", "pointwise_mult_and_sum")):  # cuDNN's FFT convolutions
        return "cuDNN conv"
    if any(k in n for k in ("memcpy", "memset", "copy", "cat", "transpose", "pad",
                            "index", "gather", "repeat")):
        return "copies, pads, layout, gathers"
    if any(k in n for k in ("reduce", "norm", "sum", "mean")):
        return "reductions (norm statistics)"
    return "elementwise"


def profile_phase(dev, nst_ckpt: Path, reco_ckpts: dict, t7_ckpts: dict, workdir: Path,
                  reco_only: bool = False):
    """Device time of one steady 1080p B=8 batch of each slice (Johnson,
    NST_Train, ReCoNet, Torch7; the Johnson slices and the sets of
    ``F32_SETS`` under float32; two slots
    with rotating voronoi regions) and of the masked-stylize step, by kind
    of kernel and by kernel (torch.profiler after two warm-up batches; the
    regions' frames are numbered from 1 each batch); with ``reco_only`` the
    ReCoNet slices alone."""
    from neuralstyletransferv1_torch.engine import pipeline as tpipe

    frames = moving_frames(3 * B, H, W, SEED + 6)
    runs = ([(mode, fused, CKPT, "") for mode, fused in (("none", None), ("bf16_static", None))
             + SLICES]
            + [(mode, fused, nst_ckpt, "nst (defaults)" if dflt else "nst")
               for mode, fused, dflt in NST_SLICES]
            + [(mode, None, reco_ckpts[frn], f"reco {'frn' if frn else 'in'}")
               for mode, frn in RECO_SLICES]
            + [("int8_static", RECO_S8, reco_ckpts[False], "reco in")]
            + [(mode, fused, t7_ckpts[norm], f"t7 {norm}") for norm, mode, fused in T7_SLICES]
            + [(mode, None, CKPT, "f32") for mode in ("none",) + F32_SLICES]
            + [(mode, fused, {"johnson": CKPT, "nst": nst_ckpt, "t7 in": t7_ckpts["in"],
                              "reco in": reco_ckpts[False]}[slot],
                "f32" if slot == "johnson" else f"f32 {slot}")
               for slot, mode, fused in F32_SETS]
            + [("none", None, CKPT, "regions")])
    if reco_only:
        runs = [r for r in runs if r[3].removeprefix("f32 ").startswith("reco")]
    for mode, fused, ckpt, label in runs:
        if label.endswith("(defaults)"):
            with _without_adoption_file():
                _profile_slice(dev, mode, fused, ckpt, label, frames)
        else:
            _profile_slice(dev, mode, fused, ckpt, label, frames)
    if reco_only:
        return
    profile_masked_step(dev, frames)
    profile_deeplab(dev)
    profile_backends(dev, workdir, frames)


def _profile_slice(dev, mode, fused, ckpt, label, frames) -> None:
    """``profile_phase``'s report of one slice."""
    from neuralstyletransferv1_torch.engine import pipeline as tpipe

    f32 = label == "f32" or label.startswith("f32 ")
    argv = ["--input_video", "in.mp4", "--output_video", "out.mp4", "--model", str(ckpt),
            "--frame_batch", str(B), "--flow_ema", "--compute_dtype",
            "float32" if f32 else "bfloat16", "--quantize", mode]
    if label.removeprefix("f32 ").startswith("reco"):
        argv += ["--model_type", "reconet"]
    if label == "regions":
        argv += REGION_FLAGS
    _, proc = tpipe.make_batched_core(tpipe.build_parser().parse_args(argv), dev,
                                      fused_sites=fused)
    proc(frames[:B])
    proc(frames[B:2 * B])
    name = slice_name(mode, fused)
    name = f"{label} {name}" if label else name
    profile_report(f"--quantize {name}", lambda: proc(frames[2 * B:]))


def profile_backends(dev, workdir: Path, frames) -> None:
    """Phase 12's paths profiled like the slices: one steady 1080p B=8 batch
    of the magenta slot (colour transfer) and of the Farneback int8_static
    slice (float32) through ``make_batched_core``, flow EMA; one compact-CIN
    batch (360 tiles)."""
    import numpy as np
    import torch
    from PIL import Image

    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_torch.models import magenta as tm

    style = workdir / "magenta_style.png"
    Image.fromarray(moving_frames(1, 300, 400, SEED + 30)[0]).save(style)
    base = ["--input_video", "in.mp4", "--output_video", "out.mp4", "--frame_batch", str(B),
            "--flow_ema"]
    for label, extra in (
            ("magenta (colour transfer)", ["--model_type", "magenta", "--magenta_style",
                                           str(style), "--magenta_model_root",
                                           str(workdir / "no_magenta_models")]),
            ("farneback int8_static (f32)", ["--model", str(CKPT), "--flow_method", "farneback",
                                             "--quantize", "int8_static"])):
        _, proc = tpipe.make_batched_core(tpipe.build_parser().parse_args(base + extra), dev)
        proc(frames[:B])
        proc(frames[B:2 * B])
        profile_report(label, lambda: proc(frames[2 * B:]))
    net = tm.compact_from_jax(cin_tree(SEED + 32), dev)
    x = torch.from_numpy(np.stack(frames[:B])).to(dev).float() / 255.0
    st = x[0, :MAGENTA_TILE, :MAGENTA_TILE]

    def run():
        with torch.no_grad():
            return tm.stylize_tiled_batch(net, x, st)

    run()
    profile_report(f"compact CIN net {B}x{H}x{W}", run)

    # the same batch with every conv on an NCHW copy of its input, in turns
    import torch.nn.functional as F

    from neuralstyletransferv1_torch.experiments._bench import in_turns

    conv_nhwc = tm._conv_nhwc

    def run_nchw():
        tm._conv_nhwc = lambda x_, w, b, s_: F.conv2d(
            x_.permute(0, 3, 1, 2).contiguous(), w, b, stride=s_).permute(0, 2, 3, 1)
        try:
            return run()
        finally:
            tm._conv_nhwc = conv_nhwc

    t = in_turns({"channels-last": (run, 1), "NCHW copies": (run_nchw, 1)}, 3)
    log("compact CIN net by conv input layout: " + ", ".join(
        f"{k} {v['ms']:.2f} ms (spread {v['spread']:.1%})" for k, v in t.items()))


def profile_report(label: str, fn, group=kernel_group) -> tuple:
    """torch.profiler over one call of ``fn`` (warmed up by the caller): the
    wall, the device busy time and its share, by kind of kernel and the top
    kernels. Returns (wall ms, busy ms, device kernels and copies)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    groups: dict = {}
    for name, ms, _ in kernels:
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    n = sum(c for _, _, c in kernels)
    log(f"profile {label}: batch wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({busy / wall:.1%}), {n} device kernels and copies")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {g}: {ms:.2f} ms")
    for name, ms, count in sorted(kernels, key=lambda k: -k[1])[:12]:
        log(f"    {ms:8.3f} ms  x{count:<4d} {name[:110]}")
    return wall, busy, n


def masked_group(name: str) -> str:
    """``kernel_group`` with the resizes and gathers apart (the masked step's
    bilinear resizes, antialiased and align-corners, and index gathers)."""
    n = name.lower()
    if any(k in n for k in ("upsample", "interpolate", "index", "gather")):
        return "resize and gather"
    return kernel_group(name)


def profile_masked_step(dev, frames) -> None:
    """One steady batch of the masked-stylize step (B = DL_B at 1080p,
    infer_res DL_INFER, the full-width ResNet-101 DeepLab from seed SEED,
    the Johnson checkpoint), by kind of kernel."""
    import numpy as np
    import torch

    from neuralstyletransferv1_torch.engine import stylizer as tst
    from neuralstyletransferv1_torch.engine.masked_stylize import make_masked_stylize_step
    from neuralstyletransferv1_torch.models import deeplab as tdl

    state = tdl.import_deeplab(tdl.init_state_dict("resnet", 21, seed=SEED))[0]
    step = make_masked_stylize_step(tdl.DeepLab(state).to(dev).eval(),
                                    tst.load_model(CKPT, device=dev), (H, W), infer_res=DL_INFER)
    x = torch.from_numpy(np.stack(frames[:DL_B])).to(dev).float() / 255
    step(x)
    step(x)
    profile_report(f"masked step bf16 {DL_B}x{H}x{W} infer_res {DL_INFER}", lambda: step(x),
                   masked_group)


def profile_deeplab(dev) -> None:
    """The full-width ResNet-101 DeepLab's bf16 forward alone (B = DL_B at
    DL_INFER²), by kind of kernel; then ASPP's three atrous convs (2048 →
    256 at the OS16 feature) on channels-last and on NCHW input, timed in
    turns: the reason ``models/deeplab.aspp`` gives its atrous branches an
    NCHW copy."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from neuralstyletransferv1_torch.engine.masked_stylize import cast_params
    from neuralstyletransferv1_torch.experiments._bench import in_turns
    from neuralstyletransferv1_torch.models import deeplab as tdl

    state = tdl.import_deeplab(tdl.init_state_dict("resnet", 21, seed=SEED))[0]
    net = cast_params(tdl.DeepLab(state).to(dev).eval(), torch.bfloat16)
    rng = np.random.default_rng(SEED + 22)
    x = torch.from_numpy(rng.uniform(-1, 1, (DL_B, DL_INFER, DL_INFER, 3)).astype(np.float32)).to(
        dev, torch.bfloat16)
    with torch.no_grad():
        net(x)
        profile_report(f"DeepLab resnet bf16 forward {DL_B}x{DL_INFER}x{DL_INFER}", lambda: net(x),
                       masked_group)
        side = -(-DL_INFER // 16)
        cout, cin = net.aspp["aspp2"]["conv"].w.shape[:2]
        feat = torch.from_numpy(rng.standard_normal((DL_B, side, side, cin)).astype(np.float32)).to(
            dev, torch.bfloat16).permute(0, 3, 1, 2)
        calls = {}
        for i, rate in ((2, 6), (3, 12), (4, 18)):
            w = net.aspp[f"aspp{i}"]["conv"].w
            for layout, xin in (("channels-last", feat), ("NCHW", feat.contiguous())):
                calls[f"rate {rate} {layout}"] = (
                    lambda xin=xin, w=w, rate=rate: F.conv2d(xin, w, None, 1, rate, rate), 3)
        for name, t in in_turns(calls).items():
            log(f"ASPP atrous conv {DL_B}x{cin}x{side}x{side} -> {cout}, {name}: {t['ms']:.3f} ms "
                f"(spread {t['spread']:.1%})")


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
    global CARD
    CARD = card
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    from neuralstyletransferv1_torch.device import resolve_device
    from neuralstyletransferv1_torch.kernels import _build
    from neuralstyletransferv1_torch.kernels import bf16_sites as k9
    from neuralstyletransferv1_torch.kernels import dis_iter as k1
    from neuralstyletransferv1_torch.kernels import int8_probes as k12
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    resolve_device("cuda")  # TF32 off for the f32 paths
    t0 = time.perf_counter()
    _build.build([k1._SOURCE, k8._SOURCE, k8._SOURCE_WG, k9._SOURCE, k12._SOURCE])
    for mod in (k1, k8, k9, k12):
        mod._lib()
    k8._lib_wg()
    log(f"built K1, K2-K8b (and K3/K4's wgmma core), K9a-K11 and K12-K13 with nvcc (in parallel) in "
        f"{time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        return run_phases(dev, Path(tmp), k8)


def run_phases(dev, tmp: Path, k8) -> int:
    import torch

    nst_ckpt = nst_checkpoint(tmp / "nst_random.pth")
    reco_ckpts = {frn: reco_checkpoint(tmp / f"reco_{'frn' if frn else 'in'}.pth", frn)
                  for frn in (False, True)}
    t7_ckpts = {norm: t7_checkpoint(tmp / f"eccv16_{norm.replace(' ', '_')}.t7", norm)
                for norm in ("in", "bn", "bn k4")}
    if sys.argv[1:] in (["--profile"], ["--profile", "reco"], ["--phases"]):
        if sys.argv[1:] == ["--profile", "reco"]:
            profile_phase(dev, nst_ckpt, reco_ckpts, t7_ckpts, tmp, reco_only=True)
        elif sys.argv[1] == "--profile":
            profile_phase(dev, nst_ckpt, reco_ckpts, t7_ckpts, tmp)
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
    f32 = f32_kernel_phase(dev)
    bf16 = bf16_kernel_phase(dev)
    bf16_f32 = bf16_f32_phase(dev)
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
    nst_forms_phase(dev, nst_ckpt)
    reco_chain_phase(dev, reco_ckpts)
    t7_kernel_phase(dev, int8)
    t7_chain_phase(dev, t7_ckpts["bn"])
    t7_forms_phase(dev, t7_ckpts)
    f32_chains_phase(dev, tmp)
    launches = {k: 0 for k in read_counts()}
    runs = ([dict(quantize=mode, fused=fused) for mode, fused in (("none", None),) + SLICES]
            + [dict(quantize=mode, fused=fused, nst_ckpt=nst_ckpt, defaults=dflt)
               for mode, fused, dflt in NST_SLICES]
            + [dict(quantize=mode, reco=(reco_ckpts[frn], frn)) for mode, frn in RECO_SLICES]
            + [dict(quantize="int8_static", fused=RECO_S8, reco=(reco_ckpts[False], False))]
            + [dict(quantize=mode, fused=fused, t7=(t7_ckpts[norm], norm))
               for norm, mode, fused in T7_SLICES]
            + [dict(quantize=mode, dtype="float32") for mode in F32_SLICES]
            + [dict(quantize="int8_static", fused=J_S8_TAIL, dtype="float32"),
               dict(quantize="none", fused=TAIL_D3, dtype="float32"),
               dict(quantize="none", fused=D3, dtype="float32"),
               dict(quantize="int8", fused=J_D3_XLA, dtype="float32"),
               dict(quantize="int8", fused=NST_I8, nst_ckpt=nst_ckpt, dtype="float32"),
               dict(quantize="int8", fused=T7_I8, t7=(t7_ckpts["in"], "in"), dtype="float32"),
               dict(quantize="int8_static", fused=RECO_S8, reco=(reco_ckpts[False], False),
                    dtype="float32")])
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
    for k, v in region_phase(dev, tmp).items():
        launches[k] += v
    for k, v in deeplab_phase(dev, tmp).items():
        launches[k] += v
    for k, v in backends_phase(dev, tmp).items():
        launches[k] += v
    bench_keys = ladder_gram_phase(dev, tmp)
    bench_keys.update(s8_bench_phase(dev, t7_ckpts, reco_ckpts))
    for k, v in mesh_apps_phase(dev, tmp).items():
        launches[k] += v
    for k, v in loader_apps_phase(dev, tmp).items():
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
        srcs = sorted({per.get("source", "neuralstyletransferv1_torch/csrc/int8_sites.cu")
                       for per in rec["per_case"].values()})
        kernels.append({
            "name": name, "route": "cuda", "source": srcs[0],
            "sources": srcs, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            "cudnn_bf16_ms": rec["cudnn_bf16_ms"],
            **{k: rec[k] for k in ("prev_ms", "bound_share") if k in rec},
            "per_case": rec["per_case"],
        })
    for name, (base, _cases) in F32_KERNELS.items():
        rec = f32[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "neuralstyletransferv1_torch/csrc/int8_sites.cu",
            "replaces": INT8_KERNELS[base][1],
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None, "bf16_form_ms": rec["bf16_ms"],
            "cudnn_f32_ms": rec["cudnn_f32_ms"],
            "bound_share": rec["bound_share"], "per_case": rec["per_case"],
        })
    for name, (_shape, replaces) in BF16_KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "neuralstyletransferv1_torch/csrc/bf16_sites.cu", "replaces": replaces,
            "launches": launches[name], "library_ms": None, **bf16[name],
        })
    for name, base in BF16_F32_KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "neuralstyletransferv1_torch/csrc/bf16_sites.cu",
            "replaces": BF16_KERNELS[base][1], "launches": launches[name], "library_ms": None,
            **bf16_f32[name],
        })
    for name, (source, replaces) in EXP_KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": exp_launches[name], **exp[name],
        })
    for name in (*INT8_KERNELS, *F32_KERNELS, *BF16_KERNELS, *BF16_F32_KERNELS):
        if launches[name] == 0:
            fail(f"{name} was launched no time on the main path")
    print(json.dumps({**bench_keys, "card": CARD}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
