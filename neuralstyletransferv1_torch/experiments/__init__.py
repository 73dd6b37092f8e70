"""The port's counterparts of the JAX package's bf16 megakernel experiments
(``experiments/`` at the repository root), one module per script:

  mk1_fusedconv  the fused res-block site, K10 ``fused_conv`` (f32 prologue)
  mk2_variants   mk1's TPU tilings A–E: K10, same function
  mk3_variants   mk1's auto-pipelined tilings F, G, R, T: K10, same function
  mk5_ablate     mk3-T's ablations: K10 with no prologue (np), no statistics
                 (ns), the affine in bf16 arithmetic (bp); the tilings t0,
                 t1, t2, na, x3 are the f32 form
  mk7_d3site     the d3 rows site: K9e ``d3_rows``
  mk13_c1        Johnson's conv1 as a block site, K11 ``c1_site``

and of its int8 probes:

  mk20_int8_smoke      XLA's int8 dot (library calls), the plain s8 / bf16
                       dot on K12 ``shift_dot``'s flat form, the 9-tap strip
                       dot on its strip form (int8 and bf16)
  mk21_int8_res_sweep  the strip dot's variants tap9, k384 (tap9 on
                       regrouped weights), noq (s8 in): K12's strip form
  mk27_pallas_s8_dot   six shifted K = 128 dots over 32 slices, s8 at
                       offsets r and 32r, bf16, the saturating cast: K12's
                       flat form
  mk28_probe           the column pad and injection, K13 ``pad_inject``; the
                       mini site, K4 without statistics
  mk31_i8_variants     the int8 res site v0 (K4), v1 (K4 with the bare
                       saturating cast), v2 (K4 without statistics)

Each runs at its script's shapes on the card (``--device cpu --small`` for a
CPU rehearsal on the plain versions), builds its inputs from a numpy seed,
holds the kernel against its plain version, times in turns the kernel, the
plain version, the library call that computes the same function where there
is one (``library_ms``) and the yardsticks the script's XLA references stand
for (the cuDNN conv, the three-pass path; ``_bench``), and prints one JSON
line. The TPU tilings are layout and are not carried over.
"""
