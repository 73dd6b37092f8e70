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

Each runs at its script's shapes on the card (``--device cpu --small`` for a
CPU rehearsal on the plain versions), builds its inputs from a numpy seed,
holds the kernel against its plain version, times in turns the kernel, the
plain version, the cuDNN conv and the path the script's XLA reference
stands for (``_bench``), and prints one JSON line. The TPU tilings are layout and are not carried over.
"""
