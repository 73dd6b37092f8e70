"""mk3 on the card: mk1's fused conv site with auto-pipelined halo blocks.

Port of ``experiments/mk3_variants.py``. Every variant computes mk1's
function at B=8, 270×480; the body + tail BlockSpec halo and the F/G/R/T
tilings are TPU layout. Here each runs K10 in the f32 form, checked and
timed once. (mk3's ``xla_unit`` takes (x_pad, stat, w, cb): K10's operand
order.)

    python -m neuralstyletransferv1_torch.experiments.mk3_variants [F G R T]
    python -m neuralstyletransferv1_torch.experiments.mk3_variants --device cpu --small
"""

from __future__ import annotations

from .mk1_fusedconv import run_variants

VARIANTS = {"F": ("f32", True, "9 tap dots + full-strip slice-adds, pipelined halo blocks"),
            "G": ("f32", True, "K-packed dy, dx via static slices, 3 dots"),
            "R": ("f32", True, "G with pltpu.roll dx shifts"),
            "T": ("f32", True, "static row tiles MT=2·WP, 9 small dots a tile")}


def main(argv=None) -> dict:
    return run_variants("mk3_variants", __doc__, VARIANTS, argv)


if __name__ == "__main__":
    main()
