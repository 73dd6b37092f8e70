"""mk2 on the card: mk1's fused conv site in the TPU's tilings A–E.

Port of ``experiments/mk2_variants.py``. Every variant computes mk1's
function (f32 prologue, 3×3 128 → 128, bias, [Σ, Σ²]) at B=8, 270×480; the
tilings (double-buffered DMA, K-packed dy with sliced or rolled dx, row
tiles with a register accumulator) are TPU layout. Here each runs K10 in
that one form, checked and timed once.

    python -m neuralstyletransferv1_torch.experiments.mk2_variants [A B C D E]
    python -m neuralstyletransferv1_torch.experiments.mk2_variants --device cpu --small
"""

from __future__ import annotations

from .mk1_fusedconv import run_variants

VARIANTS = {"A": ("f32", True, "9 tap dots, full-strip f32 slice-adds"),
            "B": ("f32", True, "A + double-buffered input DMA"),
            "C": ("f32", True, "K-packed dy (N,384)@(384,128), 3 dx dots"),
            "D": ("f32", True, "C with pltpu.roll for the dx shifts"),
            "E": ("f32", True, "row tiles MT=512, register accumulator")}


def main(argv=None) -> dict:
    return run_variants("mk2_variants", __doc__, VARIANTS, argv, default=["A", "B", "C", "E"])


if __name__ == "__main__":
    main()
