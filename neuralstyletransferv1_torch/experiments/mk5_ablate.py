"""mk5 on the card: mk3-T's ablations, as K10's functional forms.

Port of ``experiments/mk5_ablate.py`` at B=8, 270×480, 128 → 128. Three of
its ablations change what is computed, and K10 computes each: ``np`` no
prologue (the raw input), ``ns`` no statistics, ``bp`` the affine in bf16
arithmetic (x·bf16(a) → bf16, + bf16(c) → bf16, max 0). The script's
kernel takes the prologue and the statistics as two switches, and its
``build`` sets one a variant; ``npns`` and ``bpns`` set both, so that the
default run covers all six of K10's forms. The others (t0, t1, t2:
row-tile sizes; na: the control; x3: K-packed dy) are TPU tilings of the
f32 form. Each distinct form is checked and timed once.

    python -m neuralstyletransferv1_torch.experiments.mk5_ablate [t0 t1 t2 np ns bp npns bpns x3 na]
    python -m neuralstyletransferv1_torch.experiments.mk5_ablate --device cpu --small
"""

from __future__ import annotations

from .mk1_fusedconv import run_variants

VARIANTS = {"t0": ("f32", True, "control: T, MT=2·WP"),
            "t1": ("f32", True, "MT=WP"),
            "t2": ("f32", True, "MT=4·WP"),
            "np": ("none", True, "no prologue (raw bf16 in)"),
            "ns": ("f32", False, "no stats epilogue"),
            "bp": ("bf16", True, "bf16 prologue (no f32 upcast)"),
            "npns": ("none", False, "np and ns together (_kernel_t's two switches)"),
            "bpns": ("bf16", False, "bp and ns together (_kernel_t's two switches)"),
            "x3": ("f32", True, "K-packed dy in a (TH+3, WP, 3C) scratch, 3 dots K=384"),
            "na": ("f32", True, "the control (build's default branch)")}


def main(argv=None) -> dict:
    return run_variants("mk5_ablate", __doc__, VARIANTS, argv,
                        default=["t0", "t1", "t2", "np", "ns", "bp", "npns", "bpns", "x3"])


if __name__ == "__main__":
    main()
