#!/usr/bin/env python3
"""Parts of ``chip_smoke.py`` run on one tree, for comparing two trees on one
card in turns.

    python3 chip_ab.py ROOT slices [--nst-chain]
    python3 chip_ab.py ROOT kernels
    python3 chip_ab.py ROOT bf16
    python3 chip_ab.py ROOT experiments
    python3 chip_ab.py ROOT profile

ROOT is the root of a checkout (for example the parent commit unpacked with
``git archive`` into a gitignored directory); its own ``chip_smoke.py`` and
package are imported and its kernels built from its sources. ``slices``
runs the 1080p B=8 Johnson slices (``chip_smoke.slice_phase``: plain bf16
and every quantized or fused-site slice) and prints their frames/s; with
``--nst-chain`` it then runs the NST int8_static chain phase and the slices
again. ``kernels`` runs phase 5, K2-K8b against their plain versions with
their device times (each in turns with its previous ``__dp4a`` core);
``bf16`` the same for K9a-K9e (K9a and K9b in turns with their previous
cores). ``experiments`` runs the entry points of mk5 (K10's six
forms), mk20 and mk27 (K12's flat forms) at their full shapes, each
printing its JSON line. ``profile`` runs ``chip_smoke.py --profile``'s
torch.profiler pass over the 1080p Johnson slices only (plain bf16,
``bf16_static`` and the quantized or fused-site slices): device time by
kind of kernel. Run parent, change, change, parent in one call:

    for r in PARENT . . PARENT; do python3 chip_ab.py $r kernels; done
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path


def main() -> int:
    if len(sys.argv) < 3 or sys.argv[2] not in ("slices", "kernels", "bf16", "experiments",
                                                 "profile"):
        print(__doc__)
        return 2
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from neuralstyletransferv1_torch.device import resolve_device
    from neuralstyletransferv1_torch.kernels import _build
    from neuralstyletransferv1_torch.kernels import bf16_sites as k9
    from neuralstyletransferv1_torch.kernels import dis_iter as k1
    from neuralstyletransferv1_torch.kernels import int8_probes as k12
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    print(f"tree {root}", flush=True)
    resolve_device("cuda")
    dev = torch.device("cuda", 0)
    if sys.argv[2] == "experiments":
        import importlib

        _build.build([k9._SOURCE, k12._SOURCE])
        for name in ("mk5_ablate", "mk20_int8_smoke", "mk27_pallas_s8_dot"):
            importlib.import_module(f"neuralstyletransferv1_torch.experiments.{name}").main([])
        return 0
    _build.build([k1._SOURCE, k8._SOURCE, k9._SOURCE])
    for mod in (k1, k8, k9):
        mod._lib()
    if sys.argv[2] == "kernels":
        cs.int8_kernel_phase(dev)
        return 0
    if sys.argv[2] == "bf16":
        cs.bf16_kernel_phase(dev)
        return 0
    if sys.argv[2] == "profile":
        cs.NST_SLICES, cs.RECO_SLICES, cs.T7_SLICES = (), (), ()
        cs.profile_phase(dev, None, {}, {})
        return 0
    for mode, fused in (("none", None),) + cs.SLICES:
        cs.slice_phase(dev, mode, fused)
    if "--nst-chain" in sys.argv[3:]:
        with tempfile.TemporaryDirectory() as tmp:
            cs.nst_chain_phase(dev, cs.nst_checkpoint(Path(tmp) / "nst.pth"))
        print("--- after the NST chain phase", flush=True)
        for mode, fused in (("none", None),) + cs.SLICES:
            cs.slice_phase(dev, mode, fused)
    return 0


if __name__ == "__main__":
    sys.exit(main())
