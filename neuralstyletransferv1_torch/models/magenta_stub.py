"""The magenta slot loader (counterpart of
``neuralstyletransferv1_tpu/models/magenta_stub.py``).

The style image is loaded with the EXIF rotation and resized to the tile
size (PIL LANCZOS). A SavedModel with complete variables under
``--magenta_model_root`` runs through the graph executor; without one the
slot takes the Reinhard colour transfer, with the JAX package's warning:
the tiled path is the same, the aesthetic a global colour match.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch


@dataclass
class MagentaSlot:
    """What ``jit_stylizer`` runs for a magenta slot: the style image (HWC
    [0,1] on the device, ``tile`` square), the tiling, the optional
    ``--magenta_target_res`` long side (0: none) and the transfer function
    (tiles → tiles)."""

    style01: torch.Tensor
    tile: int
    overlap: int
    target_res: int
    transfer_fn: object


def load_magenta_slot(style_path: str, args, device: torch.device | str = "cpu"):
    """A magenta ``StyleModel`` from the style image and the CLI's
    ``--magenta_*`` flags (``magenta_tile``, ``magenta_overlap``,
    ``magenta_target_res``, ``magenta_model_root``)."""
    from PIL import Image

    from ..engine.stylizer import StyleModel
    from ..io.frames import load_image_exif_rgb
    from . import magenta

    tile = int(getattr(args, "magenta_tile", 256))
    overlap = int(getattr(args, "magenta_overlap", 32))
    target_res = getattr(args, "magenta_target_res", None)
    style_pil = load_image_exif_rgb(style_path).resize((tile, tile), Image.LANCZOS)
    style01 = torch.from_numpy(np.asarray(style_pil, np.float32) / 255.0).to(device)

    model_root = getattr(args, "magenta_model_root", "/app/models/magenta")
    sm_dir = magenta.find_savedmodel(model_root)
    if sm_dir:
        print(f"[magenta] real weights: executing SavedModel graph from {sm_dir}")
        transfer_fn = magenta.savedmodel_transfer_fn(sm_dir, style01)
    else:
        print(f"[magenta][warn] no complete SavedModel under {model_root}; falling back to "
              "Reinhard moment-matching color transfer — the tiled path is identical, the "
              "aesthetic is a global color match rather than learned texture.")
        transfer_fn = magenta.color_transfer_fn(style01)
    slot = MagentaSlot(style01, tile, overlap, int(target_res) if target_res else 0, transfer_fn)
    return StyleModel("magenta", slot, "raw_01", Path(style_path).stem)
