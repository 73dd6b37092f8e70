"""The stylizer bank: Johnson slots resident on the device, one call per
frame batch.

Counterpart of the Johnson subset of ``neuralstyletransferv1_tpu/engine/
stylizer.py``. The JAX engine runs a space-to-depth form with the IO-preset
affine baked into the first and last convs; this port computes the same
function directly: preprocess → TransformerNet → postprocess.

dtype float32 is the parity path (TF32 off, see ``device.py``); bfloat16
casts weights and activations to bf16, keeps instance-norm statistics in
f32 and returns f32.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.nn.functional as F

from neuralstyletransferv1_tpu.io import checkpoints as ckpt

from ..models import io_presets as iop
from ..models.transformer_net import TransformerNet, params_from_jax
from ..ops.resize import resize_bilinear


@dataclass
class StyleModel:
    """One loaded slot of the model bank."""

    arch: str  # johnson
    net: TransformerNet
    io_preset: str
    name: str = ""


def load_model(path: str | Path, *, model_type: str = "transformer", io_preset: str = "auto",
               name: str | None = None, device: torch.device | str = "cpu") -> StyleModel:
    """Load a reference-format Johnson checkpoint, through the same importer
    as the JAX engine (``io/checkpoints.import_transformer``)."""
    path = Path(path)
    if model_type != "transformer":
        raise NotImplementedError(
            f"model type {model_type!r}: only Johnson 'transformer' slots are ported "
            "(ROADMAP.md Queue 1, item 6: other stylizer backends)")
    sd = ckpt.load_state_dict(str(path))
    arch = ckpt.detect_transformer_arch(sd)
    if arch != "johnson":
        raise NotImplementedError(
            f"{path.name}: {arch} checkpoints are not ported "
            "(ROADMAP.md Queue 1, item 6: other stylizer backends)")
    net = TransformerNet()
    net.load_state_dict(params_from_jax(ckpt.import_transformer(sd)))
    net = net.to(device).eval().requires_grad_(False)
    if io_preset == "auto":
        io_preset = iop.resolve_auto_preset(model_type, arch=arch)
    return StyleModel(arch, net, io_preset, name or path.stem)


def stylize(net: TransformerNet, io_preset: str, x01: torch.Tensor) -> torch.Tensor:
    """[0,1] NHWC batch → stylized [0,1] NHWC batch, locked to the input size
    (the Johnson net grows dims that are not multiples of 4)."""
    out = iop.postprocess(io_preset, net(iop.preprocess(io_preset, x01)))
    if out.shape[1:3] != x01.shape[1:3]:
        out = resize_bilinear(out, (x01.shape[1], x01.shape[2]))
    return out


def jit_stylizer(model: StyleModel, *, dtype: torch.dtype = torch.float32):
    """A stylize function for one slot: f(batch01 NHWC f32) → NHWC f32.

    Sizes that are not multiples of 4 reflect-pad to the next multiple and
    crop back, as the JAX engine does for its fast forms."""
    net = model.net if dtype == torch.float32 else copy.deepcopy(model.net).to(dtype)

    @torch.no_grad()
    def fn(x01: torch.Tensor) -> torch.Tensor:
        x = x01.to(dtype)
        H, W = x.shape[1], x.shape[2]
        ph, pw = (-H) % 4, (-W) % 4
        if (ph or pw) and H >= 8 and W >= 8:
            xp = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="reflect")
            out = stylize(net, model.io_preset, xp.permute(0, 2, 3, 1))[:, :H, :W]
        else:
            out = stylize(net, model.io_preset, x)
        return out.float()

    return fn
