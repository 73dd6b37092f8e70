"""The stylizer bank: Johnson slots resident on the device, one call per
frame batch.

Counterpart of the Johnson subset of ``neuralstyletransferv1_tpu/engine/
stylizer.py``. The JAX engine runs a space-to-depth form with the IO-preset
affine baked into the first and last convs; this port computes the same
function directly: preprocess → TransformerNet → postprocess.

dtype float32 is the parity path (TF32 off, see ``device.py``); bfloat16
casts weights and activations to bf16, keeps instance-norm statistics in
f32 and returns f32. Under bfloat16, ``quantize`` selects the JAX engine's
``--quantize`` modes: ``bf16_static`` freezes every instance norm to the
first frame's statistics, ``int8_static`` and ``int8`` run the int8 sites
with frozen or measured norms (``models/transformer_net_quant.py``), routed
by a fused-site set: the adopted one (``adopt_overrides.py`` reading
``i8_adopt.json``), or the tuple ``jit_stylizer(fused_sites=...)`` is given.
When the set makes deconv3 an int8 site, its weights carry the IO post
affine, as the JAX engine bakes it, and the output is only clamped. A set
may also name the bf16 fused sites ``head``, ``tail`` and ``d3``
(``models/sites_bf16.py``, K9a–K9e): with ``quantize="none"`` or
``bf16_static`` they route the bf16 net itself
(``TransformerNet.forward(fused_sites=)``), in the int8 modes ``tail`` and
``d3`` route the decoder (``forward_int8``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.nn.functional as F

from ..io import checkpoints as ckpt
from ..models import io_presets as iop
from ..models import sites_bf16, sites_i8
from ..models import transformer_net_quant as tq
from ..models.transformer_net import TransformerNet, params_from_jax
from ..ops.resize import resize_bilinear

QUANTIZE_MODES = ("none", "bf16_static", "int8_static", "int8")


@dataclass
class StyleModel:
    """One loaded slot of the model bank."""

    arch: str  # johnson
    net: TransformerNet
    io_preset: str
    name: str = ""


def load_model(path: str | Path, *, model_type: str = "transformer", io_preset: str = "auto",
               name: str | None = None, device: torch.device | str = "cpu") -> StyleModel:
    """Load a reference-format Johnson checkpoint (``io/checkpoints``, the
    port's copy of the JAX engine's importer)."""
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


def _input_size(out: torch.Tensor, x01: torch.Tensor) -> torch.Tensor:
    if out.shape[1:3] != x01.shape[1:3]:
        out = resize_bilinear(out, (x01.shape[1], x01.shape[2]))
    return out


def stylize(forward, io_preset: str, x01: torch.Tensor) -> torch.Tensor:
    """[0,1] NHWC batch → stylized [0,1] NHWC batch, locked to the input size
    (the Johnson net grows dims that are not multiples of 4). ``forward``:
    the net, or any function of its input with the same contract."""
    return _input_size(iop.postprocess(io_preset, forward(iop.preprocess(io_preset, x01))), x01)


def stylize_baked(forward, io_preset: str, x01: torch.Tensor) -> torch.Tensor:
    """``stylize`` for a forward whose output already carries the preset's
    post affine (an int8 deconv3): the output is only clamped."""
    return _input_size(forward(iop.preprocess(io_preset, x01)).clamp(0.0, 1.0), x01)


def _reflect_pad(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Reflect-pad NHWC at the bottom/right."""
    return F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="reflect").permute(0, 2, 3, 1)


def _calibrated_forward(model: StyleModel, net: TransformerNet, quantize: str,
                        x01: torch.Tensor, fused_sites=None, sw=None):
    """Calibrate on the first frame of ``x01`` (f32, the f32 weights, padded
    to a multiple of 4 only) and return the forward of ``quantize`` and
    whether its output carries the post affine. ``sw``: the bf16 sites'
    weights, where the set names one."""
    xc = x01[:1].float()
    H, W = xc.shape[1], xc.shape[2]
    xc = _reflect_pad(xc, (-H) % 4, (-W) % 4)
    xin = iop.preprocess(model.io_preset, xc)
    stats = None
    if quantize in ("bf16_static", "int8_static"):
        stats = tq.calibrate_in_stats(model.net, xin)
    if quantize == "bf16_static":
        print(f"[stylizer] static-norm bf16 path calibrated for {model.name} "
              f"({len(stats)} frozen norms)")
        return (lambda t: net(t, static_stats=stats, fused_sites=fused_sites or (),
                              site_weights=sw)), False
    fused = tq.check_fused_sites(tq.default_sites(stats is not None) if fused_sites is None
                                 else fused_sites)
    scales = tq.calibrate_act_scales(model.net, xin, sites=tq.QUANT_SITES_PALLAS,
                                     static_stats=stats)
    scales = tq.site_filter(scales, xc.shape[1], xc.shape[2], fused)
    quant = tq.quantize_net(model.net, scales, io_preset=model.io_preset)
    d3 = tq.baked_d3(model.net, model.io_preset) if "d3" in quant else None
    sites = sites_i8.prepare_sites(net, quant, x01.device, d3=d3)
    print(f"[stylizer] {quantize} path calibrated for {model.name} ({len(sites)} int8 sites, "
          f"fused {fused}" + (f", {len(stats)} frozen norms)" if stats else ")"))
    return (lambda t: tq.forward_int8(net, t, sites, stats, fused_sites=fused,
                                      site_weights=sw)), d3 is not None


def jit_stylizer(model: StyleModel, *, dtype: torch.dtype = torch.float32,
                 quantize: str = "none", fused_sites=None):
    """A stylize function for one slot: f(batch01 NHWC f32) → NHWC f32.
    ``fused_sites``: the fused-site set; None is the adopted one in the int8
    modes (``adopt_overrides.sites``) and no fused site otherwise. Under
    bfloat16 without an int8 mode the set's ``head``, ``tail`` and ``d3``
    run as the bf16 fused sites (the port's stand-in for calling the JAX
    ``apply(fused_sites=)`` directly).

    Sizes that are not multiples of 4 reflect-pad to the next multiple and
    crop back, as the JAX engine does for its fast forms; the int8 modes pad
    to multiples of 8 × 32 once H ≥ 32 and W ≥ 64, as the JAX engine does so
    that its fused sites keep their geometry (the padding changes the
    instance-norm statistics, so it is part of the function). A quantize
    mode calibrates lazily on the first frame of the first batch."""
    if quantize not in QUANTIZE_MODES:
        raise ValueError(f"quantize {quantize!r} not in {QUANTIZE_MODES}")
    if quantize != "none" and dtype != torch.bfloat16:
        raise NotImplementedError(
            f"--quantize {quantize} runs under bfloat16 only: ROADMAP.md Queue 1, item 10 "
            "(--quantize under float32)")
    if fused_sites is not None:
        unknown = sorted(set(fused_sites) - set(tq.FUSED_SITE_NAMES))
        if unknown:
            raise ValueError(f"unknown fused sites {unknown}; known: {tq.FUSED_SITE_NAMES}")
    bf16_sites = set(fused_sites or ()) & set(sites_bf16.BF16_SITE_NAMES)
    if bf16_sites and dtype != torch.bfloat16:
        raise NotImplementedError(
            f"fused sites {sorted(bf16_sites)} run under bfloat16 only: ROADMAP.md Queue 1, "
            "item 10 (--quantize and fused sites under float32)")
    net = model.net if dtype == torch.float32 else copy.deepcopy(model.net).to(dtype)
    sw = None
    if bf16_sites:
        sw = sites_bf16.prepare(model.net, next(model.net.parameters()).device)

    def plain(t):
        return net(t, fused_sites=fused_sites or (), site_weights=sw)

    state = {"forward": plain if quantize == "none" else None, "baked": False}
    int8 = quantize in ("int8_static", "int8")

    @torch.no_grad()
    def fn(x01: torch.Tensor) -> torch.Tensor:
        if state["forward"] is None:
            state["forward"], state["baked"] = _calibrated_forward(model, net, quantize, x01,
                                                                   fused_sites, sw)
        x = x01.to(dtype)
        H, W = x.shape[1], x.shape[2]
        mh, mw = (8, 32) if int8 and H >= 32 and W >= 64 else (4, 4)
        ph, pw = (-H) % mh, (-W) % mw
        run = stylize_baked if state["baked"] else stylize
        if (ph or pw) and H >= 8 and W >= 8:
            out = run(state["forward"], model.io_preset, _reflect_pad(x, ph, pw))[:, :H, :W]
        else:
            out = run(state["forward"], model.io_preset, x)
        return out.float()

    return fn
