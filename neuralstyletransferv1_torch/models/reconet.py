"""ReCoNet as an ``nn.Module``: the exact f32 path (the pixel form).

Port of ``neuralstyletransferv1_tpu/models/reconet.py``:

  encoder: conv9x9 s1 3→48 · conv3x3 s2 48→96 · conv3x3 s2 96→192, each a
           norm + activation; 4 × residual blocks at 192 (conv + norm +
           activation, conv + norm, the skip add, then the activation)
  decoder: 2 × (nearest ×2 upsample → conv3x3 → norm + activation)
           192→96→48; conv9x9 48→3, tanh.

Every conv is reflect-padded by k//2. The norm is an affine instance norm
with a ReLU, or, in an FRN net (``frn=True``), a filter response norm
(eps 1e-6) with a thresholded linear unit max(x, tau). The residual blocks
activate after the skip add. NHWC in and out: the model-input scale of
the IO preset (``imagenet_01`` for ReCoNet slots), tanh output in [−1, 1].

The module's parameters are named ``enc{1,2,3}``, ``res{0..3}``,
``dec{1,2}`` and ``final`` (``norm.tau`` for a TLU, ``act_tau`` for a res
block's post-add TLU); the reference checkpoints' nested-Sequential keys
(``encoder.layers.0.layers.0.layers.1.weight`` …) go through
``io/checkpoints.import_reconet`` and ``params_from_jax``, and ``init``
writes random weights in that reference layout.
``models/reconet_fast.apply`` runs the same net in the JAX engine's fast-form
numerics.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.conv import conv2d
from ..ops.norm import frn as frn_op
from ..ops.norm import instance_norm
from ..ops.pad import reflect_pad_2d
from ..ops.resize import upsample_nearest

ENC = (("enc1", 3, 48, 9, 1), ("enc2", 48, 96, 3, 2), ("enc3", 96, 192, 3, 2))
NUM_RES = 4
RES_C = 192
DEC = (("dec1", 192, 96), ("dec2", 96, 48))
FRN_EPS = 1e-6  # the reference FRN's eps (the fast form uses 1e-5, as the JAX one does)


class RConv(nn.Conv2d):
    """Reflect pad k//2, then a k×k conv (stride ``stride``), on NHWC."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(reflect_pad_2d(x, self.kernel_size[0] // 2), self.weight, self.bias,
                      stride=self.stride[0])


class Norm(nn.Module):
    """The affine norm of a ConvNormLayer: instance norm, or FRN; ``act``
    adds the FRN net's TLU threshold ``tau`` (an IN net's activation is a
    ReLU)."""

    def __init__(self, c: int, frn: bool, act: bool = True):
        super().__init__()
        self.frn = frn
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        if frn and act:
            self.tau = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor, act: bool = True) -> torch.Tensor:
        if self.frn:
            y = frn_op(x, self.weight, self.bias, eps=FRN_EPS)
            return torch.maximum(y, self.tau.to(y.dtype)) if act else y
        y = instance_norm(x, self.weight, self.bias)
        return torch.relu(y) if act else y


class ConvNorm(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int, frn: bool):
        super().__init__()
        self.conv, self.norm = RConv(cin, cout, k, stride), Norm(cout, frn)


class ResBlock(nn.Module):
    """conv + norm + activation, conv + norm; the caller adds the skip and
    activates after it (``act_tau``: the FRN net's post-add TLU)."""

    def __init__(self, frn: bool, c: int = RES_C):
        super().__init__()
        self.conv1, self.norm1 = RConv(c, c, 3), Norm(c, frn)
        self.conv2, self.norm2 = RConv(c, c, 3), Norm(c, frn, act=False)
        if frn:
            self.act_tau = nn.Parameter(torch.zeros(c))


def post_act(y: torch.Tensor, blk: ResBlock, frn: bool) -> torch.Tensor:
    """The activation after a residual block's skip add: max(y, tau) in f32
    (FRN), or a ReLU, back in y's dtype."""
    if frn:
        return torch.maximum(y.float(), blk.act_tau.float()).to(y.dtype)
    return torch.relu(y)


class ReCoNet(nn.Module):
    """ReCoNet; NHWC in (the IO preset's model-input scale), tanh NHWC out."""

    def __init__(self, frn: bool = False):
        super().__init__()
        self.frn = frn
        for name, cin, cout, k, s in ENC:
            setattr(self, name, ConvNorm(cin, cout, k, s, frn))
        for i in range(NUM_RES):
            setattr(self, f"res{i}", ResBlock(frn))
        for name, cin, cout in DEC:
            setattr(self, name, ConvNorm(cin, cout, 3, 1, frn))
        self.final = RConv(48, 3, 9)

    def res(self, i: int) -> ResBlock:
        return getattr(self, f"res{i}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for name, *_ in ENC:
            layer = getattr(self, name)
            y = layer.norm(layer.conv(y))
        for i in range(NUM_RES):
            blk = self.res(i)
            r = blk.norm1(blk.conv1(y))
            y = post_act(y + blk.norm2(blk.conv2(r), act=False), blk, self.frn)
        for name, *_ in DEC:
            layer = getattr(self, name)
            y = layer.norm(layer.conv(upsample_nearest(y, 2)))
        return torch.tanh(self.final(y))


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ReCoNet param tree (numpy leaves, as ``io/checkpoints
    .import_reconet`` or the JAX ``reconet.init`` give it) → ``ReCoNet``
    state dict: HWIO ``w`` → OIHW, norm ``scale``/``bias``/``tau`` →
    ``weight``/``bias``/``tau``, a res block's ``act.tau`` → ``act_tau``. A
    ``tau`` of a norm without activation (the res blocks' ``norm2``, which
    the JAX init also draws) is not part of the net's function and is
    dropped."""
    sd: dict[str, torch.Tensor] = {}
    frn = bool(tree["frn"])

    def t(a, perm=None):
        a = np.asarray(a, np.float32)
        return torch.from_numpy(np.array(a if perm is None else a.transpose(perm)))

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = t(p["w"], (3, 2, 0, 1))
        sd[f"{prefix}.bias"] = t(p["b"])

    def norm(prefix, p, act=True):
        sd[f"{prefix}.weight"] = t(p["scale"])
        sd[f"{prefix}.bias"] = t(p["bias"])
        if frn and act:
            sd[f"{prefix}.tau"] = t(p["tau"])

    enc, dec = tree["encoder"], tree["decoder"]
    for (name, *_), p in zip(ENC, enc[:3]):
        conv(f"{name}.conv", p["conv"])
        norm(f"{name}.norm", p["norm"])
    for i, r in enumerate(enc[3:]):
        conv(f"res{i}.conv1", r["conv1"])
        norm(f"res{i}.norm1", r["norm1"])
        conv(f"res{i}.conv2", r["conv2"])
        norm(f"res{i}.norm2", r["norm2"], act=False)
        if frn:
            sd[f"res{i}.act_tau"] = t(r["act"]["tau"])
    for (name, *_), p in zip(DEC, dec[:2]):
        conv(f"{name}.conv", p["conv"])
        norm(f"{name}.norm", p["norm"])
    conv("final", dec[2]["conv"])
    return sd


def _reference_layout(frn: bool) -> dict[str, tuple]:
    """The reference checkpoint's keys (``import_reconet``'s layout), each
    with its shape and how ``init`` draws it: ("conv", fan_in) for a conv
    weight or bias, ("one",) / ("zero",) for a norm weight / bias, ("tau",)
    for a TLU threshold. IN parameters are (C,), FRN parameters and TLU
    thresholds (1, C, 1, 1)."""
    layout: dict[str, tuple] = {}

    def conv(prefix, cin, cout, k):
        layout[f"{prefix}.weight"] = ((cout, cin, k, k), "conv", cin * k * k)
        layout[f"{prefix}.bias"] = ((cout,), "conv", cin * k * k)

    def cnl(prefix, cin, cout, k, act=True):
        conv(f"{prefix}.layers.0.layers.1", cin, cout, k)
        nshape = (1, cout, 1, 1) if frn else (cout,)
        layout[f"{prefix}.layers.1.weight"] = (nshape, "one")
        layout[f"{prefix}.layers.1.bias"] = (nshape, "zero")
        if frn and act:
            layout[f"{prefix}.layers.2.tau"] = ((1, cout, 1, 1), "tau")

    for i, (_, cin, cout, k, _s) in enumerate(ENC):
        cnl(f"encoder.layers.{i}", cin, cout, k)
    for i in range(3, 3 + NUM_RES):
        cnl(f"encoder.layers.{i}.branch.0", RES_C, RES_C, 3)
        cnl(f"encoder.layers.{i}.branch.1", RES_C, RES_C, 3, act=False)
        if frn:
            layout[f"encoder.layers.{i}.activation.tau"] = ((1, RES_C, 1, 1), "tau")
    cnl("decoder.layers.1", 192, 96, 3)
    cnl("decoder.layers.3", 96, 48, 3)
    conv("decoder.layers.4.layers.0.layers.1", 48, 3, 9)
    return layout


def init(seed: int = 0, frn: bool = False) -> dict[str, torch.Tensor]:
    """Random weights from a seed, in the reference key layout (for
    ``torch.save``; ``stylizer.load_model(model_type="reconet")`` reads it):
    convs uniform in ±sqrt(3/fan_in) (biases ±sqrt(1/fan_in)), norms at
    identity, the scheme of the JAX ``reconet.init``, drawn with numpy. An
    FRN net's TLU thresholds are drawn uniform in [−0.5, 0], where the JAX
    init sets them to 0 (a ReLU): so that a random FRN net exercises them."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, (shape, how, *fan_in) in _reference_layout(frn).items():
        if how == "conv":
            bound = (1.0 / fan_in[0]) ** 0.5 * (3 ** 0.5 if k.endswith("weight") else 1.0)
            sd[k] = torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32))
        elif how == "tau":
            sd[k] = torch.from_numpy(rng.uniform(-0.5, 0.0, shape).astype(np.float32))
        else:
            sd[k] = torch.full(shape, 1.0 if how == "one" else 0.0)
    return sd
