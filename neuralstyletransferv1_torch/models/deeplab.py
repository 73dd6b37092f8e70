"""DeepLabV3+ semantic segmentation: NHWC images in, NHWC class logits out.

Counterpart of ``neuralstyletransferv1_tpu/models/deeplab.py``, the
jfzhang95-layout model: backbone (ResNet-101 bottlenecks, output stride 16
or 8, multi-grid [1, 2, 4] on layer 4) → ASPP (rates by stride, the
global-pool branch, 1280 → 256) → decoder (low-level 256 → 48, concat, two
3×3 convs, the 1×1 classifier) → align-corners bilinear upsample to the
input size. The other backbones (MobileNetV2, AlignedXception, DRN-D-54)
are in ``deeplab_backbones.py``.

Inference only. The module tree mirrors the JAX param tree: a ``Conv``
holds ``w`` (OIHW) and an optional ``b``, a ``BN`` holds ``scale``,
``bias``, ``mean`` and ``var``; the state-dict keys are the JAX tree's
paths joined by dots (``backbone.layer1.0.conv1.w``). Widths come from the
weights, as in JAX. Convolutions run on NCHW views of channels-last
tensors; ``BN`` is the JAX ``_bn`` formula (scale and shift in f32 from the
f32 running stats, applied in the activation dtype), not ``F.batch_norm``.

``import_deeplab`` reads a reference-format state dict (``module.``
stripped, running statistics kept, the class count detected from the 1×1
heads); ``params_from_jax`` turns a JAX param tree (numpy, HWIO) into the
same state dict; ``init_state_dict`` makes a seeded reference-format state
dict (the reference constructor's initialisation) for tests and the chip
smoke.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear_align_corners

_RESNET101_LAYERS = [3, 4, 23, 3]
_MG_BLOCKS = [1, 2, 4]
BACKBONES = ("resnet", "mobilenet", "xception", "drn")


class Conv(nn.Module):
    """A convolution's weight ``w`` (OIHW) and optional bias ``b``; the
    stride, padding, dilation and groups come from the call, as in JAX."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("b", b)

    def forward(self, x, *, stride=1, padding=0, dilation=1, groups=1):
        return F.conv2d(x, self.w, self.b, stride, padding, dilation, groups)


class BN(nn.Module):
    """Inference BatchNorm as the JAX ``_bn``: ``inv = rsqrt(var + eps)``,
    ``scale·inv`` and ``bias − mean·scale·inv`` in f32, cast to the
    activation dtype, then ``x·scale + shift`` in that dtype."""

    def __init__(self, scale, bias, mean, var):
        super().__init__()
        for name, t in (("scale", scale), ("bias", bias), ("mean", mean), ("var", var)):
            self.register_buffer(name, t)

    def forward(self, x, eps: float = 1e-5):
        inv = torch.rsqrt(self.var.float() + eps)
        scale = (self.scale * inv).to(x.dtype)
        shift = (self.bias - self.mean * self.scale * inv).to(x.dtype)
        return x * scale[:, None, None] + shift[:, None, None]


def _conv_bn_relu(x, conv, bn, *, stride=1, padding=0, dilation=1, relu=True):
    y = bn(conv(x, stride=stride, padding=padding, dilation=dilation))
    return F.relu(y) if relu else y


def _max_pool_3s2(x):
    return F.max_pool2d(x, 3, 2, padding=1)


def _bottleneck(x, p, *, stride=1, dilation=1):
    residual = x
    y = _conv_bn_relu(x, p["conv1"], p["bn1"])
    y = _conv_bn_relu(y, p["conv2"], p["bn2"], stride=stride, padding=dilation, dilation=dilation)
    y = _conv_bn_relu(y, p["conv3"], p["bn3"], relu=False)
    if "downsample" in p:
        residual = p["downsample"]["bn"](p["downsample"]["conv"](x, stride=stride))
    return F.relu(y + residual)


def backbone_resnet(p, x, *, output_stride=16):
    """ResNet-101 trunk → (features at the output stride, low-level feature)."""
    if output_stride == 16:
        strides, dilations = [1, 2, 2, 1], [1, 1, 1, 2]
    elif output_stride == 8:
        strides, dilations = [1, 2, 1, 1], [1, 1, 2, 4]
    else:
        raise NotImplementedError(output_stride)
    y = _conv_bn_relu(x, p["conv1"], p["bn1"], stride=2, padding=3)
    y = _max_pool_3s2(y)
    low = None
    for li, nblocks in enumerate(_RESNET101_LAYERS):
        layer = p[f"layer{li + 1}"]
        grid = _MG_BLOCKS if li == 3 else [1] * nblocks  # the multi-grid unit on layer 4
        for bi, mg in enumerate(grid):
            y = _bottleneck(y, layer[bi], stride=strides[li] if bi == 0 else 1,
                            dilation=mg * dilations[li])
        if li == 0:
            low = y
    return y, low


def aspp(p, x, *, output_stride=16):
    dil = [1, 6, 12, 18] if output_stride == 16 else [1, 12, 24, 36]
    x1 = _conv_bn_relu(x, p["aspp1"]["conv"], p["aspp1"]["bn"])
    # the atrous branches read an NCHW copy: on channels-last input cuDNN
    # runs the rate-12 and rate-18 convs at 33×33 (B=4, 2048 channels) on a
    # direct kernel, 55.3 and 41.0 ms, against 3.1 and 3.0 on NCHW (NVIDIA
    # H100 80GB HBM3, 700 W; chip_smoke.py --profile times both layouts)
    xa = x.contiguous()
    x2 = _conv_bn_relu(xa, p["aspp2"]["conv"], p["aspp2"]["bn"], padding=dil[1], dilation=dil[1])
    x3 = _conv_bn_relu(xa, p["aspp3"]["conv"], p["aspp3"]["bn"], padding=dil[2], dilation=dil[2])
    x4 = _conv_bn_relu(xa, p["aspp4"]["conv"], p["aspp4"]["bn"], padding=dil[3], dilation=dil[3])
    gp = _conv_bn_relu(x.mean((2, 3), keepdim=True), p["gap"]["conv"], p["gap"]["bn"])
    x5 = gp.expand_as(x4)  # the 1×1 map's bilinear upsample is a broadcast
    return _conv_bn_relu(torch.cat([x1, x2, x3, x4, x5], 1), p["conv1"], p["bn1"])


def _resize_nchw(x, out_hw):
    return resize_bilinear_align_corners(x.permute(0, 2, 3, 1), out_hw).permute(0, 3, 1, 2)


def decoder(p, x, low_level):
    ll = _conv_bn_relu(low_level, p["conv1"], p["bn1"])
    x = _resize_nchw(x, (ll.shape[2], ll.shape[3]))
    y = _conv_bn_relu(torch.cat([x, ll], 1), p["lc0"], p["lc1"], padding=1)
    y = _conv_bn_relu(y, p["lc4"], p["lc5"], padding=1)
    return p["cls"](y)


class DeepLab(nn.Module):
    """DeepLabV3+ from a state dict in this module's layout (``import_deeplab``,
    ``params_from_jax``). ``forward``: NHWC (ImageNet-normalised) → NHWC
    logits [K], the JAX ``apply``; ``drn`` forces output stride 8."""

    def __init__(self, state: dict, *, backbone: str = "resnet", output_stride: int = 16):
        super().__init__()
        if backbone not in BACKBONES:
            raise ValueError(f"backbone {backbone!r} not in {BACKBONES}")
        tree = _modules(_nest(state))
        self.backbone, self.aspp, self.decoder = tree["backbone"], tree["aspp"], tree["decoder"]
        self.backbone_name = backbone
        self.output_stride = 8 if backbone == "drn" else output_stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.permute(0, 3, 1, 2)
        os_ = self.output_stride
        if self.backbone_name == "resnet":
            feat, low = backbone_resnet(self.backbone, xc, output_stride=os_)
        else:
            from .deeplab_backbones import BACKBONE_FNS

            feat, low = BACKBONE_FNS[self.backbone_name](self.backbone, xc, output_stride=os_)
        y = decoder(self.decoder, aspp(self.aspp, feat, output_stride=os_), low)
        return resize_bilinear_align_corners(y.permute(0, 2, 3, 1), (x.shape[1], x.shape[2]))


# ---------------------------------------------------------------------------
# state dicts: nesting, the JAX tree, the reference checkpoint
# ---------------------------------------------------------------------------


def _nest(state: dict) -> dict:
    root: dict = {}
    for key, v in state.items():
        *path, leaf = key.split(".")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return root


def _modules(node: dict):
    """Nested dict of tensors → ``Conv`` / ``BN`` leaves in ``ModuleDict`` /
    ``ModuleList`` (digit keys) containers."""
    if all(isinstance(v, torch.Tensor) for v in node.values()):
        if set(node) <= {"w", "b"}:
            return Conv(node["w"], node.get("b"))
        return BN(node["scale"], node["bias"], node["mean"], node["var"])
    kids = {k: _modules(v) for k, v in node.items()}
    if all(k.isdigit() for k in kids):
        return nn.ModuleList([kids[str(i)] for i in range(len(kids))])
    return nn.ModuleDict(kids)


def _flatten(tree, leaf_fn, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: leaf_fn(prefix[:-1], tree)}
    out = {}
    for k, v in items:
        out.update(_flatten(v, leaf_fn, f"{prefix}{k}."))
    return out


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX DeepLab param tree (numpy or JAX arrays, HWIO weights) → this
    module's state dict (OIHW weights, f32)."""
    def leaf(key, v):
        a = np.asarray(v, np.float32)
        if key.endswith(".w"):
            a = np.transpose(a, (3, 2, 0, 1))
        return torch.tensor(np.ascontiguousarray(a))

    return _flatten(tree, leaf)


def detect_backbone(sd: dict) -> str:
    """The backbone family from reference-format keys: MobileNetV2's
    ``features`` sequential, DRN's ``layer0`` stem, Xception's ``blockN``,
    else ResNet."""
    keys = {k.removeprefix("module.") for k in sd}
    if any(k.startswith("backbone.features.") for k in keys):
        return "mobilenet"
    if any(k.startswith("backbone.layer0.") for k in keys):
        return "drn"
    if any(k.startswith("backbone.block1.") for k in keys):
        return "xception"
    return "resnet"


def detect_num_classes(sd: dict) -> int:
    """K from the 1×1 conv heads, preferring 19, 21, 150, 80."""
    candidates = [v.shape[0] for k, v in sd.items()
                  if k.endswith(".weight") and v.ndim == 4 and v.shape[2] == 1 and v.shape[3] == 1]
    for pref in (19, 21, 150, 80):
        if pref in candidates:
            return pref
    return int(candidates[-1]) if candidates else 21


def _f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(v, np.float32))


def _cv(sd, key):
    return {"w": sd[f"{key}.weight"]}


def _bnp(sd, key):
    return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"],
            "mean": sd[f"{key}.running_mean"], "var": sd[f"{key}.running_var"]}


def import_deeplab(sd: dict, *, backbone: str = "resnet") -> tuple[dict[str, torch.Tensor], int]:
    """Reference-format DeepLab state dict (tensors or arrays, running
    statistics kept) → (this module's state dict, detected class count)."""
    sd = {k.removeprefix("module."): _f32(v) for k, v in sd.items()}
    num_classes = detect_num_classes(sd)
    if backbone != "resnet":
        from .deeplab_backbones import IMPORTERS

        return _flatten(_assemble(sd, IMPORTERS[backbone](sd)), lambda k, v: v), num_classes
    bb: dict = {"conv1": _cv(sd, "backbone.conv1"), "bn1": _bnp(sd, "backbone.bn1")}
    for li, nblocks in enumerate(_RESNET101_LAYERS):
        blocks = []
        for bi in range(len(_MG_BLOCKS) if li == 3 else nblocks):
            pre = f"backbone.layer{li + 1}.{bi}"
            blk = {"conv1": _cv(sd, f"{pre}.conv1"), "bn1": _bnp(sd, f"{pre}.bn1"),
                   "conv2": _cv(sd, f"{pre}.conv2"), "bn2": _bnp(sd, f"{pre}.bn2"),
                   "conv3": _cv(sd, f"{pre}.conv3"), "bn3": _bnp(sd, f"{pre}.bn3")}
            if f"{pre}.downsample.0.weight" in sd:
                blk["downsample"] = {"conv": _cv(sd, f"{pre}.downsample.0"),
                                     "bn": _bnp(sd, f"{pre}.downsample.1")}
            blocks.append(blk)
        bb[f"layer{li + 1}"] = blocks
    return _flatten(_assemble(sd, bb), lambda k, v: v), num_classes


def _assemble(sd, bb) -> dict:
    """ASPP + decoder, shared by every backbone (identical names)."""
    ap = {f"aspp{i}": {"conv": _cv(sd, f"aspp.aspp{i}.atrous_conv"), "bn": _bnp(sd, f"aspp.aspp{i}.bn")}
          for i in range(1, 5)}
    ap["gap"] = {"conv": _cv(sd, "aspp.global_avg_pool.1"), "bn": _bnp(sd, "aspp.global_avg_pool.2")}
    ap["conv1"], ap["bn1"] = _cv(sd, "aspp.conv1"), _bnp(sd, "aspp.bn1")
    dc = {"conv1": _cv(sd, "decoder.conv1"), "bn1": _bnp(sd, "decoder.bn1"),
          "lc0": _cv(sd, "decoder.last_conv.0"), "lc1": _bnp(sd, "decoder.last_conv.1"),
          "lc4": _cv(sd, "decoder.last_conv.4"), "lc5": _bnp(sd, "decoder.last_conv.5"),
          "cls": {"w": sd["decoder.last_conv.8.weight"], "b": sd["decoder.last_conv.8.bias"]}}
    return {"backbone": bb, "aspp": ap, "decoder": dc}


# ---------------------------------------------------------------------------
# seeded reference-format state dicts
# ---------------------------------------------------------------------------


def _resnet_spec(c):
    """(key, shape) of every conv ('conv', cout, cin/groups, k, groups) and BN
    ('bn', channels) of the reference ResNet-101 trunk; ``c`` narrows."""
    yield "backbone.conv1", ("conv", c(64), 3, 7)
    yield "backbone.bn1", ("bn", c(64))
    inplanes = c(64)
    for li, (planes, nblocks) in enumerate(zip((64, 128, 256, 512), _RESNET101_LAYERS)):
        planes = c(planes)
        for bi in range(len(_MG_BLOCKS) if li == 3 else nblocks):
            pre = f"backbone.layer{li + 1}.{bi}"
            yield f"{pre}.conv1", ("conv", planes, inplanes, 1)
            yield f"{pre}.bn1", ("bn", planes)
            yield f"{pre}.conv2", ("conv", planes, planes, 3)
            yield f"{pre}.bn2", ("bn", planes)
            yield f"{pre}.conv3", ("conv", planes * 4, planes, 1)
            yield f"{pre}.bn3", ("bn", planes * 4)
            if bi == 0:
                yield f"{pre}.downsample.0", ("conv", planes * 4, inplanes, 1)
                yield f"{pre}.downsample.1", ("bn", planes * 4)
            inplanes = planes * 4


def _head_spec(c, inplanes: int, low: int, num_classes: int):
    """ASPP (inplanes → 256) and decoder (low-level → 48, 304 → 256 → K)."""
    a = c(256)
    for i in range(1, 5):
        yield f"aspp.aspp{i}.atrous_conv", ("conv", a, inplanes, 1 if i == 1 else 3)
        yield f"aspp.aspp{i}.bn", ("bn", a)
    yield "aspp.global_avg_pool.1", ("conv", a, inplanes, 1)
    yield "aspp.global_avg_pool.2", ("bn", a)
    yield "aspp.conv1", ("conv", a, 5 * a, 1)
    yield "aspp.bn1", ("bn", a)
    yield "decoder.conv1", ("conv", c(48), low, 1)
    yield "decoder.bn1", ("bn", c(48))
    yield "decoder.last_conv.0", ("conv", a, a + c(48), 3)
    yield "decoder.last_conv.1", ("bn", a)
    yield "decoder.last_conv.4", ("conv", a, a, 3)
    yield "decoder.last_conv.5", ("bn", a)
    yield "decoder.last_conv.8", ("cls", num_classes, a, 1)


def init_state_dict(backbone: str = "resnet", num_classes: int = 21, seed: int = 0,
                    width: float = 1) -> dict[str, torch.Tensor]:
    """A seeded DeepLab state dict in the reference checkpoint's key layout
    (``num_batches_tracked`` included), initialised as the reference's
    constructor does: Kaiming-normal convs (fan in, gain √2), BN weight 1,
    bias 0, running mean 0, var 1, the classifier's bias uniform in
    ±1/√fan_in. ``width`` scales every channel count (1: the published
    widths); block counts stay."""
    if backbone not in BACKBONES:
        raise ValueError(f"backbone {backbone!r} not in {BACKBONES}")

    def c(n):
        return max(1, int(n * width))

    if backbone == "resnet":
        spec, (inplanes, low) = list(_resnet_spec(c)), (c(2048), c(256))
    else:
        from .deeplab_backbones import SPECS

        spec, (inplanes, low) = SPECS[backbone](c)
    spec += list(_head_spec(c, inplanes, low, num_classes))
    g = torch.Generator().manual_seed(seed)
    sd: dict[str, torch.Tensor] = {}
    for key, (kind, *shape) in spec:
        if kind == "bn":
            n = shape[0]
            sd[f"{key}.weight"], sd[f"{key}.bias"] = torch.ones(n), torch.zeros(n)
            sd[f"{key}.running_mean"], sd[f"{key}.running_var"] = torch.zeros(n), torch.ones(n)
            sd[f"{key}.num_batches_tracked"] = torch.tensor(0)
            continue
        cout, cin, k = shape
        fan_in = cin * k * k
        sd[f"{key}.weight"] = torch.randn(cout, cin, k, k, generator=g) * math.sqrt(2.0 / fan_in)
        if kind == "cls":
            bound = 1.0 / math.sqrt(fan_in)
            sd[f"{key}.bias"] = (torch.rand(cout, generator=g) * 2 - 1) * bound
    return sd
