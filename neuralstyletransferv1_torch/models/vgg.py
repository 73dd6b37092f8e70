"""VGG16 feature extractor for the Gram-matrix NST loss.

Counterpart of ``neuralstyletransferv1_tpu/models/vgg.py``: torchvision's
VGG16 ``features`` trunk (13 convs 3×3 pad 1, each with a ReLU, max-pools
2×2 at ``_CFG``'s ``"M"``), in torchvision's module layout, so a
torchvision ``vgg16`` state dict (``features.N.weight``) loads as it is.
The input is ImageNet-normalized first. Style and content taps follow
Gatys: content at relu3_3, style at relu1_2, relu2_2, relu3_3, relu4_3.

The weights are frozen (``requires_grad`` off): the Gram NST differentiates
with respect to the image only. Every op is a cuDNN convolution, a max-pool
or an elementwise op, as the JAX module is XLA (no ``pallas_call``). On
CUDA the f32 convs and the Gram products run with TF32 off
(``device.resolve_device``), as the JAX module's run at HIGHEST precision.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
# torchvision features indices of the convs
_TV_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]

RELU_NAMES = [
    "relu1_1", "relu1_2", "relu2_1", "relu2_2", "relu3_1", "relu3_2", "relu3_3",
    "relu4_1", "relu4_2", "relu4_3", "relu5_1", "relu5_2", "relu5_3",
]
STYLE_LAYERS = ("relu1_2", "relu2_2", "relu3_3", "relu4_3")
CONTENT_LAYER = "relu3_3"

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG16Features(nn.Module):
    """torchvision's ``vgg16().features``: NCHW in, the ReLU outputs taken
    by ``extract_features``."""

    def __init__(self):
        super().__init__()
        layers: list[nn.Module] = []
        cin = 3
        for c in _CFG:
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers += [nn.Conv2d(cin, c, 3, padding=1), nn.ReLU()]
            cin = c
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)


def init(seed: int = 0) -> dict[str, torch.Tensor]:
    """Random weights from a seed, as a torchvision-layout state dict: convs
    uniform in ±sqrt(3/fan_in), biases 0 — the scheme of the JAX
    ``vgg.init``, drawn with numpy."""
    rng = np.random.default_rng(seed)
    sd = {}
    cin = 3
    for idx, c in zip(_TV_CONV_IDX, [c for c in _CFG if c != "M"]):
        bound = (3.0 / (cin * 9)) ** 0.5
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.uniform(-bound, bound, (c, cin, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.zeros(c)
        cin = c
    return sd


def import_torchvision_vgg16(sd: dict) -> dict[str, torch.Tensor]:
    """A torchvision ``vgg16`` state dict (``features.N.weight`` OIHW, numpy
    or torch; the classifier's keys are dropped) → ``VGG16Features`` state
    dict."""
    out = {}
    for idx in _TV_CONV_IDX:
        for kind in ("weight", "bias"):
            v = sd[f"features.{idx}.{kind}"]
            v = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.asarray(v))
            out[f"features.{idx}.{kind}"] = v.float().contiguous()
    return out


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """A JAX ``vgg`` param list (``w`` HWIO, ``b``; numpy-convertible) →
    ``VGG16Features`` state dict."""
    sd = {}
    for idx, p in zip(_TV_CONV_IDX, params):
        w = np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)
        sd[f"features.{idx}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        sd[f"features.{idx}.bias"] = torch.from_numpy(np.asarray(p["b"], np.float32).copy())
    return sd


def load(sd: dict[str, torch.Tensor], device: torch.device | str = "cpu") -> VGG16Features:
    """A frozen ``VGG16Features`` holding ``sd`` on ``device``."""
    net = VGG16Features()
    net.load_state_dict(sd)
    return net.to(device).eval()


def extract_features(net: VGG16Features, x01: torch.Tensor, layers) -> dict[str, torch.Tensor]:
    """x01: NHWC in [0, 1] → {relu name: feature NHWC} for the requested
    layers; the trunk stops after the last of them (the Gatys layers never
    run conv5). The trunk runs on contiguous NCHW: on the channels-last
    view of the input cuDNN's f32 convs convert layouts around each call
    (6% slower over 100 Gram NST steps at 512² on an H100,
    ``chip_ladder_ab.py``). The features are NHWC views."""
    y = ((x01.permute(0, 3, 1, 2) - net.mean) / net.std).contiguous()
    want = set(layers)
    feats = {}
    relu_i = 0
    for m in net.features:
        y = m(y)
        if isinstance(m, nn.ReLU):
            name = RELU_NAMES[relu_i]
            relu_i += 1
            if name in want:
                feats[name] = y.permute(0, 2, 3, 1)
                if len(feats) == len(want):
                    break
    return feats


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """Gram matrix with the reference's 1/(C·H·W) normalization. feat: NHWC
    → [N, C, C] (f32, TF32 off on CUDA)."""
    n, h, w, c = feat.shape
    f = feat.permute(0, 3, 1, 2).reshape(n, c, h * w)
    return torch.bmm(f, f.transpose(1, 2)) / (c * h * w)
