"""Johnson fast-style TransformerNet as an ``nn.Module``.

  conv9x9 s1 3→32 · conv3x3 s2 32→64 · conv3x3 s2 64→128  (reflect pad k//2,
  each followed by affine InstanceNorm + ReLU)
  5 × residual blocks (conv3x3+IN+ReLU, conv3x3+IN, additive skip)
  2 × (nearest ×2 upsample → conv3x3 → IN → ReLU)  128→64→32
  conv9x9 32→3, no output activation.

Parameter names are the reference checkpoints' (``conv1.conv2d.weight``,
``in1.weight`` …). ``forward`` takes and returns NHWC; the convolutions see
it as a channels-last NCHW view.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.conv import conv2d
from ..ops.norm import instance_norm
from ..ops.pad import reflect_pad_2d
from ..ops.resize import upsample_nearest

NUM_RES = 5
_CONVS = ("conv1", "conv2", "conv3", "deconv1", "deconv2", "deconv3")
_NORMS = ("in1", "in2", "in3", "in4", "in5")


class ConvLayer(nn.Module):
    """Reflect pad k//2, then a k×k conv (stride ``stride``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.k, self.stride = k, stride
        self.conv2d = nn.Conv2d(cin, cout, k, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = reflect_pad_2d(x, self.k // 2)
        return conv2d(y, self.conv2d.weight, self.conv2d.bias, stride=self.stride)


class InstanceNorm(nn.Module):
    """Affine instance norm with f32 statistics (``ops.norm``)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.weight, self.bias)


class ResidualBlock(nn.Module):
    def __init__(self, c: int = 128):
        super().__init__()
        self.conv1, self.in1 = ConvLayer(c, c, 3), InstanceNorm(c)
        self.conv2, self.in2 = ConvLayer(c, c, 3), InstanceNorm(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.in1(self.conv1(x)))
        return self.in2(self.conv2(y)) + x


class TransformerNet(nn.Module):
    """The Johnson net; NHWC in (scaled per the IO preset), NHWC out."""

    def __init__(self):
        super().__init__()
        self.conv1, self.in1 = ConvLayer(3, 32, 9), InstanceNorm(32)
        self.conv2, self.in2 = ConvLayer(32, 64, 3, 2), InstanceNorm(64)
        self.conv3, self.in3 = ConvLayer(64, 128, 3, 2), InstanceNorm(128)
        for i in range(1, NUM_RES + 1):
            setattr(self, f"res{i}", ResidualBlock(128))
        self.deconv1, self.in4 = ConvLayer(128, 64, 3), InstanceNorm(64)
        self.deconv2, self.in5 = ConvLayer(64, 32, 3), InstanceNorm(32)
        self.deconv3 = ConvLayer(32, 3, 9)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.in1(self.conv1(x)))
        y = torch.relu(self.in2(self.conv2(y)))
        y = torch.relu(self.in3(self.conv3(y)))
        for i in range(1, NUM_RES + 1):
            y = getattr(self, f"res{i}")(y)
        y = torch.relu(self.in4(self.deconv1(upsample_nearest(y, 2))))
        y = torch.relu(self.in5(self.deconv2(upsample_nearest(y, 2))))
        return self.deconv3(y)


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX Johnson param tree (numpy leaves, as ``io/checkpoints
    .import_transformer`` returns it) → ``TransformerNet`` state dict:
    HWIO ``w`` → OIHW ``weight``, IN ``scale``/``bias`` → ``weight``/``bias``."""
    sd: dict[str, torch.Tensor] = {}

    def conv(prefix, p):
        w = np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)
        sd[f"{prefix}.conv2d.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        sd[f"{prefix}.conv2d.bias"] = torch.from_numpy(np.asarray(p["b"], np.float32).copy())

    def norm(prefix, p):
        sd[f"{prefix}.weight"] = torch.from_numpy(np.asarray(p["scale"], np.float32).copy())
        sd[f"{prefix}.bias"] = torch.from_numpy(np.asarray(p["bias"], np.float32).copy())

    for name in _CONVS:
        conv(name, tree[name])
    for name in _NORMS:
        norm(name, tree[name])
    for i in range(1, NUM_RES + 1):
        r = tree[f"res{i}"]
        conv(f"res{i}.conv1", r["conv1"])
        norm(f"res{i}.in1", r["in1"])
        conv(f"res{i}.conv2", r["conv2"])
        norm(f"res{i}.in2", r["in2"])
    return sd
