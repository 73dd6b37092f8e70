"""NST_Train-variant TransformerNet as an ``nn.Module``: the exact f32 path.

Port of ``neuralstyletransferv1_tpu/models/transformer_net_nst.py``:

  global ReflectionPad2d(40), cropped back at the end
  down: conv9x9 s1 3→32 · conv3x3 s2 32→64 · conv3x3 s2 64→128
        (zero padding k//2, affine InstanceNorm, ReLU)
  5 × residual blocks (zero-padded conv3x3 + IN + ReLU, conv3x3 + IN, skip)
  up:   2 × ConvTranspose2d(k=3, s=2, p=1, output_padding=1) + IN + ReLU
  final conv9x9 32→3, zero pad 4, no activation.

Parameter names are the reference checkpoints' (``down1.conv.weight``,
``down1.norm.weight``, ``res1.conv1.weight``, ``up1.conv.weight`` (IOHW),
``final.weight``), so the arch is detected by the ``down1.`` prefix. The
forward takes and returns NHWC (``raw_01`` scale: the IO preset these
checkpoints force). ``transformer_net_nst_fast.apply`` runs the same net in
the JAX engine's fast-form numerics (bf16, frozen norms, int8 res chains).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import conv2d
from ..ops.norm import instance_norm

PAD = 40
NUM_RES = 5
DOWN = (("down1", 3, 32, 9, 1), ("down2", 32, 64, 3, 2), ("down3", 64, 128, 3, 2))
UP = (("up1", 128, 64), ("up2", 64, 32))


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source rows of a reflect pad by ``pad`` of ``n`` rows, reflecting
    again where the pad exceeds the size (``np.pad(mode="reflect")``)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    i = torch.remainder(i, 2 * n - 2)
    return torch.where(i >= n, 2 * n - 2 - i, i)


def pad_reflect(x: torch.Tensor, pad: int = PAD) -> torch.Tensor:
    """The global reflect pad of an NHWC batch, at any size."""
    x = x.index_select(1, _reflect_index(x.shape[1], pad, x.device))
    return x.index_select(2, _reflect_index(x.shape[2], pad, x.device))


class Norm(nn.Module):
    """Affine instance norm with f32 statistics (``ops.norm``)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.weight, self.bias)


class ZConv(nn.Conv2d):
    """A k×k conv with zero padding k//2 on NHWC (``ops.conv``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.kernel_size[0] // 2
        x = F.pad(x, (0, 0, p, p, p, p))
        return conv2d(x, self.weight, self.bias, stride=self.stride[0])


class UpConv(nn.ConvTranspose2d):
    """ConvTranspose2d(k=3, s=2, p=1, output_padding=1) on NHWC: an exact 2×
    upsample of the grid."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, stride=2, padding=1, output_padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                               self.bias.to(x.dtype), stride=2, padding=1, output_padding=1)
        return y.permute(0, 2, 3, 1)


class ConvNorm(nn.Module):
    def __init__(self, conv: nn.Module, c: int):
        super().__init__()
        self.conv, self.norm = conv, Norm(c)


class ResBlock(nn.Module):
    def __init__(self, c: int = 128):
        super().__init__()
        self.conv1, self.norm1 = ZConv(c, c, 3), Norm(c)
        self.conv2, self.norm2 = ZConv(c, c, 3), Norm(c)


class TransformerNetNST(nn.Module):
    """The NST_Train net; NHWC ``raw_01`` in, NHWC out at the input size."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, k, s in DOWN:
            setattr(self, name, ConvNorm(ZConv(cin, cout, k, s), cout))
        for i in range(1, NUM_RES + 1):
            setattr(self, f"res{i}", ResBlock(128))
        for name, cin, cout in UP:
            setattr(self, name, ConvNorm(UpConv(cin, cout), cout))
        self.final = ZConv(32, 3, 9)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        y = pad_reflect(x)
        for name, *_ in DOWN:
            layer = getattr(self, name)
            y = torch.relu(layer.norm(layer.conv(y)))
        for i in range(1, NUM_RES + 1):
            blk = getattr(self, f"res{i}")
            r = torch.relu(blk.norm1(blk.conv1(y)))
            y = blk.norm2(blk.conv2(r)) + y
        for name, *_ in UP:
            layer = getattr(self, name)
            y = torch.relu(layer.norm(layer.conv(y)))
        return self.final(y)[:, PAD:PAD + h, PAD:PAD + w]


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX NST param tree (numpy leaves, as ``io/checkpoints
    .import_transformer_nst`` returns it) → ``TransformerNetNST`` state dict:
    HWIO ``w`` → OIHW, the transposed convs' (k, k, Cout, Cin) → IOHW, norm
    ``scale``/``bias`` → ``weight``/``bias``."""
    sd: dict[str, torch.Tensor] = {}

    def t(a, perm=None):
        a = np.asarray(a, np.float32)
        return torch.from_numpy(np.array(a if perm is None else a.transpose(perm)))

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = t(p["w"], (3, 2, 0, 1))
        sd[f"{prefix}.bias"] = t(p["b"])

    def norm(prefix, p):
        sd[f"{prefix}.weight"] = t(p["scale"])
        sd[f"{prefix}.bias"] = t(p["bias"])

    for name, *_ in DOWN:
        conv(f"{name}.conv", tree[name]["conv"])
        norm(f"{name}.norm", tree[name]["norm"])
    for i in range(1, NUM_RES + 1):
        r = tree[f"res{i}"]
        for k in ("conv1", "conv2"):
            conv(f"res{i}.{k}", r[k])
        for k in ("norm1", "norm2"):
            norm(f"res{i}.{k}", r[k])
    for name, *_ in UP:
        conv(f"{name}.conv", tree[name]["conv"])
        norm(f"{name}.norm", tree[name]["norm"])
    conv("final", tree["final"])
    return sd


def init(seed: int = 0) -> dict[str, torch.Tensor]:
    """Random weights from a seed, in the reference key layout: convs
    uniform in ±sqrt(3/fan_in) (biases ±sqrt(1/fan_in)), norms at identity —
    the scheme of the JAX ``transformer_net_nst.init``, drawn with numpy."""
    rng = np.random.default_rng(seed)
    ref = TransformerNetNST().state_dict()
    sd = {}
    for k, v in ref.items():
        if ".norm" in k:
            sd[k] = v
            continue
        wshape = ref[k.rsplit(".", 1)[0] + ".weight"].shape
        # OIHW convs and IOHW transposed convs both hold the JAX fan_in at 1
        fan_in = wshape[1] * wshape[2] * wshape[3]
        bound = (1.0 / fan_in) ** 0.5 * (3 ** 0.5 if k.endswith("weight") else 1.0)
        sd[k] = torch.from_numpy(rng.uniform(-bound, bound, tuple(v.shape)).astype(np.float32))
    return sd
