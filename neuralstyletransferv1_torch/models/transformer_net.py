"""Johnson fast-style TransformerNet as an ``nn.Module``.

  conv9x9 s1 3→32 · conv3x3 s2 32→64 · conv3x3 s2 64→128  (reflect pad k//2,
  each followed by affine InstanceNorm + ReLU)
  5 × residual blocks (conv3x3+IN+ReLU, conv3x3+IN, additive skip)
  2 × (nearest ×2 upsample → conv3x3 → IN → ReLU)  128→64→32
  conv9x9 32→3, no output activation.

Parameter names are the reference checkpoints' (``conv1.conv2d.weight``,
``in1.weight`` …). ``forward`` takes and returns NHWC; the convolutions see
it as a channels-last NCHW view.

``forward``'s hooks are the JAX engine's (``transformer_net_s2d2.apply``):
``tap(site, tensor)`` sees the activated tensor each conv consumes (sites
``c1 c2 c3 r{i}a r{i}b d1 d2 d3``), ``stats_out`` records each instance
norm's ``(mean, inv)`` and ``static_stats`` freezes them (norm sites
``in1..in5`` and ``r{i}in{1,2}``). Either of the two runs every norm in the
deferred form of ``models/s2d.py``; with neither, the plain instance norm.
``fused_sites`` names the bf16 fused sites (``models/sites_bf16.py``):
``head``, ``tail`` and ``d3`` replace a norm pass + conv pair by one kernel.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.conv import conv2d
from ..ops.norm import instance_norm
from ..ops.pad import reflect_pad_2d
from ..ops.resize import upsample_nearest
from . import sites_bf16
from .s2d import apply_in_relu, d2s, in_stats, s2d

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


def _no_tap(site, t):
    return None


class NormHooks:
    """How the forward runs each instance norm (site ``in1``, ``r3in2`` …):
    frozen to ``static_stats[site]`` when it is there, else measured — in
    the deferred form (recorded into ``stats_out`` when given) or, with
    neither hook nor ``deferred``, as the plain ``instance_norm``."""

    def __init__(self, stats_out: dict | None = None, static_stats: dict | None = None,
                 deferred: bool = False):
        self.stats_out, self.static_stats = stats_out, static_stats
        self.deferred = deferred or stats_out is not None or static_stats is not None

    def __call__(self, site: str, norm: "InstanceNorm", x: torch.Tensor, *,
                 relu: bool = True) -> torch.Tensor:
        if not self.deferred:
            y = norm(x)
            return torch.relu(y) if relu else y
        m, inv = self.stats(site, x)
        return apply_in_relu(x, m, inv, norm.weight, norm.bias, relu=relu)

    def stats(self, site: str, x: torch.Tensor):
        """The norm's ``(mean, inv)``: frozen, or measured (and recorded)."""
        if self.static_stats is not None and site in self.static_stats:
            return tuple(t.float() for t in self.static_stats[site])
        m, inv = in_stats(x)
        if self.stats_out is not None:
            self.stats_out[site] = (m, inv)
        return m, inv


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

    def forward(self, x: torch.Tensor, *, tap=None, stats_out: dict | None = None,
                static_stats: dict | None = None, fused_sites=(),
                site_weights: "sites_bf16.SiteWeights | None" = None) -> torch.Tensor:
        """``fused_sites``: of ``head``, ``tail``, ``d3`` (other names of a
        set are the int8 forward's and do nothing here), routed as
        ``transformer_net_s2d2.apply`` routes them without ``quant``: a name
        whose geometry gate fails runs unfused; under ``static_stats``
        ``head`` and ``tail`` are dropped (they measure their norms) and
        ``d3`` stays. They need ``site_weights`` (``sites_bf16.prepare`` of
        the f32 net) and H, W divisible by 4; a fused site's ``tap`` sees
        the raw tensor. Under float32 ``tail`` and ``d3`` run as the JAX
        forward runs them with f32 params (K9a and K9e read the f32 raw;
        ``tail`` returns f32, ``d3`` bf16); ``head`` has no float32 form
        (the JAX forward takes it only from params with ``c3_wb``, which
        the JAX engine never builds) and raises where it would run."""
        tap = tap or _no_tap
        nh = NormHooks(stats_out, static_stats)
        fused = set(fused_sites) & set(sites_bf16.BF16_SITE_NAMES)
        if static_stats is not None:
            fused -= {"head", "tail"}
        h, w = x.shape[1], x.shape[2]
        if fused and (site_weights is None or x.dtype not in (torch.bfloat16, torch.float32)
                      or h % 4 or w % 4):
            raise ValueError("the bf16 fused sites need site_weights, a bfloat16 or float32 "
                             f"input and H, W divisible by 4 (got {x.dtype}, {h}x{w})")
        if "head" in fused and sites_bf16.head_supported(h // 2, w // 2):
            if x.dtype != torch.bfloat16:
                raise NotImplementedError(
                    "the fused site 'head' has no float32 form: the JAX forward takes it only "
                    "from params with conv3's block weights (c3_wb), which its engine never "
                    "builds")
            tap("c1", x)
            y1 = self.conv1(x).contiguous()
            raw3, m3, inv3 = sites_bf16.head(y1, *nh.stats("in1", y1), self, site_weights,
                                             tap=tap)
            y = apply_in_relu(raw3, m3, inv3, self.in3.weight, self.in3.bias)
        else:
            y = self.encode(x, nh, tap)
        for i in range(1, NUM_RES + 1):
            blk = getattr(self, f"res{i}")
            tap(f"r{i}a", y)
            r = nh(f"r{i}in1", blk.in1, blk.conv1(y))
            tap(f"r{i}b", r)
            y = nh(f"r{i}in2", blk.in2, blk.conv2(r), relu=False) + y
        tap("d1", y)
        y = self.deconv1(upsample_nearest(y, 2))
        if "tail" in fused and sites_bf16.tail_supported(h // 2, w // 2):
            y12 = sites_bf16.tail(y, *nh.stats("in4", y), self, site_weights, tap=tap)
            return d2s(y12, 2, 3)
        y = nh("in4", self.in4, y)
        tap("d2", y)
        y = self.deconv2(upsample_nearest(y, 2))
        if "d3" in fused and sites_bf16.d3_supported(h // 2, w // 2):
            return sites_bf16.d3_branch(s2d(y, 2), *nh.stats("in5", y), self, site_weights,
                                        tap=tap)
        y = nh("in5", self.in5, y)
        tap("d3", y)
        return self.deconv3(y)

    def encode(self, x: torch.Tensor, nh: NormHooks, tap=_no_tap) -> torch.Tensor:
        """conv1 → conv2 → conv3, each with its norm and ReLU: the
        activated input of the residual blocks."""
        tap("c1", x)
        y = nh("in1", self.in1, self.conv1(x))
        tap("c2", y)
        y = nh("in2", self.in2, self.conv2(y))
        tap("c3", y)
        return nh("in3", self.in3, self.conv3(y))


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


def quant_from_jax(quant: dict | None = None, static_stats: dict | None = None):
    """The JAX engine's calibration → the port's: ``quant`` (per site int8
    HWIO ``w`` — the phase weights for d1/d2, the tap-packed baked weights
    for d3, conv2's block weights gathered back to pixels — f32 ``ws``,
    scalar ``qin``,
    as ``transformer_net_s2d2.quantize_net`` returns it) and
    ``static_stats`` (per norm site ``(mean, inv)``, as ``calibrate_in_stats``
    returns it), with numpy-convertible leaves. Returns the pair in the form
    ``transformer_net_quant.quantize_net`` / ``calibrate_in_stats`` give,
    either None when not given."""
    from .s2d import stride2_pixel_weight

    def weight(site, w):
        w = np.asarray(w, np.int8)
        if site == "c2" and w.shape[:2] == (2, 2):  # the block form → pixels
            w = stride2_pixel_weight(w)
        return torch.from_numpy(w.copy())

    q = None if quant is None else {
        site: {"w": weight(site, s["w"]),
               "ws": torch.from_numpy(np.asarray(s["ws"], np.float32).copy()),
               "qin": float(np.float32(s["qin"]))}
        for site, s in quant.items()}
    st = None if static_stats is None else {
        site: tuple(torch.from_numpy(np.asarray(t, np.float32).copy()) for t in mi)
        for site, mi in static_stats.items()}
    return q, st


def init(seed: int = 0) -> dict[str, torch.Tensor]:
    """Random weights from a seed, in the reference key layout
    (``conv1.conv2d.weight`` …): convs uniform in ±sqrt(3/fan_in), biases
    in ±sqrt(1/fan_in), instance norms at identity — the scheme of the JAX
    ``transformer_net.init`` (PyTorch's Conv2d default), drawn with numpy."""
    rng = np.random.default_rng(seed)
    ref = TransformerNet().state_dict()
    sd = {}
    for k, v in ref.items():
        if ".conv2d." not in k:  # an instance norm's weight (1) or bias (0)
            sd[k] = v
            continue
        _co, ci, kh, kw = ref[k.rsplit(".", 1)[0] + ".weight"].shape
        bound = (1.0 / (ci * kh * kw)) ** 0.5 * (3 ** 0.5 if k.endswith("weight") else 1.0)
        sd[k] = torch.from_numpy(rng.uniform(-bound, bound, tuple(v.shape)).astype(np.float32))
    return sd
