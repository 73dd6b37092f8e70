"""Arbitrary image stylization (the magenta slot): the tiling, the stitch and the
transfer functions.

Counterpart of ``neuralstyletransferv1_tpu/models/magenta.py``. Content is
cut into ``tile_size`` tiles at stride ``tile_size − overlap`` (the whole
frame edge-padded once), the tiles of every frame run as one batch through a
transfer function, and each frame is feather-stitched back (a linear ramp
over ``overlap`` pixels at every tile edge, normalized by the summed mask,
clipped to [0, 1]). The transfer functions:

- ``savedmodel_transfer_fn``: the TF-Hub SavedModel graph (InceptionV3
  style predictor, conditional-IN transfer net) run by
  ``io/tf_saved_model.TFGraphExecutor``, when ``find_savedmodel`` finds one
  with its variables;
- ``color_transfer_fn``: the weight-free fallback, a Reinhard moment match
  of each tile's LAB planes to the style image's;
- ``CompactCIN``: the compact conditional-instance-norm net of the JAX
  module at its full width (predictor convs 32/64/128/256 at stride 2, a
  100-wide embedding; encoder 32/64/128, five 128-channel residual blocks,
  decoder 64/32, a 9×9 output conv, sigmoid). Its weights come from
  ``params_from_jax`` of a ``magenta.init`` tree (the JAX engine runs it
  only when a caller passes it the params, as the tests and the chip smoke
  do; the CLI slot takes one of the other two). It runs in f32.

Everything here is convolutions, norms and elementwise ops (the JAX module
is XLA, no ``pallas_call``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pad import reflect_pad_2d
from ..ops.resize import upsample_nearest

BOTTLENECK = 100

# (name, cin, cout, ksize, stride): encoder; residual blocks 5 × 128; decoder
_ENC = [("c1", 3, 32, 9, 1), ("c2", 32, 64, 3, 2), ("c3", 64, 128, 3, 2)]
_DEC = [("u1", 128, 64, 3), ("u2", 64, 32, 3)]
_OUT = ("out", 32, 3, 9)
_PRED = (32, 64, 128, 256)
# the CIN sites in order, each with its layer width
_CIN_SITES = ([("c1", 32), ("c2", 64), ("c3", 128)]
              + [(f"res{i}_{j}", 128) for i in range(1, 6) for j in (1, 2)]
              + [("u1", 64), ("u2", 32)])


class _Leaf(nn.Module):
    """Named tensors of one JAX param leaf dict (``w`` OIHW, ``b``; a CIN
    site's ``gw``, ``gb``, ``bw``, ``bb``), held as buffers."""

    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            self.register_buffer(name, t)


def _conv_leaf(cin, cout, k):
    return _Leaf(w=torch.zeros(cout, cin, k, k), b=torch.zeros(cout))


class CompactCIN(nn.Module):
    """The compact CIN net; the state-dict keys are the JAX tree's paths
    joined by dots (``predictor.convs.0.w``, ``net.res1_1.b``,
    ``cin.u2.gw``)."""

    def __init__(self):
        super().__init__()
        self.predictor = nn.Module()
        cins = (3,) + _PRED[:-1]
        self.predictor.convs = nn.ModuleList([_conv_leaf(ci, co, 3) for ci, co in zip(cins, _PRED)])
        self.predictor.proj = _Leaf(w=torch.zeros(_PRED[-1], BOTTLENECK),
                                    b=torch.zeros(BOTTLENECK))
        net = {name: _conv_leaf(ci, co, k) for name, ci, co, k, _s in _ENC}
        for i in range(1, 6):
            for j in (1, 2):
                net[f"res{i}_{j}"] = _conv_leaf(128, 128, 3)
        net.update({name: _conv_leaf(ci, co, k) for name, ci, co, k in _DEC})
        net["out"] = _conv_leaf(_OUT[1], _OUT[2], _OUT[3])
        self.net = nn.ModuleDict(net)
        self.cin = nn.ModuleDict({
            name: _Leaf(gw=torch.zeros(BOTTLENECK, w), gb=torch.zeros(w),
                        bw=torch.zeros(BOTTLENECK, w), bb=torch.zeros(w))
            for name, w in _CIN_SITES})

    def predict_style(self, style01: torch.Tensor) -> torch.Tensor:
        """Style images NHWC [0,1] → [N, BOTTLENECK] embeddings."""
        y = style01.permute(0, 3, 1, 2)
        for p in self.predictor.convs:
            y = F.relu(F.conv2d(y, p.w, p.b, stride=2, padding=1))
        y = y.mean(dim=(2, 3))
        return y @ self.predictor.proj.w + self.predictor.proj.b

    def transform(self, content01: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """Content NHWC [0,1] and [N, BOTTLENECK] embeddings → stylized NHWC
        [0,1], f32."""
        y = content01

        def conv(x, name, stride=1):
            p = self.net[name]
            return _conv_nhwc(x, p.w, p.b, stride)

        def cin(x, name):
            return _cin(x, emb, self.cin[name])

        for name, _ci, _co, k, s in _ENC:
            y = F.relu(cin(conv(reflect_pad_2d(y, k // 2), name, s), name))
        for i in range(1, 6):
            r = F.relu(cin(conv(reflect_pad_2d(y, 1), f"res{i}_1"), f"res{i}_1"))
            r = cin(conv(reflect_pad_2d(r, 1), f"res{i}_2"), f"res{i}_2")
            y = y + r
        for name, _ci, _co, k in _DEC:
            y = F.relu(cin(conv(reflect_pad_2d(upsample_nearest(y, 2), k // 2), name), name))
        y = conv(reflect_pad_2d(y, _OUT[3] // 2), "out")
        return torch.sigmoid(y)


def _conv_nhwc(x, w, b, stride):
    """NHWC conv with OIHW weights and a bias, no padding."""
    return F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride).permute(0, 2, 3, 1)


def _cin(x: torch.Tensor, emb: torch.Tensor, site: _Leaf) -> torch.Tensor:
    """Conditional instance norm: statistics per (N, C), γ and β from the
    embedding."""
    gamma = emb @ site.gw + site.gb
    beta = emb @ site.bw + site.bb
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + 1e-5)
    return y * gamma[:, None, None, :] + beta[:, None, None, :]


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """A ``magenta.init`` tree (numpy or JAX arrays, HWIO conv weights) →
    ``CompactCIN``'s state dict (OIHW, f32)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")
        else:
            a = np.asarray(node, np.float32)
            if a.ndim == 4:
                a = np.transpose(a, (3, 2, 0, 1))
            out[path] = torch.tensor(np.ascontiguousarray(a))

    walk(tree, "")
    return out


def init_tree(seed: int) -> dict:
    """A compact CIN net's weights as ``magenta.init``'s tree (numpy, HWIO),
    drawn from the numpy ``seed`` with init's distributions: convs uniform
    within ±√3/√fan_in (bias ±1/√fan_in), the projection and the CIN maps
    N(0, 0.05²), γ biases 1, β biases 0. (JAX's ``jax.random`` draw cannot
    be reproduced; tests carry a JAX tree across with ``compact_from_jax``.)"""
    rng = np.random.default_rng(seed)

    def conv(ci, co, k):
        b = (1.0 / (ci * k * k)) ** 0.5
        return {"w": rng.uniform(-b * 3 ** 0.5, b * 3 ** 0.5, (k, k, ci, co)).astype(np.float32),
                "b": rng.uniform(-b, b, co).astype(np.float32)}

    cins = (3,) + _PRED[:-1]
    pred = {"convs": [conv(ci, co, 3) for ci, co in zip(cins, _PRED)],
            "proj": {"w": (rng.normal(0, 1, (_PRED[-1], BOTTLENECK)) * 0.05).astype(np.float32),
                     "b": np.zeros(BOTTLENECK, np.float32)}}
    net = {name: conv(ci, co, k) for name, ci, co, k, _s in _ENC}
    net.update({f"res{i}_{j}": conv(128, 128, 3) for i in range(1, 6) for j in (1, 2)})
    net.update({name: conv(ci, co, k) for name, ci, co, k in _DEC})
    net["out"] = conv(_OUT[1], _OUT[2], _OUT[3])
    cin = {name: {"gw": (rng.normal(0, 1, (BOTTLENECK, w)) * 0.05).astype(np.float32),
                  "gb": np.ones(w, np.float32),
                  "bw": (rng.normal(0, 1, (BOTTLENECK, w)) * 0.05).astype(np.float32),
                  "bb": np.zeros(w, np.float32)} for name, w in _CIN_SITES}
    return {"predictor": pred, "net": net, "cin": cin}


def compact_from_jax(tree, device="cpu") -> CompactCIN:
    """``CompactCIN`` holding a ``magenta.init`` tree's weights on ``device``."""
    net = CompactCIN()
    net.load_state_dict(params_from_jax(tree))
    return net.to(device).eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# tiled stylization (stitch math of the JAX module, exact)
# ---------------------------------------------------------------------------


def _feather_mask(tile_size: int, overlap: int) -> np.ndarray:
    """Linear edge feather [t, t, 1]."""
    mask = np.ones((tile_size, tile_size, 1), np.float32)
    for i in range(overlap):
        wgt = i / float(overlap)
        mask[i, :, 0] *= wgt
        mask[-1 - i, :, 0] *= wgt
        mask[:, i, 0] *= wgt
        mask[:, -1 - i, 0] *= wgt
    return mask


def _stitch_weight(H: int, W: int, ys, xs, tile_size: int, overlap: int) -> np.ndarray:
    """The summed feather masks at the tile offsets [H, W, 1] (data
    independent: built once on the host)."""
    mask = _feather_mask(tile_size, overlap)
    weight = np.zeros((H, W, 1), np.float32)
    for y in ys:
        for x in xs:
            h = min(tile_size, H - y)
            w = min(tile_size, W - x)
            weight[y:y + h, x:x + w] += mask[:h, :w]
    return weight


def stylize_tiled_batch(net: CompactCIN | None, content01: torch.Tensor, style01: torch.Tensor,
                        *, tile_size: int = 256, overlap: int = 32,
                        transfer_fn=None) -> torch.Tensor:
    """Content [B,H,W,3] in [0,1] → stylized [B,H,W,3]: the tiles of every
    frame as one batch (frame-major), through ``transfer_fn`` (tiles
    [N,t,t,3] → [N,t,t,3]) or the compact ``net`` conditioned on
    ``style01`` (HWC [0,1], already ``tile_size`` square), then the feather
    stitch per frame."""
    B, H, W = content01.shape[0], content01.shape[1], content01.shape[2]
    stride = tile_size - overlap
    ys = list(range(0, H, stride))
    xs = list(range(0, W, stride))
    pad_h = max(0, ys[-1] + tile_size - H)
    pad_w = max(0, xs[-1] + tile_size - W)
    padded = F.pad(content01.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h),
                   mode="replicate").permute(0, 2, 3, 1)
    tiles = torch.stack([padded[:, y:y + tile_size, x:x + tile_size] for y in ys for x in xs], 1)
    nt = tiles.shape[1]
    flat = tiles.reshape((B * nt,) + tiles.shape[2:])
    if transfer_fn is not None:
        styled = transfer_fn(flat)
    else:
        emb = net.predict_style(style01[None])
        styled = net.transform(flat, emb.expand(flat.shape[0], -1))
    styled = styled.reshape((B, nt) + styled.shape[1:]).float()

    dev = content01.device
    mask = torch.from_numpy(_feather_mask(tile_size, overlap)).to(dev)
    weight = torch.from_numpy(_stitch_weight(H, W, ys, xs, tile_size, overlap)).to(dev)
    out = torch.zeros((B, H, W, 3), dtype=torch.float32, device=dev)
    i = 0
    for y in ys:
        for x in xs:
            h = min(tile_size, H - y)
            w = min(tile_size, W - x)
            out[:, y:y + h, x:x + w] += styled[:, i, :h, :w] * mask[:h, :w]
            i += 1
    return (out / weight.clamp_min(1e-6)).clamp(0.0, 1.0)


def stylize_tiled(net: CompactCIN | None, content01: torch.Tensor, style01: torch.Tensor,
                  **kw) -> torch.Tensor:
    """``stylize_tiled_batch`` of one HWC frame."""
    return stylize_tiled_batch(net, content01[None], style01, **kw)[0]


# ---------------------------------------------------------------------------
# transfer functions
# ---------------------------------------------------------------------------


def find_savedmodel(model_root) -> str | None:
    """A magenta SavedModel with complete variables under ``model_root``
    (the root itself or a directory in it holding ``saved_model.pb``), or
    None. A directory whose graph or variables cannot be read (a stripped
    weight shard, no ``tensorflow``) is skipped, as in the JAX package."""
    root = Path(model_root)
    if not root.exists():
        return None
    for d in [root] + sorted(root.glob("*")):
        if not (d / "saved_model.pb").exists():
            continue
        try:
            import tensorflow as tf

            from ..io import tf_saved_model as tsm

            name_map = tsm.checkpoint_name_map(tsm.load_saved_model_proto(d))
            rdr = tf.train.load_checkpoint(str(d / "variables" / "variables"))
            rdr.get_tensor(next(iter(name_map)))  # raises if the shard is missing
            return str(d)
        except Exception:
            continue
    return None


def savedmodel_transfer_fn(sm_dir, style01: torch.Tensor):
    """Tiles [N,t,t,3] → stylized [N,t,t,3] through the SavedModel graph,
    its variables on ``style01``'s device."""
    from ..io.tf_saved_model import TFGraphExecutor

    ex = TFGraphExecutor(sm_dir, device=style01.device)
    style = style01[None]

    def transfer(tiles):
        return ex.forward(tiles, style)

    return transfer


def color_transfer_fn(style01: torch.Tensor):
    """The weight-free transfer: each tile's LAB planes (PIL's byte
    convention) moved to the style image's mean and population standard
    deviation, back to RGB, clipped."""
    from ..ops.color import lab_u8_to_rgb, rgb_to_lab_u8

    style_lab = rgb_to_lab_u8(style01)
    s_mean = style_lab.mean(dim=(0, 1))
    s_std = style_lab.std(dim=(0, 1), correction=0) + 1e-5

    def transfer(tiles):
        lab = rgb_to_lab_u8(tiles)
        m = lab.mean(dim=(1, 2), keepdim=True)
        sd = lab.std(dim=(1, 2), keepdim=True, correction=0) + 1e-5
        out = (lab - m) / sd * s_std + s_mean
        return lab_u8_to_rgb(out.clamp(0.0, 255.0)).clamp(0.0, 1.0)

    return transfer
