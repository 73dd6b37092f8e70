"""The quantized and static-norm Johnson forms (``--quantize bf16_static``,
``int8_static``, ``int8``).

Port of the quant and static contract of ``neuralstyletransferv1_tpu/models/
transformer_net_s2d2.py``: ``QUANT_SITES`` / ``QUANT_SITES_PALLAS``,
``_site_weight``, ``calibrate_act_scales``, ``calibrate_in_stats`` and
``quantize_net``; the ``_qc`` contract is ``s2d.quant_affine`` plus the site
kernels (``kernels/int8_sites.py``). Calibration runs the f32 net with the
forward hooks of ``TransformerNet``; the int8 forward runs the bf16 net's
head (conv1–conv3, pixel convs), the int8 residual and decoder chains of
``sites_i8`` and the bf16 deconv3.

The int8 weights of deconv1/deconv2 are the space-to-depth phase weights
(``s2d.scatter_upconv``): a 3×3 conv on the low grid with 4·CO outputs,
whose per-output-channel scales are taken over those phase channels. An
"upsample then conv" with its own scales would be a different function, so
d1/d2 run in that phase form followed by ``d2s``.

The JAX engine resolves its fused-site sets at run time (``adopt_overrides.py``
reading ``i8_adopt.json``); the port fixes them:

- ``--quantize int8_static``: ``("res_i8", "res_s8", "dec_i8")``, the
  ``sites_static`` key of ``neuralstyletransferv1_tpu/i8_adopt.json`` —
  the s8-carry residual chain (K2, K3) and the decoder sites (K4);
- ``--quantize int8``: ``("res_i8", "dec_i8")``, the ``sites`` default of
  ``neuralstyletransferv1_tpu/adopt_overrides.py`` (the JSON has no ``sites``
  key) — the residual chain (K4, K5) with block 5's add folded into d1.

Under both sets the engine's site filter (``engine/stylizer.py::
_s2d2_site_filter``) quantizes exactly ``INT8_SITES``: c2/c3 would need
``head_i8`` and d3 ``tail_s8``, neither adopted, so conv1–conv3 and deconv3
stay bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from . import sites_i8
from .s2d import apply_in_relu, d2s, scatter_upconv
from .transformer_net import NUM_RES, NormHooks, TransformerNet

QUANT_SITES = ("c2", "c3", "r1a", "r1b", "r2a", "r2b", "r3a", "r3b",
               "r4a", "r4b", "r5a", "r5b", "d1", "d2")
QUANT_SITES_PALLAS = QUANT_SITES + ("d3",)
INT8_SITES = tuple(f"r{i}{ab}" for i in range(1, NUM_RES + 1) for ab in "ab") + ("d1", "d2")


def _hwio(conv) -> np.ndarray:
    return conv.conv2d.weight.detach().float().permute(2, 3, 1, 0).cpu().numpy()


def _site_weight(net: TransformerNet, site: str) -> np.ndarray:
    """HWIO f32 weights of an int8 site; d1/d2 in the phase form."""
    if site.startswith("r"):
        blk = getattr(net, f"res{site[1]}")
        return _hwio(blk.conv1 if site[2] == "a" else blk.conv2)
    if site in ("d1", "d2"):
        return scatter_upconv(_hwio(net.deconv1 if site == "d1" else net.deconv2))
    raise NotImplementedError(f"site {site!r} has no int8 form in the port (only {INT8_SITES})")


@torch.no_grad()
def calibrate_act_scales(net: TransformerNet, x_cal: torch.Tensor,
                         sites: tuple = QUANT_SITES,
                         static_stats: dict | None = None) -> dict[str, float]:
    """Per-site max|activation| of the tensor each conv consumes, from one
    forward of ``net`` (f32) on ``x_cal`` — against the static-norm graph
    when ``static_stats`` is given (int8_static quantizes that graph)."""
    vals: dict[str, float] = {}

    def tap(site, t):
        if site in sites:
            vals[site] = float(t.float().abs().max())

    net(x_cal, tap=tap, static_stats=static_stats)
    return vals


@torch.no_grad()
def calibrate_in_stats(net: TransformerNet, x_cal: torch.Tensor) -> dict:
    """Frozen ``(mean, inv)`` of every instance norm (``in1..in5``,
    ``r{i}in{1,2}``) from one f32 forward, averaged over the calibration
    batch to shape (1, C)."""
    so: dict = {}
    net(x_cal.float(), stats_out=so)
    return {k: (m.mean(dim=0, keepdim=True), inv.mean(dim=0, keepdim=True))
            for k, (m, inv) in so.items()}


def quantize_net(net: TransformerNet, act_scales: dict) -> dict:
    """The ``quant`` dict: per site, symmetric per-output-channel int8
    weights ``w`` (HWIO), the dequant row ``ws`` = w_scale·A/127 and the
    input quantizer ``qin`` = 127/A, in the JAX code's numpy arithmetic."""
    q = {}
    for site in act_scales:
        w = _site_weight(net, site)
        ws = np.maximum(np.max(np.abs(w), axis=(0, 1, 2)) / 127.0, 1e-12)
        wq = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
        a = max(float(act_scales[site]), 1e-6)
        q[site] = {
            "w": torch.from_numpy(wq),
            "ws": torch.from_numpy(np.asarray(ws * (a / 127.0), np.float32)),
            "qin": float(np.float32(127.0 / a)),
        }
    return q


def forward_int8(net: TransformerNet, x: torch.Tensor, sites: dict,
                 static_stats: dict | None = None) -> torch.Tensor:
    """The int8 forward of the (bf16) net: NHWC in, NHWC out.

    ``sites``: ``sites_i8.prepare_sites`` of the ``quantize_net`` dict.
    With ``static_stats`` (int8_static) every norm is frozen and the
    residual blocks run on s8 carries; without (int8) the norms are
    measured — the head's in the deferred form, the int8 sites' from the
    kernels' sums."""
    nh = NormHooks(static_stats=static_stats, deferred=True)
    y = net.encode(x, nh).contiguous()  # the kernels take dense NHWC
    if static_stats is not None:
        y = sites_i8.res_chain_s8_static(y, net, sites, static_stats)
        r2, m5, inv5 = sites_i8.dec_chain(y, net, sites, static_stats=static_stats)
    else:
        y4, carry = sites_i8.res_chain(y, net, sites)
        r2, m5, inv5 = sites_i8.dec_chain(y4, net, sites, carry=carry)
    y = apply_in_relu(d2s(r2, 2, r2.shape[-1] // 4), m5, inv5, net.in5.weight, net.in5.bias)
    return net.deconv3(y)
