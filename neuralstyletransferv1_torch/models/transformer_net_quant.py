"""The quantized and static-norm Johnson forms (``--quantize bf16_static``,
``int8_static``, ``int8``).

Port of the quant and static contract of ``neuralstyletransferv1_tpu/models/
transformer_net_s2d2.py``: ``QUANT_SITES`` / ``QUANT_SITES_PALLAS``,
``_site_weight``, ``calibrate_act_scales``, ``calibrate_in_stats``,
``quantize_net`` and the int8 routing of ``apply``; the ``_qc`` contract is
``s2d.quant_affine`` plus the site kernels (``kernels/int8_sites.py``), and
the engine's site filter (``engine/stylizer.py::_s2d2_site_filter``) is
``site_filter``. Calibration runs the f32 net with the forward hooks of
``TransformerNet``; the int8 forward runs on the bf16 net.

The bf16 fused sites of a set (``tail``, ``d3``; ``models/sites_bf16.py``)
are routed here too, as ``apply`` routes them with ``quant``.

Which sites are int8 follows the fused-site set in effect (the port's
``adopt_overrides.sites``, or an explicit tuple): the residual blocks and
deconv1/deconv2 always; conv2/conv3 with ``head_i8``, deconv3 with
``tail_s8``, each only where the geometry gates of ``sites_i8`` pass. The
adopted sets (``("res_i8", "res_s8", "dec_i8")`` under ``int8_static``,
``("res_i8", "dec_i8")`` under ``int8``) quantize exactly ``INT8_SITES``.

The int8 weights keep the forms their per-output-channel scales are taken
over: deconv1/deconv2 the space-to-depth phase weights
(``s2d.scatter_upconv``: a 3×3 conv on the low grid with 4·CO outputs),
deconv3 the tap-packed 1×5 weights to 60 lanes with the IO preset's post
affine baked in (``s2d.d3_tap_packed``; one scale per lane). An "upsample
then conv" or a pixel 9×9 conv with their own scales would be different
functions, so those sites run in those forms. conv2 and conv3 scatter each
pixel tap exactly once into the TPU's block forms, so their scales and codes
are the pixel weights'.
"""

from __future__ import annotations

import numpy as np
import torch

from . import io_presets as iop
from . import sites_bf16, sites_i8
from .s2d import apply_in_relu, d2s, d3_tap_packed, in_affine, in_stats, scatter_upconv
from .sites_bf16 import _hwio
from .transformer_net import NUM_RES, NormHooks, TransformerNet

QUANT_SITES = ("c2", "c3", "r1a", "r1b", "r2a", "r2b", "r3a", "r3b",
               "r4a", "r4b", "r5a", "r5b", "d1", "d2")
QUANT_SITES_PALLAS = QUANT_SITES + ("d3",)
#: the int8 sites under the adopted sets (no ``head_i8``, no ``tail_s8``)
INT8_SITES = tuple(f"r{i}{ab}" for i in range(1, NUM_RES + 1) for ab in "ab") + ("d1", "d2")
#: the names a fused-site set may hold: the int8 sites' and the bf16 sites'
FUSED_SITE_NAMES = ("head_i8", "res_i8", "res_s8", "dec_i8", "dec_s8", "tail_s8",
                    "d3_i8") + sites_bf16.BF16_SITE_NAMES
#: the int8 sites of a set that have no float32 form: no adopted set holds
#: them, so no CLI path reaches them
F32_UNPORTED = {"head_i8": "K8a with an f32 input (the f32 conv1 output)",
                "tail_s8": "deconv3's f32 border strips beside K6",
                "d3_i8": "deconv3's f32 border strips beside K7"}


def check_fused_sites(fused) -> tuple:
    """An int8 mode's set as a tuple; raises for unknown names. The empty
    set is the JAX engine's "mk32 BN-form configuration": every site of
    ``QUANT_SITES`` (c2 and c3 included) through the XLA int8 form, no site
    kernel."""
    fused = tuple(fused)
    unknown = sorted(set(fused) - set(FUSED_SITE_NAMES))
    if unknown:
        raise ValueError(f"unknown fused sites {unknown}; known: {FUSED_SITE_NAMES}")
    return fused


def site_filter(scales: dict, h: int, w: int, fused) -> dict:
    """The JAX engine's ``_s2d2_site_filter``: of the calibrated sites keep
    the res sites, d1 and d2; c2/c3 only under ``head_i8`` and d3 only under
    ``tail_s8``, each where its gate passes at the calibration frame's size
    h × w (padded to multiples of 4). The empty set keeps every site of
    ``QUANT_SITES``."""
    fused = check_fused_sites(fused)
    if not fused:
        return {k: v for k, v in scales.items() if k in QUANT_SITES}
    keep = {"d1", "d2"}
    if "head_i8" in fused and sites_i8.head_supported(h // 2, w // 2):
        keep |= {"c2", "c3"}
    if "tail_s8" in fused and sites_i8.d3s8_supported(h // 2, w // 2):
        keep |= {"d3"}
    return {k: v for k, v in scales.items() if k.startswith("r") or k in keep}


def baked_d3(net: TransformerNet, io_preset: str) -> tuple[np.ndarray, np.ndarray]:
    """deconv3 of the f32 net, tap-packed with ``io_preset``'s post affine
    baked in: (w_row [1,5,128,60], b [12]) f32."""
    post = iop.preset_affine(io_preset)[3:]
    return d3_tap_packed(_hwio(net.deconv3),
                         net.deconv3.conv2d.bias.detach().float().cpu().numpy(), post)


def _site_weight(net: TransformerNet, site: str, io_preset: str | None = None) -> np.ndarray:
    """HWIO f32 weights of an int8 site: pixel for the res sites and c2/c3,
    the phase form for d1/d2, the baked tap-packed form for d3."""
    if site.startswith("r"):
        blk = getattr(net, f"res{site[1]}")
        return _hwio(blk.conv1 if site[2] == "a" else blk.conv2)
    if site in ("c2", "c3"):
        return _hwio(net.conv2 if site == "c2" else net.conv3)
    if site in ("d1", "d2"):
        return scatter_upconv(_hwio(net.deconv1 if site == "d1" else net.deconv2))
    if site == "d3":
        if io_preset is None:
            raise ValueError("the d3 site's weights carry the IO preset: pass io_preset")
        return baked_d3(net, io_preset)[0]
    raise ValueError(f"site {site!r} is not an int8 site ({QUANT_SITES_PALLAS})")


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


def quantize_net(net: TransformerNet, act_scales: dict, io_preset: str | None = None) -> dict:
    """The ``quant`` dict: per site, symmetric per-output-channel int8
    weights ``w`` (HWIO), the dequant row ``ws`` = w_scale·A/127 and the
    input quantizer ``qin`` = 127/A, in the JAX code's numpy arithmetic.
    ``io_preset``: the slot's preset, baked into d3's weights."""
    return {site: quantize_site(_site_weight(net, site, io_preset), act_scales[site])
            for site in act_scales}


def quantize_site(w: np.ndarray, act_scale: float) -> dict:
    """One site's ``quant`` entry (``s2d2_sites_i8.quantize_site``): HWIO f32
    weights ``w`` → symmetric per-output-channel int8 ``w``, ``ws`` and
    ``qin`` for the activation scale ``act_scale``."""
    ws = np.maximum(np.max(np.abs(w), axis=(0, 1, 2)) / 127.0, 1e-12)
    wq = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
    a = max(float(act_scale), 1e-6)
    return {
        "w": torch.from_numpy(wq),
        "ws": torch.from_numpy(np.asarray(ws * (a / 127.0), np.float32)),
        "qin": float(np.float32(127.0 / a)),
    }


def default_sites(static: bool) -> tuple:
    """The adopted set of ``--quantize int8_static`` (static) or ``int8``."""
    from .. import adopt_overrides

    return adopt_overrides.sites("sites_static" if static else "sites")


def forward_int8(net: TransformerNet, x: torch.Tensor, sites: dict,
                 static_stats: dict | None = None, *, fused_sites=None,
                 site_weights: "sites_bf16.SiteWeights | None" = None) -> torch.Tensor:
    """The int8 forward of the (bf16) net: NHWC in, NHWC out.

    ``sites``: ``sites_i8.prepare_sites`` of the ``quantize_net`` dict.
    The net and x are bf16, or f32 (the float32 chains: the head, the norms
    outside the sites and the tail run in f32, the sites that read the f32
    tensor take their f32 forms, as ``transformer_net_s2d2.apply`` does with
    f32 params).
    With ``static_stats`` (int8_static) every norm is frozen; without
    (int8) the norms are measured — the bf16 head's in the deferred form,
    the int8 sites' from the kernels' sums. ``fused_sites``: the set that
    routes the sites (the ``apply`` of ``transformer_net_s2d2.py``), the
    adopted one when None:

    - ``head_i8`` (with c2/c3 quantized, head gate): conv2/conv3 on K8a/K8b;
      under frozen norms the in3 apply waits for the s8 res chain; without
      ``head_i8``, c2/c3 quantized (the empty set) run in the XLA form
      (``sites_i8.head_qc``);
    - ``res_s8`` (frozen norms, res gate): the s8-carry res chain (K2/K3);
      else ``res_i8`` (res gate): ``res_chain`` (K4/K5); else the same int8
      sites in the XLA form (``sites_i8.res_chain_qc``), as the JAX engine
      runs them below ``res_supported``;
    - ``dec_s8`` (frozen norms, decoder gate): d1/d2 on s8 carries, bridged
      from the s8 res chain; ``dec_i8`` (decoder gate): d1 folds the res
      chain's last add; otherwise d1 and d2 run in the XLA form
      (``dec_d1_qc``, ``dec_d2_qc``) at any size, as the JAX engine's
      ``_qc`` sites do;
    - ``tail`` (measured norms, neither ``dec_*`` took the decoder, tail
      gate): after d1, deconv2 + deconv3 as the bf16 sites K9a/K9b;
    - ``tail_s8`` (with ``dec_s8`` and d3 quantized, tail gate): d2 emits
      deconv3's codes and K6 runs deconv3;
    - ``d3`` (rows gate of the bf16 site): deconv3's rows conv on K9e; it
      wins over ``d3_i8`` (d3 quantized, rows gate), the rows conv on K7;
    - ``head`` does nothing here: the JAX forward takes it only from params
      that carry conv3's block weights (``c3_wb``), which the engine's
      never do (``_BUILD_HEAD_SITE`` is off), so its int8 sets run the bf16
      head unfused.

    ``site_weights`` (``sites_bf16.prepare`` of the f32 net) is needed by
    ``tail`` and ``d3``. When d3 is quantized the output carries the IO post
    affine (clamp only), also through K9b/K9e, which then take the baked
    weights; else it is the model's output for ``postprocess``."""
    static = static_stats is not None
    fused = set(check_fused_sites(default_sites(static) if fused_sites is None else fused_sites))
    if fused & {"tail", "d3"} and site_weights is None:
        raise ValueError("the fused sites 'tail' and 'd3' need site_weights")
    f32_unported = sorted(fused & set(F32_UNPORTED)) if x.dtype == torch.float32 else []
    if f32_unported:
        raise NotImplementedError(
            f"the fused site {f32_unported[0]!r} under float32 needs "
            f"{F32_UNPORTED[f32_unported[0]]}: ROADMAP.md Queue 2 (no CLI path reaches it)")
    h, w = x.shape[1], x.shape[2]

    use_head_i8 = ("head_i8" in fused and "c2" in sites and "c3" in sites
                   and sites_i8.head_supported(h // 2, w // 2)
                   and (not static or ("in2" in static_stats and "in3" in static_stats)))
    pend3 = None
    if use_head_i8:
        y1 = net.conv1(x).contiguous()
        if static and "in1" in static_stats:
            m1, inv1 = (t.float() for t in static_stats["in1"])
        else:
            m1, inv1 = in_stats(y1)
        y, m3, inv3 = sites_i8.head_chain(y1, m1, inv1, net, sites, static_stats)
        if static:
            pend3 = (m3, inv3)
        else:
            y = apply_in_relu(y, m3, inv3, net.in3.weight, net.in3.bias)
    elif "head_i8" not in fused and "c2" in sites and "c3" in sites:
        y = sites_i8.head_qc(x, net, sites, static_stats=static_stats)
    else:
        y = net.encode(x, NormHooks(static_stats=static_stats, deferred=True))
    y = y.contiguous()  # the kernels take dense NHWC
    h4, w4 = y.shape[1], y.shape[2]

    res_ok = (sites_i8.res_supported(h4, w4)
              and all(f"r{i}{ab}" in sites for i in range(1, NUM_RES + 1) for ab in "ab"))
    use_res_s8 = ("res_s8" in fused and static and res_ok
                  and all(f"r{i}in{j}" in static_stats
                          for i in range(1, NUM_RES + 1) for j in (1, 2)))
    use_res_i8 = "res_i8" in fused and not use_res_s8 and res_ok
    have_d = "d1" in sites and "d2" in sites and sites_i8.dec_supported(h4, w4)
    use_dec_s8 = ("dec_s8" in fused and static and have_d
                  and "in4" in static_stats and "in5" in static_stats)
    use_dec_i8 = "dec_i8" in fused and not use_dec_s8 and have_d
    use_tail_s8 = (use_dec_s8 and "tail_s8" in fused and "d3" in sites
                   and sites_i8.d3s8_supported(2 * h4, 2 * w4))

    in_aff = None
    if pend3 is not None:
        if use_res_s8:
            in_aff = in_affine(*pend3, net.in3.weight.float(), net.in3.bias.float())
        else:
            y = apply_in_relu(y, *pend3, net.in3.weight, net.in3.bias)
    carry = None
    if use_res_s8:
        y = sites_i8.res_chain_s8_static(y, net, sites, static_stats, in_aff=in_aff,
                                         emit_qo=sites["d1"].qin if use_dec_s8 else None)
    elif use_res_i8 and use_dec_i8:
        y, carry = sites_i8.res_chain(y, net, sites, static_stats=static_stats)
    elif use_res_i8:
        y = sites_i8.res_chain(y, net, sites, static_stats=static_stats, ret_carry=False)
    else:
        y = sites_i8.res_chain_qc(y, net, sites, static_stats=static_stats)

    s3 = sites.get("d3")
    d3 = None if s3 is None else (s3.wr, s3.bias)  # the baked deconv3 for K9b/K9e
    if use_dec_s8:
        if use_tail_s8:
            y12 = sites_i8.dec_chain_s8_static(y, net, sites, static_stats, tail=True)
            return d2s(y12, 2, 3)
        r2, m5, inv5 = sites_i8.dec_chain_s8_static(y, net, sites, static_stats)
    elif use_dec_i8:
        r2, m5, inv5 = sites_i8.dec_chain(y, net, sites, carry=carry, static_stats=static_stats)
    else:
        r, m4, inv4 = sites_i8.dec_d1_qc(y, net, sites, static_stats=static_stats)
        if "tail" in fused and not static and sites_bf16.tail_supported(h // 2, w // 2):
            y12 = sites_bf16.tail(d2s(r, 2, r.shape[-1] // 4), m4, inv4, net, site_weights, d3=d3)
            return d2s(y12, 2, 3)
        r2, m5, inv5 = sites_i8.dec_d2_qc(r, m4, inv4, net, sites, static_stats=static_stats)
    if "d3" in fused and sites_bf16.d3_supported(r2.shape[1], r2.shape[2]):
        return sites_bf16.d3_branch(r2, m5, inv5, net, site_weights, d3=d3)
    if s3 is not None:
        use_d3_i8 = "d3_i8" in fused and sites_i8.d3_supported(r2.shape[1], r2.shape[2])
        return sites_i8.d3_forward(r2, m5, inv5, net, s3, use_d3_i8=use_d3_i8)
    # under float32 the tail runs in f32 on the (bf16) d2 raw of the int8 sites
    y = apply_in_relu(d2s(r2, 2, r2.shape[-1] // 4).to(x.dtype), m5, inv5, net.in5.weight,
                      net.in5.bias)
    return net.deconv3(y)
