"""The stylizer bank: Johnson, NST_Train, ReCoNet, Torch7 and magenta slots
resident on the device, one call per frame batch.

Counterpart of the Johnson, NST, ReCoNet, ``.t7`` and magenta parts of
``neuralstyletransferv1_tpu/engine/stylizer.py``. The JAX engine runs a space-to-depth form with the IO-preset
affine baked into the first and last convs; this port computes the same
function directly: preprocess → TransformerNet → postprocess.

dtype float32 is the parity path (TF32 off, see ``device.py``); bfloat16
casts weights and activations to bf16, keeps instance-norm statistics in
f32 and returns f32. Under either dtype, ``quantize`` selects the JAX
engine's ``--quantize`` modes (under float32 the head, the norms and the
tail run in f32, and the sites that read an f32 tensor take the kernels'
f32-operand forms, which read it unrounded as the JAX kernels do):
``bf16_static`` freezes every instance norm to the
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

NST_Train slots (``down1.``-keyed checkpoints, arch ``nst``, IO preset
forced to ``raw_01``) run ``models/transformer_net_nst_fast.apply`` with
the same pad-and-crop and lazy first-frame calibration; their int8 modes
route by the adopted ``nst`` / ``nst_static`` sets. ReCoNet slots
(``model_type="reconet"``, IN or FRN nets, preset ``imagenet_01`` by
default) run ``models/reconet_fast.apply`` the same way, routed by the
adopted ``reco`` / ``reco_static`` sets (``RECO_SKIP`` / ``reco_skip``
choose the K5 form of the ``res_i8`` chain). Torch7 slots (``.t7`` files, or
``model_type="torch7"``; preset ``caffe_bgr`` by default) run
``io/t7_fast.t7_fast_apply`` where the graph matches the Johnson topology
and the exact executor ``io/t7.t7_apply`` where it does not; their int8
modes route by the adopted ``t7`` set (instance-norm graphs) or ``t7_bn``
(BN-folded graphs, and instance-norm graphs folded by the static modes).
Magenta slots (``model_type="magenta"``: a style image, preset ``raw_01``)
run the tiled transfer of ``models/magenta.py`` in f32 whatever the dtype
and quantize mode, as the JAX engine does.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.nn.functional as F

from ..io import checkpoints as ckpt
from ..models import io_presets as iop
from ..models import reconet as rn
from ..models import reconet_fast as rf
from ..models import sites_bf16, sites_i8
from ..models import transformer_net_quant as tq
from ..models import transformer_net_nst as tnn
from ..models import transformer_net_nst_fast as nstf
from ..models.transformer_net import TransformerNet, params_from_jax
from ..ops.resize import resize_bilinear

QUANTIZE_MODES = ("none", "bf16_static", "int8_static", "int8")


@dataclass
class StyleModel:
    """One loaded slot of the model bank."""

    arch: str  # johnson | nst | reconet | t7 | magenta
    # t7: the layer list; magenta: a models/magenta_stub.MagentaSlot
    net: TransformerNet | tnn.TransformerNetNST | rn.ReCoNet | list | object
    io_preset: str
    name: str = ""


def load_model(path: str | Path, *, model_type: str = "transformer", io_preset: str = "auto",
               name: str | None = None, device: torch.device | str = "cpu",
               magenta_args=None) -> StyleModel:
    """Load a reference-format Johnson, NST_Train or ReCoNet checkpoint
    (``io/checkpoints``, the port's copy of the JAX engine's importer; a
    ``transformer``'s arch by key prefix, a ``reconet``'s norm family by its
    ``.tau`` keys), or a Torch7 ``.t7`` net (by its suffix, or
    ``model_type="torch7"``: ``io/t7.load_torch7_model``, its layers on
    ``device``). NST checkpoints force ``raw_01`` over ``raw_255`` and
    ``imagenet_255``, as the reference does. A ``magenta`` slot's ``path``
    is its style image (``models/magenta_stub.load_magenta_slot``, with the
    CLI's ``--magenta_*`` values in ``magenta_args``, defaults where None)."""
    if model_type == "magenta":
        from ..models.magenta_stub import load_magenta_slot

        return load_magenta_slot(str(path), magenta_args, device)
    path = Path(path)
    if model_type == "torch7" or path.suffix.lower() == ".t7":
        from ..io.t7 import load_torch7_model

        m = load_torch7_model(str(path), io_preset, device=device)
        return StyleModel(m.arch, m.net, m.io_preset, name or m.name)
    if model_type not in ("transformer", "reconet"):
        raise ValueError(f"model type {model_type!r} is not one of transformer, torch7, "
                         "magenta, reconet")
    sd = ckpt.load_state_dict(str(path))
    arch = "reconet" if model_type == "reconet" else ckpt.detect_transformer_arch(sd)
    if arch == "reconet":
        tree = ckpt.import_reconet(sd)
        net = rn.ReCoNet(frn=tree["frn"])
        net.load_state_dict(rn.params_from_jax(tree))
    elif arch == "nst":
        net = tnn.TransformerNetNST()
        net.load_state_dict(tnn.params_from_jax(ckpt.import_transformer_nst(sd)))
    else:
        net = TransformerNet()
        net.load_state_dict(params_from_jax(ckpt.import_transformer(sd)))
    net = net.to(device).eval().requires_grad_(False)
    if io_preset == "auto":
        io_preset = iop.resolve_auto_preset(model_type, arch=arch)
    elif arch == "nst" and io_preset in ("raw_255", "imagenet_255"):
        io_preset = "raw_01"
    return StyleModel(arch, net, io_preset, name or path.stem)


def make_random_model(arch: str = "nst", *, seed: int = 0, io_preset: str | None = None,
                      device: torch.device | str = "cpu") -> StyleModel:
    """A random-weight slot from a seed (tests, the chip smoke and the ladder
    bank, where no trained checkpoint is in the repo): ``johnson`` (preset
    ``imagenet_255``), ``nst`` (``raw_01``) or an IN ``reconet``
    (``imagenet_01``; an FRN net: ``models/reconet.init(seed, frn=True)``
    saved and loaded). Johnson and ReCoNet weights load through the
    checkpoint importer, as a saved ``init(seed)`` would."""
    if arch == "johnson":
        from ..models import transformer_net as tn

        net, preset = TransformerNet(), "imagenet_255"
        net.load_state_dict(params_from_jax(ckpt.import_transformer(
            {k: v.numpy() for k, v in tn.init(seed).items()})))
    elif arch == "nst":
        net, preset = tnn.TransformerNetNST(), "raw_01"
        net.load_state_dict(tnn.init(seed))
    elif arch == "reconet":
        net, preset = rn.ReCoNet(), "imagenet_01"
        net.load_state_dict(rn.params_from_jax(ckpt.import_reconet(
            {k: v.numpy() for k, v in rn.init(seed).items()})))
    else:
        raise NotImplementedError(
            f"make_random_model({arch!r}): the random slots are 'johnson', 'nst' and 'reconet' "
            "(a .t7 net: chip_smoke.t7_net_layers + write_t7; a magenta slot takes a style image)")
    net = net.to(device).eval().requires_grad_(False)
    return StyleModel(arch, net, io_preset or preset, f"random_{arch}")


def _input_size(out: torch.Tensor, x01: torch.Tensor) -> torch.Tensor:
    """``out`` resized to ``x01``'s size, where it differs (the resize in
    f32, rounded back to out's dtype: the CPU has no bf16 antialias)."""
    if out.shape[1:3] != x01.shape[1:3]:
        out = resize_bilinear(out.float(), (x01.shape[1], x01.shape[2])).to(out.dtype)
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


def _pad_call(run, forward, io_preset: str, x: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    """``run(forward, io_preset, x)`` with x reflect-padded at the bottom and
    right to multiples of (mh, mw), cropped back."""
    H, W = x.shape[1], x.shape[2]
    ph, pw = (-H) % mh, (-W) % mw
    if ph or pw:
        return run(forward, io_preset, _reflect_pad(x, ph, pw))[:, :H, :W]
    return run(forward, io_preset, x)


def _calibration_input(model: StyleModel, x01: torch.Tensor) -> torch.Tensor:
    """The first frame, f32, reflect-padded to multiples of 4, preprocessed."""
    xc = x01[:1].float()
    xc = _reflect_pad(xc, (-xc.shape[1]) % 4, (-xc.shape[2]) % 4)
    return iop.preprocess(model.io_preset, xc)


def _to(obj, device):
    """A calibration's products (dicts, lists and tuples of tensors, numpy
    arrays and numbers) with every tensor moved to ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, device) for v in obj)
    return obj


def _measure(model: StyleModel, quantize: str, x01: torch.Tensor, fused_sites=None) -> dict:
    """A Johnson slot's calibration on the first frame of ``x01`` (f32, the
    f32 weights, padded to a multiple of 4 only): the frozen norms of the
    static modes, and in the int8 modes the fused-site set and the
    quantized sites (``quant``, with deconv3's baked weights where the set
    makes it an int8 site)."""
    xin = _calibration_input(model, x01)
    stats = None
    if quantize in ("bf16_static", "int8_static"):
        stats = tq.calibrate_in_stats(model.net, xin)
    if quantize == "bf16_static":
        print(f"[stylizer] static-norm bf16 path calibrated for {model.name} "
              f"({len(stats)} frozen norms)")
        return {"stats": stats}
    fused = tq.check_fused_sites(tq.default_sites(stats is not None) if fused_sites is None
                                 else fused_sites)
    scales = tq.calibrate_act_scales(model.net, xin, sites=tq.QUANT_SITES_PALLAS,
                                     static_stats=stats)
    scales = tq.site_filter(scales, xin.shape[1], xin.shape[2], fused)
    quant = tq.quantize_net(model.net, scales, io_preset=model.io_preset)
    d3 = tq.baked_d3(model.net, model.io_preset) if "d3" in quant else None
    print(f"[stylizer] {quantize} path calibrated for {model.name} ({len(quant)} int8 sites, "
          f"fused {fused}" + (f", {len(stats)} frozen norms)" if stats else ")"))
    return {"stats": stats, "fused": fused, "quant": quant, "d3": d3}


def _bind(net: TransformerNet, quantize: str, cal: dict, device, fused_sites=None, sw=None):
    """The forward of ``quantize`` from a calibration (``_measure``) on the
    net ``net`` (the slot's weights in the compute dtype on ``device``),
    its int8 sites prepared there, and whether its output carries the post
    affine. ``sw``: the bf16 sites' weights, where the set names one."""
    stats = cal["stats"]
    if quantize == "bf16_static":
        return (lambda t: net(t, static_stats=stats, fused_sites=fused_sites or (),
                              site_weights=sw)), False
    sites = sites_i8.prepare_sites(net, cal["quant"], device, d3=cal["d3"])
    fused = cal["fused"]
    return (lambda t: tq.forward_int8(net, t, sites, stats, fused_sites=fused,
                                      site_weights=sw)), cal["d3"] is not None


def _net_device(model: StyleModel) -> torch.device:
    """Where a slot's weights live."""
    if model.arch == "t7":
        from ..io.t7 import layers_device

        return layers_device(model.net)
    return next(model.net.parameters()).device


def _replica(model: StyleModel, device: torch.device) -> StyleModel:
    """The slot with its f32 weights copied to ``device``."""
    if model.arch == "t7":
        from ..io.t7 import layers_to

        return StyleModel("t7", layers_to(model.net, device, torch.float32), model.io_preset,
                          model.name)
    return StyleModel(model.arch, copy.deepcopy(model.net).to(device), model.io_preset,
                      model.name)


def jit_stylizer(model: StyleModel, *, dtype: torch.dtype = torch.float32,
                 quantize: str = "none", fused_sites=None, mesh=None):
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
    mode calibrates lazily on the first frame of the first batch.

    ``mesh`` (``parallel/mesh.Mesh``): the batch splits across its shards
    (``shard_stylizer``); the slot's weights live on the mesh's primary
    device and are copied once to each other distinct device.
    A quantize mode calibrates once, on the global batch's first frame on
    the primary device, and every replica binds those same scales and
    statistics, its int8 sites prepared on its own device (JAX calibrates
    once on the global batch too). A magenta slot stays unsharded on the
    primary device, as in JAX: its batch axis is tiles, not frames."""
    if quantize not in QUANTIZE_MODES:
        raise ValueError(f"quantize {quantize!r} not in {QUANTIZE_MODES}")
    if mesh is None or model.arch == "magenta":
        return _stylizer(model, dtype, quantize, fused_sites)
    from ..parallel.mesh import on_device, shard_stylizer

    cal: dict = {}
    fns = {d: _stylizer(model if d == mesh.primary else _replica(model, d), dtype, quantize,
                        fused_sites, calib=lambda d=d: _to(cal["products"], d))
           for d in mesh.distinct()}
    run = shard_stylizer(fns, mesh)
    measure = fns[mesh.primary].measure

    @torch.no_grad()
    def fn(x01: torch.Tensor) -> torch.Tensor:
        if measure is not None and "products" not in cal:
            with on_device(mesh.primary):
                cal["products"] = measure(x01.to(mesh.primary))
        return run(x01)

    return fn


def _stylizer(model: StyleModel, dtype: torch.dtype, quantize: str, fused_sites,
              calib=None):
    """``jit_stylizer`` on one device: the slot's stylize function, with
    ``fn.measure(x01)`` its calibration (None where the mode has none).
    ``calib``: where a replica takes its calibration from instead of
    measuring its own first frame (``calib()`` → the products on its
    device)."""
    if model.arch == "magenta":
        fn = _magenta_stylizer(model)
        fn.measure = None
        return fn
    if model.arch == "nst":
        return _nst_stylizer(model, dtype, quantize, fused_sites, calib)
    if model.arch == "reconet":
        return _reco_stylizer(model, dtype, quantize, fused_sites, calib)
    if model.arch == "t7":
        return _t7_stylizer(model, dtype, quantize, fused_sites, calib)
    if fused_sites is not None:
        unknown = sorted(set(fused_sites) - set(tq.FUSED_SITE_NAMES))
        if unknown:
            raise ValueError(f"unknown fused sites {unknown}; known: {tq.FUSED_SITE_NAMES}")
    bf16_sites = set(fused_sites or ()) & set(sites_bf16.BF16_SITE_NAMES)
    if bf16_sites and dtype != torch.bfloat16:
        raise NotImplementedError(
            f"fused sites {sorted(bf16_sites)} run under bfloat16 only: ROADMAP.md Queue 2, "
            "row 3 (the float32 forms)")
    net = model.net if dtype == torch.float32 else copy.deepcopy(model.net).to(dtype)
    dev = _net_device(model)
    sw = None
    if bf16_sites:
        sw = sites_bf16.prepare(model.net, dev)

    def plain(t):
        return net(t, fused_sites=fused_sites or (), site_weights=sw)

    state = {"forward": plain if quantize == "none" else None, "baked": False}
    int8 = quantize in ("int8_static", "int8")

    def measure(x01):
        return _measure(model, quantize, x01, fused_sites)

    @torch.no_grad()
    def fn(x01: torch.Tensor) -> torch.Tensor:
        if state["forward"] is None:
            cal = calib() if calib is not None else measure(x01)
            state["forward"], state["baked"] = _bind(net, quantize, cal, dev, fused_sites, sw)
        x = x01.to(dtype)
        H, W = x.shape[1], x.shape[2]
        run = stylize_baked if state["baked"] else stylize
        if H < 8 or W < 8:
            return run(state["forward"], model.io_preset, x).float()
        mh, mw = (8, 32) if int8 and H >= 32 and W >= 64 else (4, 4)
        return _pad_call(run, state["forward"], model.io_preset, x, mh, mw).float()

    fn.measure = None if quantize == "none" else measure
    return fn


def _nst_stylizer(model: StyleModel, dtype: torch.dtype, quantize: str, fused_sites,
                  calib=None):
    """``jit_stylizer`` for an NST slot (JAX ``jit_stylizer`` with
    ``nst_fast_params``): the fast form at sizes padded to multiples of 4
    (8 × 32 under int8 once H ≥ 32 and W ≥ 64), the exact net below 8
    pixels. A quantize mode calibrates on the first frame (f32 net, padded
    to multiples of 4): frozen norms (``calibrate_in_stats``) for the static
    modes, activation scales and int8 res weights for the int8 ones, routed
    by the adopted ``nst_static`` / ``nst`` set or ``fused_sites``.
    ``calib``: as ``_stylizer``'s."""
    from .. import adopt_overrides

    net = model.net if dtype == torch.float32 else copy.deepcopy(model.net).to(dtype)
    dev = _net_device(model)
    fused = None if fused_sites is None else tuple(fused_sites)
    state = {"forward": (lambda t: nstf.apply(net, t)) if quantize == "none" else None}

    def measure(x01):
        xin = _calibration_input(model, x01)
        stats = None
        if quantize in ("bf16_static", "int8_static"):
            stats = nstf.calibrate_in_stats(model.net, xin)
        if quantize == "bf16_static":
            print(f"[stylizer] static-norm bf16 nst path calibrated for {model.name} "
                  f"({len(stats)} frozen norms)")
            return {"stats": stats}
        quant = nstf.quantize_net(model.net, nstf.calibrate_act_scales(model.net, xin,
                                                                        static_stats=stats))
        sset = adopt_overrides.sites("nst_static" if stats else "nst") if fused is None else fused
        print(f"[stylizer] {quantize} nst path calibrated for {model.name} ({len(quant)} int8 "
              f"sites, fused {sset})")
        return {"stats": stats, "quant": quant, "sset": sset}

    def bind(cal):
        stats = cal["stats"]
        if quantize == "bf16_static":
            return lambda t: nstf.apply(net, t, static_stats=stats)
        sites, sset = nstf.prepare_sites(net, cal["quant"], dev), cal["sset"]
        return lambda t: nstf.apply(net, t, sites=sites, fused_sites=sset, static_stats=stats)

    @torch.no_grad()
    def fn(x01: torch.Tensor) -> torch.Tensor:
        if state["forward"] is None:
            state["forward"] = bind(calib() if calib is not None else measure(x01))
        x = x01.to(dtype)
        H, W = x.shape[1], x.shape[2]
        if H < 8 or W < 8:
            return stylize(net, model.io_preset, x).float()
        big = quantize in ("int8_static", "int8") and H >= 32 and W >= 64
        return _pad_call(stylize, state["forward"], model.io_preset, x,
                         *((8, 32) if big else (4, 4))).float()

    fn.measure = None if quantize == "none" else measure
    return fn


def _reco_stylizer(model: StyleModel, dtype: torch.dtype, quantize: str, fused_sites,
                   calib=None):
    """``jit_stylizer`` for a ReCoNet slot (JAX ``jit_stylizer`` with
    ``reco_fast_params``): the fast form (``reconet_fast.FastReCoNet`` of the
    f32 net, cast to ``dtype`` after the f32 phase sums) at sizes padded to
    multiples of 4 (8 × 32 under int8 once H ≥ 32 and W ≥ 64), the pixel net
    below 8 pixels. A quantize mode calibrates on the first frame (the f32
    fast form, padded to multiples of 4): frozen norms
    (``calibrate_in_stats``) for the static modes, activation scales and int8
    res and decoder weights for the int8 ones, routed by the adopted
    ``reco_static`` / ``reco`` set or ``fused_sites``. ``calib``: as
    ``_stylizer``'s."""
    from .. import adopt_overrides

    fp32 = rf.FastReCoNet(model.net)
    fp = fp32 if dtype == torch.float32 else copy.deepcopy(fp32).to(dtype)
    dev = _net_device(model)
    fused = None if fused_sites is None else tuple(fused_sites)
    state = {"forward": (lambda t: rf.apply(fp, t)) if quantize == "none" else None}

    def measure(x01):
        xin = _calibration_input(model, x01)
        stats = None
        if quantize in ("bf16_static", "int8_static"):
            stats = rf.calibrate_in_stats(fp32, xin)
        if quantize == "bf16_static":
            print(f"[stylizer] static-norm bf16 reconet path calibrated for {model.name} "
                  f"({len(stats)} frozen norms)")
            return {"stats": stats}
        quant = rf.quantize_net(fp32, rf.calibrate_act_scales(fp32, xin, static_stats=stats))
        sset = adopt_overrides.sites("reco_static" if stats else "reco") if fused is None else fused
        print(f"[stylizer] {quantize} reconet path calibrated for {model.name} ({len(quant)} "
              f"int8 sites, fused {sset})")
        return {"stats": stats, "quant": quant, "sset": sset}

    def bind(cal):
        stats = cal["stats"]
        if quantize == "bf16_static":
            return lambda t: rf.apply(fp, t, static_stats=stats)
        sites, sset = rf.prepare_sites(fp, cal["quant"], dev), cal["sset"]
        return lambda t: rf.apply(fp, t, sites=sites, fused_sites=sset, static_stats=stats)

    @torch.no_grad()
    def fn(x01: torch.Tensor) -> torch.Tensor:
        if state["forward"] is None:
            state["forward"] = bind(calib() if calib is not None else measure(x01))
        x = x01.to(dtype)
        H, W = x.shape[1], x.shape[2]
        if H < 8 or W < 8:
            return stylize(fp.net, model.io_preset, x).float()
        big = quantize in ("int8_static", "int8") and H >= 32 and W >= 64
        return _pad_call(stylize, state["forward"], model.io_preset, x,
                         *((8, 32) if big else (4, 4))).float()

    fn.measure = None if quantize == "none" else measure
    return fn


def _t7_stylizer(model: StyleModel, dtype: torch.dtype, quantize: str, fused_sites,
                 calib=None):
    """``jit_stylizer`` for a Torch7 slot (JAX ``jit_stylizer`` with
    ``t7_fast_params``): the fast form (``t7_fast.try_fast_johnson`` of the
    f32 layers, cast to ``dtype``) at sizes padded to multiples of 4 (8 × 32
    under int8 once H ≥ 32 and W ≥ 64), the exact executor below 8 pixels or
    for a graph that does not match. A quantize mode calibrates on the first
    frame (the f32 fast form, padded to multiples of 4). The static modes on
    an instance-norm graph freeze its norms (``calibrate_t7_in_stats``) and
    fold them into the weights (``fold_static_in``); int8_static then
    quantizes the folded graph, which takes the ``t7_bn`` set. A BN-folded
    graph has no norm to freeze: int8_static runs as int8 and bf16_static as
    no quantize, with the JAX engine's warning. int8 quantizes the graph
    (``calibrate_t7_scales``, ``quantize_t7``), routed by the adopted ``t7``
    (instance norms) or ``t7_bn`` (BN-folded) set, or ``fused_sites``.
    ``calib``: as ``_stylizer``'s."""
    from .. import adopt_overrides
    from ..io import t7_fast as t7f
    from ..io.t7 import layers_device, layers_to, t7_apply

    dev = layers_device(model.net)
    layers = model.net if dtype == torch.float32 else layers_to(model.net, dev, dtype)
    p32 = t7f.try_fast_johnson(model.net)
    p = None
    if p32 is not None:
        p32 = t7f.params_to(p32, dev)
        p = p32 if dtype == torch.float32 else t7f.params_to(p32, dev, dtype)
        print(f"[stylizer] t7 fast path active for {model.name}")
    deferred = p32 is not None and t7f.has_deferred_norms(p32)
    if quantize in ("bf16_static", "int8_static") and not deferred:
        # the JAX engine's fallback: nothing to freeze (BN-folded, or no fast form)
        print(f"[stylizer][WARN] --quantize {quantize}: {model.name} (t7) has no freezable "
              f"runtime norms; falls back to "
              f"{'int8' if quantize == 'int8_static' else 'the exact path'}.")
        quantize = "int8" if quantize == "int8_static" else "none"
    if quantize == "int8" and p32 is None:
        print(f"[stylizer][WARN] --quantize int8 needs a supported fast path (Johnson s2d2 / "
              f".t7 / NST / ReCoNet); {model.name} (t7) stays "
              f"{'bf16' if dtype != torch.float32 else 'f32'}.")
        quantize = "none"
    fused = None if fused_sites is None else tuple(fused_sites)

    def exact(t):
        return t7_apply(layers, t)

    def fast(params, sites=None, sset=()):
        return lambda t: t7f.t7_fast_apply(params, t, sites=sites, fused_sites=sset)

    def measure(x01):
        xin = _calibration_input(model, x01)
        if quantize in ("bf16_static", "int8_static"):
            stats = t7f.calibrate_t7_in_stats(p32, xin)
            quant, sset = None, ()
            if quantize == "int8_static":
                folded32 = t7f.fold_static_in(p32, stats)
                quant = t7f.quantize_t7(folded32, t7f.calibrate_t7_scales(folded32, xin))
                sset = adopt_overrides.sites("t7_bn") if fused is None else fused
            print(f"[stylizer] static-norm {'int8' if quant else 'bf16'} .t7 path folded for "
                  f"{model.name} ({len(stats)} frozen norms" + (f", fused {sset})" if quant
                                                               else ")"))
            return {"stats": stats, "quant": quant, "sset": sset}
        quant = t7f.quantize_t7(p32, t7f.calibrate_t7_scales(p32, xin))
        sset = adopt_overrides.sites("t7" if deferred else "t7_bn") if fused is None else fused
        print(f"[stylizer] int8 t7 path calibrated for {model.name} ({len(quant)} sites, "
              f"fused {sset})")
        return {"stats": None, "quant": quant, "sset": sset}

    def bind(cal):
        """The static modes fold the frozen norms into this slot's own f32
        weights, then cast; the quantized sites go to its device."""
        params = p
        if cal["stats"] is not None:
            folded32 = t7f.fold_static_in(p32, cal["stats"])
            params = folded32 if dtype == torch.float32 else t7f.params_to(folded32, dev, dtype)
        sites = None if cal["quant"] is None else t7f.prepare_sites(params, cal["quant"], dev)
        return fast(params, sites, cal["sset"])

    state = {"forward": None}
    if quantize == "none":
        state["forward"] = exact if p is None else fast(p)
    big_pad = quantize in ("int8", "int8_static")

    @torch.no_grad()
    def fn(x01: torch.Tensor) -> torch.Tensor:
        if state["forward"] is None:
            state["forward"] = bind(calib() if calib is not None else measure(x01))
        x = x01.to(dtype)
        H, W = x.shape[1], x.shape[2]
        if p is None or H < 8 or W < 8:
            return stylize(exact, model.io_preset, x).float()
        mh, mw = (8, 32) if big_pad and H >= 32 and W >= 64 else (4, 4)
        return _pad_call(stylize, state["forward"], model.io_preset, x, mh, mw).float()

    fn.measure = measure if state["forward"] is None else None
    return fn


def _magenta_stylizer(model: StyleModel):
    """``jit_stylizer`` for a magenta slot (JAX ``_jit_magenta_stylizer``):
    the optional ``--magenta_target_res`` downscale (long side, ``int(H·r)``),
    the tiled transfer of the whole frame batch (``models/magenta.
    stylize_tiled_batch``), the resize back, f32 out. It takes neither the
    compute dtype nor a quantize mode: the JAX engine dispatches a magenta
    slot before either applies."""
    from ..models.magenta import stylize_tiled_batch

    p = model.net

    @torch.no_grad()
    def fn(x01: torch.Tensor) -> torch.Tensor:
        H, W = x01.shape[1], x01.shape[2]
        work = x01.float()
        if p.target_res and max(H, W) > p.target_res:
            r = p.target_res / max(H, W)
            work = resize_bilinear(work, (int(H * r), int(W * r)))
        y = stylize_tiled_batch(None, work, p.style01, tile_size=p.tile, overlap=p.overlap,
                                transfer_fn=p.transfer_fn)
        if y.shape[1:3] != (H, W):
            y = resize_bilinear(y, (H, W))
        return y.float()

    return fn


def stack_models(models: list[StyleModel]) -> StyleModel:
    """Same-arch, same-preset slots as one bank ``bank[M]`` (its ``net`` the
    ``nn.ModuleList`` of the M nets, in order); mixed arch or preset raise
    the JAX engine's ValueError."""
    archs = {m.arch for m in models}
    presets = {m.io_preset for m in models}
    if len(archs) != 1 or len(presets) != 1:
        raise ValueError(f"stack_models needs uniform arch/preset, got {archs}/{presets}")
    return StyleModel(models[0].arch, torch.nn.ModuleList([m.net for m in models]),
                      models[0].io_preset, f"bank[{len(models)}]")


def jit_ladder_stylizer(models: list[StyleModel], *, dtype: torch.dtype = torch.float32,
                        optimize: bool = True):
    """One call styling a batch with every model of a same-arch bank (the
    style_all_weights weight-ladder workload, BASELINE config #2):
    f(x01 NHWC f32) → [M, N, H, W, C] f32.

    The bank runs as a loop over its M nets inside the call, each net's
    forward on the whole batch. A ``vmap`` over stacked weights, which
    turns every conv into a grouped one, took 1.5% longer at 8.5× the
    memory for the bench's 8-slot bf16 bank on an H100
    (``chip_ladder_ab.py``). The two branches are the JAX engine's: a
    Johnson bank with ``optimize`` at H, W ≥ 8 reflect-pads the bottom and
    right to multiples of 4, runs preprocess → net → postprocess (the
    function of JAX's IO-baked fast form; postprocess clips to [0, 1]) and
    crops; otherwise each model runs the plain ``stylize`` in ``dtype``
    (resized back to the input size where the net changed it), not
    clipped again."""
    bank = stack_models(models)
    arch, preset = bank.arch, bank.io_preset
    if arch not in ("johnson", "nst", "reconet"):
        raise NotImplementedError(f"jit_ladder_stylizer: a {arch} bank (the ladder's banks are "
                                  "Johnson, NST_Train or ReCoNet)")
    nets = [n if dtype == torch.float32 else copy.deepcopy(n).to(dtype) for n in bank.net]

    @torch.no_grad()
    def fn(x01: torch.Tensor) -> torch.Tensor:
        x = x01.to(dtype)
        H, W = x.shape[1], x.shape[2]
        if optimize and arch == "johnson" and H >= 8 and W >= 8:
            xp = _reflect_pad(x, (-H) % 4, (-W) % 4)
            outs = [stylize(net, preset, xp)[:, :H, :W] for net in nets]  # clipped
        else:
            outs = [stylize(net, preset, x) for net in nets]
        return torch.stack(outs, 0).float()

    return fn


def blend_outputs(outputs: list[torch.Tensor], weights: list[float]) -> torch.Tensor:
    """RGB weighted blend of stylized batches, the weights normalized to sum
    to 1, clipped to [0, 1]."""
    total = sum(weights)
    acc = outputs[0] * (weights[0] / total)
    for o, w in zip(outputs[1:], weights[1:]):
        acc = acc + o * (w / total)
    return acc.clamp(0.0, 1.0)
