"""DeepLabV3+ backbones besides ResNet-101: MobileNetV2, AlignedXception,
DRN-D-54.

Counterpart of ``neuralstyletransferv1_tpu/models/deeplab_backbones.py``,
NCHW on channels-last tensors, the module tree in the JAX param tree's
layout (``deeplab.Conv`` / ``deeplab.BN`` leaves). What each keeps of the
reference:

- MobileNetV2: inverted residuals with the TF-style ``_fixed_pad`` applied
  to the block input before its first conv, the 1×1 expansion included
  (the padded border becomes ``relu6(bn(0))``, not zero, as in the
  reference and JAX); ReLU6; depthwise convs; the low-level feature after
  the stem and three blocks; the stride/dilation schedule by output stride.
- AlignedXception: separable convs (``_fixed_pad``, depthwise VALID, BN,
  pointwise), entry/middle/exit blocks with skip convs, the extra ReLU after
  block 1 feeding the low-level feature.
- DRN-D-54: conv layers 0–2, bottleneck layers 3–6 (dilation 2 and 4 at
  levels 5 and 6), conv layers 7–8; the low-level feature after layer 3;
  the DeepLab wrapper forces output stride 8.

``IMPORTERS`` map the reference state-dict names (``nn.Sequential``
indices included) into the tree; ``SPECS`` give each backbone's conv and
BN shapes for ``deeplab.init_state_dict``.
"""

from __future__ import annotations

import torch.nn.functional as F

from .deeplab import _bnp, _cv

# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _fixed_pad(x, k, dilation=1):
    """TF-style asymmetric zero pad of NCHW."""
    total = k + (k - 1) * (dilation - 1) - 1
    beg = total // 2
    return F.pad(x, (beg, total - beg, beg, total - beg))


def _relu6(x):
    return x.clamp(0.0, 6.0)


# ---------------------------------------------------------------------------
# MobileNetV2
# ---------------------------------------------------------------------------

_MBV2_SETTING = [  # t, c, n, s
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


def _mbv2_schedule(output_stride, c=int):
    """Per block (stride, dilation, expand, cin, cout), the reference
    constructor's current_stride / rate logic; ``c`` narrows the widths."""
    feats = []
    current_stride, rate, cin = 2, 1, c(32)  # after the stem
    for t, ch, n, s in _MBV2_SETTING:
        if current_stride == output_stride:
            stride, dilation = 1, rate
            rate *= s
        else:
            stride, dilation = s, 1
            current_stride *= s
        for i in range(n):
            feats.append((stride if i == 0 else 1, dilation, t, cin, c(ch)))
            cin = c(ch)
    return feats


def _inverted_residual(x, p, *, stride, dilation, expand):
    x_pad = _fixed_pad(x, 3, dilation)  # before the expansion conv, as the reference
    cin = x.shape[1]
    if expand == 1:
        y = p["dw"](x_pad, stride=stride, dilation=dilation, groups=cin)
    else:
        y = _relu6(p["exp_bn"](p["exp"](x_pad)))
        y = p["dw"](y, stride=stride, dilation=dilation, groups=y.shape[1])
    y = _relu6(p["dw_bn"](y))
    y = p["pw_bn"](p["pw"](y))
    if stride == 1 and y.shape[1] == cin:
        y = x + y
    return y


def backbone_mobilenet(p, x, *, output_stride=16):
    y = _relu6(p["stem_bn"](p["stem"](x, stride=2, padding=1)))
    low = None
    for i, (stride, dilation, expand, _ci, _co) in enumerate(_mbv2_schedule(output_stride)):
        y = _inverted_residual(y, p["blocks"][i], stride=stride, dilation=dilation, expand=expand)
        if i == 2:  # features[0:4]: the stem and three blocks
            low = y
    return y, low


def import_mobilenet(sd) -> dict:
    blocks = []
    for i, (_s, _d, expand, _ci, _co) in enumerate(_mbv2_schedule(16)):
        pre = f"backbone.features.{i + 1}.conv"
        if expand == 1:
            blocks.append({"dw": _cv(sd, f"{pre}.0"), "dw_bn": _bnp(sd, f"{pre}.1"),
                           "pw": _cv(sd, f"{pre}.3"), "pw_bn": _bnp(sd, f"{pre}.4")})
        else:
            blocks.append({"exp": _cv(sd, f"{pre}.0"), "exp_bn": _bnp(sd, f"{pre}.1"),
                           "dw": _cv(sd, f"{pre}.3"), "dw_bn": _bnp(sd, f"{pre}.4"),
                           "pw": _cv(sd, f"{pre}.6"), "pw_bn": _bnp(sd, f"{pre}.7")})
    return {"stem": _cv(sd, "backbone.features.0.0"), "stem_bn": _bnp(sd, "backbone.features.0.1"),
            "blocks": blocks}


def _mobilenet_spec(c):
    spec = [("backbone.features.0.0", ("conv", c(32), 3, 3)),
            ("backbone.features.0.1", ("bn", c(32)))]
    for i, (_s, _d, t, cin, cout) in enumerate(_mbv2_schedule(16, c)):
        pre = f"backbone.features.{i + 1}.conv"
        hidden = round(cin * t)
        j = 0
        if t != 1:
            spec += [(f"{pre}.0", ("conv", hidden, cin, 1)), (f"{pre}.1", ("bn", hidden))]
            j = 3
        spec += [(f"{pre}.{j}", ("conv", hidden, 1, 3)), (f"{pre}.{j + 1}", ("bn", hidden)),
                 (f"{pre}.{j + 3}", ("conv", cout, hidden, 1)), (f"{pre}.{j + 4}", ("bn", cout))]
    return spec, (c(320), c(24))


# ---------------------------------------------------------------------------
# AlignedXception
# ---------------------------------------------------------------------------


def _sep_conv(x, p, *, stride=1, dilation=1):
    """SeparableConv2d: fixed pad → depthwise VALID → BN → pointwise."""
    y = _fixed_pad(x, 3, dilation)
    y = p["bn"](p["conv1"](y, stride=stride, dilation=dilation, groups=x.shape[1]))
    return p["pointwise"](y)


def _xception_block_spec(reps, stride, grow_first, is_last, start_with_relu):
    """The block's ``rep`` Sequential module by module — ('relu',),
    ('sep', stride, dilated), ('bn',) — so list positions are the
    Sequential's indices."""
    ops = []

    def sep(s, use_dil):
        ops.extend([("relu",), ("sep", s, use_dil), ("bn",)])

    if grow_first:
        sep(1, True)
    for _ in range(reps - 1):
        sep(1, True)
    if not grow_first:
        sep(1, True)
    if stride != 1:
        sep(2, False)
    if stride == 1 and is_last:
        sep(1, False)
    return ops if start_with_relu else ops[1:]


def _xception_layout(output_stride):
    """(name, reps, stride, dilation, start_with_relu, grow_first, is_last)
    of the 20 blocks, and the exit flow's dilations."""
    if output_stride == 16:
        entry3, mid_dil, exit_dil = 2, 1, (1, 2)
    elif output_stride == 8:
        entry3, mid_dil, exit_dil = 1, 2, (2, 4)
    else:
        raise NotImplementedError(output_stride)
    blocks = [("block1", 2, 2, 1, False, True, False), ("block2", 2, 2, 1, False, True, False),
              ("block3", 2, entry3, 1, True, True, True)]
    blocks += [(f"block{i}", 3, 1, mid_dil, True, True, False) for i in range(4, 20)]
    blocks.append(("block20", 2, 1, exit_dil[0], True, False, True))
    return blocks, exit_dil


def backbone_xception(p, x, *, output_stride=16):
    y = F.relu(p["bn1"](p["conv1"](x, stride=2, padding=1)))
    y = F.relu(p["bn2"](p["conv2"](y, padding=1)))
    blocks, exit_dil = _xception_layout(output_stride)
    low = None
    for name, reps, stride, dilation, swr, grow, is_last in blocks:
        b = p[name]
        inp, si = y, 0
        for op in _xception_block_spec(reps, stride, grow, is_last, swr):
            if op[0] == "relu":
                y = F.relu(y)
            elif op[0] == "sep":
                y = _sep_conv(y, b["seps"][si], stride=op[1], dilation=dilation if op[2] else 1)
            else:  # the Sequential's own BN after each separable conv
                y = b["sep_bns"][si](y)
                si += 1
        y = y + (b["skipbn"](b["skip"](inp, stride=stride)) if "skip" in b else inp)
        if name == "block1":
            y = F.relu(y)  # the reference's extra ReLU; the low-level feature
            low = y
    y = F.relu(y)
    for i in (3, 4, 5):
        y = F.relu(p[f"bn{i}"](_sep_conv(y, p[f"conv{i}"], dilation=exit_dil[1])))
    return y, low


def _sep_params(sd, key):
    return {"conv1": _cv(sd, f"{key}.conv1"), "bn": _bnp(sd, f"{key}.bn"),
            "pointwise": _cv(sd, f"{key}.pointwise")}


def import_xception(sd, *, output_stride=16) -> dict:
    out = {"conv1": _cv(sd, "backbone.conv1"), "bn1": _bnp(sd, "backbone.bn1"),
           "conv2": _cv(sd, "backbone.conv2"), "bn2": _bnp(sd, "backbone.bn2")}
    for i in (3, 4, 5):
        out[f"conv{i}"] = _sep_params(sd, f"backbone.conv{i}")
        out[f"bn{i}"] = _bnp(sd, f"backbone.bn{i}")
    blocks, _ = _xception_layout(output_stride)
    for name, reps, stride, _dil, swr, grow, is_last in blocks:
        pre = f"backbone.{name}"
        seps, sep_bns = [], []
        for idx, op in enumerate(_xception_block_spec(reps, stride, grow, is_last, swr)):
            if op[0] == "sep":
                seps.append(_sep_params(sd, f"{pre}.rep.{idx}"))
            elif op[0] == "bn":
                sep_bns.append(_bnp(sd, f"{pre}.rep.{idx}"))
        blk = {"seps": seps, "sep_bns": sep_bns}
        if f"{pre}.skip.weight" in sd:
            blk["skip"], blk["skipbn"] = _cv(sd, f"{pre}.skip"), _bnp(sd, f"{pre}.skipbn")
        out[name] = blk
    return out


def _xception_spec(c):
    def sep(key, ci, co):
        return [(f"{key}.conv1", ("conv", ci, 1, 3)), (f"{key}.bn", ("bn", ci)),
                (f"{key}.pointwise", ("conv", co, ci, 1))]

    spec = [("backbone.conv1", ("conv", c(32), 3, 3)), ("backbone.bn1", ("bn", c(32))),
            ("backbone.conv2", ("conv", c(64), c(32), 3)), ("backbone.bn2", ("bn", c(64)))]
    chans = {"block1": (64, 128), "block2": (128, 256), "block3": (256, 728), "block20": (728, 1024)}
    for name, reps, stride, _dil, swr, grow, is_last in _xception_layout(16)[0]:
        inplanes, planes = (c(n) for n in chans.get(name, (728, 728)))
        pre = f"backbone.{name}"
        # each sep's (cin, cout) in the reference Block's order
        io = [(inplanes, planes)] if grow else []
        io += [(planes if grow else inplanes,) * 2] * (reps - 1)
        io += [] if grow else [(inplanes, planes)]
        io += [(planes, planes)] if stride != 1 or is_last else []
        seps = iter(io)
        for idx, op in enumerate(_xception_block_spec(reps, stride, grow, is_last, swr)):
            if op[0] == "sep":
                ci, co = next(seps)
                spec += sep(f"{pre}.rep.{idx}", ci, co)
                last = co
            elif op[0] == "bn":
                spec.append((f"{pre}.rep.{idx}", ("bn", last)))
        if planes != inplanes or stride != 1:
            spec += [(f"{pre}.skip", ("conv", planes, inplanes, 1)), (f"{pre}.skipbn", ("bn", planes))]
    for i, (ci, co) in zip((3, 4, 5), ((1024, 1536), (1536, 1536), (1536, 2048))):
        spec += sep(f"backbone.conv{i}", c(ci), c(co)) + [(f"backbone.bn{i}", ("bn", c(co)))]
    return spec, (c(2048), c(128))


# ---------------------------------------------------------------------------
# DRN-D-54
# ---------------------------------------------------------------------------

_DRN54_BLOCKS = {3: 3, 4: 4, 5: 6, 6: 3}
_DRN_CHANNELS = [16, 32, 64, 128, 256, 512, 512, 512]


def _drn_bottleneck(x, p, *, stride=1, dilation=(1, 1)):
    residual = x
    y = F.relu(p["bn1"](p["conv1"](x)))
    y = F.relu(p["bn2"](p["conv2"](y, stride=stride, padding=dilation[1], dilation=dilation[1])))
    y = p["bn3"](p["conv3"](y))
    if "downsample" in p:
        residual = p["downsample"]["bn"](p["downsample"]["conv"](x, stride=stride))
    return F.relu(y + residual)


def backbone_drn(p, x, *, output_stride=8):
    """DRN-D-54 trunk (the wrapper forces output stride 8; the trunk is fixed)."""
    y = F.relu(p["layer0"]["bn"](p["layer0"]["conv"](x, padding=3)))
    y = F.relu(p["layer1"]["bn"](p["layer1"]["conv"](y, padding=1)))
    y = F.relu(p["layer2"]["bn"](p["layer2"]["conv"](y, stride=2, padding=1)))
    dil_cfg = {3: (1, 1), 4: (1, 1), 5: (2, 2), 6: (4, 4)}
    stride_cfg = {3: 2, 4: 2, 5: 1, 6: 1}
    low = None
    for li in (3, 4, 5, 6):
        for bi, blk in enumerate(p[f"layer{li}"]):
            y = _drn_bottleneck(y, blk, stride=stride_cfg[li] if bi == 0 else 1, dilation=dil_cfg[li])
        if li == 3:
            low = y
    y = F.relu(p["layer7"]["bn"](p["layer7"]["conv"](y, padding=2, dilation=2)))
    y = F.relu(p["layer8"]["bn"](p["layer8"]["conv"](y, padding=1)))
    return y, low


def import_drn(sd) -> dict:
    out = {name: {"conv": _cv(sd, f"backbone.{name}.0"), "bn": _bnp(sd, f"backbone.{name}.1")}
           for name in ("layer0", "layer1", "layer2", "layer7", "layer8")}
    for li, nblocks in _DRN54_BLOCKS.items():
        blocks = []
        for bi in range(nblocks):
            pre = f"backbone.layer{li}.{bi}"
            blk = {"conv1": _cv(sd, f"{pre}.conv1"), "bn1": _bnp(sd, f"{pre}.bn1"),
                   "conv2": _cv(sd, f"{pre}.conv2"), "bn2": _bnp(sd, f"{pre}.bn2"),
                   "conv3": _cv(sd, f"{pre}.conv3"), "bn3": _bnp(sd, f"{pre}.bn3")}
            if f"{pre}.downsample.0.weight" in sd:
                blk["downsample"] = {"conv": _cv(sd, f"{pre}.downsample.0"),
                                     "bn": _bnp(sd, f"{pre}.downsample.1")}
            blocks.append(blk)
        out[f"layer{li}"] = blocks
    return out


def _drn_spec(c):
    ch = [c(n) for n in _DRN_CHANNELS]
    spec = []

    def conv_layer(name, cout, cin, k):
        spec.extend([(f"backbone.{name}.0", ("conv", cout, cin, k)), (f"backbone.{name}.1", ("bn", cout))])

    conv_layer("layer0", ch[0], 3, 7)
    conv_layer("layer1", ch[0], ch[0], 3)
    conv_layer("layer2", ch[1], ch[0], 3)
    inplanes = ch[1]
    for li, nblocks in _DRN54_BLOCKS.items():
        planes = ch[li - 1]
        for bi in range(nblocks):
            pre = f"backbone.layer{li}.{bi}"
            spec += [(f"{pre}.conv1", ("conv", planes, inplanes, 1)), (f"{pre}.bn1", ("bn", planes)),
                     (f"{pre}.conv2", ("conv", planes, planes, 3)), (f"{pre}.bn2", ("bn", planes)),
                     (f"{pre}.conv3", ("conv", planes * 4, planes, 1)), (f"{pre}.bn3", ("bn", planes * 4))]
            if bi == 0:
                spec += [(f"{pre}.downsample.0", ("conv", planes * 4, inplanes, 1)),
                         (f"{pre}.downsample.1", ("bn", planes * 4))]
            inplanes = planes * 4
    conv_layer("layer7", ch[6], inplanes, 3)
    conv_layer("layer8", ch[7], ch[6], 3)
    return spec, (ch[7], ch[2] * 4)


BACKBONE_FNS = {"mobilenet": backbone_mobilenet, "xception": backbone_xception, "drn": backbone_drn}
IMPORTERS = {"mobilenet": import_mobilenet, "xception": import_xception, "drn": import_drn}
SPECS = {"mobilenet": _mobilenet_spec, "xception": _xception_spec, "drn": _drn_spec}
