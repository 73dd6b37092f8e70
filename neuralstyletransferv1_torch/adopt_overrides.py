"""The adopted int8 fused-site sets of the Johnson, NST_Train, ReCoNet and
Torch7 stylizers, and the ReCoNet kernel-form flag ``reco_skip``.

Port of ``neuralstyletransferv1_tpu/adopt_overrides.py``: the sets the
engine runs under ``--quantize int8`` (keys ``sites``, ``nst``, ``reco``)
and ``int8_static`` (``sites_static``, ``nst_static``, ``reco_static``) are
read from ``i8_adopt.json`` beside this module, over the built-in
``DEFAULTS``; a ``.t7`` slot's by its graph: ``t7`` for instance-norm
graphs, ``t7_bn`` for BN-folded ones and for instance-norm graphs folded by
the static-norm modes. A tuple in the JSON replaces the default wholesale
(the file records the full adopted set, not a delta), and an empty one is a
set: every quantized conv in PyTorch int8 ops, no site kernel (the JSON's
``t7_bn`` and ``nst``). ``flag("reco_skip",
env="RECO_SKIP")``: whether ReCoNet's ``res_i8`` chain folds each block's
residual add and post-add activation into the next a-site (K5); an explicit
``RECO_SKIP`` (``1`` on, anything else off) wins over the JSON, which wins
over the default. The port's JSON is a copy of the JAX package's.

The names a set may hold (``models/transformer_net_quant.forward_int8``
routes on them): ``head_i8`` (conv2/conv3 as int8 sites, K8a/K8b),
``res_i8`` (the residual chain, K4/K5), ``res_s8`` (its s8-carry form under
frozen norms, K2/K3), ``dec_i8`` / ``dec_s8`` (deconv1/deconv2, K4 / K2–K3),
``tail_s8`` (deconv2 emits deconv3's codes, K3 + K6) and ``d3_i8``
(deconv3's rows conv, K7). The NST sets route
``models/transformer_net_nst_fast.apply``, the ReCoNet sets
``models/reconet_fast.apply``, the Torch7 sets ``io/t7_fast.t7_fast_apply``.
Without the file every key takes ``DEFAULTS``: NST_Train's ``res_i8`` runs
K4/K5 with ``sw`` (``transformer_net_nst_fast.res_chain_i8``), and every
NST and Torch7 name has its kernels.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

PATH = Path(__file__).with_name("i8_adopt.json")

#: The JAX engine's built-in defaults for the keys the port reads.
DEFAULTS: dict[str, tuple] = {
    "sites": ("res_i8", "dec_i8"),
    "sites_static": ("res_i8", "dec_i8"),
    "nst": ("res_i8",),
    "nst_static": ("res_i8",),
    "reco": ("res_i8",),
    "reco_static": ("res_i8",),
    "t7": ("res_i8",),
    "t7_bn": ("res_i8",),
}
#: the JAX engine's defaults of the kernel-form flags the port reads
FLAGS: dict[str, bool] = {"reco_skip": False}


def _load(path: Path | None = None) -> dict:
    """The adoption file's dict: ``path``, or ``PATH`` as it stands at the
    call (a missing or unreadable file reads as empty: the defaults)."""
    try:
        path = PATH if path is None else path
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
        return d if isinstance(d, dict) else {}
    except (OSError, ValueError):
        return {}


def sites(key: str, path: Path | None = None) -> tuple:
    """Adopted fused-site tuple for ``key`` (``"sites"``, ``"sites_static"``,
    ``"nst"``, ``"nst_static"``, ``"reco"``, ``"reco_static"``, ``"t7"`` or
    ``"t7_bn"``)."""
    if key not in DEFAULTS:
        raise KeyError(f"{key!r}: the port reads only the keys {tuple(DEFAULTS)}")
    v = _load(path).get(key)
    if isinstance(v, (list, tuple)) and all(isinstance(t, str) for t in v):
        return tuple(v)
    return DEFAULTS[key]


def flag(key: str, env: str | None = None, path: Path | None = None) -> bool:
    """Adopted boolean for ``key``; an explicit ``env`` variable wins
    (``"1"`` is on), then the JSON, then ``FLAGS``."""
    if key not in FLAGS:
        raise KeyError(f"{key!r}: the port reads only the flags {tuple(FLAGS)}")
    if env is not None and env in os.environ:
        return os.environ[env] == "1"
    v = _load(path).get(key)
    return v if isinstance(v, bool) else FLAGS[key]
