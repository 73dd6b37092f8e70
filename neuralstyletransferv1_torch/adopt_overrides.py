"""The adopted int8 fused-site sets of the Johnson stylizer.

Port of the ``sites()`` part of ``neuralstyletransferv1_tpu/
adopt_overrides.py``: the sets the engine runs under ``--quantize int8``
(key ``sites``) and ``int8_static`` (key ``sites_static``) are read from
``i8_adopt.json`` beside this module, over the built-in ``DEFAULTS``. A
tuple in the JSON replaces the default wholesale (the file records the full
adopted set, not a delta). The port's JSON is a copy of the JAX package's.

The names a set may hold (``models/transformer_net_quant.forward_int8``
routes on them): ``head_i8`` (conv2/conv3 as int8 sites, K8a/K8b),
``res_i8`` (the residual chain, K4/K5), ``res_s8`` (its s8-carry form under
frozen norms, K2/K3), ``dec_i8`` / ``dec_s8`` (deconv1/deconv2, K4 / K2–K3),
``tail_s8`` (deconv2 emits deconv3's codes, K3 + K6) and ``d3_i8``
(deconv3's rows conv, K7).
"""

from __future__ import annotations

import json
from pathlib import Path

PATH = Path(__file__).with_name("i8_adopt.json")

#: The JAX engine's built-in defaults for the Johnson keys.
DEFAULTS: dict[str, tuple] = {
    "sites": ("res_i8", "dec_i8"),
    "sites_static": ("res_i8", "dec_i8"),
}


def _load(path: Path = PATH) -> dict:
    try:
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
        return d if isinstance(d, dict) else {}
    except (OSError, ValueError):
        return {}


def sites(key: str, path: Path = PATH) -> tuple:
    """Adopted fused-site tuple for ``key`` (``"sites"`` or
    ``"sites_static"``)."""
    if key not in DEFAULTS:
        raise KeyError(f"{key!r}: the port reads only the Johnson keys {tuple(DEFAULTS)}")
    v = _load(path).get(key)
    if isinstance(v, (list, tuple)) and all(isinstance(t, str) for t in v):
        return tuple(v)
    return DEFAULTS[key]
