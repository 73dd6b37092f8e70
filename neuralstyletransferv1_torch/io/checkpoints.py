"""Checkpoint import: reference-format torch state dicts → the Johnson,
NST_Train and ReCoNet param trees (numpy leaves).

The port's copy of the Johnson, NST_Train and ReCoNet parts of the JAX
engine's ``io/checkpoints.py`` (the port imports nothing of the JAX package):

- robust load: ``weights_only`` retry, ``state_dict`` unwrap, legacy
  InstanceNorm running-stat dropping;
- arch detection by key prefix: ``down1.`` ⇒ the NST_Train variant;
- conv weights OIHW → HWIO, transposed-conv weights IOHW → (k, k, Cout,
  Cin), norms ``weight``/``bias`` → ``scale``/``bias``: the trees
  ``models.transformer_net.params_from_jax`` and
  ``models.transformer_net_nst.params_from_jax`` take;
- ReCoNet's nested-Sequential key layout (``import_reconet``, FRN nets
  detected by their ``.tau`` keys, the FRN parameters' (1, C, 1, 1) shapes
  flattened to (C,)): the tree ``models.reconet.params_from_jax`` takes.
"""

from __future__ import annotations

import numpy as np

_DROP_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def load_state_dict(path: str) -> dict[str, np.ndarray]:
    """Load a torch checkpoint into {key: float32 numpy}."""
    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for wrapper in ("state_dict", "model_state_dict"):
            if wrapper in obj and isinstance(obj[wrapper], dict):
                obj = obj[wrapper]
                break
    out: dict[str, np.ndarray] = {}
    for k, v in obj.items():
        if k.endswith(_DROP_SUFFIXES):
            continue
        k = k.removeprefix("module.")
        if hasattr(v, "detach"):
            out[k] = v.detach().cpu().numpy().astype(np.float32)
        else:
            out[k] = np.asarray(v, dtype=np.float32)
    return out


def detect_transformer_arch(sd: dict[str, np.ndarray]) -> str:
    """'nst' if keys use the NST_Train ``down1.`` prefix, else 'johnson'."""
    for k in sd:
        if k.startswith("down1."):
            return "nst"
    return "johnson"


def _conv(sd, prefix) -> dict:
    w = sd[f"{prefix}.weight"]  # OIHW
    p = {"w": np.transpose(w, (2, 3, 1, 0))}  # → HWIO
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    else:
        p["b"] = np.zeros(w.shape[0], np.float32)
    return p


def _conv_t(sd, prefix) -> dict:
    w = sd[f"{prefix}.weight"]  # IOHW (torch ConvTranspose2d)
    p = {"w": np.transpose(w, (2, 3, 1, 0))}  # → HW, Cout, Cin
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    else:
        p["b"] = np.zeros(w.shape[1], np.float32)
    return p


def _norm(sd, prefix) -> dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def import_transformer(sd: dict[str, np.ndarray]) -> dict:
    """Johnson TransformerNet state dict → param tree
    (keys ``conv1.conv2d.weight`` / ``in1.weight`` …)."""
    p: dict = {}
    for name in ("conv1", "conv2", "conv3", "deconv1", "deconv2", "deconv3"):
        p[name] = _conv(sd, f"{name}.conv2d")
    for name in ("in1", "in2", "in3", "in4", "in5"):
        p[name] = _norm(sd, name)
    for i in range(1, 6):
        p[f"res{i}"] = {
            "conv1": _conv(sd, f"res{i}.conv1.conv2d"),
            "in1": _norm(sd, f"res{i}.in1"),
            "conv2": _conv(sd, f"res{i}.conv2.conv2d"),
            "in2": _norm(sd, f"res{i}.in2"),
        }
    return p


def import_transformer_nst(sd: dict[str, np.ndarray]) -> dict:
    """NST_Train TransformerNet state dict → param tree
    (keys ``down1.conv.weight`` / ``res1.conv1.weight`` / ``up1.conv.weight``)."""
    p: dict = {}
    for name in ("down1", "down2", "down3"):
        p[name] = {"conv": _conv(sd, f"{name}.conv"), "norm": _norm(sd, f"{name}.norm")}
    for i in range(1, 6):
        p[f"res{i}"] = {
            "conv1": _conv(sd, f"res{i}.conv1"),
            "norm1": _norm(sd, f"res{i}.norm1"),
            "conv2": _conv(sd, f"res{i}.conv2"),
            "norm2": _norm(sd, f"res{i}.norm2"),
        }
    for name in ("up1", "up2"):
        p[name] = {"conv": _conv_t(sd, f"{name}.conv"), "norm": _norm(sd, f"{name}.norm")}
    p["final"] = _conv(sd, "final")
    return p


def _reconet_cnl(sd, prefix, use_frn) -> dict:
    """A ConvNormLayer: Sequential(ConvLayer, Norm[, Act]), the ConvLayer
    itself Sequential(ReflectionPad2d, Conv2d): the conv at
    ``{prefix}.layers.0.layers.1``, the norm at ``{prefix}.layers.1``, an FRN
    net's TLU at ``{prefix}.layers.2``."""
    out = {
        "conv": _conv(sd, f"{prefix}.layers.0.layers.1"),
        "norm": _norm(sd, f"{prefix}.layers.1"),
    }
    if use_frn and f"{prefix}.layers.2.tau" in sd:
        out["norm"]["tau"] = sd[f"{prefix}.layers.2.tau"].reshape(-1)
    return out


def _flatten_frn(t):
    """(1, C, 1, 1) FRN parameters → (C,); conv weights (HWIO, never of that
    shape) and everything else as they are."""
    if isinstance(t, dict):
        return {k: _flatten_frn(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_flatten_frn(v) for v in t]
    if isinstance(t, np.ndarray) and t.ndim == 4 and t.shape[0] == 1 and t.shape[2] == 1:
        return t.reshape(-1)
    return t


def import_reconet(sd: dict[str, np.ndarray]) -> dict:
    """ReCoNet state dict → param tree ``{"frn", "encoder", "decoder"}``: the
    three encoder ConvNormLayers (``encoder.layers.{0,1,2}``), the four
    ResLayers (``encoder.layers.{3..6}.branch.{0,1}``, an FRN net's post-add
    TLU at ``.activation.tau``), the two decoder ConvNormLayers
    (``decoder.layers.{1,3}``, after the upsamples) and the final conv
    (``decoder.layers.4.layers.0.layers.1``)."""
    use_frn = any(".tau" in k for k in sd)
    enc: list = [_reconet_cnl(sd, f"encoder.layers.{i}", use_frn) for i in range(3)]
    for i in range(3, 7):
        c1 = _reconet_cnl(sd, f"encoder.layers.{i}.branch.0", use_frn)
        c2 = _reconet_cnl(sd, f"encoder.layers.{i}.branch.1", use_frn)
        enc.append({"conv1": c1["conv"], "norm1": c1["norm"], "conv2": c2["conv"],
                    "norm2": c2["norm"],
                    "act": ({"tau": sd[f"encoder.layers.{i}.activation.tau"].reshape(-1)}
                            if use_frn else None)})
    dec = [_reconet_cnl(sd, "decoder.layers.1", use_frn),
           _reconet_cnl(sd, "decoder.layers.3", use_frn),
           {"conv": _conv(sd, "decoder.layers.4.layers.0.layers.1")}]
    return _flatten_frn({"frn": use_frn, "encoder": enc, "decoder": dec})
