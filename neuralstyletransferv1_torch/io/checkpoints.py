"""Checkpoint import: reference-format torch state dicts → the Johnson param
tree (numpy leaves).

The port's copy of the Johnson part of the JAX engine's
``io/checkpoints.py`` (the port imports nothing of the JAX package):

- robust load: ``weights_only`` retry, ``state_dict`` unwrap, legacy
  InstanceNorm running-stat dropping;
- arch detection by key prefix: ``down1.`` ⇒ the NST_Train variant;
- conv weights OIHW → HWIO, norms ``weight``/``bias`` → ``scale``/``bias``,
  the tree ``models.transformer_net.params_from_jax`` takes.
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
