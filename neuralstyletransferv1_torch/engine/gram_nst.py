"""Optimization-based (slow) neural style transfer: the Gram-matrix path.

Counterpart of ``neuralstyletransferv1_tpu/engine/gram_nst.py`` (BASELINE
config #3: VGG16 content and style losses, 500 steps at 512 px). Losses
follow Gatys: content MSE at relu3_3, style MSE between Gram matrices at
relu1_2, relu2_2, relu3_3, relu4_3, and total variation. The JAX module
runs the steps as one ``lax.scan``; here the loop runs on the device with
no host round trip per step: each step's loss stays a device scalar until
the loop ends. Autograd differentiates with respect to the image only
(the VGG weights are frozen). Adam is optax's, written as tensor ops in
optax's order, so the two agree to an f32 ulp per update.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import vgg

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def nst_losses(net, img01: torch.Tensor, content_feats: torch.Tensor, style_grams: dict, *,
               content_weight: float, style_weight: float, tv_weight: float):
    """(total, {"content", "style", "tv"}) of an NHWC [0, 1] image."""
    feats = vgg.extract_features(net, img01, vgg.STYLE_LAYERS + (vgg.CONTENT_LAYER,))
    c_loss = torch.mean((feats[vgg.CONTENT_LAYER] - content_feats) ** 2)
    s_loss = 0.0
    for name in vgg.STYLE_LAYERS:
        s_loss = s_loss + torch.mean((vgg.gram_matrix(feats[name]) - style_grams[name]) ** 2)
    tv = (torch.mean(torch.abs(img01[:, 1:] - img01[:, :-1]))
          + torch.mean(torch.abs(img01[:, :, 1:] - img01[:, :, :-1])))
    total = content_weight * c_loss + style_weight * s_loss + tv_weight * tv
    return total, {"content": c_loss, "style": s_loss, "tv": tv}


def _div(t: torch.Tensor, s: float) -> torch.Tensor:
    """``t / s`` as a true division (PyTorch divides by a Python or CPU
    scalar as a product with its reciprocal, an ulp off optax's). The
    divisor is filled on the device: no host-to-device copy a step."""
    return t / torch.full((), s, dtype=t.dtype, device=t.device).expand_as(t)


def adam_init(x: torch.Tensor) -> dict:
    """optax ``scale_by_adam``'s state: the moments at zero, count 0."""
    return {"mu": torch.zeros_like(x), "nu": torch.zeros_like(x), "count": 0}


def adam_update(grads: torch.Tensor, state: dict, lr: float, *, b1: float = ADAM_B1,
                b2: float = ADAM_B2, eps: float = ADAM_EPS) -> tuple:
    """One ``optax.adam(lr)`` update (eps_root 0), its operations in optax's
    order and f32 constants: returns (updates, new state)."""
    mu = (1 - b1) * grads + b1 * state["mu"]
    nu = (1 - b2) * (grads * grads) + b2 * state["nu"]
    count = state["count"] + 1
    # ``1 - decay ** count`` in f32, as optax's bias correction computes it
    bc1 = float(np.float32(1) - np.power(np.float32(b1), np.float32(count)))
    bc2 = float(np.float32(1) - np.power(np.float32(b2), np.float32(count)))
    # the square root in f64, rounded once to f32: PyTorch's vectorized f32
    # sqrt on the CPU is not correctly rounded (XLA's is)
    root = torch.sqrt(_div(nu, bc2).double()).to(nu.dtype)
    updates = (_div(mu, bc1) / (root + eps)) * -lr
    return updates, {"mu": mu, "nu": nu, "count": count}


def optimize(net, content01: torch.Tensor, style01: torch.Tensor, *, steps: int = 500,
             lr: float = 0.02, content_weight: float = 1.0, style_weight: float = 1e4,
             tv_weight: float = 1e-4, init_from: str = "content", seed: int = 0):
    """Run the whole optimization on the image's device. content01 and
    style01: NHWC [0, 1] (the style image may differ in size). Returns
    (stylized01, history[steps]): history[i] is the total loss of the image
    before step i's update. After each update the image is clipped to
    [0, 1]; Adam sees the unclipped gradients. ``init_from="random"`` draws
    the start uniformly from a ``torch.Generator`` seeded with ``seed``
    (JAX's ``jax.random`` draw cannot be reproduced)."""
    # a caller in inference_mode or no_grad cannot break the loop; the
    # clones make the inputs ordinary tensors there
    with torch.inference_mode(False), torch.enable_grad():
        content01, style01 = content01.clone(), style01.clone()
        with torch.no_grad():
            content_feats = vgg.extract_features(net, content01, (vgg.CONTENT_LAYER,))[
                vgg.CONTENT_LAYER]
            style_grams = {k: vgg.gram_matrix(v) for k, v in
                           vgg.extract_features(net, style01, vgg.STYLE_LAYERS).items()}
        if init_from == "content":
            img = content01
        elif init_from == "random":
            gen = torch.Generator(device=content01.device).manual_seed(seed)
            img = torch.rand(content01.shape, generator=gen, device=content01.device,
                             dtype=content01.dtype)
        else:
            raise ValueError(init_from)

        state = adam_init(img)
        history = []
        for _ in range(steps):
            img = img.detach().requires_grad_(True)
            total, _parts = nst_losses(net, img, content_feats, style_grams,
                                       content_weight=content_weight,
                                       style_weight=style_weight, tv_weight=tv_weight)
            (grads,) = torch.autograd.grad(total, img)
            history.append(total.detach())
            with torch.no_grad():
                updates, state = adam_update(grads, state, lr)
                img = torch.clamp(img + updates, 0.0, 1.0)
    return img.detach(), torch.stack(history) if history else torch.zeros(0)
