"""Where the card's f32 Gram NST parts from the CPU's: the ten Adam steps of
``tests/test_torch_ladder_card.py::test_gram_nst_card_matches_cpu`` (VGG16
from seed 0, a 64² content and style image, lr 0.02) on the card in f32,
on the CPU in f32 and on the CPU in f64 (the reference), stage by stage.

At the content image (where every run starts): the relative error of each
VGG feature the losses read, of its Gram matrix, of the total loss and of
the gradient, and the pixels whose gradient sign differs from the f64 run's
(Adam's first update is about −lr·sign(g), so a flipped sign moves a pixel
by 2·lr). Then for each step: the gradient's relative error, its sign
flips, and the share of pixels within 1e-3 of the f64 image, the test's
gate. The card runs twice, with cuDNN pinned as the test pins it
(deterministic, no autotuner) and with cuDNN off (PyTorch's own f32
convolutions); the cuDNN conv kernels of one forward are listed. One JSON
line at the end.

    python -m neuralstyletransferv1_torch.experiments.gram_parting [--device cpu]

(``--device cpu`` runs the two CPU columns only.)
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..engine import gram_nst as tg
from ..models import vgg as tv

STEPS, LR, GATE = 10, 0.02, 1e-3


def _x(shape, seed):
    """The card test's inputs."""
    return torch.from_numpy(np.random.default_rng(seed).random(shape).astype(np.float32))


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.double().cpu(), ref.double().cpu()
    return float((a - ref).norm() / ref.norm().clamp(min=1e-300))


def _start(net, c, s):
    """The stages at the content image: features, Grams, loss, gradient."""
    feats = tv.extract_features(net, c, tv.STYLE_LAYERS + (tv.CONTENT_LAYER,))
    grams = {k: tv.gram_matrix(feats[k]) for k in tv.STYLE_LAYERS}
    content = feats[tv.CONTENT_LAYER].detach()
    sgrams = {k: tv.gram_matrix(v) for k, v in
              tv.extract_features(net, s, tv.STYLE_LAYERS).items()}
    img = c.clone().requires_grad_(True)
    total, _ = tg.nst_losses(net, img, content, sgrams, content_weight=1.0,
                             style_weight=1e4, tv_weight=1e-4)
    (g,) = torch.autograd.grad(total, img)
    return {"feats": {k: v.detach() for k, v in feats.items()},
            "grams": {k: v.detach() for k, v in grams.items()}, "loss": total.detach(), "grad": g}


def _run(dev, dtype):
    """The stages at the start, then the ten steps' gradients and images
    (``optimize``'s loop, its ``adam_update`` recording each gradient and
    update; image k is clamp(image k−1 + update k, 0, 1), as the loop
    computes it, elementwise and so exact on any device)."""
    net = tv.load(tv.init(0), dev).to(dtype)
    c, s = (_x((1, 64, 64, 3), seed).to(dev, dtype) for seed in (4, 5))
    with torch.enable_grad():
        start = _start(net, c, s)
    grads, updates = [], []
    orig = tg.adam_update

    def record(g, state, lr, **kw):
        upd, st = orig(g, state, lr, **kw)
        grads.append(g.detach().cpu())
        updates.append(upd.cpu())
        return upd, st

    tg.adam_update = record
    try:
        last, _ = tg.optimize(net, c, s, steps=STEPS, lr=LR)
    finally:
        tg.adam_update = orig
    imgs, img = [], c.cpu()
    for upd in updates:
        img = torch.clamp(img + upd, 0.0, 1.0)
        imgs.append(img)
    assert torch.equal(img, last.cpu())
    return {"start": start, "grads": grads, "imgs": imgs}


def _conv_kernels(dev) -> list:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    net = tv.load(tv.init(0), dev)
    c = _x((1, 64, 64, 3), 4).to(dev).requires_grad_(True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        f = tv.extract_features(net, c, tv.STYLE_LAYERS + (tv.CONTENT_LAYER,))
        sum(v.sum() for v in f.values()).backward()
        torch.cuda.synchronize()
    return sorted({e.key[:100] for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0})


def _compare(run: dict, ref: dict) -> dict:
    s, r = run["start"], ref["start"]
    g, gr = s["grad"].cpu(), r["grad"].cpu()
    flips = (torch.sign(g) != torch.sign(gr.to(g.dtype)))
    out = {"feature_rel": {k: _rel(s["feats"][k], r["feats"][k]) for k in s["feats"]},
           "gram_rel": {k: _rel(s["grams"][k], r["grams"][k]) for k in s["grams"]},
           "loss_rel": _rel(s["loss"], r["loss"]), "grad_rel": _rel(g, gr),
           "grad_sign_flips": int(flips.sum()),
           "flip_grad_abs_max": float(gr[flips].abs().max()) if flips.any() else 0.0,
           "grad_abs_median": float(gr.abs().median()), "steps": []}
    for k, (gk, img) in enumerate(zip(run["grads"], run["imgs"])):
        gref, iref = ref["grads"][k], ref["imgs"][k]
        d = (img.double() - iref.double()).abs()
        out["steps"].append({
            "step": k + 1, "grad_rel": _rel(gk, gref),
            "grad_sign_flips": int((torch.sign(gk) != torch.sign(gref.to(gk.dtype))).sum()),
            "img_mean_abs": float(d.mean()), "img_max_abs": float(d.max()),
            "share_within_gate": float((d <= GATE).double().mean())})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from ..device import resolve_device

    cpu = torch.device("cpu")
    ref = _run(cpu, torch.float64)
    cols = {"cpu f32": _compare(_run(cpu, torch.float32), ref)}
    rec = {"reference": "cpu f64"}
    if args.device == "cuda":
        dev = resolve_device("cuda")  # TF32 off
        rec["card"] = torch.cuda.get_device_name(0)
        saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
                 torch.backends.cudnn.enabled)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            rec["cudnn_kernels"] = _conv_kernels(dev)
            cols["card f32 (cuDNN pinned)"] = _compare(_run(dev, torch.float32), ref)
            torch.backends.cudnn.enabled = False
            cols["card f32 (cuDNN off)"] = _compare(_run(dev, torch.float32), ref)
        finally:
            (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.enabled) = saved
    for name, c in cols.items():
        last = c["steps"][-1]
        print(f"{name} vs cpu f64: start: features rel max {max(c['feature_rel'].values()):.3e}, "
              f"grams rel max {max(c['gram_rel'].values()):.3e}, loss rel {c['loss_rel']:.3e}, "
              f"grad rel {c['grad_rel']:.3e}, {c['grad_sign_flips']} gradient sign flips "
              f"(largest |g64| among them {c['flip_grad_abs_max']:.3e}; median |g64| "
              f"{c['grad_abs_median']:.3e}); after {STEPS} steps mean |d| "
              f"{last['img_mean_abs']:.3e}, max {last['img_max_abs']:.3e}, "
              f"{last['share_within_gate']:.6f} within {GATE}")
        for st in c["steps"]:
            print(f"  step {st['step']:2d}: grad rel {st['grad_rel']:.3e}, sign flips "
                  f"{st['grad_sign_flips']}, image mean |d| {st['img_mean_abs']:.3e}, max "
                  f"{st['img_max_abs']:.3e}, {st['share_within_gate']:.6f} within {GATE}")
    print(json.dumps({**rec, "columns": cols}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
