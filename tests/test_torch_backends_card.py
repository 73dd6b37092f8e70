"""The magenta slot, the compact CIN net, Farneback flow and the Caffe SSD
detector on the card against the port on the CPU: the ``cuda`` twins of
``chip_smoke.py`` phase 12, run on the card's machine with ``--noconftest``
(this file imports no JAX). The CPU cases check the smoke's own seeded
weights (``chip_smoke.cin_tree``, ``chip_smoke.write_ssd``), which the card
cases and phase 12 use.

Tolerances, as in the smoke: the compact net f32 1e-5 MAE, the colour
transfer 1e-4 MAE (its LAB a/b planes round to integers), Farneback a mean
|Δflow| of 1e-2 px with 99.9% of the pixels within 0.5 px (its gather
rounds ``p + flow``), the SSD heads 1e-4 relative MAE and its detections
1e-4 absolute.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from neuralstyletransferv1_torch.models import caffe_ssd as tssd
from neuralstyletransferv1_torch.models import magenta as tm

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from neuralstyletransferv1_torch.device import resolve_device

    return resolve_device("cuda")  # TF32 off


def _frames(n, h, w, seed):
    return torch.from_numpy(np.stack(chip_smoke.moving_frames(n, h, w, seed))).float() / 255.0


def test_smoke_cin_tree_loads_at_full_width():
    """``cin_tree`` has ``magenta.init``'s layout and widths; the net it
    loads stylizes a tile into [0, 1]."""
    net = tm.compact_from_jax(chip_smoke.cin_tree(0))
    sd = net.state_dict()
    assert sd["net.c1.w"].shape == (32, 3, 9, 9) and sd["net.res5_2.w"].shape == (128, 128, 3, 3)
    assert sd["cin.u2.gw"].shape == (100, 32) and sd["predictor.convs.3.w"].shape == (256, 128,
                                                                                       3, 3)
    with torch.no_grad():
        y = tm.stylize_tiled_batch(net, _frames(1, 40, 56, 1), _frames(1, 32, 32, 2)[0],
                                   tile_size=32, overlap=8)
    assert y.shape == (1, 40, 56, 3) and 0.0 <= y.min() and y.max() <= 1.0 and y.std() > 1e-3


def test_smoke_ssd_weights_match_the_graph(tmp_path):
    """``write_ssd``: a blob for every weighted layer, BatchNorm's running
    sums over a scale factor of 2, and a graph that detects."""
    proto, model, blobs = chip_smoke.write_ssd(tmp_path, 0)
    assert blobs["conv1_bn_h"][2].tolist() == [2.0] and blobs["conv1_h"][0].shape == (16, 3, 7, 7)
    assert "layer_64_1_conv1_h" in blobs and len(blobs["layer_64_1_conv1_h"]) == 1  # no bias
    net = tssd.load_caffe_ssd(proto, model, CPU)
    dets = net.forward(np.random.default_rng(0).normal(0, 50, (1, 3, 300, 300)).astype(np.float32))
    assert dets.shape[:2] == (1, 1) and dets.shape[2] > 0 and dets.shape[3] == 7


@pytest.mark.cuda
def test_compact_cin_card_matches_cpu(cuda_device):
    """The full-width compact net, f32, on a 256×480 frame (6 tiles of 256²)."""
    tree = chip_smoke.cin_tree(1)
    x, style = _frames(1, 256, 480, 3), _frames(1, 256, 256, 4)[0]
    outs = []
    for d in (cuda_device, CPU):
        with torch.no_grad():
            outs.append(tm.stylize_tiled_batch(tm.compact_from_jax(tree, d), x.to(d),
                                               style.to(d)).cpu())
    assert (outs[0] - outs[1]).abs().mean().item() <= 1e-5
    assert outs[0].std().item() > 1e-3


@pytest.mark.cuda
def test_magenta_slot_card_matches_cpu(cuda_device, tmp_path):
    """The colour-transfer slot (tile 256, overlap 32) on a 2-frame batch."""
    from neuralstyletransferv1_torch.engine import stylizer as tst

    style = tmp_path / "style.png"
    Image.fromarray(chip_smoke.moving_frames(1, 300, 400, 5)[0]).save(style)
    args = SimpleNamespace(magenta_model_root=str(tmp_path / "none"), magenta_tile=256,
                           magenta_overlap=32, magenta_target_res=None)
    x = _frames(2, 270, 480, 6)
    outs = [tst.jit_stylizer(tst.load_model(style, model_type="magenta", device=d,
                                            magenta_args=args))(x.to(d)).cpu()
            for d in (cuda_device, CPU)]
    assert (outs[0] - outs[1]).abs().mean().item() <= 1e-4 and outs[0].std().item() > 1e-2


@pytest.mark.cuda
def test_farneback_card_matches_cpu(cuda_device):
    """Two pairs at 270×480 (the clip's pan (3, 1) px a frame)."""
    from neuralstyletransferv1_torch.ops.color import rgb_to_gray
    from neuralstyletransferv1_torch.ops.flow import farneback_flow

    g = rgb_to_gray(_frames(3, 270, 480, 7) * 255.0)
    with torch.no_grad():
        card = farneback_flow(g[:-1].to(cuda_device), g[1:].to(cuda_device)).cpu()
        cpu = farneback_flow(g[:-1], g[1:])
    d = (card - cpu).abs()
    assert d.mean().item() <= 1e-2 and (d.amax(-1) <= 0.5).float().mean().item() >= 0.999
    pan = card[:, 30:-30, 30:-30].mean((0, 1, 2))
    assert abs(pan[0].item() - 3.0) <= 0.3 and abs(pan[1].item() - 1.0) <= 0.3


@pytest.mark.cuda
def test_ssd_card_matches_cpu(cuda_device, tmp_path):
    proto, model, _ = chip_smoke.write_ssd(tmp_path, 2)
    blob = np.random.default_rng(8).normal(0, 50, (1, 3, 300, 300)).astype(np.float32)
    nets = [tssd.load_caffe_ssd(proto, model, d) for d in (cuda_device, CPU)]
    heads = [{k: v.cpu() for k, v in n.trunk(blob).items()} for n in nets]
    for k in ("__loc__", "__conf__"):
        rel = (heads[0][k] - heads[1][k]).abs().mean() / heads[1][k].abs().mean()
        assert rel.item() <= 1e-4, k
    a, b = (n.forward(blob) for n in nets)
    assert a.shape == b.shape and a.shape[2] > 0 and np.abs(a - b).max() <= 1e-4
