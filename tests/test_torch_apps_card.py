"""The frame loader and the apps' device paths without JAX: on the CPU, the
loader against PIL and the apps' batched renders against their frame-by-
frame forms; and the ``cuda`` twins of ``chip_smoke.py`` phase 15 — the
loader on the card's host, ``optical_flow_morph`` and the other apps'
device renders card vs CPU — run on the card's machine with
``--noconftest`` (this file imports no JAX).

Tolerances: the loader's PNG frames equal PIL's, its JPEG frames within 1
level (the system libjpeg against PIL's libjpeg-turbo). Morph frames card
vs CPU by mean |Δ| ≤ 1 level and ≥ 99% within 1 level (Farneback's gather
rounds ``p + flow``; never the maximum); the wipes, motion clips and text
remaps card vs CPU within 1 level (f32 gathers and blends, a truncating
cast); batched vs frame-by-frame on the CPU equal.
"""

import random

import numpy as np
import pytest
import torch
from PIL import Image

from neuralstyletransferv1_torch.apps import cryptic_text as tct
from neuralstyletransferv1_torch.apps import gen_pytorch_only_videos as tgp
from neuralstyletransferv1_torch.apps import morph as tmo
from neuralstyletransferv1_torch.apps import style_showcase as tsc
from neuralstyletransferv1_torch.io import native_loader as tnl


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file (the six-worker tier-1 run shares
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from neuralstyletransferv1_torch.device import resolve_device

    return resolve_device("cuda")  # TF32 off


def _scene(h, w, seed, shift=(0, 0)):
    rng = np.random.default_rng(seed)
    small = (rng.random((h // 8 + 1, w // 8 + 1, 3)) * 255).astype(np.uint8)
    big = np.asarray(Image.fromarray(small).resize((w + 16, h + 16), Image.BICUBIC))
    return np.ascontiguousarray(big[8 + shift[0]:8 + shift[0] + h, 8 + shift[1]:8 + shift[1] + w])


def _loader_round(tmp_path, n, h, w, threads, capacity):
    files, want = [], []
    for i in range(n):
        f = _scene(h, w, i)
        fmt = "png" if i % 2 else "jpg"
        files.append(tmp_path / f"frame_{i:04d}.{fmt}")
        Image.fromarray(f).save(files[-1], **({"quality": 90} if fmt == "jpg" else {}))
        want.append(np.asarray(Image.open(files[-1]).convert("RGB")))
    with tnl.NativeFrameLoader(files, threads=threads, capacity=capacity) as ld:
        got = list(ld)
    assert len(got) == n
    for i, (g, p) in enumerate(zip(got, want)):
        assert g.shape == p.shape == (h, w, 3)
        if i % 2:
            np.testing.assert_array_equal(g, p)
        else:
            assert np.abs(g.astype(int) - p.astype(int)).max() <= 1


@pytest.mark.parametrize("threads,capacity", [(1, 2), (4, 16)])
def test_loader_matches_pil(tmp_path, threads, capacity):
    """Interleaved PNG and JPEG frames, more than the capacity, in order."""
    _loader_round(tmp_path, 20, 36, 52, threads, capacity)


def test_morph_render_chunks_match_one_pass():
    a, b = _scene(40, 56, 0), _scene(40, 56, 0, (2, 3))
    whole = tmo.optical_flow_morph(a, b, 6, device="cpu", chunk=6)
    for chunk in (1, 4):
        for x, y in zip(tmo.optical_flow_morph(a, b, 6, device="cpu", chunk=chunk), whole):
            np.testing.assert_array_equal(x, y)


def test_transition_and_motion_chunks_match_one_pass():
    a, b = _scene(24, 40, 1), _scene(24, 40, 2)
    for kind in ("spiral", "radial", "blob"):
        for x, y in zip(tgp.transition_frames(a, b, kind, 5, chunk=2),
                        tgp.transition_frames(a, b, kind, 5, chunk=5)):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(tsc.motion_clip_frames(a, "ken_burns", 0.5, 10, 0.2, chunk=2),
                    tsc.motion_clip_frames(a, "ken_burns", 0.5, 10, 0.2, chunk=5)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_loader_on_card_host(cuda_device, tmp_path):
    """The loader built and decoding on the card's machine, 1080p frames.
    Where that machine lacks g++ or the libjpeg / libpng headers it skips
    with the compiler's reason (``chip_smoke.py`` phase 15 then holds the
    engine's PIL fallback)."""
    try:
        tnl.get_lib()
    except tnl.LoaderUnavailable as e:
        pytest.skip(f"the loader cannot be built on this machine: {e}")
    _loader_round(tmp_path, 8, 1080, 1920, 4, 8)


@pytest.mark.cuda
def test_optical_flow_morph_card_matches_cpu(cuda_device):
    a, b = _scene(270, 480, 3), _scene(270, 480, 3, (4, 7))
    got = np.stack(tmo.optical_flow_morph(a, b, 8, device=cuda_device)).astype(int)
    want = np.stack(tmo.optical_flow_morph(a, b, 8, device="cpu")).astype(int)
    d = np.abs(got - want)
    assert d.mean() <= 1.0 and (d <= 1).mean() >= 0.99, (d.mean(), (d <= 1).mean())


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["spiral", "radial", "blob", "ken_burns", "zoom_out", "remap"])
def test_app_renders_card_match_cpu(cuda_device, app):
    a, b = _scene(120, 200, 4), _scene(120, 200, 5)
    if app in ("spiral", "radial", "blob"):
        got, want = (tgp.transition_frames(a, b, app, 7, device=d) for d in (cuda_device, "cpu"))
    elif app == "remap":
        rgba = np.concatenate([a, a[..., :1]], -1)
        got, want = ([tct.apply_distortion(rgba, "ripple", 0.3, rng=random.Random(0), device=d)]
                     for d in (cuda_device, "cpu"))
    else:
        got, want = (tsc.motion_clip_frames(a, app, 0.7, 10, 0.3, device=d)
                     for d in (cuda_device, "cpu"))
    assert len(got) == len(want) > 0
    for x, y in zip(got, want):
        assert np.abs(x.astype(int) - y.astype(int)).max() <= 1
