"""Farneback flow (``ops/flow.py``, ``--flow_method farneback``): the port
against the JAX package on the CPU.

``_gather_at_flow`` rounds ``p + flow`` to integers (half to even on both
sides), so a last-bit f32 difference can flip an index and move one pixel's
flow far: whole flows are compared by the mean |Δ| and the share of pixels
within 0.1 px, not by the maximum. The pieces before the first rounding are
held to 1e-4 relative. The CLI paths (per-frame and batched, flow EMA with
Farneback) are held to the repo's 1e-2 MAE gate on [0, 1] frames.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from neuralstyletransferv1_tpu import config as nconfig
from neuralstyletransferv1_tpu.engine import pipeline as jpipe
from neuralstyletransferv1_tpu.ops import flow as jflow
from neuralstyletransferv1_torch.engine import pipeline as tpipe
from neuralstyletransferv1_torch.ops import flow as tflow

CKPT = Path(__file__).resolve().parent.parent / "_testdata" / "test_johnson.pth"
CPU = torch.device("cpu")
MEAN_TOL = 1e-3   # px, mean |Δflow|
SHARE = 0.99      # of pixels within 0.1 px
GATE = 1e-2       # MAE on [0, 1] frames


def _scene(h, w, dx, dy, seed=0):
    """A smooth textured grey scene (0..255) shifted by (dx, dy) px."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    x, y = xx - dx, yy - dy
    f = (120 + 60 * np.sin(0.11 * x + 0.07 * y) + 40 * np.cos(0.05 * x - 0.13 * y)
         + 20 * np.sin(0.3 * x) * np.cos(0.2 * y))
    return (f + rng.normal(0, 1.0, (h, w))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_flow():
    return jax.jit(jflow.farneback_flow)


def _assert_flow_close(ours, ref):
    d = np.abs(np.asarray(ours, np.float64) - np.asarray(ref, np.float64))
    assert ours.shape == ref.shape
    assert d.mean() <= MEAN_TOL and (d.max(-1) <= 0.1).mean() >= SHARE, (d.mean(), d.max())


@pytest.mark.parametrize("shift", [(3.0, 2.0), (-1.5, 0.5)], ids=["3,2", "-1.5,0.5"])
def test_farneback_matches_jax(jax_flow, shift):
    """136×240 (three levels), a shifted scene: the port's flow within the
    bounds of JAX's, which recovers the shift in the interior."""
    prev, curr = _scene(136, 240, 0, 0), _scene(136, 240, *shift)
    ref = np.asarray(jax_flow(jnp.asarray(prev), jnp.asarray(curr)))
    ours = tflow.farneback_flow(torch.from_numpy(prev), torch.from_numpy(curr)).numpy()
    _assert_flow_close(ours, ref)
    inner = ours[20:-20, 20:-20].mean((0, 1))
    assert np.abs(inner - np.asarray(shift)).max() < 0.5, inner


def test_farneback_batch_matches_jax_vmap():
    """A 2-pair batch, odd sizes (the level sizes by Python's round: 75 →
    38 → 19): the port's batched call against JAX's vmap, and each pair
    against the port's single-pair call."""
    prevs = np.stack([_scene(75, 99, 0, 0, 1), _scene(75, 99, 0, 0, 2)])
    currs = np.stack([_scene(75, 99, 2, -1, 1), _scene(75, 99, -1, 1, 2)])
    ref = np.asarray(jax.jit(jax.vmap(jflow.farneback_flow))(jnp.asarray(prevs),
                                                             jnp.asarray(currs)))
    ours = tflow.farneback_flow(torch.from_numpy(prevs), torch.from_numpy(currs))
    assert ours.shape == (2, 75, 99, 2)
    _assert_flow_close(ours.numpy(), ref)
    for i in range(2):
        one = tflow.farneback_flow(torch.from_numpy(prevs[i]), torch.from_numpy(currs[i]))
        _assert_flow_close(one.numpy(), ours[i].numpy())


def test_small_inputs_give_zero_flow():
    """No level fits (min side < 15): zero flow, as in JAX."""
    a = np.random.default_rng(0).random((12, 40)).astype(np.float32)
    ours = tflow.farneback_flow(torch.from_numpy(a), torch.from_numpy(a))
    ref = np.asarray(jflow.farneback_flow(jnp.asarray(a), jnp.asarray(a)))
    assert ours.shape == ref.shape == (12, 40, 2) and not ours.any() and not ref.any()


def test_poly_expansion_and_box_filter_match_jax():
    img = _scene(40, 52, 0, 0, 3)
    b, A = tflow.poly_expansion(torch.from_numpy(img)[None], 5, 1.1)
    jb, jA = jflow.poly_expansion(jnp.asarray(img), 5, 1.1)
    for o, r in ((b[0], jb), (A[0], jA)):
        r = np.asarray(r)
        assert np.abs(o.numpy() - r).max() <= 1e-4 * np.abs(r).max()
    x = np.random.default_rng(4).normal(0, 10, (1, 40, 52, 6)).astype(np.float32)
    ours = tflow._box_filter(torch.from_numpy(x), 15)[0].numpy()
    ref = np.asarray(jflow._box_filter(jnp.asarray(x[0]), 15))
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


def test_gather_rounds_half_to_even_and_clamps():
    """Flows at exact .5 offsets and past the border: the same indices as
    JAX (round half to even, clamped)."""
    rng = np.random.default_rng(5)
    field = rng.normal(0, 1, (9, 11, 3)).astype(np.float32)
    flow = (rng.integers(-30, 30, (9, 11, 2)) / 2.0).astype(np.float32)
    ours = tflow._gather_at_flow(torch.from_numpy(field)[None], torch.from_numpy(flow)[None])
    ref = np.asarray(jflow._gather_at_flow(jnp.asarray(field), jnp.asarray(flow)))
    np.testing.assert_array_equal(ours[0].numpy(), ref)


def test_flow_level_clamps_det_as_jax():
    """``_flow_level`` on random coefficients with a flat patch (A = 0: det
    0) and sign-mixed systems: ``det`` becomes +1e-9 wherever |det| < 1e-9,
    whatever its sign; one iteration, no rounding in between."""
    rng = np.random.default_rng(6)
    h, w = 20, 24
    b1, b2 = (rng.normal(0, 1, (h, w, 2)).astype(np.float32) for _ in range(2))
    A1, A2 = (rng.normal(0, 1, (h, w, 2, 2)).astype(np.float32) for _ in range(2))
    A1[:8, :8] = A2[:8, :8] = 0.0
    b1[:8, :8] = b2[:8, :8] = 0.0
    flow = np.zeros((h, w, 2), np.float32)
    args = (b1, A1, b2, A2, flow)
    ours = tflow._flow_level(*(torch.from_numpy(a)[None] for a in args), 5, 1)[0].numpy()
    ref = np.asarray(jax.jit(jflow._flow_level, static_argnums=(5, 6))(*args, 5, 1))
    assert np.abs(ours - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())
    assert not ours[:2, :2].any()  # zero systems: 0 / 1e-9


def _frames(n, h=64, w=96, seed=0):
    """A textured scene panning (2, 1) px a frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (rng.random((h, w, 3)) * 120).astype(np.float32)
    out = []
    for t in range(n):
        x, y = xx - 2 * t, yy - t
        tex = (60 * np.sin(0.2 * x + 0.1 * y)[..., None]
               + 50 * np.cos(0.13 * x - 0.21 * y)[..., None])
        out.append(np.clip(base + 70 + tex, 0, 255).astype(np.uint8))
    return out


def _video_args(parser, extra):
    return parser.parse_args(["--input_video", "in.mp4", "--output_video", "out.mp4",
                              "--model", str(CKPT), "--io_preset", "raw_01", "--flow_ema",
                              "--flow_method", "farneback", "--flow_alpha", "0.7"] + extra)


@pytest.fixture
def _isolated(monkeypatch):
    if not CKPT.exists():
        pytest.skip("synthetic checkpoint missing")
    monkeypatch.setenv("NST_TPU_COMPILE_CACHE", "0")
    monkeypatch.setattr(nconfig, "conv_precision", nconfig.conv_precision)


def test_per_frame_cli_matches_jax(tmp_path, _isolated):
    """The per-frame loop over an image sequence (frame files) with the
    Farneback flow EMA: the styled files within the 1e-2 gate of JAX's."""
    extra = []
    frames = _frames(4)
    dirs = {}
    for side in ("t", "j"):
        d = tmp_path / side / "frames"
        d.mkdir(parents=True)
        for i, f in enumerate(frames, start=1):
            Image.fromarray(f).save(d / f"frame_{i:04d}.png")
        dirs[side] = d
    targs = _video_args(tpipe.build_parser(), extra + ["--device", "cpu"])
    assert tpipe.style_frames(targs, dirs["t"], False, {}, CPU) == (4, 4)
    assert jpipe.style_frames(_video_args(jpipe.build_arg_parser(), extra), dirs["j"], False,
                              {}) == (4, 4)
    for i in range(1, 5):
        a, b = (np.asarray(Image.open(dirs[s] / f"styled_frame_{i:04d}.png"), np.float64) / 255
                for s in ("t", "j"))
        assert np.abs(a - b).mean() <= GATE and a.std() > 1e-2


def test_batched_core_matches_jax(tmp_path, _isolated):
    """The batched core with the Farneback flow EMA at half resolution
    (JAX: vmapped pairs), two batches of 3: within the 1e-2 gate, the flow
    carried across the batch seam."""
    frames = _frames(6, seed=2)
    extra = ["--frame_batch", "3", "--exact_warp", "--flow_downscale", "2"]
    _, tproc = tpipe.make_batched_core(_video_args(tpipe.build_parser(),
                                                   extra + ["--device", "cpu"]), CPU)
    _, jproc = jpipe._make_batched_core(_video_args(jpipe.build_arg_parser(), extra), tmp_path)
    for b0 in (0, 3):
        ours = tproc(frames[b0:b0 + 3]).numpy() / 255.0
        ref = np.asarray(jproc(frames[b0:b0 + 3], None, b0)) / 255.0
        assert np.abs(ours - ref).mean() <= GATE
