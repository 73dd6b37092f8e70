"""Temporal chain of the PyTorch port (split form) vs the JAX package's
``temporal_postprocess_scan`` (split form, its default), on the CPU.

The LAB EMA runs on wrapped a/b bytes, so a last-bit cube-root difference
can carry a pixel across the wrap and land it far away; the bounds are the
mean error and the share of values beyond 1/255, never the max error.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralstyletransferv1_tpu.temporal import ema as jema
from neuralstyletransferv1_torch.temporal import ema as tema


def _data(T=6, H=13, W=17, seed=0):
    rng = np.random.default_rng(seed)
    styled = rng.random((T, H, W, 3)).astype(np.float32)
    orig = rng.random((T, H, W, 3)).astype(np.float32)
    flows = rng.normal(0, 1.5, (T, H, W, 2)).astype(np.float32)
    state = (rng.random((H, W, 3)).astype(np.float32),
             (rng.random((H, W, 3)) * 255.0).astype(np.float32))
    return styled, orig, flows, state


def _close(ours, ref, *, mean=1e-5, share=1e-3):
    d = np.abs(np.asarray(ours, np.float64) - np.asarray(ref, np.float64))
    assert d.mean() <= mean, d.mean()
    assert (d > 1 / 255).mean() <= share, (d > 1 / 255).mean()


@pytest.mark.parametrize(
    "flow_ema,fast_warp,with_init,motion_blend,chroma",
    [c for c in itertools.product([True, False], [True, False], [True, False],
                                  [False, True], [False])
     if c[0] or c[1]]  # fast_warp only matters with flow_ema
    + [(True, True, False, False, True), (True, False, True, True, True)],
)
def test_split_chain_matches_jax(flow_ema, fast_warp, with_init, motion_blend, chroma):
    styled, orig, flows, state = _data()
    kw = dict(flow_ema=flow_ema, flow_alpha=0.85, smooth_lightness=True,
              smooth_chroma=chroma, smooth_alpha=0.7, chroma_alpha=0.85,
              motion_blend=motion_blend, blend=0.9 if motion_blend else 1.0,
              fast_warp=fast_warp)
    out, st = tema.temporal_postprocess_split(
        torch.from_numpy(styled), torch.from_numpy(orig), torch.from_numpy(flows),
        init=tema.TemporalState(*map(torch.from_numpy, state)) if with_init else None, **kw)
    jout, jst = jema.temporal_postprocess_scan(
        jnp.asarray(styled), jnp.asarray(orig), jnp.asarray(flows),
        init=jema.TemporalState(*map(jnp.asarray, state)) if with_init else None, **kw)
    assert out.shape == styled.shape
    _close(out.numpy(), jout)
    _close(st.prev_styled01.numpy(), jst.prev_styled01)
    lab = np.abs(st.prev_lab.numpy() - np.asarray(jst.prev_lab))
    lab = np.minimum(lab, 256.0 - lab)  # wrapped a/b bytes
    assert lab.mean() <= 1e-2 and (lab > 1.0).mean() <= 1e-3


def test_chain_carries_state_across_batches():
    """Two batches with the carried state == the JAX chain on the same two
    batches (the engine's first-batch warm-up, then init=state)."""
    styled, orig, flows, _ = _data(T=8, seed=1)
    kw = dict(flow_ema=True, flow_alpha=0.85, smooth_lightness=True, fast_warp=True)
    st = jst = None
    for sl in (slice(0, 4), slice(4, 8)):
        out, st = tema.temporal_postprocess_split(
            torch.from_numpy(styled[sl]), torch.from_numpy(orig[sl]),
            torch.from_numpy(flows[sl]), init=st, **kw)
        jout, jst = jema.temporal_postprocess_scan(
            jnp.asarray(styled[sl]), jnp.asarray(orig[sl]), jnp.asarray(flows[sl]),
            init=jst, **kw)
        _close(out.numpy(), jout)


def test_single_steps_match_jax():
    styled, orig, flows, state = _data(T=2, seed=2)
    a, b, f = styled[0], styled[1], flows[1]
    _close(tema.flow_ema_fuse(*map(torch.from_numpy, (a, b, f)), 0.85).numpy(),
           jema.flow_ema_fuse(*map(jnp.asarray, (a, b, f)), 0.85))
    _close(tema.motion_adaptive_blend(*map(torch.from_numpy, (a, orig[0], f)), 0.9).numpy(),
           jema.motion_adaptive_blend(*map(jnp.asarray, (a, orig[0], f)), 0.9))
    _close(tema.uniform_blend(torch.from_numpy(a), torch.from_numpy(orig[0]), 0.6).numpy(),
           jema.uniform_blend(jnp.asarray(a), jnp.asarray(orig[0]), 0.6))
    rgb, lab = tema.lab_ema_step(torch.from_numpy(a), torch.from_numpy(state[1]))
    jrgb, jlab = jema.lab_ema_step(jnp.asarray(a), jnp.asarray(state[1]))
    _close(rgb.numpy(), jrgb)
