"""DIS flow of the PyTorch port vs the JAX package, on the CPU.

K1's plain version (``kernels/dis_iter.dis_iter_plain``, what the wrapper
runs for CPU tensors) against the Pallas kernel ``_iter_search_pallas`` in
interpret mode, then one pyramid level, the variational refinement and the
whole batched ``dis_flow`` against ``jax.vmap(dis_flow)``.

The bounds sit well above the measured differences (noted beside each):
the Gauss–Newton sums run in another order, and a last-bit change of the
offset can move ``floor(o)`` across a bilinear cell edge, after which the
two runs take different steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralstyletransferv1_tpu.ops import dis_flow as jdis
from neuralstyletransferv1_torch.kernels import dis_iter as k1
from neuralstyletransferv1_torch.ops import dis_flow as tdis

B, H, W = 2, 144, 256


def _pairs(seed=0):
    """B textured frame pairs, the second a sub-pixel shift of the first."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    prev, curr = [], []
    for b in range(B):
        ph = rng.random(4) * 6.0
        dx, dy = 1.5 + b, -0.75 * (b + 1)

        def img(x, y):
            return (128 + 50 * np.sin(0.21 * x + 0.13 * y + ph[0])
                    + 35 * np.cos(0.11 * x - 0.27 * y + ph[1])
                    + 20 * np.sin(0.05 * x * np.cos(ph[2]) + 0.07 * y))

        prev.append(img(xx, yy))
        curr.append(img(xx - dx, yy - dy))
    noise = rng.normal(0, 2.0, (2, B, H, W))
    return ((np.stack(prev) + noise[0]).astype(np.float32),
            (np.stack(curr) + noise[1]).astype(np.float32))


@pytest.fixture(scope="module")
def level_inputs():
    """One level at 36×64 (the finest of the 144×256 pyramid) with a
    non-zero init flow, as numpy arrays [B,ny,nx,...]."""
    prev, curr = _pairs()
    a = np.array(jax.image.resize(jnp.asarray(prev), (B, 36, 64), "linear"))
    c = np.array(jax.image.resize(jnp.asarray(curr), (B, 36, 64), "linear"))
    init = np.random.default_rng(1).normal(0.5, 0.6, (B, 36, 64, 2)).astype(np.float32)
    ins = tdis._level_inputs(torch.from_numpy(a), torch.from_numpy(c), torch.from_numpy(init))
    return a, c, init, {k: v.contiguous().numpy() for k, v in ins.items()}


def test_k1_plain_vs_pallas(level_inputs):
    _, _, _, ins = level_inputs
    ny, nx = ins["t"].shape[1:3]
    n = B * ny * nx
    flat = {k: torch.from_numpy(v.reshape((n,) + v.shape[3:])) for k, v in ins.items()}
    before = k1.LAUNCHES
    u, res = k1.dis_iter(**flat, iters=16, R=6)
    assert k1.LAUNCHES == before  # CPU tensors take the plain version
    run = jax.jit(jax.vmap(lambda *xs: jdis._iter_search_pallas(*xs, 16, 6)))
    ju, jres = run(*(ins[k] for k in ("nb", "t", "gx", "gy", "hxx", "hxy", "hyy", "det",
                                      "u0", "lo")))
    ju = np.asarray(ju).reshape(n, 2)
    jres = np.asarray(jres).reshape(n)
    # measured on this input: max offset diff 4.8e-7 px, residual 7.6e-6
    du = np.abs(u.numpy() - ju).max(axis=1)
    same = du <= 1e-4
    assert same.mean() >= 0.99, same.mean()  # offsets within 1e-4 px on >= 99% of patches
    assert np.abs(res.numpy() - jres)[same].max() <= 1e-3  # residual, grey levels


def test_inverse_search_level(level_inputs):
    a, c, init, _ = level_inputs
    ours = tdis._inverse_search_level(torch.from_numpy(a), torch.from_numpy(c),
                                      torch.from_numpy(init), 16).numpy()
    ref = np.asarray(jax.jit(jax.vmap(
        lambda x, y, f: jdis._inverse_search_level(x, y, f, 16)))(a, c, init))
    assert np.abs(ours - ref).mean() <= 1e-3  # px; measured 1e-7


def test_variational_refine(level_inputs):
    a, c, init, _ = level_inputs
    ours = tdis.variational_refine(torch.from_numpy(a), torch.from_numpy(c),
                                   torch.from_numpy(init)).numpy()
    ref = np.asarray(jax.vmap(jdis.variational_refine)(a, c, init))
    assert np.abs(ours - ref).max() <= 1e-5  # px; measured 4.8e-7


def test_level_sizes_match():
    for hw in ((540, 960), (144, 256), (64, 96)):
        assert tdis._level_sizes(*hw, 2) == jdis._level_sizes(*hw, 2)
    assert [s[:2] for s in tdis._level_sizes(540, 960, 2)] == \
        [(16, 30), (33, 60), (67, 120), (135, 240)]


def test_dis_flow_batched_vs_vmap():
    prev, curr = _pairs(2)
    ours = tdis.dis_flow(torch.from_numpy(prev), torch.from_numpy(curr)).numpy()
    ref = np.asarray(jax.jit(jax.vmap(jdis.dis_flow))(prev, curr))
    assert ours.shape == ref.shape == (B, H, W, 2)
    assert np.abs(ours - ref).mean() <= 1e-3  # px; measured 6.9e-7 (max 6.2e-6)
    inner = ours[:, 24:-24, 24:-24]
    for b in range(B):  # and it recovers the synthetic shift
        assert abs(inner[b, ..., 0].mean() - (1.5 + b)) < 0.3
        assert abs(inner[b, ..., 1].mean() + 0.75 * (b + 1)) < 0.3
