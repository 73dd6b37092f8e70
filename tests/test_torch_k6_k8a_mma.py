"""K6 (``d3_s8_site``) and K8a (``c2_site``) of the PyTorch port vs the JAX
package, on the CPU, at the shapes that meet the edges of their
tensor-core kernels' tiling.

On the card K6 runs on ``d3s8_mma_kernel`` (warps walk 32-column strips
down the image, five rows of partial sums a pixel) and K8a on
``mma_s2_kernel`` (8×16 output tiles at stride 2), held bit for bit against
their plain versions by ``tests/test_torch_policy.py`` (``-m cuda``). Here
the plain versions meet the interpret-mode Pallas kernels of
``models/s2d2_sites_i8.py``: K6 at heights below the 5-row dy-sum and
widths off the strip; K8a at even sizes off the output tile, at the floor 0
(``c2p_site``, on its column-pair view) and −127 (``c2p_site`` is built
with the floor 0, so the stride-1 ``res_site`` at the even output pixels
stands in: a stride-2 3×3 conv over an even size never reads the bottom or
right halo). Interpret-mode XLA contracts acc·ws + bias into an FMA where
the port rounds the product (``tests/test_torch_int8.py``), so the K8a
cases take power-of-two dequant scales: the product is exact, and so the
outputs must be bit-identical. CPU tensors take the plain versions, and the
previous ``__dp4a`` forms refuse them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_tpu.models import transformer_net_s2d as s2dj
from neuralstyletransferv1_torch.kernels import int8_sites as k8


def _interpret(fn, *args, **kw):
    si8._INTERPRET = True
    try:
        return jax.tree.map(np.asarray, fn(*args, **kw))
    finally:
        si8._INTERPRET = False


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _f32(ref):
    return np.asarray(jnp.asarray(ref).astype(jnp.float32))


def _d3_operands(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return {"w5": rng.integers(-127, 128, (1, 5, 128, 60)).astype(np.int8),
            "ws": np.asarray(rng.uniform(0.5, 2, 60) / (127 * 127 * 20), np.float32),
            "codes": rng.integers(0, 128, (b, h, w, 128)).astype(np.int8),
            "bias": np.asarray(rng.normal(0, 0.2, 12), np.float32)}


def _k6(d):
    wk = k8.pack_weights(torch.from_numpy(d["w5"]), co_pad=k8.CO_TILE)
    ws = torch.cat([torch.from_numpy(d["ws"]), torch.zeros(4)])
    return torch.from_numpy(d["codes"]), wk, ws, torch.from_numpy(d["bias"])


# (B, H, W): heights below the 5-row dy-sum, widths off the 32-column strip
# and off 16 (the Pallas kernel's zero2 carry takes any width)
@pytest.mark.parametrize("b,h,w", [(1, 3, 13), (2, 4, 20), (1, 5, 37), (1, 8, 33)])
def test_k6_short_and_ragged_match_pallas(b, h, w):
    """K6's plain version against ``d3_s8_site`` in interpret mode: bit for
    bit (the dy-sum adds exact bf16 K lanes in f32 in the same order)."""
    d = _d3_operands(20 + h + w, b, h, w)
    carry = jnp.pad(jnp.asarray(d["codes"]), ((0, 0), (0, 0), (2, si8._wps2(w) - w - 2), (0, 0)))
    ref = _interpret(si8.d3_s8_site, carry, jnp.asarray(d["w5"][0]), jnp.asarray(d["ws"]),
                     jnp.asarray(d["bias"]), w0=w)
    before = dict(k8.LAUNCHES)
    ours = k8.d3_s8_site(*_k6(d))
    assert k8.LAUNCHES == before
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (b, h, w, 12)
    assert np.array_equal(ours.float().numpy(), _f32(ref))


def _c2_operands(seed, b, h, w):
    """K8a's operands, the dequant scales powers of two (see the module
    docstring)."""
    rng = np.random.default_rng(seed)
    return {"x": _bf16(rng.normal(0, 2, (b, h, w, 32))),
            "a": np.asarray(rng.uniform(5, 40, (b, 32)), np.float32),
            "c": np.asarray(rng.normal(0, 8, (b, 32)), np.float32),
            "w": rng.integers(-127, 128, (3, 3, 32, 64)).astype(np.int8),
            "ws": np.asarray(2.0 ** -rng.integers(17, 21, 64), np.float32),
            "bias": np.asarray(rng.normal(0, 0.2, 64), np.float32)}


def _k8a(d, lo):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    return k8.c2_site(t["x"].to(torch.bfloat16), t["a"], t["c"], lo, k8.pack_weights(t["w"]),
                      t["ws"], t["bias"])


def _assert_sums(sums, want, n):
    """[Σ, Σ²] within 1e-5: Σ² relative, Σ of the magnitude it could cancel
    from (at most sqrt(n·Σ²))."""
    got = sums.numpy().astype(np.float64)
    s2 = np.abs(want[:, 1])
    assert np.all(np.abs(got[:, 1] - want[:, 1]) <= 1e-5 * s2)
    assert np.all(np.abs(got[:, 0] - want[:, 0]) <= 1e-5 * np.sqrt(n * s2))


# (B, H, W): even, the output off the 8×16 tile (H/2 = 10 and 9 rows, W/2 =
# 18 and 22 columns)
@pytest.mark.parametrize("b,h,w", [(1, 20, 36), (2, 18, 44)])
def test_k8a_floor0_off_tile_matches_pallas(b, h, w):
    """K8a at the floor 0 against ``c2p_site`` on its column-pair view of
    the space-to-depth tensor: bf16 raw bit for bit, sums within 1e-5."""
    d = _c2_operands(30 + h + w, b, h, w)
    wblk = s2dj._scatter_stride2_s2d2(d["w"].astype(np.float32)).astype(np.int8)
    yp = np.asarray(s2dj.s2d(jnp.asarray(d["x"]), 2)).reshape(b, h // 2, w // 4, 256)
    ref, sout = _interpret(
        si8.c2p_site, jnp.asarray(yp, jnp.bfloat16), jnp.tile(jnp.asarray(d["a"]), (1, 8)),
        jnp.tile(jnp.asarray(d["c"]), (1, 8)), si8._pair_c2_weights(wblk),
        jnp.tile(jnp.asarray(d["ws"]), 2), jnp.tile(jnp.asarray(d["bias"]), 2))
    ours, sums = _k8a(d, 0.0)
    assert tuple(ours.shape) == (b, h // 2, w // 2, 64)
    assert np.array_equal(ours.float().numpy(), _f32(ref).reshape(b, h // 2, w // 2, 64))
    _assert_sums(sums, np.asarray(sout, np.float64).reshape(b, 2, 2, 64).sum(axis=2),
                 (h // 2) * (w // 2))


# (B, H, W): an output of 7 rows (no row strip of c2p_site divides it), a
# batch of 3, and the smallest even image (one output row of 2 pixels)
@pytest.mark.parametrize("b,h,w", [(1, 20, 36), (3, 14, 28), (1, 2, 4)])
def test_k8a_floor_m127_off_tile_matches_pallas(b, h, w):
    """K8a at the floor −127 against the stride-1 ``res_site`` (the same
    quantize, conv and dequant) at the even output pixels: bit for bit, sums
    within 1e-5 of the f64 sums of those pixels."""
    d = _c2_operands(40 + h + w, b, h, w)
    ref, _ = _interpret(si8.res_site, jnp.asarray(d["x"], jnp.bfloat16), jnp.asarray(d["a"]),
                        jnp.asarray(d["c"]), jnp.asarray(d["w"]).reshape(9, 32, 64),
                        jnp.asarray(d["ws"]), jnp.asarray(d["bias"]), -127.0, halo="reflect")
    ref = _f32(ref)[:, ::2, ::2]
    ours, sums = _k8a(d, -127.0)
    assert np.array_equal(ours.float().numpy(), ref)
    r = ref.astype(np.float64)
    _assert_sums(sums, np.stack([r.sum(axis=(1, 2)), (r * r).sum(axis=(1, 2))], axis=1),
                 (h // 2) * (w // 2))


def _cpu_args(name):
    if name.startswith("c2_site"):
        d = _c2_operands(50, 2, 10, 20)
        t = {k: torch.from_numpy(v) for k, v in d.items()}
        return (t["x"].to(torch.bfloat16), t["a"], t["c"], 0.0, k8.pack_weights(t["w"]),
                t["ws"], t["bias"])
    return _k6(_d3_operands(51, 2, 7, 20))


@pytest.mark.parametrize("name", ["c2_site_prev", "d3_s8_site_prev"])
def test_prev_forms_refuse_cpu_tensors(name):
    before = dict(k8.LAUNCHES)
    with pytest.raises(NotImplementedError, match="no kernel for device cpu"):
        getattr(k8, name)(*_cpu_args(name))
    assert k8.LAUNCHES == before


@pytest.mark.parametrize("name", ["c2_site", "d3_s8_site"])
def test_cpu_tensors_take_the_plain_versions(name):
    """On CPU tensors K8a and K6 return their plain versions' results and
    count no launch, from a view 2 bytes off a 16-byte boundary too (only
    the card's cores read 16-byte chunks)."""
    args = list(_cpu_args(name))
    x = args[0]
    k = 2 // x.element_size()
    off = torch.empty(x.numel() + k, dtype=x.dtype)[k:].view(x.shape)
    off.copy_(x)
    args[0] = off
    before = dict(k8.LAUNCHES)
    got, want = getattr(k8, name)(*args), getattr(k8, f"{name}_plain")(*args)
    got, want = (v if isinstance(v, tuple) else (v,) for v in (got, want))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert k8.LAUNCHES == before
