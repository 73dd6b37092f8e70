"""K8b (``c3_site``) and K9b (``d3_sum_site``) of the PyTorch port vs the JAX
package, on the CPU, at the shapes that meet the edges of their
tensor-core kernels' tiling.

On the card K8b runs on ``mma_s2_kernel`` (8×16 output tiles at stride 2,
the int8 tensor cores) and K9b on ``d3sum_mma_kernel`` (warps walk
16-column strips down the image, five rows of partial sums a pixel, the
bf16 tensor cores); ``tests/test_torch_policy.py`` (``-m cuda``) holds them
against their plain versions and their previous designs there. Here the
plain versions meet the interpret-mode Pallas kernels: K8b against
``c3p_site`` of ``models/s2d2_sites_i8.py`` on its column-pair view, at the
floor 0 (the Pallas kernel's), at even sizes whose output falls off the
8×16 tile, with power-of-two dequant scales (interpret-mode XLA contracts
acc·ws + bias into an FMA where the port rounds the product; a
power-of-two scale makes the product exact), bit for bit, sums within 1e-5;
K9b against ``_d3_sum_site`` of ``models/s2d2_sites.py`` on its halo buffer,
at heights below the 5-row dy-sum and widths off the 16-column strip,
within 2 bf16 ulp of the largest of an element's five row terms (both sides
accumulate the conv rows in f32 in their own order, and each bf16 row term
may differ by an ulp of its own size). CPU tensors take the plain
versions, and the previous forms refuse them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16_sites import assert_close_bf16
from test_torch_k6_k8a_mma import _assert_sums, _bf16, _f32, _interpret

from neuralstyletransferv1_tpu.models import s2d2_sites as sj
from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_tpu.models import transformer_net_s2d2 as s2d2
from neuralstyletransferv1_torch.kernels import bf16_sites as k9
from neuralstyletransferv1_torch.kernels import int8_sites as k8


def _c3_operands(seed, b, h, w):
    """K8b's operands, the dequant scales powers of two (see the module
    docstring)."""
    rng = np.random.default_rng(seed)
    return {"x": _bf16(rng.normal(0, 2, (b, h, w, 64))),
            "a": np.asarray(rng.uniform(5, 40, (b, 64)), np.float32),
            "c": np.asarray(rng.normal(0, 8, (b, 64)), np.float32),
            "w": rng.integers(-127, 128, (3, 3, 64, 128)).astype(np.int8),
            "ws": np.asarray(2.0 ** -rng.integers(17, 21, 128), np.float32),
            "bias": np.asarray(rng.normal(0, 0.2, 128), np.float32)}


def _k8b_args(d, lo=0.0):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    return (t["x"].to(torch.bfloat16), t["a"], t["c"], lo, k8.pack_weights(t["w"]), t["ws"],
            t["bias"])


# (B, H, W): even, the output off the 8×16 tile (H/2 = 10 and 9 rows, W/2 =
# 18 and 22 columns)
@pytest.mark.parametrize("b,h,w", [(1, 20, 36), (2, 18, 44)])
def test_k8b_floor0_off_tile_matches_pallas(b, h, w):
    """K8b at the floor 0 against ``c3p_site`` on its column-pair view of
    the conv2 raw: bf16 raw bit for bit, sums within 1e-5."""
    d = _c3_operands(60 + h + w, b, h, w)
    ref, sout = _interpret(
        si8.c3p_site, jnp.asarray(d["x"].reshape(b, h, w // 2, 128), jnp.bfloat16),
        jnp.tile(jnp.asarray(d["a"]), (1, 2)), jnp.tile(jnp.asarray(d["c"]), (1, 2)),
        si8._pair_c3_weights(d["w"]), jnp.asarray(d["ws"]), jnp.asarray(d["bias"]))
    before = dict(k8.LAUNCHES)
    ours, sums = k8.c3_site(*_k8b_args(d))
    assert k8.LAUNCHES == before
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (b, h // 2, w // 2, 128)
    assert np.array_equal(ours.float().numpy(), _f32(ref))
    _assert_sums(sums, np.asarray(sout, np.float64), (h // 2) * (w // 2))


def _d3_operands(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return {"y": _bf16(rng.normal(0, 1.5, (b, h, w, 128))),
            "a": np.tile(np.asarray(rng.uniform(0.5, 1.5, (b, 32)), np.float32), (1, 4)),
            "c": np.tile(np.asarray(rng.normal(0, 0.3, (b, 32)), np.float32), (1, 4)),
            "w": _bf16(rng.normal(0, 640 ** -0.5, (1, 5, 128, 60))),
            "bias": _bf16(rng.normal(0, 0.2, 12))}


def _k9b_args(d):
    t = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in d.items()}
    return (t["y"].to(torch.bfloat16), t["a"], t["c"], k9.pack_rows_weights(t["w"]), t["bias"])


def _d3_sum_pallas(d):
    """``_d3_sum_site`` in interpret mode on the halo buffer: the 4-pixel
    reflect-padded input (rows and columns past it zero), 8-row output
    strips, a width padded to 8 → [B,H,W,12] f32."""
    b, h, w, _ = d["y"].shape
    ho, wp = 8 * -(-h // 8), 8 * -(-(w + 4) // 8)
    yp = s2d2._pad_reflect_f2_4px(jnp.asarray(d["y"], jnp.bfloat16), 32)
    y5 = jnp.pad(yp, ((0, 0), (0, ho + 8 - h - 4), (0, wp - w - 4), (0, 0)))
    sj._INTERPRET = True
    try:
        ref = sj._d3_sum_site(y5, jnp.asarray(d["a"]), jnp.asarray(d["c"]),
                              jnp.asarray(d["w"], jnp.bfloat16), jnp.asarray(d["bias"]),
                              ho=ho, w2=w, wp=wp)
    finally:
        sj._INTERPRET = False
    return np.asarray(ref[:, :h, :, :12].astype(jnp.float32))


# (B, H, W): heights below the 5-row dy-sum, widths off the 16-column strip
@pytest.mark.parametrize("b,h,w", [(1, 3, 13), (2, 4, 20), (1, 5, 37), (1, 9, 33)])
def test_k9b_short_and_ragged_match_pallas(b, h, w):
    """K9b's plain version against ``_d3_sum_site`` in interpret mode: within
    2 ulp of the largest of an element's five row terms, 99% equal."""
    d = _d3_operands(70 + h + w, b, h, w)
    ref = _d3_sum_pallas(d)
    args = _k9b_args(d)
    before = dict(k9.LAUNCHES)
    ours = k9.d3_sum_site(*args)
    assert k9.LAUNCHES == before
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (b, h, w, 12)
    assert_close_bf16(ours, ref, limit=2.0, scale=k9.d3_sum_scale_plain(*args[:4]))


def _cpu_args(name):
    if name.startswith("c3_site"):
        return _k8b_args(_c3_operands(80, 2, 10, 20))
    return _k9b_args(_d3_operands(81, 2, 7, 20))


_MODULES = {"c3_site": k8, "d3_sum_site": k9}


@pytest.mark.parametrize("name", ["c3_site_prev", "d3_sum_site_prev"])
def test_prev_forms_refuse_cpu_tensors(name):
    mod = _MODULES[name[:-5]]
    before = dict(mod.LAUNCHES)
    with pytest.raises(NotImplementedError, match="no kernel for device cpu"):
        getattr(mod, name)(*_cpu_args(name))
    assert mod.LAUNCHES == before


@pytest.mark.parametrize("name", ["c3_site", "d3_sum_site"])
def test_cpu_tensors_take_the_plain_versions(name):
    """On CPU tensors K8b and K9b return their plain versions' results and
    count no launch, from a view 2 bytes off a 16-byte boundary too (only
    the card's cores read 16-byte chunks)."""
    mod = _MODULES[name]
    args = list(_cpu_args(name))
    x = args[0]
    k = 2 // x.element_size()
    off = torch.empty(x.numel() + k, dtype=x.dtype)[k:].view(x.shape)
    off.copy_(x)
    args[0] = off
    before = dict(mod.LAUNCHES)
    got, want = getattr(mod, name)(*args), getattr(mod, f"{name}_plain")(*args)
    got, want = (v if isinstance(v, tuple) else (v,) for v in (got, want))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert mod.LAUNCHES == before
