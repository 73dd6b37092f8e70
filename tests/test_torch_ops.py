"""PyTorch port ops vs the JAX package's ops, on the CPU.

Same numpy inputs (seeded) through both; f32 comparisons are bounded at
1e-5 max abs unless stated. LAB comparisons use the mean error and the
share of values beyond 1/255 (of the 0..255 byte scale for LAB planes):
a/b are wrapped signed bytes, so a one-ulp cube-root difference can carry
a value across the wrap, which a max-error bound would count as 255.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from neuralstyletransferv1_tpu.ops import blur as jblur
from neuralstyletransferv1_tpu.ops import color as jcolor
from neuralstyletransferv1_tpu.ops import conv as jconv
from neuralstyletransferv1_tpu.ops import norm as jnorm
from neuralstyletransferv1_tpu.ops import pad as jpad
from neuralstyletransferv1_tpu.ops import resize as jresize
from neuralstyletransferv1_tpu.ops import warp as jwarp
from neuralstyletransferv1_torch.ops import blur, color, conv, norm, pad, resize, warp

F32_TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _maxdiff(a, b):
    return float(np.max(np.abs(_np(a).astype(np.float64) - _np(b).astype(np.float64))))


@pytest.mark.parametrize("p", [1, 4, (2, 3)])
def test_reflect_pad(p):
    x = _rng().random((2, 11, 13, 3)).astype(np.float32)
    assert _maxdiff(pad.reflect_pad_2d(torch.from_numpy(x), p),
                    jpad.reflect_pad_2d(jnp.asarray(x), p)) == 0.0


@pytest.mark.parametrize("k,stride", [(9, 1), (3, 2), (3, 1)])
def test_conv2d(k, stride):
    rng = _rng(1)
    x = rng.standard_normal((2, 17, 19, 8)).astype(np.float32)
    w = rng.standard_normal((k, k, 8, 6)).astype(np.float32) * 0.1   # HWIO
    b = rng.standard_normal(6).astype(np.float32)
    ours = conv.conv2d(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                       torch.from_numpy(b), stride=stride)
    ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride)
    assert ours.shape == ref.shape
    assert _maxdiff(ours, ref) <= F32_TOL


def test_instance_norm():
    rng = _rng(2)
    x = (rng.standard_normal((2, 9, 11, 5)) * 3 + 1).astype(np.float32)
    s = rng.standard_normal(5).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    ours = norm.instance_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b))
    ref = jnorm.instance_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    assert _maxdiff(ours, ref) <= F32_TOL


@pytest.mark.parametrize("factor", [2, 4, 8, 16])
def test_resize_downsample_antialias(factor):
    """jax.image.resize antialiases every downsample; exact factors as in the
    ds2 flow input and the DIS pyramid."""
    x = (_rng(3).random((2, 96, 160, 1)) * 255).astype(np.float32)
    hw = (96 // factor, 160 // factor)
    assert _maxdiff(resize.resize_bilinear(torch.from_numpy(x), hw),
                    jresize.resize_bilinear(jnp.asarray(x), hw)) <= 1e-5 * 255


@pytest.mark.parametrize("src,dst", [((135, 240), (67, 120)), ((135, 240), (33, 60)),
                                     ((16, 30), (33, 60)), ((33, 60), (135, 240))])
def test_resize_pyramid_shapes(src, dst):
    """The 1080p/ds2 pyramid's non-integer factors (540 >> 3 = 67) and the
    coarse-to-fine flow upsamples."""
    x = _rng(4).standard_normal((2,) + src + (2,)).astype(np.float32)
    assert _maxdiff(resize.resize_bilinear(torch.from_numpy(x), dst),
                    jresize.resize_bilinear(jnp.asarray(x), dst)) <= F32_TOL


@pytest.mark.parametrize("factor", [2, 4])
def test_resize_upsample(factor):
    x = _rng(5).standard_normal((12, 20, 2)).astype(np.float32)
    hw = (12 * factor, 20 * factor)
    assert _maxdiff(resize.resize_bilinear(torch.from_numpy(x), hw),
                    jresize.resize_bilinear(jnp.asarray(x), hw)) <= F32_TOL


def test_upsample_nearest():
    x = _rng(6).random((2, 5, 7, 3)).astype(np.float32)
    assert _maxdiff(resize.upsample_nearest(torch.from_numpy(x)),
                    jresize.upsample_nearest(jnp.asarray(x))) == 0.0


@pytest.mark.parametrize("shape,sigma", [((13, 17), 3.0), ((13, 17, 2), 1.0),
                                         ((3, 20, 24, 1), 3.0)])
def test_gaussian_blur(shape, sigma):
    x = _rng(7).random(shape).astype(np.float32)
    assert _maxdiff(blur.gaussian_blur(torch.from_numpy(x), sigma),
                    jblur.gaussian_blur(jnp.asarray(x), sigma)) <= F32_TOL


def test_rgb_to_gray():
    x = (_rng(8).random((2, 9, 10, 3)) * 255).astype(np.float32)
    assert _maxdiff(color.rgb_to_gray(torch.from_numpy(x)),
                    jcolor.rgb_to_gray(jnp.asarray(x))) <= 1e-5 * 255


def test_lab_roundtrip_vs_jax():
    x = _rng(9).random((4, 32, 48, 3)).astype(np.float32)
    lab = color.rgb_to_lab_u8(torch.from_numpy(x))
    jlab = jcolor.rgb_to_lab_u8(jnp.asarray(x))
    d = np.abs(_np(lab) - _np(jlab))
    d = np.minimum(d, 256.0 - d)  # the a/b planes wrap at 256
    assert d.mean() < 1e-3, d.mean()
    assert (d > 1.0).mean() < 1e-3

    back = color.lab_u8_to_rgb(torch.from_numpy(np.array(jlab)))
    jback = jcolor.lab_u8_to_rgb(jlab)
    e = np.abs(_np(back) - _np(jback))
    assert e.mean() < 1e-5, e.mean()
    assert (e > 1 / 255).mean() < 1e-3


def _warp_inputs(seed=10, H=15, W=21):
    rng = _rng(seed)
    img = rng.random((H, W, 3)).astype(np.float32)
    # large enough to reach every border
    flow = rng.normal(0, 4.0, (H, W, 2)).astype(np.float32)
    return img, flow


def test_warp_flow_exact():
    img, flow = _warp_inputs()
    assert _maxdiff(warp.warp_flow(torch.from_numpy(img), torch.from_numpy(flow)),
                    jwarp.warp_flow(jnp.asarray(img), jnp.asarray(flow))) <= F32_TOL


def test_warp_flow_packed_u8():
    """The int32 corner packing (sign byte included) unpacks to the JAX
    values; the u8 contract vs the exact warp holds too."""
    img, flow = _warp_inputs(11)
    img[0, 0] = 1.0  # a 255 corner in the sign byte
    ours = warp.warp_flow_packed_u8(torch.from_numpy(img), torch.from_numpy(flow))
    ref = jwarp.warp_flow_packed_u8(jnp.asarray(img), jnp.asarray(flow))
    assert _maxdiff(ours, ref) <= F32_TOL
    exact = warp.warp_flow(torch.from_numpy(img), torch.from_numpy(flow))
    assert float((ours - exact).abs().mean()) < 2e-3
