"""DeepLabV3+ in the port (``models/deeplab.py``, ``deeplab_backbones.py``),
its align-corners resize and the mask morphology, held against the JAX
package on the CPU.

The weights are seeded reference-format state dicts
(``deeplab.init_state_dict``) at narrow widths with their BN running
statistics perturbed, fed to both importers; the inputs come from numpy
seeds. The JAX side is jitted once per backbone and shared. The ``cuda``
case imports no JAX (the card's machine runs it with ``--noconftest``):
the full-width ResNet-101 on the card against the port on the CPU, f32.
"""

import numpy as np
import pytest
import torch

from neuralstyletransferv1_torch.models import deeplab as tdl
from neuralstyletransferv1_torch.ops import morphology as tmorph
from neuralstyletransferv1_torch.ops.resize import resize_bilinear_align_corners

BACKBONES = ("resnet", "mobilenet", "xception", "drn")
WIDTH = 0.125
HW = (65, 97)


def perturbed_state_dict(backbone, seed=0, width=WIDTH, num_classes=21):
    """``init_state_dict`` with the running statistics moved off 0 / 1, as the
    JAX package's DeepLab tests do: mean + N(0, 0.1), var · U[0.75, 1.25)."""
    sd = tdl.init_state_dict(backbone, num_classes, seed=seed, width=width)
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = v + torch.randn(v.shape, generator=g) * 0.1
        elif k.endswith("running_var"):
            sd[k] = v * (torch.rand(v.shape, generator=g) * 0.5 + 0.75)
    return sd


@pytest.fixture(scope="module")
def jax_side():
    """Per backbone: the state dict, JAX's imported tree and its jitted apply."""
    import jax

    from neuralstyletransferv1_tpu.models import deeplab as jdl

    cache = {}

    def get(backbone):
        if backbone not in cache:
            sd = perturbed_state_dict(backbone)
            tree, nc = jdl.import_deeplab({k: v.numpy() for k, v in sd.items()}, backbone=backbone)
            fn = jax.jit(lambda p, x: jdl.apply(p, x, backbone=backbone))
            cache[backbone] = (sd, tree, nc, fn)
        return cache[backbone]

    return get


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# import, detection, the seeded state dict
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefix", ["", "module."])
@pytest.mark.parametrize("backbone", BACKBONES)
def test_import_matches_params_from_jax(jax_side, backbone, prefix):
    """The port's importer of a reference state dict (``module.`` prefixed or
    not, ``num_batches_tracked`` present) equals ``params_from_jax`` of JAX's
    import, key for key and bit for bit."""
    import jax

    sd, tree, nc, _ = jax_side(backbone)
    state, tnc = tdl.import_deeplab({prefix + k: v for k, v in sd.items()}, backbone=backbone)
    want = tdl.params_from_jax(jax.tree.map(np.asarray, tree))
    assert (tnc, nc) == (21, 21)
    assert sorted(state) == sorted(want)
    for k in state:
        assert state[k].dtype == torch.float32
        assert torch.equal(state[k], want[k]), k


@pytest.mark.parametrize("keys,want", [
    (["backbone.features.0.0.weight", "backbone.layer1.0.conv1.weight"], "mobilenet"),
    (["module.backbone.layer0.0.weight", "backbone.layer1.0.weight"], "drn"),
    (["backbone.block1.rep.0.conv1.weight"], "xception"),
    (["module.backbone.layer1.0.conv1.weight", "aspp.conv1.weight"], "resnet"),
    ([], "resnet"),
])
def test_detect_backbone(keys, want):
    from neuralstyletransferv1_tpu.models import deeplab as jdl

    sd = dict.fromkeys(keys, np.zeros(1, np.float32))
    assert tdl.detect_backbone(sd) == jdl.detect_backbone(sd) == want


@pytest.mark.parametrize("heads,want", [
    ([19, 256], 19), ([256, 21], 21), ([21, 19], 19), ([150, 80], 150), ([80, 7], 80),
    ([256, 7], 7), ([], 21),
])
def test_detect_num_classes(heads, want):
    """1×1 heads preferring 19, 21, 150, 80, else the last; 3×3 kernels and
    non-weight keys never count."""
    from neuralstyletransferv1_tpu.models import deeplab as jdl

    sd = {f"head{i}.weight": np.zeros((n, 4, 1, 1), np.float32) for i, n in enumerate(heads)}
    sd["decoder.last_conv.0.weight"] = np.zeros((21, 4, 3, 3), np.float32)
    sd["aspp.bn1.running_mean"] = np.zeros((19,), np.float32)
    assert tdl.detect_num_classes(sd) == jdl.detect_num_classes(sd) == want
    assert tdl.detect_num_classes({k: torch.from_numpy(v) for k, v in sd.items()}) == want


def test_init_state_dict_layout_and_statistics():
    """The seeded state dict: the reference key layout, reproducible from the
    seed, BN at identity, Kaiming-normal convs (std √(2/fan_in)), the
    classifier's bias within ±1/√fan_in; ``width`` narrows channels only."""
    sd = tdl.init_state_dict("resnet", 21, seed=3)
    again = tdl.init_state_dict("resnet", 21, seed=3)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["backbone.conv1.weight"], tdl.init_state_dict("resnet", 21, seed=4)["backbone.conv1.weight"])
    assert sd["backbone.conv1.weight"].shape == (64, 3, 7, 7)
    assert sd["backbone.layer3.22.conv3.weight"].shape == (1024, 256, 1, 1)
    assert sd["backbone.layer4.0.downsample.0.weight"].shape == (2048, 1024, 1, 1)
    assert "backbone.layer4.3.conv1.weight" not in sd  # the multi-grid unit has 3 blocks
    assert sd["aspp.conv1.weight"].shape == (256, 1280, 1, 1)
    assert sd["decoder.last_conv.0.weight"].shape == (256, 304, 3, 3)
    assert sd["decoder.last_conv.8.weight"].shape == (21, 256, 1, 1)
    w = sd["backbone.layer3.5.conv2.weight"]
    assert abs(w.std().item() / np.sqrt(2.0 / (256 * 9)) - 1) < 0.02
    assert sd["decoder.last_conv.8.bias"].abs().max() <= 1 / np.sqrt(256)
    assert torch.equal(sd["aspp.bn1.weight"], torch.ones(256))
    assert torch.equal(sd["aspp.bn1.running_var"], torch.ones(256))
    assert torch.equal(sd["aspp.bn1.running_mean"], torch.zeros(256))
    assert sd["aspp.bn1.num_batches_tracked"].dtype == torch.int64
    narrow = tdl.init_state_dict("resnet", 21, seed=3, width=WIDTH)
    assert sorted(narrow) == sorted(sd)
    assert narrow["backbone.layer4.2.conv3.weight"].shape == (256, 64, 1, 1)


@pytest.mark.parametrize("backbone,low,high", [("mobilenet", 24, 320), ("xception", 128, 2048),
                                               ("drn", 256, 512)])
def test_backbone_state_dicts_at_published_widths(backbone, low, high):
    """The other backbones' seeded state dicts at full width: the decoder's
    low-level input and ASPP's input channels of the reference model."""
    sd = tdl.init_state_dict(backbone, 19, seed=0)
    assert sd["decoder.conv1.weight"].shape == (48, low, 1, 1)
    assert sd["aspp.aspp1.atrous_conv.weight"].shape == (256, high, 1, 1)
    assert tdl.detect_backbone(sd) == backbone
    assert tdl.detect_num_classes(sd) == 19


def test_deeplab_rejects_unknown_backbone():
    with pytest.raises(ValueError, match="backbone"):
        tdl.init_state_dict("vgg")
    with pytest.raises(ValueError, match="backbone"):
        tdl.DeepLab({}, backbone="vgg")


# ---------------------------------------------------------------------------
# the forward against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backbone", BACKBONES)
def test_logits_match_jax(jax_side, backbone):
    """f32 logits at 65×97 (odd sizes: the stem pool and the align-corners
    resizes off the grid): relative MAE ≤ 1e-4, argmax ≥ 99.9% equal."""
    import jax.numpy as jnp

    sd, tree, _, fn = jax_side(backbone)
    x = _x(0, (1, *HW, 3))
    want = np.asarray(fn(tree, jnp.asarray(x)))
    net = tdl.DeepLab(tdl.import_deeplab(sd, backbone=backbone)[0], backbone=backbone).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, *HW, 21)
    rel = np.abs(got - want).mean() / np.abs(want).mean()
    assert rel <= 1e-4, rel
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


@pytest.mark.parametrize("h,w", [(65, 97), (64, 96), (7, 7), (8, 9)])
def test_bn_and_stem_pool_match_jax(h, w):
    """``BN`` is the JAX ``_bn`` (f32: within 1e-6 on values up to ~8, a few
    ulp: XLA's rsqrt is not correctly rounded and its CPU code may contract
    ``x·scale + shift``; bf16 within 1 bf16 ulp), and the 3×3 stride-2 pool
    with −inf padding gives JAX's output size and values at odd and even
    sizes."""
    import jax.numpy as jnp

    from neuralstyletransferv1_tpu.models import deeplab as jdl

    rng = np.random.default_rng(h * w)
    x = rng.standard_normal((2, h, w, 8)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 2, 8), "bias": rng.normal(0, 1, 8),
         "mean": rng.normal(0, 1, 8), "var": rng.uniform(0.5, 2, 8)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    bn = tdl.BN(*(torch.from_numpy(p[k]) for k in ("scale", "bias", "mean", "var")))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for dt, jdt, rtol in ((torch.float32, jnp.float32, 1e-6), (torch.bfloat16, jnp.bfloat16, 2 ** -8)):
        got = bn(xt.to(dt)).permute(0, 2, 3, 1).float().numpy()
        want = np.asarray(jdl._bn(jnp.asarray(x, jdt), {k: jnp.asarray(v) for k, v in p.items()}),
                          np.float32)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)
    got = tdl._max_pool_3s2(xt).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jdl._max_pool_3s2(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the align-corners resize
# ---------------------------------------------------------------------------

_RESIZES = [((1, 17, 33, 5), (65, 129)), ((2, 65, 97, 3), (17, 25)), ((9, 14, 4), (9, 14)),
            ((1, 1, 6, 2), (4, 11)), ((1, 33, 33, 21), (129, 129))]


@pytest.mark.parametrize("shape,out_hw", _RESIZES)
def test_resize_align_corners_matches_jax(shape, out_hw):
    """f32 within 1e-6 (the same gathers and weights); bf16 within one bf16
    ulp of JAX on ≥ 99% of elements (the weights in bf16, each product and
    sum rounded)."""
    import jax.numpy as jnp

    from neuralstyletransferv1_tpu.ops.resize import resize_bilinear_align_corners as jresize

    x = _x(len(shape), shape) * 3
    got = resize_bilinear_align_corners(torch.from_numpy(x), out_hw).numpy()
    want = np.asarray(jresize(jnp.asarray(x), out_hw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    gb = resize_bilinear_align_corners(torch.from_numpy(x).bfloat16(), out_hw)
    assert gb.dtype == torch.bfloat16
    wb = np.asarray(jresize(jnp.asarray(x, jnp.bfloat16), out_hw), np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wb), 1e-30))) - 7)
    assert (np.abs(gb.float().numpy() - wb) <= ulp).mean() >= 0.99


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_integer_resize_upcasts_to_f32(dtype):
    """Queue 3, integer resize: an integer input is upcast to f32 and equals
    the resize of its float cast, where the JAX function (weights cast to the
    integer dtype, so 0) returns the top-left neighbour of every sample."""
    import jax.numpy as jnp

    from neuralstyletransferv1_tpu.ops.resize import resize_bilinear_align_corners as jresize

    x = np.random.default_rng(5).integers(0, 256, (1, 9, 13, 2))
    xi = torch.from_numpy(x).to(dtype)
    got = resize_bilinear_align_corners(xi, (17, 20))
    assert got.dtype == torch.float32
    assert torch.equal(got, resize_bilinear_align_corners(xi.float(), (17, 20)))
    fault = np.asarray(jresize(jnp.asarray(x, jnp.int32), (17, 20)))
    ys = np.floor(np.arange(17, dtype=np.float32) * np.float32(8 / 16)).astype(int)
    xs = np.floor(np.arange(20, dtype=np.float32) * np.float32(12 / 19)).astype(int)
    np.testing.assert_array_equal(fault, x[:, ys][:, :, xs])
    assert not np.array_equal(fault, got.numpy())


# ---------------------------------------------------------------------------
# the mask morphology
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["grey_erode", "morph_close", "max_pool_dilate", "grey_dilate"])
@pytest.mark.parametrize("kind", ["float", "int_as_float"])
def test_morphology_matches_jax(op, kind):
    """Erode, close and the gap fill's dilate vs JAX, bit for bit, on HW, HWC
    and NHWC floats, and on uint8 masks cast to float (JAX's erode does not
    trace on uint8); the port's integer input keeps its dtype."""
    import jax.numpy as jnp

    from neuralstyletransferv1_tpu.ops import morphology as jmorph

    rng = np.random.default_rng(11)
    for shape, k in (((37, 51), 5), ((20, 24, 3), 3), ((2, 16, 19, 1), 7)):
        if kind == "float":
            x = rng.standard_normal(shape).astype(np.float32)
        else:
            x = ((rng.random(shape) > 0.6) * 255).astype(np.uint8).astype(np.float32)
        got = getattr(tmorph, op)(torch.from_numpy(x), k).numpy()
        want = np.asarray(getattr(jmorph, op)(jnp.asarray(x), k))
        np.testing.assert_array_equal(got, want)
        if kind == "int_as_float":
            gi = getattr(tmorph, op)(torch.from_numpy(x.astype(np.uint8)), k)
            assert gi.dtype == torch.uint8
            np.testing.assert_array_equal(gi.numpy(), want.astype(np.uint8))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_resnet101_full_width_card_matches_cpu():
    """The full-width ResNet-101 DeepLab (OS16, 21 classes, seed 0) on the
    card vs the port on the CPU, f32 (TF32 off) at 129×129: relative logits
    MAE ≤ 1e-4, argmax ≥ 99.9% equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from neuralstyletransferv1_torch.device import resolve_device

    dev = resolve_device("cuda")
    state, _ = tdl.import_deeplab(tdl.init_state_dict("resnet", 21, seed=0))
    net = tdl.DeepLab(state).eval()
    x = torch.from_numpy(_x(1, (1, 129, 129, 3)))
    with torch.no_grad():
        want = net(x)
        got = net.to(dev)(x.to(dev)).cpu()
    rel = ((got - want).abs().mean() / want.abs().mean()).item()
    assert rel <= 1e-4, rel
    assert (got.argmax(-1) == want.argmax(-1)).float().mean().item() >= 0.999
