"""Johnson TransformerNet and stylizer of the PyTorch port vs the JAX
package, on the CPU, with the repo's synthetic checkpoint."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralstyletransferv1_tpu.engine import stylizer as jst
from neuralstyletransferv1_tpu.io import checkpoints as ckpt
from neuralstyletransferv1_torch.engine import stylizer as tst
from neuralstyletransferv1_torch.models import io_presets as tiop
from neuralstyletransferv1_torch.models.transformer_net import TransformerNet, params_from_jax

CKPT = Path(__file__).resolve().parent.parent / "_testdata" / "test_johnson.pth"


@pytest.fixture(scope="module")
def models():
    if not CKPT.exists():
        pytest.skip("synthetic checkpoint missing")
    return (tst.load_model(CKPT, io_preset="raw_01"),
            jst.load_model(CKPT, io_preset="raw_01"))


def _frames(n=2, h=64, w=96, seed=0):
    return np.random.default_rng(seed).random((n, h, w, 3)).astype(np.float32)


def test_params_from_jax_roundtrips_the_checkpoint():
    """JAX tree (HWIO, scale/bias) → state dict equals the torch checkpoint."""
    sd = ckpt.load_state_dict(str(CKPT))
    ours = params_from_jax(ckpt.import_transformer(sd))
    assert set(ours) == set(TransformerNet().state_dict())
    assert set(ours) == set(sd)
    for k, v in ours.items():
        assert np.array_equal(v.numpy(), sd[k]), k


@pytest.mark.parametrize("preset", ["raw_01", "imagenet_255", "tanh", "imagenet_01",
                                    "caffe_bgr", "raw_255"])
def test_io_presets_match(preset):
    from neuralstyletransferv1_tpu.models import io_presets as jiop

    x = _frames(1, 5, 7)
    pre = tiop.preprocess(preset, torch.from_numpy(x))
    assert np.abs(pre.numpy() - np.asarray(jiop.preprocess(preset, jnp.asarray(x)))).max() <= 1e-4
    y = np.random.default_rng(1).normal(0, 100, (1, 5, 7, 3)).astype(np.float32)
    post = tiop.postprocess(preset, torch.from_numpy(y))
    assert np.abs(post.numpy() - np.asarray(jiop.postprocess(preset, jnp.asarray(y)))).max() <= 1e-6


@pytest.mark.parametrize("preset", ["raw_01", "imagenet_255"])
def test_f32_matches_jax_stylize(models, preset):
    tm, jm = models
    x = _frames()
    ours = tst.stylize(tm.net, preset, torch.from_numpy(x)).numpy()
    ref = np.asarray(jst.stylize("johnson", jm.params, preset, jnp.asarray(x)))
    d = np.abs(ours - ref)
    assert d.mean() <= 1e-5 and d.max() <= 1e-3, (d.mean(), d.max())


def test_f32_stylizer_pad_and_crop(models):
    """A size that is not a multiple of 4 reflect-pads and crops back, like
    the JAX engine's stylizer."""
    tm, jm = models
    x = _frames(2, 66, 98, seed=2)
    ours = tst.jit_stylizer(tm)(torch.from_numpy(x)).numpy()
    ref = np.asarray(jst.jit_stylizer(jm)(jnp.asarray(x)))
    assert ours.shape == ref.shape == x.shape
    d = np.abs(ours - ref)
    assert d.mean() <= 1e-5 and d.max() <= 1e-3, (d.mean(), d.max())


def test_bf16_matches_jax_bf16(models):
    """bf16 weights and activations, f32 norm statistics: within the repo's
    1e-2 MAE gate of the JAX bf16 stylizer (which rounds at other places)."""
    tm, jm = models
    x = _frames(2, 64, 96, seed=3)
    ours = tst.jit_stylizer(tm, dtype=torch.bfloat16)(torch.from_numpy(x))
    ref = np.asarray(jst.jit_stylizer(jm, dtype=jnp.bfloat16)(jnp.asarray(x)))
    assert ours.dtype == torch.float32
    assert np.abs(ours.numpy() - ref).mean() <= 1e-2
