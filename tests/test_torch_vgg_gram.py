"""The VGG16 trunk and the Gram-matrix NST (``models/vgg.py``,
``engine/gram_nst.py``, ``apps/slow_nst.py``): the port against the JAX
package on the CPU, with JAX's ``vgg.init`` weights carried across by
``vgg.params_from_jax``.

Tolerances: features at every ReLU and the Gram matrix 1e-5 relative MAE;
``nst_losses`` 1e-5 relative and its image gradient 1e-4 relative MAE; one
Adam update within 1 f32 ulp of ``optax.adam``'s; 5 ``optimize`` steps: the
loss history 1e-4 relative, the image mean |Δ| ≤ 1e-4 with ≥ 99.9% within
1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralstyletransferv1_tpu.engine import gram_nst as jg
from neuralstyletransferv1_tpu.models import vgg as jv
from neuralstyletransferv1_torch.engine import gram_nst as tg
from neuralstyletransferv1_torch.models import vgg as tv

W_KW = dict(content_weight=1.0, style_weight=1e4, tv_weight=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: in the six-worker tier-1 run the
    workers share the cores, and a multi-threaded torch pool then waits at
    each op's barrier for threads that other workers preempt, which made
    these many small ops run tens of times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's VGG16Features) from ``vgg.init(key(1))``."""
    params = jax.jit(jv.init)(jax.random.key(1))
    return params, tv.load(tv.params_from_jax(jax.tree.map(np.asarray, params)))


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).mean() / np.abs(a).mean()


@pytest.mark.parametrize("hw", [(48, 64), (50, 70)])
def test_features_match_jax(weights, hw):
    """Every ReLU tap (the odd size floors at each max-pool)."""
    params, net = weights
    x = _rand((2,) + hw + (3,), 0)
    want = jax.jit(lambda p, x: jv.extract_features(p, x, tuple(jv.RELU_NAMES)))(params, x)
    got = tv.extract_features(net, torch.from_numpy(x), tuple(tv.RELU_NAMES))
    assert list(got) == [k for k in tv.RELU_NAMES]
    for k in tv.RELU_NAMES:
        assert got[k].shape == want[k].shape, k
        assert _rel(want[k], got[k].numpy()) <= 1e-5, k


def test_extract_stops_after_the_last_layer(weights):
    """The Gatys layers stop after relu4_3: conv5 never runs."""
    _, net = weights
    calls = []
    hooks = [m.register_forward_hook(lambda m, i, o: calls.append(m))
             for m in net.features if isinstance(m, torch.nn.Conv2d)]
    try:
        feats = tv.extract_features(net, torch.rand(1, 32, 32, 3), tv.STYLE_LAYERS)
    finally:
        for h in hooks:
            h.remove()
    assert set(feats) == set(tv.STYLE_LAYERS) and len(calls) == 10
    assert feats["relu4_3"].shape == (1, 4, 4, 512)
    assert tv.RELU_NAMES == jv.RELU_NAMES and tv.STYLE_LAYERS == jv.STYLE_LAYERS
    assert tv.CONTENT_LAYER == jv.CONTENT_LAYER


def test_gram_matrix_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 9, 11, 7)).astype(np.float32)
    want = np.asarray(jv.gram_matrix(jnp.asarray(x)))
    got = tv.gram_matrix(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 7, 7)
    assert _rel(want, got) <= 1e-5


def test_torchvision_import_layout():
    """A torchvision ``vgg16`` state dict (the classifier included) loads as
    is; JAX's importer of the same zeros gives the same layout."""
    sd = {}
    cin = 3
    for idx, cout in zip([0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28],
                         [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]):
        sd[f"features.{idx}.weight"] = np.zeros((cout, cin, 3, 3), np.float32)
        sd[f"features.{idx}.bias"] = np.zeros((cout,), np.float32)
        cin = cout
    sd["classifier.0.weight"] = np.zeros((4096, 25088), np.float32)
    params = jv.import_torchvision_vgg16(sd)
    ours = tv.import_torchvision_vgg16({k: torch.from_numpy(v) for k, v in sd.items()})
    assert len(ours) == 26 and "classifier.0.weight" not in ours
    net = tv.load(ours)
    assert net.features[0].weight.shape == (64, 3, 3, 3)
    assert net.features[28].weight.shape == (512, 512, 3, 3)
    assert not any(p.requires_grad for p in net.parameters())
    ref = tv.params_from_jax(jax.tree.map(np.asarray, params))
    assert {k: v.shape for k, v in ref.items()} == {k: v.shape for k, v in ours.items()}


def test_init_draws_jax_init_distribution():
    """Seeded, in the torchvision layout; convs uniform in ±sqrt(3/fan_in),
    biases 0, as JAX ``vgg.init``."""
    a, b = tv.init(3), tv.init(3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["features.0.weight"], tv.init(4)["features.0.weight"])
    w = a["features.28.weight"]
    bound = (3.0 / (512 * 9)) ** 0.5
    assert w.abs().max() <= bound and w.abs().max() > 0.99 * bound
    assert all(float(a[f"features.{i}.bias"].abs().max()) == 0.0 for i in (0, 14, 28))


def test_nst_losses_and_image_gradient_match_jax(weights):
    """Total loss, its parts and d total / d image; the style image at
    another size than the content."""
    params, net = weights
    content, style, img = _rand((1, 40, 56, 3), 1), _rand((1, 48, 36, 3), 2), _rand(
        (1, 40, 56, 3), 3)
    cf = jv.extract_features(params, content, (jv.CONTENT_LAYER,))[jv.CONTENT_LAYER]
    sg = {k: jv.gram_matrix(v) for k, v in jv.extract_features(params, style,
                                                               jv.STYLE_LAYERS).items()}
    (total, parts), grad = jax.jit(jax.value_and_grad(
        lambda im: jg.nst_losses(params, im, cf, sg, **W_KW), has_aux=True))(jnp.asarray(img))

    with torch.no_grad():
        tcf = tv.extract_features(net, torch.from_numpy(content), (tv.CONTENT_LAYER,))[
            tv.CONTENT_LAYER]
        tsg = {k: tv.gram_matrix(v) for k, v in tv.extract_features(
            net, torch.from_numpy(style), tv.STYLE_LAYERS).items()}
    im = torch.from_numpy(img).requires_grad_(True)
    ttotal, tparts = tg.nst_losses(net, im, tcf, tsg, **W_KW)
    (tgrad,) = torch.autograd.grad(ttotal, im)
    assert abs(ttotal.item() - float(total)) <= 1e-5 * abs(float(total))
    for k in ("content", "style", "tv"):
        assert abs(tparts[k].item() - float(parts[k])) <= 1e-5 * abs(float(parts[k])), k
    assert _rel(grad, tgrad.numpy()) <= 1e-4


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b.numpy().view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0, 1e2])
def test_adam_update_matches_optax(scale):
    """One update from ``optax.adam(lr).init``'s state: updates and both
    moments within 1 f32 ulp of ``optax.adam(lr).update``'s."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 7, 3)).astype(np.float32)
    g = (rng.normal(size=x.shape) * scale).astype(np.float32)
    opt = optax.adam(0.02)
    u, state = opt.update(jnp.asarray(g), opt.init(jnp.asarray(x)))
    tu, ours = tg.adam_update(torch.from_numpy(g), tg.adam_init(torch.from_numpy(x)), 0.02)
    assert _ulps(u, tu) <= 1
    assert _ulps(state[0].mu, ours["mu"]) <= 1 and _ulps(state[0].nu, ours["nu"]) <= 1
    assert int(state[0].count) == ours["count"] == 1


def test_adam_later_updates_match_optax():
    """Updates 2–4 from optax's own state: the moments within 1 ulp; the
    update within 3e-5 relative, the f32 noise of ``1 − b2**count`` (XLA's
    and numpy's f32 pow differ by up to 256 ulps of it at count 3, as
    JAX's jitted and eager forms do)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 7, 3)).astype(np.float32)
    opt = optax.adam(0.02)
    state = opt.init(jnp.asarray(x))
    for step in range(4):
        g = (rng.normal(size=x.shape) * 10.0 ** (step - 2)).astype(np.float32)
        ours = {"mu": torch.tensor(np.asarray(state[0].mu)),
                "nu": torch.tensor(np.asarray(state[0].nu)), "count": int(state[0].count)}
        u, state = opt.update(jnp.asarray(g), state)
        tu, ours = tg.adam_update(torch.from_numpy(g), ours, 0.02)
        assert _ulps(state[0].mu, ours["mu"]) <= 1 and _ulps(state[0].nu, ours["nu"]) <= 1
        u = np.asarray(u)
        assert np.abs(tu.numpy() - u).max() <= 3e-5 * np.abs(u).max(), step


def test_optimize_matches_jax(weights):
    """5 steps from the content at 32×48 (the style 40×36)."""
    params, net = weights
    content, style = _rand((1, 32, 48, 3), 5), _rand((1, 40, 36, 3), 6)
    out, hist = jg.optimize(params, jnp.asarray(content), jnp.asarray(style), steps=5)
    tout, thist = tg.optimize(net, torch.from_numpy(content), torch.from_numpy(style), steps=5)
    hist = np.asarray(hist)
    assert thist.shape == (5,) and tout.shape == content.shape
    assert np.all(np.abs(thist.numpy() - hist) <= 1e-4 * np.abs(hist))
    d = np.abs(np.asarray(out) - tout.numpy())
    assert d.mean() <= 1e-4 and (d <= 1e-3).mean() >= 0.999
    assert float(tout.min()) >= 0.0 and float(tout.max()) <= 1.0


def test_optimization_reduces_loss():
    """The port's twin of ``tests/test_gram_nst.py::test_optimization_reduces_loss``:
    30 steps from a random start (the port's torch generator)."""
    net = tv.load(tv.init(1))
    rng = np.random.default_rng(2)
    content = torch.from_numpy(rng.random((1, 48, 64, 3)).astype(np.float32))
    style = torch.from_numpy(rng.random((1, 48, 64, 3)).astype(np.float32))
    out, hist = tg.optimize(net, content, style, steps=30, lr=0.05, init_from="random")
    hist = hist.numpy()
    assert np.isfinite(hist).all()
    assert hist[-1] < hist[0] * 0.9, (hist[0], hist[-1])
    assert out.shape == content.shape
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    out2, _ = tg.optimize(net, content, style, steps=1, init_from="random", seed=0)
    out3, _ = tg.optimize(net, content, style, steps=1, init_from="random", seed=0)
    assert torch.equal(out2, out3)
    with pytest.raises(ValueError):
        tg.optimize(net, content, style, steps=1, init_from="noise")


def test_optimize_runs_under_inference_mode():
    """The loop enables grad itself: a caller in ``inference_mode`` gets the
    same image as one outside it."""
    net = tv.load(tv.init(0))
    c, s = torch.from_numpy(_rand((1, 24, 32, 3), 7)), torch.from_numpy(_rand((1, 24, 32, 3), 8))
    want, _ = tg.optimize(net, c, s, steps=2)
    with torch.inference_mode():
        got, _ = tg.optimize(net, c, s, steps=2)
    assert torch.equal(want, got)


def test_slow_nst_cli_writes_its_png(tmp_path, capsys):
    """``slow_nst.main`` with ``--device cpu``: a 3-step run at --size 48
    (the 64×80 inputs downscaled with LANCZOS) writes a 38×48 PNG."""
    from PIL import Image

    from neuralstyletransferv1_torch.apps import slow_nst

    for name, seed in (("c.png", 0), ("s.png", 1)):
        Image.fromarray((_rand((64, 80, 3), seed) * 255).astype(np.uint8)).save(tmp_path / name)
    out = tmp_path / "out.png"
    assert slow_nst.main(["--content", str(tmp_path / "c.png"), "--style",
                          str(tmp_path / "s.png"), "--output", str(out), "--steps", "3",
                          "--size", "48", "--device", "cpu"]) == 0
    assert Image.open(out).size == (48, 38)
    assert "random VGG features" in capsys.readouterr().out


def test_slow_nst_without_device_needs_cuda(monkeypatch, tmp_path):
    from neuralstyletransferv1_torch.apps import slow_nst

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        slow_nst.main(["--content", "c.png", "--style", "s.png", "--output",
                       str(tmp_path / "o.png")])
