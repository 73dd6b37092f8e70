"""``--mesh_devices`` in the port (``parallel/mesh.py``, the mesh in
``engine/pipeline.make_batched_core`` and ``engine/stylizer.jit_stylizer``,
``engine/gram_nst.sharded_optimize_step``) against the JAX package on the
CPU: JAX shards over the 8 virtual CPU devices of ``tests/conftest.py``, the
port over a mesh of CPU shards (``make_mesh(n, "cpu")``, one weight replica
each).

Tolerances: the sharded temporal chain against JAX's on 2 and 4 shards,
frames and the carried frame within 1e-5, the carried LAB within 1e-3
(``tests/test_temporal_shard.py``'s bounds); against the port's own chunk
emulation bit for bit, against the sequential chain the first chunk within
1e-5 and the rest mean < 0.05. The CLI against JAX's ``main`` with the same
flags: 1 level on ≥ 99% of the pixels, or 1e-2 MAE on [0, 1] (the port's CLI
gate); the mesh core against the single-device one with smoothing off,
1e-5 MAE under f32. The Gram step against JAX's on 2 devices: images 1e-4,
loss 1e-5 relative; against the port's unsharded step on the whole batch,
the loss 1e-6 relative, the images 1e-6 mean |Δ| (and 1e-4 max: Adam's
first update magnifies a gradient near its 1e-8 epsilon), the first moment
1e-5 of its largest.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralstyletransferv1_tpu.engine import gram_nst as jg
from neuralstyletransferv1_tpu.engine import pipeline as jpipe
from neuralstyletransferv1_tpu.models import vgg as jv
from neuralstyletransferv1_tpu.parallel import mesh as jm
from neuralstyletransferv1_tpu.temporal.ema import TemporalState as JState
from neuralstyletransferv1_torch.engine import gram_nst as tg
from neuralstyletransferv1_torch.engine import pipeline as tpipe
from neuralstyletransferv1_torch.engine import stylizer as tst
from neuralstyletransferv1_torch.models import vgg as tv
from neuralstyletransferv1_torch.ops.color import rgb_to_lab_u8
from neuralstyletransferv1_torch.parallel import mesh as tm
from neuralstyletransferv1_torch.temporal.ema import TemporalState, temporal_postprocess_split

CKPT = Path(__file__).resolve().parent.parent / "_testdata" / "test_johnson.pth"
CPU = torch.device("cpu")

KW = dict(flow_ema=True, flow_alpha=0.6, smooth_lightness=True, smooth_chroma=False,
          smooth_alpha=0.7, chroma_alpha=0.85, motion_blend=True, blend=0.9,
          composite_keep=True)


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


def _data(T=8, H=16, W=24, seed=0, with_mask=True):
    """``tests/test_temporal_shard.py``'s data, as numpy."""
    rng = np.random.default_rng(seed)
    styled = rng.random((T, H, W, 3)).astype(np.float32)
    orig = rng.random((T, H, W, 3)).astype(np.float32)
    flows = rng.normal(0, 1.5, (T, H, W, 2)).astype(np.float32)
    alphas = rng.random((T, H, W, 1)).astype(np.float32) if with_mask else None
    has = (rng.random(T) > 0.5) if with_mask else None
    state = (rng.random((H, W, 3)).astype(np.float32),
             (rng.random((H, W, 3)) * 255.0).astype(np.float32))
    return styled, orig, flows, alphas, has, state


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _port_sharded(n, d, first):
    styled, orig, flows, alphas, has, state = d
    return tm.temporal_postprocess_sharded(
        tm.make_mesh(n, "cpu"), _t(styled), _t(orig), _t(flows),
        state=TemporalState(_t(state[0]), _t(state[1])), first=first,
        mask_alphas=_t(alphas), mask_has=_t(has), **KW)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("with_mask", [True, False])
def test_sharded_chain_matches_jax(n, first, with_mask):
    """The port's sharded chain on n CPU shards against JAX's on n virtual
    devices, and against the port's own chunk emulation (each chunk through
    ``temporal_postprocess_split``: shard 0 from the carry with
    ``warmup=first``, shard k from chunk k − 1's last stylized frame)."""
    d = _data(with_mask=with_mask)
    styled, orig, flows, alphas, has, state = d
    mesh = jm.make_mesh(n)
    want, wst = jax.jit(lambda s, o, f, st: jm.temporal_postprocess_sharded(
        mesh, s, o, f, state=st, first=first, mask_alphas=alphas, mask_has=has, **KW))(
        styled, orig, flows, JState(*state))
    got, gst = _port_sharded(n, d, first)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(gst.prev_styled01.numpy(), np.asarray(wst.prev_styled01), atol=1e-5)
    np.testing.assert_allclose(gst.prev_lab.numpy(), np.asarray(wst.prev_lab), atol=1e-3)

    tl, outs, st = styled.shape[0] // n, [], None
    for k in range(n):
        sl = slice(k * tl, (k + 1) * tl)
        if k == 0:
            init, warmup = TemporalState(_t(state[0]), _t(state[1])), first
        else:
            b = _t(styled[k * tl - 1])
            init, warmup = TemporalState(b, rgb_to_lab_u8(b)), False
        o, st = temporal_postprocess_split(
            _t(styled[sl]), _t(orig[sl]), _t(flows[sl]), init=init, warmup=warmup,
            mask_alphas=None if alphas is None else _t(alphas[sl]),
            mask_has=None if has is None else _t(has[sl]), **KW)
        outs.append(o)
    assert torch.equal(got, torch.cat(outs, 0))
    assert torch.equal(gst.prev_styled01, st.prev_styled01) and torch.equal(gst.prev_lab,
                                                                           st.prev_lab)


def test_sharded_chain_close_to_sequential():
    """The chunk seed's error stays bounded: the first chunk is exact (the
    true carry), the second within 0.05 mean of the sequential chain."""
    d = _data(with_mask=False)
    got, _ = _port_sharded(2, d, True)
    seq, _ = temporal_postprocess_split(_t(d[0]), _t(d[1]), _t(d[2]), init=None, **KW)
    diff = (got - seq).abs()
    assert diff[:4].max().item() < 1e-5
    assert diff[4:].mean().item() < 0.05


def test_warmup_defaults_keep_the_old_behaviour():
    """``warmup`` None infers it from ``init``: an explicit warm-up from the
    frame-0 state equals ``init=None``, and ``warmup=False`` with an init
    equals the old call with that init."""
    styled, orig, flows, _, _, state = _data(with_mask=False)
    s, o, f = _t(styled), _t(orig), _t(flows)
    a, sa = temporal_postprocess_split(s, o, f, init=None, **KW)
    b, sb = temporal_postprocess_split(s, o, f, init=TemporalState(s[0], rgb_to_lab_u8(s[0])),
                                       warmup=True, **KW)
    assert torch.equal(a, b) and torch.equal(sa.prev_lab, sb.prev_lab)
    init = TemporalState(_t(state[0]), _t(state[1]))
    c, _ = temporal_postprocess_split(s, o, f, init=init, **KW)
    e, _ = temporal_postprocess_split(s, o, f, init=init, warmup=False, **KW)
    assert torch.equal(c, e)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_halo_ring_order(n):
    """Shard k receives shard k − 1's frame; shard 0 receives shard
    n − 1's (JAX's ppermute (i, (i + 1) mod n))."""
    mesh = tm.make_mesh(n, "cpu")
    frames = [torch.full((2, 3, 3), float(k)) for k in range(n)]
    got = tm.temporal_halo_exchange(mesh, frames)
    assert [int(g[0, 0, 0]) for g in got] == [(k - 1) % n for k in range(n)]


def test_mesh_shape_and_clamp():
    """``make_mesh`` on the CPU (n distinct shards), from an explicit list
    with repeats (shared replicas); the clamp to the visible devices and
    the batch rounding as pure functions; ``split`` refuses a ragged batch."""
    mesh = tm.make_mesh(3, "cpu")
    assert len(mesh) == 3 and len(mesh.distinct()) == 3 and mesh.primary == torch.device("cpu", 0)
    rep = tm.make_mesh(devices=["cpu", "cpu"])
    assert len(rep) == 2 and rep.distinct() == [CPU]
    for n, vis, want in ((2, 1, 1), (2, 8, 2), (8, 4, 4), (4, 4, 4), (3, 0, 0)):
        assert tm.clamp_mesh(n, vis) == want
    for b, n, want in ((3, 2, 4), (4, 2, 4), (1, 4, 4), (5, 4, 8), (8, 8, 8)):
        assert tm.round_batch(b, n) == want
    assert tm.visible_devices(CPU, 6) == 6
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        tm.split(mesh, torch.zeros(4, 2))


def test_engine_mesh_clamps_rounds_and_prints(capsys, monkeypatch):
    """``engine_mesh``: the JAX engine's lines, ``args.frame_batch``
    rounded; with fewer visible devices than asked the clamp, and no mesh
    once it reaches 1 (the batch then stays as given)."""
    args = tpipe.build_parser().parse_args(
        ["--input_video", "a.mp4", "--output_video", "b.mp4", "--model", str(CKPT),
         "--mesh_devices", "2", "--frame_batch", "3", "--device", "cpu"])
    mesh = tpipe.engine_mesh(args, CPU)
    out = capsys.readouterr().out
    assert len(mesh) == 2 and args.frame_batch == 4
    assert "[mesh] rounding --frame_batch 3 -> 4 (multiple of 2)" in out
    assert "[mesh] data-parallel stylize over 2 device(s)" in out
    monkeypatch.setattr(tm, "visible_devices", lambda device, n: 1)
    args.frame_batch = 3
    assert tpipe.engine_mesh(args, CPU) is None and args.frame_batch == 3
    assert "[mesh] only 1 device(s) visible; clamping --mesh_devices 2 -> 1" in \
        capsys.readouterr().out


def _frames(n, h, w, seed):
    base = (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)
    return [np.ascontiguousarray(np.roll(base, (t, 2 * t), axis=(0, 1))) for t in range(n)]


@pytest.mark.parametrize("quantize", ["none", "int8_static", "int8"])
def test_mesh_core_matches_single_device(quantize, monkeypatch):
    """The batched core on a 2-shard CPU mesh (two weight replicas) against
    the single-device core, smoothing off, f32: within 1e-5 MAE (bit for
    bit here). A quantize mode calibrates once, on the global batch's
    first frame, and both replicas bind that calibration."""
    measured = []
    real = tst._measure
    monkeypatch.setattr(tst, "_measure", lambda *a, **k: measured.append(1) or real(*a, **k))
    frames = _frames(8, 64, 96, 3)
    outs = {}
    for m in (0, 2):
        argv = ["--input_video", "a.mp4", "--output_video", "b.mp4", "--model", str(CKPT),
                "--io_preset", "raw_01", "--frame_batch", "4", "--no-smooth_lightness",
                "--mesh_devices", str(m), "--device", "cpu", "--quantize", quantize]
        b, process = tpipe.make_batched_core(tpipe.build_parser().parse_args(argv), CPU)
        assert b == 4
        outs[m] = torch.cat([process(frames[i:i + 4]) for i in (0, 4)]).float() / 255.0
    assert (outs[0] - outs[2]).abs().mean().item() <= 1e-5
    assert len(measured) == (0 if quantize == "none" else 2)  # one a core


def _write_video(path, frames, fps=8):
    import cv2

    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for fr in frames:
        vw.write(fr[..., ::-1])
    vw.release()


def _styled(work_dir):
    from PIL import Image

    return [np.asarray(Image.open(p), np.float32) / 255.0
            for p in sorted((Path(work_dir) / "frames").glob("styled_frame_*.png"))]


def _cli_gate(a, b):
    d = np.abs(a - b)
    return (d <= 1.0 / 255 + 1e-6).mean() >= 0.99 or d.mean() <= 1e-2


@pytest.mark.parametrize("extra,hw", [
    (["--flow_ema", "--motion_blend", "--blend", "0.9"], (32, 48)),
    (["--quantize", "int8_static", "--no-smooth_lightness"], (64, 96)),
], ids=["flow_ema", "int8_static"])
def test_cli_mesh_matches_jax(tmp_path, capsys, extra, hw):
    """``main(--mesh_devices 2 --frame_batch 3)`` in both engines on a
    6-frame clip (two batches of 4 after the rounding, the second padded),
    ``--stream off`` so the styled frames stay as PNGs: the port prints
    JAX's rounding line and its frames meet the CLI gate against JAX's. The
    flow-EMA clip is small (32×48): JAX's DIS compile is most of the time."""
    pytest.importorskip("cv2")
    vid = tmp_path / "in.mp4"
    _write_video(vid, _frames(6, *hw, 1))

    def argv(out, wd):
        return ["--input_video", str(vid), "--output_video", str(out), "--model", str(CKPT),
                "--io_preset", "raw_01", "--frame_batch", "3", "--mesh_devices", "2",
                "--stream", "off", "--fps", "8", "--work_dir", str(wd)] + extra

    assert tpipe.main(argv(tmp_path / "t.mp4", tmp_path / "wt") + ["--device", "cpu"]) == 0
    assert "[mesh] rounding --frame_batch 3 -> 4 (multiple of 2)" in capsys.readouterr().out
    assert jpipe.main(argv(tmp_path / "j.mp4", tmp_path / "wj")) == 0
    got, want = _styled(tmp_path / "wt"), _styled(tmp_path / "wj")
    assert len(got) == len(want) == 6
    for i, (a, b) in enumerate(zip(got, want)):
        assert _cli_gate(a, b), (i, np.abs(a - b).mean())


@pytest.fixture(scope="module")
def vgg_weights():
    """(JAX params, the port's VGG16Features) from ``vgg.init(key(1))``."""
    params = jax.jit(jv.init)(jax.random.key(1))
    return params, tv.load(tv.params_from_jax(jax.tree.map(np.asarray, params)))


def _gram_inputs(params, n=2, hw=32):
    rng = np.random.default_rng(5)
    imgs = rng.random((n, hw, hw, 3)).astype(np.float32)
    targets = rng.random((n, hw, hw, 3)).astype(np.float32)
    style = rng.random((1, hw, hw, 3)).astype(np.float32)
    feats = jv.extract_features(params, targets, (jv.CONTENT_LAYER,))[jv.CONTENT_LAYER]
    grams = {k: jnp.broadcast_to(jv.gram_matrix(v), (n,) + v.shape[-1:] * 2)
             for k, v in jv.extract_features(params, style, jv.STYLE_LAYERS).items()}
    return imgs, np.array(feats), {k: np.array(v) for k, v in grams.items()}


def test_sharded_gram_step_matches_jax_and_unsharded(vgg_weights):
    """One sharded Gram step on 2 CPU shards against JAX's on 2 virtual
    devices (the same weights, features and Grams), and against the port's
    unsharded step on the whole batch: the losses are global means, so the
    shards' gradients are the whole batch's."""
    params, net = vgg_weights
    imgs, feats, grams = _gram_inputs(params)
    opt = optax.adam(0.02)
    j_imgs, _, j_loss = jg.sharded_optimize_step(params, jnp.asarray(imgs), feats, grams, opt,
                                                 opt.init(jnp.asarray(imgs)), mesh=jm.make_mesh(2))
    x = torch.from_numpy(imgs)
    tfeats, tgrams = torch.from_numpy(feats), {k: torch.from_numpy(v) for k, v in grams.items()}
    got, state, loss = tg.sharded_optimize_step(net, x, tfeats, tgrams, tg.adam_init(x),
                                                mesh=tm.make_mesh(2, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_imgs), atol=1e-4)
    assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    assert state["count"] == 1 and state["mu"].shape == x.shape

    # the port's unsharded step on the whole batch
    img = x.clone().requires_grad_(True)
    total, _ = tg.nst_losses(net, img, tfeats, tgrams, content_weight=1.0, style_weight=1e4,
                             tv_weight=1e-4)
    (g,) = torch.autograd.grad(total, img)
    upd, ust = tg.adam_update(g, tg.adam_init(x), 0.02)
    want = torch.clamp(x + upd, 0.0, 1.0)
    # Adam's first update is -lr·g/(|g| + 1e-8): where |g| is near 1e-8
    # (0.15% of these pixels) a 1e-6 relative change of g (the shards sum in
    # another order) moves the update by up to ~3e-5
    diff = (got - want).abs()
    assert diff.mean().item() <= 1e-6 and diff.max().item() <= 1e-4
    assert abs(loss.item() - total.item()) <= 1e-6 * abs(total.item())
    assert (state["mu"] - ust["mu"]).abs().max().item() <= 1e-5 * ust["mu"].abs().max().item()
