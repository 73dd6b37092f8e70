"""The magenta slot (``models/magenta.py``, ``models/magenta_stub.py`` and
the engine's dispatch): the port against the JAX package on the CPU.

No magenta SavedModel is in the repo, so the CLI slot takes the colour
transfer (``tests/test_torch_tf_saved_model.py`` holds the SavedModel path
on a graph it writes). The compact CIN net is held with ``magenta.init``'s
weights through ``params_from_jax``. Tolerances: the feather stitch 1e-6;
the compact net f32 1e-5 MAE (and 1e-4 at most) on [0, 1]; the colour
transfer 1e-5 MAE (its LAB a/b planes round to integers, so an f32 ulp can
move a pixel by a level: at most 2e-3 there); the CLI outputs within the
repo's 1e-2 MAE gate of JAX's.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from neuralstyletransferv1_tpu.engine import pipeline as jpipe
from neuralstyletransferv1_tpu.engine import stylizer as jst
from neuralstyletransferv1_tpu.models import magenta as jm
from neuralstyletransferv1_tpu.models import magenta_stub as jstub
from neuralstyletransferv1_torch.engine import pipeline as tpipe
from neuralstyletransferv1_torch.engine import stylizer as tst
from neuralstyletransferv1_torch.models import magenta as tm

GATE = 1e-2


@pytest.fixture(scope="module")
def compact():
    """(JAX params, the port's CompactCIN) from ``magenta.init(key(0))``
    (jitted: one compile instead of ~100 eager draws)."""
    params = jax.jit(jm.init)(jax.random.key(0))
    return params, tm.compact_from_jax(jax.tree.map(np.asarray, params))


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def test_feather_stitch_matches_jax():
    """The mask, the weight map and the stitch of fixed tile outputs (a
    transfer that maps each tile to a seeded field) exact to 1e-6."""
    for tile, overlap in ((64, 16), (256, 32), (32, 0)):
        np.testing.assert_array_equal(tm._feather_mask(tile, overlap),
                                      jm._feather_mask(tile, overlap))
    ys, xs = tuple(range(0, 100, 48)), tuple(range(0, 140, 48))
    np.testing.assert_array_equal(tm._stitch_weight(100, 140, ys, xs, 64, 16),
                                  jm._stitch_weight(100, 140, ys, xs, 64, 16))
    content = _rand((2, 100, 140, 3), 0)
    field = _rand((18, 64, 64, 3), 1)  # 2 frames × 3 × 3 tiles
    ours = tm.stylize_tiled_batch(None, torch.from_numpy(content), None, tile_size=64,
                                  overlap=16,
                                  transfer_fn=lambda t: t * 0.5 + torch.from_numpy(field))
    ref = jax.jit(lambda c: jm.stylize_tiled_batch(
        None, c, None, tile_size=64, overlap=16,
        transfer_fn=lambda t: t * 0.5 + jnp.asarray(field)))(content)
    assert np.abs(ours.numpy() - np.asarray(ref)).max() <= 1e-6


def test_params_from_jax_fills_every_weight(compact):
    params, net = compact
    sd = net.state_dict()
    n_leaves = len(jax.tree.leaves(params))
    assert len(sd) == n_leaves == 4 * 2 + 2 + 16 * 2 + 15 * 4
    assert sd["net.c1.w"].shape == (32, 3, 9, 9) and sd["predictor.proj.w"].shape == (256, 100)
    np.testing.assert_array_equal(sd["net.res3_2.w"].numpy(),
                                  np.transpose(np.asarray(params["net"]["res3_2"]["w"]),
                                               (3, 2, 0, 1)))


def test_compact_net_matches_jax(compact):
    """The compact net at full width, f32, tile 64, overlap 16, on two
    100×148 frames (12 tiles each, one batch): the embedding and the
    stitched output against JAX's batched call; each frame alone against
    the batch."""
    params, net = compact
    frames, style = _rand((2, 100, 148, 3), 1), _rand((64, 64, 3), 2)
    emb = net.predict_style(torch.from_numpy(style)[None]).numpy()
    jemb = np.asarray(jm.predict_style(params, jnp.asarray(style)[None]))
    assert np.abs(emb - jemb).max() <= 1e-5 * max(1.0, np.abs(jemb).max())
    ref = np.asarray(jax.jit(lambda c, s: jm.stylize_tiled_batch(
        params, c, s, tile_size=64, overlap=16))(frames, style))
    ours = tm.stylize_tiled_batch(net, torch.from_numpy(frames), torch.from_numpy(style),
                                  tile_size=64, overlap=16).numpy()
    d = np.abs(ours - ref)
    assert ours.shape == (2, 100, 148, 3) and d.mean() <= 1e-5 and d.max() <= 1e-4, (
        d.mean(), d.max())
    assert ours.std() > 1e-3
    for i in range(2):
        single = tm.stylize_tiled(net, torch.from_numpy(frames[i]), torch.from_numpy(style),
                                  tile_size=64, overlap=16).numpy()
        assert np.abs(ours[i] - single).max() <= 1e-5


def test_color_transfer_matches_jax():
    """Population standard deviations (``correction=0``, ``jnp.std``'s):
    the transfer of seeded tiles to a style image's LAB moments."""
    style = (_rand((64, 64, 3), 5) * 0.5 + 0.25).astype(np.float32)
    tiles = _rand((5, 48, 48, 3), 6)
    ours = tm.color_transfer_fn(torch.from_numpy(style))(torch.from_numpy(tiles)).numpy()
    ref = np.asarray(jax.jit(jm.color_transfer_fn(jnp.asarray(style)))(tiles))
    d = np.abs(ours - ref)
    assert d.mean() <= 1e-5 and d.max() <= 2e-3, (d.mean(), d.max())
    # a sample std would differ by the factor sqrt(n / (n - 1)) in every tile
    s = torch.from_numpy(style).reshape(-1, 3)
    assert not torch.allclose(s.std(0), s.std(0, correction=0))


def _slot_args(root, **kw):
    return SimpleNamespace(magenta_model_root=str(root), magenta_tile=kw.get("tile", 48),
                           magenta_overlap=kw.get("overlap", 12),
                           magenta_target_res=kw.get("target_res"))


def _style(tmp_path, seed=8):
    p = tmp_path / "style.jpg"
    Image.fromarray((_rand((80, 60, 3), seed) * 200 + 30).astype(np.uint8)).save(p)
    return p


@pytest.mark.parametrize("target_res", [None, 64])
def test_slot_stylizer_matches_jax(tmp_path, target_res):
    """The slot from the style image (EXIF load, LANCZOS to the tile) and
    the dispatch (``--magenta_target_res`` downscale by ``int(H·r)``, the
    resize back) on a 2-frame batch, against JAX's slot."""
    sty = _style(tmp_path)
    args = _slot_args(tmp_path / "no_models", target_res=target_res)
    ours = tst.load_model(sty, model_type="magenta", magenta_args=args)
    ref = jstub.load_magenta_slot(str(sty), args)
    assert ours.arch == "magenta" and ours.io_preset == "raw_01" and ours.name == "style"
    np.testing.assert_array_equal(ours.net.style01.numpy(), np.asarray(ref.params["style01"]))
    x = _rand((2, 70, 100, 3), 9)
    got = tst.jit_stylizer(ours)(torch.from_numpy(x)).numpy()
    want = np.asarray(jst.jit_stylizer(ref)(jnp.asarray(x)))
    d = np.abs(got - want)
    assert got.shape == (2, 70, 100, 3) and got.dtype == np.float32
    assert d.mean() <= 1e-5 and d.max() <= 2e-3, (d.mean(), d.max())


def test_dtype_and_quantize_leave_the_slot_unchanged(tmp_path):
    """A magenta slot runs in f32 under ``--compute_dtype bfloat16`` and
    ignores ``--quantize`` (the JAX engine returns from its dispatch before
    either applies): the same output, no error."""
    slot = tst.load_model(_style(tmp_path), model_type="magenta",
                          magenta_args=_slot_args(tmp_path / "none"))
    x = torch.from_numpy(_rand((1, 60, 80, 3), 10))
    base = tst.jit_stylizer(slot)(x)
    for q in ("none", "bf16_static", "int8_static", "int8"):
        assert torch.equal(tst.jit_stylizer(slot, dtype=torch.bfloat16, quantize=q)(x), base)
    assert torch.equal(tst.jit_stylizer(slot, quantize="int8_static")(x), base)


def _u8(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"), np.float64) / 255.0


def test_image_cli_matches_jax(tmp_path):
    """The single-image mode with a magenta slot (tile 64, overlap 16) in
    both engines' main(); the port again under ``--compute_dtype bfloat16
    --quantize int8_static``, unchanged."""
    img = tmp_path / "c.png"
    Image.fromarray((_rand((96, 128, 3), 11) * 255).astype(np.uint8)).save(img)
    argv = ["--input_image", str(img), "--model_type", "magenta", "--magenta_style",
            str(_style(tmp_path)), "--magenta_tile", "64", "--magenta_overlap", "16",
            "--magenta_model_root", str(tmp_path / "no_models")]
    outs = {}
    for side, extra in (("torch", ["--device", "cpu"]), ("jax", []),
                        ("torch_q", ["--device", "cpu", "--compute_dtype", "bfloat16",
                                     "--quantize", "int8_static"])):
        out = tmp_path / f"{side}.png"
        run = jpipe.main if side == "jax" else tpipe.main
        assert run(argv + extra + ["--output_image", str(out),
                                   "--work_dir", str(tmp_path / f"_w{side}")]) == 0
        outs[side] = _u8(out)
    assert outs["torch"].shape == (96, 128, 3) and outs["torch"].std() > 1e-2
    assert np.abs(outs["torch"] - outs["jax"]).mean() <= GATE
    assert np.array_equal(outs["torch"], outs["torch_q"])


def _clip(path: Path, n, h=64, w=96):
    cv2 = pytest.importorskip("cv2")
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8, (w, h))
    yy, xx = np.mgrid[0:h, 0:w]
    for t in range(n):
        f = 120 + 60 * np.sin(0.2 * (xx - 2 * t) + 0.1 * (yy - t))
        vw.write(np.repeat(f[..., None], 3, 2).clip(0, 255).astype(np.uint8)
                 + np.array([0, 20, 40], np.uint8))
    vw.release()


def _read(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, fr = cap.read()
        if not ok:
            return out
        out.append(fr.astype(np.float64) / 255.0)


def test_video_cli_matches_jax(tmp_path):
    """A 6-frame mp4 through both engines' main() with a magenta slot and
    the DIS flow EMA, per frame: the styled frame files within the gate.
    Streamed in batches of 3 (the port only: JAX's batched core compiles
    for minutes on the CPU), every frame encoded and each batch's stylize
    the per-frame one's."""
    src = tmp_path / "in.mp4"
    _clip(src, 6)
    argv = ["--input_video", str(src), "--model_type", "magenta", "--magenta_style",
            str(_style(tmp_path)), "--magenta_tile", "48", "--magenta_overlap", "8",
            "--magenta_model_root", str(tmp_path / "no_models"), "--flow_ema"]
    for side in ("t", "j"):
        run = tpipe.main if side == "t" else jpipe.main
        dev = ["--device", "cpu"] if side == "t" else []
        assert run(argv + dev + ["--output_video", str(tmp_path / f"{side}.mp4"),
                                 "--work_dir", str(tmp_path / f"_w{side}")]) == 0
    a, b = ([_u8(p) for p in sorted((tmp_path / f"_w{s}" / "frames").glob("styled_*.png"))]
            for s in ("t", "j"))
    assert len(a) == len(b) == 6
    for x, y in zip(a, b):
        assert np.abs(x - y).mean() <= GATE and x.std() > 1e-2
    assert tpipe.main(argv + ["--device", "cpu", "--frame_batch", "3", "--output_video",
                              str(tmp_path / "s.mp4"), "--work_dir", str(tmp_path / "_ws")]) == 0
    assert len(_read(tmp_path / "s.mp4")) == 6
    frames = [np.asarray(Image.open(p)) for p in
              sorted((tmp_path / "_wt" / "frames").glob("frame_*.png"))]
    slot = tpipe.load_slot_bank(tpipe.build_parser().parse_args(argv + ["--device", "cpu"]),
                                torch.device("cpu"))[0]
    x = torch.from_numpy(np.stack(frames[:3])).float() / 255.0
    fn = tst.jit_stylizer(slot)
    batch = fn(x)
    for i in range(3):
        assert torch.allclose(batch[i], fn(x[i:i + 1])[0], atol=1e-6)


def test_cli_admits_magenta_and_checks_its_style(tmp_path, capsys):
    """The CLI admits magenta slots A–H; main() keeps the JAX engine's two
    argument checks."""
    base = ["--input_image", "a.png", "--output_image", "b.png", "--device", "cpu"]
    for extra in (["--model_type", "magenta", "--magenta_style", "s.png"],
                  ["--model", "m.pth", "--model_c_type", "magenta", "--magenta_style_c", "s.png"]):
        assert tpipe.build_parser().parse_args(base + extra).device == "cpu"
    assert tpipe.main(base + ["--model_type", "magenta"]) == 2
    assert "--magenta_style is required" in capsys.readouterr().out
    assert tpipe.main(base) == 2
    assert "--model is required" in capsys.readouterr().out
    args = tpipe.build_parser().parse_args(
        base + ["--model_type", "magenta", "--magenta_style", str(_style(tmp_path)),
                "--model_b", "x.pth", "--model_b_type", "magenta", "--magenta_tile", "32",
                "--magenta_model_root", str(tmp_path / "none")])
    bank = tpipe.load_slot_bank(args, torch.device("cpu"))
    assert [m.arch for m in bank] == ["magenta"] and bank[0].net.tile == 32
