"""The port's showcase, mask and text apps on the CPU (``--device cpu`` /
``DEVICE=cpu``) against the JAX apps on the same inputs: ``style_mask``,
``generate_mask_samples`` (a seeded MobileNetV2 DeepLab written once and
read by both packages' importers), ``generate_style_selfstyle`` (the
compact magenta net on ``magenta.init_tree(0)`` in both), ``style_showcase``
(the env contract, ``discover_models``, ``motion_clip_frames``) and
``cryptic_text`` (masks, fills, distortions, animations, the CLI) — the
twins of ``tests/test_cryptic_text.py``, ``tests/test_presets.py:147-200``
and ``tests/test_apps_smoke.py``'s cases; and ``ops/warp.bilinear_sample``
with JAX's ``border="constant"``.

Tolerance: images, masks and decoded video frames within 1 level of JAX's
on ≥ 99% of the pixels or 1e-2 MAE on [0, 1] (the port's CLI gate); the
JAX package's host code, copied, gives equal outputs; ``bilinear_sample``
within 1e-4 (f32, the same gathers and weights).

Pinned: JAX's ``style_showcase.motion_clip_frames`` raises a TypeError for
every motion but ``none`` (its gather cannot reshape the [H·W] samples of a
[1, W] × [H, 1] coordinate pair); the port's clip is held against JAX's
``bilinear_sample`` on the [H, W] broadcast of those coordinates.
"""

import json
import random
import shutil
import sqlite3
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from neuralstyletransferv1_torch.apps import cryptic_text as tct
from neuralstyletransferv1_torch.apps import generate_mask_samples as tgm
from neuralstyletransferv1_torch.apps import generate_style_selfstyle as tgs
from neuralstyletransferv1_torch.apps import style_mask as tsm
from neuralstyletransferv1_torch.apps import style_showcase as tsc
from neuralstyletransferv1_torch.models import deeplab as tdl
from neuralstyletransferv1_torch.models import magenta as tmag
from neuralstyletransferv1_torch.ops.warp import bilinear_sample

CKPT = Path(__file__).resolve().parent.parent / "_testdata" / "test_johnson.pth"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file (the six-worker tier-1 run shares
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    small = (rng.random((h // 8 + 1, w // 8 + 1, 3)) * 255).astype(np.uint8)
    return np.ascontiguousarray(
        np.asarray(Image.fromarray(small).resize((w, h), Image.BICUBIC)))


def _gate(a, b):
    a, b = np.asarray(a, np.float32) / 255.0, np.asarray(b, np.float32) / 255.0
    d = np.abs(a - b)
    return a.shape == b.shape and ((d <= 1.0 / 255 + 1e-6).mean() >= 0.99 or d.mean() <= 1e-2)


def _read(p):
    return np.asarray(Image.open(p).convert("RGB"))


def _decode(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        out.append(fr)
    cap.release()
    return out


def _same_videos(a, b):
    fa, fb = _decode(a), _decode(b)
    assert len(fa) == len(fb) > 0, (len(fa), len(fb))
    for i, (x, y) in enumerate(zip(fa, fb)):
        assert _gate(x, y), (i, np.abs(x.astype(int) - y.astype(int)).mean())


# ---------------------------------------------------------------- bilinear_sample


@pytest.mark.parametrize("border", ["replicate", "constant"])
@pytest.mark.parametrize("channels", [0, 4])
def test_bilinear_sample_border_matches_jax(border, channels):
    import jax.numpy as jnp

    from neuralstyletransferv1_tpu.ops.warp import bilinear_sample as jbs

    rng = np.random.default_rng(channels)
    shape = (20, 30) + ((channels,) if channels else ())
    img = (rng.random(shape) * 255).astype(np.float32)
    mx = rng.uniform(-3, 33, (3, 20, 30)).astype(np.float32)
    my = rng.uniform(-3, 23, (3, 20, 30)).astype(np.float32)
    got = bilinear_sample(torch.from_numpy(img), torch.from_numpy(mx), torch.from_numpy(my),
                          border=border, border_value=7.0)
    want = np.asarray(jbs(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my), border=border,
                          border_value=7.0))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    if border == "constant":
        out = (mx < 0) | (mx > 29) | (my < 0) | (my > 19)
        assert out.any() and np.all(got.numpy()[out] == 7.0)
    with pytest.raises(ValueError):
        bilinear_sample(torch.from_numpy(img), torch.from_numpy(mx), torch.from_numpy(my),
                        border="wrap")


# ---------------------------------------------------------------- cryptic_text


def test_cryptic_fills_masks_and_paths_match_jax():
    from neuralstyletransferv1_tpu.apps import cryptic_text as jct

    mask = np.zeros((20, 40), np.uint8)
    mask[5:15, 10:30] = 255
    for g in ("fire", "ice", "rainbow", "chrome", "white"):
        np.testing.assert_array_equal(tct.apply_gradient_fill(mask, g, 0.3),
                                      jct.apply_gradient_fill(mask, g, 0.3))
    rgba = tct.apply_gradient_fill(mask, "rainbow", 0.1)
    np.testing.assert_array_equal(tct.apply_neon_glow(rgba, (0, 255, 255), 6),
                                  jct.apply_neon_glow(rgba, (0, 255, 255), 6))
    np.testing.assert_array_equal(tct.render_text_mask("Hi", None, 24),
                                  jct.render_text_mask("Hi", None, 24))
    for a, b in zip(tct.render_letter_masks("AB", None, 32), jct.render_letter_masks("AB", None, 32)):
        np.testing.assert_array_equal(a.pop("mask"), b.pop("mask"))
        assert a == b
    for anim in tct.ANIMATIONS:
        for t in (0.0, 0.3, 0.7, 1.0):
            assert tct.get_animation_position(anim, t, (320, 240), (60, 20)) == \
                jct.get_animation_position(anim, t, (320, 240), (60, 20))
    np.testing.assert_array_equal(tct.rotate_and_scale_rgba(rgba, 30.0, 0.8),
                                  jct.rotate_and_scale_rgba(rgba, 30.0, 0.8))


@pytest.mark.parametrize("kind", ["ripple", "melt", "breathe", "glitch_warp", "wave_distort",
                                  "none"])
def test_cryptic_distortions_match_jax(kind):
    """The remap (constant zero border) on the port's device path; the
    glitch's random draws in the same order from the same seed."""
    from neuralstyletransferv1_tpu.apps import cryptic_text as jct

    rgba = np.zeros((32, 48, 4), np.uint8)
    rgba[8:24, 12:36] = (np.random.default_rng(1).random((16, 24, 4)) * 255).astype(np.uint8)
    ra, rb = random.Random(3), random.Random(3)
    for progress in (0.0, 0.4):
        got = tct.apply_distortion(rgba, kind, progress, rng=ra, device="cpu")
        want = jct.apply_distortion(rgba, kind, progress, rng=rb)
        assert got.shape == want.shape == rgba.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert ra.random() == rb.random()


def test_cryptic_text_frame_matches_jax(tmp_path):
    """One frame's overlay at each fill, the neon colour and the glitch
    drawn from one seeded ``random.Random`` in the JAX order; an NST texture
    fill from a file."""
    import cv2

    from neuralstyletransferv1_tpu.apps import cryptic_text as jct

    tex = tmp_path / "tex.jpg"
    cv2.imwrite(str(tex), _scene(240, 260, 2))
    frame = _scene(240, 320, 1)
    for fill in tct.FILLS:
        ra, rb = random.Random(5), random.Random(5)
        got = tct.apply_text_to_frame(frame, "HEY", None, 48, "float", "glitch_warp", fill, 0.5,
                                      str(tex), rng=ra, device="cpu")
        want = jct.apply_text_to_frame(frame, "HEY", None, 48, "float", "glitch_warp", fill, 0.5,
                                       str(tex), rng=rb)
        assert _gate(got, want), fill
        assert (got != frame).any(), fill  # the text is drawn
    assert tct.find_nst_textures(str(tmp_path / "none")) is None


def test_cryptic_text_cli_matches_jax(tmp_path):
    """Two phrases with their animation, distortion and fill drawn from
    ``--seed``: the decoded videos against JAX's, and the text visible."""
    import cv2

    from neuralstyletransferv1_tpu.apps import cryptic_text as jct

    vid = tmp_path / "in.mp4"
    vw = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"mp4v"), 8, (160, 120))
    base = _scene(120, 160, 0)
    for _ in range(8):
        vw.write(base)
    vw.release()
    argv = ["--input", str(vid), "--phrases", "HELLO,WORLD", "--seed", "7",
            "--texture_dir", str(tmp_path / "none")]
    assert tct.main(argv + ["--output", str(tmp_path / "t.mp4"), "--device", "cpu"]) == 0
    assert jct.main(argv + ["--output", str(tmp_path / "j.mp4")]) == 0
    _same_videos(tmp_path / "t.mp4", tmp_path / "j.mp4")
    assert tct.main(["--list", "--device", "cpu"]) == 0


# ---------------------------------------------------------------- style_showcase


def test_motion_clip_frames_match_jax_sampling():
    import jax
    import jax.numpy as jnp

    from neuralstyletransferv1_tpu.apps import style_showcase as jsc
    from neuralstyletransferv1_tpu.ops.warp import bilinear_sample as jbs

    img = _scene(24, 32, 3)
    with pytest.raises(TypeError):
        jsc.motion_clip_frames(img, "zoom_in", 0.5, 8, 0.1)
    for x, y in zip(tsc.motion_clip_frames(img, "none", 0.5, 8, 0.1),
                    jsc.motion_clip_frames(img, "none", 0.5, 8, 0.1)):
        np.testing.assert_array_equal(x, y)
    h, w = img.shape[:2]
    gx = jnp.arange(w, dtype=jnp.float32)[None, :]
    gy = jnp.arange(h, dtype=jnp.float32)[:, None]
    for motion in tsc.MOTIONS:
        got = tsc.motion_clip_frames(img, motion, 0.75, 8, 0.2, device="cpu", chunk=4)
        assert len(got) == 6 and got[0].dtype == np.uint8 and got[0].shape == img.shape
        z, px, py = (np.asarray(v) for v in tsc._motion_params(
            motion, torch.linspace(0.0, 1.0, 6), 0.2))
        for i, f in enumerate(got):
            sx = jnp.broadcast_to(gx / z[i] + px[i] * w, (h, w))
            sy = jnp.broadcast_to(gy / z[i] + py[i] * h, (h, w))
            want = np.clip(np.asarray(jbs(jnp.asarray(img, jnp.float32), sx, sy)), 0, 255)
            assert np.abs(f.astype(int) - want.astype(np.uint8).astype(int)).max() <= 1, motion
    del jax


def test_showcase_discovery_and_cli_match_jax(tmp_path, monkeypatch):
    """The env contract: two discovered checkpoints, blends, motion none,
    port vs JAX; the port alone with MOTION=ken_burns writes its video."""
    from neuralstyletransferv1_tpu.apps import style_showcase as jsc

    in_dir = tmp_path / "in"
    in_dir.mkdir()
    Image.fromarray(_scene(48, 64, 4)).save(in_dir / "img.png")
    pdir = tmp_path / "pytorch"
    pdir.mkdir()
    shutil.copy(CKPT, pdir / "alpha.pth")
    shutil.copy(CKPT, pdir / "beta.pth")
    env = {"IN_DIR": str(in_dir), "PYTORCH_DIR": str(pdir), "TORCH_DIR": str(tmp_path / "none"),
           "SCALE": "64", "FPS": "4", "MOTION": "none", "HOLD_MODEL": "0.5",
           "HOLD_ORIG_START": "0.25", "HOLD_ORIG_END": "0.25", "TRANS": "0.25",
           "IO_PRESET": "raw_01", "INCLUDE_BLENDS": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tsc.discover_models(5) == jsc.discover_models(5)
    assert [m[0] for m in tsc.discover_models(1)] == ["alpha"]
    for tag, run in (("t", tsc.main), ("j", jsc.main)):
        monkeypatch.setenv("OUT_DIR", str(tmp_path / tag))
        if tag == "t":
            monkeypatch.setenv("DEVICE", "cpu")
        assert run([]) == 0
    _same_videos(tmp_path / "t" / "img_showcase.mp4", tmp_path / "j" / "img_showcase.mp4")
    monkeypatch.setenv("MOTION", "ken_burns")
    monkeypatch.setenv("OUT_DIR", str(tmp_path / "kb"))
    assert tsc.main([]) == 0
    assert len(_decode(tmp_path / "kb" / "img_showcase.mp4")) > 0


# ---------------------------------------------------------------- DeepLab apps


@pytest.fixture(scope="module")
def seg(tmp_path_factory):
    """A seeded 21-class MobileNetV2 DeepLab (width 0.125) as a
    reference-format ``.pth.tar``, an input photo, and the class the port's
    model finds most often in it (so that its mask is not empty)."""
    from neuralstyletransferv1_torch.apps import sky_swap as tss

    d = tmp_path_factory.mktemp("seg")
    path = d / "deeplab-mobilenet.pth.tar"
    torch.save({"state_dict": tdl.init_state_dict("mobilenet", 21, seed=0, width=0.125)}, path)
    photo = d / "bike-dog-person.png"
    Image.fromarray(_scene(64, 96, 11)).save(photo)
    params, nc, bb = tss.load_deeplab(str(path))
    pred = tss.SegmentationModel(params, nc, bb, device="cpu").predict(Image.open(photo))
    ids, counts = np.unique(pred[pred > 0], return_counts=True)
    return path, photo, int(ids[np.argmax(counts)])


def test_style_mask_cli_matches_jax(seg, tmp_path):
    """FG and BG masked stills of one image, the stills and the slideshow
    against JAX's."""
    from neuralstyletransferv1_torch.apps.sky_swap import VOC21_LABELS
    from neuralstyletransferv1_tpu.apps import style_mask as jsm

    path, photo, cid = seg
    label = {v: k for k, v in VOC21_LABELS.items()}[cid]
    argv = ["--images", str(photo), "--deeplab_weights", str(path), "--target_labels", label,
            "--fg_model", str(CKPT), "--io_preset", "raw_01", "--size", "96", "--mask_res",
            "64", "--mask_feather", "2", "--hold_secs", "0.5", "--fade_secs", "0.25",
            "--fps", "4"]
    for tag, run, extra in (("t", tsm.main, ["--device", "cpu"]), ("j", jsm.main, [])):
        assert run(argv + ["--output", str(tmp_path / f"{tag}.mp4"), "--out_stills",
                           str(tmp_path / f"s{tag}")] + extra) == 0
    for name in ("bike-dog-person_fg.png", "bike-dog-person_bg.png"):
        a, b = _read(tmp_path / "st" / name), _read(tmp_path / "sj" / name)
        assert _gate(a, b), name
    fg, bg = _read(tmp_path / "st" / "bike-dog-person_fg.png"), _read(
        tmp_path / "st" / "bike-dog-person_bg.png")
    assert np.abs(fg.astype(int) - bg.astype(int)).mean() > 1  # the masks differ
    _same_videos(tmp_path / "t.mp4", tmp_path / "j.mp4")


def test_generate_mask_samples_matches_jax(seg, tmp_path):
    """One normal and one inverted sample config: masks, styled images,
    sheets, preset JSONs and the metadata index against JAX's."""
    from neuralstyletransferv1_tpu.apps import generate_mask_samples as jgm

    path, photo, cid = seg
    samples = [{"input_prefix": "bike-dog-person", "target_ids": str(cid), "invert": False,
                "name": "styled", "preset_name": "Mask: Style", "tags": ["mask"]},
               {"input_prefix": "bike-dog-person", "target_ids": f"{cid},0", "invert": True,
                "name": "protected"}]
    sj = tmp_path / "samples.json"
    sj.write_text(json.dumps(samples))
    argv = ["--input_dir", str(photo.parent), "--deeplab_weights", str(path), "--backbone",
            "mobilenet", "--model", str(CKPT), "--io_preset", "raw_01", "--samples_json",
            str(sj), "--scale", "96"]
    for tag, run, extra in (("t", tgm.main, ["--device", "cpu"]), ("j", jgm.main, [])):
        assert run(argv + ["--output_dir", str(tmp_path / f"o{tag}"), "--work_dir",
                           str(tmp_path / f"w{tag}")] + extra) == 0
    for name in ("styled", "protected"):
        assert _gate(np.asarray(Image.open(tmp_path / "wt" / f"{name}_mask.png")),
                     np.asarray(Image.open(tmp_path / "wj" / f"{name}_mask.png")))
        for f in (f"{name}.jpg", f"{name}_comparison.jpg"):
            assert _gate(_read(tmp_path / "ot" / f), _read(tmp_path / "oj" / f)), f
        assert (tmp_path / "ot" / f"{name}_preset.json").read_text() == \
            (tmp_path / "oj" / f"{name}_preset.json").read_text()
    assert (tmp_path / "ot" / "mask_samples_metadata.json").read_text() == \
        (tmp_path / "oj" / "mask_samples_metadata.json").read_text()
    m = np.asarray(Image.open(tmp_path / "wt" / "styled_mask.png"))
    assert 0 < (m > 127).mean() < 1


# ---------------------------------------------------------------- generate_style_selfstyle


@pytest.fixture
def jmag(monkeypatch):
    """JAX's ``magenta.init`` returns the port's ``init_tree(0)``."""
    import jax
    import jax.numpy as jnp

    from neuralstyletransferv1_tpu.models import magenta as jm

    tree = tmag.init_tree(0)
    monkeypatch.setattr(jm, "init", lambda key: jax.tree.map(jnp.asarray, tree))
    return tree


def test_self_style_matches_jax(jmag, tmp_path, monkeypatch):
    """Tile 48 / overlap 8 with the long side capped at 64 (resized back),
    blend 0.9."""
    from neuralstyletransferv1_tpu.apps import generate_style_selfstyle as jgs

    monkeypatch.chdir(tmp_path)
    img01 = _scene(60, 80, 8).astype(np.float32) / 255.0
    got = tgs.self_style(img01, 48, 8, 0.9, scale=64, device="cpu")
    want = np.asarray(jgs.self_style(img01, 48, 8, 0.9, scale=64))
    assert got.shape == want.shape == (60, 80, 3)
    assert _gate((np.clip(got, 0, 1) * 255).astype(np.uint8),
                 (np.clip(want, 0, 1) * 255).astype(np.uint8))
    crop = _scene(80, 100, 1)
    np.testing.assert_array_equal(tgs.extract_center_crop(crop, 0.6),
                                  jgs.extract_center_crop(crop, 0.6))
    np.testing.assert_array_equal(tgs.add_thumbnail_overlay(crop, crop[:40]),
                                  jgs.add_thumbnail_overlay(crop, crop[:40]))


def test_generate_style_selfstyle_cli_matches_jax(jmag, tmp_path, monkeypatch):
    """Samples, comparisons and the presets DB rows against JAX's."""
    import cv2

    from neuralstyletransferv1_tpu.apps import generate_style_selfstyle as jgs

    monkeypatch.chdir(tmp_path)
    src = tmp_path / "src"
    src.mkdir()
    cv2.imwrite(str(src / "a.png"), _scene(80, 100, 2))
    argv = ["--input_dir", str(src), "--tile", "48", "--overlap", "8", "--scale", "100"]
    for tag, run, extra in (("t", tgs.main, ["--device", "cpu"]), ("j", jgs.main, [])):
        assert run(argv + ["--output_dir", str(tmp_path / tag), "--db",
                           str(tmp_path / f"{tag}.db")] + extra) == 0
    for f in ("a_selfstyle.jpg", "a_comparison.jpg"):
        assert _gate(_read(tmp_path / "t" / f), _read(tmp_path / "j" / f)), f
    rows = []
    for tag in "tj":
        con = sqlite3.connect(tmp_path / f"{tag}.db")
        rows.append(con.execute(
            "SELECT name, description, model_type, magenta_style, magenta_tile, "
            "magenta_overlap, blend, sample_image_path FROM presets").fetchall())
        con.close()
    assert len(rows[0]) == len(rows[1]) == 1
    assert rows[0][0][:7] == rows[1][0][:7]
    assert [Path(r[0][7]).name for r in rows] == ["a_selfstyle.jpg"] * 2
