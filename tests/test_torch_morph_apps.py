"""The port's morph apps on the CPU (``--device cpu``) against the JAX apps
on the same inputs: ``morph`` (``optical_flow_morph``, the slideshow CLI),
``morph_faces`` (the zoom/blob compositing, the styled face ladder, the
CLI with ``--manual_faces`` and its run log), ``gen_pytorch_only_videos``
(the wipe transitions, the dual blob, the face mode), ``morph_v2`` (the
region analysis over a seeded MobileNetV2 DeepLab, the motion pass, the
CLI) and ``morph_slideshow`` (the transitions, the CLI) — the twins of
``tests/test_morph_faces.py``, ``test_morph_slideshow.py`` and
``test_morph_v2_motion.py``.

The CLIs are compared on the frames they hand to ``cv2.VideoWriter`` (a
stand-in keeps them by path): the lossy mp4 encode of these small frames
turns a 1-level difference into several.

Tolerance: morph frames (``optical_flow_morph`` and the videos made of
them) by mean |Δ| ≤ 1 level and the share within 1 level ≥ 99%, never by
the maximum: Farneback's gather rounds ``p + flow`` and a rounding flip
moves a pixel of the flow. Other images and decoded video frames within 1
level of JAX's on ≥ 99% of the pixels or 1e-2 MAE on [0, 1] (the port's
CLI gate). Host-only compositing (the same numpy/OpenCV code) is equal.
Magenta runs the compact net on ``magenta.init_tree(0)`` in both packages
(JAX's ``magenta.init`` is given that tree); styles use
``_testdata/test_johnson.pth`` under ``raw_01``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from neuralstyletransferv1_torch.apps import gen_pytorch_only_videos as tgp
from neuralstyletransferv1_torch.apps import morph as tmo
from neuralstyletransferv1_torch.apps import morph_faces as tmf
from neuralstyletransferv1_torch.apps import morph_slideshow as tms
from neuralstyletransferv1_torch.apps import morph_v2 as tm2
from neuralstyletransferv1_torch.models import deeplab as tdl
from neuralstyletransferv1_torch.models import magenta as tmag

CKPT = Path(__file__).resolve().parent.parent / "_testdata" / "test_johnson.pth"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file (the six-worker tier-1 run shares
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jmag(monkeypatch):
    """JAX's ``magenta.init`` returns the port's ``init_tree(0)``, and its
    eager ``stylize_tiled`` runs jitted (one compile a tile size)."""
    import jax
    import jax.numpy as jnp

    from neuralstyletransferv1_tpu.models import magenta as jm

    tree = tmag.init_tree(0)
    monkeypatch.setattr(jm, "init", lambda key: jax.tree.map(jnp.asarray, tree))
    monkeypatch.setattr(jm, "stylize_tiled", jax.jit(
        jm.stylize_tiled, static_argnames=("tile_size", "overlap", "transfer_fn",
                                           "compute_dtype")))
    return tree


def _scene(h, w, seed, shift=(0, 0)):
    """Smooth texture (a flow has something to follow), shifted."""
    rng = np.random.default_rng(seed)
    small = (rng.random((h // 8 + 1, w // 8 + 1, 3)) * 255).astype(np.uint8)
    big = np.asarray(Image.fromarray(small).resize((w + 16, h + 16), Image.BICUBIC))
    return np.ascontiguousarray(big[8 + shift[0]:8 + shift[0] + h, 8 + shift[1]:8 + shift[1] + w])


def _morph_close(got, want):
    got, want = np.stack(got).astype(np.int32), np.stack(want).astype(np.int32)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.mean() <= 1.0 and (d <= 1).mean() >= 0.99, (d.mean(), (d <= 1).mean())


def _gate(a, b):
    a, b = np.asarray(a, np.float32) / 255.0, np.asarray(b, np.float32) / 255.0
    d = np.abs(a - b)
    return a.shape == b.shape and ((d <= 1.0 / 255 + 1e-6).mean() >= 0.99 or d.mean() <= 1e-2)


class _Capture:
    """A ``cv2.VideoWriter`` stand-in that keeps each path's frames."""

    by_path: dict = {}

    def __init__(self, path, *a, **k):
        self.frames = _Capture.by_path.setdefault(str(path), [])

    def isOpened(self):
        return True

    def write(self, f):
        self.frames.append(np.array(f))

    def release(self):
        pass


@pytest.fixture
def videos(monkeypatch):
    """{path: frames} of every video the apps write in the test."""
    import cv2

    _Capture.by_path = {}
    monkeypatch.setattr(cv2, "VideoWriter", _Capture)
    return _Capture.by_path


def _same_videos(videos, a, b, morph=False):
    fa, fb = videos[str(a)], videos[str(b)]
    assert len(fa) == len(fb) > 0, (a, len(fa), len(fb))
    if morph:
        _morph_close(fa, fb)
    else:
        for i, (x, y) in enumerate(zip(fa, fb)):
            assert _gate(x, y), (i, np.abs(x.astype(int) - y.astype(int)).mean())


# ---------------------------------------------------------------- morph


@pytest.fixture(scope="module")
def morph_pair():
    """A 64×96 pair (the second panned by (3, 5) px) and JAX's morph of it,
    7 frames, smooth easing."""
    from neuralstyletransferv1_tpu.apps import morph as jmo

    a, b = _scene(64, 96, 0), _scene(64, 96, 0, shift=(3, 5))
    return a, b, jmo.optical_flow_morph(a, b, 7)


@pytest.mark.parametrize("chunk", [2, 24])
def test_optical_flow_morph_matches_jax(morph_pair, chunk):
    a, b, want = morph_pair
    got = tmo.optical_flow_morph(a, b, 7, device="cpu", chunk=chunk)
    assert len(got) == 7 and got[0].dtype == np.uint8 and got[0].shape == (64, 96, 3)
    _morph_close(got, want)
    # the endpoints are the images themselves (up to the truncating cast)
    assert np.abs(got[0].astype(int) - a).mean() < 1.0
    assert np.abs(got[-1].astype(int) - b).mean() < 1.0


def test_morph_flows_resize_and_easing(morph_pair):
    """A second image of another size is resized to the first's (PIL
    bilinear, as JAX); the easings the CLI offers all run."""
    from neuralstyletransferv1_tpu.apps import morph as jmo

    a, b, _ = morph_pair
    b_big = np.asarray(Image.fromarray(b).resize((120, 80), Image.BILINEAR))
    got = tmo.optical_flow_morph(a, b_big, 3, "linear", device="cpu")
    want = jmo.optical_flow_morph(a, b_big, 3, "linear")
    _morph_close(got, want)
    for e in ("smoother", "smooth", "linear"):
        assert len(tmo.optical_flow_morph(a, b, 2, e)) == 2


def test_morph_host_helpers_match_jax(tmp_path):
    import argparse

    from neuralstyletransferv1_tpu.apps import morph as jmo

    frames = [_scene(16, 24, s) for s in range(5)]
    for k, sigma in ((3, 1.0), (5, 2.0)):
        for x, y in zip(tmo.temporal_smooth_frames(frames, k, sigma),
                        jmo.temporal_smooth_frames(frames, k, sigma)):
            np.testing.assert_array_equal(x, y)
    assert tmo.VARIANTS == jmo.VARIANTS
    for t in (0.0, 0.3, 0.5, 0.9):
        assert tmo.ease_in_out_cubic(t) == jmo.ease_in_out_cubic(t)
        assert tmo.smootherstep(t) == jmo.smootherstep(t)
        assert tmo.calculate_zoom_pulse(t) == jmo.calculate_zoom_pulse(t)
    for name in ("img1_tile_a.jpg", "img2_x.png", "canyon_1.jpg", "canyon_wave.jpg", "z.png"):
        Image.fromarray(_scene(8, 8, 1)).save(tmp_path / name)
    for kw in ({"name_filter": None, "exclude": None, "order": "sorted", "max_images": 0},
               {"name_filter": "canyon|img", "exclude": "wave", "order": "shuffle",
                "max_images": 2}):
        args = argparse.Namespace(glob="*.jpg,*.png", image_dir=str(tmp_path), seed=7, **kw)
        assert tmo.select_images(args) == jmo.select_images(args)
    np.testing.assert_array_equal(tmo._load_cover(tmp_path / "z.png", (12, 6), 1.5),
                                  jmo._load_cover(tmp_path / "z.png", (12, 6), 1.5))


def test_morph_cli_matches_jax(tmp_path, monkeypatch):
    """The slideshow CLI: an mp4 of hold + morph + hold frames, and the
    frames against JAX's."""
    import cv2

    from neuralstyletransferv1_tpu.apps import morph as jmo

    paths = []
    for i, sh in enumerate(((0, 0), (2, 4))):
        p = tmp_path / f"m{i}.png"
        Image.fromarray(_scene(48, 64, 3, sh)).save(p)
        paths.append(str(p))
    argv = ["--images", *paths, "--morph_frames", "4", "--hold_frames", "1", "--fps", "6",
            "--temporal_smooth"]
    assert tmo.main(argv + ["--output", str(tmp_path / "real.mp4"), "--device", "cpu"]) == 0
    cap = cv2.VideoCapture(str(tmp_path / "real.mp4"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    cap.release()
    _Capture.by_path = {}
    monkeypatch.setattr(cv2, "VideoWriter", _Capture)
    assert tmo.main(argv + ["--output", str(tmp_path / "t.mp4"), "--device", "cpu"]) == 0
    assert jmo.main(argv + ["--output", str(tmp_path / "j.mp4")]) == 0
    _same_videos(_Capture.by_path, tmp_path / "t.mp4", tmp_path / "j.mp4", morph=True)


# ---------------------------------------------------------------- morph_faces


def test_face_compositing_matches_jax():
    """The host compositing is the JAX app's code: equal outputs."""
    from neuralstyletransferv1_tpu.apps import morph_faces as jmf

    faces = [{"id": 1, "bbox": (10, 10, 50, 50), "confidence": 0.9},
             {"id": 2, "bbox": (12, 12, 50, 50), "confidence": 0.8},
             {"id": 3, "bbox": (200, 200, 40, 40), "confidence": 0.7}]
    assert tmf.filter_overlapping_faces([dict(f) for f in faces]) == \
        jmf.filter_overlapping_faces([dict(f) for f in faces])
    assert tmf.calculate_safe_zoom((0.1, 0.5), 1.0) == pytest.approx(5.0)
    np.testing.assert_array_equal(tmf.create_soft_multi_blob_masks(32, 48, 3, num_blobs=4),
                                  jmf.create_soft_multi_blob_masks(32, 48, 3, num_blobs=4))
    imgs = [_scene(60, 80, s) for s in range(3)]
    orig = _scene(60, 80, 9)
    for fn, args in (("create_face_zoom_out", (imgs, orig, (40, 24), 1.0, 3.0, 8, 1.0,
                                               (0.5, 0.5))),
                     ("create_blob_face_morph", (imgs, orig, (40, 24), 1.0, 3.0, 6, 0.3,
                                                 (0.4, 0.6))),
                     ("create_face_crossfade", (orig, imgs, (40, 24), 1.0, 3.0, 6, 0.5,
                                                (0.5, 0.5), (0.3, 0.4)))):
        got, want = getattr(tmf, fn)(*args), getattr(jmf, fn)(*args)
        assert len(got) == len(want) > 0, fn
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tmf.extract_face_crop(orig, (20, 10, 20, 20)),
                                  jmf.extract_face_crop(orig, (20, 10, 20, 20)))
    assert tmf._parse_manual_faces("1,2,30,40;5,6,7,8", (100, 80)) == \
        jmf._parse_manual_faces("1,2,30,40;5,6,7,8", (100, 80))


def test_style_face_set_matches_jax(jmag, tmp_path, monkeypatch):
    """A face crop's ladder: magenta at tiles 32 and 48 (64 does not fit),
    pre-styled by one transformer checkpoint, largest tile first."""
    from neuralstyletransferv1_tpu.apps import morph_faces as jmf

    monkeypatch.chdir(tmp_path)  # keep the relative models/magenta root empty
    crop = _scene(52, 60, 4)[..., ::-1]
    tiles = [(32, 8), (48, 8), (64, 8)]
    got = tmf.style_face_set(crop, tiles, [str(CKPT)], 128, 0.95, device="cpu")
    want = jmf.style_face_set(crop, tiles, [str(CKPT)], 128, 0.95)
    assert len(got) == len(want) == 4
    for x, y in zip(got, want):
        assert x.dtype == np.uint8 and _gate(x, y)


def test_pytorch_style_matches_jax(tmp_path):
    """The transformer pre-style of a crop, capped at 48 px and resized
    back, blended 0.9."""
    from neuralstyletransferv1_tpu.apps import morph_faces as jmf

    ckpt = tmp_path / "raw01.pth"
    sd = torch.load(CKPT, map_location="cpu", weights_only=False)
    torch.save(sd, ckpt)
    x01 = _scene(40, 60, 5).astype(np.float32) / 255.0
    got = tmf._pytorch_style(x01, ckpt, 48, 0.9, device="cpu")
    want = jmf._pytorch_style(x01, ckpt, 48, 0.9)
    assert got.shape == want.shape == (40, 60, 3)
    assert np.abs(got - want).mean() <= 1e-2


def test_morph_faces_cli_matches_jax(jmag, videos, tmp_path, monkeypatch):
    """``--manual_faces`` with two faces (a crossfade between them), tiles
    32, blob mode off and on: the videos and the run logs."""
    import cv2

    from neuralstyletransferv1_tpu.apps import morph_faces as jmf

    monkeypatch.chdir(tmp_path)
    p = tmp_path / "in.png"
    cv2.imwrite(str(p), _scene(96, 128, 1))
    argv = ["--image", str(p), "--manual_faces", "20,20,40,40;70,40,40,40", "--tiles", "32",
            "--fps", "4", "--morph_time", "0.5", "--transition", "0.5", "--scale", "128",
            "--horizontal"]
    assert tmf.main(argv + ["--output_dir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert jmf.main(argv + ["--output_dir", str(tmp_path / "j")]) == 0
    a, b = (tmp_path / s / "in" / "in_faces_zoom.mp4" for s in "tj")
    _same_videos(videos, a, b)
    logs = [json.loads((tmp_path / s / "in" / "in_faces_zoom_run.json").read_text())
            for s in "tj"]
    for log in logs:
        log.pop("timestamp")
        log.pop("output_video")
    assert logs[0] == logs[1] and logs[0]["faces_detected"] == 2
    argv[3] = "30,20,50,50"
    assert tmf.main(argv + ["--blob", "--num_blobs", "3", "--output_dir", str(tmp_path / "t"),
                            "--device", "cpu"]) == 0
    assert jmf.main(argv + ["--blob", "--num_blobs", "3", "--output_dir", str(tmp_path / "j")]) == 0
    _same_videos(videos, *(tmp_path / s / "in" / "in_faces_blob.mp4" for s in "tj"))


# ---------------------------------------------------------------- gen_pytorch_only_videos


@pytest.mark.parametrize("kind", ["spiral", "radial", "blob"])
def test_transition_frames_match_jax(kind):
    from neuralstyletransferv1_tpu.apps import gen_pytorch_only_videos as jgp

    a, b = _scene(40, 56, 1), _scene(40, 56, 2)
    got = tgp.transition_frames(a, b, kind, 6, seed=43, device="cpu", chunk=4)
    want = jgp.transition_frames(a, b, kind, 6, seed=43)
    assert len(got) == len(want) == 6
    for x, y in zip(got, want):
        assert x.dtype == np.uint8 and _gate(x, y)
    np.testing.assert_array_equal(got[0], a)


def test_gpov_host_helpers_match_jax():
    from neuralstyletransferv1_tpu.apps import gen_pytorch_only_videos as jgp

    np.testing.assert_array_equal(tgp.create_animated_blob_mask(24, 32, 5),
                                  jgp.create_animated_blob_mask(24, 32, 5))
    imgs = [_scene(24, 32, s) for s in range(4)]
    for x, y in zip(tgp.brightness_order(imgs), jgp.brightness_order(imgs)):
        np.testing.assert_array_equal(x, y)
    got = tgp.create_dual_morph_blob(imgs, imgs[0], target_size=(32, 24), max_zoom=2.0, fps=4,
                                     duration=1.5)
    want = jgp.create_dual_morph_blob(imgs, imgs[0], target_size=(32, 24), max_zoom=2.0, fps=4,
                                      duration=1.5)
    assert len(got) == len(want) == 6
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_gpov_cli_matches_jax(videos, tmp_path):
    """The wipe path (two checkpoints, brightness order), the dual blob and
    the face mode, port vs JAX."""
    import cv2

    from neuralstyletransferv1_tpu.apps import gen_pytorch_only_videos as jgp

    img = tmp_path / "in.png"
    cv2.imwrite(str(img), _scene(48, 64, 6))
    base = ["--image", str(img), "--io_preset", "raw_01", "--size", "64", "--fps", "6"]
    runs = {
        "wipe": ["--models", str(CKPT), str(CKPT), "--transition_frames", "4",
                 "--hold_frames", "1", "--masks", "spiral,blob"],
        "dual": ["--models", str(CKPT), str(CKPT), "--dual_blob", "--duration", "1.0",
                 "--max_zoom", "2.0"],
        "face": ["--models", str(CKPT), "--face_mode", "--manual_faces", "10,10,30,30",
                 "--duration", "1.0", "--max_zoom", "2.0"],
    }
    for name, extra in runs.items():
        assert tgp.main(base + extra + ["--output", str(tmp_path / f"t_{name}.mp4"),
                                        "--device", "cpu"]) == 0
        assert jgp.main(base + extra + ["--output", str(tmp_path / f"j_{name}.mp4")]) == 0
        _same_videos(videos, tmp_path / f"t_{name}.mp4", tmp_path / f"j_{name}.mp4")


# ---------------------------------------------------------------- morph_v2


def test_morph_v2_helpers_match_jax():
    from neuralstyletransferv1_tpu.apps import morph_v2 as jm2

    pred = np.zeros((40, 60), np.uint8)
    pred[5:25, 10:30] = 15
    pred[30:38, 40:58] = 7
    pred[0:4, 0:60] = 3
    labels = {0: "background", 3: "bird", 7: "car", 15: "person"}
    regions = tm2.analyze_regions(pred, labels)
    assert regions == jm2.analyze_regions(pred, labels) and regions[0]["label"] == "person"
    assert tm2.select_best_region(regions, 1.0, 10.0) == jm2.select_best_region(regions, 1.0, 10.0)
    for cov in (1.0, 3.0, 10.0, 30.0, 70.0):
        assert tm2.calculate_region_score(cov, 10, 20, 0.3, 0.6, 60, 40, "dog") == \
            jm2.calculate_region_score(cov, 10, 20, 0.3, 0.6, 60, 40, "dog")
    img = _scene(40, 60, 2)
    np.testing.assert_array_equal(tm2.extract_crop(img, pred == 15, padding=3),
                                  jm2.extract_crop(img, pred == 15, padding=3))
    np.testing.assert_array_equal(tm2.apply_hue_shift(img, 90.0), jm2.apply_hue_shift(img, 90.0))
    frames = [np.roll(img, i, axis=1) for i in range(12)]
    for kw in ({"pan_zoom": 2.0, "pan_direction": "diagonal_reverse"},
               {"zoom_pulse": 0.05, "hue_rotate": 30.0}, {}):
        for x, y in zip(tm2.apply_motion_effects(frames, **kw),
                        jm2.apply_motion_effects(frames, **kw)):
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def mobilenet_ckpt(tmp_path_factory):
    """A seeded 21-class MobileNetV2 DeepLab at width 0.125, as a
    reference-format ``.pth.tar`` that both packages' importers read."""
    path = tmp_path_factory.mktemp("deeplab") / "deeplab-mobilenet.pth.tar"
    torch.save({"state_dict": tdl.init_state_dict("mobilenet", 21, seed=0, width=0.125)}, path)
    return path


def test_morph_v2_cli_matches_jax(jmag, mobilenet_ckpt, videos, tmp_path, monkeypatch):
    """The region crop over the seeded DeepLab's prediction, one pre-style
    blend variant (50%), the self-style ladder (no tile fits the 48-px crop:
    the crop itself) and the morph with Ken Burns and hue: port vs JAX."""
    from neuralstyletransferv1_tpu.apps import morph_v2 as jm2

    monkeypatch.chdir(tmp_path)
    img = tmp_path / "in.png"
    Image.fromarray(_scene(64, 96, 7)).save(img)
    argv = ["--image", str(img), "--deeplab_weights", str(mobilenet_ckpt), "--seg_res", "64",
            "--crop_size", "48", "--morph_frames", "3", "--fps", "6", "--pytorch_model",
            str(CKPT), "--pytorch_blends", "0,50", "--io_preset", "raw_01", "--pan_zoom", "1.5",
            "--hue_rotate", "20"]
    assert tm2.main(argv + ["--output", str(tmp_path / "t.mp4"), "--device", "cpu"]) == 0
    assert jm2.main(argv + ["--output", str(tmp_path / "j.mp4")]) == 0
    _same_videos(videos, tmp_path / "t.mp4", tmp_path / "j.mp4", morph=True)


def test_morph_v2_face_without_detector(capsys):
    """``--face`` without the res10 files: the JAX app's warning and None."""
    img = _scene(32, 32, 0)
    assert tm2.detect_face_crop("in.png", img, "none.prototxt", "none.caffemodel") is None
    assert "face detector files missing" in capsys.readouterr().out


# ---------------------------------------------------------------- morph_slideshow


@pytest.mark.parametrize("kind", ["fade", "dissolve", "wipeleft", "wiperight", "smoothleft",
                                  "smoothright"])
def test_slideshow_transitions_match_jax(kind):
    from neuralstyletransferv1_tpu.apps import morph_slideshow as jms

    a, b = _scene(20, 30, 1), _scene(20, 30, 2)
    got, want = tms.crossfade_frames(a, b, kind, 5, seed=1), jms.crossfade_frames(a, b, kind, 5,
                                                                                  seed=1)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    stills = [a, b, a]
    got = tms.build_slideshow(stills, fps=4, hold_start=0.5, hold_end=0.5, hold_model=0.25,
                              trans=0.5, transition=kind)
    want = jms.build_slideshow(stills, fps=4, hold_start=0.5, hold_end=0.5, hold_model=0.25,
                               trans=0.5, transition=kind)
    assert len(got) == len(want) == 9
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_morph_slideshow_cli_matches_jax(videos, tmp_path):
    from neuralstyletransferv1_tpu.apps import morph_slideshow as jms

    in_dir = tmp_path / "in"
    in_dir.mkdir()
    Image.fromarray(_scene(48, 64, 3)).save(in_dir / "photo.png")
    argv = ["--in_dir", str(in_dir), "--models", f"candy:{CKPT}", f"mosaic:{CKPT}:transformer",
            "--io_preset", "raw_01", "--scale", "64", "--fps", "4", "--hold_orig_start", "0.5",
            "--hold_orig_end", "0.5", "--hold_model", "0.5", "--trans", "0.5", "--seed", "42",
            "--include_allfour", "1"]
    assert tms.main(argv + ["--out_dir", str(tmp_path / "t"), "--work_root", str(tmp_path / "wt"),
                            "--device", "cpu"]) == 0
    assert jms.main(argv + ["--out_dir", str(tmp_path / "j"),
                            "--work_root", str(tmp_path / "wj")]) == 0
    _same_videos(videos, tmp_path / "t" / "photo_morph.mp4", tmp_path / "j" / "photo_morph.mp4")
