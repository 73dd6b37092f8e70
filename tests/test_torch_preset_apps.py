"""The port's engine-driving apps end to end on the CPU (``--device cpu`` /
``DEVICE=cpu``): ``generate_preset_samples``, ``generate_video_samples``,
``generate_morph_samples``, ``run_videos`` and ``run_styles``, each against
the JAX app on the same small inputs (the twins of
``tests/test_presets.py``'s rendering cases, ``tests/test_run_videos.py``
and ``tests/test_run_styles.py``); and every app that drives the engine
raising without ``--device`` / ``DEVICE`` where no GPU is visible.

Tolerance: each rendered image, and each frame decoded from a video or GIF,
within 1 level of JAX's on ≥ 99% of the pixels or 1e-2 MAE on [0, 1] (the
port's CLI gate; the encoders are the same on both sides).
"""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

CKPT = Path(__file__).resolve().parent.parent / "_testdata" / "test_johnson.pth"


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


def _gate(a, b):
    a, b = np.asarray(a, np.float32) / 255.0, np.asarray(b, np.float32) / 255.0
    d = np.abs(a - b)
    return a.shape == b.shape and ((d <= 1.0 / 255 + 1e-6).mean() >= 0.99 or d.mean() <= 1e-2)


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
    assert len(fa) == len(fb) > 0, (a, len(fa), len(fb))
    for i, (x, y) in enumerate(zip(fa, fb)):
        assert _gate(x, y), (a.name, i, np.abs(x.astype(float) - y).mean())


def _img(path, w=96, h=64, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(path)


@pytest.fixture()
def small_db(tmp_path):
    """``tests/test_presets.py``'s renderable DB (the Johnson test
    checkpoint in every slot), written through the port's presets API. The
    voronoi duo also rotates: an animating region set takes the fixed seed
    42, where a static one draws an unseeded layout in either engine."""
    from neuralstyletransferv1_torch.presets import (connect, create_schema, insert_preset,
                                                     upsert_category)

    db = tmp_path / "small.db"
    conn = connect(db)
    create_schema(conn)
    upsert_category(conn, 1, "Transformer", "test", 1)
    upsert_category(conn, 2, "Regions", "test", 2)
    upsert_category(conn, 3, "Morphs", "test", 3)
    insert_preset(conn, name="Solo Candy", category_id=1, model_type="transformer",
                  model_path=str(CKPT), io_preset="raw_255", blend=0.9)
    insert_preset(conn, name="Voronoi Duo", category_id=2, model_type="transformer",
                  model_path=str(CKPT), io_preset="raw_255", model_b_type="transformer",
                  model_b_path=str(CKPT), io_preset_b="raw_01", region_mode="voronoi",
                  region_count=2, region_feather=10, region_rotate=15.0)
    insert_preset(conn, name="Blob Motion", category_id=3, model_type="transformer",
                  model_path=str(CKPT), io_preset="raw_255", region_mode="voronoi",
                  region_count=2, region_feather=10, region_morph="1.0,0.2,2.0,blob")
    conn.commit()
    conn.close()
    return db


def _twin_dbs(db, tmp_path):
    a, b = tmp_path / "port.db", tmp_path / "jax.db"
    shutil.copy(db, a)
    shutil.copy(db, b)
    return a, b


def test_generate_preset_samples_matches_jax(small_db, tmp_path):
    from PIL import Image

    from neuralstyletransferv1_torch.apps.generate_preset_samples import main
    from neuralstyletransferv1_torch.presets import load_presets
    from neuralstyletransferv1_tpu.apps.generate_preset_samples import main as jmain

    img = tmp_path / "in.png"
    _img(img)
    dbs = _twin_dbs(small_db, tmp_path)
    for run, db, tag in ((main, dbs[0], "t"), (jmain, dbs[1], "j")):
        extra = ["--device", "cpu"] if tag == "t" else []
        assert run(["--db", str(db), "--input_image", str(img), "--output_dir",
                    str(tmp_path / f"s{tag}"), "--work_dir", str(tmp_path / f"w{tag}"),
                    "--scale", "96"] + extra) == 0
    names = sorted(p.name for p in (tmp_path / "st").glob("*.jpg"))
    assert len(names) == 3 and names == sorted(p.name for p in (tmp_path / "sj").glob("*.jpg"))
    for n in names:
        assert _gate(Image.open(tmp_path / "st" / n), Image.open(tmp_path / "sj" / n)), n
    assert all("sample_image" in p for p in load_presets(dbs[0]))


def test_generate_video_and_morph_samples_match_jax(small_db, tmp_path):
    """The region presets' mp4 previews and the morph preset's GIF (and its
    JSON index) against the JAX apps'."""
    pytest.importorskip("cv2")
    from PIL import Image, ImageSequence

    from neuralstyletransferv1_torch.apps.generate_morph_samples import main as gif_main
    from neuralstyletransferv1_torch.apps.generate_video_samples import main as vid_main
    from neuralstyletransferv1_tpu.apps.generate_morph_samples import main as jgif_main
    from neuralstyletransferv1_tpu.apps.generate_video_samples import main as jvid_main

    img = tmp_path / "in.png"
    _img(img, seed=1)
    common = ["--db", str(small_db), "--input_image", str(img), "--scale", "64", "--frames", "4",
              "--fps", "6"]
    for tag, vm, gm, extra in (("t", vid_main, gif_main, ["--device", "cpu"]),
                               ("j", jvid_main, jgif_main, [])):
        assert vm(common + ["--output_dir", str(tmp_path / f"v{tag}"), "--work_dir",
                            str(tmp_path / f"wv{tag}")] + extra) == 0
        assert gm(common + ["--output_dir", str(tmp_path / f"g{tag}"), "--work_dir",
                            str(tmp_path / f"wg{tag}")] + extra) == 0
    vids = sorted(p.name for p in (tmp_path / "vt").glob("*.mp4"))
    assert len(vids) == 2 and vids == sorted(p.name for p in (tmp_path / "vj").glob("*.mp4"))
    for n in vids:
        _same_videos(tmp_path / "vt" / n, tmp_path / "vj" / n)
    gifs = sorted(p.name for p in (tmp_path / "gt").glob("*.gif"))
    assert gifs == sorted(p.name for p in (tmp_path / "gj").glob("*.gif")) and len(gifs) == 1
    fa, fb = ([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(Image.open(d / gifs[0]))]
              for d in (tmp_path / "gt", tmp_path / "gj"))
    assert len(fa) == len(fb) > 0 and all(_gate(x, y) for x, y in zip(fa, fb))
    assert (tmp_path / "gt" / "morph_samples.json").read_text() == \
        (tmp_path / "gj" / "morph_samples.json").read_text()


def _clip(path, n=6, w=96, h=64):
    import cv2

    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8, (w, h))
    base = (np.random.default_rng(0).random((h, w, 3)) * 255).astype(np.uint8)
    for t in range(n):
        vw.write(np.roll(base, t * 2, axis=1))
    vw.release()


def test_run_videos_matches_jax(tmp_path, monkeypatch):
    """The env contract into both engines, the port through a 2-shard CPU
    mesh (``PIPELINE_ARGS``), JAX on 2 virtual devices; ``DEVICE=cpu``
    reaches the port's engine as ``--device``."""
    pytest.importorskip("cv2")
    from neuralstyletransferv1_torch.apps import run_videos as rv
    from neuralstyletransferv1_tpu.apps import run_videos as jrv

    vid = tmp_path / "in.mp4"
    _clip(vid)
    env = {"MODEL_A": str(CKPT), "MODEL_A_TYPE": "pytorch", "IO_PRESET": "raw_01", "SCALE": "96",
           "FPS": "8", "SMOOTH_LIGHTNESS": "1", "DEVICE": "cpu"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    line = " ".join(rv.build_pipeline_args(str(vid)))
    assert f"--model {CKPT} --model_type transformer" in line and "--device cpu" in line
    for tag, app in (("t", rv), ("j", jrv)):
        monkeypatch.setenv("OUT_DIR", str(tmp_path / f"o{tag}"))
        monkeypatch.setenv("PIPELINE_ARGS", f"--work_dir {tmp_path / ('w' + tag)} "
                                            "--frame_batch 3 --mesh_devices 2")
        assert app.main([str(vid)]) == 0
    _same_videos(tmp_path / "ot" / "in.mp4", tmp_path / "oj" / "in.mp4")


def test_run_styles_matches_jax(tmp_path, monkeypatch):
    pytest.importorskip("cv2")
    from neuralstyletransferv1_torch.apps.run_styles import generate_blend_weights, main
    from neuralstyletransferv1_tpu.apps.run_styles import main as jmain

    (tmp_path / "in").mkdir()
    _clip(tmp_path / "in" / "clip.mp4", n=4)
    env = {"IN_DIR": str(tmp_path / "in"), "MODEL_A": str(CKPT), "IO_PRESET_A": "raw_255",
           "MODEL_B": str(CKPT), "MODEL_B_TYPE": "transformer", "IO_PRESET_B": "raw_01",
           "USE_C": "0", "USE_D": "0", "BLEND_WEIGHTS": "0.6,0.4", "FPS": "8", "SCALE": "96"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for tag, run in (("t", main), ("j", jmain)):
        monkeypatch.setenv("OUT_DIR", str(tmp_path / f"o{tag}"))
        monkeypatch.setenv("WORK_ROOT", str(tmp_path / f"w{tag}"))
        if tag == "t":
            monkeypatch.setenv("DEVICE", "cpu")
        assert run([]) == 0
    (a,), (b,) = (list((tmp_path / f"o{t}").glob("*.mp4")) for t in "tj")
    assert a.name == b.name and "2m_w-0.600,0.400" in a.name
    _same_videos(a, b)
    import random

    rng = random.Random(1)
    assert generate_blend_weights(2, "0.7,0.3", False, rng) == [0.7, 0.3]
    assert abs(sum(generate_blend_weights(3, "", True, rng)) - 1.0) < 1e-6
    with pytest.raises(ValueError):
        generate_blend_weights(2, "0.9,0.9", False, rng)


_ARGV = {
    "run_videos": ["in.mp4"], "run_styles": [], "drive_videos": [], "style_showcase": [],
    "morph": ["--images", "a.png", "b.png", "--output", "o.mp4"],
    "morph_faces": ["--image", "in.png", "--manual_faces", "1,1,8,8"],
    "morph_v2": ["--image", "in.png", "--output", "o.mp4", "--deeplab_weights", "dl.pth"],
    "morph_slideshow": ["--models", "a:m.pth"],
    "gen_pytorch_only_videos": ["--image", "in.png", "--models", "m.pth", "--output", "o.mp4"],
    "generate_style_selfstyle": ["--input_dir", "in"],
    "style_mask": ["--images", "in.png", "--output", "o.mp4", "--deeplab_weights", "dl.pth",
                   "--fg_model", "m.pth"],
    "generate_mask_samples": ["--deeplab_weights", "dl.pth", "--model", "m.pth"],
    "cryptic_text": ["--input", "in.mp4", "--output", "o.mp4", "--phrases", "HI"],
}


@pytest.mark.parametrize("app", ["run_videos", "run_styles", "drive_videos",
                                 "generate_preset_samples", "generate_video_samples",
                                 "generate_morph_samples", "morph", "morph_faces", "morph_v2",
                                 "morph_slideshow", "gen_pytorch_only_videos",
                                 "generate_style_selfstyle", "style_mask",
                                 "generate_mask_samples", "style_showcase", "cryptic_text"])
def test_apps_without_device_need_cuda(app, tmp_path, monkeypatch):
    """Without ``--device`` / ``DEVICE`` an app asks for the card, and with
    none visible it raises before any work."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no GPU is visible")
    monkeypatch.delenv("DEVICE", raising=False)
    monkeypatch.setenv("IN_DIR", str(tmp_path))
    monkeypatch.setenv("OUT_DIR", str(tmp_path / "out"))
    mod = importlib.import_module(f"neuralstyletransferv1_torch.apps.{app}")
    argv = _ARGV.get(app, ["--db", str(tmp_path / "none.db"), "--input_image", "in.png"])
    with pytest.raises(RuntimeError, match="no CUDA GPU is visible"):
        mod.main(argv)
    assert not (tmp_path / "out").exists() or app != "drive_videos"
    assert os.environ.get("DEVICE") is None
