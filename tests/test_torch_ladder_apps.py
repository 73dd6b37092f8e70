"""The port's weight-ladder apps and ``slow_nst`` end to end on the CPU
(``--device cpu``): the twins of ``tests/test_apps_smoke.py``'s
``style_all_weights``, ``style_video_pipeline``, ``multi_model_video`` and
``style_morph`` cases, with the composed frames held against the JAX apps'.

Tolerances: ``multi_model_video``'s frames equal JAX's under the same
``--walk_seed`` (host numpy and OpenCV in both); ``style_morph``'s
``compose_frames`` within 1 level of JAX's on ≥ 99% of the pixels (f32 sines
in torch and XLA, then a truncating uint8 cast).
"""

import json
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


def _write_img(path, w=96, h=64, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(path)


def _write_video(path, n=4, w=96, h=64, fps=8):
    import cv2

    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    base = (np.random.default_rng(0).random((h, w, 3)) * 255).astype(np.uint8)
    for t in range(n):
        vw.write(np.roll(base, t * 2, axis=1))
    vw.release()


def _frame_count(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def _ladder_dir(tmp_path, rungs=("candy_style1e9", "candy_style5e9")):
    wdir = tmp_path / "weights"
    wdir.mkdir()
    for r in rungs:
        shutil.copy(CKPT, wdir / f"{r}.pth")
    return wdir


class _Capture:
    """A ``cv2.VideoWriter`` stand-in that keeps the frames it is given."""

    frames: list = []

    def __init__(self, *a, **k):
        _Capture.frames = []

    def isOpened(self):
        return True

    def write(self, f):
        _Capture.frames.append(np.array(f))

    def release(self):
        pass


def test_style_all_weights(tmp_path):
    """One output per frame and rung, each the port pipeline's image mode
    output for that rung; a second run skips both rungs."""
    from neuralstyletransferv1_torch.apps.style_all_weights import main

    frames = tmp_path / "frames"
    frames.mkdir()
    for i in (1, 2):
        _write_img(frames / f"frame_{i:04d}.png", seed=i)
    wdir = _ladder_dir(tmp_path)
    out_root = tmp_path / "styled"
    argv = ["--frames_dir", str(frames), "--weights_dir", str(wdir), "--out_root",
            str(out_root), "--io_preset", "raw_255", "--frame_batch", "2", "--work_dir",
            str(tmp_path / "w"), "--device", "cpu"]
    assert main(argv) == 0
    for rung in ("candy_style1e9", "candy_style5e9"):
        outs = sorted((out_root / rung).glob("*.png")) + sorted((out_root / rung).glob("*.jpg"))
        assert len(outs) == 2, (rung, outs)
    stamp = {p: p.stat().st_mtime_ns for p in out_root.rglob("*.png")}
    assert main(argv) == 0
    assert {p: p.stat().st_mtime_ns for p in out_root.rglob("*.png")} == stamp
    assert main(argv + ["--pattern", "*.none"]) == 2


def test_style_all_weights_without_device_needs_cuda(monkeypatch, tmp_path):
    from neuralstyletransferv1_torch.apps.style_all_weights import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(["--frames_dir", str(tmp_path), "--weights_dir", str(tmp_path), "--out_root",
              str(tmp_path / "o")])


def test_style_video_pipeline(tmp_path):
    """extract → ladder-style → walk_{family}.json."""
    from neuralstyletransferv1_torch.apps.style_video_pipeline import create_walk_file, main

    vid = tmp_path / "in.mp4"
    _write_video(vid, n=3)
    wdir = _ladder_dir(tmp_path)
    out = tmp_path / "out"
    assert main(["--video", str(vid), "--output_dir", str(out), "--weights_dir", str(wdir),
                 "--fps", "4", "--scale", "64", "--io_preset", "raw_255", "--frame_batch", "2",
                 "--work_dir", str(tmp_path / "w"), "--device", "cpu"]) == 0
    plan = json.loads((out / "walk_candy.json").read_text())
    assert plan["weights"] == ["candy_style1e9", "candy_style5e9"]
    assert len(plan["walk"]) == plan["frame_end"] - plan["frame_start"] + 1
    assert set(plan["walk"]) <= {0, 1}
    n = len(list((out / "frames").glob("frame_*.png")))
    for rung in plan["weights"]:
        assert len(list((out / "styled" / rung).glob("*.png"))) == n > 0
    one = json.loads(create_walk_file(tmp_path, "solo", ["a"], 1, 5).read_text())
    assert one["walk"] == [0] * 5


def test_multi_model_video_frames_equal_jax(tmp_path, monkeypatch):
    """The composed frames (the weight walk, the pulses, the saturation)
    equal the JAX app's under the same ``--walk_seed``; the real run writes
    its video and run log."""
    import cv2

    from neuralstyletransferv1_torch.apps import multi_model_video as tmmv
    from neuralstyletransferv1_tpu.apps import multi_model_video as jmmv

    base, pulse = tmp_path / "base", tmp_path / "pulse"
    for d, sufs in ((base, ("original", "candy", "mosaic")), (pulse, ("original", "udnie",
                                                                      "wave"))):
        d.mkdir()
        for i, name in enumerate(("img1", "img2")):
            for j, suffix in enumerate(sufs):
                _write_img(d / f"{name}_{suffix}.png", seed=10 * i + j + (5 if d == pulse else 0))
    out = tmp_path / "mmv.mp4"
    argv = ["--base_dir", str(base), "--base_weights", "candy,mosaic", "--pulse_dirs",
            str(pulse), "--pulse_weights", "udnie,wave", "--output", str(out), "--fps", "8",
            "--hold_frames", "3", "--walk_seed", "5"]
    with monkeypatch.context() as m:
        m.setattr(cv2, "VideoWriter", _Capture)
        assert jmmv.main(argv) == 0
        want = _Capture.frames
        assert tmmv.main(argv) == 0
        got = _Capture.frames
    assert len(got) == len(want) == 6
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert tmmv.main(argv) == 0
    assert out.exists() and _frame_count(out) == 6
    log = json.loads((tmp_path / "mmv_run.json").read_text())
    assert log["total_frames"] == 6 and log["base_weights"] == ["candy", "mosaic"]


def _ladders(seed, hw=(24, 32)):
    rng = np.random.default_rng(seed)
    return {"candy": (rng.random((3,) + hw + (3,)) * 255).astype(np.float32),
            "mosaic": (rng.random((8,) + hw + (3,)) * 255).astype(np.float32)}


@pytest.mark.parametrize("with_orig", [False, True])
def test_style_morph_compose_frames_matches_jax(with_orig):
    from neuralstyletransferv1_torch.apps import style_morph as tsm
    from neuralstyletransferv1_tpu.apps import style_morph as jsm

    ladders = _ladders(0)
    orig = (np.random.default_rng(1).random((24, 32, 3)) * 255).astype(np.float32) \
        if with_orig else None
    want = jsm.compose_frames(ladders, orig, 20, 0.08, seed_phase=0.37)
    got = tsm.compose_frames(ladders, orig, 20, 0.08, seed_phase=0.37, chunk=7)
    assert len(got) == len(want) == 20 and got[0].dtype == np.uint8
    d = np.abs(np.stack(got).astype(np.int16) - np.stack(want).astype(np.int16))
    assert d.max() <= 1 and (d == 0).mean() >= 0.99


def test_style_morph_video(tmp_path):
    """A ladder-interpolation video from pre-styled rung stills."""
    from neuralstyletransferv1_torch.apps.style_morph import main

    styled = tmp_path / "styled"
    styled.mkdir()
    for i, name in enumerate(("img1", "img2", "img3")):
        for j, rung in enumerate(("candy", "candy_style1e9", "candy_style5e9")):
            _write_img(styled / f"{name}_{rung}.png", seed=10 * i + j)
    out = tmp_path / "morph.mp4"
    assert main(["--styled_dir", str(styled), "--output", str(out), "--families", "candy",
                 "--frame_seconds", "0.5", "--fps", "4", "--device", "cpu"]) == 0
    # two images after --skip_first, 2 frames each, a 2-frame crossfade
    assert out.exists() and _frame_count(out) == 2


def test_slow_nst_main_writes_its_png(tmp_path):
    """``slow_nst.main --steps 3 --size 48`` (the ``tests/test_apps_smoke.py``
    size) on the CPU."""
    from PIL import Image

    from neuralstyletransferv1_torch.apps import slow_nst

    _write_img(tmp_path / "c.png", seed=1)
    _write_img(tmp_path / "s.png", w=40, h=40, seed=2)
    out = tmp_path / "nst.png"
    assert slow_nst.main(["--content", str(tmp_path / "c.png"), "--style",
                          str(tmp_path / "s.png"), "--output", str(out), "--steps", "3",
                          "--size", "48", "--init_from", "random", "--device", "cpu"]) == 0
    assert Image.open(out).size == (48, 32)
