"""The port's video slice end to end vs the JAX engine, on the CPU.

``make_batched_core`` (stylize → DIS flow → flow EMA → LAB EMA, uint8 in and
out) against the JAX ``_make_batched_core`` on two batches of 4 frames at
128×192, and both CLIs' ``main()`` on a small cv2-written clip. The
``raw_01`` preset keeps the random-weight checkpoint's output inside [0,1],
so the temporal chain sees real values.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from neuralstyletransferv1_tpu import config as nconfig
from neuralstyletransferv1_tpu.engine import pipeline as jpipe
from neuralstyletransferv1_torch.engine import pipeline as tpipe

CKPT = Path(__file__).resolve().parent.parent / "_testdata" / "test_johnson.pth"


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    if not CKPT.exists():
        pytest.skip("synthetic checkpoint missing")
    monkeypatch.setenv("NST_TPU_COMPILE_CACHE", "0")
    # the JAX bf16 engine lowers the global conv precision; restore it after
    monkeypatch.setattr(nconfig, "conv_precision", nconfig.conv_precision)


def _frames(n=8, h=128, w=192, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (rng.random((h, w, 3)) * 120).astype(np.float32)
    out = []
    for t in range(n):
        x, y = xx - 2 * t, yy - t
        tex = 60 * np.sin(0.2 * x + 0.1 * y)[..., None] + 50 * np.cos(0.13 * x - 0.21 * y)[..., None]
        out.append(np.clip(base + 70 + tex, 0, 255).astype(np.uint8))
    return out


def _argv(extra):
    return ["--input_video", "in.mp4", "--output_video", "out.mp4", "--model", str(CKPT),
            "--io_preset", "raw_01", "--frame_batch", "4", "--flow_ema"] + extra


@pytest.mark.parametrize("extra,mae_bound", [
    (["--exact_warp"], 1e-4),                  # f32 parity path; measured 2.5e-6
    (["--compute_dtype", "bfloat16"], 1e-2),   # bf16, u8-corner warp; measured 3.8e-3
])
def test_batched_core_matches_jax(tmp_path, extra, mae_bound):
    imgs = _frames()
    targs = tpipe.build_parser().parse_args(_argv(extra + ["--device", "cpu"]))
    jargs = jpipe.build_arg_parser().parse_args(_argv(extra))
    B, tproc = tpipe.make_batched_core(targs, torch.device("cpu"))
    jB, jproc = jpipe._make_batched_core(jargs, tmp_path)
    assert B == jB == 4
    for b0 in (0, 4):
        ours = tproc(imgs[b0:b0 + 4])
        ref = np.asarray(jproc(imgs[b0:b0 + 4], None, b0))
        assert ours.dtype == torch.uint8 and tuple(ours.shape) == ref.shape == (4, 128, 192, 3)
        d = np.abs(ours.numpy().astype(np.float64) - ref) / 255.0
        assert d.mean() <= mae_bound, (b0, d.mean())
        assert ours.numpy().std() > 1.0  # a real picture, not a constant


def test_two_slot_rgb_blend_matches_jax(tmp_path):
    """Slots A and B (a perturbed copy of the checkpoint) blended 0.3/0.7."""
    sd = torch.load(CKPT, map_location="cpu", weights_only=True)
    g = torch.Generator().manual_seed(7)
    sd = {k: v + 0.05 * v.abs().mean() * torch.randn(v.shape, generator=g) for k, v in sd.items()}
    ckpt_b = tmp_path / "b.pth"
    torch.save(sd, ckpt_b)
    imgs = _frames(4, 64, 96, seed=3)
    argv = ["--input_video", "in.mp4", "--output_video", "out.mp4", "--model", str(CKPT),
            "--model_b", str(ckpt_b), "--blend_models_weights", "0.3,0.7",
            "--io_preset", "raw_01", "--io_preset_b", "raw_01", "--frame_batch", "4"]
    _, tproc = tpipe.make_batched_core(tpipe.build_parser().parse_args(argv + ["--device", "cpu"]),
                                       torch.device("cpu"))
    _, jproc = jpipe._make_batched_core(jpipe.build_arg_parser().parse_args(argv), tmp_path)
    ours = tproc(imgs).numpy().astype(np.float64)
    ref = np.asarray(jproc(imgs, None, 0)).astype(np.float64)
    assert np.abs(ours - ref).mean() / 255.0 <= 1e-4


def test_partial_final_batch_pads_with_last_frame():
    imgs = _frames(6)
    args = tpipe.build_parser().parse_args(_argv(["--device", "cpu"]))
    B, proc = tpipe.make_batched_core(args, torch.device("cpu"))
    proc(imgs[:4])
    out = proc(imgs[4:])
    assert tuple(out.shape) == (4, 128, 192, 3)


def _read(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            return frames
        frames.append(fr.astype(np.float64))


def test_cli_main_matches_jax(tmp_path):
    """The same argv through both engines' main() on a 6-frame clip (two
    batches of 4, the second padded)."""
    cv2 = pytest.importorskip("cv2")
    vid = tmp_path / "in.mp4"
    vw = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"mp4v"), 8, (96, 64))
    for fr in _frames(6, 64, 96, seed=1):
        vw.write(fr[..., ::-1])
    vw.release()

    def argv(out, wd):
        return ["--input_video", str(vid), "--output_video", str(out), "--model", str(CKPT),
                "--io_preset", "raw_01", "--flow_ema", "--motion_blend", "--blend", "0.9",
                "--frame_batch", "4", "--exact_warp", "--fps", "8", "--work_dir", str(wd)]

    a, b = tmp_path / "torch.mp4", tmp_path / "jax.mp4"
    assert tpipe.main(argv(a, tmp_path / "_wt") + ["--device", "cpu"]) == 0
    assert jpipe.main(argv(b, tmp_path / "_wj")) == 0
    fa, fb = _read(a), _read(b)
    assert len(fa) == len(fb) == 6
    for x, y in zip(fa, fb):
        # grey levels. Measured 0.57: the uint8 frames handed to the encoder
        # differ by 4e-4 on average, and the lossy mp4 encode spreads that.
        assert np.abs(x - y).mean() < 1.5


def test_unported_flags_raise(tmp_path, capsys):
    """No flag of the JAX engine is refused any more. The last one,
    ``--profile_dir``, runs: the single-image mode writes a
    ``torch.profiler`` trace into the directory and prints the JAX
    engine's line; --mesh_devices runs (tests/test_torch_mesh.py): on the
    CPU the mesh takes as many shards as asked and rounds the batch up."""
    from PIL import Image

    args = tpipe.build_parser().parse_args(
        _argv(["--device", "cpu"]) + ["--mesh_devices", "2", "--frame_batch", "3"])
    assert len(tpipe.engine_mesh(args, torch.device("cpu"))) == 2 and args.frame_batch == 4
    src, out, prof = tmp_path / "a.png", tmp_path / "b.png", tmp_path / "prof"
    Image.fromarray((np.random.default_rng(0).random((24, 32, 3)) * 255).astype(np.uint8)
                    ).save(src)
    assert tpipe.main(["--input_image", str(src), "--output_image", str(out), "--model",
                       str(CKPT), "--profile_dir", str(prof), "--device", "cpu",
                       "--work_dir", str(tmp_path / "_w")]) == 0
    assert out.exists() and list(prof.glob("*.pt.trace.json"))
    assert f"[profile] trace written to {prof}" in capsys.readouterr().out
