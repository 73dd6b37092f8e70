"""The port's threaded frame loader (``io/native_loader.py`` +
``csrc/frameloader.cpp``) against the JAX package's ``NativeFrameLoader``,
and the batched video path that reads through it.

- Each file kind (8-bit RGB, RGBA, grey, palette and 16-bit PNG; baseline,
  progressive, grey and truncated JPEG; a BMP under a ``.png`` name, which
  the native decoders refuse and PIL reads) decodes bit for bit as JAX's
  loader decodes it, at several thread and capacity counts and with more
  frames than the capacity. The 8-bit PNGs also equal PIL's
  ``convert("RGB")``, the 16-bit PNG its high bytes.
- The build lands in ``_build/`` under a hashed name, builds started at
  once by two processes both succeed, and a built library is reused
  without the compiler.
- ``style_frames_batched`` of the port against the JAX engine's on JPEG
  frames, both loaders active, in f32: the per-frame gate of the PNG
  comparisons (``tests/test_torch_per_frame.py``: within 1 level at
  ≥ 99% of the values, ≤ 0.01 levels on average).
- Without a compiler the engine prints JAX's fallback line and reads the
  frames with PIL; on PNG frames its output equals the loader's bit for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from neuralstyletransferv1_torch.io import native_loader as tnl

CKPT = Path(__file__).resolve().parent.parent / "_testdata" / "test_johnson.pth"
ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file (the six-worker tier-1 run shares
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_loader():
    from neuralstyletransferv1_tpu.io import native_loader as jnl

    assert jnl.available(), "the JAX loader needs g++, libjpeg and libpng"
    return jnl.NativeFrameLoader


def _img(h, w, seed, c=3):
    return (np.random.default_rng(seed).random((h, w, c)) * 255).astype(np.uint8)


def _write(kind, path_stem: Path, seed: int, h=24, w=40) -> tuple[Path, np.ndarray | None]:
    """A file of ``kind`` and the RGB frame PIL (or the 16-bit high bytes)
    says it holds, None where PIL cannot read it."""
    import cv2

    if kind == "rgb_png":
        a = _img(h, w, seed)
        p = path_stem.with_suffix(".png")
        Image.fromarray(a).save(p)
        return p, a
    if kind == "rgba_png":
        p = path_stem.with_suffix(".png")
        Image.fromarray(_img(h, w, seed, 4), "RGBA").save(p)
    elif kind == "grey_png":
        p = path_stem.with_suffix(".png")
        Image.fromarray(_img(h, w, seed)[..., 0], "L").save(p)
    elif kind == "palette_png":
        p = path_stem.with_suffix(".png")
        Image.fromarray(_img(h, w, seed)).quantize(colors=16).save(p)
    elif kind == "png16":
        p = path_stem.with_suffix(".png")
        a16 = np.random.default_rng(seed).integers(0, 65536, (h, w, 3), dtype=np.uint16)
        cv2.imwrite(str(p), a16[..., ::-1])
        return p, (a16 >> 8).astype(np.uint8)
    elif kind in ("jpeg", "jpeg_progressive", "jpeg_grey", "jpeg_truncated"):
        p = path_stem.with_suffix(".jpg")
        im = Image.fromarray(_img(h, w, seed))
        if kind == "jpeg_grey":
            im = im.convert("L")
        im.save(p, quality=90, progressive=kind == "jpeg_progressive")
        if kind == "jpeg_truncated":
            p.write_bytes(p.read_bytes()[: len(p.read_bytes()) * 2 // 3])
            return p, None
    elif kind == "bmp_as_png":
        p = path_stem.with_suffix(".png")
        Image.fromarray(_img(h, w, seed)).save(p, format="BMP")
    else:
        raise ValueError(kind)
    return p, np.asarray(Image.open(p).convert("RGB"))


KINDS = ["rgb_png", "rgba_png", "grey_png", "palette_png", "png16", "jpeg",
         "jpeg_progressive", "jpeg_grey", "jpeg_truncated", "bmp_as_png"]


@pytest.mark.parametrize("threads,capacity", [(1, 1), (3, 4), (6, 2)])
@pytest.mark.parametrize("kind", KINDS)
def test_loader_matches_jax_bit_for_bit(tmp_path, jax_loader, kind, threads, capacity):
    """Nine frames of ``kind`` (more than the capacity), of three sizes,
    through both loaders; PNGs also against PIL, JPEGs within 1 level of
    it (the system libjpeg against PIL's libjpeg-turbo)."""
    files, pil = [], []
    for i in range(9):
        p, want = _write(kind, tmp_path / f"frame_{i:04d}", seed=i, h=24 + i % 3, w=40)
        files.append(p)
        pil.append(want)
    with tnl.NativeFrameLoader(files, threads=threads, capacity=capacity) as ld:
        got = list(ld)
    with jax_loader(files, threads=threads, capacity=capacity) as ld:
        want = list(ld)
    assert len(got) == len(want) == 9
    for g, w, p in zip(got, want, pil):
        assert g.dtype == np.uint8 and g.shape == w.shape == (w.shape[0], 40, 3)
        np.testing.assert_array_equal(g, w)
        if p is None:
            continue
        if kind.startswith("jpeg"):
            assert np.abs(g.astype(int) - p.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(g, p)


def test_truncated_png_fails_in_both(tmp_path, jax_loader):
    """A PNG cut short: both native decoders refuse it, and PIL, which then
    reads it, raises in both loaders."""
    p, _ = _write("rgb_png", tmp_path / "frame_0001", 0)
    p.write_bytes(p.read_bytes()[:200])
    for loader in (tnl.NativeFrameLoader, jax_loader):
        with loader([p]) as ld, pytest.raises(OSError):
            next(ld)


_BUILD = """
import sys
from pathlib import Path
sys.path.insert(0, {root!r})
from neuralstyletransferv1_torch.io import native_loader as nl
nl.BUILD_DIR = Path(sys.argv[1])
print(nl.build()[0])
"""


def test_build_in_build_dir_concurrent_and_reused(tmp_path, monkeypatch):
    """Two processes build into one empty directory at once: both succeed,
    on one file, with no temporary left; a third call reuses it without the
    compiler. The default target is the package's ``_build/``, never
    ``native/``."""
    assert tnl.target().parent == ROOT / "neuralstyletransferv1_torch" / "_build"
    assert tnl.target().name.startswith("libframeloader_")
    code = _BUILD.format(root=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "b")],
                              stdout=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0] == outs[1] and Path(outs[0]).exists()
    assert sorted(os.listdir(tmp_path / "b")) == [Path(outs[0]).name]
    monkeypatch.setattr(tnl, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(tnl, "CXX", "g++")
    monkeypatch.setattr(tnl.shutil, "which", lambda name: None)  # no compiler from here
    assert tnl.build() == (Path(outs[0]), "")


def _jpeg_frames(d: Path, n=6, h=64, w=96):
    d.mkdir(parents=True)
    rng = np.random.default_rng(3)
    base = (rng.random((h, w, 3)) * 120).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for t in range(n):
        tex = 60 * np.sin(0.2 * (xx - 2 * t) + 0.1 * (yy - t))[..., None]
        Image.fromarray(np.clip(base + 70 + tex, 0, 255).astype(np.uint8)).save(
            d / f"frame_{t + 1:04d}.jpg", quality=90)
    return d


def _args(parser, extra=()):
    return parser.parse_args(["--input_video", "in.mp4", "--output_video", "out.mp4",
                              "--model", str(CKPT), "--io_preset", "raw_01", "--frame_batch",
                              "4", *extra])


def _styled(d: Path):
    return [np.asarray(Image.open(p), np.int32) for p in sorted(d.glob("styled_frame_*.png"))]


def test_batched_path_matches_jax_on_jpeg_frames(tmp_path, capsys):
    """``style_frames_batched`` over six JPEG frames (two batches, the
    second padded) with flow EMA, f32, in both engines, each reading
    through its native loader."""
    from neuralstyletransferv1_tpu.engine import pipeline as jpipe
    from neuralstyletransferv1_torch.engine import pipeline as tpipe

    import shutil

    td = _jpeg_frames(tmp_path / "t")
    jd = tmp_path / "j"
    shutil.copytree(td, jd)
    extra = ["--flow_ema", "--exact_warp"]
    assert tpipe.style_frames_batched(_args(tpipe.build_parser(), extra + ["--device", "cpu"]),
                                      td, False, {}, CPU) == (6, 6)
    assert "[batch] native frame loader active (6 frames)" in capsys.readouterr().out
    assert jpipe.style_frames_batched(_args(jpipe.build_arg_parser(), extra), jd, False,
                                      {}) == (6, 6)
    assert "[batch] native frame loader active (6 frames)" in capsys.readouterr().out
    got, want = _styled(td), _styled(jd)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        d = np.abs(a - b)
        assert (d <= 1).mean() >= 0.99 and d.mean() <= 0.01, ((d <= 1).mean(), d.mean())
        assert a.std() > 1.0


def test_fallback_without_compiler(tmp_path, capsys, monkeypatch):
    """No compiler (and nothing built in the build directory): the engine
    prints JAX's fallback line, reads the frames with PIL, and on PNG frames
    writes what the loader's run writes, bit for bit."""
    from neuralstyletransferv1_torch.engine import pipeline as tpipe

    frames = {}
    for tag in ("native", "pil"):
        d = tmp_path / tag
        d.mkdir()
        for i in range(5):
            Image.fromarray(_img(32, 48, i)).save(d / f"frame_{i + 1:04d}.png")
        frames[tag] = d
    args = _args(tpipe.build_parser(), ["--device", "cpu"])
    assert tpipe.style_frames_batched(args, frames["native"], False, {}, CPU) == (5, 5)
    assert "[batch] native frame loader active (5 frames)" in capsys.readouterr().out
    monkeypatch.setattr(tnl, "BUILD_DIR", tmp_path / "empty_build")
    monkeypatch.setattr(tnl, "CXX", "no-such-compiler")
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_error", None)
    assert not tnl.available()
    args = _args(tpipe.build_parser(), ["--device", "cpu"])
    assert tpipe.style_frames_batched(args, frames["pil"], False, {}, CPU) == (5, 5)
    out = capsys.readouterr().out
    assert ("[batch] native frame loader unavailable (no-such-compiler not found); using PIL"
            in out)
    a, b = _styled(frames["native"]), _styled(frames["pil"])
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
