"""The port's magenta self-style apps (``apps/selfstyle_blob.py``,
``batch_selfstyle.py``, ``generate_magenta_self_style.py``) on the CPU
(``--device cpu``): ``self_style_variants`` and ``blob_morph_frames``
against the JAX apps' on the same compact CIN weights (a
``magenta.init``-layout tree, given to JAX as its ``magenta.init`` draw
and to the port by ``magenta_tree=``), and
the three CLIs end to end with ``monkeypatch.chdir`` keeping the relative
``models/magenta`` root empty, as the JAX tests do.

Tolerance: the variants and the blob frames, as the apps' uint8 images,
within 1 level of JAX's on ≥ 99% of the pixels (f32 convs and sines in
another order, then a truncating cast).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from neuralstyletransferv1_torch.apps import selfstyle_blob as tsb
from neuralstyletransferv1_torch.models import magenta as tm
from neuralstyletransferv1_tpu.apps import selfstyle_blob as jsb
from neuralstyletransferv1_tpu.models import magenta as jm


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


@pytest.fixture
def tree(monkeypatch):
    """A ``magenta.init``-layout tree from the port's numpy draw
    (``magenta.init_tree(0)``), which the JAX app gets as its
    ``magenta.init`` result; the JAX app's eager ``stylize_tiled`` runs
    jitted (the same function, one compile a tile size)."""
    t = tm.init_tree(0)
    monkeypatch.setattr(jm, "init", lambda key: jax.tree.map(jnp.asarray, t))
    monkeypatch.setattr(jm, "stylize_tiled", jax.jit(
        jm.stylize_tiled, static_argnames=("tile_size", "overlap", "transfer_fn",
                                           "compute_dtype")))
    return t


def _img(h, w, seed):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


def _u8(x):
    return (np.clip(np.asarray(x), 0, 1) * 255).astype(np.uint8)


def _close(got, want):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return d.max() <= 1 and (d == 0).mean() >= 0.99


def test_self_style_variants_match_jax(tree, tmp_path):
    """Tile configs 32/8 and 48/8 on a 56×72 image (96/16 does not fit
    and is skipped, as in JAX); no SavedModel under the root."""
    content = _img(56, 72, 1)
    configs = [(32, 8), (96, 16), (48, 8)]
    root = tmp_path / "no_magenta"
    want = np.asarray(jsb.self_style_variants(content, configs, seed=0, magenta_root=root))
    got = tsb.self_style_variants(content, configs, magenta_root=root, magenta_tree=tree)
    assert got.shape == want.shape == (2, 56, 72, 3) and got.dtype == torch.float32
    assert _close(_u8(got), _u8(want))
    assert float(got.std()) > 1e-2
    none_fit = tsb.self_style_variants(content, [(96, 16)], magenta_root=root, magenta_tree=tree)
    assert torch.equal(none_fit, torch.from_numpy(content)[None])


def test_self_style_variants_from_a_seed(tmp_path):
    """Without a tree the compact net comes from ``magenta.init_tree(seed)``:
    the same seed, the same variants."""
    content = _img(40, 40, 2)
    a, b = (tsb.self_style_variants(content, [(32, 8)], seed=3, magenta_root=tmp_path)
            for _ in range(2))
    c = tsb.self_style_variants(content, [(32, 8)], seed=4, magenta_root=tmp_path)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("n_blobs", [1, 3])
def test_blob_morph_frames_match_jax(n_blobs):
    variants = np.stack([_img(40, 56, s) for s in (3, 4)])
    base = _img(40, 56, 5)
    want = jsb.blob_morph_frames(variants, base, 9, 4, n_blobs=n_blobs)
    got = tsb.blob_morph_frames(torch.from_numpy(variants), base, 9, 4, n_blobs=n_blobs,
                                chunk=4)
    assert len(got) == len(want) == 9 and got[0].dtype == np.uint8
    assert _close(np.stack(got), np.stack(want))


def _frame_count(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def _write(path, h, w, seed):
    Image.fromarray(_u8(_img(h, w, seed))).save(path)


def test_batch_selfstyle(tmp_path, monkeypatch):
    """One PNG per image and fitting config; a rerun skips the image."""
    from neuralstyletransferv1_torch.apps.batch_selfstyle import main

    monkeypatch.chdir(tmp_path)
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    _write(in_dir / "a.png", 64, 64, 6)
    _write(in_dir / "b.jpg", 36, 40, 7)  # 48 does not fit
    out_dir = tmp_path / "out"
    argv = ["--input_dir", str(in_dir), "--output_dir", str(out_dir), "--size", "64",
            "--tile_configs", "32:8,48:8", "--device", "cpu"]
    assert main(argv) == 0
    assert sorted(p.name for p in out_dir.iterdir()) == ["a_t32o8.png", "a_t48o8.png",
                                                         "b_t32o8.png"]
    stamp = (out_dir / "a_t32o8.png").stat().st_mtime_ns
    assert main(argv) == 0
    assert (out_dir / "a_t32o8.png").stat().st_mtime_ns == stamp


def test_generate_magenta_self_style(tmp_path, monkeypatch):
    """``--count`` images picked by ``--seed`` from the sorted pool, each
    self-styled and blended, written as ``selfstyle_<stem>.jpg``."""
    import random

    from neuralstyletransferv1_torch.apps.generate_magenta_self_style import main

    monkeypatch.chdir(tmp_path)
    pool = tmp_path / "pool"
    pool.mkdir()
    for i in range(4):
        _write(pool / f"p{i}.png", 48, 64, 10 + i)
    out = tmp_path / "out"
    assert main(["--input_dir", str(pool), "--output_dir", str(out), "--count", "2",
                 "--seed", "3", "--scale", "48", "--magenta_tile", "32",
                 "--magenta_overlap", "8", "--device", "cpu"]) == 0
    random.seed(3)
    picks = random.sample(sorted(pool.glob("*.png")), 2)
    assert sorted(p.name for p in out.iterdir()) == sorted(f"selfstyle_{p.stem}.jpg"
                                                           for p in picks)
    assert Image.open(out / f"selfstyle_{picks[0].stem}.jpg").size == (48, 36)


def test_selfstyle_blob(tmp_path, monkeypatch):
    """Self-style variants + drifting blob morph video at 64²."""
    from neuralstyletransferv1_torch.apps.selfstyle_blob import main

    monkeypatch.chdir(tmp_path)
    img = tmp_path / "img.png"
    _write(img, 64, 64, 8)
    out = tmp_path / "blob.mp4"
    assert main(["--image", str(img), "--output", str(out), "--size", "64", "--seconds", "0.5",
                 "--fps", "4", "--blobs", "1", "--tile_configs", "32:8,32:16",
                 "--device", "cpu"]) == 0
    assert out.exists() and _frame_count(out) == 2


def test_self_style_apps_without_device_need_cuda(monkeypatch, tmp_path):
    from neuralstyletransferv1_torch.apps import batch_selfstyle, generate_magenta_self_style

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((tsb.main, ["--image", "a.png", "--output", "b.mp4"]),
                       (batch_selfstyle.main, ["--input_dir", str(tmp_path), "--output_dir",
                                               str(tmp_path / "o")]),
                       (generate_magenta_self_style.main, ["--input_dir", str(tmp_path),
                                                           "--output_dir",
                                                           str(tmp_path / "o")])):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            main(argv)
    assert not Path(tmp_path / "o").exists()
