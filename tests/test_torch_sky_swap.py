"""The masked-stylize step (``engine/masked_stylize.py``) and the sky-swap
tools (``apps/sky_swap.py``, ``apps/run_sky_swap.py``) of the port, held
against the JAX package on the CPU.

DeepLab runs at narrow widths from a seeded reference-format state dict
(``deeplab.init_state_dict``, running statistics perturbed), written as a
``.pth.tar`` with a ``state_dict`` wrapper and ``module.`` prefixes where a
tool loads it; the style slot is ``_testdata/test_johnson.pth`` under
``raw_01``. Masks are held by agreement share: random-weight logits tie
more often than trained ones, and the two sides' bf16 resizes differ by
rounding. ``pipeline.main`` is replaced by a recorder in both packages
where the workflow is compared (the port's ``--mask_dir`` pipeline is held
against JAX in ``test_torch_region.py``). The ``cuda`` case imports no JAX.
"""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from neuralstyletransferv1_torch.apps import run_sky_swap as trun
from neuralstyletransferv1_torch.apps import sky_swap as tss
from neuralstyletransferv1_torch.engine import masked_stylize as tms
from neuralstyletransferv1_torch.engine import stylizer as tst
from neuralstyletransferv1_torch.models import deeplab as tdl
from neuralstyletransferv1_torch.ops.resize import resize_bilinear

REPO = Path(__file__).resolve().parent.parent
JOHNSON = REPO / "_testdata" / "test_johnson.pth"
WIDTH = 0.125
H, W = 64, 96
INFER = 65


def _state_dict(backbone="resnet", num_classes=21, seed=0, width=WIDTH):
    sd = tdl.init_state_dict(backbone, num_classes, seed=seed, width=width)
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = v + torch.randn(v.shape, generator=g) * 0.1
        elif k.endswith("running_var"):
            sd[k] = v * (torch.rand(v.shape, generator=g) * 0.5 + 0.75)
    return sd


def _smooth(b, h, w, phase=0.0):
    """Smooth [0,1] NHWC content (argmax margins behave like images')."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    x = np.stack([np.sin(xx / 9 + phase) * np.cos(yy / 7), np.cos(xx / 13 - phase),
                  np.sin((xx + yy) / 11 + 2 * phase)], -1)
    return np.repeat((x * 0.4 + 0.5)[None], b, 0).astype(np.float32)


@pytest.fixture(scope="module")
def jx():
    """The JAX modules, imported here so the ``cuda`` case needs no JAX."""
    import jax
    import jax.numpy as jnp

    from neuralstyletransferv1_tpu.apps import run_sky_swap as jrun
    from neuralstyletransferv1_tpu.apps import sky_swap as jss
    from neuralstyletransferv1_tpu.engine import masked_stylize as jms
    from neuralstyletransferv1_tpu.engine import stylizer as jst
    from neuralstyletransferv1_tpu.models import deeplab as jdl
    from neuralstyletransferv1_tpu.models import transformer_net_s2d2 as s2d
    from neuralstyletransferv1_tpu.ops import resize as jresize

    class J:
        pass

    j = J()
    j.jax, j.jnp, j.jrun, j.jss, j.jms, j.jst, j.jdl, j.s2d, j.jresize = (
        jax, jnp, jrun, jss, jms, jst, jdl, s2d, jresize)
    return j


@pytest.fixture(scope="module")
def two_class():
    """A 2-class ResNet DeepLab (the mask is then a balanced argmax) in both
    packages, and the Johnson slot in both."""
    sd = _state_dict("resnet", num_classes=2)
    state, nc = tdl.import_deeplab(sd)
    assert nc == 2
    return sd, tdl.DeepLab(state).eval(), tst.load_model(JOHNSON, io_preset="raw_01")


@pytest.fixture(scope="module")
def jax_step_parts(jx, two_class):
    sd = two_class[0]
    tree, _ = jx.jdl.import_deeplab({k: v.numpy() for k, v in sd.items()})
    jm = jx.jst.load_model(JOHNSON, io_preset="raw_01")
    bp = jx.s2d.bake_io_affine(jx.s2d.from_johnson_params(jm.params), "raw_01")
    bp = jx.jax.tree.map(lambda a: a.astype(jx.jnp.bfloat16), bp)
    return tree, bp


def _port_alpha(net, x01, dt):
    """The port step's alpha before its upsample."""
    small = resize_bilinear(x01.to(dt).float(), (INFER, INFER)).to(dt)
    with torch.no_grad():
        logits = tms.cast_params(net, dt)(small * 2.0 - 1.0)
    return (logits.argmax(-1) != 0).cpu().numpy()


# ---------------------------------------------------------------------------
# the parameter cast and the masked step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backbone", ["resnet", "mobilenet", "xception", "drn"])
def test_cast_params_f32_leaves_match_jax(jx, backbone):
    """Queue 3, parameter cast: the port casts by module type (convs and the
    classifier's bias to bf16, every BN leaf f32), JAX by key name; the same
    leaves stay f32 on both sides, leaf for leaf."""
    sd = _state_dict(backbone)
    tree, _ = jx.jdl.import_deeplab({k: v.numpy() for k, v in sd.items()}, backbone=backbone)
    cast = jx.jms.cast_params(tree, jx.jnp.bfloat16)
    paths = jx.jax.tree_util.tree_flatten_with_path(cast)[0]
    jax_f32 = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
               for path, leaf in paths if leaf.dtype == jx.jnp.float32}
    net = tms.cast_params(tdl.DeepLab(tdl.import_deeplab(sd, backbone=backbone)[0], backbone=backbone),
                          torch.bfloat16)
    port = dict(net.state_dict())
    port_f32 = {k for k, v in port.items() if v.dtype == torch.float32}
    assert port_f32 == jax_f32
    assert {k for k, v in port.items() if v.dtype == torch.bfloat16} == set(port) - port_f32
    assert "decoder.cls.b" in set(port) - port_f32
    assert not any(k.endswith(".bias") for k in set(port) - port_f32)


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_masked_step_matches_jax(jx, two_class, jax_step_parts, dt):
    """The whole step vs JAX's on 2 smooth frames at 64×96, ``infer_res`` 65:
    composite MAE ≤ 1e-2, the pre-upsample alpha ≥ 99% equal (and mixed:
    both classes present)."""
    _, net, slot = two_class
    tree, bp = jax_step_parts
    tdt, jdt = getattr(torch, dt), getattr(jx.jnp, dt)
    x = _smooth(2, H, W)
    step = tms.make_masked_stylize_step(net, slot, (H, W), infer_res=INFER, compute_dtype=tdt)
    got = step(torch.from_numpy(x)).numpy()
    jstep = jx.jms.make_masked_stylize_step(tree, bp, (H, W), infer_res=INFER, compute_dtype=jdt)

    def jalpha(xj):  # the JAX step's alpha before its upsample (XLA shares the forward)
        small = jx.jresize.resize_bilinear(xj.astype(jdt), (INFER, INFER))
        return jx.jnp.argmax(jx.jdl.apply(jx.jms.cast_params(tree, jdt), small * 2.0 - 1.0), -1) != 0

    want, ja = (np.asarray(a) for a in jx.jax.jit(lambda xj: (jstep(xj), jalpha(xj)))(jx.jnp.asarray(x)))
    assert got.shape == want.shape == (2, H, W, 3)
    assert np.abs(got - want).mean() <= 1e-2
    pa = _port_alpha(net, torch.from_numpy(x), tdt)
    assert (pa == ja).mean() >= 0.99
    assert 0 < pa.mean() < 1, pa.mean()


@pytest.mark.parametrize("keep_fg", [True, False])
def test_masked_step_composite_math(two_class, keep_fg):
    """Given the step's own mask, the output is styled·alpha + x·(1 − alpha)
    within 5e-4 (f32 composite), alpha flipped under ``keep_fg=False``."""
    _, net, slot = two_class
    x = torch.from_numpy(np.random.default_rng(3).random((1, H, W, 3), dtype=np.float32))
    step = tms.make_masked_stylize_step(net, slot, (H, W), infer_res=INFER,
                                        compute_dtype=torch.float32, keep_fg=keep_fg)
    got = step(x)
    alpha = torch.from_numpy(_port_alpha(net, x, torch.float32)).float()[..., None]
    alpha = resize_bilinear(alpha, (H, W))
    styled = tst.jit_stylizer(slot, dtype=torch.bfloat16)(x).clamp(0, 1)
    if not keep_fg:
        alpha = 1 - alpha
    torch.testing.assert_close(got, styled * alpha + x * (1 - alpha), atol=5e-4, rtol=0)


# ---------------------------------------------------------------------------
# sky_swap: the mask cleanup, the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("expand,contract,feather,close", [(2, 1, 3, 5), (0, 0, 3, 5), (3, 0, 0, 0),
                                                           (0, 2, 5, 3), (1, 1, 1, 5)])
def test_mask_postprocess_matches_jax(jx, expand, contract, feather, close):
    """Close → dilate → erode → feather → clip → truncating uint8 vs JAX:
    never more than 1 level apart, and equal on ≥ 99.9% of the pixels whose
    JAX feathered value lies more than 1e-3 from an integer. Where it lies
    closer (a flat 0 or 255 area: 255·Σk² is 255 ± a few f32 ulp, on
    either side by the kernel's and the accumulation's rounding), the
    truncation turns ulp differences into a level."""
    from neuralstyletransferv1_tpu.ops import blur as jblur
    from neuralstyletransferv1_tpu.ops import morphology as jmorph

    rng = np.random.default_rng(expand * 7 + feather)
    field = _smooth(1, 72, 90, 0.1 * feather)[0, :, :, 0] + rng.normal(0, 0.08, (72, 90))
    sky = ((field > 0.55) * 255).astype(np.uint8)  # blobs with ragged edges and specks
    got = tss._mask_postprocess_np(sky, expand, contract, feather, close)
    want = jx.jss._mask_postprocess_np(sky, expand, contract, feather, close)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    m = jx.jnp.asarray(sky.astype(np.float32))
    m = jmorph.morph_close(m, close) if close else m
    m = jmorph.grey_dilate(m, 2 * expand + 1) if expand else m
    m = jmorph.grey_erode(m, 2 * contract + 1) if contract else m
    m = np.clip(np.asarray(jblur.gaussian_blur(m, feather * 0.5) if feather else m), 0, 255)
    np.testing.assert_array_equal(m.astype(np.uint8), want)
    if not feather:
        np.testing.assert_array_equal(got, want)
        return
    off_edge = np.abs(m - np.round(m)) > 1e-3
    assert off_edge.mean() > 0.1
    assert (diff[off_edge] == 0).mean() >= 0.999


def test_mask_postprocess_truncates():
    """The uint8 cast truncates: a feathered value of 127.9 is 127."""
    sky = np.zeros((40, 40), np.uint8)
    sky[:, 20:] = 255
    m = tss._mask_postprocess_np(sky, 0, 0, 4, 0)
    from neuralstyletransferv1_torch.ops.blur import gaussian_blur

    f = np.clip(gaussian_blur(torch.from_numpy(sky.astype(np.float32)), 2.0).numpy(), 0, 255)
    np.testing.assert_array_equal(m, np.floor(f).astype(np.uint8))
    assert (f != np.round(f)).any()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A 21-class ResNet DeepLab ``.pth.tar``: ``state_dict`` wrapper,
    ``module.`` prefixes, running statistics perturbed."""
    path = tmp_path_factory.mktemp("deeplab") / "deeplab-resnet.pth.tar"
    torch.save({"epoch": 1, "state_dict": {"module." + k: v for k, v in _state_dict().items()}}, path)
    return path


def _image(path, h, w, phase):
    Image.fromarray((_smooth(1, h, w, phase)[0] * 255).astype(np.uint8)).save(path)
    return path


def _close_u8(a_path, b_path):
    a = np.asarray(Image.open(a_path)).astype(int)
    b = np.asarray(Image.open(b_path)).astype(int)
    assert a.shape == b.shape
    d = np.abs(a - b)
    return (d <= 1).mean()


@pytest.mark.parametrize("extra", [
    ["--scan_sky", "--mask_expand_pct", "3.0", "--mask_feather_pct", "3.0"],
    ["--target_labels", "person,car|bus", "--plate_fit", "pad", "--mask_contract", "1"],
], ids=["scan_sky", "target_labels"])
def test_sky_swap_single_image_matches_jax(jx, ckpt, tmp_path, extra):
    """Single-image mode with a plate: the mask and the composite vs JAX
    ``main`` on the same checkpoint and image, within 1 level on ≥ 99.9%."""
    img = _image(tmp_path / "in.png", 96, 128, 0.3)
    plate = _image(tmp_path / "plate.png", 50, 140, 1.1)
    outs = {}
    for side, fn, dev in (("jax", jx.jss.main, []), ("port", tss.main, ["--device", "cpu"])):
        m, o = tmp_path / f"{side}_mask.png", tmp_path / f"{side}_out.png"
        rc = fn(["--image", str(img), "--weights", str(ckpt), "--plate", str(plate),
                 "--out_mask", str(m), "--out_image", str(o), "--resolution", "64"] + extra + dev)
        assert rc == 0
        outs[side] = (m, o)
    assert np.asarray(Image.open(outs["port"][0])).shape == (96, 128)
    assert _close_u8(outs["port"][0], outs["jax"][0]) >= 0.999
    assert _close_u8(outs["port"][1], outs["jax"][1]) >= 0.999


@pytest.mark.parametrize("extra", [
    ["--scan_sky", "--debug_pred", "--mask_feather_pct", "4.0"],
    ["--target_ids", "0,3|7", "--transpose", "flip_h", "--debug_overlay"],
], ids=["scan_sky", "target_ids"])
def test_sky_swap_batch_frames_matches_jax(jx, ckpt, tmp_path, extra):
    """``--batch_frames``: one mask per frame at the frame's size, each vs
    JAX's within 1 level on ≥ 99.9%; the debug outputs are written."""
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(3):
        _image(frames / f"frame_{i + 1:04d}.png", 72, 112, 0.4 * i)
    for side, fn, dev in (("jax", jx.jss.main, []), ("port", tss.main, ["--device", "cpu"])):
        rc = fn(["--weights", str(ckpt), "--batch_frames", str(frames), "--resolution", "64",
                 "--batch_out_dir", str(tmp_path / side)] + extra + dev)
        assert rc == 0
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    masks = [n for n in names if n.startswith("mask_")]
    assert len(masks) == 3 and len(names) == 6
    for n in masks:
        assert np.asarray(Image.open(tmp_path / "port" / n)).shape == (72, 112)
        assert _close_u8(tmp_path / "port" / n, tmp_path / "jax" / n) >= 0.999


# ---------------------------------------------------------------------------
# run_sky_swap: the workflow
# ---------------------------------------------------------------------------


def _clip(path, n=3):
    import cv2

    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8, (96, 64))
    for i in range(n):
        vw.write((_smooth(1, 64, 96, 0.5 * i)[0, :, :, ::-1] * 255).astype(np.uint8))
    vw.release()
    return path


def _drop_device(argv):
    i = argv.index("--device")
    assert argv[i + 1] == "cpu"
    return argv[:i] + argv[i + 2:]


@pytest.mark.parametrize("by_label", [False, True], ids=["scan_sky", "style_by_label"])
def test_run_sky_swap_matches_jax(jx, ckpt, tmp_path, monkeypatch, by_label):
    """The workflow on a 3-frame clip: the pipeline passes it makes (recorded
    in both packages) are the same argv lists apart from the port's
    ``--device``, and the mask folders hold the same files, within 1 level
    on ≥ 99.9%."""
    from neuralstyletransferv1_torch.engine import pipeline as tpipe
    from neuralstyletransferv1_tpu.engine import pipeline as jpipe

    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jpipe, "main", lambda argv: calls["jax"].append(list(argv)) or 0)
    monkeypatch.setattr(tpipe, "main", lambda argv: calls["port"].append(list(argv)) or 0)
    env = {"INPUT_VIDEO": str(_clip(tmp_path / "clip.mp4")), "STYLE_MODEL": str(JOHNSON),
           "DEEPLAB_WEIGHTS": str(ckpt), "FPS": "8", "CANVAS_W": "96", "CANVAS_H": "64",
           "INFER_RES": "64", "MASK_RES": "64", "WORK_ROOT": str(tmp_path / "work"),
           "OUT_DIR": str(tmp_path / "out"), "PIPELINE_ARGS": "--frame_batch 2 --flow_ema",
           "STYLE_BY_LABEL": "1" if by_label else "0", "DEVICE": "cpu"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mask_dirs = ["masks_person", "masks_vehicle"] if by_label else ["masks"]
    assert jx.jrun.main() == 0
    for d in mask_dirs:
        shutil.move(tmp_path / "work" / d, tmp_path / f"jax_{d}")
    assert trun.main() == 0
    assert len(calls["port"]) == (3 if by_label else 1)
    assert [_drop_device(a) for a in calls["port"]] == calls["jax"]
    for d in mask_dirs:
        names = sorted(os.listdir(tmp_path / f"jax_{d}"))
        assert names == sorted(os.listdir(tmp_path / "work" / d))
        assert len(names) == 3
        for n in names:
            assert _close_u8(tmp_path / "work" / d / n, tmp_path / f"jax_{d}" / n) >= 0.999


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------


def test_entry_points_need_cuda_without_device(ckpt, tmp_path, monkeypatch):
    """``--device`` / ``DEVICE`` default to cuda; with no GPU visible the
    segmentation model and both tools raise instead of running on the CPU,
    and other device names are not ported."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tss.build_arg_parser().parse_args(["--weights", "w"]).device == "cuda"
    img = _image(tmp_path / "in.png", 32, 32, 0.0)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tss.main(["--weights", str(ckpt), "--image", str(img)])
    with pytest.raises(NotImplementedError):
        tss.main(["--weights", str(ckpt), "--image", str(img), "--device", "tpu"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tss.SegmentationModel(tdl.import_deeplab(_state_dict())[0], 21)
    monkeypatch.delenv("DEVICE", raising=False)
    monkeypatch.setenv("WORK_ROOT", str(tmp_path / "w"))
    monkeypatch.setenv("OUT_DIR", str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        trun.main()
    assert not (tmp_path / "w").exists()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_masked_step_card_matches_cpu():
    """The bf16 masked step with the full-width ResNet-101 (seed 0) and the
    Johnson slot, card vs CPU on a 1×128×224 frame at ``infer_res`` 65:
    composite MAE ≤ 1e-2, the pre-upsample alpha ≥ 99% equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from neuralstyletransferv1_torch.device import resolve_device

    dev = resolve_device("cuda")
    state = tdl.import_deeplab(tdl.init_state_dict("resnet", 21, seed=0))[0]
    x = torch.from_numpy(_smooth(1, 128, 224))
    out, alpha = [], []
    for d in ("cpu", dev):
        net = tdl.DeepLab(state).to(d).eval()
        step = tms.make_masked_stylize_step(net, tst.load_model(JOHNSON, device=d), (128, 224),
                                            infer_res=INFER)
        out.append(step(x.to(d)).cpu())
        alpha.append(_port_alpha(net, x.to(d), torch.bfloat16))
    assert (out[1] - out[0]).abs().mean().item() <= 1e-2
    assert (alpha[1] == alpha[0]).mean() >= 0.99
