"""Regions, masks and the LAB multi-slot blend: the port against the JAX
package on the CPU.

The port keeps its own copy of ``region/`` (masks, animation, blend DSL,
composite, crops), of the grey dilation and of the replicate-border
bilinear sampler, and adds the mask composite to the batched temporal
chain. Every generator, parser, animation and composite is held against its
JAX function on the same seed (masks and weights within 1e-5); the temporal
chain with masks against JAX's scan within its bounds; the batched core
with regions or the LAB blend and ``--mask_dir`` against JAX's; then the CLI
cases
(twins of ``tests/test_pipeline_cli.py::test_region_blend_cli`` and
``test_mask_composite_cli`` on synthesized images and frames, two slots of
the repo's Johnson checkpoint under different IO presets, so the slots
differ) within 1 level on >= 99% of the values.
"""

import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from neuralstyletransferv1_tpu import config as nconfig
from neuralstyletransferv1_tpu import region as jr
from neuralstyletransferv1_tpu.engine import pipeline as jpipe
from neuralstyletransferv1_tpu.engine import stylizer as jst
from neuralstyletransferv1_tpu.ops import morphology as jmorph
from neuralstyletransferv1_tpu.ops import warp as jwarp
from neuralstyletransferv1_tpu.region import animate as janim
from neuralstyletransferv1_tpu.region import blend as jblend
from neuralstyletransferv1_tpu.region import crops as jcrops
from neuralstyletransferv1_tpu.temporal import ema as jema
from neuralstyletransferv1_torch import region as tr
from neuralstyletransferv1_torch.engine import pipeline as tpipe
from neuralstyletransferv1_torch.ops import morphology as tmorph
from neuralstyletransferv1_torch.ops import warp as twarp
from neuralstyletransferv1_torch.region import animate as tanim
from neuralstyletransferv1_torch.region import blend as tblend
from neuralstyletransferv1_torch.region import crops as tcrops
from neuralstyletransferv1_torch.temporal import ema as tema

H, W = 40, 56
CKPT = Path(__file__).resolve().parent.parent / "_testdata" / "test_johnson.pth"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this file: in the six-worker tier-1 run
    the workers share the cores, and a multi-threaded pool then waits at
    each op's barrier for threads other workers preempt."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(ours, ref, tol=1e-5):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    d = np.abs(ours.astype(np.float64) - np.asarray(ref, np.float64))
    assert ours.shape == np.asarray(ref).shape
    assert d.max() <= tol, d.max()


def _v(obj):
    """A dataclass (or a list of them) as plain fields: the two packages'
    classes are distinct."""
    return [vars(o) for o in obj] if isinstance(obj, list) else vars(obj)


# ---------------------------------------------------------------------------
# masks, feathering, parsers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", jr.AVAILABLE_MODES)
def test_generators_match_jax(mode):
    """Each generator at a fixed seed (the random mode picks through the same
    RNG), feathered; voronoi also power-weighted by region sizes."""
    for count, feather in ((3, 6), (5, 0)):
        _close(tr.generate_region_masks(H, W, mode, count, seed=7, feather=feather),
               jr.generate_region_masks(H, W, mode, count, seed=7, feather=feather))
    if mode == "voronoi":
        sizes = tr.masks.parse_region_sizes("1,2|0.5", 4)
        assert sizes == jr.masks.parse_region_sizes("1,2|0.5", 4) == [1.0, 2.0, 0.5, 1.0]
        _close(tr.generate_region_masks(H, W, mode, 4, seed=3, feather=4, region_sizes=sizes),
               jr.generate_region_masks(H, W, mode, 4, seed=3, feather=4, region_sizes=sizes))


def test_feather_and_parsers_match_jax():
    m = np.random.default_rng(1).random((2, H, W, 1)).astype(np.float32)
    for px in (0, 3, 10):
        _close(tr.feather_mask(torch.from_numpy(m), px), jr.feather_mask(jnp.asarray(m), px))
    for spec in (None, "1,1", "2|0.5|1|1|3", "x,1"):
        assert tr.masks.parse_region_sizes(spec, 3) == jr.masks.parse_region_sizes(spec, 3)
    for spec in (None, "off", "blob", "pulse", "2", "2,0.3", "2,0.3,4", "2,0.3,4,wave", "fast"):
        assert _v(tr.parse_morph_animation(spec)) == _v(janim.parse_morph_animation(spec)), spec
    for spec in (None, "0", "60", "60,triangle", "60,square,90,0.2,0.9", "bad"):
        assert _v(tr.parse_blend_animation(spec)) == _v(jr.parse_blend_animation(spec)), spec
        assert _v(tr.parse_scale_animation(spec)) == _v(jr.parse_scale_animation(spec)), spec
    for spec in (None, "30|60,sawtooth", "45,sine"):
        assert _v(tr.parse_region_blend_animations(spec, 3)) == _v(
            jr.parse_region_blend_animations(spec, 3))
        assert _v(tr.parse_region_scale_animations(spec, 3)) == _v(
            jr.parse_region_scale_animations(spec, 3))


def test_harmonics_assignments_and_dsl_match_jax():
    for wave in ("sine", "triangle", "sawtooth", "sawtooth_down", "square", "other"):
        for f in (0, 7, 33):
            assert tr.compute_harmonic_value(f, 24, 0.1, 0.9, 45, wave) == \
                jr.compute_harmonic_value(f, 24, 0.1, 0.9, 45, wave)
    anim = jr.BlendAnimation(enabled=True, period=20, waveform="triangle")
    tanim_ = tr.BlendAnimation(enabled=True, period=20, waveform="triangle")
    for f in (0, 5, 13):
        assert tr.compute_animated_weights([0.5, 0.3, 0.2], f, tanim_) == \
            jr.compute_animated_weights([0.5, 0.3, 0.2], f, anim)
        assert tr.compute_animated_scale(1.0, f, tr.ScaleAnimation(enabled=True, period=9)) == \
            jr.compute_animated_scale(1.0, f, jr.ScaleAnimation(enabled=True, period=9))
    for assignment, weights, chance in (("sequential", None, 0.0), ("sequential", None, 0.3),
                                        ("random", None, 0.0), ("random", None, 0.4),
                                        ("weighted", [0.2, 0.8], 0.0),
                                        ("weighted", None, 0.25)):
        assert tr.assign_models_to_regions(7, 2, assignment, weights, 11, chance) == \
            jr.assign_models_to_regions(7, 2, assignment, weights, 11, chance)
    for spec, scales in (("A:0.7+B:0.3|C|O", "1,0.5"), ("a+b:0.2|ORIGINAL", None),
                         (None, "1|0.75|0.5")):
        ours = tr.parse_region_configs(5, 3, "random", spec, scales, 4, 0.2)
        ref = jr.parse_region_configs(5, 3, "random", spec, scales, 4, 0.2)
        assert _v(ours) == _v(ref)
        assert sorted(tr.get_required_scales(5, 3, "random", spec, scales, 4)) == \
            sorted(jr.get_required_scales(5, 3, "random", spec, scales, 4))
    with pytest.raises(ValueError, match="Unknown model"):
        tr.parse_region_configs(2, 2, blend_spec="Z")
    np.testing.assert_array_equal(
        tblend._region_weight_matrix(tr.parse_region_configs(3, 2, blend_spec="A+B|O"), 2),
        jblend._region_weight_matrix(jr.parse_region_configs(3, 2, blend_spec="A+B|O"), 2))


# ---------------------------------------------------------------------------
# animation, morphology, sampling
# ---------------------------------------------------------------------------


def test_morphology_and_sampler_match_jax():
    """The gap fill's dilation (NHWC, HW and integer input) and the
    replicate-border sampler of the rotation and the organic warps."""
    x = np.random.default_rng(2).random((2, 15, 19, 3)).astype(np.float32)
    for k in (3, 5, 11):
        _close(tmorph.grey_dilate(torch.from_numpy(x), k), jmorph.grey_dilate(jnp.asarray(x), k),
               0.0)
        _close(tmorph.grey_dilate(torch.from_numpy(x[0, ..., 0]), k),
               jmorph.grey_dilate(jnp.asarray(x[0, ..., 0]), k), 0.0)
    u8 = (x[0] * 255).astype(np.uint8)
    _close(tmorph.grey_dilate(torch.from_numpy(u8), 5),
           jmorph.grey_dilate(jnp.asarray(u8.astype(np.float32)), 5), 0.0)
    img = x[0]
    rng = np.random.default_rng(3)
    mx = rng.uniform(-3, 21, (15, 19)).astype(np.float32)
    my = rng.uniform(-3, 17, (15, 19)).astype(np.float32)
    _close(twarp.bilinear_sample(torch.from_numpy(img), torch.from_numpy(mx),
                                 torch.from_numpy(my)),
           jwarp.bilinear_sample(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my),
                                 border="replicate"))


@pytest.mark.parametrize("mode", ["blob", "tentacle", "wave", "pulse"])
def test_organic_warp_and_rotation_match_jax(mode):
    base = jr.generate_region_masks(H, W, "voronoi", 3, seed=5, feather=4)
    tb = torch.from_numpy(np.asarray(base).copy())
    morph = tr.MorphAnimation(enabled=True, mode=mode, amplitude=0.2, speed=3.0)
    jmorph_ = jr.MorphAnimation(enabled=True, mode=mode, amplitude=0.2, speed=3.0)
    for f in (1, 17):
        _close(tr.warp_all_masks_organic(tb, morph, f),
               jr.warp_all_masks_organic(base, jmorph_, f), 2e-5)
    if mode == "blob":
        for angle in (0.0, 7.5, -33.0):
            _close(tr.rotate_all_masks(tb, angle), jr.rotate_all_masks(base, angle))
        sparse = np.zeros((2, H, W), np.float32)
        sparse[0, :4, :4] = 1.0
        sparse[1, -3:, -5:] = 0.5
        _close(tanim._gap_fill(torch.from_numpy(sparse)), janim._gap_fill(jnp.asarray(sparse)))
        assert tanim._octave_offsets(42, 3) == janim._octave_offsets(42, 3)


# ---------------------------------------------------------------------------
# composites
# ---------------------------------------------------------------------------


def _outs(n, seed=4, h=H, w=W):
    rng = np.random.default_rng(seed)
    return [rng.random((h, w, 3)).astype(np.float32) for _ in range(n)]


def test_blend_by_regions_matches_jax():
    """The simple composite, static and animated (rotation, then an organic
    morph; the base masks come from the cache on later frames), with the
    original frame in the mix."""
    outs, orig = _outs(3), _outs(1, seed=9)[0]
    t_outs = [torch.from_numpy(o) for o in outs]
    cases = [dict(mode="grid", assignment="sequential", seed=1),
             dict(mode="voronoi", seed=7, original_chance=0.5, rotation_rate=4.0),
             dict(mode="waves", seed=3, morph="blob", region_count=4, weights=[0.2, 0.3, 0.5],
                  assignment="weighted", region_sizes=[1, 2, 1, 1])]
    tblend.clear_mask_cache()
    jblend.clear_mask_cache()
    for kw in cases:
        kw = dict(kw)
        morph = kw.pop("morph", None)
        for f in (1, 2, 9):
            ours = tr.blend_by_regions(
                t_outs, H, W, feather=6, original=torch.from_numpy(orig), frame_idx=f,
                morph=tr.parse_morph_animation(morph), **kw)
            ref = jr.blend_by_regions(
                outs, H, W, feather=6, original=orig, frame_idx=f,
                morph=jr.parse_morph_animation(morph), **kw)
            _close(ours, ref, 2e-5)


def test_blend_by_regions_advanced_matches_jax():
    """The DSL composite over rendered scales, with per-region blend and
    scale animations."""
    outs, orig = _outs(2, seed=5), _outs(1, seed=6)[0]
    by_scale_j = {1.0: outs, 0.5: [o[::2, ::2] for o in outs]}
    by_scale_t = {s: [torch.from_numpy(np.ascontiguousarray(o)) for o in v]
                  for s, v in by_scale_j.items()}
    for f in (1, 6):
        kw = dict(mode="diagonal", region_count=3, blend_spec="A:0.6+B|B|O",
                  scale_spec="1|0.5", seed=2, frame_idx=f, feather=5, rotation_rate=2.0)
        ours = tr.blend_by_regions_advanced(
            by_scale_t, H, W, original=torch.from_numpy(orig),
            blend_animations=tr.parse_region_blend_animations("10,triangle|20", 3),
            scale_animations=tr.parse_region_scale_animations("8", 3), **kw)
        ref = jr.blend_by_regions_advanced(
            by_scale_j, H, W, original=orig,
            blend_animations=jr.parse_region_blend_animations("10,triangle|20", 3),
            scale_animations=jr.parse_region_scale_animations("8", 3), **kw)
        _close(ours, ref, 2e-5)
    masks = jr.generate_region_masks(20, 28, "radial", 2, seed=1, feather=3)
    _close(tr.composite_regions([torch.from_numpy(o) for o in outs], torch.from_numpy(
        np.asarray(masks).copy()), [1, -1], torch.from_numpy(orig)),
        jr.composite_regions(outs, masks, [1, -1], orig), 2e-5)


def test_crop_helpers_match_jax():
    masks = np.asarray(jr.generate_region_masks(H, W, "grid", 4, seed=0, feather=2))
    configs = jr.parse_region_configs(4, 2, blend_spec="A|B:0.5+O|A+B|B", scale_spec="1|0.5")
    tconfigs = tr.parse_region_configs(4, 2, blend_spec="A|B:0.5+O|A+B|B", scale_spec="1|0.5")
    crops_j = jcrops.prepare_region_crops(masks, configs, H, W, padding=5)
    crops_t = tcrops.prepare_region_crops(masks, tconfigs, H, W, padding=5)
    assert [(c.region_idx, c.bbox, c.padded_bbox) for c in crops_t] == \
        [(c.region_idx, c.bbox, c.padded_bbox) for c in crops_j]
    assert tcrops.compute_mask_bbox(np.zeros((5, 7))) == jcrops.compute_mask_bbox(
        np.zeros((5, 7))) == (0, 0, 7, 5)
    assert tcrops.models_needed_for_regions(crops_t) == jcrops.models_needed_for_regions(crops_j)
    assert tcrops.compute_crop_coverage(crops_t, H, W) == jcrops.compute_crop_coverage(
        crops_j, H, W)
    for hw in ((5, 7), (130, 700), (2100, 3000)):
        assert tcrops.bucket_hw(*hw) == jcrops.bucket_hw(*hw)
    px = [np.random.default_rng(i).random((9 + i, 30 - i, 3)).astype(np.float32)
          for i in range(3)]

    def fn(batch):
        return np.clip(batch * 0.8 + batch.mean(axis=(1, 2), keepdims=True) * 0.2, 0, 1)

    for a, b in zip(tcrops.style_crop_batched(px, fn), jcrops.style_crop_batched(px, fn)):
        np.testing.assert_array_equal(a, b)
    orig = _outs(1, seed=8)[0]
    styled = {m: {c.region_idx: np.random.default_rng(10 + m + c.region_idx).random(
        (c.padded_bbox[3] - c.padded_bbox[1], c.padded_bbox[2] - c.padded_bbox[0], 3))
        .astype(np.float32) for c in crops_j} for m in (0, 1)}
    anims = jr.parse_region_blend_animations("12", 4)
    for original in (orig, None):
        if original is None:  # the dilation gap fill needs the original absent
            crops_j = [c for c in crops_j if -1 not in c.config.model_indices]
            crops_t = [c for c in crops_t if -1 not in c.config.model_indices]
        _close(tcrops.composite_from_crops(styled, crops_t, original, H, W, masks, 3,
                                          tr.parse_region_blend_animations("12", 4)),
               jcrops.composite_from_crops(styled, crops_j, original, H, W, masks, 3, anims))


# ---------------------------------------------------------------------------
# the mask composite in the temporal chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keep,motion_blend,flow_ema", [(True, False, True), (False, True, True),
                                                         (True, True, False)])
def test_masked_temporal_chain_matches_jax(keep, motion_blend, flow_ema):
    """``temporal_postprocess_split`` with per-frame mask alphas (some frames
    unmasked) against JAX's scan: the composite after the LAB EMA, and a
    masked frame takes the uniform blend, never the motion-adaptive one."""
    rng = np.random.default_rng(11)
    T = 5
    styled, orig = (rng.random((T, 13, 17, 3)).astype(np.float32) for _ in range(2))
    flows = rng.normal(0, 1.5, (T, 13, 17, 2)).astype(np.float32)
    alphas = rng.random((T, 13, 17, 1)).astype(np.float32)
    has = np.array([True, False, True, True, False])
    kw = dict(flow_ema=flow_ema, flow_alpha=0.8, smooth_lightness=True, smooth_alpha=0.7,
              motion_blend=motion_blend, blend=0.85, composite_keep=keep)
    out, _ = tema.temporal_postprocess_split(
        *map(torch.from_numpy, (styled, orig, flows)), mask_alphas=torch.from_numpy(alphas),
        mask_has=torch.from_numpy(has), **kw)
    ref, _ = jema.temporal_postprocess_scan(
        *map(jnp.asarray, (styled, orig, flows)), mask_alphas=jnp.asarray(alphas),
        mask_has=jnp.asarray(has), **kw)
    d = np.abs(out.numpy().astype(np.float64) - np.asarray(ref, np.float64))
    assert d.mean() <= 1e-4 and (d > 1 / 255).mean() <= 1e-3, (d.mean(), (d > 1 / 255).mean())


# ---------------------------------------------------------------------------
# the CLI, port vs the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shared_jax_stylizers():
    """The JAX engine's compiled unquantized stylizers, kept across this
    module's CLI cases: every case loads the same checkpoint into the same
    slots, and a fresh ``jit_stylizer`` per ``main()`` recompiles the same
    function (a quantized stylizer calibrates on its first frame, so it is
    built anew each time)."""
    built = {}
    orig = jst.jit_stylizer

    def jit_stylizer(model, **kw):
        if kw.get("quantize", "none") != "none" or kw.get("mesh") is not None:
            return orig(model, **kw)
        leaves = [np.asarray(a) for a in jax.tree.leaves(model.params)]
        key = (model.arch, model.name, model.io_preset, model.model_type,
               str(kw.get("dtype")), kw.get("optimize", True),
               tuple((a.shape, float(a.astype(np.float64).sum())) for a in leaves))
        if key not in built:
            built[key] = orig(model, **kw)
        return built[key]

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jst, "jit_stylizer", jit_stylizer)
        yield


@pytest.fixture
def isolated(monkeypatch, shared_jax_stylizers):
    if not CKPT.exists():
        pytest.skip("synthetic checkpoint missing")
    monkeypatch.setenv("NST_TPU_COMPILE_CACHE", "0")
    monkeypatch.setattr(nconfig, "conv_precision", nconfig.conv_precision)
    tblend.clear_mask_cache()
    jblend.clear_mask_cache()
    tpipe._crop_cache.clear()
    jpipe._crop_cache.clear()


def _frames(n, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (rng.random((h, w, 3)) * 120).astype(np.float32)
    out = []
    for t in range(n):
        x, y = xx - 2 * t, yy - t
        tex = (60 * np.sin(0.2 * x + 0.1 * y)[..., None]
               + 50 * np.cos(0.13 * x - 0.21 * y)[..., None])
        out.append(np.clip(base + 70 + tex, 0, 255).astype(np.uint8))
    return out


def _u8(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"), np.int32)


def _assert_u8_close(ours, ref):
    d = np.abs(ours - ref)
    assert ours.shape == ref.shape
    assert (d <= 1).mean() >= 0.99, ((d <= 1).mean(), d.max())
    assert ours.std() > 1.0


TWO_SLOTS = ["--model", str(CKPT), "--io_preset", "raw_01", "--model_b", str(CKPT),
             "--io_preset_b", "raw_255"]
ONE_SLOT = TWO_SLOTS[:4]


def _mask(path, h=48, w=64):
    m = np.zeros((h, w), np.uint8)
    m[:, : w // 2] = 255
    m[h // 3:, w // 2: w // 2 + 8] = 128
    Image.fromarray(m).save(path)
    return path


@pytest.mark.parametrize("slots,extra", [
    (TWO_SLOTS, ["--region_mode", "voronoi", "--region_seed", "7"]),
    (TWO_SLOTS, ["--region_mode", "diagonal", "--region_seed", "3", "--region_count", "3",
                 "--region_blend_spec", "A:0.7+B:0.3|B|O", "--region_scales", "1,0.5"]),
    (TWO_SLOTS, ["--region_mode", "grid", "--region_seed", "5", "--region_optimize",
                 "--region_padding", "8", "--region_assignment", "sequential",
                 "--region_scales", "1,0.5"]),
    (TWO_SLOTS, ["--blend_models_lab", "--blend_models_lab_weights", "0.3,0.7"]),
    (ONE_SLOT, ["--mask", "MASK", "--mask_feather", "4"]),
    (ONE_SLOT, ["--quantize", "int8"]),
], ids=["voronoi", "blend_spec_scales", "optimize", "lab", "mask", "quantize_f32"])
def test_image_cli_matches_jax(isolated, tmp_path, slots, extra):
    """The single-image mode with the region, mask, LAB and --quantize (on
    the default float32) flags, port vs JAX engine. Under --quantize int8
    the two compute different int8 functions — the port its adopted set's
    chains (the f32 forms first), the JAX CPU engine the XLA int8 form — so
    that case is held to the repo's int8 gate (MAE <= 1e-2 on [0, 1]; this
    random net moves up to 17 levels where a code flips)."""
    src = tmp_path / "in.png"
    Image.fromarray(_frames(1, seed=5)[0]).save(src)
    extra = [str(_mask(tmp_path / "m.png")) if a == "MASK" else a for a in extra]
    argv = slots + extra + ["--input_image", str(src), "--no-smooth_lightness"]
    a, b = tmp_path / "t.png", tmp_path / "j.png"
    assert tpipe.main(argv + ["--output_image", str(a), "--device", "cpu",
                              "--work_dir", str(tmp_path / "_wt")]) == 0
    assert jpipe.main(argv + ["--output_image", str(b), "--work_dir", str(tmp_path / "_wj")]) == 0
    if "--quantize" in extra:
        d = np.abs(_u8(a) - _u8(b)) / 255.0
        assert d.mean() <= 1e-2 and _u8(a).std() > 1.0, d.mean()
    else:
        _assert_u8_close(_u8(a), _u8(b))


def _write_frames(d: Path, frames) -> Path:
    d.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames, start=1):
        Image.fromarray(f).save(d / f"frame_{i:04d}.png")
    return d


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "per_frame"])
def test_mask_dir_and_rotating_regions_on_frames_match_jax(isolated, tmp_path, batched):
    """Five frames through ``--input_dir`` (staged as ``frame_<n>``):
    ``--mask_dir`` (one frame without a mask) over rotating voronoi regions,
    on the batched path (``--frame_batch 2``: a padded tail frame) and the
    per-frame loop."""
    frames = _frames(5, seed=3)
    in_dir = _write_frames(tmp_path / "ins", frames)
    md = tmp_path / "masks"
    md.mkdir()
    for i in (1, 2, 3, 5):
        _mask(md / f"mask_{i:04d}.png")
    argv = TWO_SLOTS + ["--input_dir", str(in_dir), "--pattern", "frame_*.png",
                        "--mask_dir", str(md), "--composite_mode", "replace",
                        "--region_mode", "voronoi", "--region_seed", "4", "--region_rotate", "6",
                        "--frame_batch", "2" if batched else "1"]
    ta, jb = tmp_path / "t_out", tmp_path / "j_out"
    assert tpipe.main(argv + ["--output_dir", str(ta), "--device", "cpu",
                              "--work_dir", str(tmp_path / "_wt")]) == 0
    assert jpipe.main(argv + ["--output_dir", str(jb), "--work_dir", str(tmp_path / "_wj")]) == 0
    names = sorted(p.name for p in ta.glob("*.png"))
    assert names == sorted(p.name for p in jb.glob("*.png")) and len(names) == 5
    for name in names:
        _assert_u8_close(_u8(ta / name), _u8(jb / name))


@pytest.mark.parametrize("extra", [
    ["--region_mode", "voronoi", "--region_seed", "9", "--region_rotate", "5",
     "--region_assignment", "sequential"],
    ["--blend_models_lab", "--composite_mode", "replace"],
], ids=["regions", "lab"])
def test_batched_core_with_masks_matches_jax(isolated, tmp_path, extra):
    """The batched core (the streaming path's) against the JAX engine's on
    two batches of 4 (the second with 2 real frames: the padded frames
    reuse the last real one and draw nothing), two slots, flow EMA and the
    exact warp, per-frame ``--mask_dir`` alphas by the frames' names (frame
    4 without a mask): the uint8 outputs within 1 level on >= 99%."""
    frames = _frames(6, seed=8)
    md = tmp_path / "masks"
    md.mkdir()
    for i in (1, 2, 3, 5, 6):
        _mask(md / f"mask_{i:04d}.png")
    argv = ["--input_video", "in.mp4", "--output_video", "out.mp4", *TWO_SLOTS,
            "--frame_batch", "4", "--flow_ema", "--exact_warp", "--mask_dir", str(md), *extra]
    B, tproc = tpipe.make_batched_core(tpipe.build_parser().parse_args(argv + ["--device", "cpu"]),
                                       torch.device("cpu"), frames_dir=tmp_path / "t")
    jB, jproc = jpipe._make_batched_core(jpipe.build_arg_parser().parse_args(argv), tmp_path / "j")
    assert B == jB == 4
    for b0 in (0, 4):
        chunk = frames[b0:b0 + B]
        names = [Path(f"frame_{b0 + i + 1:04d}.png") for i in range(len(chunk))]
        ours = tproc(chunk, names, b0)[:len(chunk)].numpy().astype(np.int32)
        ref = np.asarray(jproc(chunk, names, b0))[:len(chunk)].astype(np.int32)
        for o, r in zip(ours, ref):
            _assert_u8_close(o, r)


def test_lab_weights_and_region_seed_parsing():
    assert tpipe.parse_lab_weights(None) == jpipe.parse_lab_weights(None) == (0.5, 0.5)
    assert tpipe.parse_lab_weights("0.2,0.8") == (0.2, 0.8)
    with pytest.raises(ValueError, match="sum to 1"):
        tpipe.parse_lab_weights("0.5,0.6")
    parser = tpipe.build_parser()
    for extra in ([], ["--region_seed", "random"], ["--region_seed", "fixed"],
                  ["--region_seed", "12"], ["--region_rotate", "2"], ["--region_seed", "x"]):
        args = parser.parse_args(["--input_image", "a"] + extra)
        morph = tr.parse_morph_animation(args.region_morph) if args.region_morph else None
        assert tpipe._parse_region_seed(args, morph) == jpipe._parse_region_seed(args, morph)


def test_unseeded_regions_draw_from_a_fresh_rng(monkeypatch):
    """No --region_seed and no animation: the seed is None and the masks
    come from an unseeded ``random.Random()`` (every comparison test above
    passes a seed)."""
    seeds = []
    orig = random.Random.__init__

    def spy(self, x=None):
        seeds.append(x)
        orig(self, x)

    monkeypatch.setattr(random.Random, "__init__", spy)
    tr.generate_region_masks(8, 8, "voronoi", 2, seed=None, feather=0)
    assert seeds[-1] is None
