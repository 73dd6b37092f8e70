"""Static-norm modes of the PyTorch port (``--quantize bf16_static`` and
``int8_static``) vs the JAX package, on the CPU: the frozen statistics,
the s8-carry residual chain (K2 → K3) with the decoder sites (K4) against
the XLA static int8 reference, the static stylize, and the int8_static video
slice against the JAX engine's.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_int8 import _video, calibrate_jax, chain_out, johnson, xla_reference  # noqa: F401

from neuralstyletransferv1_tpu import config as nconfig
from neuralstyletransferv1_tpu.engine import pipeline as jpipe
from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_tpu.models import transformer_net_s2d2 as s2d2
from neuralstyletransferv1_torch.engine import pipeline as tpipe
from neuralstyletransferv1_torch.models import sites_i8
from neuralstyletransferv1_torch.models import transformer_net_quant as tq
from neuralstyletransferv1_torch.models.transformer_net import quant_from_jax

CKPT = Path(__file__).resolve().parent.parent / "_testdata" / "test_johnson.pth"
ALL_NORMS = ("in1", "in2", "in3", "in4", "in5") + tuple(
    f"r{i}in{j}" for i in range(1, 6) for j in (1, 2))


@pytest.fixture(scope="module")
def static(johnson):  # noqa: F811
    """--quantize int8_static: the JAX calibration and XLA reference at
    (2, 32, 64)."""
    bp32, _, _ = johnson
    x = _video(2, 32, 64, seed=0)
    stats, scales, quant = calibrate_jax(bp32, x, static=True)
    ref, taps = xla_reference(bp32, x, quant, stats, jit=False)
    return {"x": x, "stats": stats, "scales": scales, "quant": quant, "ref": ref, "taps": taps}


def test_calibrate_in_stats_matches_jax(johnson, static):  # noqa: F811
    _, net, _ = johnson
    ours = tq.calibrate_in_stats(net, torch.from_numpy(static["x"][:1]))
    assert sorted(ours) == sorted(static["stats"]) == sorted(ALL_NORMS)
    for k, (m, inv) in static["stats"].items():
        for got, want in zip(ours[k], (m, inv)):
            want = np.asarray(want)
            assert got.shape == want.shape and want.shape[0] == 1
            assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max(), k
    scales = tq.calibrate_act_scales(net, torch.from_numpy(static["x"][:1]),
                                     sites=tq.QUANT_SITES_PALLAS, static_stats=ours)
    for k, v in static["scales"].items():
        assert abs(scales[k] - v) <= 1e-5 * v, (k, scales[k], v)


def test_static_matches_dynamic_on_calibration_input(johnson):  # noqa: F811
    """B=1: the frozen statistics are the measured ones, so the static f32
    forward reproduces the dynamic one to float rounding."""
    _, net, _ = johnson
    x = torch.from_numpy(_video(1, 48, 64, seed=3))
    stats = tq.calibrate_in_stats(net, x)
    with torch.no_grad():
        d = (net(x, static_stats=stats) - net(x)).abs()
    assert float(d.mean()) < 1e-4, float(d.mean())


@pytest.mark.parametrize("hw", [(32, 64), (28, 120)])
def test_s8_chain_matches_xla_reference(johnson, static, hw):  # noqa: F811
    """From the same res input (the JAX head's output), the port's s8-carry
    residual chain (5 × K2 → K3) and decoder sites (2 × K4) reproduce the
    XLA static int8 reference's deconv3 input bit for bit: with frozen
    norms every scale is fixed, and every bf16 rounding happens where the
    reference rounds. 28×120 is below the JAX geometry gate
    (res_supported(7, 30) is False, so the JAX engine runs its XLA form
    there); the port's kernels take any size."""
    bp32, _, nb = johnson
    if hw == (32, 64):
        quant, stats, taps = static["quant"], static["stats"], static["taps"]
    else:
        x = _video(2, *hw, seed=4)
        stats, _, quant = calibrate_jax(bp32, x, static=True)
        _, taps = xla_reference(bp32, x, quant, stats, jit=False)
        assert not si8.res_supported(hw[0] // 4, hw[1] // 4)
    ours = chain_out(nb, quant, taps["r1a"], stats)
    np.testing.assert_array_equal(ours, taps["d3"])


def test_int8_static_stylize_matches_xla_reference(johnson, static):  # noqa: F811
    """The whole int8_static forward with the JAX calibration carried
    across, against the XLA reference: the bf16 heads differ by isolated
    ulps (pixel vs space-to-depth convs), which flip a few codes; the
    outputs agree to the repo's 1e-2 gate."""
    _, _, nb = johnson
    q, st = quant_from_jax(static["quant"], static["stats"])
    with torch.no_grad():
        ours = tq.forward_int8(nb, torch.from_numpy(static["x"]).to(torch.bfloat16),
                               sites_i8.prepare_sites(nb, q, "cpu"), st).float().numpy()
    d = np.abs(np.clip(ours, 0, 1) - np.clip(static["ref"], 0, 1))
    assert d.mean() <= 1e-2, d.mean()


def test_bf16_static_stylize_matches_jax(johnson, static):  # noqa: F811
    """bf16 with the JAX frozen statistics, against the JAX static bf16
    forward: bf16 rounding differences only (no codes to flip)."""
    bp32, _, nb = johnson
    bp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), bp32)
    ref = jax.jit(lambda t: s2d2.apply(bp, t, static_stats=static["stats"]))(
        jnp.asarray(static["x"], jnp.bfloat16))
    _, st = quant_from_jax(None, static["stats"])
    with torch.no_grad():
        ours = nb(torch.from_numpy(static["x"]).to(torch.bfloat16), static_stats=st)
    d = np.abs(np.clip(ours.float().numpy(), 0, 1) - np.clip(np.asarray(ref, np.float32), 0, 1))
    assert d.mean() <= 1e-2, d.mean()


def test_int8_static_video_slice_matches_jax(tmp_path, monkeypatch):
    """``make_batched_core`` with ``--quantize int8_static --compute_dtype
    bfloat16 --exact_warp`` on two batches of 4 at 128×192 against the JAX
    engine's ``_make_batched_core`` under the same argv; each engine
    calibrates itself on its first frame."""
    if not CKPT.exists():
        pytest.skip("synthetic checkpoint missing")
    monkeypatch.setenv("NST_TPU_COMPILE_CACHE", "0")
    monkeypatch.setattr(nconfig, "conv_precision", nconfig.conv_precision)
    frames = [np.ascontiguousarray((f * 255).astype(np.uint8)) for f in _video(8, 128, 192, 5)]
    argv = ["--input_video", "in.mp4", "--output_video", "out.mp4", "--model", str(CKPT),
            "--io_preset", "raw_01", "--frame_batch", "4", "--flow_ema", "--exact_warp",
            "--quantize", "int8_static", "--compute_dtype", "bfloat16"]
    _, tproc = tpipe.make_batched_core(tpipe.build_parser().parse_args(argv + ["--device", "cpu"]),
                                       torch.device("cpu"))
    _, jproc = jpipe._make_batched_core(jpipe.build_arg_parser().parse_args(argv), tmp_path)
    for b0 in (0, 4):
        ours = tproc(frames[b0:b0 + 4]).numpy().astype(np.float64)
        ref = np.asarray(jproc(frames[b0:b0 + 4], None, b0)).astype(np.float64)
        assert ours.shape == ref.shape == (4, 128, 192, 3)
        mae = np.abs(ours - ref).mean() / 255.0
        assert mae <= 1e-2, (b0, mae)
        assert ours.std() > 1.0
