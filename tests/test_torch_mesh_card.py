"""The mesh without JAX: two shards on one device share one weight replica
and match the single-device core on the CPU; and the ``cuda`` twins of
``chip_smoke.py`` phase 14 (a 2-shard mesh with both shards on ``cuda:0``
against the single-device core, with the kernels' launch counts), run on
the card's machine with ``--noconftest`` (this file imports no JAX).

Tolerances: CPU, smoothing off, f32: bit for bit. Card, bf16, smoothing
off, at the slice's 1080p: within 1/255 on ≥ 99.9% of the pixels (the
calibration is shared, so only cuDNN's choice of algorithm at the shard's
batch can differ; it does not at 1080p, where the two are bit-identical,
but at 256×448 cuDNN's bf16 convs round differently at B = 4 than at B = 8:
86% of the pixels within 1 level with no quantize, f32 bit-identical, on an
H100); the launch counts exact: K1 as single-device, K2–K5 twice a single
shard's.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from neuralstyletransferv1_torch.engine import pipeline as tpipe
from neuralstyletransferv1_torch.parallel import mesh as tm

CKPT = Path(__file__).resolve().parent.parent / "_testdata" / "test_johnson.pth"
CPU = torch.device("cpu")


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
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from neuralstyletransferv1_torch.device import resolve_device

    return resolve_device("cuda")  # TF32 off


def _frames(n, h, w, seed):
    base = (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)
    return [np.ascontiguousarray(np.roll(base, (t, 3 * t), axis=(0, 1))) for t in range(n)]


def _args(extra):
    return tpipe.build_parser().parse_args(
        ["--input_video", "a.mp4", "--output_video", "b.mp4", "--model", str(CKPT),
         "--io_preset", "raw_01"] + extra)


def _run(args, device, frames, mesh=None):
    b, process = tpipe.make_batched_core(args, device, mesh=mesh)
    return torch.cat([process(frames[i:i + b]) for i in range(0, len(frames), b)])


def test_repeated_device_shares_one_replica():
    """Shards on one device share the caller's weights (one replica: the
    module itself), other devices get copies; the explicit mesh matches the
    single-device core."""
    mesh = tm.make_mesh(devices=["cpu", "cpu"])
    net = torch.nn.Linear(2, 2)
    assert mesh.distinct() == [CPU] and mesh.replicate(net) == {CPU: net}
    reps = tm.make_mesh(2, "cpu").replicate(net)
    one = torch.device("cpu", 1)
    assert reps[torch.device("cpu", 0)] is net and reps[one] is not net
    assert torch.equal(reps[one].weight, net.weight)
    frames = _frames(8, 64, 96, 0)
    argv = ["--frame_batch", "4", "--no-smooth_lightness", "--device", "cpu", "--quantize",
            "int8_static"]
    assert torch.equal(_run(_args(argv), CPU, frames), _run(_args(argv), CPU, frames, mesh=mesh))


def _counts():
    from neuralstyletransferv1_torch.kernels import dis_iter as k1
    from neuralstyletransferv1_torch.kernels import int8_sites as k8

    return {"dis_iter": k1.LAUNCHES, **k8.LAUNCHES, **k8.F32_LAUNCHES}


@pytest.mark.cuda
@pytest.mark.parametrize("quantize,per_shard", [
    ("int8_static", {"res_site_s8o": 5, "site_s8": 5, "res_site": 2}),
    ("int8", {"res_site": 7, "res_site_skip": 5}),
])
def test_mesh_on_one_card_matches_single_device(cuda_device, quantize, per_shard):
    """A 2-shard mesh with both shards on the card against the
    single-device core (bf16, 2 batches of 8 at 1080p): with smoothing off
    the outputs agree within 1/255 on ≥ 99.9%; with the flow EMA the mesh
    launches K1 as the single device does and K2–K5 twice a shard's
    forward, a batch."""
    frames = _frames(16, 1080, 1920, 1)
    base = ["--frame_batch", "8", "--compute_dtype", "bfloat16", "--quantize", quantize]
    mesh = tm.make_mesh(devices=[cuda_device, cuda_device])
    off = base + ["--no-smooth_lightness"]
    a = _run(_args(off), cuda_device, frames).float()
    b = _run(_args(off), cuda_device, frames, mesh=mesh).float()
    assert ((a - b).abs() <= 1.0).float().mean().item() >= 0.999

    got = {}
    for m in (None, mesh):
        b_, process = tpipe.make_batched_core(_args(base + ["--flow_ema"]), cuda_device, mesh=m)
        process(frames[:8])  # calibrates
        before = _counts()
        process(frames[8:])
        torch.cuda.synchronize()
        got[m is not None] = {k: v - before[k] for k, v in _counts().items()}
    assert got[True]["dis_iter"] == got[False]["dis_iter"] > 0
    for k, v in got[True].items():
        if k != "dis_iter":
            assert v == 2 * per_shard.get(k, 0) and got[False][k] == per_shard.get(k, 0), k
