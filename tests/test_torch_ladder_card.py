"""The weight-ladder bank and the Gram NST without JAX: the bank against
its models one by one and the random Johnson slot on the CPU, and the
``cuda`` twins of ``chip_smoke.py`` phase 13 (the bank and 10 Gram NST
steps on the card against the port on the CPU), run on the card's machine
with ``--noconftest`` (this file imports no JAX).

Tolerances: the bank against its models bit for bit on the CPU; card
against CPU, f32: the bank 1e-4 MAE on [0, 1]; the Gram NST history 1e-4
relative, the image mean |Δ| ≤ 1e-4 with ≥ 99.9% within 1e-3.
"""

import numpy as np
import pytest
import torch

from neuralstyletransferv1_torch.engine import gram_nst as tg
from neuralstyletransferv1_torch.engine import stylizer as tst
from neuralstyletransferv1_torch.io import checkpoints as tckpt
from neuralstyletransferv1_torch.models import transformer_net as ttn
from neuralstyletransferv1_torch.models import vgg as tv

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


def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).random(shape).astype(np.float32))


def _bank(seeds, preset, device=CPU):
    return [tst.make_random_model("johnson", seed=s, io_preset=preset, device=device)
            for s in seeds]


def test_random_johnson_slot_is_seeded_and_loads_through_the_importer(tmp_path):
    """``make_random_model("johnson", seed=)``: the same weights for a seed,
    others for another, the preset ``imagenet_255``; the weights are
    ``transformer_net.init(seed)``'s, the state dict a checkpoint saved
    from it loads to."""
    a, b, c = (tst.make_random_model("johnson", seed=s) for s in (7, 7, 8))
    assert (a.arch, a.io_preset, a.name) == ("johnson", "imagenet_255", "random_johnson")
    sa, sb, sc = (m.net.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["res3.conv1.conv2d.weight"], sc["res3.conv1.conv2d.weight"])
    sd = ttn.init(7)
    torch.save(sd, tmp_path / "j.pth")
    loaded = tst.load_model(tmp_path / "j.pth")
    assert loaded.io_preset == "imagenet_255"
    assert all(torch.equal(sa[k], loaded.net.state_dict()[k]) for k in sa)
    assert sd.keys() == tckpt.load_state_dict(str(tmp_path / "j.pth")).keys()
    w, bias = sd["conv2.conv2d.weight"], sd["conv2.conv2d.bias"]
    bound = (1.0 / (32 * 9)) ** 0.5
    assert 0.99 * bound * 3 ** 0.5 < w.abs().max() <= bound * 3 ** 0.5
    assert 0.9 * bound < bias.abs().max() <= bound
    assert torch.equal(sd["in4.weight"], torch.ones(64)) and not sd["in4.bias"].any()
    assert tst.make_random_model("johnson", seed=7, io_preset="raw_01").io_preset == "raw_01"
    with pytest.raises(NotImplementedError):
        tst.make_random_model("t7")


@pytest.mark.parametrize("hw", [(32, 40), (30, 38), (6, 20)])
@pytest.mark.parametrize("preset", ["imagenet_255", "raw_01"])
def test_bank_equals_its_models_one_by_one(hw, preset):
    """The bank's output for each model is that model's own stylize, bit
    for bit: ``jit_stylizer`` (its pad and crop) at 8 rows and more, the
    plain ``stylize`` below."""
    models = _bank((0, 1, 2), preset)
    x = _x((2,) + hw + (3,), 1)
    got = tst.jit_ladder_stylizer(models)(x)
    assert got.shape == (3, 2) + hw + (3,)
    for i, m in enumerate(models):
        want = tst.jit_stylizer(m)(x) if hw[0] >= 8 else tst.stylize(m.net, preset, x)
        assert torch.equal(got[i], want), i


def test_nst_bank_equals_the_exact_nets():
    models = [tst.make_random_model("nst", seed=s) for s in (0, 1)]
    x = _x((1, 30, 38, 3), 2)
    got = tst.jit_ladder_stylizer(models)(x)
    for i, m in enumerate(models):
        with torch.no_grad():
            assert torch.equal(got[i], tst.stylize(m.net, "raw_01", x))


def test_bank_names_and_rejects_mixed_banks():
    models = _bank((0, 1), "raw_01")
    bank = tst.stack_models(models)
    assert bank.name == "bank[2]" and len(bank.net) == 2 and bank.net[1] is models[1].net
    with pytest.raises(ValueError):
        tst.stack_models([models[0], tst.make_random_model("nst")])
    with pytest.raises(ValueError):
        tst.stack_models([models[0], tst.make_random_model("johnson", io_preset="raw_255")])


@pytest.mark.cuda
def test_ladder_bank_card_matches_cpu(cuda_device):
    """A small f32 Johnson bank (3 models, ``raw_01``) at 64×96 (pad and
    crop at 62×94 too), f32 and bf16 (bf16 against the CPU's f32, within
    the repo's 1e-2 gate)."""
    for hw in ((64, 96), (62, 94)):
        x = _x((2,) + hw + (3,), 3)
        cpu = tst.jit_ladder_stylizer(_bank((0, 1, 2), "raw_01"))(x)
        card = tst.jit_ladder_stylizer(_bank((0, 1, 2), "raw_01", cuda_device))(
            x.to(cuda_device)).cpu()
        card16 = tst.jit_ladder_stylizer(_bank((0, 1, 2), "raw_01", cuda_device),
                                         dtype=torch.bfloat16)(x.to(cuda_device)).cpu()
        assert (card - cpu).abs().mean() <= 1e-4
        assert (card16 - cpu).abs().mean() <= 1e-2


@pytest.fixture
def pinned_cudnn():
    """cuDNN's deterministic algorithms for the test, its autotuner off: its
    f32 algorithm choice varied between runs of the same code (ROADMAP
    Queue 3); restored afterwards."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@pytest.mark.cuda
def test_gram_nst_card_matches_cpu(cuda_device, pinned_cudnn):
    """10 steps from the content at 64², VGG from seed 0."""
    c, s = _x((1, 64, 64, 3), 4), _x((1, 64, 64, 3), 5)
    outs = [tg.optimize(tv.load(tv.init(0), d), c.to(d), s.to(d), steps=10)
            for d in (cuda_device, CPU)]
    (card, hc), (cpu, hcpu) = [(o.cpu(), h.cpu()) for o, h in outs]
    assert torch.all((hc - hcpu).abs() <= 1e-4 * hcpu.abs())
    d = (card - cpu).abs()
    share = float((d <= 1e-3).float().mean())
    assert d.mean() <= 1e-4 and share >= 0.999, \
        f"mean |d| {float(d.mean()):.4g}, {share:.6f} within 1e-3"
