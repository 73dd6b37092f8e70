"""The weight-ladder bank (``engine/stylizer.py``: ``stack_models``,
``jit_ladder_stylizer``, ``blend_outputs``): the port against the JAX
engine on the CPU, with JAX's random weights carried across by each net's
``params_from_jax``. (JAX-free checks of the bank and its card twins:
``tests/test_torch_ladder_card.py``.)

The Johnson banks run under ``raw_01``, where a random net's output spans
[0, 1] (under the bench's ``imagenet_255`` it sits near 0, which would hold
nothing). Tolerances: f32 MAE 1e-5 and max 1e-4 on [0, 1]; bf16 the repo's
1e-2 MAE gate; ``blend_outputs`` 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralstyletransferv1_tpu.engine import stylizer as jst
from neuralstyletransferv1_tpu.models import transformer_net as jtn
from neuralstyletransferv1_tpu.models import transformer_net_nst as jtnn
from neuralstyletransferv1_torch.engine import stylizer as tst
from neuralstyletransferv1_torch.models import transformer_net as ttn
from neuralstyletransferv1_torch.models import transformer_net_nst as ttnn

GATE = 1e-2


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


def _pair(arch, seeds, preset):
    """(JAX StyleModels, the port's) of one random bank: JAX's init under
    jit, the trees carried across."""
    init, net_cls, from_jax = {
        "johnson": (jtn.init, ttn.TransformerNet, ttn.params_from_jax),
        "nst": (jtnn.init, ttnn.TransformerNetNST, ttnn.params_from_jax),
    }[arch]
    jms, tms = [], []
    for s in seeds:
        params = jax.jit(init)(jax.random.key(s))
        jms.append(jst.StyleModel(arch, params, preset, f"r{s}", "transformer"))
        net = net_cls()
        net.load_state_dict(from_jax(jax.tree.map(np.asarray, params)))
        tms.append(tst.StyleModel(arch, net.eval().requires_grad_(False), preset, f"r{s}"))
    return jms, tms


@pytest.fixture(scope="module")
def johnson():
    return _pair("johnson", (0, 1, 2), "raw_01")


@pytest.fixture(scope="module")
def nst():
    return _pair("nst", (3, 4), "raw_01")


def _x(hw, seed=1):
    return np.random.default_rng(seed).random((2,) + hw + (3,)).astype(np.float32)


@pytest.mark.parametrize("hw", [(32, 40), (30, 38), (6, 20)],
                         ids=["fast", "pad_and_crop", "h_below_8"])
def test_johnson_bank_matches_jax_f32(johnson, hw):
    """Both branches: the fast form (32×40), its reflect pad and crop
    (30×38) and the plain stylize below 8 rows (6×20: the net grows the
    rows to 8, resized back)."""
    jms, tms = johnson
    x = _x(hw)
    want = np.asarray(jst.jit_ladder_stylizer(jms)(jnp.asarray(x)))
    got = tst.jit_ladder_stylizer(tms)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 2) + hw + (3,) and got.dtype == np.float32
    d = np.abs(got - want)
    assert d.mean() <= 1e-5 and d.max() <= 1e-4
    assert want.std() > 0.05  # raw_01: the outputs spread over [0, 1]


def test_johnson_bank_matches_jax_bf16(johnson):
    jms, tms = johnson
    x = _x((30, 38), 2)
    want = np.asarray(jst.jit_ladder_stylizer(jms, dtype=jnp.bfloat16)(jnp.asarray(x)))
    got = tst.jit_ladder_stylizer(tms, dtype=torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).mean() <= GATE


def test_nst_bank_matches_jax(nst):
    """The weight ladder's real arch (NST_Train, ``raw_01``): the plain
    branch, not clipped again after the resize."""
    jms, tms = nst
    x = _x((30, 38), 3)
    want = np.asarray(jst.jit_ladder_stylizer(jms)(jnp.asarray(x)))
    got = tst.jit_ladder_stylizer(tms)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2, 30, 38, 3)
    assert np.abs(got - want).mean() <= 1e-5 and np.abs(got - want).max() <= 1e-4
    want16 = np.asarray(jst.jit_ladder_stylizer(jms, dtype=jnp.bfloat16)(jnp.asarray(x)))
    got16 = tst.jit_ladder_stylizer(tms, dtype=torch.bfloat16)(torch.from_numpy(x)).numpy()
    assert np.abs(got16 - want16).mean() <= GATE


def test_blend_outputs_matches_jax():
    outs = [_x((9, 11), s) * 3.0 - 1.0 for s in range(3)]  # the blend clips
    weights = [0.5, 2.0, 1.5]
    want = np.asarray(jst.blend_outputs([jnp.asarray(o) for o in outs], weights))
    got = tst.blend_outputs([torch.from_numpy(o) for o in outs], weights).numpy()
    assert np.abs(got - want).max() <= 1e-6
    assert got.min() == 0.0 and got.max() == 1.0


def test_stack_models_matches_jax_naming_and_errors(johnson, nst):
    jms, tms = johnson
    assert tst.stack_models(tms).name == jst.stack_models(jms).name == "bank[3]"
    for bad_j, bad_t in (([jms[0], nst[0][0]], [tms[0], nst[1][0]]),
                         ([jms[0], jst.StyleModel("johnson", jms[1].params, "raw_255", "x",
                                                  "transformer")],
                          [tms[0], tst.StyleModel("johnson", tms[1].net, "raw_255")])):
        with pytest.raises(ValueError, match="uniform arch/preset"):
            jst.stack_models(bad_j)
        with pytest.raises(ValueError, match="uniform arch/preset"):
            tst.stack_models(bad_t)
