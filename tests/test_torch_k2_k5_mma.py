"""K2 (``res_site_s8o``) and K5 (``res_site_skip``) of the PyTorch port vs the
JAX package, on the CPU, in the forms their tensor-core kernels take.

On the card K2 and K5 run on the int8 tensor-core core (``mma_kernel``),
held bit for bit against their plain versions by ``tests/test_torch_policy.py``
(``-m cuda``). Here the plain versions meet the interpret-mode Pallas kernels
of ``models/s2d2_sites_i8.py``: K5 in Johnson's d1 form (CO = 2C, edge halo,
no v out), and both at sizes that are not multiples of the kernels' 8×16
output tile. CPU tensors take the plain versions, and the previous
``__dp4a`` forms refuse them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
from neuralstyletransferv1_torch.kernels import int8_sites as k8


def _inputs(seed, b, h, w, c, co):
    """Random site operands, bf16-representable where the site reads bf16."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {
        "x": bf(rng.normal(0, 2, (b, h, w, c))), "y": bf(rng.normal(0, 1, (b, h, w, c))),
        "a": f32(rng.uniform(5, 40, (b, c))), "c": f32(rng.normal(0, 8, (b, c))),
        "a2": f32(rng.uniform(0.5, 1.5, (b, c))), "c2": f32(rng.normal(0, 0.3, (b, c))),
        "w": rng.integers(-127, 128, (3, 3, c, co)).astype(np.int8),
        "ws": f32(rng.uniform(0.5, 2, co) / (127 * 127 * 12)), "bias": f32(rng.normal(0, 0.2, co)),
        "qa": f32(rng.uniform(10, 60, co)), "qc": f32(rng.normal(0, 10, co)),
    }


def _jax(d, k):
    v = d[k]
    if k in ("x", "y"):
        return jnp.asarray(v, jnp.bfloat16)
    if k == "w":
        return jnp.asarray(v).reshape(9, v.shape[2], v.shape[3])
    return jnp.asarray(v)


def _torch(d, k):
    v = torch.from_numpy(d[k].copy())
    if k in ("x", "y"):
        return v.to(torch.bfloat16)
    return k8.pack_weights(v) if k == "w" else v


def _interpret(fn, *args, **kw):
    si8._INTERPRET = True
    try:
        return jax.tree.map(np.asarray, fn(*args, **kw))
    finally:
        si8._INTERPRET = False


def _bf16_ordered(v):
    """bf16 values → integers ordered like the values (1 apart = 1 ulp)."""
    bits = np.asarray(jnp.asarray(v, jnp.bfloat16).view(jnp.int16)).astype(np.int32)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def _assert_bf16_close(ours: torch.Tensor, ref):
    """Within 1 bf16 ulp at >= 99.9% of elements and never more than 2
    (interpret-mode Pallas lets XLA contract a product and a sum into an
    FMA where the port rounds the product, as tests/test_torch_int8.py
    documents)."""
    d = np.abs(_bf16_ordered(ours.float().numpy()) - _bf16_ordered(np.asarray(ref, np.float32)))
    assert (d <= 1).mean() >= 0.999 and d.max() <= 2, (d.max(), (d > 1).mean())


def _assert_codes_close(ours: torch.Tensor, ref):
    """Codes equal at >= 99.9% of elements, never more than 1 apart (the
    isolated FMA flips above move a code by one)."""
    d = np.abs(ours.numpy().astype(np.int32) - np.asarray(ref).astype(np.int32))
    assert (d == 0).mean() >= 0.999 and d.max() <= 1, (d.max(), (d > 0).mean())


def _assert_sums_close(sums: torch.Tensor, ours: torch.Tensor, sout, ref, n: int):
    """[Σ, Σ²] within 1e-5 relative of the Pallas sums, after moving those
    by what the outputs' isolated 1-ulp flips change: Σ² against itself, Σ
    against the magnitude sum it could cancel from (at most sqrt(n·Σ²))."""
    def exact(v):
        v = np.asarray(v, np.float64)
        return np.stack([v.sum(axis=(1, 2)), (v * v).sum(axis=(1, 2))], axis=1)

    got = sums.numpy().astype(np.float64)
    want = (np.asarray(sout, np.float64) + exact(ours.float().numpy())
            - exact(np.asarray(ref, np.float32)))
    s2 = np.abs(want[:, 1])
    assert np.all(np.abs(got[:, 1] - want[:, 1]) <= 1e-5 * s2)
    assert np.all(np.abs(got[:, 0] - want[:, 0]) <= 1e-5 * np.sqrt(n * s2))


def _k5(d, lo, halo, yout):
    """K5 by the Pallas kernel (interpret mode) and by the port's wrapper
    on CPU tensors."""
    ref = _interpret(si8.res_site_skip, _jax(d, "x"), _jax(d, "y"),
                     *(_jax(d, k) for k in ("a", "c", "a2", "c2", "w", "ws", "bias")), lo,
                     halo=halo, yout=yout)
    ours = k8.res_site_skip(*(_torch(d, k) for k in ("x", "y", "a", "c", "a2", "c2")), lo,
                            *(_torch(d, k) for k in ("w", "ws", "bias")), halo=halo, yout=yout)
    return ref, ours


@pytest.mark.parametrize("lo", [-127.0, 0.0])
def test_k5_d1_form_matches_pallas(lo):
    """K5 as Johnson's d1 runs it: CO = 2C, the edge halo, no v out (the
    Pallas kernel's v is then a dummy row)."""
    b, h, w, c = 1, 8, 16, 32
    d = _inputs(11, b, h, w, c, 2 * c)
    (ref, sout, _), (ours, sums, v) = _k5(d, lo, "edge", False)
    assert v is None
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (b, h, w, 2 * c)
    _assert_bf16_close(ours, ref)
    _assert_sums_close(sums, ours, sout, ref, h * w)


# sizes off the 8×16 output tile that the Pallas kernels take (H a multiple
# of one of their row-strip heights): (B, H, W, C, CO, halo)
_OFF_TILE = [(2, 10, 20, 32, 32, "reflect"), (1, 12, 24, 32, 64, "edge")]


@pytest.mark.parametrize("b,h,w,c,co,halo", _OFF_TILE)
def test_k5_off_tile_matches_pallas(b, h, w, c, co, halo):
    d = _inputs(12 + h, b, h, w, c, co)
    (ref, sout, vref), (ours, sums, v) = _k5(d, -127.0, halo, True)
    assert tuple(v.shape) == (b, h, w, c)
    _assert_bf16_close(v, vref)
    _assert_bf16_close(ours, ref)
    _assert_sums_close(sums, ours, sout, ref, h * w)


@pytest.mark.parametrize("b,h,w,c,co,halo", _OFF_TILE)
def test_k2_off_tile_matches_pallas(b, h, w, c, co, halo):
    d = _inputs(13 + h, b, h, w, c, co)
    ref = _interpret(si8.res_site_s8o, _jax(d, "x"), _jax(d, "a"), _jax(d, "c"), _jax(d, "w"),
                     _jax(d, "ws"), _jax(d, "bias"), qa=_jax(d, "qa"), qc=_jax(d, "qc"),
                     lo=-127.0, qlo=0.0, halo=halo)
    ours = k8.res_site_s8o(*(_torch(d, k) for k in ("x", "a", "c")), -127.0,
                           *(_torch(d, k) for k in ("w", "ws", "bias", "qa", "qc")), halo=halo)
    assert ours.dtype == torch.int8 and tuple(ours.shape) == (b, h, w, co)
    _assert_codes_close(ours, ref[:, :, 1:w + 1])  # the Pallas carry's content columns


def test_k2_zero_halo_off_tile_matches_pallas():
    """K2 in the NST chain's form off the tile: the zero halo, the content
    width sw = 18 of a grid padded to 24."""
    b, h, w, c, sw = 1, 10, 24, 32, 18
    d = _inputs(14, b, h, w, c, c)
    ref = _interpret(si8.res_site_s8o, _jax(d, "x"), _jax(d, "a"), _jax(d, "c"), _jax(d, "w"),
                     _jax(d, "ws"), _jax(d, "bias"), qa=_jax(d, "qa"), qc=_jax(d, "qc"),
                     lo=-127.0, qlo=0.0, halo="zero", sw=sw)
    ours = k8.res_site_s8o(*(_torch(d, k) for k in ("x", "a", "c")), -127.0,
                           *(_torch(d, k) for k in ("w", "ws", "bias", "qa", "qc")),
                           halo="zero", sw=sw)
    assert not ours[:, :, sw:].any()
    _assert_codes_close(ours, ref[:, :, 1:w + 1])


def _cpu_args(c=64, co=64, b=2, h=9, w=20):
    d = _inputs(15, b, h, w, c, co)
    return {k: _torch(d, k) for k in d}


@pytest.mark.parametrize("name", ["res_site_s8o_prev", "res_site_skip_prev"])
def test_prev_forms_refuse_cpu_tensors(name):
    t = _cpu_args()
    if name == "res_site_s8o_prev":
        args = (t["x"], t["a"], t["c"], 0.0, t["w"], t["ws"], t["bias"], t["qa"], t["qc"])
    else:
        args = (t["x"], t["y"], t["a"], t["c"], t["a2"], t["c2"], 0.0, t["w"], t["ws"],
                t["bias"])
    before = dict(k8.LAUNCHES)
    with pytest.raises(NotImplementedError, match="no kernel for device cpu"):
        getattr(k8, name)(*args)
    assert k8.LAUNCHES == before


@pytest.mark.parametrize("form", ["k2", "k2_zero_sw", "k5", "k5_d1"])
def test_cpu_tensors_take_the_plain_versions(form):
    """On CPU tensors K2 and K5 return their plain versions' results and
    count no launch, at shapes and alignments the card's core would refuse
    or take (a view that starts 2 bytes off a 16-byte boundary included:
    only the card's core reads 16-byte chunks)."""
    t = _cpu_args(co=128 if form == "k5_d1" else 64)
    x = torch.empty(t["x"].numel() + 1, dtype=torch.bfloat16)[1:].view(t["x"].shape)
    x.copy_(t["x"])
    before = dict(k8.LAUNCHES)
    if form.startswith("k2"):
        kw = dict(halo="zero", sw=17) if form == "k2_zero_sw" else {}
        args = (x, t["a"], t["c"], -127.0, t["w"], t["ws"], t["bias"], t["qa"], t["qc"])
        got, want = k8.res_site_s8o(*args, **kw), k8.res_site_s8o_plain(*args, **kw)
        assert torch.equal(got, want)
    else:
        kw = dict(halo="edge", yout=False) if form == "k5_d1" else {}
        args = (x, t["y"], t["a"], t["c"], t["a2"], t["c2"], 0.0, t["w"], t["ws"], t["bias"])
        got, want = k8.res_site_skip(*args, **kw), k8.res_site_skip_plain(*args, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert (got[2] is None) == (form == "k5_d1")
        if got[2] is not None:
            assert torch.equal(got[2], want[2])
    assert k8.LAUNCHES == before
