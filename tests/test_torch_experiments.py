"""The port's bf16 megakernel experiments (``neuralstyletransferv1_torch/
experiments/``: K10 ``fused_conv``, K11 ``c1_site``, mk7 on K9e) against the
JAX package's experiment scripts, on the CPU.

The Pallas kernels of ``experiments/`` run only on a TPU (``fused_conv``
has no interpret switch), so the port's plain versions are held against
each script's own oracle for its kernel: ``mk1_fusedconv.xla_unit``, mk3's
and mk5's ``xla_unit`` (operands in the order x_pad, stat, w, cb), mk5's
``_prologue(..., "bf16")`` followed by the same conv, mk13's
``conv2d(y12, c1_w, c1_b)`` with the weights of ``from_johnson_params``, and
mk7's ``ref_path`` (a closure in its ``main``, rebuilt here from the same
JAX calls). The JAX references run eagerly, op by op: no FMA contraction of
the prologue.

Tolerances. Both sides multiply bf16 values (exact in f32) and accumulate
in f32 in their own order, so bf16 outputs differ by isolated ulps: every
element within 1 bf16 ulp, an ulp taken at no less than 2^-8 of the
tensor's largest magnitude, and at least 99% of them equal. mk13's oracle
(``ops/conv.py::conv2d`` with ``_NATIVE_BF16_OUT`` off) accumulates in f32,
adds the bf16 bias in f32 and rounds once, as K11 does. Sums: within 1e-5
relative (Σ² against itself, Σ against sqrt(n·Σ²)). The weight carry-over to
K11 is bit-exact.

The ``cuda`` cases hold the kernels against their plain versions on the card
at ragged shapes; they import no JAX, so that machine runs them with
``--noconftest``.
"""

import importlib
import json

import numpy as np
import pytest
import torch

from neuralstyletransferv1_torch.experiments import mk1_fusedconv as tmk1
from neuralstyletransferv1_torch.experiments import mk2_variants as tmk2
from neuralstyletransferv1_torch.experiments import mk3_variants as tmk3
from neuralstyletransferv1_torch.experiments import mk5_ablate as tmk5
from neuralstyletransferv1_torch.experiments import mk7_d3site as tmk7
from neuralstyletransferv1_torch.experiments import mk13_c1 as tmk13
from neuralstyletransferv1_torch.kernels import bf16_sites as k9

ENTRY_POINTS = ("mk1_fusedconv", "mk2_variants", "mk3_variants", "mk5_ablate", "mk7_d3site",
                "mk13_c1")


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card cases need no JAX."""
    import types

    import jax
    import jax.numpy as jnp

    from experiments import mk1_fusedconv, mk3_variants, mk5_ablate, mk13_c1
    from neuralstyletransferv1_tpu.models import transformer_net
    from neuralstyletransferv1_tpu.models import transformer_net_s2d as s2d1
    from neuralstyletransferv1_tpu.models import transformer_net_s2d2 as s2d2

    return types.SimpleNamespace(jax=jax, jnp=jnp, mk1=mk1_fusedconv, mk3=mk3_variants,
                                 mk5=mk5_ablate, mk13=mk13_c1, tn=transformer_net, s2d1=s2d1,
                                 s2d2=s2d2)


def _bf(a) -> np.ndarray:
    """Round to bf16, back as f32 numpy."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _fused_operands(seed, b=2, h=8, w=16, halo="random"):
    """mk1's operands at a small shape: x_pad [B,H+2,W+8,128] (``halo``
    "zero": the 1-pixel frame zero, the junk columns past W+2 random), stat
    with c > 0 on half the channels so an activated zero halo is nonzero."""
    rng = np.random.default_rng(seed)
    x = _bf(rng.normal(0, 1.0, (b, h + 2, w + 8, 128)))
    if halo == "zero":
        x[:, [0, h + 1]] = 0
        x[:, :, [0, w + 1]] = 0
    stat = np.stack([rng.normal(0, 1.0, (b, 128)), rng.normal(0.05, 0.3, (b, 128))],
                    1).astype(np.float32)
    return {"x_pad": x, "stat": stat, "w": _bf(rng.normal(0, 0.05, (3, 3, 128, 128))),
            "cb": np.asarray(rng.normal(0, 1.0, 128), np.float32), "hw": (h, w)}


def _port_fused(op, **kw):
    t = torch.from_numpy
    return k9.fused_conv(t(op["x_pad"]).to(torch.bfloat16), t(op["stat"]),
                         t(op["w"].reshape(9, 128, 128)).to(torch.bfloat16), t(op["cb"]),
                         op["hw"], **kw)


def _assert_close_bf16(ours: torch.Tensor, ref):
    r = torch.from_numpy(np.array(ref, np.float32))
    assert ours.shape == r.shape, (ours.shape, r.shape)
    worst, equal = k9.bf16_ulp_error(ours, r)
    assert worst <= 1.0 and equal >= 0.99, (worst, equal)


def _assert_sums_close(sums: torch.Tensor, ref, n: int, tol: float = 1e-5):
    got, want = sums.numpy().astype(np.float64), np.asarray(ref, np.float64)
    s2 = np.abs(want[:, 1])
    assert np.all(np.abs(got[:, 1] - want[:, 1]) <= tol * s2)
    assert np.all(np.abs(got[:, 0] - want[:, 0]) <= tol * np.sqrt(n * s2))


# ---------------------------------------------------------------------------
# K10 fused_conv: the plain version against mk1/mk3/mk5's xla_unit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("halo", ["random", "zero"])
@pytest.mark.parametrize("script,prologue", [("mk1", "f32"), ("mk1", "none"), ("mk3", "f32"),
                                             ("mk5", "f32")])
def test_k10_matches_xla_unit(jx, script, prologue, halo):
    """K10's f32 and none forms against the script's XLA unit on the same
    (B, H+2, W+8, C) buffer. A zero halo with c > 0 activates to max(c, 0):
    the prologue is applied to every position read, the halo included."""
    op = _fused_operands(7, halo=halo)
    jnp = jx.jnp
    x, w = jnp.asarray(op["x_pad"], jnp.bfloat16), jnp.asarray(op["w"], jnp.bfloat16)
    stat, cb = jnp.asarray(op["stat"]), jnp.asarray(op["cb"])
    if script == "mk1":
        yr, sr = jx.mk1.xla_unit(x, w, cb, stat,
                                 prologue="affine_relu" if prologue == "f32" else "none")
    else:
        yr, sr = getattr(jx, script).xla_unit(x, stat, w, cb[None])
    y, s = _port_fused(op, prologue=prologue)
    _assert_close_bf16(y, yr)
    _assert_sums_close(s, sr, 8 * 16)
    if halo == "zero" and prologue == "f32":  # the activated halo reaches the border outputs
        op["x_pad"][:, 0] = -1e3
        y_neg, _ = _port_fused(op, prologue=prologue)
        assert not torch.equal(y_neg[:, 0], y[:, 0])


@pytest.mark.parametrize("halo", ["random", "zero"])
def test_k10_bf16_prologue_matches_mk5(jx, halo):
    """mk5's ``bp``: its ``_prologue(x, stat, "bf16")`` (x·bf16(a) → bf16,
    + bf16(c) → bf16, max 0), then mk1's unit on the activated buffer with
    no prologue."""
    op = _fused_operands(11, halo=halo)
    jnp = jx.jnp
    x = jnp.asarray(op["x_pad"], jnp.bfloat16)
    stat = jnp.asarray(op["stat"])
    xn = jnp.stack([jx.mk5._prologue(x[i], stat[i:i + 1], "bf16") for i in range(x.shape[0])])
    yr, sr = jx.mk1.xla_unit(xn, jnp.asarray(op["w"], jnp.bfloat16), jnp.asarray(op["cb"]), stat,
                             prologue="none")
    y, s = _port_fused(op, prologue="bf16")
    _assert_close_bf16(y, yr)
    _assert_sums_close(s, sr, 8 * 16)


def test_k10_without_statistics():
    """mk5's ``ns``: the same output, no sums."""
    op = _fused_operands(3)
    y, s = _port_fused(op)
    y_ns, s_ns = _port_fused(op, stats=False)
    assert s_ns is None and s.shape == (2, 2, 128)
    assert torch.equal(y, y_ns)


def test_k10_reads_only_the_padded_tile():
    """The columns of x_pad past W+2 never reach the output."""
    op = _fused_operands(5)
    y, s = _port_fused(op)
    op["x_pad"][:, :, op["hw"][1] + 2:] = np.nan
    y2, s2 = _port_fused(op)
    assert torch.equal(y, y2) and torch.equal(s, s2)


def test_k10_rejects_an_unknown_prologue():
    with pytest.raises(ValueError, match="prologue"):
        _port_fused(_fused_operands(0), prologue="affine_relu")


# ---------------------------------------------------------------------------
# K11 c1_site: the plain version against mk13's oracle; the weights carried
# ---------------------------------------------------------------------------


def _johnson_params(jx, source):
    """A full Johnson param tree (numpy): the JAX ``transformer_net.init``
    (mk13's) or the repository's ``_testdata/test_johnson.pth``."""
    if source == "init":
        return jx.jax.tree.map(np.asarray, jx.tn.init(jx.jax.random.key(0)))
    from neuralstyletransferv1_torch.io.checkpoints import import_transformer, load_state_dict

    return import_transformer(load_state_dict(str(tmk13.CKPT)))


@pytest.mark.parametrize("source", ["init", "ckpt"])
def test_k11_weights_match_from_johnson_params(jx, source):
    """``block_conv1_weights`` is ``from_johnson_params``' c1_w / c1_b cast
    to bf16, bit for bit."""
    params = _johnson_params(jx, source)
    bp = jx.s2d2.from_johnson_params(params)
    w, cb = tmk13.block_conv1_weights(params["conv1"]["w"], params["conv1"]["b"])
    jw = np.asarray(bp["c1_w"].astype(jx.jnp.bfloat16).astype(jx.jnp.float32))
    jb = np.asarray(bp["c1_b"].astype(jx.jnp.bfloat16).astype(jx.jnp.float32))
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (5, 5, 12, 128)
    assert np.array_equal(w.float().numpy(), jw)
    assert cb.dtype == torch.float32 and np.array_equal(cb.numpy(), jb)


@pytest.mark.parametrize("b,h,w", [(1, 16, 32), (2, 12, 20)])
def test_k11_matches_mk13_oracle(jx, b, h, w):
    """K11 on mk13's block input against its oracle ``conv2d(y12, c1_w,
    c1_b)`` (bf16 weights from ``from_johnson_params``); the port's y12 is
    mk13's ``mk_x12`` bit for bit."""
    jnp = jx.jnp
    params = _johnson_params(jx, "init")
    bp = jx.jax.tree.map(lambda a: a.astype(jnp.bfloat16), jx.s2d2.from_johnson_params(params))
    x01 = _bf(np.random.default_rng(b * h).random((b, h, w, 3)))
    yj = jx.s2d2._pad_reflect_f2_4px(jx.s2d1.s2d(jnp.asarray(x01, jnp.bfloat16), 2), 3)
    from neuralstyletransferv1_tpu.ops.conv import conv2d

    ref = conv2d(yj, bp["c1_w"], bp["c1_b"])
    y12 = tmk13.block_input(torch.from_numpy(x01).to(torch.bfloat16))
    assert np.array_equal(y12.float().numpy(), np.asarray(yj.astype(jnp.float32)))
    wb, cb = tmk13.block_conv1_weights(params["conv1"]["w"], params["conv1"]["b"])
    out = k9.c1_site(y12, wb, cb)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (b, h // 2, w // 2, 128)
    _assert_close_bf16(out, ref.astype(jnp.float32))


# ---------------------------------------------------------------------------
# mk7 on K9e; the entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [tmk7.SMALL, (2, 6, 9)])
def test_mk7_rows_match_ref_path(jx, shape):
    """The entry's K9e call (plain version here) against mk7's ``ref_path``:
    phase-reflect pad, f32 prologue, 1×5 conv to 60 lanes, bf16."""
    jnp, lax = jx.jnp, jx.jax.lax
    ins = tmk7.inputs(shape, 4, torch.device("cpu"))
    x = jnp.asarray(ins["x"].float().numpy(), jnp.bfloat16)
    st = jnp.asarray(ins["stat"].numpy())
    w_row = jnp.asarray(ins["w_row"].float().numpy(), jnp.bfloat16)
    xp = jx.s2d2._pad_reflect_f2_4px(x, 32)
    xn = jnp.maximum(xp.astype(jnp.float32) * st[:, 0, None, None, :] + st[:, 1, None, None, :],
                     0.0).astype(jnp.bfloat16)
    ref = lax.conv_general_dilated(xn, w_row, (1, 1), "VALID",
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                   preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    rows = tmk7.rows(ins["x"], ins["stat"], ins["w_row"])
    b, h, w = shape
    assert tuple(rows.shape) == (b, h + 4, w, 60)
    _assert_close_bf16(rows, ref.astype(jnp.float32))


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_runs_on_cpu(name, capsys):
    """Each entry point at its small shape on the plain versions: one JSON
    line, its checks passed, no time (a CPU run measures no device); mk5's
    default run takes K10's six forms."""
    mod = importlib.import_module(f"neuralstyletransferv1_torch.experiments.{name}")
    rec = mod.main(["--device", "cpu", "--small"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == rec
    assert rec["experiment"] == name and rec["device"] == "cpu"
    for r in rec.get("variants", [rec]):
        assert r["worst_ulp"] == 0.0 and r["equal_share"] == 1.0
        assert "ms" not in r and "bound_ms" not in r
    if name == "mk5_ablate":
        assert len({(r["prologue"], r["stats"]) for r in rec["variants"]}) == 6


def test_variants_take_their_forms():
    """mk2/mk3 tile one function (the f32 form with sums); mk5's np, ns and
    bp change it, npns and bpns set two switches: six forms in all; mk1's
    prologue switch is its none form."""
    for mod in (tmk2, tmk3):
        assert {v[:2] for v in mod.VARIANTS.values()} == {("f32", True)}
    forms = {k: v[:2] for k, v in tmk5.VARIANTS.items()}
    assert len(set(forms.values())) == 6
    assert forms.pop("np") == ("none", True) and forms.pop("ns") == ("f32", False)
    assert forms.pop("bp") == ("bf16", True)
    assert forms.pop("npns") == ("none", False) and forms.pop("bpns") == ("bf16", False)
    assert set(forms) == {"t0", "t1", "t2", "x3", "na"}
    assert set(forms.values()) == {("f32", True)}
    assert tmk1.VARIANTS["noprologue"][:2] == ("none", True)


def test_cpu_tensors_take_the_plain_versions():
    op = _fused_operands(2)
    before = dict(k9.LAUNCHES)
    y, s = _port_fused(op, prologue="bf16")
    t = torch.from_numpy
    yp, sp = k9.fused_conv_plain(t(op["x_pad"]).to(torch.bfloat16), t(op["stat"]),
                                 t(op["w"].reshape(9, 128, 128)).to(torch.bfloat16), t(op["cb"]),
                                 op["hw"], prologue="bf16")
    y12 = torch.randn(1, 9, 13, 12).to(torch.bfloat16)
    wb, cb = torch.randn(5, 5, 12, 128).to(torch.bfloat16), torch.randn(128)
    assert torch.equal(k9.c1_site(y12, wb, cb), k9.c1_site_plain(y12, wb, cb))
    assert k9.LAUNCHES == before
    assert torch.equal(y, yp) and torch.equal(s, sp)


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain versions at ragged shapes
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K10 and K11 are CUDA kernels with no CPU mode)")
    from neuralstyletransferv1_torch.device import resolve_device

    return resolve_device("cuda")


def _on(op, dev):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (t(op["x_pad"]).to(torch.bfloat16), t(op["stat"]),
            t(op["w"].reshape(9, 128, 128)).to(torch.bfloat16), t(op["cb"]))


@pytest.mark.cuda
@pytest.mark.parametrize("prologue", ["f32", "none", "bf16"])
@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("b,h,w,junk", [(2, 13, 37, 6), (1, 8, 32, 0)])
def test_k10_matches_plain_on_card(cuda_device, prologue, stats, b, h, w, junk):
    """K10 in every form at a ragged grid (partial 8×32 tiles) and at one
    whose x_pad is exactly (H+2) × (W+2): two launches bit-identical, within
    1 ulp of the plain version and 99% equal, sums within 1e-5."""
    from neuralstyletransferv1_torch.experiments import _bench

    op = _fused_operands(b * h + w, b=b, h=h, w=w, halo="zero")
    op["x_pad"] = op["x_pad"][:, :, :w + 2 + junk]
    args = _on(op, cuda_device)
    before = k9.LAUNCHES["fused_conv"]
    (y, s), (y2, s2) = (k9.fused_conv(*args, (h, w), prologue=prologue, stats=stats)
                        for _ in range(2))
    yr, sr = k9.fused_conv_plain(*args, (h, w), prologue=prologue, stats=stats)
    torch.cuda.synchronize()
    assert k9.LAUNCHES["fused_conv"] - before == 2
    _bench.check("fused_conv", y, y2, yr, sums=s, sums_again=s2, sums_ref=sr)
    assert (s is None) == (not stats)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(2, 13, 45), (1, 16, 64), (3, 5, 7)])
def test_k11_matches_plain_on_card(cuda_device, b, h, w):
    """K11 at ragged block grids (partial 8×32 tiles, a grid smaller than a
    tile) with the repository's Johnson conv1."""
    from neuralstyletransferv1_torch.experiments import _bench

    wb, cb = tmk13.block_conv1_weights(*tmk13.conv1_params(tmk13.CKPT))
    rng = np.random.default_rng(h * w)
    x01 = torch.from_numpy(rng.random((b, 2 * h, 2 * w, 3), dtype=np.float32))
    y12 = tmk13.block_input(x01.to(cuda_device).to(torch.bfloat16))
    wb, cb = wb.to(cuda_device), cb.to(cuda_device)
    before = k9.LAUNCHES["c1_site"]
    out, again = k9.c1_site(y12, wb, cb), k9.c1_site(y12, wb, cb)
    torch.cuda.synchronize()
    assert k9.LAUNCHES["c1_site"] - before == 2
    assert tuple(out.shape) == (b, h, w, 128)
    _bench.check("c1_site", out, again, k9.c1_site_plain(y12, wb, cb))


@pytest.mark.cuda
def test_k10_k11_reject_bad_inputs(cuda_device):
    x, stat, w9, cb = _on(_fused_operands(1), cuda_device)
    with pytest.raises(ValueError, match="at least"):
        k9.fused_conv(x, stat, w9, cb, (9, 16))
    with pytest.raises(ValueError, match="C=64"):
        k9.fused_conv(x[..., :64].contiguous(), stat, w9, cb, (8, 16))
    with pytest.raises(TypeError, match="bfloat16"):
        k9.fused_conv(x.float(), stat, w9, cb, (8, 16))
    with pytest.raises(ValueError, match="expected cuda"):
        k9.fused_conv(x, stat.cpu(), w9, cb, (8, 16))
    y12 = torch.zeros((1, 9, 13, 12), dtype=torch.bfloat16, device=cuda_device)
    w = torch.zeros((5, 5, 12, 128), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="12 channels"):
        k9.c1_site(y12[..., :6].contiguous(), w, cb)
    with pytest.raises(ValueError, match="16-byte"):
        k9.c1_site(torch.zeros(1 + 9 * 13 * 12, dtype=torch.bfloat16,
                               device=cuda_device)[1:].view(1, 9, 13, 12), w, cb)


@pytest.mark.cuda
def test_k10_k11_seat_two_blocks_a_sm(cuda_device):
    """The designs' occupancy: K11's previous core stages its 5 packed
    kernel rows (92 KB), K10's previous core one tap of weights (115 KB):
    two blocks a SM each; K10's and K11's cores are one persistent block a
    SM (K10: two input tiles and three weight slabs in flight, 217 KB; K11:
    the five kernel rows' weights resident, four output buffers and 30
    input rows, 199 KB)."""
    occ = k9.occupancy()
    assert occ["c1_site_prev"][0] == 2 and occ["fused_conv_prev"][0] == 2, occ
    assert occ["fused_conv"][0] == 1 and occ["c1_site"][0] == 1, occ
