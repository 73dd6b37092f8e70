"""The float32 forms on the card: K4's 2×2 forms (pads 1 and 0, the latter
with and without ``sw``), K2 at C = 192 → CO = 384 (IN and FRN emits) and
K8a, each with an f32 x that is not bf16-representable, bit for bit against
its plain version at ragged shapes, two launches bit-identical, each
counted under its own name in ``F32_LAUNCHES``; K9a and K9e with an f32 raw
within 1 bf16 ulp of their plain versions (``chip_smoke.check_bf16_site``);
the forms that are not built refused; then the float32 chains and sites of
the NST_Train, Torch7, ReCoNet and Johnson slices card against CPU
(``chip_smoke.f32_chains_phase``, at a crop).

This file imports no JAX: it runs on the card's machine with
``--noconftest``, and its cases skip where no GPU is visible.
"""

import pytest
import torch

import chip_smoke
from neuralstyletransferv1_torch.kernels import bf16_sites as k9
from neuralstyletransferv1_torch.kernels import int8_sites as k8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from neuralstyletransferv1_torch.device import resolve_device

    return resolve_device("cuda")


def _raise(msg):
    raise AssertionError(msg)


def _check(fn, plain, form, label, n):
    """Two launches bit-identical, equal to the plain version (sums within
    ``chip_smoke.SUM_TOL``), each counted once under ``form``."""
    before = dict(k8.F32_LAUNCHES)
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert k8.F32_LAUNCHES[form] == before[form] + 2, label
    assert {k: v for k, v in k8.F32_LAUNCHES.items() if k != form} == \
        {k: v for k, v in before.items() if k != form}, label
    assert chip_smoke._same(a, b), label
    chip_smoke.check_site(label, a, plain(), n)
    return a


# (pt, B, H, W, CO, sw): conv2's block form (128 -> 64, pad 1) and the k3
# deconv's (128 -> 256, pad 0), with and without sw, at grids off the tile
K4_2X2 = [(1, 2, 9, 21, 64, None), (1, 1, 17, 40, 64, None), (0, 2, 11, 40, 256, 36),
          (0, 3, 9, 24, 256, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("pt,b,h,w,co,sw", K4_2X2)
def test_k4_2x2_f32_matches_plain_on_card(cuda_device, monkeypatch, pt, b, h, w, co, sw):
    monkeypatch.setattr(chip_smoke, "fail", _raise)
    t = chip_smoke.f32_operand(chip_smoke.site_inputs(cuda_device, b, h, w, 128, co, h + w),
                               "res_site", h * w)
    kw = dict(halo="zero", kh=2, kw=2, pt=pt, pl_=pt, sw=sw)
    args = (t["x"], t["a"], t["c"], 0.0 if pt == 0 else -127.0, t["wk4"], t["ws"], t["bias"])
    out = _check(lambda: k8.res_site(*args, **kw), lambda: k8.res_site_plain(*args, **kw),
                 f"res_site_k2p{pt}_f32", f"K4 2x2 pad {pt} f32", h * (sw or w))
    assert out[0].dtype == torch.bfloat16
    # the f32 x is not the bf16-rounded one: rounding it first moves the raw
    rounded = k8.res_site(args[0].to(torch.bfloat16), *args[1:], **kw)[0]
    assert not torch.equal(rounded, out[0])


@pytest.mark.cuda
@pytest.mark.parametrize("frn", [False, True], ids=["in", "frn"])
@pytest.mark.parametrize("b,h,w", [(2, 9, 24), (1, 17, 40)])
def test_k2_co384_f32_matches_plain_on_card(cuda_device, monkeypatch, b, h, w, frn):
    monkeypatch.setattr(chip_smoke, "fail", _raise)
    t = chip_smoke.f32_operand(chip_smoke.site_inputs(cuda_device, b, h, w, 192, 384, 3 * h),
                               "res_site_s8o", w)
    kw = dict(halo="edge", qlo=-127.0, tau=t["tauo"]) if frn else dict(halo="edge")
    args = (t["x"], t["a"], t["c"], -127.0, t["wk"], t["ws"], t["bias"], t["qa"], t["qc"])
    out = _check(lambda: k8.res_site_s8o(*args, **kw), lambda: k8.res_site_s8o_plain(*args, **kw),
                 "res_site_s8o_co384_f32", f"K2 192->384 f32 {'frn' if frn else 'in'}", h * w)
    assert out.dtype == torch.int8 and bool((out < 0).any()) == frn and bool((out > 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(2, 18, 40), (1, 34, 66), (3, 16, 32)])
def test_k8a_f32_matches_plain_on_card(cuda_device, monkeypatch, b, h, w):
    monkeypatch.setattr(chip_smoke, "fail", _raise)
    t = chip_smoke.f32_operand(chip_smoke.site_inputs(cuda_device, b, h, w, 32, 64, h + 2 * w),
                               "c2_site", b * w)
    args = (t["x"], t["a"], t["c"], 0.0, t["wk"], t["ws"], t["bias"])
    before = dict(k8.LAUNCHES)
    out = _check(lambda: k8.c2_site(*args), lambda: k8.c2_site_plain(*args), "c2_site_f32",
                 "K8a f32", (h // 2) * (w // 2))
    assert k8.LAUNCHES == before  # the bf16 form's count stays
    assert out[0].dtype == torch.bfloat16 and tuple(out[0].shape) == (b, h // 2, w // 2, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["d2_site", "d3_rows"])
@pytest.mark.parametrize("b,h,w", [(2, 13, 37), (1, 24, 130)])
def test_k9_f32_raw_matches_plain_on_card(cuda_device, monkeypatch, name, b, h, w):
    """K9a and K9e with an f32 raw: within 1 bf16 ulp of the plain version,
    two launches bit-identical, counted under the f32 name; the bf16 form of
    the bf16-rounded raw is another function."""
    monkeypatch.setattr(chip_smoke, "fail", _raise)
    c = 64 if name == "d2_site" else 128
    args = chip_smoke.bf16_site_inputs(cuda_device, name, (b, h, w, c), seed=h * w)
    args[0] = chip_smoke.f32_raw(args[0], seed=b + h)
    fn, plain = getattr(k9, name), getattr(k9, f"{name}_plain")
    before, bf16_before = dict(k9.F32_LAUNCHES), dict(k9.LAUNCHES)
    out, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert k9.F32_LAUNCHES[f"{name}_f32"] == before[f"{name}_f32"] + 2
    assert k9.LAUNCHES == bf16_before
    chip_smoke.check_bf16_site(f"{name} f32", out, again, plain(*args), args)
    rounded = fn(args[0].to(torch.bfloat16), *args[1:])
    first = lambda o: o[0] if isinstance(o, tuple) else o  # noqa: E731
    assert not torch.equal(first(rounded), first(out))


@pytest.mark.cuda
def test_forms_outside_the_built_ones_raise(cuda_device):
    """K4's 2×2 f32 forms exist at C = 128 only; K3's 2×2 form takes no f32
    residual; K2's CO = 384 f32 form only under the edge halo; K8b, K9b-K9d
    and the previous cores take no f32 input."""
    t = chip_smoke.f32_operand(chip_smoke.site_inputs(cuda_device, 1, 8, 16, 64, 128, 1),
                               "res_site", 1)
    with pytest.raises(ValueError, match=r"no f32 form at C=64 with the zero halo \(k2p1\)"):
        k8.res_site(t["x"], t["a"], t["c"], -127.0, t["wk4"], t["ws"], t["bias"], halo="zero",
                    kh=2, kw=2, pt=1, pl_=1)
    with pytest.raises(NotImplementedError, match="no chain adds one"):
        k8.site_s8(t["codes"], t["wk4"], t["ws"], t["bias"], y=t["y"].float()[..., :64]
                   .repeat(1, 1, 1, 2).contiguous(), halo="zero", kh=2, kw=2, pt=0, pl_=0)
    r = chip_smoke.f32_operand(chip_smoke.site_inputs(cuda_device, 1, 8, 16, 192, 384, 2),
                               "res_site_s8o", 2)
    with pytest.raises(ValueError, match="no form"):
        k8.res_site_s8o(r["x"], r["a"], r["c"], -127.0, r["wk"], r["ws"], r["bias"], r["qa"],
                        r["qc"], halo="reflect")
    s = chip_smoke.site_inputs(cuda_device, 1, 16, 32, 64, 128, 3)
    with pytest.raises(TypeError, match="must be"):
        k8.c3_site(s["x"].float(), s["a"], s["c"], 0.0, s["wk"], s["ws"], s["bias"])
    args = chip_smoke.bf16_site_inputs(cuda_device, "d3_sum_site", (1, 12, 32, 128), seed=4)
    with pytest.raises(TypeError):
        k9.d3_sum_site(args[0].float(), *args[1:])
    args = chip_smoke.bf16_site_inputs(cuda_device, "d2_site", (1, 12, 32, 64), seed=5)
    with pytest.raises(TypeError, match="no form with an f32 x"):
        k9.d2_site_prev(args[0].float(), *args[1:])


@pytest.mark.cuda
def test_f32_chains_card_matches_cpu(cuda_device, tmp_path, monkeypatch):
    """``chip_smoke.f32_chains_phase``: the float32 chains of the new forms
    (NST_Train's and Torch7's c2_i8 and dec_i8, ReCoNet's dec_s8 on both
    nets, Johnson's head_i8 chain, tail and d3 sites) card against CPU on a
    256×480 crop, with their exact launch counts: bit-identical where every
    norm is static, within the chains' bound where norms are measured."""
    monkeypatch.setattr(chip_smoke, "fail", _raise)
    chip_smoke.f32_chains_phase(cuda_device, tmp_path)
