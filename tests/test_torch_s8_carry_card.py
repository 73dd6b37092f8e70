"""The s8 carries of Torch7 and ReCoNet on the card: ReCoNet's two decoder
forms (K2 at C = 192 → CO = 384 under the edge halo, IN and FRN emits; K3 at
C = 96 → 192 under the edge halo, a bare bf16 raw), each bit for bit against
its plain version at ragged grids and across two launches, counted under
its own name in ``FORM_LAUNCHES``, and refused outside its form; then the
static-norm chains card against CPU on the same inputs, bit for bit, with
their exact launch counts (``chip_smoke.py``'s phases, at a crop): Torch7's
``res_s8``, ``dec_s8`` and ``tail_s8`` on the BN graphs with k3 and k4
deconvs, ReCoNet's ``s8_sites`` (the s8 res chain, then ``dec_s8``) on the
IN and the FRN net.

This file imports no JAX: it runs on the card's machine with
``--noconftest``, and its cases skip where no GPU is visible.
"""

import pytest
import torch

import chip_smoke
from neuralstyletransferv1_torch.kernels import int8_sites as k8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from neuralstyletransferv1_torch.device import resolve_device

    return resolve_device("cuda")


def _ops(dev, b, h, w, c, co, seed):
    """Site operands on ``dev`` at realistic scales (codes across the int8
    range, f = acc·ws + bias of O(1)), with a TLU floor row on f·qa + qc."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0, lo=0.0):
        return (torch.rand(shape, generator=g) * scale + lo).to(dev).contiguous()

    codes = torch.randint(-127, 128, (b, h, w, c), generator=g, dtype=torch.int32)
    return {"x": (torch.randn((b, h, w, c), generator=g) * 2).to(torch.bfloat16).to(dev),
            "a": rnd(b, c, scale=35.0, lo=5.0), "c": rnd(b, c, scale=16.0, lo=-8.0),
            "wk": k8.pack_weights(torch.randint(-127, 128, (3, 3, c, co), generator=g,
                                                dtype=torch.int32).to(torch.int8)).to(dev),
            "ws": rnd(co, scale=1.5e-5, lo=0.5e-5) * (128 / c) ** 0.5,
            "bias": rnd(co, scale=0.4, lo=-0.2), "qa": rnd(co, scale=50.0, lo=10.0),
            "qc": rnd(co, scale=20.0, lo=-10.0), "tau": rnd(co, scale=20.0, lo=-20.0),
            "codes": codes.to(torch.int8).to(dev)}


def _check(fn, plain, form, label):
    """Two launches bit-identical, equal to the plain version, each counted
    once under ``form``."""
    before = dict(k8.FORM_LAUNCHES)
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert k8.FORM_LAUNCHES[form] == before[form] + 2, label
    assert {k: v for k, v in k8.FORM_LAUNCHES.items() if k != form} == \
        {k: v for k, v in before.items() if k != form}, label
    assert torch.equal(a, b), label
    ref = plain()
    assert torch.equal(a.cpu(), ref), (label, int((a.cpu() != ref).sum()))
    return a


def _cpu(t: dict) -> dict:
    return {k: v.cpu() for k, v in t.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("frn", [False, True], ids=["in", "frn"])
@pytest.mark.parametrize("b,h,w", [(2, 9, 24), (1, 17, 40)])
def test_k2_co384_matches_plain_on_card(cuda_device, b, h, w, frn):
    """K2 at C = 192 → CO = 384 under the edge halo (ReCoNet's d1 emitting
    d2's codes), the IN emit (floor 0) and the FRN emit (the (CO,) floor
    row, floor −127), at grids off the 8 × 16 tile."""
    t = _ops(cuda_device, b, h, w, 192, 384, 10 * h + frn)

    def call(fn, t):
        kw = dict(qlo=-127.0, tau=t["tau"]) if frn else {}
        return fn(t["x"], t["a"], t["c"], -127.0, t["wk"], t["ws"], t["bias"], t["qa"], t["qc"],
                  halo="edge", **kw)

    tc = _cpu(t)
    out = _check(lambda: call(k8.res_site_s8o, t), lambda: call(k8.res_site_s8o_plain, tc),
                 "res_site_s8o_co384", f"K2 192->384 {'frn' if frn else 'in'}")
    assert bool((out < 0).any()) == frn and bool((out > 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(2, 16, 32), (1, 19, 44)])
def test_k3_c96_matches_plain_on_card(cuda_device, b, h, w):
    """K3 at C = 96 → CO = 192 under the edge halo with a bare bf16 raw out
    (ReCoNet's d2 on the s8 carry), at grids off the 8 × 16 tile."""
    t = _ops(cuda_device, b, h, w, 96, 192, 7 * h)
    tc = _cpu(t)
    out = _check(lambda: k8.site_s8(t["codes"], t["wk"], t["ws"], t["bias"], halo="edge"),
                 lambda: k8.site_s8_plain(tc["codes"], tc["wk"], tc["ws"], tc["bias"],
                                          halo="edge"), "site_s8_c96", "K3 96->192")
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())


@pytest.mark.cuda
def test_forms_outside_the_built_ones_raise(cuda_device):
    """The two forms exist under the edge halo only, K3's without an
    epilogue step, K2's for a bf16 x (its f32 form is ROADMAP Queue 2's
    row 3)."""
    t = _ops(cuda_device, 1, 8, 16, 192, 384, 1)
    k2 = (t["x"], t["a"], t["c"], -127.0, t["wk"], t["ws"], t["bias"], t["qa"], t["qc"])
    with pytest.raises(ValueError, match="no form"):
        k8.res_site_s8o(*k2, halo="reflect")
    with pytest.raises(NotImplementedError, match="Queue 2 row 3"):
        k8.res_site_s8o(t["x"].float(), *k2[1:], halo="edge")
    t3 = _ops(cuda_device, 1, 8, 16, 96, 192, 2)
    k3 = (t3["codes"], t3["wk"], t3["ws"], t3["bias"])
    with pytest.raises(ValueError, match="no form"):
        k8.site_s8(*k3, halo="reflect")
    with pytest.raises(ValueError, match="epilogue"):
        k8.site_s8(*k3, t3["qa"], t3["qc"], halo="edge")
    with pytest.raises(ValueError, match="epilogue"):
        k8.site_s8(*k3, qa=t3["qa"], qc=t3["qc"], halo="edge")


def _raise(msg):
    raise AssertionError(msg)


@pytest.mark.cuda
def test_t7_s8_chains_card_matches_cpu(cuda_device, tmp_path, monkeypatch):
    """``chip_smoke.t7_forms_phase`` on the full-width eccv16 BN nets with
    k3 and k4 deconvs: ``res_s8`` (5 × K2 + 5 × K3), with ``dec_s8`` (2 ×
    K3: 2×2 pad 0 for k3, 3×3 for k4) and with ``tail_s8`` (+ K6), card
    against CPU bit for bit, with their exact launch counts."""
    monkeypatch.setattr(chip_smoke, "fail", _raise)
    chip_smoke.t7_forms_phase(cuda_device, {
        norm: chip_smoke.t7_checkpoint(tmp_path / f"eccv16_{norm.replace(' ', '_')}.t7", norm)
        for norm in ("bn", "bn k4")})


@pytest.mark.cuda
@pytest.mark.parametrize("frn", [False, True], ids=["in", "frn"])
def test_reco_s8_sites_card_matches_cpu(cuda_device, tmp_path, monkeypatch, frn):
    """ReCoNet's ``s8_sites`` chains (the s8 res chain, 4 × K2 + 4 × K3,
    then ``dec_s8``: K2 at CO = 384 and K3 at C = 96) on a seeded full-width
    net with frozen norms, from one res-chain input of a 256×480 crop, card
    against CPU bit for bit, with their exact launch counts."""
    import copy

    from neuralstyletransferv1_torch.engine import stylizer as st
    from neuralstyletransferv1_torch.models import io_presets as iop
    from neuralstyletransferv1_torch.models import reconet_fast as rf

    monkeypatch.setattr(chip_smoke, "fail", _raise)
    ckpt = chip_smoke.reco_checkpoint(tmp_path / "reco.pth", frn)
    model = st.load_model(ckpt, model_type="reconet", device=cuda_device)
    ch, cw = chip_smoke.RECO_CROP
    frame = chip_smoke.moving_frames(1, ch, cw, 5)[0]
    x = iop.preprocess(model.io_preset,
                       torch.from_numpy(frame[None]).to(cuda_device).float() / 255.0)
    fp32 = rf.FastReCoNet(model.net)
    stats = rf.calibrate_in_stats(fp32, x)
    quant = rf.quantize_net(fp32, rf.calibrate_act_scales(fp32, x, static_stats=stats))
    fpb = copy.deepcopy(fp32).to(torch.bfloat16)
    grab = {}
    with torch.no_grad():
        rf.apply(fpb, x.to(torch.bfloat16), static_stats=stats,
                 tap=lambda k, t: grab.setdefault(k, t.contiguous()))

    def inputs(d):
        fpd = copy.deepcopy(fpb).to(d)
        st_d = {k: (m.to(d), inv.to(d)) for k, (m, inv) in stats.items()}
        return {"fp": fpd, "st": st_d, "sites": rf.prepare_sites(fpd, quant, d),
                "y": grab["r0a"].to(d)}

    def s8_sites(o):
        yr = rf.res_chain_s8_static(o["y"], o["fp"], o["sites"], o["st"])
        return rf.dec_s8_static(yr, o["fp"], o["sites"], o["st"])

    chip_smoke._chains_card_vs_cpu(cuda_device, f"ReCoNet {'FRN' if frn else 'IN'}", {
        "s8_sites": (s8_sites, chip_smoke.RECO_S8_PER_BATCH, True)}, inputs)
