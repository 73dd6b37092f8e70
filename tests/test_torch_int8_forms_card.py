"""The int8 kernel forms of the NST_Train and Torch7 int8 paths on the card:
K4's 2×2 block forms (pads 1 and 0), K4 and K5 with ``sw``, K3's 2×2 pad-0
form (bf16 out, and the ``zero2`` emit that K6 reads), each bit for bit
against its plain version at ragged grids and widths and across two
launches; then the NST chains (``c2_i8``, ``res_i8`` with measured norms,
``dec_i8``, ``dec_s8`` with the fused tail) and the Torch7 ``c2_i8`` /
``dec_i8`` branches card against CPU on the same inputs, bit for bit, with
their exact launch counts (``chip_smoke.py``'s phases, at a crop).

This file imports no JAX: it runs on the card's machine with
``--noconftest``, and its cases skip where no GPU is visible.
"""

import pytest
import torch

import chip_smoke
from neuralstyletransferv1_torch.kernels import int8_sites as k8

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from neuralstyletransferv1_torch.device import resolve_device

    return resolve_device("cuda")


def _ops(dev, b, h, w, c, co, taps, seed):
    """Site operands on ``dev`` at realistic scales (codes across the int8
    range, f = acc·ws + bias of O(1))."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0, lo=0.0):
        return (torch.rand(shape, generator=g) * scale + lo).to(dev).contiguous()

    def codes(*shape, lo=-127):
        return torch.randint(lo, 128, shape, generator=g, dtype=torch.int32).to(torch.int8)

    k = 2 if taps == 4 else 3
    return {"x": (torch.randn((b, h, w, c), generator=g) * 2).to(torch.bfloat16).to(dev),
            "y": torch.randn((b, h, w, c), generator=g).to(torch.bfloat16).to(dev),
            "a": rnd(b, c, scale=35.0, lo=5.0), "c": rnd(b, c, scale=16.0, lo=-8.0),
            "a2": rnd(b, c, scale=1.0, lo=0.5), "c2": rnd(b, c, scale=0.6, lo=-0.3),
            "wk": k8.pack_weights(codes(k, k, c, co)).to(dev),
            "ws": rnd(co, scale=1.5e-5, lo=0.5e-5), "bias": rnd(co, scale=0.4, lo=-0.2),
            "qa": rnd(co, scale=50.0, lo=10.0), "qc": rnd(co, scale=20.0, lo=-10.0),
            "codes": codes(b, h, w, c, lo=0).to(dev)}


def _same(card, cpu_out, label):
    """Card and plain outputs bit for bit (sums within f32 summation order)."""
    card = card if isinstance(card, tuple) else (card,)
    cpu_out = cpu_out if isinstance(cpu_out, tuple) else (cpu_out,)
    for o, r in zip(card, cpu_out):
        if o is None:
            continue
        o = o.cpu()
        if o.dtype == torch.float32:
            torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-2)
        else:
            assert torch.equal(o, r), (label, int((o != r).sum()))


def _check(fn, plain, label):
    """Two launches bit-identical, and equal to the plain version."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    a_, b_ = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
    assert all(x is None or torch.equal(x, y) for x, y in zip(a_, b_)), label
    _same(a, plain(), label)
    return a


def _cpu(t: dict) -> dict:
    return {k: v.cpu() for k, v in t.items()}


# K4's 2×2 forms: (B, H, W, C, CO, pt, sw): conv2's at pad 1, 128 → 64 (NST,
# eccv16 at c0 = 32) and 64 → 64; the decoders' at pad 0, 128 → 256 and 64 →
# 128, with and without sw
K4_2X2 = [(2, 13, 40, 128, 64, 1, None), (3, 9, 24, 64, 64, 1, None),
          (2, 11, 32, 128, 256, 0, 29), (1, 17, 48, 64, 128, 0, 46), (2, 8, 16, 64, 128, 0, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,co,pt,sw", K4_2X2)
def test_k4_2x2_matches_plain_on_card(cuda_device, b, h, w, c, co, pt, sw):
    t = _ops(cuda_device, b, h, w, c, co, 4, seed=h * w + pt)
    args = (t["x"], t["a"], t["c"], -127.0, t["wk"], t["ws"], t["bias"])
    kw = dict(halo="zero", kh=2, kw=2, pt=pt, pl_=pt, sw=sw)
    name = "res_site_k2p1" if pt else "res_site_k2p0"
    n0 = k8.FORM_LAUNCHES[name]
    tc = _cpu(t)
    _check(lambda: k8.res_site(*args, **kw),
           lambda: k8.res_site_plain(tc["x"], tc["a"], tc["c"], -127.0, tc["wk"], tc["ws"],
                                     tc["bias"], **kw), f"K4 2x2 pt {pt}")
    assert k8.FORM_LAUNCHES[name] == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("c,lo,w,sw", [(128, -127.0, 40, 37), (128, 0.0, 32, 29),
                                       (64, -127.0, 24, 21)])
def test_k4_sw_matches_plain_on_card(cuda_device, c, lo, w, sw):
    t = _ops(cuda_device, 2, 11, w, c, c, 9, seed=sw)
    t["x"][:, :, sw:] = 9.0  # junk the mask hides
    tc = _cpu(t)
    kw = dict(halo="zero", sw=sw)
    n0 = k8.FORM_LAUNCHES["res_site_sw"]
    _check(lambda: k8.res_site(t["x"], t["a"], t["c"], lo, t["wk"], t["ws"], t["bias"], **kw),
           lambda: k8.res_site_plain(tc["x"], tc["a"], tc["c"], lo, tc["wk"], tc["ws"],
                                     tc["bias"], **kw), "K4 sw")
    assert k8.FORM_LAUNCHES["res_site_sw"] == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("c,w,sw,yout", [(128, 40, 37, True), (64, 24, 19, False)])
def test_k5_sw_matches_plain_on_card(cuda_device, c, w, sw, yout):
    t = _ops(cuda_device, 2, 13, w, c, c, 9, seed=sw + 1)
    tc = _cpu(t)

    def call(k, fn):
        return fn(k["x"], k["y"], k["a"], k["c"], k["a2"], k["c2"], -127.0, k["wk"], k["ws"],
                  k["bias"], halo="zero", sw=sw, yout=yout)

    n0 = k8.FORM_LAUNCHES["res_site_skip_sw"]
    _check(lambda: call(t, k8.res_site_skip), lambda: call(tc, k8.res_site_skip_plain), "K5 sw")
    assert k8.FORM_LAUNCHES["res_site_skip_sw"] == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,co,sw,emit", [(2, 11, 32, 128, 256, 29, True),
                                                (2, 9, 48, 64, 128, 42, True),
                                                (1, 13, 40, 64, 128, None, False),
                                                (2, 8, 24, 64, 128, 21, False)])
def test_k3_2x2_matches_plain_on_card(cuda_device, b, h, w, c, co, sw, emit):
    """K3's 2×2 pad-0 form: NST dec_s8's d1 emit (128 → 256), d2's emit of
    deconv3's codes (``zero2``) and its bf16 raw; with an emit, K6 on the
    card's codes against its plain version."""
    t = _ops(cuda_device, b, h, w, c, co, 4, seed=w + c)
    if sw is not None:
        t["codes"][:, :, sw:] = 0
    tc = _cpu(t)
    kw = dict(halo="zero", kh=2, kw=2, pt=0, pl_=0, sw=sw)
    if emit:
        kw.update(qlo=0.0, halo_out="zero2" if co == 128 else None)
    n0 = k8.FORM_LAUNCHES["site_s8_k2p0"]

    def call(k, fn):
        rows = dict(qa=k["qa"] / 8, qc=k["qc"]) if emit else {}
        return fn(k["codes"], k["wk"], k["ws"], k["bias"], **kw, **rows)

    q = _check(lambda: call(t, k8.site_s8), lambda: call(tc, k8.site_s8_plain), "K3 2x2")
    assert k8.FORM_LAUNCHES["site_s8_k2p0"] == n0 + 2
    if emit and sw is not None:
        assert not q[:, :, sw:].any()
    if emit and co == 128:
        w5 = torch.randint(-127, 128, (1, 5, 128, 60), generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32).to(torch.int8)
        wk5 = k8.pack_weights(w5, co_pad=k8.CO_TILE)
        ws5 = torch.nn.functional.pad(torch.full((60,), 2.0 ** -17), (0, 4))
        b12 = torch.linspace(-0.2, 0.2, 12)
        out = k8.d3_s8_site(q, wk5.to(cuda_device), ws5.to(cuda_device), b12.to(cuda_device))
        _same(out, k8.d3_s8_site_plain(q.cpu(), wk5, ws5, b12), "K6 on K3's zero2 emit")


def _raise(msg):
    raise AssertionError(msg)


@pytest.mark.cuda
def test_nst_chains_card_matches_cpu(cuda_device, tmp_path, monkeypatch):
    """``chip_smoke.nst_forms_phase``: the NST chains of the new forms
    (``c2_i8``, ``res_i8`` with measured norms, ``dec_i8``, ``dec_s8`` with
    the fused tail) on a seeded full-width net, from one forward's inputs on
    a 256×480 crop of a 1080p frame, card against CPU bit for bit, with
    their exact launch counts."""
    monkeypatch.setattr(chip_smoke, "fail", _raise)
    chip_smoke.nst_forms_phase(cuda_device, chip_smoke.nst_checkpoint(tmp_path / "nst.pth"))


@pytest.mark.cuda
def test_t7_branches_card_matches_cpu(cuda_device, tmp_path, monkeypatch):
    """``chip_smoke.t7_forms_phase``: Torch7 ``c2_i8`` and ``dec_i8`` on the
    full-width eccv16 IN net (k3 deconvs) and BN net with k4 deconvs, card
    against CPU bit for bit, with their exact launch counts."""
    monkeypatch.setattr(chip_smoke, "fail", _raise)
    chip_smoke.t7_forms_phase(cuda_device, {
        norm: chip_smoke.t7_checkpoint(tmp_path / f"eccv16_{norm.replace(' ', '_')}.t7", norm)
        for norm in ("in", "bn k4")})
