"""K4 (``res_site``) and K3 (``site_s8``) at ReCoNet's widths (C = 192 and
96 input channels, bf16 operands) on their Hopper core,
``site_wgmma_kernel`` (``csrc/int8_wgmma.cu``): one block on all output
channels of an 8 × 16 tile, the tile's haloed input quantized once, the
weights streamed from L2 by tap into a ring of shared-memory slots, two
consumer warpgroups of ``wgmma`` m64n192k32.

On the CPU: the host-side contracts, each a Python mirror of what the
source does (``wgmma_weights``: the weight units in the layout the
consumers' no-swizzle descriptors read; ``wgmma_smem_bytes``: within the
232,448 bytes a block may take), and the wrappers' dispatch (CPU tensors
take the plain versions; the previous core, ``mma_kernel``, is a CUDA
timing form). The plain versions themselves are unchanged and are held to
the JAX package by tests/test_torch_reconet.py and
tests/test_torch_reco_dec_s8.py. The ``cuda`` cases import no JAX, so the
card's machine runs them with ``--noconftest``: every form bit for bit its
plain version and the previous core, at ragged shapes and at the 1080p B=8
grids, two launches bit-identical, sums within 1e-5 (``_bench.check``),
each launch counted where the wrapper counts it.
"""

import numpy as np
import pytest
import torch

from neuralstyletransferv1_torch.experiments import _bench
from neuralstyletransferv1_torch.kernels import int8_sites as k8
from neuralstyletransferv1_torch.kernels.int8_probes import SMEM_MAX


@pytest.mark.parametrize("c,co", [(192, 192), (192, 384), (96, 192)])
def test_wgmma_weights_are_the_consumers_units(c, co):
    """Unit (pass, tap, k) byte (j, n, i) is the weight of input channel
    96k + 16j + i for output channel 192·pass + n at tap (tap // 3,
    tap % 3): 16-byte core-matrix rows of one output channel, 192 of them a
    column, the unit's 6 columns of 16 input channels in order."""
    rng = np.random.default_rng(c + co)
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, c, co)).astype(np.int8))
    g = k8.wgmma_weights(k8.pack_weights(w))
    assert g.dtype == torch.int8 and g.is_contiguous()
    assert tuple(g.shape) == (co // 192, 9, c // 96, 6, 192, 16)
    want = w.reshape(9, c // 96, 6, 16, co // 192, 192).permute(4, 0, 1, 2, 5, 3)
    assert torch.equal(g, want)
    p, t, k, j, n, i = (int(v) for v in (rng.integers(co // 192), rng.integers(9),
                                          rng.integers(c // 96), rng.integers(6),
                                          rng.integers(192), rng.integers(16)))
    assert g[p, t, k, j, n, i] == w[t // 3, t % 3, 96 * k + 16 * j + i, 192 * p + n]


def test_wgmma_smem_mirror_fits_a_block():
    """The weight ring (4 slots of 18,432 bytes), two code buffers of the
    180-pixel haloed tile (C + 16 bytes a pixel), the 128 staged outputs
    (400 bytes a pixel), 8 epilogue rows of 384 f32, [Σ, Σ²] of 192
    channels for the 8 row warps (C = 192) or the 10 storing pixel groups
    (C = 96), 256 bytes of barriers; a fifth slot does not fit at
    C = 192."""
    assert k8.wgmma_smem_bytes(192) == 73728 + 74880 + 51200 + 12288 + 12288 + 256 == 224640
    assert k8.wgmma_smem_bytes(96) == 73728 + 40320 + 51200 + 12288 + 15360 + 256 == 193152
    assert k8.wgmma_smem_bytes(192) + 18432 > SMEM_MAX
    assert max(k8.wgmma_smem_bytes(c) for c in k8.WG_C) <= SMEM_MAX


def _operands(dev, b, h, w, c, co, seed):
    """Site operands at realistic scales: codes span the int8 range and
    f = acc·ws + bias is O(1); the TLU floor bites on a share of x·a + c."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0, lo=0.0):
        return (torch.rand(shape, generator=g, device=dev) * scale + lo).contiguous()

    def codes(*shape, lo=-127):
        return torch.randint(lo, 128, shape, generator=g, device=dev,
                             dtype=torch.int32).to(torch.int8)

    return {"x": (torch.randn((b, h, w, c), generator=g, device=dev) * 2).to(torch.bfloat16),
            "y": torch.randn((b, h, w, co), generator=g, device=dev).to(torch.bfloat16),
            "a": rnd(b, c, scale=35.0, lo=5.0), "c": rnd(b, c, scale=16.0, lo=-8.0),
            "tau": rnd(b, c, scale=20.0, lo=-10.0), "codes": codes(b, h, w, c, lo=0),
            "wk": k8.pack_weights(codes(3, 3, c, co)),
            "ws": rnd(co, scale=1.5e-5, lo=0.5e-5) * (128 / c) ** 0.5,
            "bias": rnd(co, scale=0.4, lo=-0.2), "aa": rnd(co, scale=2.0, lo=0.25),
            "ac": rnd(co, scale=0.5, lo=-0.25), "qa": rnd(co, scale=50.0, lo=10.0),
            "qc": rnd(co, scale=20.0, lo=-10.0), "ya": rnd(co, scale=1.5, lo=0.5),
            "yc": rnd(co, scale=0.6, lo=-0.3)}


#: the forms: (label, wrapper, C, CO, halo, form); K4 "tau" takes FRN's TLU
#: floor, K3 "aff_add" the frozen affine and the residual, "yaff" also the
#: residual's affine and ReLU, "emit" the s8 emit at floor −127, "raw" the
#: bare bf16 raw (the static-norm decoder's d2, counted as site_s8_c96)
FORMS = [("k4 res", "res_site", 192, 192, "reflect", ""),
         ("k4 res tau", "res_site", 192, 192, "reflect", "tau"),
         ("k4 d1", "res_site", 192, 384, "edge", ""),
         ("k4 d2 tau", "res_site", 96, 192, "edge", "tau"),
         ("k4 d2", "res_site", 96, 192, "edge", ""),
         ("k3 res", "site_s8", 192, 192, "reflect", "aff_add"),
         ("k3 res yaff", "site_s8", 192, 192, "reflect", "yaff"),
         ("k3 res emit", "site_s8", 192, 192, "reflect", "emit"),
         ("k3 d2", "site_s8", 96, 192, "edge", "raw")]


def _call(t, name, halo, form, kind=""):
    """The form through ``name`` (K4's or K3's wrapper), or with ``kind``
    "_prev" / "_plain" through its previous core / plain version."""
    fn = getattr(k8, f"{name}{kind}")
    if name == "res_site":
        kw = {"tau": t["tau"]} if form == "tau" else {}
        return fn(t["x"], t["a"], t["c"], -127.0 if form == "tau" else 0.0, t["wk"], t["ws"],
                  t["bias"], halo=halo, **kw)
    if form == "raw":
        return fn(t["codes"], t["wk"], t["ws"], t["bias"], halo=halo)
    kw = {"yaff": (t["ya"], t["yc"])} if form == "yaff" else \
        {"qa": t["qa"] / 4, "qc": t["qc"], "qlo": -127.0} if form == "emit" else {}
    return fn(t["codes"], t["wk"], t["ws"], t["bias"], t["aa"], t["ac"], t["y"], halo=halo, **kw)


@pytest.mark.parametrize("label,name,c,co,halo,form", FORMS[::2], ids=[f[0] for f in FORMS[::2]])
def test_wgmma_forms_on_cpu_are_the_plain_versions(label, name, c, co, halo, form):
    """On CPU tensors each form returns its plain version's result and
    counts nothing; the previous core refuses CPU tensors."""
    t = _operands(torch.device("cpu"), 1, 5, 9, c, co, seed=co + c)
    counts = (dict(k8.LAUNCHES), dict(k8.FORM_LAUNCHES))
    got, want = _call(t, name, halo, form), _call(t, name, halo, form, "_plain")
    got, want = (v if isinstance(v, tuple) else (v,) for v in (got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (dict(k8.LAUNCHES), dict(k8.FORM_LAUNCHES)) == counts
    with pytest.raises(NotImplementedError, match="no kernel for device cpu"):
        _call(t, name, halo, form, "_prev")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the wgmma core is a CUDA kernel with no CPU mode)")
    from neuralstyletransferv1_torch.device import resolve_device

    return resolve_device("cuda")


#: (B, H, W): ReCoNet's ragged cases (W off the 16-column tile, H off the
#: 8-row tile, one and three images), a 2 × 2 image, and the 1080p B=8 grid
#: of each width (the res grid at C = 192, the d2 grid at C = 96)
CARD_SHAPES = [(3, 13, 21), (1, 11, 30), (2, 9, 40), (1, 2, 2), None]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=["3x13x21", "1x11x30", "2x9x40", "1x2x2",
                                                    "1080p"])
@pytest.mark.parametrize("label,name,c,co,halo,form", FORMS, ids=[f[0] for f in FORMS])
def test_wgmma_core_matches_plain_and_previous_on_card(cuda_device, label, name, c, co, halo,
                                                       form, shape):
    """Each form on the wgmma core: two launches bit-identical (sums too),
    bit for bit the plain version (sums within 1e-5) and the previous core
    (K4's sums too at C = 192: the same order), one launch counted each under
    the wrapper's name (K3 at C = 96 under ``site_s8_c96``); the previous
    core counts none."""
    b, h, w = shape or ((8, 270, 480) if c == 192 else (8, 540, 960))
    t = _operands(cuda_device, b, h, w, c, co, seed=b * h + w + co)
    key, counts = ("site_s8_c96", k8.FORM_LAUNCHES) if c == 96 and name == "site_s8" \
        else (name, k8.LAUNCHES)
    before = counts[key]
    out, again = _call(t, name, halo, form), _call(t, name, halo, form)
    prev = _call(t, name, halo, form, "_prev")
    ref = _call(t, name, halo, form, "_plain")
    torch.cuda.synchronize()
    assert counts[key] - before == 2
    if name == "res_site":
        _bench.check(label, out[0], again[0], ref[0], exact=True, sums=out[1],
                     sums_again=again[1], sums_ref=ref[1])
        assert torch.equal(out[0], prev[0])
        if c == 192:  # at 96 the previous core sums two rows a warp: another order
            assert torch.equal(out[1], prev[1])
    else:
        _bench.check(label, out, again, ref, exact=True)
        assert torch.equal(out, prev)


@pytest.mark.cuda
def test_wgmma_smem_mirror_matches_the_source_on_card(cuda_device):
    for c in k8.WG_C:
        assert k8._lib_wg().site_wgmma_smem_bytes(c) == k8.wgmma_smem_bytes(c)
    assert k8._lib_wg().site_wgmma_smem_bytes(128) == 0
