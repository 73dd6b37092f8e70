"""K7 (``d3_rows_site``) and K9a (``d2_site``) on their Hopper cores
(``d3rows_mma_kernel``, ``d2_wgmma_kernel``): the host-side contracts of
the new designs, the plain versions at the shapes that meet the new tiles'
edges against the JAX package's functions on the CPU, the wrappers'
dispatch; on the card, the new cores against the plain versions and the
previous cores.

The contracts, each a Python mirror of what the CUDA source does: the
shared memory of each block (``d3_rows_smem_bytes``, ``d2_site_smem_bytes``:
within the 232,448 bytes a block may take, and on the card equal to the
source's own ``d3rows_mma_smem_bytes``, ``d2_wgmma_smem_bytes``); K7's walk
of the (image, 32-column strip, row) items (``d3_rows_schedule``: every item
exactly once); K7's quantize, which rounds by adding 1.5·2^23
(``quantize_i``: torch.round's half to even on every finite bf16 value);
K9a's halo, zero-filled by TMA outside the image and patched to the edge on
border tiles (``d2_halo_tile``: the replicate pad at the corners and edges).

The JAX side runs the Pallas kernels of ``models/s2d2_sites_i8.py`` and
``models/s2d2_sites.py`` in interpret mode. K7 at heights below the 8-row
tile and widths off the 32-column strip, its quantize affine a power of two
so that no contraction of x·a + c into an FMA can flip a code: bit for
bit. K9a at widths off the 32-column tile (the TPU geometry needs H ≡ 4
mod 8 and W ≡ 0 mod 8), its affine's scale a power of two as well (a
contracted prologue would flip an activation by an ulp, and the conv
carries that flip to several ulp of a small output): within 1 bf16 ulp
(taken at no less than 2^-8 of the largest magnitude), ≥ 99% equal, sums
within 1e-4 relative, as ``tests/test_torch_bf16_sites.py`` holds it. The
``cuda`` cases import no JAX, so the card's machine runs them with
``--noconftest``: K7 bit for bit, K9a within 1 ulp, ≥ 99% equal and sums
within 1e-5 (``_bench.check``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neuralstyletransferv1_torch.experiments import _bench
from neuralstyletransferv1_torch.kernels import bf16_sites as k9
from neuralstyletransferv1_torch.kernels import int8_sites as k8
from neuralstyletransferv1_torch.kernels.int8_probes import SMEM_MAX


@pytest.fixture
def jx():
    """The JAX side: the Pallas sites in interpret mode for this test."""
    import types

    import jax.numpy as jnp

    from neuralstyletransferv1_tpu.models import s2d2_sites as sj
    from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8
    from neuralstyletransferv1_tpu.models import transformer_net_s2d as s2dj

    sj._INTERPRET = si8._INTERPRET = True
    yield types.SimpleNamespace(jnp=jnp, sj=sj, si8=si8, s2dj=s2dj)
    sj._INTERPRET = si8._INTERPRET = False


def _bf(a) -> np.ndarray:
    """Round to bf16, back as f32 numpy."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


# ---------------------------------------------------------------------------
# the new designs' host-side contracts
# ---------------------------------------------------------------------------


def test_k7_smem_mirror_fits_a_block():
    """K7's block: weights [5][64] rows of 144 bytes (46,080) and, per warp
    of 8, a landing row of 36 raw bf16 pixels (9,216) and two code slots of
    36 × 144 (10,368)."""
    assert k8.d3_rows_smem_bytes() == 46080 + 8 * (9216 + 10368) == 202752
    assert k8.d3_rows_smem_bytes() <= SMEM_MAX


def test_k9a_smem_mirror_fits_a_block():
    """K9a's block: alignment slack, two 32 KB buffers (a 6 × 34-pixel input
    of 128 bytes a pixel, 26,112, then the tile's 4 × 32 × 128 bf16 output),
    the nine taps' weights (147,456), the affine by parity, bias, sums and
    barriers."""
    assert k9.d2_site_smem_bytes() == 1024 + 2 * 32768 + 147456 + 4 * (256 + 128 + 2048) + 64
    assert k9.d2_site_smem_bytes() <= SMEM_MAX


# (B, H, W, SMs): items fewer than the warps, a share inside one strip,
# shares across strips and images, the 1080p B=8 grid on 132 SMs
@pytest.mark.parametrize("b,h,w,sms", [(1, 2, 2, 132), (1, 5, 45, 132), (3, 7, 70, 132),
                                       (3, 13, 100, 4), (2, 75, 33, 3), (8, 540, 960, 132)])
def test_k7_schedule_covers_every_item_once(b, h, w, sms):
    """K7's warps walk contiguous shares of the B·strips·H items: together
    every (image, strip, row) exactly once, each share in walk order, the
    shares' sizes at most one apart."""
    shares = k8.d3_rows_schedule(b, h, w, sms)
    strips = -(-w // k8.D3_STRIP)
    items = [it for share in shares for it in share]
    assert len(items) == b * strips * h
    assert set(items) == {(i, s, r) for i in range(b) for s in range(strips) for r in range(h)}
    assert items == sorted(items)
    sizes = [len(share) for share in shares]
    assert max(sizes) - min(sizes) <= 1
    assert len(shares) % k8.D3_WARPS == 0 and len(shares) <= sms * k8.D3_WARPS


def _all_bf16() -> torch.Tensor:
    """Every finite bf16 value."""
    v = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    return v[torch.isfinite(v.float())]


@pytest.mark.parametrize("a", [1.0, 0.5, 3.0, 37.3, 1e-3, 250.0])
@pytest.mark.parametrize("c", [0.0, 0.25, -3.1, 63.5, 126.5])
def test_k7_quantize_mirror_rounds_half_to_even(a, c):
    """``quantize_i`` (clamp to [0, 127], then + 1.5·2^23: the add rounds
    half to even into the low mantissa bits) equals clamp(torch.round(v·a
    + c), 0, 127) on every finite bf16 value, ties included."""
    v = _all_bf16()
    want = torch.clamp(torch.round(v.float() * a + c), 0.0, 127.0).to(torch.int32)
    assert torch.equal(k8.quantize_i(v, a, c), want)
    ties = v.float() * a + c
    assert torch.equal(k8.quantize_i(v, a, c)[ties == ties.floor() + 0.5],
                       want[ties == ties.floor() + 0.5])


# (H, W): a 4-row tile grid with a partial bottom tile and a partial right
# tile, one narrower than a tile, a 2 × 2 image
@pytest.mark.parametrize("h,w", [(7, 45), (4, 32), (3, 20), (2, 2)])
def test_k9a_halo_mirror_is_the_edge_pad(h, w):
    """At every tile of the grid (the four corners, the edges and the
    interior), the patched haloed input equals the replicate pad of the
    image on every position that feeds a stored output: rows ty0−1..min(ty0
    + 4, H), columns tx0−1..min(tx0 + 32, W)."""
    x = torch.from_numpy(np.random.default_rng(h * w).normal(0, 1, (h, w, 8)).astype(np.float32))
    pad = F.pad(x.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")[0].permute(1, 2, 0)
    th, tw = k9.FUSED_TILE
    for ty0 in range(0, h, th):
        for tx0 in range(0, w, tw):
            tile = k9.d2_halo_tile(x, ty0, tx0)
            rows, cols = min(th + 2, h + 2 - ty0), min(tw + 2, w + 2 - tx0)
            assert torch.equal(tile[:rows, :cols], pad[ty0:ty0 + rows, tx0:tx0 + cols]), (ty0, tx0)
            assert not tile[rows:].any() and not tile[:, cols:].any()


# ---------------------------------------------------------------------------
# the plain versions at the new tiles' edges against the JAX package
# ---------------------------------------------------------------------------


def _k7_operands(seed, b, h, w):
    """K7's operands, the quantize scale a power of two."""
    rng = np.random.default_rng(seed)
    return {"y": _bf(rng.normal(0, 2, (b, h, w, 128))),
            "a": np.asarray(2.0 ** rng.integers(2, 6, (b, 128)), np.float32),
            "c": np.asarray(rng.normal(0, 8, (b, 128)), np.float32),
            "w5": rng.integers(-127, 128, (1, 5, 128, 60)).astype(np.int8),
            "ws": np.asarray(rng.uniform(0.5, 2, 60) / (127 * 127 * 20), np.float32)}


def _k7_torch(d, dev="cpu"):
    t = {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
    return (t["y"].to(torch.bfloat16), t["a"], t["c"],
            k8.pack_weights(t["w5"], co_pad=k8.CO_TILE),
            torch.cat([t["ws"], torch.zeros(4, device=dev)]))


# (B, H, W): heights below the 8-row tile, widths off the 32-column strip
@pytest.mark.parametrize("b,h,w", [(1, 5, 45), (3, 6, 70), (1, 3, 33)])
def test_k7_plain_off_the_strip_matches_pallas(jx, b, h, w):
    """K7's plain version against ``d3_rows_site`` in interpret mode: bit
    for bit, no launch counted."""
    jnp = jx.jnp
    d = _k7_operands(60 + h + w, b, h, w)
    ref = jx.si8.d3_rows_site(jnp.asarray(d["y"], jnp.bfloat16), jnp.asarray(d["a"]),
                              jnp.asarray(d["c"]), jnp.asarray(d["w5"][0]), jnp.asarray(d["ws"]))
    before = dict(k8.LAUNCHES)
    ours = k8.d3_rows_site(*_k7_torch(d))
    assert k8.LAUNCHES == before
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (b, h, w, 60)
    assert np.array_equal(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def _k9a_operands(seed, b, h, w):
    """K9a's operands, the affine's scale a power of two (see K7's)."""
    rng = np.random.default_rng(seed)
    return {"x": _bf(rng.normal(0, 1.5, (b, h, w, 64))),
            "a": np.asarray(2.0 ** rng.integers(-1, 1, (b, 64)), np.float32),
            "c": np.asarray(rng.normal(0, 0.3, (b, 64)), np.float32),
            "w": _bf(rng.normal(0, (9 * 64) ** -0.5, (3, 3, 64, 128))),
            "bias": _bf(rng.normal(0, 0.2, 128))}


def _k9a_torch(d, dev="cpu"):
    t = {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
    return (t["x"].to(torch.bfloat16), t["a"], t["c"], k9.pack_site_weights(t["w"]), t["bias"])


# (B, H, W): widths off the 32-column tile (40, 56: a partial tile; 24:
# narrower than one), three images
@pytest.mark.parametrize("b,h,w", [(1, 20, 40), (1, 28, 56), (3, 20, 24)])
def test_k9a_plain_off_the_tile_matches_pallas(jx, b, h, w):
    """K9a's plain version against ``_d2_site`` on its edge-padded,
    junk-aligned buffer (as ``tests/test_torch_bf16_sites.py`` runs it):
    the buffer's interior within 1 ulp, ≥ 99% equal, sums within 1e-4."""
    jnp, sj = jx.jnp, jx.sj
    d = _k9a_operands(70 + h + w, b, h, w)
    _, hbuf, wp = sj._tail_geom(h, w)
    xin = jx.s2dj._pad_edge_blocks(jnp.asarray(d["x"], jnp.bfloat16))
    x4 = jnp.pad(xin, ((0, 0), (2, hbuf - h - 2), (2, wp - w - 4), (0, 0)))
    y5, sout = sj._d2_site(x4, jnp.asarray(d["a"]), jnp.asarray(d["c"]),
                           jnp.asarray(d["w"], jnp.bfloat16).reshape(9, 64, 128),
                           jnp.asarray(d["bias"])[None, :], h2=h, w2=w, hbuf=hbuf, wp=wp)
    before = dict(k9.LAUNCHES)
    ours, sums = k9.d2_site(*_k9a_torch(d))
    assert k9.LAUNCHES == before
    ref = torch.from_numpy(np.array(y5.astype(jnp.float32))[:, 2:2 + h, 2:2 + w])
    worst, equal = k9.bf16_ulp_error(ours, ref)
    assert worst <= 1.0 and equal >= _bench.BF16_EQUAL_SHARE, (worst, equal)
    got, want = sums.numpy().astype(np.float64), np.asarray(sout, np.float64)
    s2 = np.abs(want[:, 1])
    assert np.all(np.abs(got[:, 1] - want[:, 1]) <= 1e-4 * s2)
    assert np.all(np.abs(got[:, 0] - want[:, 0]) <= 1e-4 * np.sqrt(h * w * s2))


# ---------------------------------------------------------------------------
# dispatch on the CPU
# ---------------------------------------------------------------------------


def _cpu_args(name):
    if name.startswith("d3_rows"):
        return list(_k7_torch(_k7_operands(80, 2, 3, 20)))
    return list(_k9a_torch(_k9a_operands(81, 2, 5, 20)))


@pytest.mark.parametrize("mod,name", [(k8, "d3_rows_site"), (k9, "d2_site")])
def test_cpu_tensors_take_the_plain_versions(mod, name):
    """On CPU tensors K7 and K9a return their plain versions' results and
    count no launch, from a view 2 bytes off a 16-byte boundary too (only
    the card's cores read 16-byte chunks and TMA boxes)."""
    args = _cpu_args(name)
    x = args[0]
    off = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    off.copy_(x)
    args[0] = off
    before = dict(mod.LAUNCHES)
    got, want = getattr(mod, name)(*args), getattr(mod, f"{name}_plain")(*args)
    got, want = (v if isinstance(v, tuple) else (v,) for v in (got, want))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert mod.LAUNCHES == before


@pytest.mark.parametrize("mod,name", [(k8, "d3_rows_site_prev"), (k9, "d2_site_prev")])
def test_prev_forms_refuse_cpu_tensors(mod, name):
    before = dict(mod.LAUNCHES)
    with pytest.raises(NotImplementedError, match="no kernel for device cpu"):
        getattr(mod, name)(*_cpu_args(name))
    assert mod.LAUNCHES == before


# ---------------------------------------------------------------------------
# on the card: the new cores against the plain versions and the previous ones
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K7 and K9a are CUDA kernels with no CPU mode)")
    from neuralstyletransferv1_torch.device import resolve_device

    return resolve_device("cuda")


#: (B, H, W): widths off the strip / tile, heights below the tile, one and
#: three images, a 2 × 2 image, and the 1080p B=8 grid of the slices
CARD_CASES = [(1, 5, 45), (3, 7, 70), (1, 3, 33), (3, 13, 100), (1, 2, 2), (8, 540, 960)]


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    v = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", CARD_CASES)
def test_k7_new_core_matches_plain_and_previous_on_card(cuda_device, b, h, w):
    """K7 on ``d3rows_mma_kernel``: two launches bit-identical, bit for bit
    the plain version and the previous core, one launch counted each; the
    previous core counts none and a misaligned y raises."""
    args = _k7_torch(_k7_operands(90 + h + w, b, h, w), cuda_device)
    before = k8.LAUNCHES["d3_rows_site"]
    rows, again = k8.d3_rows_site(*args), k8.d3_rows_site(*args)
    prev, ref = k8.d3_rows_site_prev(*args), k8.d3_rows_site_plain(*args)
    torch.cuda.synchronize()
    assert k8.LAUNCHES["d3_rows_site"] - before == 2
    _bench.check("d3_rows_site", rows, again, ref, exact=True)
    _bench.check("d3_rows_site vs previous", rows, again, prev, exact=True)
    with pytest.raises(ValueError, match="16-byte"):
        k8.d3_rows_site(_misaligned(args[0]), *args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", CARD_CASES)
def test_k9a_new_core_matches_plain_and_previous_on_card(cuda_device, b, h, w):
    """K9a on ``d2_wgmma_kernel``: two launches bit-identical, within 1 ulp
    of the plain version and of the previous core, ≥ 99% equal, sums within
    1e-5, one launch counted each; a misaligned x raises."""
    args = _k9a_torch(_k9a_operands(100 + h + w, b, h, w), cuda_device)
    before = k9.LAUNCHES["d2_site"]
    (y, s), (y2, s2) = k9.d2_site(*args), k9.d2_site(*args)
    yp, sp = k9.d2_site_prev(*args)
    yr, sr = k9.d2_site_plain(*args)
    torch.cuda.synchronize()
    assert k9.LAUNCHES["d2_site"] - before == 2
    _bench.check("d2_site", y, y2, yr, sums=s, sums_again=s2, sums_ref=sr)
    _bench.check("d2_site vs previous", y, y2, yp, sums=s, sums_again=s2, sums_ref=sp)
    with pytest.raises(ValueError, match="16-byte"):
        k9.d2_site(_misaligned(args[0]), *args[1:])


@pytest.mark.cuda
def test_smem_mirrors_match_the_sources_on_card(cuda_device):
    """The Python mirrors answer as the sources' own entries."""
    assert k8._lib().d3rows_mma_smem_bytes() == k8.d3_rows_smem_bytes()
    assert k9._lib().d2_wgmma_smem_bytes() == k9.d2_site_smem_bytes()
