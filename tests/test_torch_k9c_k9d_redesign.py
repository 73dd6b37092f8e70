"""K9c (``c2_site_bf16``) and K9d (``c3_site_bf16``) on their Hopper core
(``s2_mma_bf16_kernel``): the host-side contracts of the new design, the
plain versions at shapes that meet the new tiles' edges against the JAX
package's functions on the CPU, the wrappers' dispatch; on the card, the
new core against the plain versions and the previous core.

The contracts, each a Python mirror of what the CUDA source does: the
shared memory of each block (``s2_site_smem_bytes``: within the 232,448
bytes a block may take, and on the card equal to the
source's own ``s2_bf16_smem_bytes``); the parity planes (``s2_plane_pixel``:
every pixel of the haloed tile in one staged slot; ``s2_tap_pixel``: each
tap of each output pixel reads the pixel a stride-2 conv reads); the XOR
swizzle (``s2_swizzle``: any eight consecutive rows an ``ldmatrix`` reads
fall in distinct bank groups); the reflect halo as cp.async brings it in
(``s2_halo_tile``: the reflect pad at the top and left edges and corners);
the persistent walk (``s2_site_schedule``: every (image, tile) once).

The JAX side runs the Pallas kernels of ``models/s2d2_sites.py`` in
interpret mode, on conv2's output 36 × 48 (a partial bottom tile of K9c's
8 rows and of K9d's 4; K9d's 24 columns a tile and a half): within 1 bf16
ulp (taken at no less than 2^-8 of the largest magnitude), ≥ 99% equal, as
``tests/test_torch_bf16_sites.py`` holds them. The ``cuda`` cases import
no JAX, so the card's machine runs them with ``--noconftest``: within 1
ulp, ≥ 99% equal and sums within 1e-5 (``_bench.check``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neuralstyletransferv1_torch.experiments import _bench
from neuralstyletransferv1_torch.kernels import bf16_sites as k9
from neuralstyletransferv1_torch.kernels.int8_probes import SMEM_MAX

NAMES = ("c2_site_bf16", "c3_site_bf16")


@pytest.fixture
def jx():
    """The JAX side: the Pallas sites in interpret mode for this test."""
    import types

    import jax.numpy as jnp

    from neuralstyletransferv1_tpu.models import s2d2_sites as sj
    from neuralstyletransferv1_tpu.models import transformer_net_s2d as s2dj

    sj._INTERPRET = True
    yield types.SimpleNamespace(jnp=jnp, sj=sj, s2dj=s2dj)
    sj._INTERPRET = False


def _bf(a) -> np.ndarray:
    """Round to bf16, back as f32 numpy."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


# ---------------------------------------------------------------------------
# the new design's host-side contracts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,want", [
    # alignment slack, weights [9][64][32] bf16, four buffers of planes of
    # 17 × 33 pixels of 64 bytes (35,904, in whole kilobytes), bias
    ("c2_site_bf16", 1024 + 36864 + 4 * 36864 + 4 * 64),
    # alignment slack, weights [9][128][64] bf16, two buffers of planes of
    # 9 × 33 pixels of 128 bytes (38,016), bias
    ("c3_site_bf16", 1024 + 147456 + 2 * 38912 + 4 * 128)])
def test_smem_mirror_fits_a_block(name, want):
    """The block's shared memory: within the 232,448 bytes a block may take."""
    assert k9.s2_site_smem_bytes(name) == want <= SMEM_MAX


@pytest.mark.parametrize("name", NAMES)
def test_plane_map_stages_every_pixel_once(name):
    """``s2_plane_pixel`` puts the (2TH + 1) × 33 haloed tile's pixels in
    the staged slots one to one: a permutation of range(pixels)."""
    th = k9.SITES[name][4][0]
    slots = [k9.s2_plane_pixel(name, hr, hc) for hr in range(2 * th + 1) for hc in range(33)]
    assert sorted(slots) == list(range((2 * th + 1) * 33))


def _reflect_pad(x: torch.Tensor) -> torch.Tensor:
    """x [H,W,C] padded by one pixel, reflected (row −1 is row 1)."""
    return F.pad(x.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="reflect")[0].permute(1, 2, 0)


# (H, W) of the input, even: one tile and a partial one each way, a tile
# narrower than the image's 2 × 2, a width off the 16-column tile
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("h,w", [(20, 40), (2, 2), (10, 66)])
def test_taps_read_the_stride2_source(name, h, w):
    """At every tile of the grid, the staged planes (the haloed tile put
    through ``s2_plane_pixel``) hold at ``s2_tap_pixel(r, c, dy, dx)`` the
    pixel that a stride-2 conv over the reflect-padded input reads for tap
    (dy, dx) of output pixel (r, c), for every output inside the image."""
    th, tw = k9.SITES[name][4]
    x = torch.from_numpy(np.random.default_rng(h * w).normal(0, 1, (h, w, 3)).astype(np.float32))
    pad = _reflect_pad(x)
    for ty0 in range(0, h // 2, th):
        for tx0 in range(0, w // 2, tw):
            halo = k9.s2_halo_tile(name, x, ty0, tx0)
            staged = torch.empty(halo.shape[0] * halo.shape[1], 3)
            for hr in range(halo.shape[0]):
                for hc in range(halo.shape[1]):
                    staged[k9.s2_plane_pixel(name, hr, hc)] = halo[hr, hc]
            for r in range(min(th, h // 2 - ty0)):
                for c in range(min(tw, w // 2 - tx0)):
                    for dy in range(3):
                        for dx in range(3):
                            got = staged[k9.s2_tap_pixel(name, r, c, dy, dx)]
                            want = pad[2 * (ty0 + r) + dy, 2 * (tx0 + c) + dx]
                            assert torch.equal(got, want), (ty0, tx0, r, c, dy, dx)


@pytest.mark.parametrize("name", NAMES)
def test_swizzle_spreads_ldmatrix_rows(name):
    """Under ``s2_swizzle`` a row's chunks stay within its own 2C bytes, and
    chunk k of any eight consecutive rows (an ``ldmatrix``'s 8 addresses, A
    rows of a plane or B rows of the weights) falls in 8 distinct 16-byte
    bank groups."""
    cin, co = k9.SITES[name][:2]
    ch, rows = cin // 8, 9 * co
    for p in range(rows):
        assert sorted(k9.s2_swizzle(name, p, k) - 2 * cin * p for k in range(ch)) == \
            [16 * k for k in range(ch)]
    for p0 in range(rows - 7):
        for k in range(ch):
            assert len({k9.s2_swizzle(name, p, k) // 16 % 8 for p in range(p0, p0 + 8)}) == 8


# (H, W) of the input: partial tiles at the bottom and right, one image
# narrower than a tile, a 2 × 2 image
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("h,w", [(22, 70), (6, 34), (2, 2)])
def test_halo_mirror_is_the_reflect_pad(name, h, w):
    """At every tile (the top and left edges and corners among them) the
    haloed raw input equals the reflect pad of the image on every position
    inside the padded image (rows up to H, columns up to W); positions past
    it hold pixels of the image."""
    th, tw = k9.SITES[name][4]
    x = torch.from_numpy(np.random.default_rng(h + w).normal(0, 1, (h, w, 4)).astype(np.float32))
    pad = _reflect_pad(x)
    for ty0 in range(0, h // 2, th):
        for tx0 in range(0, w // 2, tw):
            tile = k9.s2_halo_tile(name, x, ty0, tx0)
            assert tuple(tile.shape) == (2 * th + 1, 2 * tw + 1, 4)
            rows = min(2 * th + 1, h + 2 - 2 * ty0)
            cols = min(2 * tw + 1, w + 2 - 2 * tx0)
            assert torch.equal(tile[:rows, :cols],
                               pad[2 * ty0:2 * ty0 + rows, 2 * tx0:2 * tx0 + cols]), (ty0, tx0)


# (B, H, W, SMs): fewer tiles than blocks, several images, the 1080p B=8
# shapes of the slices on 132 SMs, and on 3
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("b,h,w,sms", [(1, 2, 2, 132), (3, 26, 100, 132), (3, 14, 70, 2),
                                       (8, 1080, 1920, 132), (8, 540, 960, 3)])
def test_schedule_covers_every_tile_once(name, b, h, w, sms):
    """The persistent blocks' walks cover every (image, tile row, tile
    column) exactly once, each walk in order, their lengths at most one
    apart, and no more blocks than SMs."""
    th, tw = k9.SITES[name][4]
    walks = k9.s2_site_schedule(name, b, h, w, sms)
    ty, tx = -(-(h // 2) // th), -(-(w // 2) // tw)
    tiles = [t for walk in walks for t in walk]
    assert len(tiles) == b * ty * tx
    assert set(tiles) == {(i, r, c) for i in range(b) for r in range(ty) for c in range(tx)}
    assert all(walk == sorted(walk) for walk in walks)
    assert max(map(len, walks)) - min(map(len, walks)) <= 1
    assert len(walks) <= sms
    # the [Σ, Σ²] partials: one per block and consumer warp
    assert k9.s2_part_slots(name, b, h, w, sms) == 4 * len(walks)


# ---------------------------------------------------------------------------
# the plain versions at the new tiles' edges against the JAX package
# ---------------------------------------------------------------------------

B, H2, W2 = 2, 36, 48   # conv2's output: off K9c's 8-row tile, K9d's 4-row one


def _operands(seed, c, co, h, w):
    rng = np.random.default_rng(seed)
    return {"x": _bf(rng.normal(0, 1.5, (B, h, w, c))),
            "a": np.asarray(rng.uniform(0.5, 1.5, (B, c)), np.float32),
            "c": np.asarray(rng.normal(0, 0.3, (B, c)), np.float32),
            "w": _bf(rng.normal(0, (9 * c) ** -0.5, (3, 3, c, co))),
            "bias": _bf(rng.normal(0, 0.2, co))}


def _torch_args(d, dev="cpu"):
    t = {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
    return (t["x"].to(torch.bfloat16), t["a"], t["c"], k9.pack_site_weights(t["w"]), t["bias"])


def _assert_close(ours, ref):
    worst, equal = k9.bf16_ulp_error(ours, torch.from_numpy(np.array(ref, np.float32)))
    assert worst <= 1.0 and equal >= _bench.BF16_EQUAL_SHARE, (worst, equal)


def test_k9c_plain_at_the_tiles_edges_matches_pallas(jx):
    """K9c's plain version on conv1's raw output [2, 72, 96, 32] against
    ``_c2_site`` on the space-to-depth tensor with the 2×2 block weights,
    completed by ``_c2_fixup`` (as ``tests/test_torch_bf16_sites.py`` runs
    it): within 1 ulp, ≥ 99% equal; the in2 statistics (mean, inv) within
    2e-4 relative (the JAX ones sum the strip fixup's bf16-rounded values),
    no launch counted."""
    jnp, sj, s2dj = jx.jnp, jx.sj, jx.s2dj
    from neuralstyletransferv1_torch.models import sites_bf16

    rng = np.random.default_rng(43)
    d = _operands(43, 32, 64, 2 * H2, 2 * W2)
    m1 = np.asarray(rng.normal(0, 0.3, (B, 32)), np.float32)
    inv1 = np.asarray(rng.uniform(0.5, 1.5, (B, 32)), np.float32)
    in1 = {"scale": jnp.asarray(_bf(rng.uniform(0.5, 1.5, 32))),
           "bias": jnp.asarray(_bf(rng.normal(0, 0.3, 32)))}
    a1 = jnp.asarray(inv1) * in1["scale"]
    c1 = in1["bias"] - jnp.asarray(m1) * jnp.asarray(inv1) * in1["scale"]
    raw1 = s2dj.s2d(jnp.asarray(d["x"], jnp.bfloat16), 2)
    wblk = jnp.asarray(s2dj._scatter_stride2_s2d2(d["w"]), jnp.bfloat16)
    ts2, _ = sj._head_geom(H2, W2)
    y2, sout = sj._c2_site(raw1, jnp.tile(a1, (1, 4)), jnp.tile(c1, (1, 4)),
                           wblk.reshape(4, 128, 64), jnp.asarray(d["bias"])[None, :], ts2=ts2)
    y2, m2, inv2 = sj._c2_fixup(y2, sout, raw1, jnp.asarray(m1), jnp.asarray(inv1), in1, wblk,
                                jnp.asarray(d["bias"], jnp.bfloat16))
    d["a"], d["c"] = np.array(a1), np.array(c1)
    before = dict(k9.LAUNCHES)
    ours, sums = k9.c2_site_bf16(*_torch_args(d))
    assert k9.LAUNCHES == before
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (B, H2, W2, 64)
    _assert_close(ours, y2.astype(jnp.float32))
    m, inv = sites_bf16._stats(sums, float(H2 * W2))
    np.testing.assert_allclose(inv.numpy(), np.asarray(inv2), rtol=2e-4)
    np.testing.assert_allclose(m.numpy(), np.asarray(m2), rtol=0,
                               atol=2e-4 / np.asarray(inv2).min())


def test_k9d_plain_at_the_tiles_edges_matches_pallas(jx):
    """K9d's plain version on conv2's raw output [2, 36, 48, 64] against
    ``_c3_site`` on its space-to-depth form with the stride-2 phase halo and
    the 2×2 block weights: within 1 ulp, ≥ 99% equal, sums within 1e-4
    relative, no launch counted."""
    jnp, sj, s2dj = jx.jnp, jx.sj, jx.s2dj
    d = _operands(44, 64, 128, H2, W2)
    _, ts3 = sj._head_geom(H2, W2)
    h4, w4 = H2 // 2, W2 // 2
    wp = ((w4 + 1 + 7) // 8) * 8
    x3 = s2dj._pad_stride2_halo(s2dj.s2d(jnp.asarray(d["x"], jnp.bfloat16), 2), 64)
    x3 = jnp.pad(x3, ((0, 0), (0, 0), (0, wp - (w4 + 1)), (0, 0)))
    wblk = jnp.asarray(s2dj._scatter_stride2_s2d2(d["w"]), jnp.bfloat16).reshape(4, 256, 128)
    ref, sout = sj._c3_site(x3, jnp.tile(jnp.asarray(d["a"]), (1, 4)),
                            jnp.tile(jnp.asarray(d["c"]), (1, 4)), wblk,
                            jnp.asarray(d["bias"])[None, :], ts3=ts3, h4=h4, w4dim=w4, wp=wp)
    before = dict(k9.LAUNCHES)
    ours, sums = k9.c3_site_bf16(*_torch_args(d))
    assert k9.LAUNCHES == before
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (B, h4, w4, 128)
    _assert_close(ours, ref.astype(jnp.float32))
    got, want = sums.numpy().astype(np.float64), np.asarray(sout, np.float64)
    s2 = np.abs(want[:, 1])
    assert np.all(np.abs(got[:, 1] - want[:, 1]) <= 1e-4 * s2)
    assert np.all(np.abs(got[:, 0] - want[:, 0]) <= 1e-4 * np.sqrt(h4 * w4 * s2))


# ---------------------------------------------------------------------------
# dispatch on the CPU
# ---------------------------------------------------------------------------


def _cpu_args(name):
    cin, co = k9.SITES[name][:2]
    return list(_torch_args(_operands(45, cin, co, 6, 34)))


@pytest.mark.parametrize("name", NAMES)
def test_cpu_tensors_take_the_plain_versions(name):
    """On CPU tensors K9c and K9d return their plain versions' results and
    count no launch, from a view 2 bytes off a 16-byte boundary too (only
    the card's core reads 16-byte pieces)."""
    args = _cpu_args(name)
    x = args[0]
    off = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    off.copy_(x)
    args[0] = off
    before = dict(k9.LAUNCHES)
    got, want = getattr(k9, name)(*args), getattr(k9, f"{name}_plain")(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert k9.LAUNCHES == before


@pytest.mark.parametrize("name", NAMES)
def test_prev_forms_refuse_cpu_tensors(name):
    before = dict(k9.LAUNCHES)
    with pytest.raises(NotImplementedError, match="no kernel for device cpu"):
        getattr(k9, f"{name}_prev")(*_cpu_args(name))
    assert k9.LAUNCHES == before


# ---------------------------------------------------------------------------
# on the card: the new core against the plain versions and the previous one
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K9c and K9d are CUDA kernels with no CPU mode)")
    from neuralstyletransferv1_torch.device import resolve_device

    return resolve_device("cuda")


#: (B, H, W) of the input: a 1 × 1 output, outputs off the 16-column tile
#: and below or off the 8- and 4-row tiles, one and three images, and the
#: slice's 1080p B=8 shapes (K9c at 1080 × 1920, K9d at 540 × 960)
CARD_CASES = [(1, 2, 2), (1, 6, 34), (3, 14, 70), (3, 26, 100), (1, 34, 66), (8, 1080, 1920)]


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    v = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("b,h,w", CARD_CASES)
def test_new_core_matches_plain_and_previous_on_card(cuda_device, name, b, h, w):
    """K9c and K9d on ``s2_mma_bf16_kernel``: two launches bit-identical,
    within 1 ulp of the plain version and of the previous core, ≥ 99%
    equal, sums within 1e-5, one launch counted each; the previous core
    counts none, and a misaligned x raises. At a 1 × 1 output a channel's
    sums are one f and f², whose accumulation-order error no other pixel
    dilutes (both cores differ from the plain sums there by more than
    1e-5): they are held bit-identical to the previous core's, which adds
    the same products in the same order, as ``chip_smoke.py`` holds them."""
    if name == "c3_site_bf16" and (h, w) == (1080, 1920):
        h, w = 540, 960
    cin, co = k9.SITES[name][:2]
    args = _torch_args(_operands(110 + h + w, cin, co, h, w) if b < 8 else
                       {**_operands(110, cin, co, 2, 2),
                        "x": _bf(np.random.default_rng(111).normal(0, 1.5, (b, h, w, cin))),
                        "a": np.asarray(np.random.default_rng(112).uniform(0.5, 1.5, (b, cin)),
                                        np.float32),
                        "c": np.asarray(np.random.default_rng(113).normal(0, 0.3, (b, cin)),
                                        np.float32)}, cuda_device)
    before = dict(k9.LAUNCHES)
    (y, s), (y2, s2) = getattr(k9, name)(*args), getattr(k9, name)(*args)
    yp, sp = getattr(k9, f"{name}_prev")(*args)
    yr, sr = getattr(k9, f"{name}_plain")(*args)
    torch.cuda.synchronize()
    assert k9.LAUNCHES[name] - before[name] == 2
    assert all(k9.LAUNCHES[k] == v for k, v in before.items() if k != name)
    if (h, w) == (2, 2):
        assert torch.equal(s, s2) and torch.equal(s, sp)
        _bench.check(name, y, y2, yr)
        _bench.check(f"{name} vs previous", y, y2, yp)
    else:
        _bench.check(name, y, y2, yr, sums=s, sums_again=s2, sums_ref=sr)
        _bench.check(f"{name} vs previous", y, y2, yp, sums=s, sums_again=s2, sums_ref=sp)
    with pytest.raises(ValueError, match="16-byte"):
        getattr(k9, name)(_misaligned(args[0]), *args[1:])


@pytest.mark.cuda
def test_smem_mirrors_match_the_source_on_card(cuda_device):
    """The Python mirror answers as the source's own entry."""
    for name in NAMES:
        assert k9._lib().s2_bf16_smem_bytes(k9.SITES[name][0]) == k9.s2_site_smem_bytes(name)
