"""K9e (``d3_rows``) on its Hopper core (``d3rows_wgmma_kernel``) and K1
(``dis_iter``) on its 8-lanes-a-patch core: the host-side contracts of the
new designs, the plain versions at ragged shapes against the JAX package's
functions on the CPU, the wrappers' dispatch; on the card, the new cores
against the plain versions and the previous cores.

The contracts, each a Python mirror of what the CUDA source does. K9e: the
block's shared memory (``d3_rows_smem_bytes``: within the 232,448 bytes a
block may take, and on the card equal to the source's own entry); the
producer's reflect map (``d3_rows_source``: every chunk of every item,
halo rows, columns and corners included, reads what
``pad_reflect_f2_4px`` puts there); the staged row's layout
(``d3_rows_offset``, ``d3_rows_core_matrix``: each core matrix the wgmma
B descriptor reads at a tap's one-pixel shift holds that tap's pixels);
the persistent walk (``d3_rows_schedule``: every (image, conv
row, segment) once). K1: the lane layout (``lane_layout``: every row of
every patch computed and stored once, with tails of 1-3 patches in the last
warp) and the interleaved neighbourhoods (``nb_word``: a sample's reads
and the staging stores by the 32 lanes of a warp in 32 distinct banks).

The JAX side runs ``s2d2_sites.d3_rows`` in interpret mode (within 1 bf16
ulp, floored at 2^-8 of the largest magnitude, ≥ 99% equal, at a W off the
64-column segment and an odd W) and ``dis_flow._iter_search_pallas`` at a
patch count that is not a multiple of the 32 patches of a block. The
``cuda`` cases import no JAX, so the card's machine runs them with
``--noconftest``: K9e within 1 ulp and ≥ 99% equal of both its plain
version and its previous core; K1 bit-identical to its previous core (it
adds its sums in the same order), its offsets within 1e-3 px of the plain
version on ≥ 99% of patches and its residuals within 1e-3 there; each new
core bit-identical between two launches.
"""

import numpy as np
import pytest
import torch

from neuralstyletransferv1_torch.experiments import _bench
from neuralstyletransferv1_torch.kernels import bf16_sites as k9
from neuralstyletransferv1_torch.kernels import dis_iter as k1
from neuralstyletransferv1_torch.kernels.int8_probes import SMEM_MAX
from neuralstyletransferv1_torch.models.s2d import pad_reflect_f2_4px
from neuralstyletransferv1_torch.ops import dis_flow as tdis


def _bf(a) -> np.ndarray:
    """Round to bf16, back as f32 numpy."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


# ---------------------------------------------------------------------------
# K9e: the new design's host-side contracts
# ---------------------------------------------------------------------------


def test_k9e_smem_mirror_fits_a_block():
    """Alignment slack, four input buffers of 68 pixels × 256 bytes, two
    output buffers of 64 × 60 bf16: within the 232,448 bytes a block may
    take."""
    assert k9.d3_rows_smem_bytes() == 128 + 4 * 17408 + 2 * 7680 <= SMEM_MAX


# (H, W): a segment that reaches both halos, segments off the 64 columns,
# an odd W, the smallest image, one W at the inner condition's edge
@pytest.mark.parametrize("h,w", [(3, 3), (4, 70), (5, 67), (3, 131), (3, 68)])
def test_k9e_reflect_map_is_the_pad(h, w):
    """For every item (conv row, segment) and every chunk of its staged
    pixels inside the padded grid (columns −2 .. W+1), the chunk the
    producer reads is the one ``pad_reflect_f2_4px`` puts at that position:
    halo rows, halo columns and the corners."""
    x = torch.arange(h * w * 128, dtype=torch.float64).reshape(1, h, w, 128)
    pad = pad_reflect_f2_4px(x, 32)[0].numpy()          # [H+4, W+4, 128]
    xs = x[0].numpy()
    for r in range(h + 4):
        for x0 in range(0, w, k9.D3_SEG):
            for j in range(k9.D3_SEG + 4):
                col = x0 - 2 + j
                if col >= w + 2:
                    continue  # feeds only outputs past the image
                for k in range(16):
                    sy, sx, ch = k9.d3_rows_source(h, w, r, x0, j, k)
                    assert np.array_equal(xs[sy, sx, ch:ch + 8], pad[r, col + 2, 8 * k:8 * k + 8]), \
                        (r, x0, j, k)


def test_k9e_staged_layout_is_the_descriptors():
    """``d3_rows_offset`` places every (pixel, chunk) of an item's 68 × 16
    chunks in its own 16 bytes of the 17,408-byte buffer; at every tap dx
    and k16 step kc, each core matrix the B descriptor reads (8 pixels ×
    one chunk, 128 contiguous bytes from ``d3_rows_core_matrix``) holds
    pixels dx + 8m .. + 7 of chunk 2kc + h, the 64 output pixels' tap-dx
    inputs; the producers' stores (8 consecutive threads: 8 consecutive
    pixels of a chunk) fall in 8 distinct 16-byte bank groups."""
    pix = k9.D3_SEG + 4
    offs = sorted(k9.d3_rows_offset(j, k) for j in range(pix) for k in range(16))
    assert offs == [16 * i for i in range(pix * 16)]
    for dx in range(5):
        for kc in range(8):
            for m in range(8):
                for h in range(2):
                    start = k9.d3_rows_core_matrix(dx, kc, m, h)
                    assert [k9.d3_rows_offset(dx + 8 * m + r, 2 * kc + h) for r in range(8)] == \
                        [start + 16 * r for r in range(8)]
    for k in range(16):
        for j0 in range(0, pix - 7):
            assert len({k9.d3_rows_offset(j, k) // 16 % 8 for j in range(j0, j0 + 8)}) == 8


# (B, H, W, SMs): fewer items than blocks, several images, the 1080p B=8
# shape on 132 SMs, and on 7
@pytest.mark.parametrize("b,h,w,sms", [(1, 3, 3, 132), (3, 7, 130, 132), (2, 5, 67, 7),
                                       (8, 540, 960, 132), (8, 540, 960, 7)])
def test_k9e_schedule_covers_every_item_once(b, h, w, sms):
    """The persistent blocks' walks cover every (image, conv row, segment)
    exactly once, each walk in order, their lengths at most one apart, and
    no more blocks than SMs."""
    walks = k9.d3_rows_schedule(b, h, w, sms)
    segs = -(-w // k9.D3_SEG)
    items = [t for walk in walks for t in walk]
    assert len(items) == b * (h + 4) * segs
    assert set(items) == {(i, r, s) for i in range(b) for r in range(h + 4) for s in range(segs)}
    assert all(walk == sorted(walk) for walk in walks)
    assert max(map(len, walks)) - min(map(len, walks)) <= 1
    assert len(walks) <= sms


# ---------------------------------------------------------------------------
# K1: the new layout's host-side contracts
# ---------------------------------------------------------------------------


# n: one patch (a tail of 3), tails of 1, 2 and 3 patches in the last warp,
# whole warps and blocks, a block and a bit
@pytest.mark.parametrize("n", [1, 29, 30, 31, 32, 33, 62, 64, 126])
def test_k1_lane_layout_covers_every_pixel_once(n):
    """Every (patch, column) of every patch is computed by exactly one lane
    of a slot below n, and stored by exactly one lane (its group's lane 0);
    a tail slot computes on the last patch and stores nothing; each lane's
    column is its 8 pixels, so every pixel is covered once."""
    lanes = k1.lane_layout(n)
    assert len(lanes) == -(-n // k1.PATCHES_PER_BLOCK) * k1.WARPS * 32
    real = [(p, i) for blk, warp, lane, p, i, _ in lanes
            if (blk * k1.WARPS + warp) * 4 + lane // 8 < n]
    assert sorted(real) == [(p, i) for p in range(n) for i in range(8)]
    stores = sorted(p for *_, p, _, st in lanes if st)
    assert stores == list(range(n))
    tail = [(p, st) for blk, warp, lane, p, i, st in lanes
            if (blk * k1.WARPS + warp) * 4 + lane // 8 >= n]
    assert all(p == n - 1 and not st for p, st in tail)


@pytest.mark.parametrize("R", [6, 5, 4])
def test_k1_nb_layout_is_conflict_free(R):
    """The 8 lanes of a patch's group reading one row at columns ix + j (+1)
    take 8 distinct banks at any offset, and the 4 groups of a warp take
    disjoint ones (bank ≡ slot mod 4): a sample's read by the 32 lanes is
    conflict-free whatever the 4 patches' offsets. With the odd row stride
    the staging stores (lane l: slot l % 4, rows l / 4 + 8k) are too, and
    the words fit the warp's share of the block's shared memory."""
    nbw = 8 + 2 * R
    for iy in range(2 * R):
        for ix in range(2 * R):
            for i in range(9):           # rows iy .. iy + 8
                for d in range(2):       # columns ix + j and + 1
                    for q in range(4):
                        banks = {k1.nb_word(iy + i, ix + j + d, q, nbw) % 32 for j in range(8)}
                        assert len(banks) == 8 and all(bk % 4 == q for bk in banks)
    for r0 in range(0, nbw, 8):
        for c in range(nbw):
            words = [k1.nb_word(r0 + lane // 4, c, lane % 4, nbw) for lane in range(32)
                     if r0 + lane // 4 < nbw]
            assert len({wd % 32 for wd in words}) == len(words)
    assert (k1.nb_word(nbw - 1, nbw - 1, 3, nbw) + 1) * 4 * k1.WARPS <= k1.smem_bytes(nbw)


# ---------------------------------------------------------------------------
# the plain versions at ragged shapes against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture
def jx():
    """The JAX side: the Pallas sites in interpret mode for this test."""
    import types

    import jax.numpy as jnp

    from neuralstyletransferv1_tpu.models import s2d2_sites as sj
    from neuralstyletransferv1_tpu.models import transformer_net_s2d2 as s2d2

    sj._INTERPRET = True
    yield types.SimpleNamespace(jnp=jnp, sj=sj, s2d2=s2d2)
    sj._INTERPRET = False


def _rows_operands(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return {"y": _bf(rng.normal(0, 1.5, (b, h, w, 128))),
            "a": np.asarray(rng.uniform(0.5, 1.5, (b, 128)), np.float32),
            "c": np.asarray(rng.normal(0, 0.3, (b, 128)), np.float32),
            "w": _bf(rng.normal(0, (5 * 128) ** -0.5, (1, 5, 128, 60)))}


def _rows_args(d, dev="cpu"):
    t = {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
    return t["y"].to(torch.bfloat16), t["a"], t["c"], k9.pack_rows_weights(t["w"])


# (B, H, W): a W off the 64-column segment (a partial second one), an odd W
# (the Pallas kernel takes H + 4 in even strips of 4-8 rows)
@pytest.mark.parametrize("b,h,w", [(2, 4, 70), (1, 12, 67)])
def test_k9e_plain_at_ragged_widths_matches_pallas(jx, b, h, w):
    """K9e's plain version against ``d3_rows`` (padding with
    ``_pad_reflect_f2_4px``): the 60 bf16 lanes on the H+4 rows of the
    padded grid within 1 ulp, ≥ 99% equal, no launch counted."""
    jnp, sj, s2d2 = jx.jnp, jx.sj, jx.s2d2
    d = _rows_operands(50 + w, b, h, w)
    ref = sj.d3_rows(jnp.asarray(d["y"], jnp.bfloat16), jnp.asarray(d["a"]), jnp.asarray(d["c"]),
                     jnp.asarray(d["w"], jnp.bfloat16),
                     pad_fn=lambda t: s2d2._pad_reflect_f2_4px(t, 32))
    before = dict(k9.LAUNCHES)
    ours = k9.d3_rows(*_rows_args(d))
    assert k9.LAUNCHES == before
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (b, h + 4, w, 60)
    worst, equal = k9.bf16_ulp_error(ours, torch.from_numpy(np.array(ref.astype(jnp.float32))))
    assert worst <= 1.0 and equal >= _bench.BF16_EQUAL_SHARE, (worst, equal)


def _level(seed, b, h, w, dev="cpu"):
    """K1's flat inputs for one level of b random textured pairs (h × w
    grey, a small shift) with a noisy init flow."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    ph = rng.random(3) * 6.0
    img = 128 + 50 * np.sin(0.23 * xx + 0.11 * yy + ph[0]) + 30 * np.cos(0.13 * xx - 0.29 * yy)
    prev = np.stack([img + rng.normal(0, 2, (h, w)) for _ in range(b)]).astype(np.float32)
    curr = np.stack([np.roll(img, (1, 2), (0, 1)) + rng.normal(0, 2, (h, w))
                     for _ in range(b)]).astype(np.float32)
    init = rng.normal(0.5, 0.6, (b, h, w, 2)).astype(np.float32)
    ins = tdis._level_inputs(*(torch.from_numpy(v).to(dev) for v in (prev, curr, init)))
    ny, nx = ins["t"].shape[1:3]
    n = b * ny * nx
    return {k: v.reshape((n,) + v.shape[3:]).contiguous() for k, v in ins.items()}, n


def test_k1_plain_at_a_ragged_count_matches_pallas():
    """K1's plain version against ``_iter_search_pallas`` on 126 patches
    (not a multiple of 32: a partial block whose last warp has a tail of 2):
    offsets within 1e-4 px on ≥ 99% of patches, residuals within 1e-3
    there, no launch counted."""
    import jax

    from neuralstyletransferv1_tpu.ops import dis_flow as jdis

    flat, n = _level(61, 1, 40, 60)
    assert n == 126 and n % 32 and n % 4 == 2
    before = k1.LAUNCHES
    u, res = k1.dis_iter(**flat, iters=16, R=6)
    assert k1.LAUNCHES == before
    keys = ("nb", "t", "gx", "gy", "hxx", "hxy", "hyy", "det", "u0", "lo")
    # the JAX function takes [ny, nx, ...]: one row of n patches
    ju, jres = jax.jit(lambda *xs: jdis._iter_search_pallas(*xs, 16, 6))(
        *(flat[k].numpy()[None] for k in keys))
    du = np.abs(u.numpy() - np.asarray(ju)[0]).max(axis=1)
    same = du <= 1e-4
    assert same.mean() >= 0.99, same.mean()
    assert np.abs(res.numpy() - np.asarray(jres)[0])[same].max() <= 1e-3


# ---------------------------------------------------------------------------
# dispatch on the CPU
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors K9e and K1 return their plain versions' results and
    count no launch, from views 2 bytes off a 16-byte boundary too (only
    the card's cores read 16-byte pieces)."""
    args = list(_rows_args(_rows_operands(62, 1, 4, 9)))
    off = torch.empty(args[0].numel() + 1, dtype=args[0].dtype)[1:].view(args[0].shape)
    off.copy_(args[0])
    args[0] = off
    before9, before1 = dict(k9.LAUNCHES), k1.LAUNCHES
    assert torch.equal(k9.d3_rows(*args), k9.d3_rows_plain(*args))
    flat, _ = _level(63, 1, 24, 28)
    nb = torch.empty(flat["nb"].numel() + 1)[1:].view(flat["nb"].shape)
    nb.copy_(flat["nb"])
    got, want = k1.dis_iter(**{**flat, "nb": nb}), k1.dis_iter_plain(**flat)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert k9.LAUNCHES == before9 and k1.LAUNCHES == before1


def test_prev_forms_refuse_cpu_tensors():
    before9, before1 = dict(k9.LAUNCHES), k1.LAUNCHES
    with pytest.raises(NotImplementedError, match="no kernel for device cpu"):
        k9.d3_rows_prev(*_rows_args(_rows_operands(64, 1, 4, 9)))
    with pytest.raises(NotImplementedError, match="no kernel for device cpu"):
        k1.dis_iter_prev(**_level(65, 1, 24, 28)[0])
    assert k9.LAUNCHES == before9 and k1.LAUNCHES == before1


# ---------------------------------------------------------------------------
# on the card: the new cores against the plain versions and the previous ones
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K9e and K1 are CUDA kernels with no CPU mode)")
    from neuralstyletransferv1_torch.device import resolve_device

    return resolve_device("cuda")


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    v = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    v.copy_(t)
    return v


#: (B, H, W) of K9e's input: the smallest image, an odd W, W off the
#: segment and B = 3, one whole segment, a W one past it, the slice's
#: 1080p B=8 shape
K9E_CARD_CASES = [(1, 3, 3), (1, 5, 67), (3, 7, 130), (2, 9, 64), (1, 4, 65), (8, 540, 960)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", K9E_CARD_CASES)
def test_k9e_new_core_matches_plain_and_previous_on_card(cuda_device, b, h, w):
    """K9e on ``d3rows_wgmma_kernel``: two launches bit-identical, within 1
    ulp of the plain version and of the previous core, ≥ 99% equal, one
    launch counted each; the previous core counts none, and a misaligned x
    raises."""
    args = _rows_args(_rows_operands(120 + h + w, b, h, w), cuda_device)
    before = dict(k9.LAUNCHES)
    out, again = k9.d3_rows(*args), k9.d3_rows(*args)
    prev, ref = k9.d3_rows_prev(*args), k9.d3_rows_plain(*args)
    torch.cuda.synchronize()
    assert k9.LAUNCHES == {**before, "d3_rows": before["d3_rows"] + 2}
    _bench.check("d3_rows", out, again, ref)
    _bench.check("d3_rows vs previous", out, again, prev)
    with pytest.raises(ValueError, match="16-byte"):
        k9.d3_rows(_misaligned(args[0]), *args[1:])


#: (B, h, w) of a K1 level's grey images: 1, 2, 3 and 5 patches (tails of
#: 3, 2, 1 and 3 in the last warp), 126 (a partial block), and the 1080p
#: slice's finest level (8 pairs of 135 × 240 at ds2: 15,104 patches)
K1_CARD_CASES = [(1, 8, 8), (1, 8, 12), (1, 8, 16), (1, 8, 24), (1, 40, 60), (8, 135, 240)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", K1_CARD_CASES)
def test_k1_new_core_matches_plain_and_previous_on_card(cuda_device, b, h, w):
    """K1 on its 8-lanes-a-patch core: two launches bit-identical, and
    bit-identical to the previous core (the same sums in the same order);
    offsets within 1e-3 px of the plain version on ≥ 99% of patches,
    residuals within 1e-3 there; one launch counted each, none for the
    previous core."""
    flat, n = _level(130 + h + w, b, h, w, cuda_device)
    before = k1.LAUNCHES
    (u, res), (u2, res2) = k1.dis_iter(**flat), k1.dis_iter(**flat)
    pu, pres = k1.dis_iter_plain(**flat)
    qu, qres = k1.dis_iter_prev(**flat)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 2
    assert torch.equal(u, u2) and torch.equal(res, res2)
    assert torch.equal(u, qu) and torch.equal(res, qres)
    assert tuple(u.shape) == (n, 2) and tuple(res.shape) == (n,)
    du = (u - pu).abs().max(dim=1).values
    same = du <= 1e-3
    assert float(same.float().mean()) >= 0.99
    assert float((res - pres).abs()[same].max()) <= 1e-3
    with pytest.raises(ValueError, match="16-byte"):
        k1.dis_iter(**{**flat, "t": _misaligned(flat["t"])})


@pytest.mark.cuda
def test_smem_mirrors_match_the_source_on_card(cuda_device):
    """The Python mirrors answer as the sources' own entries."""
    assert k9._lib().d3_rows_smem_bytes() == k9.d3_rows_smem_bytes()
    for R in (4, 6):
        assert k1._lib().dis_iter_smem_bytes(8 + 2 * R) == k1.smem_bytes(8 + 2 * R)
