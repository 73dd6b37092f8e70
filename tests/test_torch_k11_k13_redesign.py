"""K11 (``c1_site``) on its Hopper core (``c1_wgmma_kernel``) and K13
(``pad_inject``) on its new core (``pad_inject_v2_kernel``): the host-side
contracts of the new designs, held against the plain versions and, through
them, against the JAX functions mk13 and mk28 run; the wrappers' dispatch;
on the card, the new cores against the plain versions and the previous
cores.

The contracts, each a Python mirror of what the CUDA source does. K11: the
block's shared memory (``c1_site_smem_bytes``: within the 232,448 bytes a
block may take, and on the card equal to the source's own entry); the
permuted k order of a kernel row (``c1_k_source``, ``c1_fragment_word``:
every packed element once, each lane's two fragment halves adjacent words,
its 64-bit loads free of bank conflicts in each half-warp); the tile's
arithmetic (the staged rows, the A fragments read through that map and the
weights packed in the same order: the MMAs' sum is the plain version's
conv); the persistent walk (``c1_schedule``: every (image, segment, row)
once) and the input-row ring (``c1_row_slots``: each tile reads its five
rows, and no slot is refilled while a tile that may still run reads it).
K13: the piece map (``pad_source_piece``: the output rows it builds are the
plain version's, codes included) and the launch (``pad_grid``: every unit
of every row once).

The JAX side: mk13's oracle ``conv2d`` on its block input, and mk28's P2
kernel in interpret mode with the script's shape patched ragged (C = 8 and
64). The ``cuda`` cases import no JAX, so the card's machine runs them with
``--noconftest``: K11 within 1 bf16 ulp (floored at 2^-8 of the largest
magnitude) and ≥ 99% equal of both its plain version and its previous
core, K13 bit-identical to both, each new core bit-identical between two
launches.
"""

import numpy as np
import pytest
import torch

from neuralstyletransferv1_torch.experiments import _bench
from neuralstyletransferv1_torch.experiments import mk13_c1 as tmk13
from neuralstyletransferv1_torch.kernels import bf16_sites as k9
from neuralstyletransferv1_torch.kernels import int8_probes as k13
from neuralstyletransferv1_torch.kernels.int8_probes import SMEM_MAX


def _bf(a) -> np.ndarray:
    """Round to bf16, back as f32 numpy."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _c1_operands(seed, b, h, w, dev="cpu"):
    """y12 [b, h+4, w+4, 12] in [0, 1), weights [5,5,12,128] and bias."""
    rng = np.random.default_rng(seed)
    y12 = torch.from_numpy(rng.random((b, h + 4, w + 4, 12), dtype=np.float32))
    wt = torch.from_numpy(rng.normal(0, 0.1, (5, 5, 12, 128)).astype(np.float32))
    cb = torch.from_numpy(rng.normal(0, 0.2, 128).astype(np.float32))
    return y12.to(torch.bfloat16).to(dev), wt.to(torch.bfloat16).to(dev), cb.to(dev)


# ---------------------------------------------------------------------------
# K11: the new design's host-side contracts
# ---------------------------------------------------------------------------


def test_k11_smem_mirror_fits_a_block():
    """Alignment slack, the five kernel rows' weights, two output buffers a
    consumer warpgroup, 30 input rows of 1,664 bytes and the bias: one
    block an SM."""
    assert k9.C1_ROWS == 30
    assert k9.c1_site_smem_bytes() == 1024 + 5 * 16384 + 4 * 16384 + 30 * 1664 + 512 <= SMEM_MAX


def _phys(kc, t, h, e):
    """The physical element of a pixel's row that lane t's fragment half h,
    element e, reads at k16 step kc."""
    return 2 * k9.c1_fragment_word(0, kc, t, h) + e


def test_k11_k_order_is_a_permutation():
    """The 64 wgmma k of a kernel row read the 64 elements of a pixel's
    window once each, the first 60 (5 dx taps x 12 channels) carrying their
    weight and the last 4 a zero one; fragment halves h = 0, 1 of a lane are
    adjacent words (one 64-bit load)."""
    src = [k9.c1_k_source(k) for k in range(64)]
    assert sorted(q for q in src if q is not None) == list(range(60))
    assert src.count(None) == 4
    for kc in range(4):
        for t in range(4):
            for h in range(2):
                for e in range(2):
                    k = 16 * kc + 2 * t + 8 * h + e   # the mma fragment's k
                    q = _phys(kc, t, h, e)
                    assert (src[k] is None) == (q >= 60) and (src[k] is None or src[k] == q)
            assert k9.c1_fragment_word(5, kc, t, 1) == k9.c1_fragment_word(5, kc, t, 0) + 1


def test_k11_fragment_loads_are_conflict_free():
    """A warp's 64-bit loads of one k16 step (pixels 16w + g, or + 8): the
    16 lanes of each half-warp fall in 16 distinct bank pairs, at every
    warp, step and 8-byte-aligned row base."""
    for base in (0, 2, 416, 834):             # words: row slots are 1,664 bytes apart
        for w in range(4):
            for kc in range(4):
                for dp in (0, 8):
                    for half in range(2):
                        pairs = {(base + k9.c1_fragment_word(16 * w + g + dp, kc, t, 0)) // 2 % 16
                                 for g in range(4 * half, 4 * half + 4) for t in range(4)}
                        assert len(pairs) == 16


def _c1_tile_mirror(y12, wt, cb):
    """K11 as the card computes it, tile by tile: each 64-pixel tile's five
    staged rows (68 pixels of 12 channels and zeros to 1,664 bytes), A read
    through the fragment map, B the weights in the same k order, f32 sums
    of the five kernel rows + bias → bf16 [B,H,W,128]."""
    b_, hp, wp, _ = y12.shape
    H, W = hp - 4, wp - 4
    phys = torch.tensor([_phys(k // 16, (k % 8) // 2, (k % 16) // 8, k % 2) for k in range(64)])
    wf = wt.float()
    wrow = torch.zeros(5, 64, 128)
    for k in range(64):
        q = k9.c1_k_source(k)
        if q is not None:
            wrow[:, k] = wf[:, q // 12, q % 12]
    out = torch.empty(b_, H, W, 128)
    idx = 12 * torch.arange(k9.C1_SEG)[:, None] + phys[None, :]   # [64 px, 64 k]
    for b in range(b_):
        for x0 in range(0, W, k9.C1_SEG):
            n = min(k9.C1_SEG + 4, wp - x0)
            for y in range(H):
                acc = torch.zeros(k9.C1_SEG, 128)
                for dy in range(5):
                    row = torch.zeros(1664 // 2)
                    row[:12 * n] = y12[b, y + dy, x0:x0 + n].float().reshape(-1)
                    acc += row[idx] @ wrow[dy]
                nv = min(k9.C1_SEG, W - x0)
                out[b, y, x0:x0 + nv] = acc[:nv] + cb
    return out.to(torch.bfloat16)


# (B, H, W): a 1 × 1 output, W off the tile with an odd W + 4, two tiles
@pytest.mark.parametrize("b,h,w", [(1, 1, 1), (2, 3, 67), (1, 2, 129)])
def test_k11_tile_mirror_is_the_plain_conv(b, h, w):
    """The card's arithmetic, mirrored (staging, zero fill past the image's
    right edge, the permuted k order on both operands), against the plain
    version: within 1 bf16 ulp, ≥ 99% equal (the f32 sums run in another
    order)."""
    y12, wt, cb = _c1_operands(10 + w, b, h, w)
    ours = _c1_tile_mirror(y12, wt, cb)
    worst, equal = k9.bf16_ulp_error(ours, k9.c1_site_plain(y12, wt, cb))
    assert worst <= 1.0 and equal >= _bench.BF16_EQUAL_SHARE, (worst, equal)


# (B, H, W, SMs): fewer tiles than blocks, strips shorter than a run,
# 1080p B=8 on 132 SMs and on 7
@pytest.mark.parametrize("b,h,w,sms", [(1, 1, 1, 132), (3, 7, 130, 132), (2, 5, 67, 7),
                                       (8, 540, 960, 132), (8, 540, 960, 7)])
def test_k11_schedule_covers_every_tile_once(b, h, w, sms):
    """The persistent blocks' runs cover every (image, segment, output row)
    exactly once, each run in order, their lengths at most one apart, and
    no more blocks than SMs."""
    walks = k9.c1_schedule(b, h, w, sms)
    segs = -(-w // k9.C1_SEG)
    tiles = [t for walk in walks for t in walk]
    assert len(tiles) == b * segs * h
    assert set(tiles) == {(i, s, y) for i in range(b) for s in range(segs) for y in range(h)}
    assert all(walk == sorted(walk) for walk in walks)
    assert max(map(len, walks)) - min(map(len, walks)) <= 1
    assert len(walks) <= sms


@pytest.mark.parametrize("b,h,w,sms", [(1, 1, 70, 3), (3, 2, 130, 5), (2, 7, 67, 4),
                                       (8, 540, 960, 132)])
def test_k11_row_ring_holds_each_tiles_rows(b, h, w, sms):
    """Replaying each block's loads into the ring of ``C1_ROWS`` slots: every
    tile reads, for kernel row dy, input row y + dy of its own image and
    segment; and the loads of tile j + NB − 1, which land once tile j − 1
    is done, take no slot that a tile which may still run reads (the other
    warpgroup's tile j − 2, tiles j .. j + NB − 1)."""
    nb, nc = k9.C1_BUFFERS, k9.C1_CONSUMERS
    for walk in k9.c1_schedule(b, h, w, sms)[:8]:
        slots = k9.c1_row_slots(walk)
        loads, first = [], []   # (image, segment, input row) of each load; each tile's first
        for j, (i, s, y) in enumerate(walk):
            first.append(len(loads))
            loads += [(i, s, y + dy) for dy in (range(5) if j == 0 or y == 0 else (4,))]
        last = [f - 1 for f in first[1:]] + [len(loads) - 1]
        for j, (i, s, y) in enumerate(walk):
            reads = range(last[j] - 4, last[j] + 1)
            assert [lo % k9.C1_ROWS for lo in reads] == slots[j]
            assert [loads[lo] for lo in reads] == [(i, s, y + dy) for dy in range(5)]
            m = j + nb - 1
            if m < len(walk):
                new = set(range(first[m], last[m] + 1))
                live = {lo for t in range(j - nc, m + 1) if t >= 0 and t != j - 1
                        for lo in range(last[t] - 4, last[t] + 1)} - new
                assert not {lo % k9.C1_ROWS for lo in new} & {lo % k9.C1_ROWS for lo in live}


# ---------------------------------------------------------------------------
# K13: the new core's host-side contracts
# ---------------------------------------------------------------------------


def _pad_mirror(x, wp, inject):
    """K13 as the card builds each output row from ``pad_source_piece``: 8
    channels a piece, zeros where it reads none; P2 quantized."""
    b, r, w0, c = x.shape
    cpp = c // 8
    v = k13.quant_s8(x, k13.QSCALE_PAD) if inject else x
    pieces = v.reshape(b, r, w0 * cpp, 8)
    out = torch.zeros((b, r, wp * cpp, 8), dtype=v.dtype)
    for i in range(wp * cpp):
        src = k13.pad_source_piece(i, w0, cpp, inject)
        if src is not None:
            out[:, :, i] = pieces[:, :, src]
    out = out.reshape(b, r, wp, c)
    return out.to(torch.int8) if inject else out


# (B, R, W0, C, WP): the launch floor, C = 8 with an odd piece count a row,
# 64 and 128 (mk28's width)
@pytest.mark.parametrize("b,r,w0,c,wp", [(1, 1, 3, 8, 6), (2, 3, 17, 8, 21), (1, 4, 33, 8, 37),
                                         (2, 3, 17, 64, 23), (1, 2, 480, 128, 488)])
@pytest.mark.parametrize("inject", [False, True])
def test_k13_piece_map_is_the_plain_pad(b, r, w0, c, wp, inject):
    x = torch.from_numpy(np.random.default_rng(w0 + c).normal(0, 8, (b, r, w0, c))
                         .astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(_pad_mirror(x, wp, inject), k13.pad_inject_plain(x, wp, inject=inject))


@pytest.mark.parametrize("rows,wp,c,inject,units", [
    (1, 4, 8, False, 1), (1, 6, 8, True, 1), (4, 37, 8, True, 1), (8, 488, 128, True, 1),
    (8, 488, 128, False, 1), (2160, 488, 128, False, 4), (2160, 488, 128, True, 4),
    (70000, 21, 64, True, 4)])
def test_k13_grid_covers_every_unit_once(rows, wp, c, inject, units):
    """The blocks of a row cover its units once (the last block's threads
    past them store nothing); P2 pairs pieces for 16-byte stores only where
    a row holds an even count; a thread takes 4 units where that leaves two
    blocks an SM of 132 (the res site's input), 1 on mk28's strip and
    below; rows past the grid's 65,535 are walked by the y stride."""
    gx, gy, pc, u = k13.pad_grid(rows, wp, c, inject)
    nout = wp * c // 8
    assert pc == (2 if inject and nout % 2 == 0 else 1) and u == units
    per = k13.PAD_THREADS * u
    cover = [bx * per + k * k13.PAD_THREADS + tx for bx in range(gx)
             for k in range(u) for tx in range(k13.PAD_THREADS)]
    assert sorted(v for v in cover if v < nout // pc) == list(range(nout // pc))
    assert gy == min(rows, 65535) and sorted({r % gy for r in range(rows)}) == list(range(gy))


# ---------------------------------------------------------------------------
# the plain versions at ragged shapes against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,w", [(1, 3, 3), (3, 6, 134)])
def test_k11_plain_matches_mk13_oracle_at_ragged_shapes(b, h, w):
    """K11's plain version on mk13's block input (image h × w, W off the
    64-pixel tile) against the script's oracle ``conv2d(y12, c1_w, c1_b)``:
    within 1 bf16 ulp, ≥ 99% equal; no launch counted."""
    import jax.numpy as jnp

    from neuralstyletransferv1_tpu.models import transformer_net_s2d as s2d1
    from neuralstyletransferv1_tpu.models import transformer_net_s2d2 as s2d2
    from neuralstyletransferv1_tpu.ops.conv import conv2d

    rng = np.random.default_rng(h * w)
    x01 = _bf(rng.random((b, 2 * h, 2 * w, 3)))
    w_hwio = rng.normal(0, 0.1, (9, 9, 3, 32)).astype(np.float32)
    bias = rng.normal(0, 0.1, 32).astype(np.float32)
    wb, cb = tmk13.block_conv1_weights(w_hwio, bias)
    yj = s2d2._pad_reflect_f2_4px(s2d1.s2d(jnp.asarray(x01, jnp.bfloat16), 2), 3)
    ref = conv2d(yj, jnp.asarray(wb.float().numpy(), jnp.bfloat16),
                 jnp.asarray(cb.numpy(), jnp.bfloat16))
    before = dict(k9.LAUNCHES)
    out = k9.c1_site(tmk13.block_input(torch.from_numpy(x01).to(torch.bfloat16)), wb, cb)
    assert k9.LAUNCHES == before and tuple(out.shape) == (b, h, w, 128)
    worst, equal = k9.bf16_ulp_error(out, torch.from_numpy(np.array(ref.astype(jnp.float32))))
    assert worst <= 1.0 and equal >= _bench.BF16_EQUAL_SHARE, (worst, equal)


@pytest.mark.parametrize("r,w0,c", [(3, 17, 8), (2, 33, 64)])
def test_k13_plain_matches_mk28_p2_at_ragged_shapes(monkeypatch, r, w0, c):
    """mk28's P2 kernel in interpret mode with the script's shape patched to
    R × W0 × C → WP = W0 + 4 (C = 8, 64): K13's plain version, and its
    piece-map mirror, bit for bit against the kernel's codes (the script's
    own asserts pass)."""
    import jax.experimental.pallas as pl

    from experiments import mk28_probe as jmk28

    orig, seen = pl.pallas_call, []

    def pallas_call(*a, **k):
        f = orig(*a, interpret=True, **k)

        def run(*args):
            out = f(*args)
            seen.append((np.asarray(args[0]), np.asarray(out)))
            return out
        return run

    wp = w0 + 4
    monkeypatch.setattr(pl, "pallas_call", pallas_call)
    for name, v in (("R", r), ("W0", w0), ("C", c), ("WP", wp)):
        monkeypatch.setattr(jmk28, name, v)
    jmk28.p2_inject()
    x, out = seen[0]
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    ours = k13.pad_inject(xt, wp, inject=True)
    assert ours.dtype == torch.int8 and np.array_equal(ours.numpy(), out)
    assert torch.equal(_pad_mirror(xt, wp, True), ours)


# ---------------------------------------------------------------------------
# dispatch on the CPU
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors K11 and K13 return their plain versions' results and
    count no launch."""
    y12, wt, cb = _c1_operands(3, 1, 3, 9)
    x = torch.randn((1, 2, 5, 8)).to(torch.bfloat16)
    before9, before13 = dict(k9.LAUNCHES), dict(k13.LAUNCHES)
    assert torch.equal(k9.c1_site(y12, wt, cb), k9.c1_site_plain(y12, wt, cb))
    for inject in (False, True):
        assert torch.equal(k13.pad_inject(x, 8, inject=inject),
                           k13.pad_inject_plain(x, 8, inject=inject))
    assert k9.LAUNCHES == before9 and k13.LAUNCHES == before13


def test_prev_forms_refuse_cpu_tensors():
    before9, before13 = dict(k9.LAUNCHES), dict(k13.LAUNCHES)
    with pytest.raises(NotImplementedError, match="no kernel for device cpu"):
        k9.c1_site_prev(*_c1_operands(4, 1, 3, 9))
    with pytest.raises(NotImplementedError, match="no kernel for device cpu"):
        k13.pad_inject_prev(torch.zeros((1, 2, 5, 8), dtype=torch.bfloat16), 8)
    assert k9.LAUNCHES == before9 and k13.LAUNCHES == before13


# ---------------------------------------------------------------------------
# on the card: the new cores against the plain versions and the previous ones
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K11 and K13 are CUDA kernels with no CPU mode)")
    from neuralstyletransferv1_torch.device import resolve_device

    return resolve_device("cuda")


#: (B, H, W) of K11's output: a 1 × 1 output, W off the tile with B = 3, an
#: odd W + 4, one whole tile, H below a strip, the 1080p B=8 shape
K11_CARD_CASES = [(1, 1, 1), (3, 2, 70), (1, 5, 131), (2, 7, 64), (3, 4, 129), (8, 540, 960)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", K11_CARD_CASES)
def test_k11_new_core_matches_plain_and_previous_on_card(cuda_device, b, h, w):
    """K11 on ``c1_wgmma_kernel``: two launches bit-identical, within 1 ulp
    of the plain version and of the previous core, ≥ 99% equal, one launch
    counted each; the previous core counts none, and a misaligned y12
    raises."""
    y12, wt, cb = _c1_operands(140 + h + w, b, h, w, cuda_device)
    before = dict(k9.LAUNCHES)
    out, again = k9.c1_site(y12, wt, cb), k9.c1_site(y12, wt, cb)
    prev, ref = k9.c1_site_prev(y12, wt, cb), k9.c1_site_plain(y12, wt, cb)
    torch.cuda.synchronize()
    assert k9.LAUNCHES == {**before, "c1_site": before["c1_site"] + 2}
    _bench.check("c1_site", out, again, ref)
    _bench.check("c1_site vs previous", out, again, prev)
    off = torch.empty(y12.numel() + 1, dtype=y12.dtype, device=cuda_device)[1:].view(y12.shape)
    off.copy_(y12)
    with pytest.raises(ValueError, match="16-byte"):
        k9.c1_site(off, wt, cb)


#: (B, R, W0, C, WP): mk28's strip, the res site's input, ragged widths at
#: C = 8 (an odd piece count a row), 64 and 128, the launch floor
K13_CARD_CASES = [(1, 8, 480, 128, 488), (8, 270, 480, 128, 488), (2, 3, 17, 8, 21),
                  (1, 4, 33, 8, 37), (2, 3, 37, 64, 45), (3, 2, 7, 128, 11), (1, 1, 3, 8, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("b,r,w0,c,wp", K13_CARD_CASES)
def test_k13_new_core_matches_plain_and_previous_on_card(cuda_device, inject, b, r, w0, c, wp):
    """K13 on ``pad_inject_v2_kernel``: bit-identical to the plain version
    and to the previous core, two launches bit-identical, one launch
    counted each; the previous core counts none."""
    x = _bench.normal(np.random.default_rng(r * w0 + c), (b, r, w0, c), 8.0, cuda_device)
    before = k13.LAUNCHES["pad_inject"]
    res, again = (k13.pad_inject(x, wp, inject=inject) for _ in range(2))
    prev = k13.pad_inject_prev(x, wp, inject=inject)
    ref = k13.pad_inject_plain(x, wp, inject=inject)
    torch.cuda.synchronize()
    assert k13.LAUNCHES["pad_inject"] - before == 2
    _bench.check("pad_inject", res, again, ref, exact=True)
    assert torch.equal(prev, ref)


@pytest.mark.cuda
def test_smem_mirror_matches_the_source_on_card(cuda_device):
    """The Python mirror answers as the source's own entry."""
    assert k9._lib().c1_wgmma_smem_bytes() == k9.c1_site_smem_bytes()

