"""K7 (``d3_rows_site``) with an f32 input: the float32 chains' XLA-form
decoder hands deconv3's rows site its f32 d2 raw, which the JAX K7 reads
unrounded (``v.astype(float32)·a + c``; ``models/s2d2_sites_i8.py``
``_d3_kernel``). The port's K7 takes it through its f32 form
(``F32_FORMS[("d3_rows_site", "rows")]``, counted as ``d3_rows_site_f32``):
the same ``d3rows_mma_kernel`` at 6 warps a block, each warp's landing row
holding the raw row as f32 (``d3_rows_smem_bytes(f32=True)``,
``d3_rows_schedule(f32=True)``).

On the CPU the plain version meets ``d3_rows_site`` in interpret mode on
the same f32 body: bit for bit where the quantize scale is a power of two
(x·a is then exact, so no contraction of x·a + c into an FMA can flip a
code; the dequant row likewise), on ≥ 99.9% of the outputs at random
scales. The ``cuda`` cases import no JAX, so the card's machine runs them
with ``--noconftest``: the f32 form bit for bit its plain version at ragged
shapes and at the 1080p B=8 grid, two launches bit-identical, one launch
counted each.
"""

import numpy as np
import pytest
import torch

from neuralstyletransferv1_torch.kernels import int8_sites as k8
from neuralstyletransferv1_torch.kernels.int8_probes import SMEM_MAX


def _operands(seed, b, h, w, pow2):
    """K7's operands with an f32 raw that is not bf16-representable; with
    ``pow2`` the quantize scale and the dequant row are powers of two."""
    rng = np.random.default_rng(seed)

    def scale(lo, hi, shape):
        v = rng.uniform(lo, hi, shape)
        return np.asarray(2.0 ** np.round(np.log2(v)) if pow2 else v, np.float32)

    return {"y": np.asarray(rng.normal(0, 2, (b, h, w, 128)), np.float32),
            "a": scale(4, 40, (b, 128)),
            "c": np.asarray(rng.normal(0, 8, (b, 128)), np.float32),
            "w5": rng.integers(-127, 128, (1, 5, 128, 60)).astype(np.int8),
            "ws": scale(0.5 / (127 * 127 * 20), 2 / (127 * 127 * 20), 60)}


def _torch(d, dev="cpu"):
    t = {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
    return (t["y"], t["a"], t["c"], k8.pack_weights(t["w5"], co_pad=k8.CO_TILE),
            torch.cat([t["ws"], torch.zeros(4, device=dev)]))


# (B, H, W): heights below the 8-row tile, widths off the 32-column strip
@pytest.mark.parametrize("b,h,w", [(1, 5, 45), (2, 8, 40)])
@pytest.mark.parametrize("pow2", [True, False], ids=["pow2", "random"])
def test_k7_f32_plain_matches_pallas(b, h, w, pow2):
    """The f32 form's plain version against the JAX ``d3_rows_site`` on the
    same f32 body, Pallas in interpret mode; no launch counted."""
    import jax.numpy as jnp

    from neuralstyletransferv1_tpu.models import s2d2_sites_i8 as si8

    d = _operands(30 + h + w, b, h, w, pow2)
    si8._INTERPRET = True
    try:
        ref = np.asarray(si8.d3_rows_site(jnp.asarray(d["y"]), jnp.asarray(d["a"]),
                                          jnp.asarray(d["c"]), jnp.asarray(d["w5"][0]),
                                          jnp.asarray(d["ws"])).astype(jnp.float32))
    finally:
        si8._INTERPRET = False
    before = dict(k8.F32_LAUNCHES)
    args = _torch(d)
    ours = k8.d3_rows_site(*args)
    assert k8.F32_LAUNCHES == before
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (b, h, w, 60)
    share = (ours.float().numpy() == ref).mean()
    assert share == 1.0 if pow2 else share >= 0.999, share
    rounded = k8.d3_rows_site(args[0].to(torch.bfloat16), *args[1:])
    assert not torch.equal(rounded, ours)  # the f32 raw is not its bf16 rounding


def test_k7_f32_smem_mirror_fits_a_block():
    """The f32 form's block: the weights (46,080) and, per warp of 6, a
    landing row of 36 raw f32 pixels (18,432) and two code slots (10,368);
    at 8 warps it would not fit."""
    assert k8.d3_rows_warps(True) == 6 and k8.d3_rows_warps() == k8.D3_WARPS == 8
    assert k8.d3_rows_smem_bytes(True) == 46080 + 6 * (18432 + 10368) == 218880 <= SMEM_MAX
    assert 46080 + 8 * (18432 + 10368) > SMEM_MAX


@pytest.mark.parametrize("b,h,w,sms", [(1, 2, 2, 132), (3, 7, 70, 132), (2, 75, 33, 3),
                                       (8, 540, 960, 132)])
def test_k7_f32_schedule_covers_every_item_once(b, h, w, sms):
    """At 6 warps a block the walk still takes every (image, strip, row)
    item exactly once, in order, the shares at most one apart."""
    shares = k8.d3_rows_schedule(b, h, w, sms, f32=True)
    strips = -(-w // k8.D3_STRIP)
    items = [it for share in shares for it in share]
    assert items == sorted(items) and len(items) == b * strips * h
    assert len(set(items)) == len(items)
    sizes = [len(share) for share in shares]
    assert max(sizes) - min(sizes) <= 1
    assert len(shares) % 6 == 0 and len(shares) <= sms * 6


def test_k7_f32_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper returns the plain version's result for an
    f32 y and counts nothing."""
    args = _torch(_operands(40, 2, 3, 20, False))
    before, f32_before = dict(k8.LAUNCHES), dict(k8.F32_LAUNCHES)
    assert torch.equal(k8.d3_rows_site(*args), k8.d3_rows_site_plain(*args))
    assert k8.LAUNCHES == before and k8.F32_LAUNCHES == f32_before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K7 is a CUDA kernel with no CPU mode)")
    from neuralstyletransferv1_torch.device import resolve_device

    return resolve_device("cuda")


#: (B, H, W): widths off the strip, heights below the tile, one and three
#: images, a 2 × 2 image, and the 1080p B=8 grid
CARD_CASES = [(1, 5, 45), (3, 7, 70), (1, 3, 33), (3, 13, 100), (1, 2, 2), (8, 540, 960)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", CARD_CASES)
def test_k7_f32_form_matches_plain_on_card(cuda_device, b, h, w):
    """The f32 form: two launches bit-identical and bit for bit the plain
    version, counted in ``F32_LAUNCHES`` and not as the bf16 form; a
    misaligned y and an f16 y raise."""
    args = _torch(_operands(50 + h + w, b, h, w, False), cuda_device)
    before, bf16_before = k8.F32_LAUNCHES["d3_rows_site_f32"], k8.LAUNCHES["d3_rows_site"]
    rows, again = k8.d3_rows_site(*args), k8.d3_rows_site(*args)
    ref = k8.d3_rows_site_plain(*args)
    torch.cuda.synchronize()
    assert k8.F32_LAUNCHES["d3_rows_site_f32"] - before == 2
    assert k8.LAUNCHES["d3_rows_site"] == bf16_before
    assert torch.equal(rows, again) and torch.equal(rows, ref)
    y = args[0]
    off = torch.empty(y.numel() + 1, dtype=y.dtype, device=y.device)[1:].view(y.shape)
    off.copy_(y)
    with pytest.raises(ValueError, match="16-byte"):
        k8.d3_rows_site(off, *args[1:])
    with pytest.raises(TypeError):
        k8.d3_rows_site(y.half(), *args[1:])


@pytest.mark.cuda
def test_k7_f32_smem_mirror_matches_the_source_on_card(cuda_device):
    assert k8._lib().d3rows_mma_f32_smem_bytes() == k8.d3_rows_smem_bytes(True)
    assert k8._lib().d3rows_mma_smem_bytes() == k8.d3_rows_smem_bytes()
