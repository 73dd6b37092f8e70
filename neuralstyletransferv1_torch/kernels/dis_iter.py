"""K1: the DIS per-patch Gauss–Newton iterations (``csrc/dis_iter.cu``).

Replaces ``neuralstyletransferv1_tpu/ops/dis_flow.py::_iter_search_pallas``
(kernel ``_iter_kernel``). Contract, for N patches (pairs × ny × nx):

  nb [N, P+2R, P+2R]   pre-warped I1 neighbourhood of each 8×8 patch
  t, gx, gy [N, 8, 8]  template patch and its x/y gradients
  hxx, hxy, hyy, det [N]  2×2 Hessian and its floored determinant
  u0, lo [N, 2]        init displacement and the window's low corner (dx, dy)
  → (u [N, 2], res [N])  refined displacement and mean |warped − t|

Each of ``iters`` steps samples the patch bilinearly at offset o = u − lo,
solves du = H⁻¹J with J = (Σ gx·r, Σ gy·r), r = warped − t, clips du to ±4
and clamps o to [0, 2R − 1e-3]. ``dis_iter`` dispatches on the tensors'
device: CPU → ``dis_iter_plain``; CUDA → the kernel, or an error.

On the card (``dis_iter_kernel``) 8 lanes take a patch, one patch column
each, 4 patches a warp and 32 a 256-thread block (``lane_layout``): a lane
samples its column's 8 pixels a step and each J sum adds them in the lane
as the first core's lanes did, then 3 shuffle levels in the patch's group,
so the results are the first core's bit for bit. The warp's 4
neighbourhoods sit in shared memory interleaved word by word with an odd
row stride (``nb_word``), so a sample's reads and the staging stores fall
in 32 distinct banks. 1/det and u0 − lo are computed in the kernel: a
level is one launch. nb is read 16 bytes at a time where 8 + 2R is a
multiple of 4 (nb, t, gx and gy 16-byte aligned). ``dis_iter_prev`` runs
the first core (one warp a patch) for timing: CUDA tensors only, no launch
counted.
"""

from __future__ import annotations

import ctypes
import functools

import torch

PATCH = 8
LAUNCHES = 0
_SOURCE = "dis_iter.cu"
#: the card's layout: lanes a patch (one a patch column), warps a block
GROUP, WARPS = 8, 8
PATCHES_PER_BLOCK = WARPS * 32 // GROUP


def _hi(R: int) -> float:
    return 2 * R - 1e-3


def nb_stride(nbw: int) -> int:
    """The odd row stride of a staged neighbourhood (``nb_stride``)."""
    return nbw | 1


def nb_word(r: int, c: int, q: int, nbw: int) -> int:
    """The shared-memory word of element (r, c) of patch slot q (0..3) of a
    warp's interleaved neighbourhoods (``nb_word``): 4(r·S + c) + q."""
    return 4 * (r * nb_stride(nbw) + c) + q


def smem_bytes(nbw: int) -> int:
    """A block's dynamic shared memory (``dis_iter_smem_bytes``): 8 warps ×
    4 neighbourhoods of nbw rows at the stride, f32."""
    return WARPS * 4 * nbw * nb_stride(nbw) * 4


def lane_layout(n: int) -> list:
    """The card's lane → work map for n patches: per (block, warp, lane)
    the patch it computes on, its patch column, and whether it stores (its
    group's lane 0 of a patch index below n). A tail slot computes on the
    last patch and stores nothing."""
    out = []
    for blk in range(-(-n // PATCHES_PER_BLOCK)):
        for warp in range(WARPS):
            p0 = (blk * WARPS + warp) * (32 // GROUP)
            for lane in range(32):
                q, i = divmod(lane, GROUP)
                out.append((blk, warp, lane, min(p0 + q, n - 1), i, i == 0 and p0 + q < n))
    return out


def _sample(nb: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor) -> torch.Tensor:
    """[N,NBW,NBW] neighbourhoods sampled at offsets (ox, oy) [N] → [N,8,8]:
    bilinear over rows, then over columns."""
    n, nbw = nb.shape[0], nb.shape[1]
    ar = torch.arange(PATCH, device=nb.device)
    fyf, fxf = torch.floor(oy), torch.floor(ox)
    fy, fx = (oy - fyf)[:, None, None], (ox - fxf)[:, None, None]
    rows = fyf.long()[:, None] + ar                              # [N,8]
    top = torch.gather(nb, 1, rows[:, :, None].expand(n, PATCH, nbw))
    bot = torch.gather(nb, 1, (rows + 1)[:, :, None].expand(n, PATCH, nbw))
    r = (1.0 - fy) * top + fy * bot                              # [N,8,NBW]
    cols = (fxf.long()[:, None] + ar)[:, None, :].expand(n, PATCH, PATCH)
    left = torch.gather(r, 2, cols)
    right = torch.gather(r, 2, cols + 1)
    return (1.0 - fx) * left + fx * right


def dis_iter_plain(nb, t, gx, gy, hxx, hxy, hyy, det, u0, lo, *, iters: int = 16,
                   R: int = 6):
    """Plain PyTorch version of K1 (same contract, gathers instead of shared
    memory)."""
    inv_det = 1.0 / det
    o = u0 - lo
    ox, oy = o[:, 0], o[:, 1]
    hi = _hi(R)
    step = PATCH / 2
    for _ in range(iters):
        r = _sample(nb, ox, oy) - t
        j0 = (gx * r).sum(dim=(1, 2))
        j1 = (gy * r).sum(dim=(1, 2))
        du_x = ((hyy * j0 - hxy * j1) * inv_det).clamp(-step, step)
        du_y = ((hxx * j1 - hxy * j0) * inv_det).clamp(-step, step)
        ox = (ox - du_x).clamp(0.0, hi)
        oy = (oy - du_y).clamp(0.0, hi)
    res = (_sample(nb, ox, oy) - t).abs().mean(dim=(1, 2))
    return torch.stack([ox, oy], dim=-1) + lo, res


def _check(name, x, shape, device):
    if x.device != device:
        raise ValueError(f"dis_iter: {name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"dis_iter: {name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"dis_iter: {name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"dis_iter: {name} must be contiguous")


@functools.cache
def _lib():
    from ._build import load_library

    lib = load_library(_SOURCE)
    for name in ("dis_iter_launch", "dis_iter_prev_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.dis_iter_smem_bytes.argtypes = [ctypes.c_int]
    lib.dis_iter_smem_bytes.restype = ctypes.c_int
    return lib


def dis_iter(nb, t, gx, gy, hxx, hxy, hyy, det, u0, lo, *, iters: int = 16, R: int = 6):
    """K1 on the tensors' device: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (no fallback between the two)."""
    if nb.device.type == "cpu":
        return dis_iter_plain(nb, t, gx, gy, hxx, hxy, hyy, det, u0, lo, iters=iters, R=R)
    return _launch(False, nb, t, gx, gy, hxx, hxy, hyy, det, u0, lo, iters, R)


def dis_iter_prev(nb, t, gx, gy, hxx, hxy, hyy, det, u0, lo, *, iters: int = 16, R: int = 6):
    """K1 on its first core (one warp a patch; 1/det and u0 − lo as two
    PyTorch ops first), CUDA tensors only: ``chip_smoke.py`` times it beside
    ``dis_iter``. Nothing on the main path calls it, and it counts no
    launch."""
    return _launch(True, nb, t, gx, gy, hxx, hxy, hyy, det, u0, lo, iters, R)


def _launch(prev, nb, t, gx, gy, hxx, hxy, hyy, det, u0, lo, iters, R):
    global LAUNCHES
    if nb.device.type != "cuda":
        raise NotImplementedError(f"dis_iter: no kernel for device {nb.device}")
    n, nbw = nb.shape[0], PATCH + 2 * R
    dev = nb.device
    _check("nb", nb, (n, nbw, nbw), dev)
    for name, x in (("t", t), ("gx", gx), ("gy", gy)):
        _check(name, x, (n, PATCH, PATCH), dev)
    for name, x in (("hxx", hxx), ("hxy", hxy), ("hyy", hyy), ("det", det)):
        _check(name, x, (n,), dev)
    for name, x in (("u0", u0), ("lo", lo)):
        _check(name, x, (n, 2), dev)
    if not prev:  # read 16 bytes at a time
        for name, x in (("nb", nb), ("t", t), ("gx", gx), ("gy", gy)):
            if x.data_ptr() % 16:
                raise ValueError(f"dis_iter: {name} must start on a 16-byte boundary")
    lib = _lib()
    with torch.cuda.device(dev):
        if prev:
            fn, d, o = lib.dis_iter_prev_launch, 1.0 / det, u0 - lo
        else:
            fn, d, o = lib.dis_iter_launch, det, u0
        u = torch.empty((n, 2), dtype=torch.float32, device=dev)
        res = torch.empty((n,), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(nb.data_ptr(), t.data_ptr(), gx.data_ptr(), gy.data_ptr(), hxx.data_ptr(),
                hxy.data_ptr(), hyy.data_ptr(), d.data_ptr(), o.data_ptr(), lo.data_ptr(),
                u.data_ptr(), res.data_ptr(), n, nbw, iters, _hi(R), stream)
    if rc != 0:
        raise RuntimeError(f"dis_iter kernel launch failed: CUDA error {rc}")
    if not prev:
        LAUNCHES += 1
    return u, res
