"""DIS optical flow (Dense Inverse Search), batched over frame pairs.

Counterpart of ``neuralstyletransferv1_tpu/ops/dis_flow.py`` (its
``_PREWARP`` + Pallas-iteration configuration, the engine default). The JAX
engine maps ``dis_flow`` over pairs with ``jax.vmap``; here the pair batch is
an explicit leading dimension, and every pyramid level makes one K1 launch
(``kernels/dis_iter.py``) for all pairs' patches.

Per level, coarse → fine: pre-warp I1 by the upsampled coarse flow, cut each
8×8 patch's (8+2R)² neighbourhood (stride 4), run the Gauss–Newton
iterations (K1), and densify the patch offsets weighted by their inverse
residual. Then variational refinement at the finest level, a σ=1 blur there,
and a bilinear upsample to the input size.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.dis_iter import dis_iter
from .blur import gaussian_blur
from .resize import resize_bilinear

PATCH = 8
STRIDE = 4
NB_RADIUS = 6


def _level_sizes(H, W, finest_scale, coarsest_px=16):
    """Static list of pyramid levels, coarse→fine, finest = 1/2^finest_scale."""
    sizes = []
    k = finest_scale
    while True:
        h, w = H >> k, W >> k
        if min(h, w) < coarsest_px or k > 10:
            break
        sizes.append((h, w, k))
        k += 1
    return sizes[::-1]


def _gradient(x: torch.Tensor):
    """(d/dy, d/dx) of [B,h,w]: central differences, one-sided at the edges
    (``jnp.gradient``)."""
    gy, gx = torch.gradient(x, dim=(1, 2), edge_order=1)
    return gy, gx


def _patches(img: torch.Tensor, size: int) -> torch.Tensor:
    """[B,h,w] → [B,ny,nx,size,size] windows at stride 4."""
    return img.unfold(1, size, STRIDE).unfold(2, size, STRIDE)


def _bilinear_dense(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sample [B,h,w] at float coords [B,h',w'], clamped to [0, h - 1.001]."""
    b, h, w = img.shape
    y = y.clamp(0.0, h - 1.001)
    x = x.clamp(0.0, w - 1.001)
    y0, x0 = torch.floor(y), torch.floor(x)
    fy, fx = y - y0, x - x0
    yi, xi = y0.long(), x0.long()
    flat = img.reshape(b, h * w)

    def take(yo, xo):
        idx = (yi + yo).clamp_max(h - 1) * w + (xi + xo).clamp_max(w - 1)
        return torch.gather(flat, 1, idx.reshape(b, -1)).reshape(y.shape)

    v00, v01, v10, v11 = take(0, 0), take(0, 1), take(1, 0), take(1, 1)
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def _warp_scalar(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear warp of [B,h,w] by flow [B,h,w,2] (dx, dy), clamped borders."""
    h, w = img.shape[1], img.shape[2]
    yy = torch.arange(h, device=img.device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=img.device, dtype=torch.float32)[None, :]
    return _bilinear_dense(img, yy + flow[..., 1], xx + flow[..., 0])


def _densify(u: torch.Tensor, wgt: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Residual-weighted average of the patches covering each pixel: with
    stride 4 and 8×8 patches, pixel (y, x) is covered by patches (y//4, x//4)
    and their −1 neighbours, so it is a ×4 nearest upsample plus one shifted
    add per axis. u [B,ny,nx,2], wgt [B,ny,nx] → [B,h,w,2]."""
    ny, nx = u.shape[1], u.shape[2]
    s = PATCH // 2
    P = torch.cat([u * wgt[..., None], wgt[..., None]], dim=-1)
    U = P.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)
    U = F.pad(U, (0, 0, 0, w - s * nx, 0, h - s * ny))
    C = U + F.pad(U, (0, 0, s, 0))[:, :, :w]
    A = C + F.pad(C, (0, 0, 0, 0, s, 0))[:, :h]
    return A[..., :2] / A[..., 2:].clamp_min(1e-8)


def _level_inputs(i0, i1, flow_init, R: int = NB_RADIUS) -> dict:
    """K1's inputs for one pyramid level, each [B,ny,nx,...]: template
    patches and gradients, their 2×2 Hessian, the init displacement at the
    patch centres and the pre-warped neighbourhoods."""
    h, w = i0.shape[1], i0.shape[2]
    NBW = PATCH + 2 * R

    t_p = _patches(i0, PATCH)                                     # [B,ny,nx,8,8]
    ny, nx = t_p.shape[1], t_p.shape[2]
    gy_img, gx_img = _gradient(i0)
    gx_p = _patches(gx_img, PATCH)
    gy_p = _patches(gy_img, PATCH)
    hxx = (gx_p * gx_p).sum(dim=(-2, -1))
    hxy = (gx_p * gy_p).sum(dim=(-2, -1))
    hyy = (gy_p * gy_p).sum(dim=(-2, -1))
    det = hxx * hyy - hxy * hxy
    det = torch.where(det.abs() < 1e-6, torch.full_like(det, 1e-6), det)

    fy_init = flow_init if flow_init.shape[1:3] == (h, w) else resize_bilinear(flow_init, (h, w))
    # init displacement sampled at the (integer-truncated) patch centres
    cy = (torch.arange(ny, device=i0.device) * STRIDE + PATCH // 2).clamp(0, h - 1)
    cx = (torch.arange(nx, device=i0.device) * STRIDE + PATCH // 2).clamp(0, w - 1)
    u0 = fy_init[:, cy][:, :, cx]                                 # [B,ny,nx,2]

    # pre-warp: I1 warped once by the dense init flow, so each patch's ±R
    # neighbourhood is a static strided window of the edge-padded result
    i1w = _warp_scalar(i1, fy_init)
    i1p = F.pad(i1w[:, None], (R, R, R, R), mode="replicate")[:, 0]
    nb = _patches(i1p, NBW)                                       # [B,ny,nx,NBW,NBW]
    return dict(nb=nb, t=t_p, gx=gx_p, gy=gy_p, hxx=hxx, hxy=hxy, hyy=hyy, det=det,
                u0=u0, lo=u0 - R)


def _inverse_search_level(i0, i1, flow_init, iters: int, nb_radius: int = NB_RADIUS):
    """One pyramid level for a batch of pairs: i0, i1 [B,h,w], flow_init
    [B,h,w,2] → dense flow [B,h,w,2]. One K1 launch covers every pair."""
    b, h, w = i0.shape
    k1 = _level_inputs(i0, i1, flow_init, nb_radius)
    ny, nx = k1["t"].shape[1], k1["t"].shape[2]
    n = b * ny * nx
    flat = {k: v.reshape((n,) + v.shape[3:]).contiguous() for k, v in k1.items()}
    u, res = dis_iter(**flat, iters=iters, R=nb_radius)
    u = u.reshape(b, ny, nx, 2)
    res = res.reshape(b, ny, nx)
    wgt = 1.0 / (1.0 + res * res)
    return _densify(u, wgt, h, w)


def _nb_avg(f: torch.Tensor) -> torch.Tensor:
    """4-neighbour average of [B,h,w], edge-replicated."""
    up = torch.cat([f[:, :1], f[:, :-1]], dim=1)
    dn = torch.cat([f[:, 1:], f[:, -1:]], dim=1)
    lf = torch.cat([f[:, :, :1], f[:, :, :-1]], dim=2)
    rt = torch.cat([f[:, :, 1:], f[:, :, -1:]], dim=2)
    return (up + dn + lf + rt) / 4.0


def variational_refine(i0, i1, flow, *, fixed_point_iters: int = 5, alpha: float = 12.0,
                       eps: float = 1e-3):
    """Charbonnier brightness-constancy + smoothness refinement by lagged-
    diffusivity fixed point, on one linearization of I1 warped at the input
    flow. i0, i1 [B,h,w], flow [B,h,w,2] → [B,h,w,2]."""
    i1w = _warp_scalar(i1, flow)
    gy, gx = _gradient(i1w)
    it0 = i1w - i0
    u0 = flow
    u = flow
    g2 = gx * gx + gy * gy
    for _ in range(fixed_point_iters):
        it = it0 + gx * (u[..., 0] - u0[..., 0]) + gy * (u[..., 1] - u0[..., 1])
        wd = torch.rsqrt(it * it + eps)
        duy, dux = _gradient(u[..., 0])
        dvy, dvx = _gradient(u[..., 1])
        ws = torch.rsqrt(duy ** 2 + dux ** 2 + dvy ** 2 + dvx ** 2 + eps)
        ubar_x, ubar_y = _nb_avg(u[..., 0]), _nb_avg(u[..., 1])
        denom = (alpha * ws + wd * g2).clamp_min(1e-6)
        num = wd * (gx * (ubar_x - u[..., 0]) + gy * (ubar_y - u[..., 1]) - it)
        common = num / denom
        a_s = alpha * ws / denom
        a_d = wd * g2 / denom
        u = torch.stack([ubar_x * a_s + (u[..., 0] + gx * common) * a_d,
                         ubar_y * a_s + (u[..., 1] + gy * common) * a_d], dim=-1)
    return u


def dis_flow(prev_gray: torch.Tensor, curr_gray: torch.Tensor, *, finest_scale: int = 2,
             iters: int = 16, refine_iters: int = 5, smooth_sigma: float = 1.0,
             nb_radius: int = NB_RADIUS) -> torch.Tensor:
    """Dense flow prev→curr for a batch of pairs, cv2 convention
    (flow[b, y, x] = (dx, dy)). prev_gray, curr_gray [B,H,W] → [B,H,W,2]."""
    b, H, W = prev_gray.shape
    i0 = prev_gray.float()
    i1 = curr_gray.float()
    levels = _level_sizes(H, W, finest_scale)
    if not levels:
        return torch.zeros((b, H, W, 2), dtype=torch.float32, device=i0.device)

    flow = None
    for lh, lw, _k in levels:
        a = resize_bilinear(i0[..., None], (lh, lw))[..., 0]
        c = resize_bilinear(i1[..., None], (lh, lw))[..., 0]
        if flow is None:
            flow = torch.zeros((b, lh, lw, 2), dtype=torch.float32, device=i0.device)
        else:
            flow = resize_bilinear(flow, (lh, lw)) * 2.0
        flow = _inverse_search_level(a, c, flow, iters, nb_radius)

    if refine_iters > 0:
        lh, lw, _ = levels[-1]
        a = resize_bilinear(i0[..., None], (lh, lw))[..., 0]
        c = resize_bilinear(i1[..., None], (lh, lw))[..., 0]
        flow = variational_refine(a, c, flow, fixed_point_iters=refine_iters)

    # smoothing at the finest level, before the upsample (it commutes with
    # the linear upsample and is 2^(2*finest_scale) times cheaper there)
    if smooth_sigma > 0:
        flow = gaussian_blur(flow, smooth_sigma)
    scale = H / flow.shape[1]
    return resize_bilinear(flow, (H, W)) * scale
