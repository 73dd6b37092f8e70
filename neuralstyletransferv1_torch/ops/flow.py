"""Dense optical flow (Farneback), batched over frame pairs.

Counterpart of ``neuralstyletransferv1_tpu/ops/flow.py`` (``--flow_method
farneback``; OpenCV's ``calcOpticalFlowFarneback`` with 0.5/3/15/3/5/1.1/0).
The JAX engine maps ``farneback_flow`` over pairs with ``jax.vmap``; here
the pair batch is an explicit leading dimension. No custom kernel: every
step is a depthwise separable convolution or elementwise (the JAX function
is XLA, no ``pallas_call``).

Per level, coarse → fine: blur the original images with sigma
``(1/scale − 1)·0.5`` and resize them (antialiased bilinear) to the level;
expand both into quadratic polynomials under a Gaussian applicability (six
moments from separable 1-D correlations, times the constant ``G⁻¹``); then
iterate: fetch the second image's coefficients at the rounded ``p + d``
(clamped), build the normal equations, box-filter them over ``winsize`` and
solve the 2×2 system per pixel. The flow goes up ×2 between levels.

Kept as the JAX function has them: the level sizes use Python's ``round``
(half to even); ``det`` becomes +1e-9 wherever ``|det| < 1e-9``, whatever
its sign; the final upsample scales both components by ``H / h``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .blur import gaussian_blur
from .resize import resize_bilinear


def _poly_exp_setup(n: int, sigma: float, device=None):
    """The applicability kernels g, x·g, x²·g and G⁻¹ for the basis
    [1, x, y, x², y², xy], computed in float64 and rounded to f32."""
    xs = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = xs * g
    xxg = xs * xs * g
    s0 = g.sum()
    s2 = (xs ** 2 * g).sum()
    s4 = (xs ** 4 * g).sum()
    G = np.zeros((6, 6))
    G[0, 0] = s0 * s0
    G[1, 1] = G[2, 2] = s2
    G[0, 3] = G[3, 0] = G[0, 4] = G[4, 0] = s2
    G[3, 3] = G[4, 4] = s4
    G[3, 4] = G[4, 3] = s2 * s2
    G[5, 5] = s2 * s2
    Ginv = np.linalg.inv(G)
    return tuple(torch.tensor(a, dtype=torch.float32, device=device) for a in (g, xg, xxg, Ginv))


def _sep_conv(img: torch.Tensor, pairs) -> torch.Tensor:
    """Separable 2-D correlations of [N,H,W] with replicate border, one per
    (kx, ky) pair: the ky pass down the rows first, then kx along them (the
    JAX ``_sep_conv`` order). Returns [N,H,W,len(pairs)]."""
    n = (pairs[0][0].shape[0] - 1) // 2
    k = 2 * n + 1
    xp = F.pad(img[:, None], (n, n, n, n), mode="replicate")
    ky = torch.stack([p[1] for p in pairs]).view(-1, 1, k, 1)
    kx = torch.stack([p[0] for p in pairs]).view(-1, 1, 1, k)
    y = F.conv2d(xp.expand(-1, len(pairs), -1, -1), ky, groups=len(pairs))
    return F.conv2d(y, kx, groups=len(pairs)).permute(0, 2, 3, 1)


def poly_expansion(img: torch.Tensor, n: int, sigma: float):
    """Per-pixel quadratic coefficients of [N,H,W]: (b [N,H,W,2] = (fx, fy),
    A [N,H,W,2,2] symmetric)."""
    g, xg, xxg, Ginv = _poly_exp_setup(n, sigma, img.device)
    # moments m00, m10 (x), m01 (y), m20, m02, m11
    v = _sep_conv(img, [(g, g), (xg, g), (g, xg), (xxg, g), (g, xxg), (xg, xg)])
    c = v @ Ginv.T  # [c1, c2 (x), c3 (y), c4 (x²), c5 (y²), c6 (xy)]
    b = c[..., 1:3]
    half = c[..., 5] * 0.5
    A = torch.stack([torch.stack([c[..., 3], half], -1),
                     torch.stack([half, c[..., 4]], -1)], dim=-2)
    return b, A


def _box_filter(x: torch.Tensor, k: int) -> torch.Tensor:
    """Normalized k×k box filter with replicate border on [N,H,W,C]."""
    p = k // 2
    c = x.shape[-1]
    xp = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="replicate")
    kern = torch.full((c, 1, k, 1), 1.0 / k, dtype=torch.float32, device=x.device)
    y = F.conv2d(xp, kern, groups=c)
    y = F.conv2d(y, kern.view(c, 1, 1, k), groups=c)
    return y.permute(0, 2, 3, 1)


def _gather_at_flow(field: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """field[n, yi, xi] at the integer-rounded ``p + flow`` (half to even),
    clamped (OpenCV ``updateMatrices``). field: [N,H,W,...], flow: [N,H,W,2]."""
    N, H, W = field.shape[:3]
    gx = torch.arange(W, dtype=torch.float32, device=field.device)[None, None, :]
    gy = torch.arange(H, dtype=torch.float32, device=field.device)[None, :, None]
    xi = torch.round(gx + flow[..., 0]).clamp(0, W - 1).long()
    yi = torch.round(gy + flow[..., 1]).clamp(0, H - 1).long()
    n = torch.arange(N, device=field.device)[:, None, None]
    return field[n, yi, xi]


def _flow_level(b1, A1, b2, A2, flow, winsize: int, iterations: int):
    """Displacement iterations at one pyramid level."""
    for _ in range(iterations):
        b2w = _gather_at_flow(b2, flow)
        A2w = _gather_at_flow(A2, flow)
        A = (A1 + A2w) * 0.5
        a00, a01, a10, a11 = A[..., 0, 0], A[..., 0, 1], A[..., 1, 0], A[..., 1, 1]
        fx, fy = flow[..., 0], flow[..., 1]
        db0 = (a00 * fx + a01 * fy) - 0.5 * (b2w[..., 0] - b1[..., 0])
        db1 = (a10 * fx + a11 * fy) - 0.5 * (b2w[..., 1] - b1[..., 1])
        # normal equations (AᵀA) d = Aᵀ db, aggregated over the window
        stats = torch.stack([a00 * a00 + a10 * a10, a00 * a01 + a10 * a11,
                             a01 * a00 + a11 * a10, a01 * a01 + a11 * a11,
                             a00 * db0 + a10 * db1, a01 * db0 + a11 * db1], dim=-1)
        stats = _box_filter(stats, winsize)
        m00, m01, m10, m11 = stats[..., 0], stats[..., 1], stats[..., 2], stats[..., 3]
        v0, v1 = stats[..., 4], stats[..., 5]
        det = m00 * m11 - m01 * m10
        det = torch.where(det.abs() < 1e-9, torch.full_like(det, 1e-9), det)
        inv00 = m11 / det
        inv01 = -m01 / det
        inv11 = m00 / det
        flow = torch.stack([inv00 * v0 + inv01 * v1, inv01 * v0 + inv11 * v1], dim=-1)
    return flow


def farneback_flow(prev_gray: torch.Tensor, curr_gray: torch.Tensor, *,
                   pyr_scale: float = 0.5, levels: int = 3, winsize: int = 15,
                   iterations: int = 3, poly_n: int = 5,
                   poly_sigma: float = 1.1) -> torch.Tensor:
    """Dense flow prev → curr on grayscale [N,H,W] (or [H,W]) images, any
    scale. Returns [N,H,W,2] (or [H,W,2]) with flow[..., y, x] = (dx, dy),
    OpenCV's convention."""
    squeeze = prev_gray.ndim == 2
    f1 = (prev_gray[None] if squeeze else prev_gray).float()
    f2 = (curr_gray[None] if squeeze else curr_gray).float()
    N, H, W = f1.shape

    level_shapes = []
    for k in range(levels):
        scale = pyr_scale ** k
        lh, lw = int(round(H * scale)), int(round(W * scale))
        if min(lh, lw) < max(poly_n * 2 + 1, winsize):
            break
        level_shapes.append((lh, lw, scale))

    flow = None
    for lh, lw, scale in reversed(level_shapes):
        sigma = (1.0 / scale - 1.0) * 0.5
        if sigma > 0.01:
            i1 = gaussian_blur(f1[..., None], sigma)
            i2 = gaussian_blur(f2[..., None], sigma)
        else:
            i1, i2 = f1[..., None], f2[..., None]
        i1 = resize_bilinear(i1, (lh, lw))[..., 0]
        i2 = resize_bilinear(i2, (lh, lw))[..., 0]
        if flow is None:
            flow = torch.zeros((N, lh, lw, 2), dtype=torch.float32, device=f1.device)
        else:
            flow = resize_bilinear(flow, (lh, lw)) * (1.0 / pyr_scale)
        b1, A1 = poly_expansion(i1, poly_n, poly_sigma)
        b2, A2 = poly_expansion(i2, poly_n, poly_sigma)
        flow = _flow_level(b1, A1, b2, A2, flow, winsize, iterations)

    if flow is None:
        flow = torch.zeros((N, H, W, 2), dtype=torch.float32, device=f1.device)
    elif flow.shape[1:3] != (H, W):
        flow = resize_bilinear(flow, (H, W)) * (H / flow.shape[1])
    return flow[0] if squeeze else flow
