"""Bilinear flow warps (HWC image, HW2 flow).

``warp_flow`` is cv2.remap's grid-plus-flow warp, INTER_LINEAR,
BORDER_REPLICATE: the exact warp (engine ``--exact_warp``).
``warp_flow_packed_u8`` is the temporal chain's default warp: each channel's
four bilinear corners are quantized to uint8 and packed into one int32, so one
gather fetches all four. Its contract: exact coordinates away from the
right/bottom source edges (coordinates pre-clamp to ``W - 1.001``), corner
rounding to u8 (<= 1/510 per corner on [0,1] inputs).
"""

from __future__ import annotations

import torch


def _grid(h: int, w: int, device):
    gx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    gy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    return gx, gy


def bilinear_sample(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor, *,
                    border: str = "replicate", border_value: float = 0.0) -> torch.Tensor:
    """Sample HWC (or HW) ``img`` at float coords ``map_x``/``map_y`` (any
    shape, e.g. [T, H, W] for a batch of frames of one image). ``border``
    "replicate" clamps the coordinates (cv2.BORDER_REPLICATE: the flow
    warps, the region masks' rotation and organic warp); "constant" gives
    ``border_value`` wherever a coordinate falls outside [0, size - 1]
    (cv2.BORDER_CONSTANT, as the JAX function)."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    x, y = map_x.float(), map_y.float()
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    flat = img.reshape(h * w, c)
    xi, yi = x0.long(), y0.long()

    def gather(yy, xx):
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        return flat[idx.reshape(-1)].reshape(*x.shape, c)

    v00, v01 = gather(yi, xi), gather(yi, xi + 1)
    v10, v11 = gather(yi + 1, xi), gather(yi + 1, xi + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    if border == "constant":
        inside = ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1))[..., None]
        out = torch.where(inside, out, torch.as_tensor(border_value, dtype=out.dtype,
                                                       device=out.device))
    elif border != "replicate":
        raise ValueError(f"border={border!r}: 'replicate' or 'constant'")
    out = out.to(img.dtype)
    return out[..., 0] if squeeze else out


def warp_flow(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp HWC ``img`` by dense flow (H, W, 2), flow[y, x] = (dx, dy):
    samples img at (x + dx, y + dy), replicate border."""
    gx, gy = _grid(flow.shape[0], flow.shape[1], flow.device)
    return bilinear_sample(img, gx + flow[..., 0], gy + flow[..., 1])


def warp_flow_packed_u8(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Replicate-border flow warp of a [0,1] HWC image through one gather of
    u8-quantized, int32-packed bilinear corners."""
    h, w = flow.shape[0], flow.shape[1]
    c = img.shape[-1]
    gx, gy = _grid(h, w, flow.device)
    x = (gx + flow[..., 0]).clamp(0.0, w - 1.001)
    y = (gy + flow[..., 1]).clamp(0.0, h - 1.001)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]

    px = torch.cat([img, torch.cat([img[:, 1:], img[:, -1:]], dim=1)], dim=-1)
    p = torch.cat([px, torch.cat([px[1:], px[-1:]], dim=0)], dim=-1)
    q = torch.round(p.clamp(0.0, 1.0) * 255.0).to(torch.int32)
    # corner 11 lands in the sign byte: 255 << 24 wraps to a negative int32,
    # and the arithmetic >> 24 below sign-extends it, so every unpack masks
    # with 0xFF.
    packed = (q[..., :c] | (q[..., c:2 * c] << 8)
              | (q[..., 2 * c:3 * c] << 16) | (q[..., 3 * c:] << 24))

    idx = (y0.long() * w + x0.long()).reshape(-1)
    g = packed.reshape(h * w, c)[idx].reshape(h, w, c)
    s = 1.0 / 255.0
    v00 = (g & 0xFF).float() * s
    v01 = ((g >> 8) & 0xFF).float() * s
    v10 = ((g >> 16) & 0xFF).float() * s
    v11 = ((g >> 24) & 0xFF).float() * s
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return (top * (1 - fy) + bot * fy).to(img.dtype)
