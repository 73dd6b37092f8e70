"""Colour-space ops (NHWC / HWC, channels last).

``rgb_to_lab_u8`` / ``lab_u8_to_rgb`` reproduce PIL's uint8 "LAB" mode, the
convention of the temporal lightness/chroma EMA: sRGB → XYZ with D50
adaptation, L* scaled to 0..255, a*/b* stored as *wrapped* signed bytes
(a = -79 → byte 177). ``rgb_to_gray`` is BT.601 luma (cv2 RGB2GRAY), the
optical-flow input.

torch has no ``cbrt``: the cube root is ``pow(1/3)`` on the positive branch.
``torch.round`` rounds half to even, like ``jnp.round``.
"""

from __future__ import annotations

import torch

# sRGB -> XYZ, D50-adapted (ICC PCS / Bradford), as used by Pillow's LAB mode.
_RGB2XYZ_D50 = (
    (0.4360747, 0.3850649, 0.1430804),
    (0.2225045, 0.7168786, 0.0606169),
    (0.0139322, 0.0971045, 0.7141733),
)
_XYZ2RGB_D50 = (
    (3.1338561, -1.6168667, -0.4906146),
    (-0.9787684, 1.9161415, 0.0334540),
    (0.0719453, -0.2289914, 1.4052427),
)
_WHITE_D50 = (0.9642, 1.0, 0.8249)
_EPS = (6.0 / 29.0) ** 3
_KAPPA_INV = 1.0 / (3.0 * (6.0 / 29.0) ** 2)


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """BT.601 luma from RGB (any scale); returns (…, H, W)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = c.clamp(0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


def _f(t: torch.Tensor) -> torch.Tensor:
    cbrt = t.clamp_min(_EPS).pow(1.0 / 3.0)
    return torch.where(t > _EPS, cbrt, t * _KAPPA_INV + 4.0 / 29.0)


def _f_inv(ft: torch.Tensor) -> torch.Tensor:
    return torch.where(ft > 6.0 / 29.0, ft ** 3, (ft - 4.0 / 29.0) / _KAPPA_INV)


def rgb_to_lab_u8(rgb01: torch.Tensor) -> torch.Tensor:
    """RGB in [0,1] (…, 3) → float LAB planes in PIL's byte scaling: L in
    0..255, a/b as wrapped signed bytes in 0..255 (not rounded for L)."""
    lin = _srgb_to_linear(rgb01.float())
    xyz = lin @ _const(_RGB2XYZ_D50, lin).T
    fxyz = _f(xyz / _const(_WHITE_D50, lin))
    fx, fy, fz = fxyz[..., 0], fxyz[..., 1], fxyz[..., 2]
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    a_u8 = torch.remainder(torch.round(a), 256.0)
    b_u8 = torch.remainder(torch.round(b), 256.0)
    return torch.stack([L * (255.0 / 100.0), a_u8, b_u8], dim=-1)


def lab_u8_to_rgb(lab_u8: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rgb_to_lab_u8`; returns RGB float in [0,1]."""
    lab = lab_u8.float()
    L = lab[..., 0] * (100.0 / 255.0)
    # byte >= 128 encodes a negative value
    a = torch.remainder(lab[..., 1] + 128.0, 256.0) - 128.0
    b = torch.remainder(lab[..., 2] + 128.0, 256.0) - 128.0
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    xyz = torch.stack([_f_inv(fx), _f_inv(fy), _f_inv(fz)], dim=-1) * _const(_WHITE_D50, lab)
    lin = xyz @ _const(_XYZ2RGB_D50, lab).T
    return _linear_to_srgb(lin).clamp(0.0, 1.0)
