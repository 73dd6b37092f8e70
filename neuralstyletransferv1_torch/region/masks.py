"""Region mask generators (9 patterns) with seeded-RNG parity.

The port's copy of ``neuralstyletransferv1_tpu/region/masks.py``: the
pattern generators in numpy with the same ``random.Random(seed)`` draw
order, call for call, so a given seed yields the same regions. Generation
happens once per (H, W, mode, count, seed, feather); the result is stacked
[R, H, W] f32 and moved to the device.

Feathering: sigma = px/3, ksize = int(6*sigma+1) forced odd (min 3), reflect
padding (``ops/blur.gaussian_blur``).
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

from ..ops.blur import gaussian_blur

AVAILABLE_MODES = [
    "grid",
    "diagonal",
    "voronoi",
    "fractal",
    "radial",
    "waves",
    "spiral",
    "concentric",
    "random",
]


def feather_mask(mask: torch.Tensor, feather_px: int) -> torch.Tensor:
    """Gaussian feather of an HW / HWC / NHWC mask, sigma = px/3."""
    if feather_px <= 0:
        return mask
    sigma = feather_px / 3.0
    ksize = int(6 * sigma + 1)
    if ksize % 2 == 0:
        ksize += 1
    ksize = max(3, ksize)
    return gaussian_blur(mask, sigma, ksize=ksize)


def _coords(H: int, W: int):
    y = np.arange(H, dtype=np.float32)[:, None]
    x = np.arange(W, dtype=np.float32)[None, :]
    return y, x


def grid_masks(H, W, count):
    """2x2/3x3/… grid cells."""
    grid_size = int(math.ceil(math.sqrt(count)))
    cell_h, cell_w = H / grid_size, W / grid_size
    masks = []
    for i in range(count):
        row, col = i // grid_size, i % grid_size
        m = np.zeros((H, W), np.float32)
        y1, y2 = int(row * cell_h), min(int((row + 1) * cell_h), H)
        x1, x2 = int(col * cell_w), min(int((col + 1) * cell_w), W)
        m[y1:y2, x1:x2] = 1.0
        masks.append(m)
    return masks


def diagonal_masks(H, W, count, rng: random.Random):
    """Diagonal stripes, direction randomized."""
    y, x = _coords(H, W)
    if rng.random() > 0.5:
        diagonal = x + y
    else:
        diagonal = (W - 1 - x) + y
    diagonal = diagonal / diagonal.max()
    return [
        ((diagonal >= i / count) & (diagonal < (i + 1) / count)).astype(np.float32)
        for i in range(count)
    ]


def _generate_balanced_points(W, H, count, rng: random.Random, jitter_factor=0.3):
    """Grid-jittered seed points.

    RNG draw order preserved: 2 draws per placed point, then randint for
    overflow, then shuffle.
    """
    aspect = W / H
    cols = max(1, int(math.sqrt(count * aspect) + 0.5))
    rows = max(1, int(math.sqrt(count / aspect) + 0.5))
    while cols * rows < count:
        if cols / rows < aspect:
            cols += 1
        else:
            rows += 1
    cell_w, cell_h = W / cols, H / rows
    points = []
    for row in range(rows):
        for col in range(cols):
            if len(points) >= count:
                break
            cx, cy = (col + 0.5) * cell_w, (row + 0.5) * cell_h
            jx = (rng.random() - 0.5) * cell_w * jitter_factor
            jy = (rng.random() - 0.5) * cell_h * jitter_factor
            points.append((max(0, min(W - 1, cx + jx)), max(0, min(H - 1, cy + jy))))
    while len(points) < count:
        points.append((rng.randint(0, W - 1), rng.randint(0, H - 1)))
    rng.shuffle(points)
    return points[:count]


def voronoi_masks(H, W, count, rng: random.Random, region_weights=None):
    """Balanced-seed (power-weighted) Voronoi cells."""
    points = _generate_balanced_points(W, H, count, rng, jitter_factor=0.3)
    y, x = _coords(H, W)
    dists = []
    if region_weights:
        total = sum(region_weights)
        norm = [w * count / total for w in region_weights]
        for i, (px, py) in enumerate(points):
            d = np.sqrt((x - px) ** 2 + (y - py) ** 2)
            wgt = norm[i] if i < len(norm) else 1.0
            dists.append(d / (math.sqrt(wgt) + 1e-6))
    else:
        for px, py in points:
            dists.append(np.sqrt((x - px) ** 2 + (y - py) ** 2))
    nearest = np.argmin(np.stack(dists, 0), axis=0)
    return [(nearest == i).astype(np.float32) for i in range(count)]


def fractal_quad_masks(H, W, count, rng: random.Random, max_depth=4):
    """Random quad-tree subdivision."""
    regions = []

    def subdivide(y1, y2, x1, x2, depth):
        if len(regions) >= count:
            return
        if depth >= max_depth or (y2 - y1) < 20 or (x2 - x1) < 20:
            regions.append((y1, y2, x1, x2))
            return
        if rng.random() > 0.4 and depth > 0:
            regions.append((y1, y2, x1, x2))
            return
        mid_y = (y1 + y2) // 2 + rng.randint(-10, 10)
        mid_x = (x1 + x2) // 2 + rng.randint(-10, 10)
        mid_y = max(y1 + 10, min(y2 - 10, mid_y))
        mid_x = max(x1 + 10, min(x2 - 10, mid_x))
        quads = [
            (y1, mid_y, x1, mid_x),
            (y1, mid_y, mid_x, x2),
            (mid_y, y2, x1, mid_x),
            (mid_y, y2, mid_x, x2),
        ]
        rng.shuffle(quads)
        for q in quads:
            if len(regions) >= count:
                break
            subdivide(q[0], q[1], q[2], q[3], depth + 1)

    subdivide(0, H, 0, W, 0)
    masks = []
    for y1, y2, x1, x2 in regions[:count]:
        m = np.zeros((H, W), np.float32)
        m[y1:y2, x1:x2] = 1.0
        masks.append(m)
    return masks


def radial_masks(H, W, count, rng: random.Random):
    """Pie wedges about a jittered center."""
    cx = W // 2 + rng.randint(-W // 4, W // 4)
    cy = H // 2 + rng.randint(-H // 4, H // 4)
    rotation = rng.random() * 2 * math.pi
    y, x = _coords(H, W)
    angles = (np.arctan2(y - cy, x - cx) + math.pi + rotation) % (2 * math.pi)
    wedge = 2 * math.pi / count
    return [
        ((angles >= i * wedge) & (angles < (i + 1) * wedge)).astype(np.float32)
        for i in range(count)
    ]


def wave_masks(H, W, count, rng: random.Random):
    """Sinusoidal bands."""
    frequency = rng.uniform(1.5, 4.0)
    amplitude = rng.uniform(0.05, 0.15)
    direction = rng.choice(["horizontal", "vertical", "diagonal"])
    phase = rng.random() * 2 * math.pi
    y, x = _coords(H, W)
    yn, xn = y / H, x / W
    if direction == "horizontal":
        position = yn + np.sin(xn * frequency * 2 * math.pi + phase) * amplitude
    elif direction == "vertical":
        position = xn + np.sin(yn * frequency * 2 * math.pi + phase) * amplitude
    else:
        diagonal = (xn + yn) / 2
        position = diagonal + np.sin(diagonal * frequency * 2 * math.pi + phase) * amplitude
    position = np.broadcast_to(position, (H, W))
    position = (position - position.min()) / (position.max() - position.min() + 1e-6)
    return [
        ((position >= i / count) & (position < (i + 1) / count)).astype(np.float32)
        for i in range(count)
    ]


def spiral_masks(H, W, count, rng: random.Random):
    """Archimedean spiral arms."""
    cx, cy = W // 2, H // 2
    tightness = rng.uniform(2.0, 5.0)
    rotation = rng.random() * 2 * math.pi
    y, x = _coords(H, W)
    r = np.sqrt((x - cx) ** 2 + (y - cy) ** 2)
    theta = np.arctan2(y - cy, x - cx) + math.pi + rotation
    spiral = (theta + r / max(H, W) * tightness * 2 * math.pi) % (2 * math.pi)
    spiral = spiral / (2 * math.pi)
    return [
        ((spiral >= i / count) & (spiral < (i + 1) / count)).astype(np.float32)
        for i in range(count)
    ]


def concentric_masks(H, W, count, rng: random.Random):
    """Concentric rings about a jittered center."""
    cx = W // 2 + rng.randint(-W // 6, W // 6)
    cy = H // 2 + rng.randint(-H // 6, H // 6)
    y, x = _coords(H, W)
    r = np.sqrt((x - cx) ** 2 + (y - cy) ** 2)
    r = r / r.max()
    return [
        ((r >= i / count) & (r < (i + 1) / count)).astype(np.float32) for i in range(count)
    ]


def parse_region_sizes(spec: str | None, num_regions: int):
    """'1,1,1,0.2' / '1|1|1|0.2' → per-region weights."""
    if not spec:
        return None
    spec = spec.replace("|", ",")
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    try:
        weights = [float(p) for p in parts]
    except ValueError:
        return None
    if len(weights) < num_regions:
        return [weights[i % len(weights)] for i in range(num_regions)]
    return weights[:num_regions]


def generate_region_masks(
    H: int,
    W: int,
    mode: str,
    count: int,
    seed: int | None = None,
    feather: int = 20,
    region_sizes: list[float] | None = None,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Stacked [R, H, W] f32 soft masks on ``device``; the RNG seeding and
    the random-mode pick are the JAX package's."""
    rng = random.Random(seed) if seed is not None else random.Random()
    if mode == "random":
        mode = rng.choice([m for m in AVAILABLE_MODES if m != "random"])

    if mode == "voronoi" and region_sizes:
        raw = voronoi_masks(H, W, count, rng, region_sizes)
    else:
        generators = {
            "grid": lambda: grid_masks(H, W, count),
            "diagonal": lambda: diagonal_masks(H, W, count, rng),
            "voronoi": lambda: voronoi_masks(H, W, count, rng),
            "fractal": lambda: fractal_quad_masks(H, W, count, rng),
            "radial": lambda: radial_masks(H, W, count, rng),
            "waves": lambda: wave_masks(H, W, count, rng),
            "spiral": lambda: spiral_masks(H, W, count, rng),
            "concentric": lambda: concentric_masks(H, W, count, rng),
        }
        if mode not in generators:
            raise ValueError(f"Unknown region mode: {mode}. Available: {AVAILABLE_MODES}")
        raw = generators[mode]()

    while len(raw) < count:
        raw.append(raw[-1].copy() if raw else np.ones((H, W), np.float32))
    stacked = torch.from_numpy(np.stack(raw[:count], 0)).to(device)
    if feather > 0:
        stacked = feather_mask(stacked[..., None], feather)[..., 0]
    return stacked
