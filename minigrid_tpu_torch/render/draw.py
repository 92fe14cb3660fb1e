"""Vectorized geometric rasterization primitives (host-side, NumPy;
a copy of `minigrid_tpu/render/draw.py`).

Equivalent in behavior to the reference's predicate rasterizer
(gym_minigrid/rendering.py:~5-125: `fill_coords`, `point_in_*`,
`rotate_fn`, `downsample`, `highlight_img`) but vectorized: predicates
evaluate over the whole normalized coordinate lattice at once instead of a
per-pixel Python loop. Used only to precompute the constant tile atlas —
never on the device hot path.
"""

from __future__ import annotations

import numpy as np


def coord_lattice(size: int):
    """(size, size) arrays of normalized (x, y) pixel-center coordinates."""
    ys, xs = np.mgrid[0:size, 0:size]
    return (xs + 0.5) / size, (ys + 0.5) / size


def fill_coords(img: np.ndarray, mask_fn, color) -> np.ndarray:
    """Fill pixels whose normalized center satisfies `mask_fn(x, y)`."""
    x, y = coord_lattice(img.shape[0])
    img[mask_fn(x, y)] = np.asarray(color, dtype=np.uint8)
    return img


def point_in_rect(xmin, xmax, ymin, ymax):
    return lambda x, y: (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)


def point_in_circle(cx, cy, r):
    return lambda x, y: (x - cx) ** 2 + (y - cy) ** 2 <= r * r


def point_in_line(x0, y0, x1, y1, r):
    """Distance-to-segment ≤ r."""

    def fn(x, y):
        dx, dy = x1 - x0, y1 - y0
        denom = dx * dx + dy * dy
        t = np.clip(((x - x0) * dx + (y - y0) * dy) / denom, 0.0, 1.0)
        px, py = x0 + t * dx, y0 + t * dy
        return (x - px) ** 2 + (y - py) ** 2 <= r * r

    return fn


def point_in_triangle(a, b, c):
    """Barycentric-coordinate containment."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)

    def fn(x, y):
        v0 = c - a
        v1 = b - a
        v2x, v2y = x - a[0], y - a[1]
        dot00 = v0 @ v0
        dot01 = v0 @ v1
        dot11 = v1 @ v1
        dot02 = v0[0] * v2x + v0[1] * v2y
        dot12 = v1[0] * v2x + v1[1] * v2y
        inv = 1.0 / (dot00 * dot11 - dot01 * dot01)
        u = (dot11 * dot02 - dot01 * dot12) * inv
        v = (dot00 * dot12 - dot01 * dot02) * inv
        return (u >= 0) & (v >= 0) & (u + v < 1)

    return fn


def rotate_fn(fin, cx, cy, theta):
    """Rotate a predicate's coordinate frame by `theta` about (cx, cy)."""

    def fout(x, y):
        x = x - cx
        y = y - cy
        x2 = cx + x * np.cos(-theta) - y * np.sin(-theta)
        y2 = cy + y * np.cos(-theta) + x * np.sin(-theta)
        return fin(x2, y2)

    return fout


def downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Box-mean downsampling."""
    h, w, c = img.shape
    out = img.reshape(h // factor, factor, w // factor, factor, c)
    return out.mean(axis=(1, 3)).astype(np.uint8)


def highlight_img(img: np.ndarray, color=(255, 255, 255), alpha=0.30) -> np.ndarray:
    """Alpha-blend a highlight color over the image."""
    blend = img.astype(np.float64) * (1 - alpha) + np.asarray(color) * alpha
    img[:] = np.clip(blend, 0, 255).astype(np.uint8)
    return img
