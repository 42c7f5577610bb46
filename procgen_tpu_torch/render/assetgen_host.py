"""Host-side procedural sprite generation for ``use_generated_assets``.

A numpy copy of ``procgen_tpu.render.assetgen_host`` on the port's own
``utils/host_mt.py``, so both packages bake byte-equal generated atlases
(tests/test_torch_assetgen.py).  Reproduces AssetGen (assetgen.cpp:1-195)
with NumPy rasterization.  Sprite generation runs on its own RandGen
stream seeded ``fixed_asset_seed + type`` (basic-abstract-game.cpp:101-110),
so it never touches the per-env level stream and can run once on host at
atlas-bake time.

The *draw sequence* is replicated exactly (one u32 per rand01/randn/randint,
randgen.cpp:6-31); the rasterization approximates QPainter's non-antialiased
fill rules (pixel centers inside the float rect / ellipse).
"""

from __future__ import annotations

import numpy as np

from ..utils.host_mt import HostMT19937


class HostRandGen:
    """RandGen draw formulas (randgen.cpp:6-31) over the host mt19937."""

    def __init__(self, seed: int):
        self._mt = HostMT19937(seed & 0xFFFFFFFF)

    def randint(self, low: int, high: int) -> int:
        return low + self._mt.next_u32() % ((high - low) & 0xFFFFFFFF)

    def randn(self, high: int) -> int:
        return self._mt.next_u32() % high

    def rand01(self) -> float:
        # double divide then float cast, bit-equal to the C++ (randgen.cpp:19-23)
        return np.float32(np.float64(self._mt.next_u32()) / 4294967296.0)

    def randbool(self) -> bool:
        return self.rand01() > 0.5


class _ColorGen:
    """assetgen.cpp:3-29."""

    def __init__(self, rg: HostRandGen):
        self.rg = rg
        self.rgb_len = [rg.rand01() for _ in range(3)]
        self.rgb_start = [rg.rand01() * (1 - self.rgb_len[i]) for i in range(3)]
        self.p_rect = rg.rand01()

    def rand_color(self):
        return tuple(
            int(255 * (self.rg.rand01() * self.rgb_len[i] + self.rgb_start[i]))
            for i in range(3)
        )


def _fill_rect(img, rect, color, alpha=255):
    """QPainter::fillRect over pixel centers; rect = (x, y, w, h) floats."""
    h, w = img.shape[:2]
    x, y, rw, rh = rect
    ys = np.arange(h) + 0.5
    xs = np.arange(w) + 0.5
    m = ((ys >= y) & (ys < y + rh))[:, None] & ((xs >= x) & (xs < x + rw))[None, :]
    if alpha >= 255:
        img[m] = (*color, 255)
    else:
        a = alpha / 255.0
        rgb = img[m][:, :3] * (1 - a) + np.asarray(color, np.float64) * a
        out = np.empty((m.sum(), 4), img.dtype)
        out[:, :3] = np.round(rgb)
        out[:, 3] = np.maximum(img[m][:, 3], alpha)
        img[m] = out


def _draw_ellipse(img, rect, brush, pen):
    """drawEllipse with 1px pen outline (assetgen.cpp:94-99)."""
    h, w = img.shape[:2]
    x, y, rw, rh = rect
    cx, cy = x + rw / 2, y + rh / 2
    a, b = max(rw / 2, 1e-6), max(rh / 2, 1e-6)
    ys = (np.arange(h) + 0.5 - cy) / b
    xs = (np.arange(w) + 0.5 - cx) / a
    d2 = ys[:, None] ** 2 + xs[None, :] ** 2
    inside = d2 <= 1.0
    ai, bi = max(a - 1.0, 0.0) / a, max(b - 1.0, 0.0) / b
    ys2 = (np.arange(h) + 0.5 - cy) / max(b * bi, 1e-6)
    xs2 = (np.arange(w) + 0.5 - cx) / max(a * ai, 1e-6)
    inner = (ys2[:, None] ** 2 + xs2[None, :] ** 2) <= 1.0 if ai > 0 and bi > 0 \
        else np.zeros_like(inside)
    img[inside & ~inner] = (*pen, 255)
    img[inner] = (*brush, 255)


def _choose_sub_rect(rg, rect, min_dim, max_dim):
    """assetgen.cpp:35-51 (note the int truncation of w/h)."""
    x, y, w, h = rect
    wi, hi = int(w), int(h)
    smaller = hi if wi > hi else wi
    del_dim = max_dim - min_dim
    rdx = (rg.rand01() * del_dim + min_dim) * smaller
    rdy = (rg.rand01() * del_dim + min_dim) * smaller
    rx_off = rg.rand01() * (wi - rdx)
    ry_off = rg.rand01() * (hi - rdy)
    return (rx_off + x, ry_off + y, rdx, rdy)


def _split_rect(rect, num_splits, is_horizontal):
    x, y, w, h = rect
    dw, dh = w / num_splits, h / num_splits
    if is_horizontal:
        return [(x + i * dw, y, dw, h) for i in range(num_splits)]
    return [(x, y + i * dh, w, dh) for i in range(num_splits)]


def _paint_shape(img, rg, rect, cgen):
    """assetgen.cpp:76-102."""
    k = rg.randn(10)
    num_splits = (k * k) // 50 + 1
    splits = _split_rect(rect, num_splits, rg.randbool())
    use_rect = rg.randbool()
    regen_colors = rg.randbool()
    c1 = cgen.rand_color()
    c2 = cgen.rand_color()
    for r in splits:
        if regen_colors:
            c1 = cgen.rand_color()
            c2 = cgen.rand_color()
        if use_rect:
            _fill_rect(img, r, c1)
        else:
            _draw_ellipse(img, r, c1, c2)


def _paint_rect_resource(img, rg, rect, num_recurse, blotch_scale):
    """assetgen.cpp:104-132."""
    cgen = _ColorGen(rg)
    bgcolor = cgen.rand_color()
    _fill_rect(img, rect, bgcolor)
    scale = 0.3 + 0.7 * rg.rand01()
    max_rand_dim = 0.5 * scale
    min_rand_dim = 0.05 * scale
    num_blotches = rg.randint(blotch_scale, 2 * blotch_scale)
    p_recurse = rg.rand01() * 0.75
    for _ in range(num_blotches):
        dst = _choose_sub_rect(rg, rect, min_rand_dim, max_rand_dim)
        # C++ && short-circuits: the rand01 is only drawn when num_recurse > 0
        if num_recurse > 0 and rg.rand01() < p_recurse:
            _paint_rect_resource(img, rg, dst, num_recurse - 1, 10)
        else:
            _paint_shape(img, rg, dst, cgen)
    _fill_rect(img, rect, bgcolor, alpha=200)


def _create_bar(rg, rect, is_horizontal):
    """assetgen.cpp:134-150 (note: the C++ uses rect.height() for the
    horizontal x-offset — reproduced as-is)."""
    _, _, w, h = rect
    k1 = 0.45 + rg.rand01() * 0.4
    k2 = 0.45 + rg.rand01() * 0.4
    bw = w * k1 * k1
    bh = h * k2 * k2
    pct = rg.rand01()
    if not is_horizontal:
        return (0.0, (h - bh) * pct, w, bh)
    return ((h - bw) * pct, 0.0, bw, h)


def _paint_shape_resource(img, rg, rect):
    """assetgen.cpp:152-182 (non-block sprites on a transparent canvas)."""
    cgen = _ColorGen(rg)
    horizontal_first = rg.randbool()
    nbar1 = rg.randn(3) // 2 + 1
    nbar2 = rg.randn(3) // 2 + 1
    img[:] = 0  # CompositionMode_Source transparent clear
    for _ in range(nbar1):
        _paint_shape(img, rg, _create_bar(rg, rect, horizontal_first), cgen)
    for _ in range(nbar2):
        _paint_shape(img, rg, _create_bar(rg, rect, not horizontal_first), cgen)
    for _ in range(rg.randint(1, 5)):
        _paint_shape(img, rg, _choose_sub_rect(rg, rect, 0.1, 0.6), cgen)


def bake_generated_asset(fixed_asset_seed: int, type_: int,
                         is_rect: bool) -> np.ndarray:
    """64x64 RGBA sprite for a type under use_generated_assets
    (basic-abstract-game.cpp:101-110: seed = fixed_asset_seed + type,
    generate_resource(img, 0, 5, use_block_asset(type)))."""
    rg = HostRandGen(fixed_asset_seed + type_)
    img = np.zeros((64, 64, 4), np.uint8)
    rect = (0.0, 0.0, 64.0, 64.0)
    if is_rect:
        _paint_rect_resource(img, rg, rect, 0, 5)
    else:
        _paint_shape_resource(img, rg, rect)
    return img
