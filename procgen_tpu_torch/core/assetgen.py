"""The per-reset painted background of ``use_generated_assets``.

The counterpart of ``procgen_tpu.render.assetgen`` (its job 2): at every
reset AssetGen::generate_resource(img, 1, 50, true) (assetgen.cpp:104-132,
basic-abstract-game.cpp:776-782) paints a square canvas from the env's
level ``rand_gen``, so the words it draws must be drawn here exactly.
``consume_background_draws`` materialises the next ``N_MAX`` words of
every env's stream (``rng.draw_block``), paints each env's ``CAN x CAN``
canvas from them and advances each stream by the words that env used.

The painter has two versions with one function:

* ``generate_background_reference``, the plain batched torch version: the
  walk of the JAX package's ``generate_background`` with the masked
  cursor, in f32 as it computes (``_roll``, ``_rand_color``,
  ``_choose_sub_rect``, ``_paint_shape``, ``_paint_rect_inner``), which
  records every paint in order (a rect fill, an ellipse with its 1-px
  pen, or the 200/255 alpha fill that closes a resource), then each env's
  paints applied in order to its canvas, each inside its bounding box.  A
  loop iteration masked off in every env of the batch is skipped (one
  host read a blotch): a masked iteration draws and paints nothing.  CPU
  tensors take it.
* ``generate_background``, the CUDA kernel ``csrc/assetgen_bg.cu``; CUDA
  tensors take it, and it raises when it cannot run.

Exactness: the painter works in f32 as XLA computes the JAX version on the
CPU without fused multiply-adds; ``alpha * color + (1 - alpha) * canvas``
uses f32(200/255) and f32(1 - 200/255), both rounded from the double; the
canvas rounds half to even, clips to [0, 255] and becomes uint8.

Draw-count bound (exact worst case, as in the JAX package):
  paint_shape             <= 10 + 2*6                = 22
  inner rect resource     <= 13 + 19*(4 + 22)        = 507
  outer rect resource     <= 13 + 99*(4 + 1 + 507)   = 50701
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import rng

f32 = torch.float32
i32 = torch.int32
u8 = torch.uint8

CAN = 128  # canvas resolution (the reference paints 500x500, cpp:62)
REF = 500.0
N_MAX = 50704  # worst-case draws, rounded up a little

SHAPE_MAX_SPLITS = 2  # num_splits = randn(10)^2 / 50 + 1  in {1, 2}
INNER_MAX_BLOTCHES = 19  # randint(10, 20) <= 19
OUTER_MAX_BLOTCHES = 99  # randint(50, 100) <= 99
# paints of one canvas at most: the outer fill, 99 blotches of an inner
# resource (its fill, 19 two-split shapes, its alpha fill), the outer
# alpha fill
MAX_PAINTS = 1 + OUTER_MAX_BLOTCHES * (2 + SHAPE_MAX_SPLITS * INNER_MAX_BLOTCHES) + 1

# paint kinds (csrc/assetgen_bg.cu PAINT_*)
FILL, ELLIPSE, BLEND = 1, 2, 3


def _f(v: float) -> float:
    """``v`` rounded to f32, as a Python float (exact in f32 arithmetic)."""
    return float(np.float32(v))


ALPHA = _f(200.0 / 255.0)
ONE_MINUS_ALPHA = _f(1.0 - 200.0 / 255.0)
EPS = _f(1e-4)

# Launches of the CUDA painter since import (or since a caller reset it);
# the wrapper adds one per launch and nothing else touches it.
LAUNCHES = {"assetgen_bg": 0}


def _grid(device) -> torch.Tensor:
    """The canvas pixel centres in the 500-px reference space, f32 [CAN]
    (exact: (i + 0.5) * 3.90625)."""
    return (torch.arange(CAN, dtype=f32, device=device) + 0.5) * (REF / CAN)


# ---------------------------------------------------------------------------
# the walk: the JAX package's masked cursor, batched over the envs
# ---------------------------------------------------------------------------


class _Walk:
    """Every env's cursor into its words (``vals`` int64 [N, N_MAX]) and
    the paints recorded so far, one entry a paint site of the walk: (mask,
    kind, rect, color, pen), each [N] or [N, 3]."""

    def __init__(self, vals: torch.Tensor):
        self.vals = vals
        n = vals.shape[0]
        self.dev = vals.device
        self.c = torch.zeros((n,), dtype=i32, device=self.dev)
        self.paints = []

    def words(self, k: int) -> torch.Tensor:
        """The next ``k`` words of every env, [N, k], not consumed."""
        idx = self.c.long()[:, None] + torch.arange(k, device=self.dev)
        return self.vals.gather(1, idx.clamp_max(self.vals.shape[1] - 1))

    def take(self, k, do) -> None:
        """Consume ``k`` words where ``do``."""
        self.c = self.c + torch.as_tensor(k, device=self.dev).to(i32) * do.to(i32)

    def paint(self, do, kind, rect, color, pen=None) -> None:
        if pen is None:
            pen = color
        kind = torch.as_tensor(kind, device=self.dev).to(i32).expand(do.shape)
        self.paints.append((do, kind, torch.stack(rect, dim=-1), color, pen))


def _r01(w):
    return rng._rand01_from(w)


def _roll(wk: _Walk, do):
    """ColorGen::roll (assetgen.cpp:10-20): 7 draws, the last (p_rect)
    unused.  Returns (lens, starts), each f32 [N, 3]."""
    v = _r01(wk.words(7))
    lens = v[:, 0:3]
    starts = v[:, 3:6] * (1 - lens)
    wk.take(7, do)
    return lens, starts


def _color_of(v, cgen):
    """ColorGen::rand_color (cpp:22-28) of three rand01 values [N, 3]."""
    lens, starts = cgen
    return torch.floor(255.0 * (v * lens + starts))


def _rand_color(wk: _Walk, cgen, do):
    v = _r01(wk.words(3))
    wk.take(3, do)
    return _color_of(v, cgen)


def _choose_sub_rect(wk: _Walk, rect, min_dim, max_dim, do):
    """cpp:35-51 (w/h truncated to int): 4 draws."""
    x, y, w, h = rect
    wi = torch.trunc(w)
    hi = torch.trunc(h)
    smaller = torch.where(wi > hi, hi, wi)
    del_dim = max_dim - min_dim
    v = _r01(wk.words(4))
    wk.take(4, do)
    rdx = (v[:, 0] * del_dim + min_dim) * smaller
    rdy = (v[:, 1] * del_dim + min_dim) * smaller
    rx_off = v[:, 2] * (wi - rdx)
    ry_off = v[:, 3] * (hi - rdy)
    return (rx_off + x, ry_off + y, rdx, rdy)


def _paint_shape(wk: _Walk, rect, cgen, do):
    """cpp:76-102: 10 draws, and 6 more a split where the colors are drawn
    anew; one rect fill or ellipse a split."""
    w = wk.words(10 + 6 * SHAPE_MAX_SPLITS)
    k = rng._randn_from(w[:, 0], 10)
    num_splits = torch.div(k * k, 50, rounding_mode="floor") + 1
    v = _r01(w[:, 1:])
    horiz, use_rect, regen = v[:, 0] > 0.5, v[:, 1] > 0.5, v[:, 2] > 0.5
    c1 = _color_of(v[:, 3:6], cgen)
    c2 = _color_of(v[:, 6:9], cgen)
    wk.take(10, do)

    x, y, ww, hh = rect
    nsf = num_splits.to(f32)
    dw = ww / nsf
    dh = hh / nsf
    for i in range(SHAPE_MAX_SPLITS):
        active = do & (i < num_splits)
        draw_colors = active & regen
        # the colors of split i lie after those of the splits before it
        # (a split draws only where every split before it drew)
        o = 9 + 6 * i
        c1 = torch.where(draw_colors[:, None], _color_of(v[:, o:o + 3], cgen), c1)
        c2 = torch.where(draw_colors[:, None], _color_of(v[:, o + 3:o + 6], cgen), c2)
        wk.take(6, draw_colors)
        # x + 0 * dw is x: the canvas coordinates are never -0
        sub = (
            torch.where(horiz, x + dw, x) if i else x,
            torch.where(horiz, y, y + dh) if i else y,
            torch.where(horiz, dw, ww),
            torch.where(horiz, hh, dh),
        )
        wk.paint(active, torch.where(use_rect, FILL, ELLIPSE), sub, c1, c2)


def _resource_head(wk: _Walk, rect, do, lo: int, hi: int):
    """The start of paint_rect_resource (cpp:104-118): the color
    generator, the background fill, the scale, the blotch count (randint(lo,
    hi)) and p_recurse's word: 13 draws.  Returns (cgen, bg, min_dim,
    max_dim, num_blotches, p_recurse)."""
    cgen = _roll(wk, do)
    bg = _rand_color(wk, cgen, do)
    wk.paint(do, FILL, rect, bg)
    w = wk.words(3)
    wk.take(3, do)
    scale = _f(0.3) + _f(0.7) * _r01(w[:, 0])
    nb = rng._randint_from(w[:, 1], lo, hi)
    p_recurse = _r01(w[:, 2]) * _f(0.75)
    return cgen, bg, _f(0.05) * scale, _f(0.5) * scale, nb, p_recurse


def _paint_rect_inner(wk: _Walk, rect, do):
    """cpp:104-132 with num_recurse=0, blotch_scale=10: the recursion
    check short-circuits before its rand01."""
    cgen, bg, min_dim, max_dim, nb, _ = _resource_head(wk, rect, do, 10, 20)
    n_iter = int(torch.where(do, nb, 0).max())  # host read: the longest loop
    for j in range(n_iter):
        active = do & (j < nb)
        sub = _choose_sub_rect(wk, rect, min_dim, max_dim, active)
        _paint_shape(wk, sub, cgen, active)
    wk.paint(do, BLEND, rect, bg)


def _walk(vals: torch.Tensor) -> _Walk:
    """generate_background's walk (cpp:184-195 + 104-132) with every paint
    recorded."""
    wk = _Walk(vals)
    n = vals.shape[0]
    zero = torch.zeros((n,), dtype=f32, device=wk.dev)
    rect = (zero, zero, zero + REF, zero + REF)
    do = torch.ones((n,), dtype=torch.bool, device=wk.dev)
    cgen, bg, min_dim, max_dim, nb, p_recurse = _resource_head(wk, rect, do, 50, 100)
    for j in range(int(nb.max()) if n else 0):
        active = j < nb
        sub = _choose_sub_rect(wk, rect, min_dim, max_dim, active)
        rv = _r01(wk.words(1)[:, 0])  # num_recurse > 0: always drawn
        wk.take(1, active)
        recurse = active & (rv < p_recurse)
        shape = active & ~recurse
        # an env takes one branch: the two draw from the same cursor
        c0 = wk.c
        if bool(recurse.any()):
            _paint_rect_inner(wk, sub, recurse)
        c_r, wk.c = wk.c, c0
        _paint_shape(wk, sub, cgen, shape)
        wk.c = torch.where(recurse, c_r, wk.c)
    wk.paint(do, BLEND, rect, bg)
    return wk


# ---------------------------------------------------------------------------
# the paint: each env's paints in order, each inside its bounding box
# ---------------------------------------------------------------------------


def _span(mask: torch.Tensor):
    """(first, last + 1) of the true entries of each row of a bool
    [P, CAN] mask (0, 0 where none is), as numpy."""
    m = mask.cpu().numpy()
    anyv = m.any(axis=1)
    first = np.where(anyv, m.argmax(axis=1), 0)
    last = np.where(anyv, CAN - m[:, ::-1].argmax(axis=1), 0)
    return first, last


def _sq(t):
    return t * t  # x ** 2 is x * x under XLA


def _paint_env(canvas, kind, rect, color, pen):
    """Apply one env's paints (kind int32 [P], rect f32 [P, 4], color and
    pen f32 [P, 3]) in order to its f32 [CAN, CAN, 3] canvas.  A rect fill
    covers the pixel centres in [x, x + w) x [y, y + h); an ellipse of
    semi-axes a = max(w / 2, 1e-4) and b = max(h / 2, 1e-4) paints the
    inside of its 1-px pen (the ellipse of a - 1 and b - 1) with the
    brush and the rest of it with the pen; a blend mixes the rect with
    f32(200/255) of its color."""
    g = _grid(canvas.device)[None, :]  # [1, CAN]
    x, y, w, h = (rect[:, k:k + 1] for k in range(4))
    # rect fills and blends: rows and columns inside
    rows_in = (g >= y) & (g < y + h)
    cols_in = (g >= x) & (g < x + w)
    # ellipses (the JAX package's _draw_ellipse), per axis
    a = torch.clamp_min(w * 0.5, EPS)
    b = torch.clamp_min(h * 0.5, EPS)
    cx = x + w * 0.5
    cy = y + h * 0.5
    ai = torch.clamp_min(a - 1.0, 0.0)
    bi = torch.clamp_min(b - 1.0, 0.0)
    dy2, dx2 = _sq((g - cy) / b), _sq((g - cx) / a)
    dy2i = _sq((g - cy) / torch.clamp_min(bi, EPS))
    dx2i = _sq((g - cx) / torch.clamp_min(ai, EPS))
    has_inner = ((ai > 0) & (bi > 0))[:, 0].cpu().numpy()
    ell = (kind == ELLIPSE)[:, None]
    # a pixel inside an ellipse has dy2 <= 1 and dx2 <= 1 (d2 >= either)
    r0, r1 = _span(torch.where(ell, dy2 <= 1.0, rows_in))
    c0, c1 = _span(torch.where(ell, dx2 <= 1.0, cols_in))
    kinds = kind.cpu().numpy()
    for p in range(kind.shape[0]):
        if r0[p] >= r1[p] or c0[p] >= c1[p]:
            continue
        rs, cs = slice(r0[p], r1[p]), slice(c0[p], c1[p])
        region = canvas[rs, cs]
        if kinds[p] == ELLIPSE:
            inside = (dy2[p, rs, None] + dx2[p, None, cs]) <= 1.0
            if has_inner[p]:
                inner = (dy2i[p, rs, None] + dx2i[p, None, cs]) <= 1.0
            else:
                inner = torch.zeros_like(inside)
            region = torch.where((inside & ~inner)[..., None], pen[p], region)
            region = torch.where((inside & inner)[..., None], color[p], region)
        else:
            m = (rows_in[p, rs, None] & cols_in[p, None, cs])[..., None]
            if kinds[p] == FILL:
                region = torch.where(m, color[p], region)
            else:
                src = color[p] * ALPHA + region * ONE_MINUS_ALPHA
                region = torch.where(m, src, region)
        canvas[rs, cs] = region
    return canvas


def _paints(vals: torch.Tensor):
    """The walk's paints of every env, in order: (kind int32 [N, P], rect
    f32 [N, P, 4], color f32 [N, P, 3], pen f32 [N, P, 3], count int32
    [N]); kind 0 past an env's count.  Also the words used, int32 [N]."""
    wk = _walk(vals)
    n = vals.shape[0]
    mask = torch.stack([p[0] for p in wk.paints], dim=1)  # [N, S]
    fields = [torch.stack([p[k] for p in wk.paints], dim=1) for k in range(1, 5)]
    count = mask.sum(dim=1).to(i32)
    P = int(count.max()) if n else 0
    # each env's paint sites that painted, in order, packed to the front
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)[:, :P]
    keep = torch.arange(P, device=vals.device)[None, :] < count[:, None]
    kind = torch.where(keep, fields[0].gather(1, order), 0).to(i32)
    rest = [f.gather(1, order[..., None].expand(-1, -1, f.shape[2])) for f in fields[1:]]
    return (kind, *rest, count), wk.c


def generate_background_reference(vals: torch.Tensor):
    """AssetGen::generate_resource(img, 1, 50, true) over a 500x500 rect
    for every env, from its words ``vals`` (int64 [N, N_MAX], uint32
    values): (canvas uint8 [N, CAN, CAN, 3], words used int32 [N]).  The
    plain torch version of ``csrc/assetgen_bg.cu``."""
    (kind, rect, color, pen, count), used = _paints(vals)
    n = vals.shape[0]
    canvas = torch.zeros((n, CAN, CAN, 3), dtype=f32, device=vals.device)
    for e in range(n):
        k = int(count[e])
        _paint_env(canvas[e], kind[e, :k], rect[e, :k], color[e, :k], pen[e, :k])
    out = torch.clamp(torch.round(canvas), 0, 255).to(u8)
    return out, used


def longest_path_words(seed: int = 0) -> np.ndarray:
    """Made-up words (int64 [N_MAX], uint32 values, from ``seed``) that
    take the painter's longest path: 99 outer blotches, each recursing
    into an inner resource of 19 blotches, each of those a shape of two
    splits that draw their colors anew, 50,701 words in all.  The words of
    the other draws are random; the kernel check feeds them to the kernel
    and its plain version."""
    rs = np.random.RandomState(seed)
    out = []

    def anyw(k=1):
        out.extend(rs.randint(0, 2**32, k, dtype=np.int64).tolist())

    def mod(m, r):  # a word w with w % m == r
        out.append(int(rs.randint(0, 2**32 // m, dtype=np.int64)) * m + r)

    def shape():
        mod(10, 9)  # k = 9: two splits
        anyw(2)  # horizontal, rect or ellipse
        out.append(int(rs.randint(2**31 + 256, 2**32, dtype=np.int64)))  # regen
        anyw(6 + 2 * 6)  # the colors, then each split's new colors

    def head(m, r):  # roll, bg color, scale, blotch count, p_recurse
        anyw(7 + 3 + 1)
        mod(m, r)
        out.append(int(rs.randint(2**32 - 2**20, 2**32, dtype=np.int64)))  # ~0.75

    head(50, 49)  # 99 blotches
    for _ in range(OUTER_MAX_BLOTCHES):
        anyw(4)  # the sub rect
        out.append(int(rs.randint(0, 2**20, dtype=np.int64)))  # recurse
        head(10, 9)  # 19 blotches
        for _ in range(INNER_MAX_BLOTCHES):
            anyw(4)
            shape()
    used = len(out)
    anyw(N_MAX - used)
    return np.asarray(out, np.int64)


# ---------------------------------------------------------------------------
# the CUDA painter
# ---------------------------------------------------------------------------

# envs a launch pair walks and paints at once: the paint lists of a chunk
# (MAX_PAINTS x 24 bytes an env) take 97 MB
CHUNK = 1024
PAINT_BYTES = 24


def generate_background(vals: torch.Tensor):
    """Launch ``csrc/assetgen_bg.cu`` on a CUDA ``vals`` (same contract as
    ``generate_background_reference``); raises on anything it does not
    take or a failed launch."""
    from .. import kernels

    if vals.dim() != 2 or vals.shape[1] != N_MAX or vals.dtype != torch.int64:
        raise ValueError(f"assetgen_bg: vals must be int64 (N, {N_MAX}), got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    if vals.device.type != "cuda":
        raise ValueError("assetgen_bg takes CUDA tensors")
    if not vals.is_contiguous():
        raise ValueError("assetgen_bg: vals must be contiguous")
    n = vals.shape[0]
    dev = vals.device
    canvas = torch.empty((n, CAN, CAN, 3), dtype=u8, device=dev)
    used = torch.empty((n,), dtype=i32, device=dev)
    if n == 0:
        return canvas, used
    chunk = min(n, CHUNK)
    paints = torch.empty((chunk, MAX_PAINTS * PAINT_BYTES), dtype=u8, device=dev)
    counts = torch.empty((chunk,), dtype=i32, device=dev)
    err = kernels.load().assetgen_bg(
        vals.data_ptr(), canvas.data_ptr(), used.data_ptr(), paints.data_ptr(),
        counts.data_ptr(), n, N_MAX, chunk, MAX_PAINTS,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"assetgen_bg launch failed: cudaError {err}")
    LAUNCHES["assetgen_bg"] += 1
    return canvas, used


def consume_background_draws(game, s):
    """Game reset's procedural background (basic-abstract-game.cpp:776-782):
    the words of every env's painter drawn from its ``rand_gen`` and its
    painted canvas in ``bg_canvas``; the kernel for CUDA states, the plain
    version for CPU states."""
    vals, ctx = rng.draw_block(s.rand_gen, N_MAX)
    if vals.is_cuda:
        canvas, used = generate_background(vals.contiguous())
    else:
        canvas, used = generate_background_reference(vals)
    return s.replace(rand_gen=rng.advance_block(s.rand_gen, ctx, used),
                     bg_canvas=canvas)
