"""Observation renderer in eager torch, batch-first.

The counterpart of ``procgen_tpu.render.renderer``: the QPainter pipeline
(basic-abstract-game.cpp:828-1021) as a per-pixel compositor in the
reference's paint order — background, z=-1 sprites, grid tiles, colored
cells, z=0 and z=1 sprites.  The JAX package samples with one-hot
matmuls; every such pick selects one exact u8 texel, so a gather gives the
same values here.  Every bf16 round trip and every half-to-even round of
the JAX renderer is kept.

This is the path of the per-level static prefix (``prefix_only``), which
the JAX package also computes outside its Pallas kernel, the plain oracle
of the per-step suffix (``base``), and, with neither, the plain oracle of
the whole frame of a game that is not static (miner, coinrun, fruitbot,
starpilot, ...).  Under ``use_monochrome_assets`` it follows the XLA
renderer's coloured rectangles (``_paint_pool``) and coloured cells.
"""

from __future__ import annotations

import torch

from ..core.constants import INVALID_OBJ, SPACE

f32 = torch.float32
i32 = torch.int32
bf16 = torch.bfloat16
u8 = torch.uint8


def fdiv(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` for a float constant ``b``, IEEE-rounded on every device.

    A CUDA tensor divided by a Python scalar is computed as a multiply by
    its reciprocal, which is not the quotient for non-powers of two; a
    tensor divisor keeps the true division."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def rdiv(a: float, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` for a float constant ``a`` (``a / tensor`` is
    ``reciprocal(b) * a`` in torch)."""
    return torch.full_like(b, a) / b


def center(game, s):
    """(cx, cy, vis) per env ([N] f32): the agent-centred camera of
    ``game.camera`` under ``center_agent``, else the whole world."""
    if game.center_agent:
        return game.camera(s)
    w = s.main_width.to(f32)
    h = s.main_height.to(f32)
    vis = torch.maximum(torch.maximum(w, h), torch.full_like(w, game.min_visibility))
    return w * 0.5, h * 0.5, vis


def camera(game, s, res: int):
    """(unit, vis, x_off, y_off) per env ([N] f32): prepare_for_drawing
    (cpp:828-847)."""
    cx, cy, vis = center(game, s)
    unit = rdiv(float(res), vis)
    x_off = unit * (cx - vis / 2)
    y_off = unit * (cy - vis / 2)
    return unit, vis, x_off, y_off


def render_obs(game, s, res: int = 64, base=None, prefix_only=False):
    """Render a batch of env states to uint8 ``[N, res, res, 3]``.

    ``base``: a precomputed static-prefix frame batch (uint8
    ``[N, res, res, 3]``) — composite only the dynamic suffix on top.
    ``prefix_only``: render and return just that static prefix.
    """
    from .atlas import get_atlases

    n = s.num
    dev = s.grid.device
    unit, vis, x_off, y_off = camera(game, s, res)
    want_prefix = base is None
    want_suffix = not prefix_only

    sx = (torch.arange(res, dtype=f32, device=dev) + 0.5)[None, :]  # [1, res]
    sy = (torch.arange(res, dtype=f32, device=dev) + 0.5)[None, :]
    wxs = (sx + x_off[:, None]) / unit[:, None]  # [N, res] world x per column
    wys = vis[:, None] - (sy - y_off[:, None]) / unit[:, None]  # per row

    grid_atlas, bg_atlas, ent_atlas = get_atlases(game, res)

    if base is not None:
        obs = base.to(i32)
    else:
        obs = torch.zeros((n, res, res, 3), dtype=i32, device=dev)
        use_bg = game.options.use_backgrounds and bg_atlas is not None
        if game.options.use_backgrounds and game.uses_procgen_background:
            # each env's painted canvas, square like the reference's
            # 500x500 image: aspect 1, cropped or tiled; no game's own
            # background pass (procgen_tpu/render/renderer.py:117-122)
            obs = _paint_background(
                game, s, obs, sx, sy, res, unit, vis, s.bg_canvas,
                torch.arange(n, device=dev), torch.ones((n,), dtype=f32, device=dev),
            )
        elif use_bg and type(game).paint_background is _base_paint_background():
            pix, aspects = bg_atlas.tensors(dev)
            bi = s.background_index.long().clamp(0, pix.shape[0] - 1)
            obs = _paint_background(
                game, s, obs, sx, sy, res, unit, vis, pix, bi, aspects[bi]
            )
        elif use_bg and game.PALLAS_BG == "scroll":
            # the game's own background pass: starpilot's scrolled tiles
            obs = game.paint_background(s, res, sx, sy, bg_atlas)
        elif use_bg:
            raise NotImplementedError("custom backgrounds not ported")

    draw_mask = game.should_draw_entity_mask(s)

    def _wanted(levels):
        return tuple(z for z in levels if (want_prefix if z < 0 else want_suffix))

    ent_z = _wanted(game.ENT_Z_LEVELS)
    dec_z = _wanted(game.DECOR_Z_LEVELS) if game.DECOR_CAP else ()
    mono = ent_atlas is None  # use_monochrome_assets: coloured rectangles
    ents_canv = (
        _sprite_canvases(game, s, s.ents, draw_mask, ent_atlas, res, unit,
                         vis, x_off, y_off, sx, sy, ent_z)
        if ent_z and not mono else None
    )
    decor_canv = (
        _sprite_canvases(game, s, s.decor, None, ent_atlas, res, unit, vis,
                         x_off, y_off, sx, sy, dec_z)
        if dec_z and not mono else None
    )

    def _apply_canvas(obs, canv):
        canv = canv.to(f32)
        a = canv[..., 3:]
        return torch.round(canv[..., :3] + obs.to(f32) * (1 - a)).to(i32)

    def paint_z(obs, zlevel):
        # the entity pool's canvas, then the decor pool's (the JAX
        # package's split-pool paint order, procgen_tpu/core/game.py:118-121)
        if mono:
            if zlevel in ent_z:
                obs = _paint_pool(game, s, obs, s.ents, zlevel, draw_mask, res,
                                  wxs, wys, sx, sy)
            if zlevel in dec_z:
                obs = _paint_pool(game, s, obs, s.decor, zlevel, None, res,
                                  wxs, wys, sx, sy)
            return obs
        if ents_canv is not None and zlevel in ent_z:
            obs = _apply_canvas(obs, ents_canv[ent_z.index(zlevel)])
        if decor_canv is not None and zlevel in dec_z:
            obs = _apply_canvas(obs, decor_canv[dec_z.index(zlevel)])
        return obs

    if want_prefix:
        obs = paint_z(obs, -1)
        # grid pass (cpp:950-964)
        cellx = torch.floor(wxs).to(i32)  # [N, res]
        celly = torch.floor(wys).to(i32)
        wmax, hmax = game.WORLD_DIM_MAX
        raw = _sample_grid(s.grid, celly, cellx, hmax, wmax, INVALID_OBJ)
        inb = (
            ((celly >= 0) & (celly < s.main_height[:, None]))[:, :, None]
            & ((cellx >= 0) & (cellx < s.main_width[:, None]))[:, None, :]
        )
        # the centred camera draws the cells around the agent, out-of-world
        # ones as out_of_bounds_object (cpp:937-948, 180-185)
        oob_val = game.out_of_bounds_object if game.center_agent else INVALID_OBJ
        gtype = torch.where(inb, raw, oob_val)

        u = (wxs - torch.floor(wxs))[:, None, :].expand(n, res, res)
        v = (wys - torch.floor(wys))[:, :, None].expand(n, res, res)

        textured = torch.zeros((n, res, res), dtype=torch.bool, device=dev)
        if grid_atlas is not None:
            obs, textured = _paint_grid_tiles(
                game, s, obs, res, wxs, wys, grid_atlas
            )

        gvalid, r, g_, b = game.grid_cell_colors(s, gtype, u, v)
        gvalid = gvalid & ~textured
        gcol = torch.stack(
            [torch.as_tensor(c, device=dev).to(i32).expand(n, res, res)
             for c in (r, g_, b)], dim=-1,
        )
        obs = torch.where(gvalid[..., None], gcol, obs)

    if prefix_only:
        return obs.to(u8)

    obs = paint_z(obs, 0)
    obs = paint_z(obs, 1)
    obs = post(game, s, obs, res)
    return obs.to(u8)


def post(game, s, obs, res: int):
    """paint_vel_info (cpp:969-978) + the game's HUD overlay, on an int32
    ``[N, res, res, 3]`` frame batch."""
    dev = obs.device
    sx = torch.arange(res, dtype=f32, device=dev) + 0.5
    sy = torch.arange(res, dtype=f32, device=dev) + 0.5
    if game.options.paint_vel_info and game.has_useful_vel_info:
        infodim = res * 0.2
        s1 = to_shade(0.5 * s.ents.vx[:, 0] / s.maxspeed + 0.5)
        s2 = to_shade(0.5 * s.ents.vy[:, 0] / s.max_jump + 0.5)
        in_y = (sy < infodim)[:, None]
        r1 = in_y & (sx < infodim)[None, :]
        r2 = in_y & ((sx >= infodim) & (sx < 2 * infodim))[None, :]
        obs = torch.where(r1[None, :, :, None], s1[:, None, None, None], obs)
        obs = torch.where(r2[None, :, :, None], s2[:, None, None, None], obs)
    unit, vis, _, _ = camera(game, s, res)
    return game.render_overlay(s, obs, sx, sy, res, unit, vis)


def to_shade(f):
    """qt-utils.h:21-28."""
    return torch.clamp((f * 255).to(i32), 0, 255)


def _base_paint_background():
    from ..core.game import BasicAbstractGame

    return BasicAbstractGame.paint_background


def _sample_grid(grid, celly, cellx, hmax, wmax, oob_val):
    """out[n, p, q] = grid[n, celly[n, p], cellx[n, q]]; out-of-range cells
    read as ``oob_val``."""
    n = grid.shape[0]
    yc = celly.clamp(0, hmax - 1).long()
    xc = cellx.clamp(0, wmax - 1).long()
    idx = yc[:, :, None] * wmax + xc[:, None, :]
    vals = grid.reshape(n, -1).gather(1, idx.reshape(n, -1)).reshape(idx.shape)
    inb = ((celly >= 0) & (celly < hmax))[:, :, None] & (
        (cellx >= 0) & (cellx < wmax)
    )[:, None, :]
    return torch.where(inb, vals, oob_val)


def _paint_background(game, s, obs, sx, sy, res, unit, vis, pix, bi, bg_ar):
    """draw_background (cpp:988-1016): the aspect-preserving crop with the
    random x offset, or, for a negative ``bg_tile_ratio``, the image tiled
    vertically over the world (tile_image, cpp:849-878).  ``pix`` is the
    atlas [nb, BH, BW, 3] u8, or the envs' painted canvases [N, 128, 128,
    3] u8, ``bi`` the per-env image index."""
    BH, BW = pix.shape[1], pix.shape[2]
    W = s.main_width.to(f32)
    H = s.main_height.to(f32)
    cx, cy, _ = center(game, s)
    x_off = unit * (cx - vis / 2)
    y_off = unit * (cy - vis / 2)
    mr_x = -x_off
    mr_y = (vis - H) * unit + y_off
    mr_w = W * unit
    mr_h = H * unit
    c = lambda t: t[:, None]  # noqa: E731  [N] -> [N, 1]
    if game.bg_tile_ratio < 0:
        fy = (sy - c(mr_y)) / c(tile_height(mr_w, mr_h, -game.bg_tile_ratio))
        row_idx = ((fy - torch.floor(fy)) * BH).to(i32).clamp(0, BH - 1)
        col_idx = ((sx - c(mr_x)) / c(mr_w) * BW).to(i32).clamp(0, BW - 1)
        in_y = (sy >= c(mr_y)) & (sy < c(mr_y) + c(mr_h))
        in_x = (sx >= c(mr_x)) & (sx < c(mr_x) + c(mr_w))
        samp = pix[bi[:, None, None], row_idx.long()[:, :, None],
                   col_idx.long()[:, None, :]]
        m = (in_y[:, :, None] & in_x[:, None, :])[..., None]
        return torch.where(m, samp.to(i32), 0)
    world_ar = W / H
    extra_w = bg_ar - world_ar
    offx = s.bg_pct_x * extra_w
    bgr_x = mr_x + mr_w * (-offx)
    bgr_w = bg_width(mr_w, bg_ar, W, H)
    row_idx = ((sy - c(mr_y)) / c(mr_h) * BH).to(i32).clamp(0, BH - 1)
    col_idx = ((sx - c(bgr_x)) / c(bgr_w) * BW).to(i32).clamp(0, BW - 1)
    in_y = (sy >= c(mr_y)) & (sy < c(mr_y) + c(mr_h))
    in_x = (sx >= c(bgr_x)) & (sx < c(bgr_x) + c(bgr_w))
    samp = pix[bi[:, None, None], row_idx.long()[:, :, None],
               col_idx.long()[:, None, :]]  # [N, res, res, 3]
    m = (in_y[:, :, None] & in_x[:, None, :])[..., None]
    return torch.where(m, samp.to(i32), 0)


def bg_width(mr_w, bg_ar, w, h):
    """The background rect's width, ``mr_w * bg_ar / (w / h)`` as the JAX
    package computes it: XLA's algebraic simplifier rewrites
    ``a / (b / c)`` to ``a * c / b``, which can differ in the last bit."""
    return mr_w * bg_ar * h / w


def tile_height(mr_w, mr_h, ratio):
    """The height of one background tile (tile_image, cpp:849-878): the
    world rect ``mr_h`` high split into ``max(int(mr_h / (mr_w * ratio)),
    1)`` tiles."""
    num_tiles = torch.clamp_min((mr_h / (mr_w * ratio)).to(i32), 1)
    return mr_h / num_tiles.to(f32)


def scroll_lookup(x_off, sx, sy, res: int, BH: int, BW: int):
    """The time-scrolled background's per-pixel indices (starpilot's
    paint_background, procgen_tpu/games/starpilot.py:138-170): 18 square
    tiles of side ``3 * res`` side by side, the top edge at ``-res``,
    shifted right by ``x_off`` ([N, 1] f32, the game's
    ``background_offset``); ``sx`` / ``sy`` are the pixel centres
    ([1, res]).  Returns the image row of each pixel row ([1, res]), the
    image column of each pixel column and whether it lies on the tiles
    ([N, res] each).  The JAX package divides by the side, a constant; XLA
    computes that as a multiply by the side's f32 reciprocal, and so does
    this."""
    inv_side = float(torch.tensor(1 / (3 * res), dtype=f32))
    tx = sx - x_off
    fx = tx * inv_side
    col_idx = ((fx - torch.floor(fx)) * BW).to(i32).clamp(0, BW - 1)
    in_x = (tx >= 0) & (tx < 18.0 * (3 * res))
    row_idx = ((sy + float(res)) * inv_side * BH).to(i32).clamp(0, BH - 1)
    return row_idx, col_idx, in_x

def _paint_pool(game, s, obs, pool, zlevel, mask, res, wxs, wys, sx, sy):
    """One pool at one z level under ``use_monochrome_assets``
    (procgen_tpu/render/renderer.py:125-165): each pixel takes the colour
    of the last live slot whose rectangle holds it, opaque; its world
    rectangle is ``|wx - x| < rx`` and ``|wy - y| < ry``, an absolute one
    ``x0 <= sx < x0 + 2 res rx`` with ``x0 = res (x - rx)``."""
    e = pool
    n = e.x.shape[0]
    img_all = game.image_for_type(s, e.image_type)
    live_all = e.active & (e.render_z == zlevel) & (img_all >= 0) & (img_all != SPACE)
    if mask is not None:
        live_all = live_all & mask
    winner = torch.full(obs.shape[:3], -1, dtype=torch.int64, device=obs.device)
    for i in range(int(e.count.max()) if n else 0):
        c = lambda t: t[:, i:i + 1]  # noqa: E731  slot i, [N, 1]
        xcov_w = torch.abs(wxs - c(e.x)) < c(e.rx)
        ycov_w = torch.abs(wys - c(e.y)) < c(e.ry)
        x0 = res * (c(e.x) - c(e.rx))
        y0 = res * (c(e.y) + c(e.ry))
        xcov_a = (sx >= x0) & (sx < x0 + 2 * res * c(e.rx))
        ycov_a = (sy >= y0) & (sy < y0 + 2 * res * c(e.ry))
        ua = c(e.use_abs_coords)
        xcov = torch.where(ua, xcov_a, xcov_w)
        ycov = torch.where(ua, ycov_a, ycov_w)
        cover = ycov[:, :, None] & xcov[:, None, :] & live_all[:, i, None, None]
        winner = torch.where(cover, i, winner)
    r, g, b = game.color_for_type(img_all, e.image_theme)
    colors = torch.stack([torch.as_tensor(v, device=obs.device).to(i32).expand(n, e.cap)
                          for v in (r, g, b)], dim=-1)  # [N, cap, 3]
    col = colors.gather(1, winner.clamp_min(0).reshape(n, -1, 1).expand(-1, -1, 3))
    return torch.where((winner >= 0)[..., None], col.reshape(obs.shape), obs)


def _sprite_canvases(game, s, pool, mask, atlas, res, unit, vis, x_off,
                     y_off, sx, sy, z_levels):
    """Entity sprite pass (draw_entity, cpp:1061-1067), slot by slot in
    C++ vector order into one premultiplied bf16 canvas per z level;
    returns [len(z_levels), N, res, res, 4] bf16."""
    from .atlas import ROT_OVERHANG

    e = pool
    n, cap = e.x.shape
    S = atlas.tile_px
    dev = e.x.device
    rows = atlas.rows_on(dev)  # [n_rows, S, S, 4] u8

    img_all = game.image_for_type(s, e.image_type)
    live_all = e.active & (img_all >= 0) & (img_all != SPACE)
    if mask is not None:
        live_all = live_all & mask
    row_all = atlas.row_for(img_all, game.mask_theme(img_all, e.image_theme))
    tile_ratio_all = game.entity_tile_ratio(s, e)

    c = lambda t: t[:, None]  # noqa: E731
    x0_w = (e.x - e.rx) * c(unit) - c(x_off)
    y0_w = (c(vis) - (e.y + e.ry)) * c(unit) + c(y_off)
    w2_w = 2 * e.rx * c(unit)
    h2_w = 2 * e.ry * c(unit)
    x0_a = res * (e.x - e.rx)
    y0_a = res * (e.y + e.ry)
    w2_a = 2 * res * e.rx
    h2_a = 2 * res * e.ry
    ua = e.use_abs_coords
    x0_all = torch.where(ua, x0_a, x0_w)
    y0_all = torch.where(ua, y0_a, y0_w)
    w2_all = torch.where(ua, w2_a, w2_w)
    h2_all = torch.where(ua, h2_a, h2_w)
    x0_all, y0_all, w2_all, h2_all = game.adjust_image_rect(
        img_all, x0_all, y0_all, w2_all, h2_all
    )

    fr, fg, fb = game.color_for_type(img_all, e.image_theme)
    fallback_rgb = torch.stack(
        [torch.as_tensor(v, device=dev).to(f32).expand(n, cap) for v in (fr, fg, fb)],
        dim=-1,
    )  # [N, cap, 3]
    is_fallback = row_all == atlas.transparent_row

    nz = len(z_levels)
    canv = torch.zeros((nz, n, res, res, 4), dtype=bf16, device=dev)
    ones = torch.ones((n, res, res, 1), dtype=f32, device=dev)
    # slots past every env's live count blend with alpha 0, an exact
    # identity on the bf16 canvases: the walk stops at the largest count
    for i in range(min(cap, int(e.count.max())) if n else 0):
        rot = e.rotation[:, i]
        qf = rot * (2.0 / torch.pi)
        q = torch.remainder(torch.round(qf).to(i32), 4)
        arb = torch.abs(qf - torch.round(qf)) > 1e-4
        brow, has_bank = atlas.bank_row_for(
            row_all[:, i], e.is_reflected[:, i].to(i32), rot
        )
        use_bank = arb & has_bank
        grow = torch.where(use_bank, ROT_OVERHANG, 1.0).to(f32)

        w2_r, h2_r = w2_all[:, i], h2_all[:, i]
        x0 = x0_all[:, i] - w2_r * (grow - 1.0) * 0.5
        y0 = y0_all[:, i] - h2_r * (grow - 1.0) * 0.5
        w2 = torch.clamp_min(w2_r * grow, 1e-6)
        h2 = torch.clamp_min(h2_r * grow, 1e-6)

        u = (sx - c(x0)) / c(w2)  # [N, res] along screen x
        v = (sy - c(y0)) / c(h2)  # [N, res] along screen y
        xvalid = (u >= 0) & (u < 1)
        yvalid = (v >= 0) & (v < 1)

        tr = tile_ratio_all[:, i]
        nt_h = torch.clamp_min((w2 / (h2 * torch.clamp_min(tr, 1e-6))).to(i32), 1)
        nt_v = torch.clamp_min((h2 / (w2 * torch.clamp_min(-tr, 1e-6))).to(i32), 1)
        ut = u * c(nt_h.to(f32))
        vt = v * c(nt_v.to(f32))
        u_ = torch.where(c(tr > 0), ut - torch.floor(ut), u)
        v_ = torch.where(c(tr < 0), vt - torch.floor(vt), v)

        ui = (u_ * S).to(i32).clamp(0, S - 1)
        vi = (v_ * S).to(i32).clamp(0, S - 1)

        use_t = ((q == 1) | (q == 3)) & ~use_bank
        rowflip = ((q == 2) | (q == 3)) & ~use_bank
        colflip = ((q == 1) | (q == 2)) & ~use_bank

        row_i = torch.where(use_bank, brow, row_all[:, i]).long()
        row_i = row_i.clamp(0, rows.shape[0] - 1)
        row_idx = torch.where(c(rowflip), S - 1 - vi, vi)  # from screen y
        col_idx = torch.where(c(colflip), S - 1 - ui, ui)  # from screen x
        # reflect (flip source x) then maybe transpose, as index remaps:
        # img'[r, c] = img[r, S-1-c] under reflection; img''[r, c] =
        # img'[c, r] under use_t
        refl = c(e.is_reflected[:, i] & ~use_bank)
        ut_ = c(use_t)
        src_r = torch.where(ut_, col_idx, row_idx)  # [N, res] (rows or cols)
        src_c = torch.where(ut_, row_idx, col_idx)
        # src_r/src_c index the pixel grid [p=row, q=col]: build per pixel
        rr = torch.where(ut_[:, :, None], src_r[:, None, :], src_r[:, :, None])
        cc = torch.where(ut_[:, :, None], src_c[:, :, None], src_c[:, None, :])
        cc = torch.where(refl[:, :, None], S - 1 - cc, cc)
        samp = rows[row_i[:, None, None], rr.long(), cc.long()].to(f32)  # [N,res,res,4]
        inside = yvalid[:, :, None] & xvalid[:, None, :]
        samp = torch.where(inside[..., None], samp, 0.0)

        cover = inside.to(f32)
        fbk = is_fallback[:, i][:, None, None]
        a = torch.where(
            fbk, cover,
            samp[..., 3] * (e.alpha[:, i][:, None, None] * (1.0 / 255.0)) * cover,
        )
        rgb = torch.where(fbk[..., None], fallback_rgb[:, i][:, None, None, :],
                          samp[..., :3])
        a = torch.where(live_all[:, i][:, None, None], a, 0.0)

        src = torch.cat([rgb, ones], dim=-1)
        for zi, z in enumerate(z_levels):
            az = (a * (e.render_z[:, i] == z).to(f32)[:, None, None])[..., None]
            canv[zi] = (src * az + canv[zi].to(f32) * (1 - az)).to(bf16)
    return canv


def grid_window(game, s):
    """Grid types of the aligned ``NC x NC`` cell window, int32
    ``[N, NC, NC]`` (window rows in descending world y), plus its
    (top_y, low_x) cell origin.  The static camera's window is the world
    (NC = its larger side, INVALID_OBJ outside it); the centred camera's
    follows the agent (NC = visibility + 3, origin truncated toward zero,
    out_of_bounds_object outside the world; pallas_kernel.py:321-342)."""
    wmax, hmax = game.WORLD_DIM_MAX
    n = s.num
    dev = s.grid.device
    if game.center_agent:
        NC = int(game.visibility) + 3
        cx, cy, vis = game.camera(s)
        margin = vis / 2 + 1
        low_x = torch.trunc(cx - margin).to(i32)
        low_y = torch.trunc(cy - margin).to(i32)
        oob_val = game.out_of_bounds_object
    else:
        NC = max(wmax, hmax)
        low_x = torch.zeros((n,), dtype=i32, device=dev)
        low_y = torch.zeros((n,), dtype=i32, device=dev)
        oob_val = INVALID_OBJ
    top_y = low_y + NC
    ar = torch.arange(NC, device=dev, dtype=i32)[None, :]
    cys = top_y[:, None] - 1 - ar  # window rows: descending world y
    cxs = low_x[:, None] + ar
    gt = _sample_grid(s.grid, cys, cxs, hmax, wmax, INVALID_OBJ)
    inb = ((cys >= 0) & (cys < s.main_height[:, None]))[:, :, None] & (
        (cxs >= 0) & (cxs < s.main_width[:, None])
    )[:, None, :]
    return torch.where(inb, gt, oob_val), top_y, low_x


def grid_rows(game, s, gt, atlas):
    """The grid-atlas row of every window cell (``gt`` from
    ``grid_window``), int32; the transparent row where nothing is drawn."""
    img = game.image_for_type(s, gt)
    theme = game.theme_for_grid_obj(s, gt)
    img = torch.where(gt == INVALID_OBJ, -1, img)
    return atlas.row_for(img, game.mask_theme(img, theme))


def grid_tile_canvas(game, s, atlas):
    """Aligned per-env tile canvas ``[N, NC*sA, NC*sA, 5]`` (RGBA + covered
    flag, exact u8 values in f32), plus the (top_y, low_x) cell origin."""
    sA = atlas.tile_px
    dev = s.grid.device
    # a 5th channel marks atlas-covered texels so the colored-cell pass
    # skips those cells
    rows = atlas.rows_on(dev)
    covered = torch.arange(rows.shape[0], device=dev) < atlas.transparent_row
    covered = (covered.to(torch.uint8) * 255)[:, None, None, None]
    aug = torch.cat([rows, covered.expand(-1, sA, sA, 1)], dim=-1)

    gt, top_y, low_x = grid_window(game, s)
    n, NC = gt.shape[0], gt.shape[1]
    row = grid_rows(game, s, gt, atlas).long()  # [N, NC, NC]
    canvas = aug[row]  # [N, NC, NC, sA, sA, 5]
    canvas = canvas.permute(0, 1, 3, 2, 4, 5).reshape(n, NC * sA, NC * sA, 5)
    return canvas, top_y, low_x


def _paint_grid_tiles(game, s, obs, res, wxs, wys, atlas):
    """Textured grid pass: aligned tile canvas + separable nearest
    resample (procgen_tpu/render/renderer.py:570-597)."""
    sA = atlas.tile_px
    canvas, top_y, low_x = grid_tile_canvas(game, s, atlas)
    GS = canvas.shape[1]

    cyx = (top_y.to(f32)[:, None] - wys) * sA  # [N, res] canvas row per row
    cxx = (wxs - low_x.to(f32)[:, None]) * sA
    ri = torch.floor(cyx).to(i32).clamp(0, GS - 1).long()
    ci = torch.floor(cxx).to(i32).clamp(0, GS - 1).long()
    in_r = (cyx >= 0) & (cyx < GS)
    in_c = (cxx >= 0) & (cxx < GS)
    n = canvas.shape[0]
    samp = canvas[torch.arange(n, device=canvas.device)[:, None, None],
                  ri[:, :, None], ci[:, None, :]]  # [N, res, res, 5] u8
    m = (in_r[:, :, None] & in_c[:, None, :])[..., None]
    samp = torch.where(m, samp.to(f32), 0.0)

    alpha = fdiv(samp[..., 3:4], 255.0)
    rgb = samp[..., :3]
    blended = torch.round(obs.to(f32) * (1 - alpha) + rgb * alpha).to(i32)
    covered = samp[..., 4] > 127
    return blended, covered
