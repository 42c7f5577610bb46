"""The per-step frame render: prep in torch, the frame kernels in CUDA.

The counterpart of ``procgen_tpu.render.pallas_kernel``, on two paths:

* the static-prefix path, which maze, leaper, bigfish, plunder, dodgeball
  and bossfight take:
  the background, grid tiles and colored cells are composed once per level into
  ``state.frame`` (lifecycle.env_reset), and each step composites only the
  sprites over that frame.  ``render_suffix`` launches
  ``csrc/render_suffix.cu``; it reproduces the Pallas kernel's K1a (start
  from the cached frame), K1b (per-slot sampling into premultiplied bf16
  canvases, one per z level of each pool) and K1c (composite z=0 then
  z=1, at each z the entity pool's canvas and then the decor pool's,
  round, u8).
* the whole-frame path of a game that is not static, which miner, coinrun,
  fruitbot, starpilot and climber take, under the static camera or the
  agent-centred one (the game's ``camera`` hook: climber's shows the
  world's width).  ``render_frame`` launches ``csrc/render_frame.cu``;
  it adds the Pallas kernel's K1d (the background: the standard crop,
  fruitbot's vertical tiling or starpilot's time-scrolled tiles of a fixed
  image, or under generated assets the env's own painted canvas, cropped
  or tiled), the z=-1 composite, K1e (grid tiles from the camera's cell
  window), K1f (colored cells) and the decor pool, painted into its own
  canvases and composited after the entity pool's at each z.  Each pool is
  walked to its live count; the TPU kernel's grouped pass (K2) paints the
  same canvases as this in-order walk.

``prep`` evaluates every game hook at ``[N, cap]`` scale (rects, atlas
rows, flips, tiling, fallback colors), ``_prep_pool`` of the JAX package
operation for operation; ``prep_suffix`` adds the decor pool of the
static path; ``prep_frame`` adds the per-env scalars, the grid
window's row table and the colored-cell planes (the non-static branch of
``_prep_one``).  Each kernel has a plain torch twin,
``render_suffix_reference`` and ``render_frame_reference``, which serves
CPU tensors; a CUDA tensor always goes to the kernel.  ``post`` adds the
velocity squares and game overlays.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core.assetgen import CAN
from ..core.constants import SPACE
from .atlas import ROT_OVERHANG, get_atlases
from .renderer import (
    bg_width, camera, fdiv, grid_rows, grid_window, post, scroll_lookup,
    tile_height,
)

f32 = torch.float32
i32 = torch.int32
u8 = torch.uint8

RES = 64

# ent_f columns
EF_X0, EF_Y0, EF_W2, EF_H2, EF_ALPHA, EF_R, EF_G, EF_B = range(8)
EF_N = 8
# ent_i columns
(EI_ROW, EI_LIVE, EI_FB, EI_PFLIP, EI_QFLIP, EI_Z, EI_NTH, EI_NTV,
 EI_TILEH, EI_TILEV) = range(10)
EI_N = 10
# per-env scalar columns, f32 (procgen_tpu/render/pallas_kernel.py:69-71)
(SF_UNIT, SF_VIS, SF_XOFF, SF_YOFF, SF_MRX, SF_MRY, SF_MRW, SF_MRH,
 SF_BGRX, SF_BGRW, SF_TILEH, SF_TOPY, SF_LOWX) = range(13)
SF_N = 13
# per-env scalar columns, int32 (:73-74)
SI_BGROW, SI_ENT_COUNT, SI_DEC_COUNT = range(3)
SI_N = 3
# K1d's background modes, one per launch: none, the standard crop with the
# random x offset (SF_BGRX, SF_BGRW), the vertical tiling (SF_TILEH), the
# time-scrolled tiles (SF_BGRX, the scroll offset)
BG_NONE, BG_CROP, BG_TILED, BG_SCROLL = range(4)

# Launches of each CUDA kernel since import (or since a caller reset
# them); each wrapper adds one to its own count per launch and nothing
# else touches them.
LAUNCHES = {"render_suffix": 0, "render_frame": 0}


class RenderPlan:
    """Static per-game plan: the atlases in the kernels' layouts.

    Under ``use_monochrome_assets`` there is no entity or grid atlas
    (pallas_kernel.py:129-162): the entity atlas is a 2x2 placeholder of
    one transparent row and its transpose (``S`` 2, ``n1e`` 1), every slot
    paints its ``color_for_type`` colour (``_prep_pool``), and the grid is
    a 2x2 placeholder row that covers nothing (``sA`` 2, every cell row 0,
    ``grid_opaque`` 0), so the cells are drawn by the colored-cell pass."""

    def __init__(self, game, res: int):
        assert res == RES, "the frame kernel is 64x64 only"
        grid_atlas, bg_atlas, ent_atlas = get_atlases(game, res)
        self.game = game
        self.res = res
        self.static = bool(game.static_prefix)
        self.ent_atlas = ent_atlas
        self.z_levels = tuple(game.ENT_Z_LEVELS)
        self.dz_levels = tuple(game.DECOR_Z_LEVELS) if game.DECOR_CAP else ()
        # each pool's canvas index of z = -1, 0, 1 (-1: no such level)
        self.z_slots = tuple(
            self.z_levels.index(z) if z in self.z_levels else -1 for z in (-1, 0, 1)
        )
        self.dz_slots = tuple(
            self.dz_levels.index(z) if z in self.dz_levels else -1 for z in (-1, 0, 1)
        )
        # rows: [n1e, S, S, 4] u8, the transparent row kept
        rows = (np.zeros((1, 2, 2, 4), np.uint8) if ent_atlas is None
                else ent_atlas.rows)
        self.S = rows.shape[1]
        self.n1e = rows.shape[0]
        # rows, then their transposes: the quarter-turn variants
        self.arrays = {"ent": np.ascontiguousarray(
            np.concatenate([rows, np.transpose(rows, (0, 2, 1, 3))], axis=0)
        )}  # [2*n1e, S, S, 4] u8
        if not self.static:
            wmax, hmax = game.WORLD_DIM_MAX
            # the cell window: the world, or the centred camera's
            # visibility + 3 cells (pallas_kernel.py:89-93)
            self.NC = (int(game.visibility) + 3 if game.center_agent
                       else max(wmax, hmax))
            self.grid_atlas = grid_atlas
            if grid_atlas is None:  # monochrome: no tile covers a cell
                self.sA, self.grid_opaque = 2, 0
                self.arrays["grid"] = np.zeros((1, 2, 2, 4), np.uint8)
            else:
                self.sA = grid_atlas.tile_px
                # rows below this one are tiles that cover their cell
                self.grid_opaque = grid_atlas.transparent_row
                self.arrays["grid"] = grid_atlas.rows  # [n_rows, sA, sA, 4] u8
            # under generated assets each env paints its own canvas
            # (state.bg_canvas): square, cropped or tiled, never scrolled
            # (pallas_kernel.py:632, bg_scroll and not bg_procgen)
            self.procgen_bg = bool(game.uses_procgen_background)
            use_bg = ((bg_atlas is not None or self.procgen_bg)
                      and game.options.use_backgrounds)
            self.bg_mode = (BG_NONE if not use_bg else
                            BG_TILED if game.bg_tile_ratio < 0 else
                            BG_CROP if self.procgen_bg else
                            BG_SCROLL if game.PALLAS_BG == "scroll" else BG_CROP)
            if bg_atlas is not None:
                self.arrays["bg"] = bg_atlas.pixels  # [nb, BH, BW, 3] u8
                self.bg_aspects = np.asarray(bg_atlas.aspects, np.float32)
            else:
                self.arrays["bg"] = np.zeros((1, 1, 1, 3), np.uint8)
                self.bg_aspects = np.ones((1,), np.float32)
        self._dev: dict = {}

    def on(self, name: str, device) -> torch.Tensor:
        """Atlas ``name`` ("ent", and for the whole-frame path "grid" and
        "bg") as a tensor on ``device``, cached."""
        key = (name, str(device))
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.arrays[name], device=device)
        return self._dev[key]

    def atlas(self, device) -> torch.Tensor:
        """The entity atlas and its transposes, uint8 [2*n1e, S, S, 4]."""
        return self.on("ent", device)

    @property
    def atlas_np(self) -> np.ndarray:
        return self.arrays["ent"]


_PLANS: dict = {}


def get_plan(game, res: int = RES) -> RenderPlan:
    # every option is part of the key (the plan keeps its game, whose
    # themes follow restrict_themes), the camera the game chose, and the
    # generated sprites' seed
    key = (game.name, game.options, res, id(type(game)), bool(game.center_agent),
           game.options.use_generated_assets and int(game.fixed_asset_seed))
    if key not in _PLANS:
        _PLANS[key] = RenderPlan(game, res)
    return _PLANS[key]


# canvases each frame kernel keeps a pixel (both pools together)
MAX_CANVASES = 4


def _known_cell_colors():
    """The ``grid_cell_colors`` hooks the cell planes reproduce: the base
    one and chaser's orbs (``pallas_kernel._known_cell_colors``,
    :225-236)."""
    from ..core.game import BasicAbstractGame
    from ..games.chaser import Chaser

    return (BasicAbstractGame.grid_cell_colors, Chaser.grid_cell_colors)


def supports(game, res: int = RES) -> bool:
    """Games whose per-step frame this module reproduces: the JAX gate
    (procgen_tpu/render/pallas_kernel.py:204-215) restricted to the ported
    paths: either the static prefix with z in (0, 1) in
    the entity pool and the decor pool, if any, or the whole frame with a
    fixed background image, cropped (``bg_tile_ratio >= 0``), tiled
    vertically (``bg_tile_ratio < 0``, fruitbot) or scrolled with time
    (``PALLAS_BG == "scroll"`` with starpilot's ``paint_background``), or
    each env's painted canvas under generated assets, cropped or tiled, z
    in (-1, 0, 1) in both pools, under the static camera or the
    agent-centred one (memory mode's centred window of ``visibility + 3``
    cells among them), colored cells drawn whole or, as chaser's orbs, on
    a centred inset (``grid_cell_inset``); textured or monochrome
    (``use_monochrome_assets``: every slot and cell its fallback colour)."""
    from ..core.game import BasicAbstractGame

    if res != RES:
        return False
    if type(game).paint_background is not BasicAbstractGame.paint_background:
        from ..games.starpilot import Starpilot

        if (game.PALLAS_BG != "scroll"
                or type(game).paint_background is not Starpilot.paint_background):
            return False
    if type(game).grid_cell_colors not in _known_cell_colors():
        return False  # per-pixel cell patterns beyond the inset model
    z = tuple(game.ENT_Z_LEVELS)
    dz = tuple(game.DECOR_Z_LEVELS) if game.DECOR_CAP else ()
    if game.static_prefix:
        return z in ((0,), (1,), (0, 1)) and dz in ((), (0,), (1,), (0, 1))
    return (
        not getattr(game, "DYNAMIC_VISIBILITY", False)
        and game.PALLAS_BG in ("standard", "scroll")
        and all(len(set(lv)) == len(lv) and set(lv) <= {-1, 0, 1}
                for lv in (z, dz))
        and 1 <= len(z) and len(z) + len(dz) <= MAX_CANVASES
    )


# ---------------------------------------------------------------------------
# prep: game hooks at [N, cap] scale (procgen_tpu/render/pallas_kernel.py
# _prep_pool, :437-545)
# ---------------------------------------------------------------------------


def prep(plan: RenderPlan, s, cam=None):
    """Per-slot sprite parameters of the entity pool: (ent_f f32
    [N, cap, 8], ent_i int32 [N, cap, 10]).  ``cam``: the (unit, vis,
    x_off, y_off) of ``renderer.camera``, computed when None."""
    cam = camera(plan.game, s, plan.res) if cam is None else cam
    return _prep_pool(plan, s, s.ents, plan.game.should_draw_entity_mask(s),
                      plan.z_levels, cam)


def prep_decor(plan: RenderPlan, s, cam):
    """``prep`` for the decor pool: (dec_f f32 [N, dcap, 8], dec_i int32
    [N, dcap, 10]), z indices into its own canvases; empty pools for a game
    without one."""
    if not plan.dz_levels:
        n = s.num
        dev = s.grid.device
        return (torch.zeros((n, 0, EF_N), dtype=f32, device=dev),
                torch.zeros((n, 0, EI_N), dtype=i32, device=dev))
    return _prep_pool(plan, s, s.decor, None, plan.dz_levels, cam)


@dataclasses.dataclass
class SuffixDecor:
    """The decor pool of the static-prefix path, beside the entity slots
    that ``render_suffix`` takes: ``dec_f`` f32 [N, dcap, 8] and ``dec_i``
    int32 [N, dcap, 10] from ``prep_decor``; ``counts`` int32 [N, 2], the
    live counts of the entity pool and of the decor pool (each pool is
    walked to its count); ``nzd``, the decor pool's canvases;
    ``z_slots`` / ``dz_slots``, each pool's canvas index of z = 0 and
    z = 1 (-1 for none)."""

    dec_f: torch.Tensor
    dec_i: torch.Tensor
    counts: torch.Tensor
    nzd: int
    z_slots: tuple
    dz_slots: tuple

    def to(self, device) -> "SuffixDecor":
        return dataclasses.replace(self, dec_f=self.dec_f.to(device),
                                   dec_i=self.dec_i.to(device),
                                   counts=self.counts.to(device))


def prep_suffix(plan: RenderPlan, s):
    """The static-prefix kernel's inputs: (ent_f, ent_i, decor), ``decor``
    a ``SuffixDecor`` for a game with a decor pool (the static branch of
    the JAX package's ``_prep_one`` with ``_pools_prep``, :244-380), else
    None."""
    cam = camera(plan.game, s, plan.res)
    ent_f, ent_i = prep(plan, s, cam)
    if not plan.dz_levels:
        return ent_f, ent_i, None
    dec_f, dec_i = prep_decor(plan, s, cam)
    counts = torch.stack([s.ents.count, s.decor.count], dim=1).to(i32)
    return ent_f, ent_i, SuffixDecor(
        dec_f=dec_f, dec_i=dec_i, counts=counts, nzd=len(plan.dz_levels),
        z_slots=plan.z_slots[1:], dz_slots=plan.dz_slots[1:])


def _prep_pool(plan: RenderPlan, s, e, mask, z_levels, cam):
    """One pool's slots (procgen_tpu/render/pallas_kernel.py _prep_pool,
    :437-545); ``mask`` is the should-draw mask or None."""
    game = plan.game
    res = plan.res
    n, cap = e.x.shape
    unit, vis, x_off, y_off = cam
    c = lambda t: t[:, None]  # noqa: E731  [N] -> [N, 1]

    img_all = game.image_for_type(s, e.image_type)
    live_all = e.active & (img_all >= 0) & (img_all != SPACE)
    if mask is not None:
        live_all = live_all & mask
    if plan.ent_atlas is not None:
        row_all = plan.ent_atlas.row_for(img_all, game.mask_theme(img_all, e.image_theme))
        is_fallback = row_all == plan.ent_atlas.transparent_row
    else:  # monochrome: every slot its fallback colour
        row_all = torch.zeros_like(img_all, dtype=i32)
        is_fallback = torch.ones_like(live_all)
    tile_ratio_all = game.entity_tile_ratio(s, e)

    x0_w = (e.x - e.rx) * c(unit) - c(x_off)
    y0_w = (c(vis) - (e.y + e.ry)) * c(unit) + c(y_off)
    w2_w = 2 * e.rx * c(unit)
    h2_w = 2 * e.ry * c(unit)
    x0_a = res * (e.x - e.rx)
    y0_a = res * (e.y + e.ry)
    w2_a = 2 * res * e.rx
    h2_a = 2 * res * e.ry
    ua = e.use_abs_coords
    x0 = torch.where(ua, x0_a, x0_w)
    y0 = torch.where(ua, y0_a, y0_w)
    w2 = torch.where(ua, w2_a, w2_w)
    h2 = torch.where(ua, h2_a, h2_w)
    x0, y0, w2, h2 = game.adjust_image_rect(img_all, x0, y0, w2, h2)
    w2 = torch.clamp_min(w2, 1e-6)
    h2 = torch.clamp_min(h2, 1e-6)

    fr, fg, fb = game.color_for_type(img_all, e.image_theme)

    # rotation quarter + reflection -> atlas variant + index flips: with T
    # the transposed variant, use_t=0 samples orig[p, refl ? S-1-q : q]
    # and use_t=1 samples origT[refl ? S-1-p : p, q], so
    # pflip = rowflip ^ (use_t & refl) and qflip = colflip ^ (~use_t & refl)
    qf = e.rotation * (2.0 / torch.pi)
    q = torch.remainder(torch.round(qf).to(i32), 4)
    refl = e.is_reflected
    if plan.ent_atlas is not None:
        arb = torch.abs(qf - torch.round(qf)) > 1e-4
        brow, has_bank = plan.ent_atlas.bank_row_for(row_all, refl.to(i32), e.rotation)
        use_bank = arb & has_bank
    else:  # no rotation banks
        brow, use_bank = row_all, torch.zeros_like(refl)

    grow = torch.where(use_bank, ROT_OVERHANG, 1.0).to(f32)
    x0 = x0 - w2 * (grow - 1.0) * 0.5
    y0 = y0 - h2 * (grow - 1.0) * 0.5
    w2 = torch.clamp_min(w2 * grow, 1e-6)
    h2 = torch.clamp_min(h2 * grow, 1e-6)
    use_t = ((q == 1) | (q == 3)) & ~use_bank
    rowflip = ((q == 2) | (q == 3)) & ~use_bank
    colflip = ((q == 1) | (q == 2)) & ~use_bank
    refl = refl & ~use_bank
    pflip = rowflip ^ (use_t & refl)
    qflip = colflip ^ (~use_t & refl)
    row2 = torch.where(use_bank, brow, row_all + torch.where(use_t, plan.n1e, 0))

    tr = tile_ratio_all
    nt_h = torch.clamp_min((w2 / (h2 * torch.clamp_min(tr, 1e-6))).to(i32), 1)
    nt_v = torch.clamp_min((h2 / (w2 * torch.clamp_min(-tr, 1e-6))).to(i32), 1)

    z_idx = torch.full_like(e.render_z, -1)
    for j, z in enumerate(z_levels):
        z_idx = torch.where(e.render_z == z, j, z_idx)

    def col(v):
        return torch.as_tensor(v, device=e.x.device).to(f32).expand(n, cap)

    ent_f = torch.stack(
        [x0, y0, w2, h2, e.alpha, col(fr), col(fg), col(fb)], dim=-1
    ).contiguous()
    ent_i = torch.stack(
        [row2.to(i32), live_all.to(i32), is_fallback.to(i32),
         pflip.to(i32), qflip.to(i32), z_idx.to(i32), nt_h, nt_v,
         (tr > 0).to(i32), (tr < 0).to(i32)],
        dim=-1,
    ).contiguous()
    return ent_f, ent_i


@dataclasses.dataclass
class FrameInputs:
    """Everything ``render_frame`` and ``render_frame_reference`` read.

    Per env: ``sf`` f32 [N, SF_N] and ``si`` int32 [N, SI_N] scalars (the
    two pools' live counts among them); ``gtab`` int32 [N, NC, NC], the
    grid-atlas row of every window cell; ``cell5`` f32 [N, 5, NC, NC], the
    colored-cell planes r, g, b, valid, inset; ``ent_f`` / ``ent_i`` and
    ``dec_f`` / ``dec_i``, the sprite slots of the entity and decor pools
    ([N, 0, ...] without a decor pool).  Shared: the atlases, uint8
    ``grid_atlas`` [n_rows, sA, sA, 4], ``bg_atlas`` [nb, BH, BW, 3] (with
    ``per_env_bg``, the envs' painted canvases [N, 128, 128, 3], each env's
    ``SI_BGROW`` its own index) and ``ent_atlas`` [2*n1e, S, S, 4];
    ``z_slots`` / ``dz_slots``, each pool's canvas index of z = -1, 0, 1
    (-1 for none) among its ``nz`` / ``nzd`` canvases; ``grid_opaque``, the first grid row that covers
    nothing; ``bg_mode``, K1d's mode (``BG_NONE``, ``BG_CROP``,
    ``BG_TILED`` or ``BG_SCROLL``)."""

    sf: torch.Tensor
    si: torch.Tensor
    gtab: torch.Tensor
    cell5: torch.Tensor
    ent_f: torch.Tensor
    ent_i: torch.Tensor
    dec_f: torch.Tensor
    dec_i: torch.Tensor
    grid_atlas: torch.Tensor
    bg_atlas: torch.Tensor
    ent_atlas: torch.Tensor
    z_slots: tuple
    nz: int
    dz_slots: tuple
    nzd: int
    grid_opaque: int
    bg_mode: int
    per_env_bg: bool = False

    def to(self, device) -> "FrameInputs":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))
        })


def prep_frame(plan: RenderPlan, s) -> FrameInputs:
    """The whole-frame kernel's inputs: the non-static branch of the JAX
    package's ``_prep_one`` (procgen_tpu/render/pallas_kernel.py:250-377)
    at ``[N, ...]`` scale, except that the grid tiles come as a per-cell
    atlas row table instead of the resampled tile canvas."""
    game = plan.game
    n = s.num
    dev = s.grid.device
    w = s.main_width.to(f32)
    h = s.main_height.to(f32)
    cam = camera(game, s, plan.res)
    unit, vis, x_off, y_off = cam

    sf = torch.zeros((n, SF_N), dtype=f32, device=dev)
    si = torch.zeros((n, SI_N), dtype=i32, device=dev)
    sf[:, SF_UNIT], sf[:, SF_VIS] = unit, vis
    sf[:, SF_XOFF], sf[:, SF_YOFF] = x_off, y_off
    if plan.bg_mode != BG_NONE:
        # the world rect (:271-279), then the tiling (:292-295) or the
        # standard crop with the random x offset (:296-302)
        mr_x = -x_off
        mr_y = (vis - h) * unit + y_off
        mr_w = w * unit
        mr_h = h * unit
        if plan.procgen_bg:
            # the env's own canvas, aspect 1 (:279-287)
            bi = torch.arange(n, dtype=i32, device=dev)
            bg_ar = torch.ones((n,), dtype=f32, device=dev)
        else:
            bi = s.background_index.clamp(0, plan.bg_aspects.shape[0] - 1)
            bg_ar = torch.as_tensor(plan.bg_aspects, device=dev)[bi.long()]
        sf[:, SF_MRX], sf[:, SF_MRY] = mr_x, mr_y
        sf[:, SF_MRW], sf[:, SF_MRH] = mr_w, mr_h
        if plan.bg_mode == BG_TILED:
            # the painted canvas tiles too, as the XLA renderer tiles it;
            # the Pallas kernel's prep leaves the tile height unset there
            # (:279 before :292; ROADMAP Queue 3)
            sf[:, SF_TILEH] = tile_height(mr_w, mr_h, -game.bg_tile_ratio)
        elif plan.bg_mode == BG_SCROLL:
            # the scroll offset (:287-291), as XLA computes it
            sf[:, SF_BGRX] = game.background_offset(s, plan.res)
        else:
            world_ar = w / h
            extra_w = bg_ar - world_ar
            offx = s.bg_pct_x * extra_w
            sf[:, SF_BGRX] = mr_x + mr_w * (-offx)
            sf[:, SF_BGRW] = bg_width(mr_w, bg_ar, w, h)
        si[:, SI_BGROW] = bi
    si[:, SI_ENT_COUNT] = s.ents.count
    if plan.dz_levels:
        si[:, SI_DEC_COUNT] = s.decor.count

    gt, top_y, low_x = grid_window(game, s)
    sf[:, SF_TOPY], sf[:, SF_LOWX] = top_y.to(f32), low_x.to(f32)
    gtab = (torch.zeros(gt.shape, dtype=i32, device=dev) if plan.grid_atlas is None
            else grid_rows(game, s, gt, plan.grid_atlas))

    # colored-cell planes, evaluated at the cell centre (:356-369)
    half = torch.full(gt.shape, 0.5, dtype=f32, device=dev)
    cv, cr, cg, cb = game.grid_cell_colors(s, gt, half, half)
    inset = game.grid_cell_inset(s, gt)
    cell5 = torch.stack(
        [torch.as_tensor(v, device=dev).to(f32).expand(gt.shape)
         for v in (cr, cg, cb, cv, inset)],
        dim=1,
    )

    ent_f, ent_i = prep(plan, s, cam)
    dec_f, dec_i = prep_decor(plan, s, cam)
    per_env_bg = plan.procgen_bg and plan.bg_mode != BG_NONE
    return FrameInputs(
        sf=sf, si=si, gtab=gtab.contiguous(), cell5=cell5.contiguous(),
        ent_f=ent_f, ent_i=ent_i, dec_f=dec_f, dec_i=dec_i,
        grid_atlas=plan.on("grid", dev),
        bg_atlas=s.bg_canvas.contiguous() if per_env_bg else plan.on("bg", dev),
        ent_atlas=plan.atlas(dev), z_slots=plan.z_slots,
        nz=len(plan.z_levels), dz_slots=plan.dz_slots,
        nzd=len(plan.dz_levels), grid_opaque=plan.grid_opaque,
        bg_mode=plan.bg_mode, per_env_bg=per_env_bg,
    )


# ---------------------------------------------------------------------------
# the kernels: plain torch versions and the CUDA wrappers
# ---------------------------------------------------------------------------


def _slot_canvases(ent_f, ent_i, atlas, nz: int, res: int = RES, count=None):
    """K1b in plain torch: the slots paint in order into premultiplied RGBA
    canvases, one per z index, each rounded to bf16 after every slot.
    ``count`` (int32 [N]): the pool's live count; slots at or past it do
    not paint (the pools are compacted).  Returns f32 [nz, N, res, res,
    4]."""
    n, cap = ent_f.shape[0], ent_f.shape[1]
    S = atlas.shape[1]
    dev = ent_f.device
    sx = (torch.arange(res, dtype=f32, device=dev) + 0.5)[None, :]
    sy = sx
    canv = torch.zeros((nz, n, res, res, 4), dtype=f32, device=dev)
    nidx = torch.arange(n, device=dev)
    if count is not None:  # no slot past the batch's largest count paints
        cap = min(cap, int(count.max())) if n else 0
    for i in range(cap):
        fi = ent_f[:, i]
        ii = ent_i[:, i]
        x0, y0, w2, h2 = (fi[:, k:k + 1] for k in (EF_X0, EF_Y0, EF_W2, EF_H2))
        u = (sx - x0) / w2  # [N, res]
        xvalid = (u >= 0) & (u < 1)
        ut = u * ii[:, EI_NTH:EI_NTH + 1].to(f32)
        u_ = torch.where(ii[:, EI_TILEH:EI_TILEH + 1] > 0, ut - torch.floor(ut), u)
        ui = (u_ * S).to(i32).clamp(0, S - 1)
        qidx = torch.where(ii[:, EI_QFLIP:EI_QFLIP + 1] > 0, S - 1 - ui, ui)

        v = (sy - y0) / h2
        yvalid = (v >= 0) & (v < 1)
        vt = v * ii[:, EI_NTV:EI_NTV + 1].to(f32)
        v_ = torch.where(ii[:, EI_TILEV:EI_TILEV + 1] > 0, vt - torch.floor(vt), v)
        vi = (v_ * S).to(i32).clamp(0, S - 1)
        pidx = torch.where(ii[:, EI_PFLIP:EI_PFLIP + 1] > 0, S - 1 - vi, vi)

        row = ii[:, EI_ROW].long().clamp(0, atlas.shape[0] - 1)
        tex = atlas[row[:, None, None], pidx.long()[:, :, None],
                    qidx.long()[:, None, :]].to(f32)  # [N, res, res, 4]
        inside = yvalid[:, :, None] & xvalid[:, None, :]
        tex = torch.where(inside[..., None], tex, 0.0)
        cover = inside.to(f32)

        fb = (ii[:, EI_FB] > 0)[:, None, None]
        alpha_e = fi[:, EF_ALPHA][:, None, None]
        a = torch.where(fb, cover, tex[..., 3] * (alpha_e * (1.0 / 255.0)) * cover)
        on = (ii[:, EI_LIVE] > 0) & (ii[:, EI_Z] >= 0)
        if count is not None:
            on = on & (i < count)
        a = torch.where(on[:, None, None], a, 0.0)
        rgb = torch.where(fb[..., None], fi[:, EF_R:EF_B + 1][:, None, None, :],
                          tex[..., :3])
        zc = ii[:, EI_Z].long().clamp(0, nz - 1)
        old = canv[zc, nidx]  # [N, res, res, 4]
        a1 = a[..., None]
        new_rgb = (rgb * a1 + old[..., :3] * (1 - a1))
        new_a = a1 + old[..., 3:] * (1 - a1)
        canv[zc, nidx] = torch.cat([new_rgb, new_a], dim=-1).to(torch.bfloat16).to(f32)
    return canv


def _composite(obs, canv, z: int):
    """K1c: canvas ``z`` (-1: none) over an f32 frame, rounded."""
    if z < 0:
        return obs
    c4 = canv[z]
    return torch.round(c4[..., :3] + obs * (1 - c4[..., 3:]))


def render_suffix_reference(base, ent_f, ent_i, atlas, nz: int, decor=None):
    """Plain torch sprite suffix: the kernel's function on [N, cap, ...].

    ``base`` uint8 [N, 64, 64, 3] (the cached prefix frame), ``ent_f`` /
    ``ent_i`` from ``prep``, ``atlas`` uint8 [2*n1e, S, S, 4].  Without
    ``decor`` the entity pool's canvases composite over the frame in index
    order.  With a ``SuffixDecor``, each pool is walked to its live count
    and at z = 0, then z = 1, the entity pool's canvas composites, then the
    decor pool's (pallas_kernel.py:951-967).  Returns uint8
    [N, 64, 64, 3]."""
    res = base.shape[1]
    obs = base.to(f32)
    if decor is None:
        canv = _slot_canvases(ent_f, ent_i, atlas, nz, res)
        for z in range(nz):
            obs = _composite(obs, canv, z)
        return obs.to(i32).to(u8)
    canv = _slot_canvases(ent_f, ent_i, atlas, nz, res, count=decor.counts[:, 0])
    dcanv = _slot_canvases(decor.dec_f, decor.dec_i, atlas, decor.nzd, res,
                           count=decor.counts[:, 1])
    for k in range(2):
        obs = _composite(_composite(obs, canv, decor.z_slots[k]), dcanv,
                         decor.dz_slots[k])
    return obs.to(i32).to(u8)


# The kernels' dynamic shared memory a block, the pieces csrc/sprite.cuh
# (slot_tables_bytes), render_suffix.cu (suffix_smem) and render_frame.cu
# (frame_smem) carve, each rounded up to 16 bytes; a block takes at most
# 227 KiB.  The axis tables hold texel indices as uint8 with 255 for
# "outside", so the entity atlas's tiles are at most 254 px.
SMEM_MAX = 232448
FRAME_BYTES = RES * RES * 3
MAX_TILE_PX = 254


def _a16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def slot_tables_bytes(total: int) -> int:
    """Shared memory of the slot tables for pools of ``total`` slots."""
    words = (total + 31) // 32
    return (_a16(32 * total) + _a16(4 * RES * words) + _a16(4 * EF_N * total)
            + _a16(4 * EI_N * total) + _a16(4 * total) + 2 * _a16(RES * total) + 16)


def suffix_smem(cap: int, dcap: int) -> int:
    """Shared memory of a ``render_suffix`` block: the frame, the tables."""
    return _a16(FRAME_BYTES) + slot_tables_bytes(cap + dcap)


def frame_smem(NC: int, cap: int, dcap: int) -> int:
    """Shared memory of a ``render_frame`` block: the frame, the tables,
    the scalars, the row table, the column and row terms, the alphas."""
    return (_a16(FRAME_BYTES) + slot_tables_bytes(cap + dcap) + _a16(4 * SF_N)
            + _a16(4 * SI_N) + _a16(4 * NC * NC) + 8 * _a16(4 * RES) + _a16(4 * 256))


def _distinct(slots) -> bool:
    """No canvas index twice among ``slots`` (-1: none): the kernels
    composite each canvas at one place of their order."""
    used = [z for z in slots if z >= 0]
    return len(set(used)) == len(used)


def _check(name, tensors):
    """Raise unless every (label, tensor, dtype, shape) matches, is
    contiguous and lies on the first tensor's device, which is a CUDA
    device."""
    dev = tensors[0][1].device
    for label, t, dt, shape in tensors:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: {label} must be {dt} {tuple(shape)} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors")
    return dev


def _check_aligned(name, frames=(), atlases=()):
    """Raise unless each uint8 frame batch starts on 16 bytes and each RGBA
    atlas on 4: the kernels move frames in 16-byte words and read texels
    as 32-bit words."""
    for t, align in [(f, 16) for f in frames] + [(a, 4) for a in atlases]:
        if t.data_ptr() % align:
            raise ValueError(f"{name}: a tensor must start on {align} bytes")


def render_suffix(base, ent_f, ent_i, atlas, nz: int, decor=None):
    """Launch ``csrc/render_suffix.cu`` on CUDA tensors (same contract as
    ``render_suffix_reference``); raises on anything it does not take.
    Without ``decor`` it launches the kernel's entity-only instance, with
    it the instance that walks both pools."""
    from .. import kernels

    n, cap = base.shape[0], ent_f.shape[1]
    checks = [
        ("base", base, u8, (n, RES, RES, 3)),
        ("ent_f", ent_f, f32, (n, cap, EF_N)),
        ("ent_i", ent_i, i32, (n, cap, EI_N)),
        ("atlas", atlas, u8, (atlas.shape[0], atlas.shape[1], atlas.shape[1], 4)),
    ]
    dcap, nzd, zs, dzs = 0, 0, (0, 1), (-1, -1)
    dec_ptrs = (None, None, None)
    if decor is not None:
        dcap, nzd = decor.dec_f.shape[1], decor.nzd
        zs, dzs = tuple(decor.z_slots), tuple(decor.dz_slots)
        checks += [
            ("dec_f", decor.dec_f, f32, (n, dcap, EF_N)),
            ("dec_i", decor.dec_i, i32, (n, dcap, EI_N)),
            ("counts", decor.counts, i32, (n, 2)),
        ]
        dec_ptrs = tuple(t.data_ptr() for t in (decor.dec_f, decor.dec_i, decor.counts))
    # up to 4 canvases in registers, both pools together; the frame and
    # the slot tables in a block's shared memory
    ok = (1 <= nz and nz + nzd <= MAX_CANVASES and suffix_smem(cap, dcap) <= SMEM_MAX
          and atlas.shape[1] <= MAX_TILE_PX)
    if decor is not None:
        ok = ok and nzd >= 1 and len(zs) == len(dzs) == 2 and all(
            -1 <= z < nz for z in zs) and all(-1 <= z < nzd for z in dzs) and (
            _distinct(zs) and _distinct(dzs))
    if not ok:
        raise ValueError(f"render_suffix: nz={nz}, nzd={nzd}, z_slots={zs}, "
                         f"dz_slots={dzs}, cap={cap}, dcap={dcap} or tile "
                         f"{atlas.shape[1]} px out of range")
    dev = _check("render_suffix", checks)
    _check_aligned("render_suffix", frames=(base,), atlases=(atlas,))
    out = torch.empty((n, RES, RES, 3), dtype=u8, device=dev)
    if n == 0:
        return out
    err = kernels.load().render_suffix(
        base.data_ptr(), ent_f.data_ptr(), ent_i.data_ptr(), *dec_ptrs,
        atlas.data_ptr(), out.data_ptr(), n, cap, dcap, nz, nzd, *zs, *dzs,
        atlas.shape[1], atlas.shape[0],
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"render_suffix launch failed: cudaError {err}")
    LAUNCHES["render_suffix"] += 1
    return out


def grid_lookup(x: FrameInputs):
    """K1e's per-pixel indices, the Pallas kernel's derivation
    (pallas_kernel.py:970-1011).  Returns ``wxs`` [N, 64] and ``wys``
    [N, 64], the world coordinates of the pixel columns and rows;
    ``inside`` [N, 64, 64], the pixel lies in the cell window; ``crow``
    [N, 64, 1] and ``ccol`` [N, 1, 64], its cell; ``row`` [N, 64, 64], the
    cell's grid-atlas row; ``tex`` f32 [N, 64, 64, 4], its tile texel (0
    outside the window)."""
    sf = x.sf
    n = sf.shape[0]
    dev = sf.device
    NC = x.gtab.shape[1]
    sA = x.grid_atlas.shape[1]
    GS = NC * sA
    pix = (torch.arange(RES, dtype=f32, device=dev) + 0.5)[None, :]  # [1, 64]
    unit, vis = sf[:, SF_UNIT:SF_UNIT + 1], sf[:, SF_VIS:SF_VIS + 1]
    wys = vis - (pix - sf[:, SF_YOFF:SF_YOFF + 1]) / unit  # per pixel row
    wxs = (pix + sf[:, SF_XOFF:SF_XOFF + 1]) / unit  # per pixel column

    cyx = (sf[:, SF_TOPY:SF_TOPY + 1] - wys) * sA  # window row per pixel row
    cxx = (wxs - sf[:, SF_LOWX:SF_LOWX + 1]) * sA
    ri = torch.floor(cyx).to(i32).clamp(0, GS - 1)
    ci = torch.floor(cxx).to(i32).clamp(0, GS - 1)
    inside = (((cyx >= 0) & (cyx < GS))[:, :, None]
              & ((cxx >= 0) & (cxx < GS))[:, None, :])
    crow = torch.div(ri, sA, rounding_mode="floor").long()[:, :, None]
    ccol = torch.div(ci, sA, rounding_mode="floor").long()[:, None, :]
    nidx = torch.arange(n, device=dev)[:, None, None]
    row = x.gtab[nidx, crow, ccol].long().clamp(0, x.grid_atlas.shape[0] - 1)
    tex = x.grid_atlas[row, torch.remainder(ri, sA).long()[:, :, None],
                       torch.remainder(ci, sA).long()[:, None, :]]
    tex = torch.where(inside[..., None], tex.to(f32), 0.0)
    return wxs, wys, inside, crow, ccol, row, tex


def background_lookup(x: FrameInputs):
    """K1d's per-pixel indices, scrolled (pallas_kernel.py:632-645), tiled
    (:646-655) or cropped (:656-666), of a fixed image or of the env's
    painted canvas (:679-680).  Returns ``bi`` [N], the clamped background
    image (the env's own index for a painted canvas); ``row_idx`` and
    ``in_y`` [N, 64], the image row of each pixel row and whether the row
    lies in the world rect (every row, scrolled); ``col_idx`` and ``in_x``
    [N, 64], the same for the pixel columns."""
    sf = x.sf
    n = sf.shape[0]
    BH, BW = x.bg_atlas.shape[1], x.bg_atlas.shape[2]
    pix = (torch.arange(RES, dtype=f32, device=sf.device) + 0.5)[None, :]
    bi = x.si[:, SI_BGROW].long().clamp(0, x.bg_atlas.shape[0] - 1)

    def col(k):
        return sf[:, k:k + 1]  # [N, 1]

    if x.bg_mode == BG_SCROLL:
        row_idx, col_idx, in_x = scroll_lookup(col(SF_BGRX), pix, pix, RES, BH, BW)
        in_y = torch.ones((n, RES), dtype=torch.bool, device=sf.device)
        return bi, row_idx.expand(n, RES), col_idx, in_y, in_x
    mr_y, mr_h = col(SF_MRY), col(SF_MRH)
    if x.bg_mode == BG_TILED:
        fy = (pix - mr_y) / col(SF_TILEH)
        row_idx = ((fy - torch.floor(fy)) * BH).to(i32).clamp(0, BH - 1)
        bgr_x, bgr_w = col(SF_MRX), col(SF_MRW)
    else:
        row_idx = ((pix - mr_y) / mr_h * BH).to(i32).clamp(0, BH - 1)
        bgr_x, bgr_w = col(SF_BGRX), col(SF_BGRW)
    col_idx = ((pix - bgr_x) / bgr_w * BW).to(i32).clamp(0, BW - 1)
    in_y = (pix >= mr_y) & (pix < mr_y + mr_h)
    in_x = (pix >= bgr_x) & (pix < bgr_x + bgr_w)
    return bi, row_idx, col_idx, in_y, in_x


def render_frame_reference(x: FrameInputs):
    """Plain torch whole frame: the function of ``csrc/render_frame.cu``
    (background, z=-1, grid tiles, colored cells, z=0, z=1; at each z the
    entity pool's canvas, then the decor pool's), with the Pallas kernel's
    index derivations.  Returns uint8 [N, 64, 64, 3]."""
    n = x.sf.shape[0]
    dev = x.sf.device
    nidx = torch.arange(n, device=dev)[:, None, None]

    # K1d: the background
    obs = torch.zeros((n, RES, RES, 3), dtype=f32, device=dev)
    if x.bg_mode != BG_NONE:
        bi, row_idx, col_idx, in_y, in_x = background_lookup(x)
        samp = x.bg_atlas[bi[:, None, None], row_idx.long()[:, :, None],
                          col_idx.long()[:, None, :]]
        m = (in_y[:, :, None] & in_x[:, None, :])[..., None]
        obs = torch.where(m, samp.to(f32), 0.0)

    canv = _slot_canvases(x.ent_f, x.ent_i, x.ent_atlas, x.nz,
                          count=x.si[:, SI_ENT_COUNT])
    dcanv = _slot_canvases(x.dec_f, x.dec_i, x.ent_atlas, x.nzd,
                           count=x.si[:, SI_DEC_COUNT])

    def paint_z(obs, k):
        return _composite(_composite(obs, canv, x.z_slots[k]), dcanv, x.dz_slots[k])

    obs = paint_z(obs, 0)  # z = -1

    # K1e: grid tiles (:970-1011)
    wxs, wys, inside, crow, ccol, row, tex = grid_lookup(x)
    alpha = fdiv(tex[..., 3:4], 255.0)  # a true division, as in the kernel
    obs = torch.round(obs * (1 - alpha) + tex[..., :3] * alpha)
    covered = inside & (row < x.grid_opaque)

    # K1f: colored cells (:1016-1038)
    cells = x.cell5.permute(0, 2, 3, 1)[nidx, crow, ccol]  # [N, 64, 64, 5]
    cells = torch.where(inside[..., None], cells, 0.0)
    half = cells[..., 4] / 2
    u_frac = (wxs - torch.floor(wxs))[:, None, :]
    v_frac = (wys - torch.floor(wys))[:, :, None]
    central = (torch.abs(u_frac - 0.5) < half) & (torch.abs(v_frac - 0.5) < half)
    gvalid = (cells[..., 3] > 0.5) & central & ~covered
    obs = torch.where(gvalid[..., None], cells[..., :3], obs)

    obs = paint_z(obs, 1)  # z = 0
    obs = paint_z(obs, 2)  # z = 1
    return obs.to(i32).to(u8)


def render_frame(x: FrameInputs):
    """Launch ``csrc/render_frame.cu`` on CUDA tensors (same contract as
    ``render_frame_reference``); raises on anything it does not take."""
    from .. import kernels

    n, cap, dcap = x.sf.shape[0], x.ent_f.shape[1], x.dec_f.shape[1]
    NC = x.gtab.shape[1]
    ga, bg, ea = x.grid_atlas, x.bg_atlas, x.ent_atlas
    # the frame, the slot tables, the scalars, the row table and the row
    # and column terms in a block's shared memory; the cell planes are read
    # from global memory
    smem = frame_smem(NC, cap, dcap)
    slots_ok = (len(x.z_slots) == len(x.dz_slots) == 3
                and all(-1 <= z < x.nz for z in x.z_slots)
                and all(-1 <= z < x.nzd for z in x.dz_slots)
                and _distinct(x.z_slots) and _distinct(x.dz_slots))
    if (not 1 <= x.nz or x.nzd < 0 or x.nz + x.nzd > MAX_CANVASES
            or smem > SMEM_MAX or not slots_ok or ea.shape[1] > MAX_TILE_PX
            or x.bg_mode not in (BG_NONE, BG_CROP, BG_TILED, BG_SCROLL)):
        raise ValueError(
            f"render_frame: nz={x.nz}, nzd={x.nzd}, z_slots={x.z_slots}, "
            f"dz_slots={x.dz_slots}, cap={cap}, dcap={dcap}, NC={NC}, tile "
            f"{ea.shape[1]} px or bg_mode={x.bg_mode} out of range"
        )
    dev = _check("render_frame", [
        ("sf", x.sf, f32, (n, SF_N)),
        ("si", x.si, i32, (n, SI_N)),
        ("gtab", x.gtab, i32, (n, NC, NC)),
        ("cell5", x.cell5, f32, (n, 5, NC, NC)),
        ("ent_f", x.ent_f, f32, (n, cap, EF_N)),
        ("ent_i", x.ent_i, i32, (n, cap, EI_N)),
        ("dec_f", x.dec_f, f32, (n, dcap, EF_N)),
        ("dec_i", x.dec_i, i32, (n, dcap, EI_N)),
        ("grid_atlas", ga, u8, (ga.shape[0], ga.shape[1], ga.shape[1], 4)),
        # a painted canvas per env, or a shared atlas of images
        ("bg_atlas", bg, u8, (n, CAN, CAN, 3) if x.per_env_bg
         else (bg.shape[0], bg.shape[1], bg.shape[2], 3)),
        ("ent_atlas", ea, u8, (ea.shape[0], ea.shape[1], ea.shape[1], 4)),
    ])
    _check_aligned("render_frame", atlases=(ga, ea))
    out = torch.empty((n, RES, RES, 3), dtype=u8, device=dev)
    if n == 0:
        return out
    err = kernels.load().render_frame(
        x.sf.data_ptr(), x.si.data_ptr(), x.gtab.data_ptr(), x.cell5.data_ptr(),
        x.ent_f.data_ptr(), x.ent_i.data_ptr(), x.dec_f.data_ptr(),
        x.dec_i.data_ptr(), ga.data_ptr(), bg.data_ptr(), ea.data_ptr(),
        out.data_ptr(),
        n, cap, dcap, x.nz, x.nzd, *x.z_slots, *x.dz_slots, NC, ga.shape[1],
        ga.shape[0], x.grid_opaque, x.bg_mode, bg.shape[0], bg.shape[1],
        bg.shape[2], ea.shape[1], ea.shape[0],
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"render_frame launch failed: cudaError {err}")
    LAUNCHES["render_frame"] += 1
    return out


def _occupancy(fn, *args):
    from .. import kernels

    out = (ctypes.c_int * 4)()
    err = getattr(kernels.load(), fn)(*args, out)
    if err != 0:
        raise RuntimeError(f"{fn} failed: cudaError {err}")
    return dict(zip(("registers", "spill_bytes", "smem_bytes", "blocks_per_sm"), out))


def suffix_occupancy(cap: int, dcap: int) -> dict:
    """The ``render_suffix`` instance for these pools on the current card:
    registers and local (spill) bytes a thread, dynamic shared memory a
    block, blocks resident per SM."""
    return _occupancy("render_suffix_occupancy", cap, dcap)


def frame_occupancy(x: FrameInputs) -> dict:
    """The same for the ``render_frame`` instance that ``x`` launches."""
    return _occupancy("render_frame_occupancy", x.bg_mode, x.gtab.shape[1],
                      x.ent_f.shape[1], x.dec_f.shape[1])


def synthetic_slots(n: int, cap: int, n_rows: int, seed: int = 0,
                    edges: bool = False):
    """Made-up (ent_f, ent_i) CPU tensors covering what maze states do not
    reach: fallback slots, alpha < 1, tall sprites (h2 > 24), rects over
    the frame edges, flipped and transposed-variant rows, tiling along
    either axis, dead and foreign-z slots.  With ``edges``, also the cases
    at the boundaries of the kernels' per-axis tables and row masks
    (``_edge_slots``).  Built with numpy from ``seed``; the kernel check
    feeds them to the kernel and its plain version."""
    rng = np.random.RandomState(seed)
    shape = (n, cap)
    ent_f = np.zeros(shape + (EF_N,), np.float32)
    ent_f[..., EF_X0] = rng.uniform(-24, 72, shape)
    ent_f[..., EF_Y0] = rng.uniform(-24, 72, shape)
    ent_f[..., EF_W2] = rng.choice([0.7, 4.0, 9.0, 17.5, 30.0, 61.0], shape)
    ent_f[..., EF_H2] = rng.choice([0.7, 4.0, 9.0, 25.0, 40.0, 70.0], shape)
    ent_f[..., EF_ALPHA] = np.where(
        rng.rand(*shape) < 0.5, 1.0, rng.uniform(0, 1, shape)
    )
    ent_f[..., EF_R:EF_B + 1] = rng.randint(0, 256, shape + (3,))
    ent_i = np.zeros(shape + (EI_N,), np.int32)
    ent_i[..., EI_ROW] = rng.randint(0, n_rows, shape)
    ent_i[..., EI_LIVE] = rng.rand(*shape) < 0.85
    ent_i[..., EI_FB] = rng.rand(*shape) < 0.2
    ent_i[..., EI_PFLIP] = rng.rand(*shape) < 0.4
    ent_i[..., EI_QFLIP] = rng.rand(*shape) < 0.4
    ent_i[..., EI_Z] = rng.choice([-1, 0, 1, 1], shape)
    ent_i[..., EI_NTH] = rng.randint(1, 5, shape)
    ent_i[..., EI_NTV] = rng.randint(1, 5, shape)
    mode = rng.randint(0, 3, shape)  # 0: stretch, 1: tile x, 2: tile y
    ent_i[..., EI_TILEH] = mode == 1
    ent_i[..., EI_TILEV] = mode == 2
    if edges:
        _edge_slots(rng, ent_f, ent_i)
    ent_f, ent_i = torch.as_tensor(ent_f), torch.as_tensor(ent_i)
    if edges:
        edge_envs_paint(ent_i)
    return ent_f, ent_i


# slots that stay live among dead ones in every fourth env (env % 4 == 1)
# of the edge cases: the ends of the row masks' 32-slot words
EDGE_LIVE = (31, 32, 63, 64, 95, 96, 111)


def _edge_slots(rng, ent_f, ent_i):
    """Overwrite about 8 slots in 9 (numpy arrays, in place) with cases at
    the boundaries of the kernels' plan: rect edges on pixel centres (u ==
    0 at the first pixel, u the float just below 1 at the last), extents at
    prep's 1e-6 clamp (a line one pixel wide on a centre, or none), origins
    of -0.0, rects off the frame along one axis only, rects over the whole
    frame, tiled slots whose u * ntiles lands on integers; and in every
    fourth env only the slots ``EDGE_LIVE`` live."""
    n, cap = ent_i.shape[:2]
    shape = (n, cap)
    f32 = np.float32
    below1 = np.nextafter(f32(1), f32(0))
    # spans k whose extent nextafter(k) puts pixel centre origin + k at
    # u = the float just below 1
    spans = np.array([k for k in range(1, 64) if f32(k) / np.nextafter(
        f32(k), f32(np.inf)) == below1], f32)
    centre = rng.randint(-8, 72, shape + (2,)).astype(f32) + f32(0.5)
    kind = rng.randint(0, 9, shape)
    for ax, (o, e, nt, tile) in enumerate(((EF_X0, EF_W2, EI_NTH, EI_TILEH),
                                           (EF_Y0, EF_H2, EI_NTV, EI_TILEV))):
        other = 1 - ax
        k = rng.choice(spans, shape)

        def put(m, origin, extent):
            ent_f[..., o] = np.where(m, origin, ent_f[..., o])
            ent_f[..., e] = np.where(m, extent, ent_f[..., e])

        # 1: edges on pixel centres, the far one just below u = 1
        put(kind == 1, centre[..., ax], np.nextafter(k, f32(np.inf)))
        # 2 (x), 8 (y): the 1e-6 clamp, on a centre or between two
        put(kind == (2, 8)[ax],
            centre[..., ax] + np.where(rng.rand(*shape) < 0.5, 0, 0.25), f32(1e-6))
        # 3: an origin of -0.0
        put(kind == 3, f32(-0.0), ent_f[..., e])
        # 4, 5: off the frame along this axis only, or along the other
        off = np.where(rng.rand(*shape) < 0.5, rng.uniform(-200, -80, shape),
                       rng.uniform(64.5, 200, shape)).astype(f32)
        put(kind == 4 + ax, off, rng.uniform(4, 60, shape).astype(f32))
        put(kind == 4 + other, rng.uniform(-10, 50, shape).astype(f32),
            rng.uniform(4, 40, shape).astype(f32))
        # 6: over the whole frame
        put(kind == 6, -rng.uniform(0, 6, shape).astype(f32),
            rng.uniform(70, 90, shape).astype(f32))
        # 7: tiled with u * ntiles on integers at pixel centres
        tiles = rng.choice([2, 4, 8], shape)
        put(kind == 7, centre[..., ax], (f32(4) * tiles).astype(f32))
        ent_i[..., nt] = np.where(kind == 7, tiles, ent_i[..., nt])
        ent_i[..., tile] = np.where(kind == 7, 1, ent_i[..., tile])
    boundary = np.zeros(shape, bool)
    boundary[:, [s for s in EDGE_LIVE if s < cap]] = True
    ent_i[..., EI_LIVE] = np.where(edge_envs(n)[:, None], boundary, ent_i[..., EI_LIVE])


def edge_envs(n: int) -> np.ndarray:
    """The envs of ``n`` in which the edge cases keep only ``EDGE_LIVE``
    live: every fourth one."""
    return np.arange(n) % 4 == 1


def edge_envs_paint(ent_i):
    """Keep the edge cases' ``EDGE_LIVE`` slots painting, also after a
    caller has redrawn the z levels: z >= 0 there (a tensor, in place).
    The callers with live counts give those envs full counts."""
    cap = ent_i.shape[1]
    fix = torch.as_tensor(edge_envs(ent_i.shape[0]))[:, None] & (ent_i[..., EI_Z] < 0)
    fix[:, [s for s in range(cap) if s not in EDGE_LIVE]] = False
    ent_i[..., EI_Z][fix] = 1


def synthetic_suffix_inputs(n: int, cap: int, dcap: int, n_rows: int,
                            dz_levels=(0,), seed: int = 0, edges: bool = False):
    """Made-up static-path inputs (CPU tensors) with a decor pool: (base,
    ent_f, ent_i, decor).  A random uint8 base frame; the entity pool's
    slots as ``synthetic_slots`` makes them, at z = 0 and 1 (and dead or
    foreign-z ones); a full decor pool at ``dz_levels`` (its canvases), a
    quarter of the envs with live counts below capacity in either pool
    (the slots past them must not paint).  ``edges``: both pools as
    ``synthetic_slots(edges=True)`` makes them.  Built with numpy from
    ``seed``."""
    rng = np.random.RandomState(seed)
    base = torch.as_tensor(rng.randint(0, 256, (n, RES, RES, 3)).astype(np.uint8))
    ent_f, ent_i = synthetic_slots(n, cap, n_rows, seed=seed, edges=edges)
    dec_f, dec_i = synthetic_slots(n, dcap, n_rows, seed=seed + 1, edges=edges)
    nzd = len(dz_levels)
    dec_i[..., EI_Z] = torch.as_tensor(rng.choice([-1, 0, 0, nzd], (n, dcap)))

    def counts(c):
        return np.where(rng.rand(n) < 0.25, rng.randint(0, c + 1, n), c)

    live = np.stack([counts(cap), counts(dcap)], 1).astype(np.int32)
    if edges:
        edge_envs_paint(ent_i)
        edge_envs_paint(dec_i)
        live[edge_envs(n)] = (cap, dcap)
    decor = SuffixDecor(
        dec_f=dec_f, dec_i=dec_i, counts=torch.as_tensor(live),
        nzd=nzd, z_slots=(0, 1),
        dz_slots=tuple(dz_levels.index(z) if z in dz_levels else -1 for z in (0, 1)),
    )
    return base, ent_f, ent_i, decor


def synthetic_wall_inputs(n: int, plan, wall_row: int, seed: int = 0):
    """Made-up static-path inputs at the caps of ``plan``'s game (CPU
    tensors): ``synthetic_suffix_inputs(edges=True)``, then, among the
    entity slots, what dodgeball's states put on the kernels: about a
    third become lava walls, long rectangles tiled along their long axis
    (``EI_TILEH`` with ``w2 / h2`` tiles, or ``EI_TILEV`` with ``h2 / w2``)
    on ``wall_row``, some over the frame's edges; another third sample the
    rows of the plan's rotation banks, the rectangle grown as prep grows a
    banked sprite's.  Returns (base, ent_f, ent_i, decor); built with numpy
    from ``seed``."""
    game = plan.game
    base, ent_f, ent_i, decor = synthetic_suffix_inputs(
        n, game.ENT_CAP, game.DECOR_CAP, 2 * plan.n1e, seed=seed, edges=True)
    rng = np.random.RandomState(seed)
    shape = tuple(ent_i.shape[:2])
    kind = rng.randint(0, 3, shape)
    vert = rng.rand(*shape) < 0.5
    long_ = rng.uniform(4, 80, shape).astype(np.float32)
    short = rng.uniform(1.5, 6, shape).astype(np.float32)
    wall = torch.as_tensor(kind == 0)
    w2 = torch.as_tensor(np.where(vert, short, long_))
    h2 = torch.as_tensor(np.where(vert, long_, short))
    ent_f[..., EF_W2] = torch.where(wall, w2, ent_f[..., EF_W2])
    ent_f[..., EF_H2] = torch.where(wall, h2, ent_f[..., EF_H2])
    ent_f[..., EF_X0] = torch.where(wall, torch.as_tensor(
        rng.uniform(-30, 60, shape).astype(np.float32)), ent_f[..., EF_X0])
    ent_f[..., EF_Y0] = torch.where(wall, torch.as_tensor(
        rng.uniform(-30, 60, shape).astype(np.float32)), ent_f[..., EF_Y0])
    tiles_h = torch.clamp_min((w2 / h2).to(i32), 1)
    tiles_v = torch.clamp_min((h2 / w2).to(i32), 1)
    vt = torch.as_tensor(vert)
    for col, v in ((EI_ROW, wall_row), (EI_FB, 0), (EI_PFLIP, 0), (EI_QFLIP, 0),
                   (EI_TILEH, (~vt).to(i32)), (EI_TILEV, vt.to(i32)),
                   (EI_NTH, tiles_h), (EI_NTV, tiles_v)):
        ent_i[..., col] = torch.where(wall, torch.as_tensor(v, dtype=i32), ent_i[..., col])
    banks = np.arange(plan.ent_atlas.transparent_row + 1, plan.n1e)
    if banks.size:
        bank = torch.as_tensor(kind == 1)
        ent_i[..., EI_ROW] = torch.where(bank, torch.as_tensor(
            rng.choice(banks, shape).astype(np.int32)), ent_i[..., EI_ROW])
        for col in (EI_FB, EI_PFLIP, EI_QFLIP, EI_TILEH, EI_TILEV):
            ent_i[..., col] = torch.where(bank, 0, ent_i[..., col])
        grow = torch.where(bank, ROT_OVERHANG, 1.0).to(f32)
        for o, ext in ((EF_X0, EF_W2), (EF_Y0, EF_H2)):
            ent_f[..., o] = ent_f[..., o] - ent_f[..., ext] * (grow - 1.0) * 0.5
            ent_f[..., ext] = ent_f[..., ext] * grow
    edge_envs_paint(ent_i)
    return base, ent_f, ent_i, decor


def synthetic_frame_inputs(n: int, NC: int, cap: int, grid_atlas, bg_atlas,
                           ent_atlas, grid_opaque: int, seed: int = 0,
                           dcap: int = 0, bg_mode: int = BG_CROP,
                           edges: bool = False):
    """Made-up ``FrameInputs`` (CPU tensors, the given atlases) covering
    what real textured states do not reach: valid colored cells with an
    inset below 1, cells covered by a tile and uncovered, background rects
    that are offset or clipped, a window shifted off the frame, slots at
    z = -1, 0 and 1 (three canvases) over the grid, live counts below the
    capacity (slots past them must not paint), and with ``dcap`` a full
    decor pool with its canvas at z = 0, as every game with one has it
    (z indices past it clip to it), besides the slot modes of
    ``synthetic_slots``.  With ``bg_mode=BG_TILED``, tiled backgrounds:
    world rects up to six frames tall, starting above, inside or below the
    frame and partly off it sideways, with tile heights from 2 to 70 px
    that need not divide the rect.  With ``bg_mode=BG_SCROLL``, scroll
    offsets of the clocks 0..1000 and offsets that leave part of the frame
    or all of it off the 18 tiles.  ``edges``: both pools as
    ``synthetic_slots(edges=True)`` makes them.  Built with numpy from
    ``seed``."""
    rng = np.random.RandomState(seed)
    sf = np.zeros((n, SF_N), np.float32)
    vis = rng.choice([NC, NC + 0.5, NC * 1.3], n).astype(np.float32)
    sf[:, SF_VIS] = vis
    sf[:, SF_UNIT] = np.float32(RES) / vis
    sf[:, SF_XOFF] = rng.uniform(-8, 8, n)
    sf[:, SF_YOFF] = rng.uniform(-8, 8, n)
    sf[:, SF_MRX] = rng.uniform(-10, 10, n)
    sf[:, SF_MRY] = rng.uniform(-10, 10, n)
    sf[:, SF_MRW] = rng.uniform(30, 90, n)
    sf[:, SF_MRH] = rng.uniform(30, 90, n)
    sf[:, SF_BGRX] = rng.uniform(-60, 20, n)
    sf[:, SF_BGRW] = rng.uniform(40, 160, n)
    sf[:, SF_TOPY] = NC + rng.choice([0, 0, 1, -1], n)
    sf[:, SF_LOWX] = rng.choice([0, 0, 1, -1], n)
    si = np.zeros((n, SI_N), np.int32)
    si[:, SI_BGROW] = rng.randint(0, bg_atlas.shape[0] + 1, n)

    def counts(c):  # a quarter of the envs below capacity
        return np.where(rng.rand(n) < 0.25, rng.randint(0, c + 1, n), c)

    si[:, SI_ENT_COUNT] = counts(cap)
    si[:, SI_DEC_COUNT] = counts(dcap)
    n_rows = grid_atlas.shape[0]
    gtab = np.where(rng.rand(n, NC, NC) < 0.4, grid_opaque,
                    rng.randint(0, n_rows, (n, NC, NC))).astype(np.int32)
    cell5 = np.zeros((n, 5, NC, NC), np.float32)
    cell5[:, :3] = rng.randint(0, 256, (n, 3, NC, NC))
    cell5[:, 3] = rng.rand(n, NC, NC) < 0.7
    cell5[:, 4] = rng.choice([2.0, 1.0, 0.6, 0.3, 0.0], (n, NC, NC))
    ent_f, ent_i = synthetic_slots(n, cap, ent_atlas.shape[0], seed=seed, edges=edges)
    ent_i[..., EI_Z] = torch.as_tensor(rng.choice([-1, 0, 1, 2], (n, cap)))
    dec_f, dec_i = synthetic_slots(n, dcap, ent_atlas.shape[0], seed=seed + 1,
                                   edges=edges)
    dec_i[..., EI_Z] = torch.as_tensor(rng.choice([-1, 0, 0, 1], (n, dcap)))
    if edges:
        edge_envs_paint(ent_i)
        edge_envs_paint(dec_i)
        si[edge_envs(n), SI_ENT_COUNT:SI_DEC_COUNT + 1] = (cap, dcap)
    if bg_mode == BG_TILED:
        sf[:, SF_MRX] = rng.uniform(-40, 60, n)
        sf[:, SF_MRW] = rng.uniform(8, 120, n)
        sf[:, SF_MRH] = rng.uniform(20, 400, n)
        sf[:, SF_MRY] = rng.uniform(-360, 50, n)
        sf[:, SF_TILEH] = np.where(rng.rand(n) < 0.5, rng.uniform(2, 70, n),
                                   sf[:, SF_MRH] / rng.randint(1, 8, n))
    if bg_mode == BG_SCROLL:
        # the clocks' offsets, and offsets that put the frame's left edge
        # before the tiles, its right edge past their end, or all of it
        # past their end
        kind = rng.randint(0, 4, n)
        sf[:, SF_BGRX] = np.choose(kind, [
            -np.float32(0.8) * rng.randint(0, 1001, n), rng.uniform(0, 64, n),
            rng.uniform(-3456, -3392, n), rng.uniform(-4000, -3456, n),
        ]).astype(np.float32)
    return FrameInputs(
        sf=torch.as_tensor(sf), si=torch.as_tensor(si),
        gtab=torch.as_tensor(gtab), cell5=torch.as_tensor(cell5),
        ent_f=ent_f, ent_i=ent_i, dec_f=dec_f, dec_i=dec_i,
        grid_atlas=grid_atlas, bg_atlas=bg_atlas, ent_atlas=ent_atlas,
        z_slots=(0, 1, 2), nz=3,
        dz_slots=(-1, 0, -1) if dcap else (-1, -1, -1), nzd=1 if dcap else 0,
        grid_opaque=grid_opaque, bg_mode=bg_mode,
    )


def turned_states(s, seed: int = 0):
    """``s`` (states on any device) with every slot of both pools turned
    to made-up angles from -10^4 to 10^4 rad: a quarter turn k pi / 2, one
    within 2e-4 of it (either side of prep's 1e-4 threshold), a bucket edge
    (b + 1/2) 2 pi / 32 of the rotation banks, or any angle, a quarter of
    the slots each.  Built with numpy from ``seed``."""
    rng = np.random.RandomState(seed)
    for pool in ("ents", "decor"):
        e = getattr(s, pool)
        shape = tuple(e.rotation.shape)
        k = rng.randint(-6366, 6367, shape)
        angles = np.choose(rng.randint(0, 4, shape), [
            k * (np.pi / 2), k * (np.pi / 2) + rng.choice([-2e-4, -5e-5, 5e-5, 2e-4], shape),
            (rng.randint(-50000, 50000, shape) + 0.5) * (2 * np.pi / 32),
            rng.uniform(-1e4, 1e4, shape)]).astype(np.float32)
        s = s.replace(**{pool: e.replace(
            rotation=torch.as_tensor(angles, device=e.rotation.device))})
    return s


ORB_INSET = float(np.float32(0.3))  # chaser's orbs (games/chaser.ORB_DIM)


def synthetic_orb_inputs(n: int, NC: int, grid_atlas, bg_atlas, ent_atlas,
                         grid_opaque: int, seed: int = 0):
    """Made-up ``FrameInputs`` (CPU tensors) whose pixels fall on the edges
    of colored cells drawn at chaser's orb inset (0.3 of a cell): the
    static camera's view of ``NC`` cells, every cell valid and uncovered,
    nine in ten at the inset; each env's offsets put one pixel column's
    world x and one pixel row's world y a few ulps (-8 to 8) from a
    cell's ``0.5 - 0.15`` or ``0.5 + 0.15``, where a one-ulp difference
    in the pixel's coordinate decides whether it is drawn.  Built with
    numpy from ``seed``."""
    x = synthetic_frame_inputs(n, NC, 4, grid_atlas, bg_atlas, ent_atlas, grid_opaque,
                               seed=seed)
    rng = np.random.RandomState(seed + 1)
    f32_ = np.float32
    sf = x.sf.numpy().copy()
    vis = f32_(NC)
    unit = f32_(RES) / vis
    sf[:, SF_VIS], sf[:, SF_UNIT] = vis, unit
    sf[:, SF_TOPY], sf[:, SF_LOWX] = NC, 0
    half = f32_(ORB_INSET) / f32_(2)

    def offset(sign):
        # world = (pix + off) / unit at a pixel near cell k + 0.5 -+ half
        pix = f32_(rng.randint(0, RES)) + f32_(0.5)
        edge = f32_(rng.randint(0, NC)) + f32_(0.5) + f32_(rng.choice([-1, 1])) * half
        off = f32_(edge * unit - pix) * f32_(sign)
        ulps = rng.randint(-8, 9)
        for _ in range(abs(ulps)):
            off = np.nextafter(off, f32_(np.inf * ulps))
        return off

    sf[:, SF_XOFF] = [offset(1) for _ in range(n)]
    # world y = vis - (pix - off) / unit
    sf[:, SF_YOFF] = [offset(-1) for _ in range(n)]
    cell5 = np.zeros((n, 5, NC, NC), np.float32)
    cell5[:, :3] = rng.randint(0, 256, (n, 3, NC, NC))
    cell5[:, 3] = 1.0
    cell5[:, 4] = np.where(rng.rand(n, NC, NC) < 0.9, ORB_INSET, 2.0)
    gtab = np.full((n, NC, NC), grid_opaque, np.int32)
    return dataclasses.replace(x, sf=torch.as_tensor(sf), cell5=torch.as_tensor(cell5),
                               gtab=torch.as_tensor(gtab))


def orb_edge_pixels(x: FrameInputs, ulps: int = 8):
    """[N, 64, 64] bool: the pixels inside the cell window whose cell is
    drawn at an inset below 1 and whose ``|u - 0.5|`` or ``|v - 0.5|``
    lies within ``ulps`` ulps of half the inset (``grid_lookup``'s world
    coordinates)."""
    wxs, wys, inside, crow, ccol, _, _ = grid_lookup(x)
    nidx = torch.arange(x.sf.shape[0], device=x.sf.device)[:, None, None]
    inset = x.cell5[:, 4][nidx, crow, ccol]
    half = inset / 2
    du = torch.abs(wxs - torch.floor(wxs) - 0.5)[:, None, :] - half
    dv = torch.abs(wys - torch.floor(wys) - 0.5)[:, :, None] - half
    tol = ulps * float(np.spacing(np.float32(0.5)))
    near = (torch.abs(du) <= tol) | (torch.abs(dv) <= tol)
    return inside & (inset < 1) & near


def render_obs_batch(game, states, res: int = RES):
    """Batched uint8 [N, 64, 64, 3] frames: the CUDA kernel of the game's
    path for CUDA states, its plain torch version for CPU states."""
    if not supports(game, res):
        raise NotImplementedError(
            f"{game.name}: the frame kernels do not take this frame (a custom "
            f"background or cell colors, or its z levels)"
        )
    plan = get_plan(game, res)
    if plan.static:
        ent_f, ent_i, decor = prep_suffix(plan, states)
        base = states.frame
        atlas = plan.atlas(base.device)
        nz = len(plan.z_levels)
        if base.is_cuda:
            out = render_suffix(base.contiguous(), ent_f, ent_i, atlas, nz, decor)
        else:
            out = render_suffix_reference(base, ent_f, ent_i, atlas, nz, decor)
    else:
        x = prep_frame(plan, states)
        out = render_frame(x) if x.sf.is_cuda else render_frame_reference(x)
    return post(game, states, out.to(i32), res).to(u8)
