"""Game base classes: per-env state + the shared grid-game step.

The counterpart of ``procgen_tpu.core.game``.  A game is a plain Python
class holding static configuration; all dynamic data lives in
``BasicState``, a dataclass of batch-first tensors with the JAX package's
field names, dtypes and per-env shapes behind a leading ``[N]`` axis.  The
port carries the subset of ``BasicAbstractGame`` that the ported games
reach: grid-step and sub-stepped continuous movement (the agent with the
entity-scan hook, the other smart movers batched over a compacted slot
window), the vectorised collision dispatch with the agent's grid probe,
the entity-pair hook and the grid hook of games whose grid handler acts
on other movers (``dispatch_grid_vec`` over every slot's ``probe_cells``),
erase of both pools, the spawn test over both
pools (``spawn_blocked``), the grid reads and writes, the reset path's
RNG helpers, the rejection placement of ``reposition``
(``place_by_rejection``, batched over the envs) and of
``reposition_agent``, the sprite aspect-ratio
fit and ``game_reset_base``, and the sequential reverse collision scan
(``dispatch_sequential``) of the games whose handlers do not commute.
The sequential entity scan and push chains are queued in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from . import assetgen, rng
from .constants import (
    INVALID_OBJ, MAXVTHETA, MIXRATEROT, PLAYER, POS_EPS, SPACE, WALL_OBJ,
)
from .entities import Entities, default_fields
from .options import GameOptions

f32 = torch.float32
i32 = torch.int32


def _where(cond, a, b):
    """torch.where with ``cond`` [N] broadcast over trailing dims."""
    if torch.is_tensor(a) and a.dim() > cond.dim():
        cond = cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim()))
    return torch.where(cond, a, b)


def per_env(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-env ``[N]`` tensor shaped to broadcast against ``like``
    (``[N, ...]``)."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def _rec_where(cond, a: dict, b: dict) -> dict:
    """Field-wise select of two movement records; fields the branch left
    alone (the same tensor) are not selected."""
    return {k: a[k] if a[k] is b[k] else torch.where(cond, a[k], b[k]) for k in a}


def tree_map(fn, *trees):
    """Leaf-wise map over (nested) dataclasses of tensors; None stays None."""
    t0 = trees[0]
    if t0 is None:
        return None
    if torch.is_tensor(t0):
        return fn(*trees)
    if dataclasses.is_dataclass(t0):
        return dataclasses.replace(t0, **{
            f.name: tree_map(fn, *[getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(t0)
        })
    raise TypeError(f"unsupported tree node {type(t0)}")


def tree_where(cond, a, b):
    """Per-env select of two state trees (``cond`` is [N]); the
    counterpart of ``_tree_select`` in procgen_tpu/parallel/vec.py."""
    return tree_map(lambda x, y: x if x is y else _where(cond, x, y), a, b)


@dataclasses.dataclass
class BasicState:
    """All dynamic per-env state (Game + BasicAbstractGame fields)."""

    # Game (game.h:64-134)
    level_seed_rand_gen: rng.MTState
    rand_gen: rng.MTState
    current_level_seed: torch.Tensor
    prev_level_seed: torch.Tensor
    episodes_remaining: torch.Tensor
    episode_done: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    level_complete: torch.Tensor
    action: torch.Tensor
    cur_time: torch.Tensor
    last_reward_timer: torch.Tensor
    last_reward: torch.Tensor
    total_reward: torch.Tensor
    reset_count: torch.Tensor
    # BasicAbstractGame (basic-abstract-game.h:121-168)
    grid: torch.Tensor  # int32 [N, Hmax, Wmax]
    main_width: torch.Tensor
    main_height: torch.Tensor
    ents: Entities
    bg_pct_x: torch.Tensor
    background_index: torch.Tensor
    last_move_action: torch.Tensor
    move_action: torch.Tensor
    special_action: torch.Tensor
    mixrate: torch.Tensor
    maxspeed: torch.Tensor
    max_jump: torch.Tensor
    action_vx: torch.Tensor
    action_vy: torch.Tensor
    action_vrot: torch.Tensor
    step_rand_int: torch.Tensor
    visibility: torch.Tensor
    step_draws: torch.Tensor = None
    decor: Optional[Entities] = None
    # cached static render prefix, uint8 [N, 64, 64, 3] (static_prefix games)
    frame: Any = None
    bg_canvas: Any = None
    game: Any = None

    def replace(self, **kw) -> "BasicState":
        return dataclasses.replace(self, **kw)

    @property
    def num(self) -> int:
        return self.reward.shape[0]


class BasicAbstractGame:
    """Static game definition + batched transition functions."""

    name = "abstract"

    WORLD_DIM_MAX: tuple[int, int] = (64, 64)  # (Wmax, Hmax)
    ENT_CAP: int = 64
    MAX_STEP_DRAWS: int = 64
    MAX_SUB_STEPS: int = 8
    GRID_COLLISION_RANGE: int = 2
    ENTITY_SCAN: bool = False
    ENTITY_SCAN_NONAGENT: bool = False
    PUSH_DEPTH: int = 5
    ONLY_AGENT_SMART: bool = True
    SMART_VECTORIZABLE: bool = True
    DECOR_CAP: int = 0
    DECOR_TYPES: frozenset = frozenset(range(54, 60))
    ENT_Z_LEVELS: tuple = (0, 1)
    DECOR_Z_LEVELS: tuple = (0,)
    PALLAS_BG: str = "standard"
    STATIC_RENDER_PREFIX: bool = False
    ANY_COLLIDES_WITH_ENTITIES: bool = False
    DISPATCH_VECTORIZED: bool = False
    GRID_HANDLER_AGENT_ONLY: bool = True
    # bound on the non-agent smart movers stepped at once (None: all
    # slots); movers past it freeze for the step, as in the JAX package
    MAX_SMART: Optional[int] = None

    @property
    def static_prefix(self) -> bool:
        """Cache the bg+grid+cell render prefix per level (see
        procgen_tpu/core/game.py:196-207)."""
        return (
            self.STATIC_RENDER_PREFIX
            and not self.center_agent
            and self.PALLAS_BG != "scroll"
            and all(z >= 0 for z in self.ENT_Z_LEVELS)
            and all(z >= 0 for z in self.DECOR_Z_LEVELS)
        )

    def __init__(self, options: GameOptions):
        self.options = options
        # Game ctor (game.cpp:46-60)
        self.timeout = 1000
        self.default_action = 0
        self.fixed_asset_seed = 0
        self.grid_step = False
        self.level_seed_low = 0
        self.level_seed_high = 1
        self.game_type = 0
        # BasicAbstractGame ctor (basic-abstract-game.cpp:22-46)
        self.char_dim = 5.0
        self.visibility = 16.0
        self.min_visibility = 0.0
        self.mixrate = 0.5
        self.maxspeed = 0.5
        self.max_jump = 0.5
        self.default_action = 4
        self.bg_tile_ratio = 0.0
        self.out_of_bounds_object = INVALID_OBJ
        self.has_useful_vel_info = True
        self.random_agent_start = True
        self.center_agent = options.center_agent

    # ------------------------------------------------------------------
    # capacities / assets
    # ------------------------------------------------------------------

    @property
    def uses_procgen_background(self) -> bool:
        return self.options.use_generated_assets or not self.background_names()

    def num_backgrounds(self) -> int:
        if self.uses_procgen_background:
            return 1
        return len(self.background_names())

    def background_names(self) -> list[str]:
        return []

    RESERVED_ASSETS = {
        54: ["misc_assets/explosion1.png"],
        55: ["misc_assets/explosion2.png"],
        56: ["misc_assets/explosion3.png"],
        57: ["misc_assets/explosion4.png"],
        58: ["misc_assets/explosion5.png"],
        59: ["misc_assets/iconCircle_white.png"],
    }

    def asset_for_type(self, type_: int) -> list[str]:
        return []

    def use_block_asset(self, type_: int) -> bool:
        """Whether a generated sprite of ``type_`` is a rect resource (a
        block) rather than a shape resource (basic-abstract-game.cpp:
        101-110)."""
        return False

    def asset_names(self, type_: int) -> list[str]:
        if self.options.use_generated_assets:
            return []
        names = self.asset_for_type(type_)
        if not names:
            names = self.RESERVED_ASSETS.get(type_, [])
        return names

    def num_themes(self, type_: int) -> int:
        """asset_num_themes[type] (cpp:109-119)."""
        names = self.asset_names(type_)
        return len(names) if names else 1

    def choose_random_theme(self, s: BasicState, slot: int, type_: int):
        """cpp:1047-1050: one randn draw on the reset stream."""
        s, th = self.randn(s, self.num_themes(type_))
        return s.replace(ents=s.ents.set_fields(slot, image_theme=th))

    # ------------------------------------------------------------------
    # virtual hooks (override per game)
    # ------------------------------------------------------------------

    def choose_world_dim(self, s: BasicState) -> BasicState:
        return s

    def game_reset(self, s: BasicState) -> BasicState:
        raise NotImplementedError

    def game_step(self, s: BasicState, d: rng.Draws):
        raise NotImplementedError

    def game_init_state(self, n: int, device) -> Any:
        return None

    def is_blocked(self, s, src_type, target_type, is_horizontal):
        """basic-abstract-game.cpp:494-501."""
        blocked = target_type == WALL_OBJ
        blocked |= target_type == self.out_of_bounds_object
        return blocked

    def will_reflect(self, src_type, target_type):
        return torch.zeros_like(target_type, dtype=torch.bool)

    def handle_agent_collision_vec(self, s, d, hit):
        return s, d

    def handle_agent_collision(self, s, d, i: int):
        """The agent against slot ``i`` (a Python int) in the sequential
        scan; the result is kept only in the envs where they collide."""
        return s, d

    def dispatch_entity_pairs(self, s, d):
        return s, d

    def set_action_xy(self, s: BasicState, move_action) -> BasicState:
        """basic-abstract-game.cpp:667-671."""
        return s.replace(
            action_vx=(torch.div(move_action, 3, rounding_mode="floor") - 1).to(f32),
            action_vy=(torch.remainder(move_action, 3) - 1).to(f32),
            action_vrot=torch.zeros_like(s.action_vrot),
        )

    def get_agent_acceleration_scale(self, s: BasicState):
        return torch.ones_like(s.mixrate)

    def update_agent_velocity(self, s: BasicState) -> BasicState:
        """basic-abstract-game.cpp:678-688; every product and sum rounds
        on its own, as in the JAX package."""
        v_scale = self.get_agent_acceleration_scale(s)
        e = s.ents
        vx = (1 - s.mixrate) * e.vx[:, 0]
        vy = (1 - s.mixrate) * e.vy[:, 0]
        vx = vx + s.mixrate * s.maxspeed * s.action_vx * v_scale
        vy = vy + s.mixrate * s.maxspeed * s.action_vy * v_scale
        s = s.replace(ents=e.set_fields(0, vx=vx, vy=vy))
        return self.decay_agent_velocity(s)

    def decay_agent_velocity(self, s: BasicState) -> BasicState:
        """``agent->vx *= .9`` (cpp:690-693): the literal is a double, so
        the product is taken in double and rounded once to f32."""
        e = s.ents
        return s.replace(ents=e.set_fields(
            0, vx=f64_mul(e.vx[:, 0], 0.9), vy=f64_mul(e.vy[:, 0], 0.9)))

    def choose_center(self, s: BasicState):
        return s.ents.x[:, 0], s.ents.y[:, 0]

    def camera(self, s: BasicState):
        """(cx, cy, visibility) per env under ``center_agent``
        (prepare_for_drawing, cpp:828-847)."""
        cx, cy = self.choose_center(s)
        return cx, cy, s.visibility

    def should_draw_entity_mask(self, s: BasicState):
        return torch.ones_like(s.ents.will_erase, dtype=torch.bool)

    def image_for_type(self, s, type_):
        """cpp:446-448."""
        return torch.abs(type_)

    def theme_for_grid_obj(self, s, type_):
        return torch.zeros_like(type_, dtype=i32)

    def entity_tile_ratio(self, s, e):
        return torch.zeros_like(e.x)

    def adjust_image_rect(self, img, x0, y0, w2, h2):
        return x0, y0, w2, h2

    def render_overlay(self, s, obs, sx, sy, res, unit, vis):
        return obs

    def paint_background(self, s, res, sx, sy, bg_atlas):
        return None

    def grid_cell_colors(self, s, gtype, u, v):
        """(valid, r, g, b) per cell type (draw_grid_obj)."""
        theme = self.theme_for_grid_obj(s, gtype)
        img = self.image_for_type(s, gtype)
        valid = (gtype != INVALID_OBJ) & (img >= 0) & (img != SPACE)
        r, g, b = self.color_for_type(img, theme)
        return valid, r, g, b

    def grid_cell_inset(self, s, gtype):
        """Centered sub-rect size of a colored grid cell (cell fraction):
        the frame kernel paints a pixel iff |u-0.5| < inset/2 and
        |v-0.5| < inset/2.  2.0 covers the whole cell."""
        return torch.full(gtype.shape, 2.0, dtype=f32, device=gtype.device)

    def color_for_type(self, type_, theme):
        from ..render.assets import monochrome_color

        theme = self.mask_theme(type_, theme)
        return monochrome_color(torch.remainder(type_.to(i32), 64), theme)

    def should_preserve_type_themes(self, type_):
        return torch.zeros_like(type_, dtype=torch.bool)

    def mask_theme(self, type_, theme):
        """mask_theme_if_necessary (cpp:458-462)."""
        if not self.options.restrict_themes:
            return theme
        return torch.where(
            self.should_preserve_type_themes(type_), theme,
            torch.zeros_like(theme),
        )

    # ------------------------------------------------------------------
    # grid helpers
    # ------------------------------------------------------------------

    def _grid_read(self, s: BasicState, x, y):
        """grid[n, y, x] for in-range (clamped) coordinates ``[N, ...]``."""
        wmax, hmax = self.WORLD_DIM_MAX
        xc = x.clamp(0, wmax - 1).long()
        yc = y.clamp(0, hmax - 1).long()
        flat = s.grid.reshape(s.grid.shape[0], -1)
        idx = (yc * wmax + xc).reshape(flat.shape[0], -1)
        return flat.gather(1, idx).reshape(x.shape)

    def get_obj(self, s: BasicState, x, y):
        """Bounds-checked grid read (basic-abstract-game.cpp:180-185);
        ``x``/``y`` are int ``[N]`` or ``[N, ...]`` tensors."""
        x = x.to(i32)
        y = y.to(i32)
        mw = s.main_width.reshape((-1,) + (1,) * (x.dim() - 1))
        mh = s.main_height.reshape((-1,) + (1,) * (x.dim() - 1))
        inb = (x >= 0) & (x < mw) & (y >= 0) & (y < mh)
        val = self._grid_read(s, x, y)
        return torch.where(inb, val, self.out_of_bounds_object)

    def set_obj_where(self, s: BasicState, x, y, v, cond) -> BasicState:
        """grid[n, y, x] = v where ``cond`` (``x``/``y`` in bounds there)."""
        wmax, hmax = self.WORLD_DIM_MAX
        flat = s.grid.reshape(s.grid.shape[0], -1)
        idx = (y.clamp(0, hmax - 1) * wmax + x.clamp(0, wmax - 1)).long()
        old = flat.gather(1, idx[:, None])[:, 0]
        new = torch.where(cond, torch.as_tensor(v, dtype=i32, device=old.device), old)
        flat = flat.clone()
        flat.scatter_(1, idx[:, None], new[:, None])
        return s.replace(grid=flat.reshape(s.grid.shape))

    def set_obj(self, s: BasicState, x, y, v) -> BasicState:
        """grid[n, y, x] = v for ``[N]`` coordinates; a write outside
        ``WORLD_DIM_MAX`` is dropped, as a JAX scatter drops it (callers
        pass in-range cells)."""
        wmax, hmax = self.WORLD_DIM_MAX
        inb = (x >= 0) & (x < wmax) & (y >= 0) & (y < hmax)
        return self.set_obj_where(s, x, y, v, inb)

    def get_obj_from_floats(self, s: BasicState, fx, fy):
        """basic-abstract-game.cpp:167-174, for ``[N, ...]`` floats."""
        neg = (fx < 0) | (fy < 0)
        val = self.get_obj(s, torch.floor(fx).to(i32), torch.floor(fy).to(i32))
        return torch.where(neg, self.out_of_bounds_object, val)

    def get_obj_grid22(self, s: BasicState, fxs, fys):
        """get_obj_from_floats at the 2x2 outer grid of float coords
        ``fxs``/``fys`` ([N, ..., 2] each); returns [N, ..., 2(y), 2(x)]."""
        x = torch.floor(fxs).to(i32)
        y = torch.floor(fys).to(i32)
        inb_x = (x >= 0) & (x < per_env(s.main_width, x))
        inb_y = (y >= 0) & (y < per_env(s.main_height, y))
        quad = x.shape[:-1] + (2, 2)
        vals = self._grid_read(
            s, x[..., None, :].expand(quad), y[..., :, None].expand(quad)
        )
        ok = inb_y[..., :, None] & inb_x[..., None, :]
        neg = (fys < 0)[..., :, None] | (fxs < 0)[..., None, :]
        return torch.where(ok & ~neg, vals, self.out_of_bounds_object)

    def fill_elem(self, s: BasicState, x, y, dx, dy, elem) -> BasicState:
        """Rectangle fill (basic-abstract-game.cpp:125-131); x/y/dx/dy are
        ints or [N] tensors."""
        dev = s.grid.device
        gx = torch.arange(self.WORLD_DIM_MAX[0], device=dev)[None, None, :]
        gy = torch.arange(self.WORLD_DIM_MAX[1], device=dev)[None, :, None]

        def col(v):
            v = torch.as_tensor(v, device=dev)
            return v.reshape(-1, 1, 1) if v.dim() else v

        x, y, dx, dy = col(x), col(y), col(dx), col(dy)
        m = (gx >= x) & (gx < x + dx) & (gy >= y) & (gy < y + dy)
        m = m & (gx < col(s.main_width)) & (gy < col(s.main_height))
        return s.replace(grid=torch.where(m, elem, s.grid).to(i32))

    def is_out_of_bounds_mask(self, s):
        """cpp:1077-1093, vectorised over slots ([N, cap])."""
        e = s.ents
        w = s.main_width.to(f32)[:, None]
        h = s.main_height.to(f32)[:, None]
        return (e.x + e.rx < 0) | (e.y + e.ry < 0) | (e.x - e.rx > w) | (
            e.y - e.ry > h
        )

    def has_agent_collision_mask(self, s):
        """has_agent_collision for every slot (cpp:1135-1140)."""
        e = s.ents
        tx = e.rx[:, :1] + e.rx + e.collision_margin
        ty = e.ry[:, :1] + e.ry + e.collision_margin
        m = (torch.abs(e.x[:, :1] - e.x) < tx) & (torch.abs(e.y[:, :1] - e.y) < ty)
        return m & e.active & (e.type != PLAYER)

    # ------------------------------------------------------------------
    # movement (cpp:278-380, 602-665), agent record of [N] tensors
    # ------------------------------------------------------------------

    @staticmethod
    def _rec_of(e: Entities, slot: int) -> dict:
        return {
            "x": e.x[:, slot], "y": e.y[:, slot], "vx": e.vx[:, slot],
            "vy": e.vy[:, slot], "rx": e.rx[:, slot], "ry": e.ry[:, slot],
            "type": e.type[:, slot], "will_erase": e.will_erase[:, slot],
        }

    def _sub_step_rec(self, s, rec, vx, vy, depth: int, is_agent: bool):
        """One axis-aligned micro-move (cpp:278-380) of a record whose
        fields are ``[N]`` (the agent) or ``[N, M]`` (a window of movers).
        Returns (s, rec, blocked); only the agent's entity scan may change
        ``s``."""
        skip = rec["will_erase"]
        nx = rec["x"] + vx
        ny = rec["y"] + vy
        margin = 0.98
        horiz = vx != 0

        pxs = torch.stack([nx - rec["rx"] * margin, nx + rec["rx"] * margin], -1)
        pys = torch.stack([ny - rec["ry"] * margin, ny + rec["ry"] * margin], -1)
        t22 = self.get_obj_grid22(s, pxs, pys)  # [..., 2(y), 2(x)]
        src = rec["type"][..., None, None]
        block = self.is_blocked(s, src, t22, horiz).flatten(-2).any(-1)
        reflect = self.will_reflect(src, t22).flatten(-2).any(-1)

        rx_, ry_ = rec["rx"], rec["ry"]
        dx_ref = torch.where(
            vx < 0, torch.ceil(nx - rx_) - (nx - rx_),
            torch.floor(nx + rx_) - (nx + rx_),
        )
        dy_ref = torch.where(
            vy < 0, torch.ceil(ny - ry_) - (ny - ry_),
            torch.floor(ny + ry_) - (ny + ry_),
        )
        nx_ref = nx + 2 * dx_ref
        ny_ref = ny + 2 * dy_ref
        if self.grid_step:
            nx_blk, ny_blk = rec["x"], rec["y"]
        else:
            nx_blk = torch.where(
                vx > 0, torch.floor(nx + rx_) - rx_, torch.ceil(nx - rx_) + rx_
            )
            ny_blk = torch.where(
                vy > 0, torch.floor(ny + ry_) - ry_, torch.ceil(ny - ry_) + ry_
            )
        vert = ~horiz
        new = dict(rec)
        new["x"] = torch.where(
            reflect, torch.where(horiz, nx_ref, nx),
            torch.where(block & horiz, nx_blk, nx),
        )
        new["y"] = torch.where(
            reflect, torch.where(horiz, ny, ny_ref),
            torch.where(block & vert, ny_blk, ny),
        )
        new["vx"] = torch.where(reflect & horiz, -rec["vx"], rec["vx"])
        new["vy"] = torch.where(reflect & vert, -rec["vy"], rec["vy"])
        rec = _rec_where(skip, rec, new)

        block2 = torch.zeros_like(block)
        if (is_agent and self.ENTITY_SCAN) or (
            not is_agent and self.ENTITY_SCAN_NONAGENT
        ):
            s, rec, block2 = self._entity_scan(s, rec, vx, vy, depth)
        blocked = torch.where(skip, False, block | block2)
        return s, rec, blocked

    def _entity_scan(self, s, rec, vx, vy, depth: int):
        """The reverse scan over entities with push chains (cpp:343-379);
        games override it with vectorised equivalents (coinrun's crate
        landing).  Returns (s, rec, blocked)."""
        raise NotImplementedError(
            f"{self.name}: the sequential entity scan is not ported (ROADMAP)"
        )

    def _basic_step_rec(self, s, rec, is_agent: bool):
        """basic_step_object on a record (cpp:602-665); returns (s, rec).
        The JAX while_loop runs to the batch max of num_sub with per-env
        masking; a static loop of MAX_SUB_STEPS masked iterations is the
        same.  Only the agent's entity scan carries state."""
        if self.grid_step:
            num_sub = torch.ones_like(rec["type"])
            max_sub = 1
        else:
            speed = torch.sqrt(rec["vx"] * rec["vx"] + rec["vy"] * rec["vy"])
            num_sub = torch.clamp_min((4 * speed).to(i32), 4)
            max_sub = self.MAX_SUB_STEPS
        num_sub_f = num_sub.to(f32)
        pct = torch.ones_like(num_sub_f) / num_sub_f

        like = rec["x"]
        cmp = torch.abs(rec["vx"]) - torch.abs(rec["vy"])
        step_x_first = torch.where(
            cmp == 0, per_env(torch.remainder(s.step_rand_int, 2) == 0, like),
            cmp > 0,
        )
        is_player_t = rec["type"] == PLAYER
        step_x_first = torch.where(
            is_player_t & per_env(s.action_vx != 0, like), True, step_x_first
        )
        step_x_first = torch.where(
            is_player_t & per_env(s.action_vy != 0, like), False, step_x_first
        )
        carry_state = is_agent and self.ENTITY_SCAN

        def axis(s_, rec, horiz_axis):
            v = torch.where(horiz_axis, rec["vx"] * pct, rec["vy"] * pct)
            zero = torch.zeros_like(v)
            vx_ = torch.where(horiz_axis, v, zero)
            vy_ = torch.where(horiz_axis, zero, v)
            return self._sub_step_rec(s_, rec, vx_, vy_, 0, is_agent)

        vx_pct = torch.zeros_like(pct)
        vy_pct = torch.zeros_like(pct)
        broken = torch.zeros_like(step_x_first)
        for si in range(max_sub):
            live = (si < num_sub) & ~broken
            s2, r1, b1 = axis(s, rec, step_x_first)
            s2, rec2, b2 = axis(s2, r1, ~step_x_first)
            bx = torch.where(step_x_first, b1, b2)
            by = torch.where(step_x_first, b2, b1)
            if carry_state:
                s = tree_where(live, s2, s)
            rec = _rec_where(live, rec2, rec)
            vx_pct = vx_pct + torch.where(live & ~bx, 1.0, 0.0)
            vy_pct = vy_pct + torch.where(live & ~by, 1.0, 0.0)
            broken = broken | (live & bx & by)
        rec = dict(rec)
        rec["vx"] = rec["vx"] * (vx_pct / num_sub_f)
        rec["vy"] = rec["vy"] * (vy_pct / num_sub_f)
        return s, rec

    def basic_step_object_agent(self, s: BasicState) -> BasicState:
        """Move the agent (slot 0)."""
        rec0 = self._rec_of(s.ents, 0)
        s, rec = self._basic_step_rec(s, rec0, is_agent=True)
        rec = _rec_where(rec0["will_erase"], rec0, rec)
        return s.replace(
            ents=s.ents.set_fields(
                0, x=rec["x"], y=rec["y"], vx=rec["vx"], vy=rec["vy"]
            )
        )

    def spawn_blocked(self, s: BasicState, x, y, rx, ry):
        """has_any_collision of a spawn candidate (cpp:1123-1133) over both
        pools, [N] bool: the C++ keeps explosions and trails in the same
        entity vector and they do not avoid collisions, so they block a
        spawn too.  ``x``, ``y``, ``rx``, ``ry``: floats or [N] tensors."""
        def col(v):
            return v[:, None] if torch.is_tensor(v) and v.dim() else v

        def pool_hit(e):
            return ((torch.abs(col(x) - e.x) < col(rx) + e.rx)
                    & (torch.abs(col(y) - e.y) < col(ry) + e.ry)
                    & e.active & ~e.avoids_collisions).any(dim=1)

        hit = pool_hit(s.ents)
        if self.DECOR_CAP:
            hit = hit | pool_hit(s.decor)
        return hit

    def step_smart_entities_vectorized(self, s: BasicState) -> BasicState:
        """Move every non-agent smart entity at once (SMART_VECTORIZABLE:
        they read only the grid and their own record, so the reference's
        reverse order commutes).  With ``MAX_SMART`` the movers are first
        compacted, in slot order, into a window of that many; movers past
        it keep their fields for the step, as in the JAX package."""
        e = s.ents
        n, cap = e.x.shape
        slots = torch.arange(cap, device=e.x.device)
        do = e.active & e.smart_step & (slots != 0) & ~e.will_erase
        fields = ("x", "y", "vx", "vy", "rx", "ry", "type")
        m = self.MAX_SMART
        if m is not None and m < cap:
            pos = torch.cumsum(do.to(i32), dim=1) - 1
            ok = do & (pos < m)
            # src[n, j]: the slot of the env's j-th mover (slot 0 where it
            # has fewer; those records move and are dropped)
            src = torch.zeros((n, m + 1), dtype=torch.long, device=e.x.device)
            src.scatter_(1, torch.where(ok, pos, m).long(),
                         slots.expand(n, cap).contiguous())
            src = src[:, :m]
            rec = {k: getattr(e, k).gather(1, src) for k in fields}
            rec["will_erase"] = torch.zeros_like(rec["x"], dtype=torch.bool)
            _, recs = self._basic_step_rec(s, rec, is_agent=False)
            back = pos.clamp(0, m - 1).long()
            upd = {k: torch.where(ok, recs[k].gather(1, back), getattr(e, k))
                   for k in ("x", "y", "vx", "vy")}
        else:
            rec = {k: getattr(e, k) for k in fields + ("will_erase",)}
            _, recs = self._basic_step_rec(s, rec, is_agent=False)
            upd = {k: torch.where(do, recs[k], getattr(e, k))
                   for k in ("x", "y", "vx", "vy")}
        return s.replace(ents=e.replace(**upd))

    # ------------------------------------------------------------------
    # per-step pipeline (cpp:695-755)
    # ------------------------------------------------------------------

    def step_entities(self, s: BasicState):
        """cpp:1095-1107: non-agent Entity::step, then the agent moves and
        steps last."""
        if not self.ONLY_AGENT_SMART:
            if not self.SMART_VECTORIZABLE:
                raise NotImplementedError(
                    f"{self.name}: sequential smart movers are not ported"
                )
            s = self.step_smart_entities_vectorized(s)
        slots = torch.arange(s.ents.cap, device=s.grid.device)
        nonagent = (slots != 0)[None, :]
        s = s.replace(ents=s.ents.step_masked(s.ents.active & nonagent))
        if self.DECOR_CAP:
            s = s.replace(decor=s.decor.step_all())
        s = self.basic_step_object_agent(s)
        s = s.replace(ents=s.ents.step_masked(s.ents.active & ~nonagent))
        return s

    def dispatch_collisions(self, s: BasicState, d):
        """cpp:728-750: the phased vectorised dispatch of games whose
        handlers commute (DISPATCH_VECTORIZED), else the exact reverse
        scan (``dispatch_sequential``)."""
        if not self.DISPATCH_VECTORIZED:
            return self.dispatch_sequential(s, d)
        hit = self.has_agent_collision_mask(s)
        s, d = self.handle_agent_collision_vec(s, d, hit)
        if self.ANY_COLLIDES_WITH_ENTITIES:
            s, d = self.dispatch_entity_pairs(s, d)
        if type(self).handle_grid_collision is not BasicAbstractGame.handle_grid_collision:
            if self.GRID_HANDLER_AGENT_ONLY:
                s2, d2 = self.check_grid_collisions(s, d, 0)
                do = s.ents.smart_step[:, 0] & (s.ents.count > 0)
                s = tree_where(do, s2, s)
                d = tree_where(do, d2, d)
            else:
                # the game's vectorised form of the reverse per-slot grid
                # dispatch of every smart mover
                s, d = self.dispatch_grid_vec(s, d)
        return s, d

    def dispatch_grid_vec(self, s: BasicState, d):
        """The grid dispatch of ``DISPATCH_VECTORIZED`` games whose grid
        handler acts on smart movers other than the agent: each such game
        overrides it with a vectorised form of the reverse per-slot scan."""
        raise NotImplementedError(
            f"{self.name}: DISPATCH_VECTORIZED without GRID_HANDLER_AGENT_ONLY "
            "requires a dispatch_grid_vec override"
        )

    def probe_cells(self, s: BasicState):
        """The cells ``check_grid_collisions`` probes, for every slot at
        once (cpp:145-165): (ix, iy, in_range, gtype), each [N, cap,
        GRID_COLLISION_RANGE**2] in (dx, dy) probe order."""
        e = s.ents
        min_x = torch.trunc(e.x - (e.rx + POS_EPS)).to(i32)
        max_x = torch.trunc(e.x + (e.rx + POS_EPS)).to(i32)
        min_y = torch.trunc(e.y - (e.ry + POS_EPS)).to(i32)
        max_y = torch.trunc(e.y + (e.ry + POS_EPS)).to(i32)
        r = self.GRID_COLLISION_RANGE
        offs = torch.arange(r, dtype=i32, device=e.x.device)
        ox = offs.repeat_interleave(r)  # (dx, dy) order: dy fastest
        oy = offs.repeat(r)
        ix = min_x[..., None] + ox
        iy = min_y[..., None] + oy
        inr = (ix <= max_x[..., None]) & (iy <= max_y[..., None])
        gtype = self.get_obj_from_floats(s, ix.to(f32), iy.to(f32))
        return ix, iy, inr, gtype

    def dispatch_sequential(self, s: BasicState, d):
        """The reverse scan of cpp:728-750 for games whose handlers do not
        commute (the JAX package's ``lax.scan`` over the slots,
        procgen_tpu/core/game.py:1140-1199): from the highest live slot down,
        the agent against slot ``i``, then slot ``i``'s grid probe if it
        is smart.  Each handler sees what the slots above it left (the
        agent's size, ``will_erase``).  The loop runs from the batch's
        largest live count (one host read), each iteration batched over
        the envs; slot reads are plain gathers where the JAX package
        selects by a one-hot product.  The entity-pair branch is reached
        only by DISPATCH_VECTORIZED games and is not ported."""
        if self.ANY_COLLIDES_WITH_ENTITIES:
            raise NotImplementedError(
                f"{self.name}: the sequential entity-pair scan is not ported"
            )
        # the base grid handler changes nothing: no probe without a game's
        grid = (type(self).handle_grid_collision
                is not BasicAbstractGame.handle_grid_collision)
        for i in range(int(s.ents.count.max()) - 1, -1, -1):
            hit = self.has_agent_collision_mask(s)[:, i]  # live slots only
            s2, d2 = self.handle_agent_collision(s, d, i)
            s = tree_where(hit, s2, s)
            d = tree_where(hit, d2, d)
            if grid:
                do = (i < s.ents.count) & s.ents.smart_step[:, i]
                s2, d2 = self.check_grid_collisions(s, d, i)
                s = tree_where(do, s2, s)
                d = tree_where(do, d2, d)
        return s, d

    def handle_grid_collision(self, s, d, slot, type_, ix, iy):
        return s, d

    def check_grid_collisions(self, s: BasicState, d, slot: int):
        """cpp:145-165: probe the cells under one slot's box, in (dx, dy)
        order, and dispatch each hit per env."""
        e = s.ents
        ax, ay = e.x[:, slot], e.y[:, slot]
        arx, ary = e.rx[:, slot], e.ry[:, slot]
        min_x = torch.trunc(ax - (arx + POS_EPS)).to(i32)
        max_x = torch.trunc(ax + (arx + POS_EPS)).to(i32)
        min_y = torch.trunc(ay - (ary + POS_EPS)).to(i32)
        max_y = torch.trunc(ay + (ary + POS_EPS)).to(i32)
        r = self.GRID_COLLISION_RANGE
        for dx in range(r):
            for dy in range(r):
                x = min_x + dx
                y = min_y + dy
                in_range = (x <= max_x) & (y <= max_y)
                gtype = self.get_obj_from_floats(s, x.to(f32), y.to(f32))
                hit = in_range & (gtype != SPACE)
                s2, d2 = self.handle_grid_collision(s, d, slot, gtype, x, y)
                s = tree_where(hit, s2, s)
                d = tree_where(hit, d2, d)
        return s, d

    def erase_if_needed(self, s: BasicState) -> BasicState:
        """cpp:757-765, both pools."""
        e = s.ents
        oob = self.is_out_of_bounds_mask(s)
        keep = ~(e.will_erase | (e.auto_erase & oob))
        s = s.replace(ents=e.compact(keep))
        if self.DECOR_CAP:
            d = s.decor
            w = s.main_width.to(f32)[:, None]
            h = s.main_height.to(f32)[:, None]
            oob_d = ((d.x + d.rx < 0) | (d.y + d.ry < 0)
                     | (d.x - d.rx > w) | (d.y - d.ry > h))
            s = s.replace(decor=d.compact(~(d.will_erase | (d.auto_erase & oob_d))))
        return s

    def add_decor(self, s: BasicState, fields: dict, do=None) -> BasicState:
        """Push a decorative entity (trail, explosion) per env."""
        assert self.DECOR_CAP > 0, f"{self.name} has no decor pool"
        return s.replace(decor=s.decor.push(fields, do=do))

    def game_step_base(self, s: BasicState, d: rng.Draws):
        """BasicAbstractGame::game_step head + movement + dispatch
        (cpp:695-755)."""
        d, sri = d.randint(0, 1000000)
        s = s.replace(step_rand_int=sri)

        move_action = torch.remainder(s.action, 9)
        special = torch.where(s.action >= 9, s.action - 8, 0).to(i32)
        move_action = torch.where(s.action >= 9, 4, move_action).to(i32)
        last_move = torch.where(move_action != 4, move_action, s.last_move_action)
        zf = torch.zeros_like(s.action_vx)
        s = s.replace(
            move_action=move_action,
            special_action=special,
            last_move_action=last_move,
            action_vrot=zf,
            action_vx=zf,
            action_vy=zf,
        )
        s = self.set_action_xy(s, move_action)

        if self.grid_step:
            s = s.replace(
                ents=s.ents.set_fields(0, vx=s.action_vx, vy=s.action_vy)
            )
        else:
            s = self.update_agent_velocity(s)
            vrot = (MIXRATEROT * s.ents.vrot[:, 0]
                    + MIXRATEROT * MAXVTHETA * s.action_vrot)
            s = s.replace(ents=s.ents.set_fields(0, vrot=vrot))

        s = self.step_entities(s)
        s, d = self.dispatch_collisions(s, d)
        s = self.erase_if_needed(s)
        s = s.replace(done=s.done | self.is_out_of_bounds_mask(s)[:, 0])
        return s, d

    # ------------------------------------------------------------------
    # reset-path helpers (checked RNG)
    # ------------------------------------------------------------------

    def rand01(self, s: BasicState):
        g, v = rng.rand01(s.rand_gen)
        return s.replace(rand_gen=g), v

    def randn(self, s: BasicState, n):
        g, v = rng.randn(s.rand_gen, n)
        return s.replace(rand_gen=g), v

    def randint(self, s: BasicState, lo, hi):
        g, v = rng.randint(s.rand_gen, lo, hi)
        return s.replace(rand_gen=g), v

    def randbool(self, s: BasicState):
        g, v = rng.randbool(s.rand_gen)
        return s.replace(rand_gen=g), v

    def randrange(self, s: BasicState, lo, hi):
        g, v = rng.randrange(s.rand_gen, lo, hi)
        return s.replace(rand_gen=g), v

    def aspect_ratios(self, type_: int, device) -> torch.Tensor:
        """Per-theme aspect ratio table of a (static) type, f32."""
        from ..render.assets import aspect_for

        names = self.asset_names(type_)
        return torch.tensor([aspect_for(n) for n in names] or [1.0],
                            dtype=f32, device=device)

    def aspect_of(self, type_: int, theme: torch.Tensor) -> torch.Tensor:
        """The aspect ratio of ``type_``'s theme ``theme`` (an int
        tensor), f32; a theme past the table (a generated asset has one)
        reads its last entry, as the JAX package's gather clamps."""
        table = self.aspect_ratios(type_, theme.device)
        return table[theme.long().clamp(0, table.shape[0] - 1)]

    def fit_aspect_ratio(self, s: BasicState, mask, ar) -> BasicState:
        """fit_aspect_ratio (cpp:1034-1045) of every slot where ``mask``
        ([N, cap]), ``ar`` being each slot's aspect ratio ([N, cap] f32):
        the longer side keeps its radius."""
        e = s.ents
        ry = torch.where(ar > 1, e.rx / ar, e.ry)
        rx = torch.where(ar > 1, e.rx, e.ry * ar)
        return s.replace(ents=e.replace(rx=torch.where(mask, rx, e.rx),
                                        ry=torch.where(mask, ry, e.ry)))

    def game_reset_base(self, s: BasicState) -> BasicState:
        """BasicAbstractGame::game_reset (cpp:767-806)."""
        n = s.num
        dev = s.grid.device
        s = self.choose_world_dim(s)
        s, bg_pct = self.rand01(s)

        def full(v, dtype):
            return torch.full((n,), v, dtype=dtype, device=dev)

        s = s.replace(
            bg_pct_x=bg_pct,
            grid=torch.zeros_like(s.grid),
            mixrate=full(self.mixrate, f32),
            maxspeed=full(self.maxspeed, f32),
            max_jump=full(self.max_jump, f32),
            visibility=full(self.visibility, f32),
        )
        s, bgi = self.randn(s, self.num_backgrounds())
        s = s.replace(background_index=bgi)
        if self.uses_procgen_background:
            # AssetGen paints the background anew at every reset from the
            # level rand_gen (cpp:776-782): its exact draws and its canvas
            s = assetgen.consume_background_draws(self, s)

        ents = Entities.zeros(n, self.ENT_CAP, dev)
        if self.DECOR_CAP:
            s = s.replace(decor=Entities.zeros(n, self.DECOR_CAP, dev))
        a_r = 0.4
        if self.random_agent_start:
            s, r1 = self.rand01(s)
            s, r2 = self.rand01(s)
            a_r32 = torch.tensor(a_r, dtype=f32, device=dev)
            ax = r1 * (s.main_width.to(f32) - 2 * a_r32) + a_r32
            ay = r2 * (s.main_height.to(f32) - 2 * a_r32) + a_r32
        else:
            ax = a_r
            ay = a_r
        agent = default_fields(ax, ay, 0.0, 0.0, a_r, a_r, PLAYER)
        agent["smart_step"] = True
        agent["render_z"] = 1
        ents = ents.push(agent)
        s = s.replace(ents=ents)
        s = self.fill_elem(s, 0, 0, s.main_width, s.main_height, SPACE)
        return s

    # ------------------------------------------------------------------
    # misc queries used by games
    # ------------------------------------------------------------------

    def get_agent_index(self, s):
        """int(agent.y) * main_width + int(agent.x) (cpp:176-178), [N]."""
        e = s.ents
        return e.y[:, 0].to(i32) * s.main_width + e.x[:, 0].to(i32)

    def cells_with_type_mask(self, s, type_):
        """[N, Hmax, Wmax] mask of in-bounds cells with the given type."""
        dev = s.grid.device
        gx = torch.arange(self.WORLD_DIM_MAX[0], device=dev)[None, None, :]
        gy = torch.arange(self.WORLD_DIM_MAX[1], device=dev)[None, :, None]
        inb = (gx < s.main_width[:, None, None]) & (gy < s.main_height[:, None, None])
        return inb & (s.grid == type_)


def f64_mul(a: torch.Tensor, c: float) -> torch.Tensor:
    """``f32(double(a) * c)``: a C++ float expression with a double
    literal, which C++ evaluates in double and rounds once to float (one
    IEEE double product, then one conversion, the same bits on the CPU and
    the card)."""
    return (a.double() * c).float()


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 when none (what
    ``jnp.argmax`` returns on a bool array)."""
    n = mask.shape[-1]
    ar = torch.arange(n, device=mask.device).expand_as(mask)
    idx = torch.where(mask, ar, n).amin(dim=-1)
    return torch.where(idx == n, 0, idx)


def _rand_pos_draws(d: rng.Draws, cond, r: float, lo: float, hi: float):
    """rand_pos (cpp:1109-1117, the JAX package's ``_rand_pos_raw``) on a
    peeked window: uniform in [lo + r, hi - r], drawn where ``cond``, where
    the span exceeds 2r; else the span's centre, with no draw.  The
    constants take the JAX package's forms: ``hi - lo - 2r`` in Python's
    double, then ``* v + f32(r + lo)``, the one f32 constant XLA folds the
    chain ``+ r + lo`` into."""
    need = torch.as_tensor((hi - lo) > 2 * r, device=cond.device)
    d, v = d.rand01_if(cond & need)
    offset = float(np.float32(r) + np.float32(lo))
    return d, torch.where(need, (hi - lo - 2 * r) * v + offset, (hi + lo) / 2)


def place_by_rejection(d: rng.Draws, blockers, rx, ry, x, y, w, h, do,
                       max_tries: int = 100):
    """``reposition``'s rejection placement (cpp:550-568) on a peeked
    window ``d``, batched over the envs: every env where ``do`` draws a
    position, then redraws while it overlaps a blocker, at most
    ``max_tries`` times.  ``blockers``: (x, y, rx, ry, mask) tensors of
    [N, M] boxes, the mask marking the ones that count.  Each round draws
    only for the envs still colliding and costs one host read, of whether
    any is; an env that has placed draws nothing more.  The window must
    hold ``2 * (max_tries + 1)`` words past the cursor.  Returns (d, px,
    py), [N] each."""

    def try_place(d, m):
        d, px = _rand_pos_draws(d, m, rx, x, x + w)
        d, py = _rand_pos_draws(d, m, ry, y, y + h)
        return d, px, py

    def collides(px, py):
        hit = torch.zeros_like(do)
        for bx, by, brx, bry, m in blockers:
            ov = ((torch.abs(px[:, None] - bx) < rx + brx)
                  & (torch.abs(py[:, None] - by) < ry + bry) & m)
            hit = hit | ov.any(dim=1)
        return hit

    d, px, py = try_place(d, do)
    for _ in range(max_tries):
        redo = do & collides(px, py)
        if not bool(redo.any()):
            break
        d, px2, py2 = try_place(d, redo)
        px = torch.where(redo, px2, px)
        py = torch.where(redo, py2, py)
    return d, px, py


def reposition_agent(d: rng.Draws, e: Entities, w: float, h: float,
                     max_tries: int = 100):
    """reposition_agent (plunder.cpp:540-548, dodgeball.cpp:341) on a
    peeked window ``d``: draw the agent's centre in the ``w`` x ``h``
    world, and redraw while it overlaps a live slot that is not the
    player, at most ``max_tries`` times; masked rounds over the envs, one
    host read a round.  Unlike ``reposition`` it always draws both
    coordinates and sums the half-widths as ``agent.rx + e.rx +
    e.collision_margin``.  The window must hold ``2 * (max_tries + 1)``
    words past the cursor.  Returns (d, x, y), [N] each."""
    rx0, ry0 = e.rx[:, 0], e.ry[:, 0]
    span_x = w - 2 * rx0
    span_y = h - 2 * ry0
    reach_x = rx0[:, None] + e.rx + e.collision_margin
    reach_y = ry0[:, None] + e.ry + e.collision_margin
    blocks = e.active & (e.type != PLAYER)

    def try_place(d, m):
        d, r1 = d.rand01_if(m)
        d, r2 = d.rand01_if(m)
        return d, r1 * span_x + rx0, r2 * span_y + ry0

    d, ax, ay = try_place(d, torch.ones_like(blocks[:, 0]))
    for _ in range(max_tries):
        redo = ((torch.abs(ax[:, None] - e.x) < reach_x)
                & (torch.abs(ay[:, None] - e.y) < reach_y) & blocks).any(dim=1)
        if not bool(redo.any()):
            break
        d, ax2, ay2 = try_place(d, redo)
        ax = torch.where(redo, ax2, ax)
        ay = torch.where(redo, ay2, ay)
    return d, ax, ay
