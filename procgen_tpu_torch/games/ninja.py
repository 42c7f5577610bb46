"""Ninja: a platformer with charged jumps and throwing stars that blow up
bombs; reach the mushroom (+10).  Reference: procgen/src/games/ninja.cpp;
JAX counterpart procgen_tpu/games/ninja.py.

The first game whose grid-collision handler acts on movers other than the
agent: a throwing star sticks on a wall and booms a BOMB cell.  The C++
runs the handler slot by slot from the highest down, so a star that booms
a cell leaves SPACE for the stars below it and the agent (slot 0, last)
reads the grid after every boom; ``dispatch_grid_vec`` reproduces that in
one pass over every slot's probe cells (the highest booming slot of a cell
wins, explosions pushed in the scan's order by one ``push_many``).  A star
that a wall blocks stops dead: the C++ zeroes both its velocities inside
``is_blocked`` (ninja.cpp:139-152), so its later sub-steps and steps do
not move it, and it stays until it expires unless its probe reaches the
wall cell (a star stopped flush against a wall probes only its own cell).
The JAX package keeps the unblocked axis moving (ROADMAP, "Faults of the
JAX package"); the C++ state bytes (tests/data/refstate/ninja_bridge.json)
hold stars stopped against walls.  The reset draws the level's sections from
one peeked window, every draw masked by whether the env has it.  Every
function works on the whole batch: per-env values are ``[N]`` tensors,
per-slot values ``[N, cap]``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..core import libm, rng
from ..core.constants import EASY_MODE, EXPLOSION, PLAYER, SPACE
from ..core.entities import default_fields
from ..core.game import BasicAbstractGame, BasicState, per_env
from .registry import register

i32 = torch.int32
f32 = torch.float32

GOAL_REWARD = 10.0

GOAL = 1
BOMB = 6
THROWING_STAR = 7
PLAYER_JUMP = 9
PLAYER_RIGHT1 = 12
PLAYER_RIGHT2 = 13
FIRE = 14
WALL_MID = 20
NUM_WALL_THEMES = 3

GRAVITY = 0.2
AIR_CONTROL = 0.15
PI = math.pi
MAX_SECTIONS = 5  # num_sections <= 2 * 3 - 1
MAX_EDGES = 2
BAR_COLOR = (66, 245, 135)  # the jump-charge bar (ninja.cpp:166-175)


@functools.lru_cache(maxsize=None)
def _star_velocities(device: str):
    """(vx, vy) of a thrown star, f32 [8] each, by ``_star_heading``'s
    index: ``cos``/``sin`` of the headings 0, PI/4, PI/2, -PI/4 and their
    reflections PI - theta, each an f32 expression of the f32 PI
    (ninja.cpp:369-395), through ``core/libm.py``."""
    f = np.float32
    base = [f(0.0), f(PI / 4), f(PI / 2), f(-PI / 4)]
    theta = torch.tensor(base + [f(f(PI) - t) for t in base], dtype=f32)
    return libm.cosf(theta).to(device), libm.sinf(theta).to(device)


def _star_heading(special, reflected):
    """The index into ``_star_velocities`` of the special action's
    heading (2: PI/4, 3: PI/2, 4: -PI/4, else 0), reflected."""
    k = torch.where((special >= 2) & (special <= 4), special - 1, 0)
    return (k + torch.where(reflected, 4, 0)).long()


@dataclasses.dataclass
class NinjaState:
    has_support: torch.Tensor  # bool [N]
    facing_right: torch.Tensor  # bool [N]
    last_fire_time: torch.Tensor  # int32 [N]
    wall_theme: torch.Tensor  # int32 [N]
    jump_charge: torch.Tensor  # f32 [N]

    def replace(self, **kw) -> "NinjaState":
        return dataclasses.replace(self, **kw)


@register("ninja")
class Ninja(BasicAbstractGame):
    name = "ninja"
    WORLD_DIM_MAX = (64, 64)
    ENT_CAP = 16  # agent + goal + <= 5 stars + <= 5 explosions
    MAX_STEP_DRAWS = 4
    MAX_SUB_STEPS = 10  # a star's speed 1 takes 4; the agent's vy reaches -2
    ONLY_AGENT_SMART = False  # the stars
    SMART_VECTORIZABLE = True
    MAX_SMART = 8
    GRID_HANDLER_AGENT_ONLY = False  # stars boom bombs through the grid handler
    DISPATCH_VECTORIZED = True

    def __init__(self, options):
        super().__init__(options)
        self.out_of_bounds_object = WALL_MID
        easy = options.distribution_mode == EASY_MODE
        self.max_jump = 1.25 if easy else 1.5
        self.jump_charge_inc = 1.0 if easy else 0.25
        self.visibility = 10.0 if easy else 16.0

    def background_names(self):
        from ..render.assets import PLATFORM_BACKGROUNDS

        return PLATFORM_BACKGROUNDS

    def asset_for_type(self, type_):
        # ninja.cpp:45-75
        if type_ == WALL_MID:
            return ["misc_assets/tile_bricksGrey.png",
                    "misc_assets/tile_bricksGrown.png",
                    "misc_assets/tile_bricksRed.png"]
        if type_ == GOAL:
            return [f"platformer/shroom{i}.png" for i in range(1, 7)]
        if type_ == PLAYER:
            return ["platformer/zombie_idle.png"]
        if type_ == PLAYER_JUMP:
            return ["platformer/zombie_jump.png"]
        if type_ == PLAYER_RIGHT1:
            return ["platformer/zombie_walk1.png"]
        if type_ == PLAYER_RIGHT2:
            return ["platformer/zombie_walk2.png"]
        if type_ in (BOMB, FIRE):
            return ["misc_assets/bomb.png"]
        if type_ == THROWING_STAR:
            return ["misc_assets/saw.png"]
        return []

    def use_block_asset(self, type_):
        return type_ == WALL_MID

    def game_init_state(self, n, device):
        def full(v, dtype):
            return torch.full((n,), v, dtype=dtype, device=device)

        return NinjaState(
            has_support=full(False, torch.bool), facing_right=full(True, torch.bool),
            last_fire_time=full(0, i32), wall_theme=full(0, i32),
            jump_charge=full(0.0, f32),
        )

    def choose_world_dim(self, s):
        return s.replace(main_width=torch.full_like(s.main_width, 64),
                         main_height=torch.full_like(s.main_height, 64))

    # -- physics --------------------------------------------------------------

    def is_blocked(self, s, src_type, target_type, is_horizontal):
        b = super().is_blocked(s, src_type, target_type, is_horizontal)
        mover = (src_type == PLAYER) | (src_type == THROWING_STAR)
        return b | ((target_type == WALL_MID) & mover)

    def _sub_step_rec(self, s, rec, vx, vy, depth: int, is_agent: bool):
        """The base micro-move; a star it blocks then stops, both
        velocities zero (the C++ ``is_blocked`` zeroes them, after the
        move has snapped the star to the wall with the velocity it had)."""
        s, rec, blocked = super()._sub_step_rec(s, rec, vx, vy, depth, is_agent)
        stop = blocked & (rec["type"] == THROWING_STAR)
        rec = dict(rec, vx=torch.where(stop, 0.0, rec["vx"]),
                   vy=torch.where(stop, 0.0, rec["vy"]))
        return s, rec, blocked

    def _can_support(self, t):
        return (t == WALL_MID) | (t == self.out_of_bounds_object)

    def set_action_xy(self, s, move_action):
        # ninja.cpp:326-357: a jump charges while the agent stands
        avx = (torch.div(move_action, 3, rounding_mode="floor") - 1).to(f32)
        avy = torch.clamp_min((torch.remainder(move_action, 3) - 1).to(f32), 0.0)
        g = s.game
        facing = torch.where(avx > 0, True, torch.where(avx < 0, False, g.facing_right))
        e = s.ents
        x0, y0, rx0, ry0 = e.x[:, 0], e.y[:, 0], e.rx[:, 0], e.ry[:, 0]
        b1 = self.get_obj_from_floats(s, x0 - (rx0 - 0.01), y0 - (ry0 + 0.01))
        b2 = self.get_obj_from_floats(s, x0 + (rx0 - 0.01), y0 - (ry0 + 0.01))
        has_support = self._can_support(b1) | self._can_support(b2)
        charging = has_support & (avy == 1)
        charge = torch.where(
            charging, torch.clamp_max(g.jump_charge + self.jump_charge_inc, 1.0),
            g.jump_charge)
        charge = torch.where(has_support, charge, 0.0)
        return s.replace(
            action_vx=avx,
            action_vy=torch.where(charging, 1.0, 0.0),
            action_vrot=torch.zeros_like(s.action_vrot),
            game=g.replace(facing_right=facing, has_support=has_support,
                           jump_charge=charge),
        )

    def update_agent_velocity(self, s):
        # ninja.cpp:110-124: the jump leaves on release; every product and
        # sum rounds on its own
        g = s.game
        e = s.ents
        mixrate_x = torch.where(g.has_support, s.mixrate, s.mixrate * AIR_CONTROL)
        vx = (1 - mixrate_x) * e.vx[:, 0] + mixrate_x * s.maxspeed * s.action_vx
        release = (s.action_vy < 1) & (g.jump_charge > 0)
        vy = torch.where(release, g.jump_charge * s.max_jump, e.vy[:, 0])
        vy = torch.where(~g.has_support & (vy > -2), vy - GRAVITY, vy)
        return s.replace(
            ents=e.set_fields(0, vx=vx, vy=vy),
            game=g.replace(jump_charge=torch.where(release, 0.0, g.jump_charge)),
        )

    # -- collisions -----------------------------------------------------------

    def handle_agent_collision_vec(self, s, d, hit):
        # ninja.cpp:77-86: an explosion kills, the mushroom ends the level
        e = s.ents
        expl = (hit & (e.type == EXPLOSION)).any(dim=1)
        goal = (hit & (e.type == GOAL)).any(dim=1)
        return s.replace(
            done=s.done | expl | goal,
            reward=s.reward + torch.where(goal, GOAL_REWARD, 0.0),
            level_complete=s.level_complete | goal,
        ), d

    def handle_grid_collision(self, s, d, slot, type_, ix, iy):
        """One slot's grid hit (ninja.cpp:88-106), the handler of the
        sequential scan ``dispatch_grid_vec`` stands for: the agent dies
        on FIRE or a BOMB, a star booms a BOMB and sticks on a wall."""
        e = s.ents
        is_player = e.type[:, slot] == PLAYER
        is_star = e.type[:, slot] == THROWING_STAR
        die = is_player & ((type_ == FIRE) | (type_ == BOMB))
        boom = is_star & (type_ == BOMB)
        stick = is_star & (type_ == WALL_MID)
        s = s.replace(done=s.done | die,
                      ents=e.set_fields_where(slot, boom | stick, will_erase=True))
        s = self.set_obj_where(s, ix, iy, SPACE, boom)
        f = default_fields(ix.to(f32) + 0.5, iy.to(f32) + 0.5, 0.0, 0.0, 0.5, 0.5,
                           EXPLOSION)
        return s.replace(ents=s.ents.push(f, do=boom)), d

    def dispatch_grid_vec(self, s, d):
        """The reverse per-slot grid dispatch (ninja.cpp:88-106) in one
        pass, as the JAX package's ``dispatch_grid_vec`` (:204-280):

        * the stars go from the highest slot down, and a boomed BOMB cell
          is SPACE for the stars below: a cell booms once, by its highest
          booming slot, and only that star is erased for it;
        * a star sticks (is erased) on any probed wall;
        * the explosions are pushed in the scan's order, slot descending
          and probe cells in (dx, dy) order within a slot, by one
          ``push_many`` (pushes past ``ENT_CAP`` dropped);
        * the agent, slot 0, goes last: it dies on FIRE or a BOMB of the
          grid after the booms.

        The JAX package clears the boomed cells by a one-hot product (its
        TPU form); here a scatter writes the same cells."""
        e = s.ents
        n, cap = e.x.shape
        dev = e.x.device
        slots = torch.arange(cap, device=dev)
        live = e.active & e.smart_step
        is_star = live & (e.type == THROWING_STAR)

        ix, iy, inr, gtype = self.probe_cells(s)  # [N, cap, 4]
        k = ix.shape[2]
        hit = inr & (gtype != SPACE)
        boom_c = is_star[..., None] & hit & (gtype == BOMB)
        stick_c = is_star[..., None] & hit & (gtype == WALL_MID)

        # a candidate (slot, cell) wins unless a higher slot booms its cell
        fi = ix.reshape(n, -1)
        fy = iy.reshape(n, -1)
        fb = boom_c.reshape(n, -1)
        fslot = slots.repeat_interleave(k)
        higher = fslot[None, :] > fslot[:, None]  # [cap*k, cap*k]: column above row
        same = (fi[:, :, None] == fi[:, None, :]) & (fy[:, :, None] == fy[:, None, :])
        beaten = (same & fb[:, None, :] & higher).any(dim=2)
        win = fb & ~beaten  # [N, cap*k]

        # the boomed cells (BOMB cells, so inside the grid) become SPACE;
        # the other candidates write to a spare column
        wmax, hmax = self.WORLD_DIM_MAX
        flat = torch.cat([s.grid.reshape(n, -1),
                          torch.zeros((n, 1), dtype=i32, device=dev)], dim=1)
        idx = torch.where(win, fy * wmax + fi, wmax * hmax).long()
        flat.scatter_(1, idx, SPACE)
        erase = stick_c.any(dim=2) | win.reshape(n, cap, k).any(dim=2)
        s = s.replace(grid=flat[:, :-1].reshape(s.grid.shape),
                      ents=e.replace(will_erase=e.will_erase | erase))

        # the explosions, slot descending and cells ascending within a slot
        order = torch.as_tensor(
            np.arange(cap * k)[::-1].reshape(cap, k)[:, ::-1].reshape(-1).copy(),
            device=dev)
        f = default_fields(fi[:, order].to(f32) + 0.5, fy[:, order].to(f32) + 0.5,
                           0.0, 0.0, 0.5, 0.5, EXPLOSION)
        s = s.replace(ents=s.ents.push_many(f, win[:, order]))

        # the agent last: its probed cells read against the boomed ones
        cleared0 = (win[:, None, :] & (fi[:, None, :] == ix[:, 0, :, None])
                    & (fy[:, None, :] == iy[:, 0, :, None])).any(dim=2)
        t0 = torch.where(cleared0, SPACE, gtype[:, 0])
        die = live[:, 0] & (e.type[:, 0] == PLAYER) & (
            inr[:, 0] & ((t0 == FIRE) | (t0 == BOMB))).any(dim=1)
        return s.replace(done=s.done | die), d

    # -- rendering ------------------------------------------------------------

    def theme_for_grid_obj(self, s, type_):
        return torch.where(type_ == WALL_MID, per_env(s.game.wall_theme, type_), 0).to(i32)

    def image_for_type(self, s, type_):
        # ninja.cpp:154-164
        e = s.ents
        sup = s.game.has_support
        standing = (torch.abs(e.vx[:, 0]) < 0.01) & (s.action_vx == 0) & sup
        half = torch.div(s.cur_time, 5, rounding_mode="floor")
        walk = torch.where((torch.remainder(half, 2) == 0) | ~sup,
                           PLAYER_RIGHT1, PLAYER_RIGHT2)
        player_img = torch.where(standing, PLAYER, walk)
        out = torch.where(type_ == PLAYER, per_env(player_img, type_), torch.abs(type_))
        return out.to(i32)

    def render_overlay(self, s, obs, sx, sy, res, unit, vis):
        """The jump-charge bar (ninja.cpp:166-175), a rectangle in frame
        coordinates, over the int32 [N, res, res, 3] frames; ``sx``/``sy``
        the pixel centres."""
        bar_h = 3 * s.game.jump_charge
        u = unit[:, None]
        x0 = 0.25 * u
        y0 = ((vis - 0.5 - bar_h) * unit)[:, None]
        in_x = (sx >= x0) & (sx < x0 + 0.5 * u)
        in_y = (sy >= y0) & (sy < y0 + (bar_h * unit)[:, None])
        mask = in_y[:, :, None] & in_x[:, None, :]
        col = torch.tensor(BAR_COLOR, dtype=obs.dtype, device=obs.device)
        return torch.where(mask[..., None], col, obs)

    # -- reset ----------------------------------------------------------------

    def _fill(self, s, x, y, dx, dy, elem, cond=None):
        """``fill_elem`` where ``cond`` ([N] bool, all envs when None): the
        rectangle is emptied where it is False."""
        if cond is not None:
            dx = torch.where(cond, torch.as_tensor(dx, device=cond.device), 0)
        return self.fill_elem(s, x, y, dx, dy, elem)

    def _fill_block_top(self, s, x, y, dx, dy, cond=None):
        """ninja.cpp:177-183 with WALL_MID for the block and its top: a
        no-op where ``dy`` <= 0."""
        dy = torch.as_tensor(dy, device=s.grid.device)
        ok = dy > 0
        cond = ok if cond is None else cond & ok
        s = self._fill(s, x, y, dx, dy - 1, WALL_MID, cond)
        return self._fill(s, x, y + dy - 1, dx, 1, WALL_MID, cond)

    def game_reset(self, s: BasicState) -> BasicState:
        s = self.game_reset_base(s)
        n = s.num
        dev = s.grid.device
        s = s.replace(
            maxspeed=torch.full((n,), 0.5, dtype=f32, device=dev),
            max_jump=torch.full((n,), self.max_jump, dtype=f32, device=dev),
            visibility=torch.full((n,), self.visibility, dtype=f32, device=dev),
            ents=s.ents.set_fields(0, rx=0.5, ry=0.5, x=1.5, y=32.5),
            game=self.game_init_state(n, dev),
        )
        d, norm = rng.peek_block(s.rand_gen, rng.N)
        d, dif0 = d.randn(3)
        difficulty = dif0 + 1
        d, wall_theme = d.randn(NUM_WALL_THEMES)
        s = s.replace(game=s.game.replace(wall_theme=wall_theme))

        # init_floor_and_walls (ninja.cpp:185-190)
        w, h = 64, 64
        s = self.fill_elem(s, 0, 0, w, 1, WALL_MID)
        s = self.fill_elem(s, 0, 0, 1, h, WALL_MID)
        s = self.fill_elem(s, w - 1, 0, 1, h, WALL_MID)
        s = self.fill_elem(s, 0, h - 1, w, 1, WALL_MID)

        s, d = self._generate(s, d, difficulty)
        return s.replace(rand_gen=rng.commit(norm, d))

    def _generate(self, s, d, difficulty):
        """generate_coin_to_the_right (ninja.cpp:192-268): up to 5 sections
        of up to 2 platform edges, each draw and each write masked by
        whether the env has it, in the reference's order."""
        n = s.num
        dev = s.grid.device
        easy = self.options.distribution_mode == EASY_MODE
        min_gap = torch.clamp_min(difficulty - 1 - (1 if easy else 0), 0)
        min_plat_w = 3 if easy else 1
        inc_dy = 2 if easy else 4
        bomb_prob = 0.25 * (difficulty.to(f32) - 1)
        max_gap_inc = torch.where(difficulty == 1, 1, 2)

        d, ns0 = d.randn(difficulty)
        num_sections = ns0 + difficulty
        start_x = 5
        curr_x = torch.full((n,), start_x, dtype=i32, device=dev)
        curr_y = torch.full((n,), 32, dtype=i32, device=dev)
        min_y = curr_y
        w, h = 64, 64
        # the jump's reach in cells, from the mode's max_jump
        max_dy = int(1.25 * 1.25 / (2 * GRAVITY) - 0.5) if easy else int(
            1.5 * 1.5 / (2 * GRAVITY) - 0.5)

        s = self._fill_block_top(s, 0, 0, start_x, curr_y)
        s = self.fill_elem(s, 0, curr_y + 8, start_x, h - curr_y - 8, WALL_MID)

        neg1 = torch.full((n,), -1, dtype=i32, device=dev)
        for i in range(MAX_SECTIONS):
            sec_live = i < num_sections
            prev_x = curr_x
            prev_y = curr_y
            d, ne0 = d.randn_if(sec_live, 2)
            num_edges = ne0 + 1
            max_y = neg1
            last_edge_y = neg1

            for j in range(MAX_EDGES):
                live = sec_live & (j < num_edges)
                cx = prev_x + j
                live = live & (cx + 15 < w)
                curr_x = torch.where(live, cx, curr_x)
                cy = prev_y

                d, dy0 = d.randn_if(live, inc_dy)
                dy = torch.clamp_max(dy0 + 1 + torch.div(difficulty, 3, rounding_mode="floor"),
                                     max_dy)
                high = cy >= h - 15
                mid = (cy >= 5) & ~high
                d, flip = d.rand01_if(live & mid)
                neg = high | (mid & (flip < 0.4))
                dy = torch.where(neg, -dy, dy)
                cy = torch.clamp_min(cy + dy, 3)
                cy = torch.where(torch.abs(cy - last_edge_y) <= 1, last_edge_y + 2, cy)
                curr_y = torch.where(live, cy, curr_y)

                d, dx0 = d.randn_if(live, 3)
                dx = min_plat_w + dx0
                s = self._fill_block_top(s, curr_x, curr_y - 1, dx, 1, live)

                d, gap0 = d.randn_if(live, max_gap_inc + 1)
                curr_x = torch.where(live, curr_x + dx + min_gap + gap0, curr_x)
                max_y = torch.where(live, torch.maximum(max_y, curr_y), max_y)
                min_y = torch.where(live, torch.minimum(min_y, curr_y), min_y)
                last_edge_y = torch.where(live, curr_y, last_edge_y)

            d, broll = d.rand01_if(sec_live)
            place_bomb = sec_live & (broll < bomb_prob)
            d, bx0 = d.randn_if(place_bomb, torch.clamp_min(curr_x - prev_x + 1, 1))
            s = self.set_obj_where(s, bx0 + prev_x, max_y + 2, BOMB, place_bomb)

            ceiling_start = max_y - 1 + 11
            s = self._fill_block_top(s, prev_x, ceiling_start, curr_x - prev_x,
                                     h - ceiling_start, sec_live)

        # the goal (ninja.cpp:253-266)
        d, gtheme = d.randn(self.num_themes(GOAL))
        f = default_fields(curr_x.to(f32) + 0.5, curr_y.to(f32) + 0.5, 0.0, 0.0,
                           0.5, 0.5, GOAL)
        f["image_theme"] = gtheme
        s = s.replace(ents=s.ents.push(f))

        s = self._fill_block_top(s, curr_x, curr_y - 1, 1, 1)
        s = self.fill_elem(s, curr_x, curr_y + 6, 1, h - curr_y - 6, WALL_MID)
        fire_y = torch.clamp_min(min_y - 2, 1)
        s = self._fill_block_top(s, start_x, 0, w - start_x, fire_y)
        s = self.fill_elem(s, start_x, fire_y, w - start_x, 1, FIRE)
        s = self.fill_elem(s, curr_x + 1, 0, w - curr_x - 1, h, WALL_MID)
        return s, d

    # -- per-step -------------------------------------------------------------

    def game_step(self, s: BasicState, d):
        s, d = self.game_step_base(s, d)
        refl = torch.where(s.action_vx > 0, False,
                           torch.where(s.action_vx < 0, True, s.ents.is_reflected[:, 0]))
        s = s.replace(ents=s.ents.set_fields(0, is_reflected=refl))

        # a throwing star (ninja.cpp:369-395), at most one every 3 steps
        g = s.game
        fire = (s.special_action > 0) & ((s.cur_time - g.last_fire_time) >= 3)
        cos_t, sin_t = _star_velocities(str(s.grid.device))
        k = _star_heading(s.special_action, refl)
        e = s.ents
        f = default_fields(e.x[:, 0], e.y[:, 0], cos_t[k], sin_t[k], 0.25, 0.25,
                           THROWING_STAR)
        f["collides_with_entities"] = True
        f["expire_time"] = 15
        f["smart_step"] = True
        return s.replace(
            ents=e.push(f, do=fire),
            game=g.replace(last_fire_time=torch.where(fire, s.cur_time, g.last_fire_time)),
        ), d
