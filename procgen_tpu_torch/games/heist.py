"""Heist: a maze with up to three coloured locks; collect the keys and
reach the gem (+10).  Reference: procgen/src/games/heist.cpp; JAX
counterpart procgen_tpu/games/heist.py.

The level is a Kruskal maze with doors (``levelgen.maze.
generate_maze_with_doors``) copied into the world at a random offset.
The doors are entities that block the agent unless its key is held
(heist.cpp:66-71): the agent's entity scan is one vectorised push against
the overlapping locked door, of which there is at most one.  Held keys
show on a key ring in screen coordinates (``use_abs_coords``, render_z
1).  Collisions take the sequential reverse scan (``dispatch_sequential``):
the exit assigns its reward, a key or an opened door is erased.  Memory
mode centres the camera on the agent.  Every function works on the whole
batch: per-env values are ``[N]`` tensors, per-slot values ``[N, cap]``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import libm, rng
from ..core.constants import (
    AGENT_OBJ, DOOR_OBJ, EASY_MODE, EXIT_OBJ, HARD_MODE, KEY_OBJ, MEMORY_MODE,
    PLAYER, SPACE, WALL_OBJ,
)
from ..core.entities import default_fields, stack_records
from ..core.game import BasicAbstractGame, BasicState, first_true
from ..levelgen import maze as mazegen
from ..render.renderer import rdiv
from .registry import register

i32 = torch.int32
f32 = torch.float32

COMPLETION_BONUS = 10.0

LOCKED_DOOR = 1
KEY = 2
EXIT = 9
KEY_ON_RING = 11

KEY_R = 0.375  # a key's and the exit's radius (heist.cpp:165-178)
# the key ring's keys' radius, in screen units (heist.cpp:188-199): a C++
# float, whose products with double literals (the keys' x and y) are taken
# in double and rounded once
RING_KEY_R = float(np.float32(0.03))
# the cells of a maze that hold an object: at most 3 keys, 3 doors, the
# exit and the agent
MAX_OBJECTS = 8


@dataclasses.dataclass
class HeistState:
    num_keys: torch.Tensor  # int32 [N]
    has_keys: torch.Tensor  # bool [N, 3]

    def replace(self, **kw) -> "HeistState":
        return dataclasses.replace(self, **kw)


@register("heist")
class Heist(BasicAbstractGame):
    name = "heist"
    ENT_CAP = 12  # agent + <=3 keys + <=3 doors + exit + <=3 ring keys
    ARB_ROT_TYPES = {0: 8}  # the agent faces the 8 move directions
    MAX_STEP_DRAWS = 4
    MAX_SUB_STEPS = 6  # maxspeed .75 -> 4*|v| <= 4.2
    ENTITY_SCAN = True  # locked doors block (vectorised override below)

    def __init__(self, options):
        super().__init__(options)
        self.has_useful_vel_info = False
        self.out_of_bounds_object = WALL_OBJ
        self.visibility = 8.0
        self.maxspeed = 0.75  # set in choose_world_dim (heist.cpp:110)
        self.center_agent = options.distribution_mode == MEMORY_MODE

        mode = options.distribution_mode
        if mode == EASY_MODE:
            self.world_dim = 9
        elif mode == HARD_MODE:
            self.world_dim = 13
        elif mode == MEMORY_MODE:
            self.world_dim = 23
        else:
            raise ValueError(f"heist does not support distribution_mode {mode}")
        self.WORLD_DIM_MAX = (self.world_dim, self.world_dim)

    def background_names(self):
        from ..render.assets import TOPDOWN_BACKGROUNDS

        return TOPDOWN_BACKGROUNDS

    def asset_for_type(self, type_):
        # heist.cpp:44-60
        return {
            WALL_OBJ: ["kenney/Ground/Dirt/dirtCenter.png"],
            EXIT: ["misc_assets/gemYellow.png"],
            PLAYER: ["misc_assets/spaceAstronauts_008.png"],
            KEY: ["misc_assets/keyBlue.png", "misc_assets/keyGreen.png",
                  "misc_assets/keyRed.png"],
            LOCKED_DOOR: ["misc_assets/lock_blue.png", "misc_assets/lock_green.png",
                          "misc_assets/lock_red.png"],
        }.get(type_, [])

    def use_block_asset(self, type_):
        return type_ in (WALL_OBJ, LOCKED_DOOR)

    def should_preserve_type_themes(self, type_):
        # heist.cpp:40-42
        return (type_ == KEY) | (type_ == LOCKED_DOOR)

    def game_init_state(self, n, device):
        return HeistState(num_keys=torch.zeros((n,), dtype=i32, device=device),
                          has_keys=torch.zeros((n, 3), dtype=torch.bool, device=device))

    def choose_world_dim(self, s):
        return s.replace(main_width=torch.full_like(s.main_width, self.world_dim),
                         main_height=torch.full_like(s.main_height, self.world_dim))

    # -- physics --------------------------------------------------------------

    def _entity_scan(self, s, rec, vx, vy, depth):
        """Locked doors block the agent (heist.cpp:66-71).  The reverse scan
        ends on the lowest-slot overlapping locked door, and at most one
        overlaps (doors sit in distinct maze cells), so one push against
        it, resolved on the grid, is the scan.  ``rec`` is the agent's
        record, ``[N]`` fields."""
        e = s.ents
        horiz = vx != 0
        slots = torch.arange(self.ENT_CAP, device=e.x.device)
        locked = ~self._key_held(s, e.image_theme)
        blocking = (e.active & (slots != 0) & ~e.will_erase & (e.type == LOCKED_DOOR)
                    & locked)
        c = lambda t: t[:, None]  # noqa: E731  [N] -> [N, 1]
        coll = ((torch.abs(c(rec["x"]) - e.x) < c(rec["rx"]) + e.rx + (-0.001))
                & (torch.abs(c(rec["y"]) - e.y) < c(rec["ry"]) + e.ry + (-0.001)))
        hit = blocking & coll & c(~rec["will_erase"])
        any_hit = hit.any(dim=1)
        src = first_true(hit)[:, None]  # the lowest slot
        sx, sy, srx, sry = (t.gather(1, src)[:, 0] for t in (e.x, e.y, e.rx, e.ry))
        rsum = torch.where(horiz, srx + rec["rx"], sry + rec["ry"])
        t_vx = torch.where(horiz & any_hit,
                           sx + torch.sign(rec["x"] - sx) * rsum - rec["x"], 0.0)
        t_vy = torch.where(~horiz & any_hit,
                           sy + torch.sign(rec["y"] - sy) * rsum - rec["y"], 0.0)
        _, rec2, _ = self._sub_step_rec(s, rec, t_vx, t_vy, self.PUSH_DEPTH, False)
        rec = {k: rec[k] if rec2[k] is rec[k] else torch.where(any_hit, rec2[k], rec[k])
               for k in rec}
        rec["vx"] = torch.where(any_hit & horiz, 0.0, rec["vx"])
        rec["vy"] = torch.where(any_hit & ~horiz, 0.0, rec["vy"])
        return s, rec, any_hit

    @staticmethod
    def _key_held(s, theme):
        """has_keys[clip(theme, 0, 2)] of each env, ``theme`` [N] or
        [N, cap]."""
        hk = s.game.has_keys
        t = theme.clamp(0, 2).long()
        if t.dim() == 1:
            return hk.gather(1, t[:, None])[:, 0]
        return hk.gather(1, t)

    def should_draw_entity_mask(self, s):
        # a ring key shows only while its key is held
        e = s.ents
        return (e.type != KEY_ON_RING) | self._key_held(s, e.image_theme)

    def handle_agent_collision(self, s, d, i: int):
        """heist.cpp:81-97: the exit *assigns* the reward; a key is taken,
        a door whose key is held opens."""
        e = s.ents
        t = e.type[:, i]
        exit_ = t == EXIT
        key = t == KEY
        theme = e.image_theme[:, i].clamp(0, 2)
        door_open = (t == LOCKED_DOOR) & self._key_held(s, theme)
        colour = torch.arange(3, device=t.device)[None, :] == theme[:, None]
        g = s.game
        return s.replace(
            done=s.done | exit_,
            reward=torch.where(exit_, COMPLETION_BONUS, s.reward),
            level_complete=s.level_complete | exit_,
            ents=e.set_fields_where(i, key | door_open, will_erase=True),
            game=g.replace(has_keys=g.has_keys | (key[:, None] & colour)),
        ), d

    # -- reset ----------------------------------------------------------------

    def game_reset(self, s: BasicState) -> BasicState:
        s = self.game_reset_base(s)
        n = s.num
        dev = s.grid.device
        wd = self.world_dim

        min_maze_dim = 5
        s, difficulty = self.randn(s, (wd - min_maze_dim) // 2 + 1)
        if self.options.distribution_mode == MEMORY_MODE:
            s, num_keys = self.randn(s, 4)
        else:
            s, extra = self.randn(s, 2)
            num_keys = difficulty + extra
        num_keys = num_keys.clamp_max(3)
        maze_dim = difficulty * 2 + min_maze_dim
        s = s.replace(ents=s.ents.set_fields(0, rx=0.375, ry=0.375, x=-1.0, y=-1.0))

        g, mgrid, actual_doors = mazegen.generate_maze_with_doors(s.rand_gen, maze_dim, wd,
                                                                 num_keys)
        g, off_x = rng.randn(g, wd - maze_dim + 1)
        g, off_y = rng.randn(g, wd - maze_dim + 1)

        # the maze's cells, in maze coordinates (i, j) < wd, as objects
        # (WALL outside the maze): mobj[n, j, i]
        ij = torch.arange(wd, device=dev)
        md = maze_dim[:, None, None]
        inside = (ij[None, None, :] < md) & (ij[None, :, None] < md)
        mpos = (ij[None, :, None] + 1) * (md + 2) + (ij[None, None, :] + 1)
        mobj = mgrid.gather(1, mpos.clamp(0, mgrid.shape[1] - 1).reshape(n, -1).long())
        mobj = torch.where(inside, mobj.reshape(n, wd, wd), WALL_OBJ)

        # the world: WALL, and SPACE where the maze is open (heist.cpp:155-160)
        gy = torch.arange(wd, device=dev)[None, :, None] - off_y[:, None, None]
        gx = torch.arange(wd, device=dev)[None, None, :] - off_x[:, None, None]
        w_in = (gx >= 0) & (gx < md) & (gy >= 0) & (gy < md)
        wobj = mobj.reshape(n, -1).gather(
            1, (gy.clamp(0, wd - 1) * wd + gx.clamp(0, wd - 1)).reshape(n, -1))
        grid = torch.where(w_in & (wobj.reshape(n, wd, wd) != WALL_OBJ), SPACE, WALL_OBJ)
        s = s.replace(grid=grid.to(i32))

        # the objects, in the C++ cell order (x outer, y inner; heist.cpp:
        # 161-186): at most MAX_OBJECTS cells, taken in that order
        cm = mobj.transpose(1, 2).reshape(n, -1)  # [n, i * wd + j]
        is_obj = (cm >= DOOR_OBJ) | (cm == EXIT_OBJ) | (cm == AGENT_OBJ)
        ranks = torch.cumsum(is_obj.to(i32), dim=1) - 1
        key_ar = self.aspect_ratios(KEY, dev)
        exit_ar = self.aspect_ratios(EXIT, dev)[0]
        d, norm = rng.peek_block(g, rng.N)
        recs, dos = [], []
        ents = s.ents
        for k in range(MAX_OBJECTS):
            cell = first_true(is_obj & (ranks == k))
            obj = torch.where(ranks.amax(dim=1) >= k, cm.gather(1, cell[:, None])[:, 0],
                              WALL_OBJ)
            mx = (off_x + torch.div(cell, wd, rounding_mode="floor")).to(f32)
            my = (off_y + torch.remainder(cell, wd)).to(f32)
            is_key = obj >= KEY_OBJ
            is_door = (obj >= DOOR_OBJ) & ~is_key
            is_exit = obj == EXIT_OBJ
            # a key's or the exit's rand_pos in its cell (cpp:1109-1117):
            # (hi - lo - 2r) * v + r + lo, the span 1 > 2r always drawn
            draws = is_key | is_exit
            d, vx = d.rand01_if(draws)
            d, vy = d.rand01_if(draws)
            px = (mx + 1 - mx - 2 * KEY_R) * vx + KEY_R + mx
            py = (my + 1 - my - 2 * KEY_R) * vy + KEY_R + my
            theme = torch.where(is_key, obj - KEY_OBJ - 1, obj - DOOR_OBJ - 1).clamp(0, 2)
            ar = torch.where(is_key, key_ar[theme.clamp_max(key_ar.shape[0] - 1)], exit_ar)
            # the three types take the same constructor defaults
            f = default_fields(
                torch.where(is_door, mx + 0.5, px), torch.where(is_door, my + 0.5, py),
                0.0, 0.0, torch.where(is_door, 0.5, KEY_R),
                torch.where(is_door, 0.5, rdiv(KEY_R, ar)), KEY,
            )
            f["type"] = f["image_type"] = torch.where(
                is_key, KEY, torch.where(is_door, LOCKED_DOOR, EXIT))
            f["image_theme"] = torch.where(is_exit, 0, theme)
            recs.append(f)
            dos.append(is_key | is_door | is_exit)
            agent = obj == AGENT_OBJ
            ents = ents.set_fields_where(0, agent, x=mx + 0.5, y=my + 0.5)
        ents = ents.push_many(stack_records(recs, n, dev), torch.stack(dos, dim=1))

        # the key ring (heist.cpp:188-199), screen coordinates, above the
        # world
        ring = []
        for ki in range(3):
            f = default_fields(1 - RING_KEY_R * (2 * ki + 1.25), RING_KEY_R * 0.75, 0.0, 0.0,
                               RING_KEY_R, RING_KEY_R, KEY_ON_RING)
            f.update(image_theme=ki, image_type=KEY, rotation=math.pi / 2, render_z=1,
                     use_abs_coords=True)
            if ki < key_ar.shape[0]:
                f["ry"] = rdiv(RING_KEY_R, key_ar[ki:ki + 1]).expand(n)
            ring.append(f)
        ents = ents.push_many(stack_records(ring, n, dev),
                              torch.arange(3, device=dev)[None, :] < actual_doors[:, None])
        return s.replace(
            ents=ents,
            rand_gen=rng.commit(norm, d),
            game=HeistState(num_keys=actual_doors,
                            has_keys=torch.zeros((n, 3), dtype=torch.bool, device=dev)),
        )

    def game_step(self, s: BasicState, d):
        s, d = self.game_step_base(s, d)
        # face_direction (heist.cpp:203; entity.cpp:84-88)
        vx, vy = s.action_vx, s.action_vy
        rot = torch.where((vx != 0) | (vy != 0), -libm.atan2f(vy, vx), s.ents.rotation[:, 0])
        return s.replace(ents=s.ents.set_fields(0, rotation=rot)), d



# the agent's 8 facings: the move directions (vx, vy) whose -atan2f it
# takes (heist.cpp:203)
FACINGS = ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1))


def with_ring_and_facings(s: BasicState) -> BasicState:
    """``s`` with every key held, so that each env's key ring shows, and
    env i's agent turned to facing ``i mod 8``: the states on which the
    frame checks reach the screen-coordinate slots and every rotation
    bank."""
    n = s.ents.x.shape[0]
    d = torch.tensor([FACINGS[i % 8] for i in range(n)], dtype=f32, device=s.ents.x.device)
    return s.replace(ents=s.ents.set_fields(0, rotation=-libm.atan2f(d[:, 1], d[:, 0])),
                     game=s.game.replace(has_keys=torch.ones_like(s.game.has_keys)))
