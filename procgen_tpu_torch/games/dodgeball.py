"""Dodgeball (Berzerk): touching a wall, an enemy or an enemy's ball kills;
throw balls at the enemies (+2 each); once every enemy is dead, reach the
door (+10).  Reference: procgen/src/games/dodgeball.cpp; JAX counterpart
procgen_tpu/games/dodgeball.py.

The reset splits the world into rooms with lava walls, batched over the
envs: one pass over the splitting iterations, each env drawing over its
own live rooms.  The door, the agent and the enemies are then placed by
rejection (``place_by_rejection`` and a masked loop for the agent), and
every enemy's setup draws are taken at once from offsets of a prefix sum
over the slots.  The step fires the agent's ball, turns and fires the
enemies the same way: the draws of the reference's loop over descending
slots come from one peeked window at prefix-sum offsets, and the enemies'
balls are pushed in that order.  Enemies reflect off the lava walls
(``_entity_scan``, the highest overlapping slot) and the balls against
the walls and enemies are one overlap of every pair of slots.  Every
function works on the whole batch: per-env values are ``[N]`` tensors,
per-slot values ``[N, cap]``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import libm, rng
from ..core.constants import EASY_MODE, EXTREME_MODE, HARD_MODE, MEMORY_MODE, PLAYER
from ..core.entities import default_fields, stack_records
from ..core.game import (
    BasicAbstractGame, BasicState, first_true, per_env, place_by_rejection,
    reposition_agent,
)
from .registry import register

i32 = torch.int32
f32 = torch.float32

COMPLETION_BONUS = 10.0
ENEMY_REWARD = 2.0

LAVA_WALL = 1
PLAYER_BALL = 3
ENEMY = 4
DOOR = 5
ENEMY_BALL = 6
DOOR_OPEN = 7
DUST_CLOUD = 8
OOB_WALL = 10

NUM_ENEMY_THEMES = 7
ENEMY_VEL = 0.05
PI = math.pi
# The C++ float products and quotients, each rounded once to f32 from f32
# operands: the ball's spin is f32(f32(pi) * f32(.23)), an ulp above the
# JAX package's f32(pi * .23) in double (the C++ engine's state bytes,
# tests/data/refstate/dodgeball_bridge.json); the dust cloud's spin and
# growth give the same bits in either form.
BALL_V_ROT = float(np.float32(PI) * np.float32(0.23))
DUST_V_ROT = float(np.float32(PI) / np.float32(0.3))
DUST_GROW_RATE = float(np.float32(1.0) / np.float32(1.2))
ROOM_CAP = 40
MAX_TRIES = 100  # the retry bound of reposition and reposition_agent
PLAYER_FIRE_DELAY = 7


@dataclasses.dataclass
class DodgeballState:
    last_fire_time: torch.Tensor  # int32 [N]
    num_enemies: torch.Tensor  # int32 [N], live enemies
    ball_r: torch.Tensor  # f32 [N]
    ball_vscale: torch.Tensor  # f32 [N]

    def replace(self, **kw) -> "DodgeballState":
        return dataclasses.replace(self, **kw)


def _f32(v: float) -> float:
    return float(np.float32(v))


@register("dodgeball")
class Dodgeball(BasicAbstractGame):
    name = "dodgeball"
    ENT_CAP = 72
    # the agent and the balls face 45-degree directions (8 buckets); an
    # enemy's facing is continuous (32 buckets)
    ARB_ROT_TYPES = {0: 8, 3: 8, 4: 32, 6: 8}
    DECOR_CAP = 16  # dust clouds
    DECOR_TYPES = frozenset(range(54, 60)) | {DUST_CLOUD}
    DISPATCH_VECTORIZED = True
    ANY_COLLIDES_WITH_ENTITIES = True
    MAX_STEP_DRAWS = 96  # <= 19 enemies x (3 redraws + 1 fire) + step_rand_int
    MAX_SUB_STEPS = 5
    ONLY_AGENT_SMART = False
    SMART_VECTORIZABLE = True
    MAX_SMART = 24
    ENTITY_SCAN = False
    ENTITY_SCAN_NONAGENT = True  # enemies reflect off the lava walls
    ENEMY_FIRE_DELAY = 50
    # walls and the door are entities and the grid is never written; easy,
    # hard and extreme keep the whole-world camera (memory mode centres it)
    STATIC_RENDER_PREFIX = True

    def __init__(self, options):
        super().__init__(options)
        self.mixrate = 0.5
        self.out_of_bounds_object = OOB_WALL
        mode = options.distribution_mode
        dim = 40 if mode == MEMORY_MODE else 20
        self.world_dim = dim
        self.WORLD_DIM_MAX = (dim, dim)
        self.center_agent = mode == MEMORY_MODE

        # per-mode scaling (dodgeball.cpp:276-313)
        if mode == EASY_MODE:
            self.num_iterations, self.thickness = 2, 0.6
            self.enemy_r, self._ball_r, self._ball_vscale = 1.0, 0.5, 0.5
            self._maxspeed, self.agent_r, self.exit_r = 0.75, 1.0, 1.5
            self.max_extra = 3
        elif mode == HARD_MODE:
            self.num_iterations, self.thickness = 4, 0.45
            self.enemy_r, self._ball_r, self._ball_vscale = 0.75, 0.375, 0.375
            self._maxspeed, self.agent_r, self.exit_r = 0.5, 0.75, 0.75
            self.max_extra = 3
        elif mode == EXTREME_MODE:
            self.num_iterations, self.thickness = 8, 0.3
            self.enemy_r, self._ball_r, self._ball_vscale = 0.5, 0.25, 0.25
            self._maxspeed, self.agent_r, self.exit_r = 0.25, 0.4, 0.75
            self.max_extra = 3
        elif mode == MEMORY_MODE:
            self.num_iterations, self.thickness = 16, 0.45
            self.enemy_r, self._ball_r, self._ball_vscale = 0.75, 0.375, 0.375
            self._maxspeed, self.agent_r, self.exit_r = 0.5, 0.75, 0.75
            self.max_extra = 16
        else:
            raise ValueError(f"dodgeball does not support distribution_mode {mode}")
        # C++ float members with a double literal: the float products and
        # sum, plus .5 in double, rounded once (the JAX package's double
        # forms give the same bits for every mode)
        ar, th = np.float32(self.agent_r), np.float32(self.thickness)
        self.hard_min_dim = _f32(float(np.float32(4) * ar + np.float32(2) * th) + 0.5)
        self.min_dim = _f32(float(ar * np.float32(8)) + 0.5)

    def background_names(self):
        from ..render.assets import TOPDOWN_BACKGROUNDS

        return TOPDOWN_BACKGROUNDS

    def asset_for_type(self, type_):
        # dodgeball.cpp:50-90
        if type_ == PLAYER:
            return ["misc_assets/character12.png"]
        if type_ == PLAYER_BALL:
            return ["misc_assets/ball_soccer1.png"]
        if type_ == ENEMY:
            return [f"misc_assets/character{i}.png" for i in range(1, 12)]
        if type_ == DOOR:
            return ["misc_assets/blockRed.png"]
        if type_ == ENEMY_BALL:
            return ["misc_assets/ball_soccer2.png"]
        if type_ == DOOR_OPEN:
            return ["misc_assets/blockGreen.png"]
        if type_ in (LAVA_WALL, OOB_WALL):
            return ["misc_assets/tileStone_slope2.png"]
        if type_ == DUST_CLOUD:
            return [f"misc_assets/spaceEffect{i}.png" for i in range(1, 10)]
        return []

    def use_block_asset(self, type_):
        return type_ in (LAVA_WALL, DOOR, DOOR_OPEN)

    def entity_tile_ratio(self, s, e):
        # dodgeball.cpp:240-246: lava walls tile along their long axis
        return torch.where(e.type == LAVA_WALL,
                           torch.where(e.rx > e.ry, 1.0, -1.0), 0.0).to(f32)

    def image_for_type(self, s, type_):
        """The door shows open once no enemy is left."""
        open_ = per_env(s.game.num_enemies == 0, type_)
        door = torch.where(open_, DOOR_OPEN, DOOR)
        return torch.where(type_ == DOOR, door, torch.abs(type_)).to(type_.dtype)

    def game_init_state(self, n, device):
        def full(v, dtype):
            return torch.full((n,), v, dtype=dtype, device=device)

        return DodgeballState(
            last_fire_time=full(0, i32),
            num_enemies=full(0, i32),
            ball_r=full(self._ball_r, f32),
            ball_vscale=full(self._ball_vscale, f32),
        )

    def choose_world_dim(self, s):
        return s.replace(main_width=torch.full_like(s.main_width, self.world_dim),
                         main_height=torch.full_like(s.main_height, self.world_dim))

    # -- physics ----------------------------------------------------------------

    def will_reflect(self, src_type, target_type):
        return (src_type == ENEMY) & ((target_type == LAVA_WALL)
                                      | (target_type == self.out_of_bounds_object))

    def _entity_scan(self, s, rec, vx, vy, depth):
        """An enemy's micro-move against the lava walls (the reference's
        reverse scan, of which only the first hit acts): the record
        (``[N, M]`` fields) reflects off the highest slot it overlaps, a
        plain gather where the JAX package selects by a one-hot product.
        Pure in ``s``; [N, M, cap] overlaps."""
        e = s.ents
        cap = e.cap
        slots = torch.arange(cap, device=e.x.device)
        r = lambda t: t[:, :, None]  # noqa: E731  the record axis
        t_ = lambda t: t[:, None, :]  # noqa: E731  the slot axis
        coll = ((torch.abs(r(rec["x"]) - t_(e.x)) < r(rec["rx"]) + t_(e.rx) + (-0.001))
                & (torch.abs(r(rec["y"]) - t_(e.y)) < r(rec["ry"]) + t_(e.ry) + (-0.001))
                & t_(e.active & ~e.will_erase)
                & self.will_reflect(r(rec["type"]), t_(e.type))
                & ~r(rec["will_erase"]))
        any_hit = coll.any(dim=2)
        si = torch.where(coll, slots, -1).amax(dim=2).clamp_min(0).long()
        sx, sy, srx, sry = (t.gather(1, si) for t in (e.x, e.y, e.rx, e.ry))
        delx = sx - rec["x"]
        dely = sy - rec["y"]
        rsumx = srx + rec["rx"]
        rsumy = sry + rec["ry"]
        bx = rec["x"] + torch.where(vx > 0, -2 * (rsumx - delx), 2 * (rsumx + delx))
        by = rec["y"] + torch.where(vy > 0, -2 * (rsumy - dely), 2 * (rsumy + dely))
        horiz = vx != 0
        hx, hy = any_hit & horiz, any_hit & ~horiz
        rec = dict(rec)
        rec["x"] = torch.where(hx, bx, rec["x"])
        rec["y"] = torch.where(hy, by, rec["y"])
        rec["vx"] = torch.where(hx, -rec["vx"], rec["vx"])
        rec["vy"] = torch.where(hy, -rec["vy"], rec["vy"])
        return s, rec, torch.zeros_like(any_hit)

    # -- collisions -------------------------------------------------------------

    def handle_agent_collision_vec(self, s, d, hit):
        # dodgeball.cpp:105-121
        e = s.ents
        lethal = (hit & ((e.type == ENEMY) | (e.type == ENEMY_BALL)
                         | (e.type == LAVA_WALL))).any(dim=1)
        exit_hit = (hit & (e.type == DOOR)).any(dim=1) & (s.game.num_enemies == 0)
        return s.replace(
            done=s.done | lethal | exit_hit,
            reward=s.reward + torch.where(exit_hit, COMPLETION_BONUS, 0.0),
            level_complete=s.level_complete | exit_hit,
        ), d

    def dispatch_entity_pairs(self, s, d):
        """Balls against lava walls and enemies (dodgeball.cpp:123-152), one
        overlap of every pair of slots ([N, cap, cap], the first axis the
        wall or enemy, the second the ball); a dying enemy leaves a dust
        cloud in the decor pool, pushed in slot order."""
        e = s.ents
        live = e.active & ~e.will_erase
        is_pball = live & (e.type == PLAYER_BALL)
        is_eball = live & (e.type == ENEMY_BALL)
        is_wall = live & (e.type == LAVA_WALL)
        is_enemy = live & (e.type == ENEMY)
        a = lambda t: t[:, :, None]  # noqa: E731
        b = lambda t: t[:, None, :]  # noqa: E731
        overlap = ((torch.abs(a(e.x) - b(e.x)) < a(e.rx) + b(e.rx) + a(e.collision_margin))
                   & (torch.abs(a(e.y) - b(e.y)) < a(e.ry) + b(e.ry) + a(e.collision_margin)))

        on_wall = overlap & a(is_wall)
        pball_wall = (on_wall & b(is_pball)).any(dim=1)
        eball_wall = (on_wall & b(is_eball)).any(dim=1)
        enemy_pball = overlap & a(is_enemy) & b(is_pball)
        enemy_hits = enemy_pball.sum(dim=2).to(f32)
        pball_enemy = enemy_pball.any(dim=1)

        new_health = e.health - torch.where(is_enemy, enemy_hits, 0.0)
        enemy_dies = is_enemy & (new_health <= 0) & (enemy_hits > 0)
        s = s.replace(
            reward=s.reward + enemy_dies.sum(dim=1).to(f32) * ENEMY_REWARD,
            ents=e.replace(
                health=new_health,
                will_erase=e.will_erase | enemy_dies | pball_wall | eball_wall | pball_enemy,
            ),
        )

        # the step's theme (choose_step_random_theme: no draw)
        theme = torch.remainder(s.step_rand_int, self.num_themes(DUST_CLOUD))
        f = default_fields(e.x, e.y, 0.0, 0.0, e.rx, e.rx, DUST_CLOUD)
        f["vrot"] = DUST_V_ROT
        f["grow_rate"] = DUST_GROW_RATE
        f["expire_time"] = 4
        f["alpha_decay"] = 0.9
        f["image_theme"] = theme[:, None]
        return s.replace(decor=s.decor.push_many(f, enemy_dies)), d

    # -- reset ------------------------------------------------------------------

    def game_reset(self, s: BasicState) -> BasicState:
        s = self.game_reset_base(s)
        n = s.num
        dev = s.grid.device
        s = s.replace(
            maxspeed=torch.full((n,), self._maxspeed, dtype=f32, device=dev),
            ents=s.ents.set_fields(0, rx=self.agent_r, ry=self.agent_r),
            game=self.game_init_state(n, dev),
        )
        d, norm = rng.peek_block(s.rand_gen, rng.N)
        d, walls, do = self._split_rooms(d, n, dev)
        s = s.replace(ents=s.ents.push_many(walls, do))

        # the door on one of the four walls (dodgeball.cpp:325-339); each
        # env draws only in its own wall's box
        W = float(self.world_dim)
        er = self.exit_r
        d, wall_choice = d.randn(4)
        boxes = ((0.0, 0.0, W, 2 * er), (0.0, W - 2 * er, W, 2 * er),
                 (0.0, 0.0, 2 * er, W), (W - 2 * er, 0.0, 2 * er, W))
        for ci, (bx, by, bw, bh) in enumerate(boxes):
            d, norm = rng.window(d, norm, 2 * (MAX_TRIES + 1))
            do = wall_choice == ci
            d, px, py = place_by_rejection(d, _blockers(s.ents), er, er, bx, by, bw, bh,
                                           do, MAX_TRIES)
            s = s.replace(ents=s.ents.push(
                default_fields(px, py, 0.0, 0.0, er, er, DOOR), do=do))

        # reposition_agent (cpp:341)
        d, norm = rng.window(d, norm, 2 * (MAX_TRIES + 1))
        d, ax, ay = reposition_agent(d, s.ents, W, W, MAX_TRIES)
        s = s.replace(ents=s.ents.set_fields(0, x=ax, y=ay))

        # the enemies (cpp:343-345)
        d, extra = d.randn(self.max_extra + 1)
        num_enemies = extra + 3
        for i in range(self.max_extra + 3):
            d, norm = rng.window(d, norm, 2 * (MAX_TRIES + 1))
            do = i < num_enemies
            d, px, py = place_by_rejection(d, _blockers(s.ents), self.enemy_r, self.enemy_r,
                                           0.0, 0.0, W, W, do, MAX_TRIES)
            s = s.replace(ents=s.ents.push(default_fields(
                px, py, 0.0, 0.0, self.enemy_r, self.enemy_r, ENEMY), do=do))

        # the theme and every enemy's setup, in slot order (cpp:347-363):
        # three draws an enemy, at offsets of a prefix sum over the slots
        d, norm = rng.window(d, norm, 1 + 3 * (self.max_extra + 3))
        d, enemy_theme = d.randn(NUM_ENEMY_THEMES)
        e = s.ents
        is_en = e.active & (e.type == ENEMY)
        start = 3 * (torch.cumsum(is_en.to(i32), dim=1) - 1)
        words = d.peek_at(torch.stack([start, start + 1, start + 2], dim=1))
        d = d.replace(cursor=d.cursor + 3 * is_en.sum(dim=1, dtype=i32))
        v0 = torch.remainder(words[:, 0], 2).to(i32)
        axis0 = torch.remainder(words[:, 1], 2).to(i32)
        sp0 = torch.remainder(words[:, 2], 50).to(i32)
        vel = ENEMY_VEL * (v0 * 2 - 1).to(f32)
        vx = torch.where(axis0 == 0, vel, 0.0)
        vy = torch.where(axis0 == 0, 0.0, vel)
        rot = torch.where((vx != 0) | (vy != 0), -libm.atan2f(vy, vx), e.rotation)

        def put(arr, v):
            return torch.where(is_en, torch.as_tensor(v, device=dev).to(arr.dtype), arr)

        e = e.replace(
            image_theme=put(e.image_theme, enemy_theme[:, None]),
            health=put(e.health, 1.0), spawn_time=put(e.spawn_time, sp0 + 25),
            fire_time=put(e.fire_time, 10),
            collides_with_entities=put(e.collides_with_entities, True),
            smart_step=put(e.smart_step, True), vx=put(e.vx, vx), vy=put(e.vy, vy),
            rotation=put(e.rotation, rot),
        )
        # the agent faces -atan2f(0, 1), which is -0.0
        return s.replace(
            rand_gen=rng.commit(norm, d),
            ents=e.set_fields(0, rotation=-0.0),
            game=s.game.replace(num_enemies=num_enemies.to(i32)),
        )

    def _split_rooms(self, d, n, dev):
        """The recursive room splitting (dodgeball.cpp:314-323, 170-243),
        batched over the envs: each iteration splits a random live room of
        each env (its ``randn`` over the env's own live count) by a lava
        wall and keeps up to three of the new rooms, in up to ``ROOM_CAP``
        slots.  Returns (d, the walls' records [N, iterations], whether
        each iteration made one)."""
        W = float(self.world_dim)
        th = self.thickness
        min_dim, hard_min_dim = self.min_dim, self.hard_min_dim

        def zeros(dtype):
            return torch.zeros((n, ROOM_CAP), dtype=dtype, device=dev)

        rooms = [zeros(f32) for _ in range(4)]  # x, y, w, h
        rooms[2][:, 0] = W
        rooms[3][:, 0] = W
        alive = zeros(torch.bool)
        alive[:, 0] = True
        count = torch.ones((n,), dtype=i32, device=dev)
        slots = torch.arange(ROOM_CAP, device=dev)[None, :]
        walls, made = [], []
        for _ in range(self.num_iterations):
            nalive = alive.sum(dim=1, dtype=i32)
            it_on = nalive > 0
            d, ridx = d.randn_if(it_on, nalive.clamp_min(1))
            ranks = torch.cumsum(alive.to(i32), dim=1) - 1
            pick = first_true(alive & (ranks == ridx[:, None]))
            alive = alive & ~((slots == pick[:, None]) & it_on[:, None])
            rx0, ry0, rw0, rh0 = (r.gather(1, pick[:, None])[:, 0] for r in rooms)

            d, s1 = d.rand01_if(it_on)
            d, s2 = d.rand01_if(it_on)
            d, gap0 = d.randn_if(it_on, 3)
            will_w = s1 < 0.5
            will_w = torch.where(rw0 < min_dim, False, will_w)
            will_w = torch.where(rh0 < min_dim, True, will_w)
            choice2 = s2 < 0.5
            gap = 0.25 * (gap0 + 1).to(f32)
            pct = 1 - gap

            # a wall across the room's height (will_w False) or its width
            wy = torch.where(choice2, ry0, ry0 + (1 - pct) * rh0)
            remy = torch.where(choice2, ry0 + pct * rh0, ry0)
            wh = pct * rh0
            wx = torch.where(choice2, rx0, rx0 + (1 - pct) * rw0)
            remx = torch.where(choice2, rx0 + pct * rw0, rx0)
            ww = pct * rw0
            wall = default_fields(
                torch.where(will_w, wx + ww / 2, rx0 + rw0 / 2),
                torch.where(will_w, ry0 + rh0 / 2, wy + wh / 2), 0.0, 0.0,
                torch.where(will_w, ww / 2, th), torch.where(will_w, th, wh / 2),
                LAVA_WALL)
            wall["collides_with_entities"] = True
            walls.append(wall)
            made.append(it_on)

            nextw = rw0 / 2 - th
            nexth = rh0 / 2 - th
            new_rooms = (
                ((wx, ry0, ww, nexth), (rx0, wy, nextw, wh)),
                ((wx, ry0 + rh0 / 2 + th, ww, nexth), (rx0 + rw0 / 2 + th, wy, nextw, wh)),
                ((remx, ry0, rw0 - ww, rh0), (rx0, remy, rw0, rh0 - wh)),
            )
            for if_w, if_h in new_rooms:
                nr = [torch.where(will_w, a, b) for a, b in zip(if_w, if_h)]
                nw0, nh0 = nr[2], nr[3]
                keep = it_on & (((nw0 >= min_dim) | (nh0 >= min_dim))
                                & (nw0 >= hard_min_dim) & (nh0 >= hard_min_dim))
                ok = keep & (count < ROOM_CAP)
                at = (slots == count.clamp_max(ROOM_CAP - 1)[:, None]) & ok[:, None]
                rooms = [torch.where(at, v[:, None], r) for r, v in zip(rooms, nr)]
                alive = alive | at
                count = count + ok.to(i32)
        return d, stack_records(walls, n, dev), torch.stack(made, dim=1)

    # -- per-step ---------------------------------------------------------------

    def game_step(self, s: BasicState, d):
        s, d = self.game_step_base(s, d)
        g = s.game
        n = s.num
        dev = s.grid.device

        vx = (torch.div(s.last_move_action, 3, rounding_mode="floor") - 1).to(f32)
        vy = (torch.remainder(s.last_move_action, 3) - 1).to(f32)
        rot = torch.where((vx != 0) | (vy != 0), -libm.atan2f(vy, vx),
                          s.ents.rotation[:, 0])
        s = s.replace(ents=s.ents.set_fields(0, rotation=rot))

        # the player's ball (dodgeball.cpp:389-396)
        fire = (s.special_action == 1) & (s.cur_time - g.last_fire_time >= PLAYER_FIRE_DELAY)
        bf = default_fields(s.ents.x[:, 0], s.ents.y[:, 0], vx * g.ball_vscale,
                            vy * g.ball_vscale, g.ball_r, g.ball_r, PLAYER_BALL)
        bf["collides_with_entities"] = True
        bf["expire_time"] = 50
        bf["vrot"] = BALL_V_ROT
        s = s.replace(
            ents=s.ents.push(bf, do=fire),
            game=g.replace(last_fire_time=torch.where(fire, s.cur_time, g.last_fire_time)),
        )

        # the enemies, in the reference's descending slot order with draws
        # only where a slot redraws or fires (dodgeball.cpp:398-443).  Each
        # iteration reads the state before the loop and writes its own slot
        # (its balls land above the loop's bound), so the draws sit at the
        # offsets of a prefix sum over descending slots, one peek.
        e = s.ents
        cap = e.cap
        slots = torch.arange(cap, device=dev)[None, :]
        exists = slots < e.count[:, None]
        is_en = exists & (e.type == ENEMY)
        redraw = is_en & (e.spawn_time == 0)
        can_fire = is_en & (per_env(s.cur_time, e.x) - e.fire_time >= self.ENEMY_FIRE_DELAY)
        x0, y0 = e.x[:, :1], e.y[:, :1]
        bvelx = torch.where(e.x < x0, 1.0, -1.0)
        bvely = torch.where(e.y < y0, 1.0, -1.0)
        fire_v = can_fire & (torch.abs(e.x - x0) < 1)
        fire_h = can_fire & ~fire_v & (torch.abs(e.y - y0) < 1)
        fired = fire_v | fire_h

        cnt = 3 * redraw.to(i32) + fired.to(i32)
        start = cnt.flip(1).cumsum(1).flip(1) - cnt  # the draws of the slots above
        words = d.peek_at(torch.stack(
            [start, start + 1, start + 2, start + 3 * redraw.to(i32)], dim=1))
        d = d.replace(cursor=d.cursor + cnt.sum(dim=1, dtype=i32))
        v0 = torch.remainder(words[:, 0], 2).to(i32)
        axis0 = torch.remainder(words[:, 1], 2).to(i32)
        sp0 = torch.remainder(words[:, 2], 50).to(i32)
        ft0 = torch.remainder(words[:, 3], 4).to(i32)

        vel = ENEMY_VEL * (v0 * 2 - 1).to(f32)
        nvx = torch.where(redraw, torch.where(axis0 == 0, vel, 0.0), e.vx)
        nvy = torch.where(redraw, torch.where(axis0 == 0, 0.0, vel), e.vy)
        nsp = torch.where(redraw, sp0 + 25,
                          torch.where(is_en, e.spawn_time - 1, e.spawn_time))
        nvx = torch.where(fire_v, 0.0, torch.where(fire_h, bvelx * ENEMY_VEL, nvx))
        nvy = torch.where(fire_v, bvely * ENEMY_VEL, torch.where(fire_h, 0.0, nvy))
        nrot = torch.where((nvx != 0) | (nvy != 0), -libm.atan2f(nvy, nvx), e.rotation)
        nft = torch.where(fired, per_env(s.cur_time, e.x) + ft0, e.fire_time)

        # the enemies' balls, pushed in the loop's (descending slot) order
        g = s.game
        ballf = default_fields(
            e.x.flip(1), e.y.flip(1),
            torch.where(fire_v, 0.0, bvelx).flip(1) * g.ball_vscale[:, None],
            torch.where(fire_v, bvely, 0.0).flip(1) * g.ball_vscale[:, None],
            g.ball_r[:, None], g.ball_r[:, None], ENEMY_BALL)
        ballf["vrot"] = BALL_V_ROT
        ballf["expire_time"] = 50
        e2 = e.push_many(ballf, fired.flip(1))

        # balls past the border erase (cpp:434-440); the loop's bound
        # leaves out the balls pushed this step
        is_ball = exists & ((e.type == PLAYER_BALL) | (e.type == ENEMY_BALL))
        w = s.main_width.to(f32)[:, None]
        oob = (e.x < e.rx) | (e.x > w - e.rx) | (e.y < e.ry) | (e.y > w - e.ry)
        e2 = e2.replace(
            vx=torch.where(is_en, nvx, e2.vx),
            vy=torch.where(is_en, nvy, e2.vy),
            spawn_time=torch.where(is_en, nsp, e2.spawn_time),
            rotation=torch.where(is_en, nrot, e2.rotation),
            fire_time=torch.where(is_en, nft, e2.fire_time),
            will_erase=e2.will_erase | (is_ball & oob),
        )
        num_enemies = (e2.active & (e2.type == ENEMY) & ~e2.will_erase).sum(dim=1, dtype=i32)
        s = s.replace(ents=e2, game=g.replace(num_enemies=num_enemies))
        return self.erase_if_needed(s), d


def _blockers(e):
    """``reposition``'s blockers: the live slots that do not avoid
    collisions, and the agent."""
    slot0 = torch.arange(e.cap, device=e.x.device)[None, :] == 0
    return [(e.x, e.y, e.rx, e.ry, e.active & (slot0 | ~e.avoids_collisions))]

