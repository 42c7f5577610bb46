"""Caveflyer: an Asteroids-style ship in a cave; the exit ship gives +10,
each destructible target +3; obstacles, enemies and targets kill.
Reference: procgen/src/games/caveflyer.cpp; JAX counterpart
procgen_tpu/games/caveflyer.py.

The ship turns (``action_vrot`` into the base engine's ``vrot`` mix) and
thrusts along its heading, dropping an exhaust puff into the decor pool;
its rotation is never wrapped, so its heading's cosine and sine go through
``core/libm.py`` (glibc's ``sincosf``, its large-argument reduction past
120 rad).  The reset: a random fill of ``dim * dim`` words, 4 CA rounds,
the biggest room (``levelgen.room``), the agent's and the goal's cells by
``rng.simple_choose``, the BFS path between them widened 4 rounds outside
memory mode, 4 more CA rounds that keep the path open, then
``3 * (free // 80)`` distinct free cells for the obstacles, targets and
enemies.  A step fires bullets along the heading, turns the enemies to
face their motion and explodes the bullets that hit a cave wall; bullets
against targets, obstacles, enemies and the goal dispatch as [N, cap, cap]
pair matrices.  Every function works on the whole batch: per-env values
are ``[N]`` tensors, per-slot values ``[N, cap]``.
"""

from __future__ import annotations

import math

import torch

from ..core import libm, rng
from ..core.constants import (
    EASY_MODE, EXPLOSION, HARD_MODE, MEMORY_MODE, PLAYER, SPACE, WALL_OBJ,
)
from ..core.entities import default_fields
from ..core.game import BasicAbstractGame, BasicState, first_true
from ..levelgen import room as roomgen
from .registry import register

i32 = torch.int32
f32 = torch.float32

GOAL_REWARD = 10.0
TARGET_REWARD = 3.0

GOAL = 1
OBSTACLE = 2
TARGET = 3
PLAYER_BULLET = 4
ENEMY = 5
CAVEWALL = 8
EXHAUST = 9

MARKER = 1003
PI = math.pi


HALF_PI = float(torch.tensor(PI / 2, dtype=f32))  # the C++ PI / 2, a float


def _plus_fifth(v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``f32(double(v) + double(p) * .2)``: ``v += p * .2`` of float ``v``
    and ``p`` with a double literal."""
    return (v.double() + p.double() * 0.2).float()


@register("caveflyer")
class Caveflyer(BasicAbstractGame):
    name = "caveflyer"
    MAX_STEP_DRAWS = 4
    MAX_SUB_STEPS = 8
    ONLY_AGENT_SMART = False  # the enemies drift as smart movers
    SMART_VECTORIZABLE = True
    MAX_SMART = 24  # the JAX package's bound on the movers stepped at once
    DISPATCH_VECTORIZED = True
    ANY_COLLIDES_WITH_ENTITIES = True
    DECOR_CAP = 32  # exhaust and explosions
    DECOR_TYPES = frozenset(range(54, 60)) | {EXHAUST}
    # the ship, its bullets and the exhaust turn by any angle
    # (caveflyer.cpp:267-296): ROT_BANK_K buckets each
    ARB_ROT_TYPES = (PLAYER, PLAYER_BULLET, EXHAUST)

    def __init__(self, options):
        super().__init__(options)
        self.mixrate = 0.9
        mode = options.distribution_mode
        if mode == EASY_MODE:
            dim = 30
        elif mode == HARD_MODE:
            dim = 40
        elif mode == MEMORY_MODE:
            dim = 60
        else:
            raise ValueError(f"caveflyer does not support mode {mode}")
        self.world_dim = dim
        self.WORLD_DIM_MAX = (dim, dim)
        # 3 * (free cells // 80) objects, the free cells at most the world
        self.MAX_OBJS = 3 * (dim * dim // 80)
        self.ENT_CAP = self.MAX_OBJS + 16  # + the agent, the goal, bullets
        self.out_of_bounds_object = CAVEWALL  # the steady-state value
        self.visibility = 10.0 if mode == EASY_MODE else 16.0

    def background_names(self):
        from ..render.assets import SPACE_BACKGROUNDS

        return SPACE_BACKGROUNDS

    def asset_for_type(self, type_):
        # caveflyer.cpp:36-55
        return {
            GOAL: ["misc_assets/ufoGreen2.png"],
            OBSTACLE: ["misc_assets/meteorBrown_big1.png"],
            TARGET: ["misc_assets/ufoRed2.png"],
            PLAYER_BULLET: ["misc_assets/laserBlue02.png"],
            ENEMY: ["misc_assets/enemyShipBlue4.png"],
            PLAYER: ["misc_assets/playerShip1_red.png"],
            CAVEWALL: ["misc_assets/groundA.png"],
            EXHAUST: ["misc_assets/towerDefense_tile295.png"],
        }.get(type_, [])

    def use_block_asset(self, type_):
        return type_ == CAVEWALL

    def choose_world_dim(self, s):
        return s.replace(main_width=torch.full_like(s.main_width, self.world_dim),
                         main_height=torch.full_like(s.main_height, self.world_dim))

    # -- physics ------------------------------------------------------------

    def is_blocked(self, s, src_type, target_type, is_horizontal):
        b = super().is_blocked(s, src_type, target_type, is_horizontal)
        return b | ((src_type == PLAYER) & (target_type == CAVEWALL))

    def will_reflect(self, src_type, target_type):
        return (src_type == ENEMY) & ((target_type == CAVEWALL)
                                      | (target_type == self.out_of_bounds_object))

    def update_agent_velocity(self, s):
        # caveflyer.cpp:72-79: thrust, not the mix toward a target velocity;
        # ``vx += mixrate * maxspeed * action_vx * .2`` takes the float
        # product, then ``* .2`` and the sum in double, rounded once
        e = s.ents
        vx = _plus_fifth(e.vx[:, 0], s.mixrate * s.maxspeed * s.action_vx)
        vy = _plus_fifth(e.vy[:, 0], s.mixrate * s.maxspeed * s.action_vy)
        s = s.replace(ents=e.set_fields(0, vx=vx, vy=vy))
        return self.decay_agent_velocity(s)

    def set_action_xy(self, s, move_action):
        # caveflyer.cpp:268-289: turn and thrust (a third backwards); an
        # exhaust puff behind the ship when it thrusts forward.  ``sin`` and
        # ``cos`` are C's double functions: the thrust and the puff's place
        # are double expressions, rounded once
        accel = (torch.remainder(move_action, 3) - 1).to(f32)
        accel = torch.where(accel < 0, accel * 0.33, accel)
        e = s.ents
        theta = -e.rotation[:, 0] + HALF_PI
        sin_d, cos_d = libm.sincos_f64(theta)
        rx0 = e.rx[:, 0]
        xf = default_fields((e.x[:, 0].double() - rx0.double() * cos_d).float(),
                            (e.y[:, 0].double() - e.ry[:, 0].double() * sin_d).float(),
                            0.0, 0.0, 0.5 * rx0, 0.5 * rx0, EXHAUST)
        xf["expire_time"] = 4
        xf["rotation"] = -theta - HALF_PI
        xf["grow_rate"] = 1.25
        xf["alpha_decay"] = 0.8
        return s.replace(
            decor=s.decor.push(xf, do=accel > 0),
            action_vy=(accel.double() * sin_d).float(),
            action_vx=(accel.double() * cos_d).float(),
            action_vrot=(torch.div(move_action, 3, rounding_mode="floor") - 1).to(f32),
        )

    # -- collisions ---------------------------------------------------------

    def handle_agent_collision_vec(self, s, d, hit):
        # caveflyer.cpp:57-70
        e = s.ents
        goal = (hit & (e.type == GOAL)).any(dim=1)
        lethal = (hit & ((e.type == OBSTACLE) | (e.type == ENEMY)
                         | (e.type == TARGET))).any(dim=1)
        return s.replace(
            done=s.done | goal | lethal,
            reward=s.reward + torch.where(goal, GOAL_REWARD, 0.0),
            level_complete=s.level_complete | goal,
        ), d

    def dispatch_entity_pairs(self, s, d):
        """Bullets against targets, obstacles, enemies and the goal
        (caveflyer.cpp:96-122) on [N, source, bullet] pair matrices: a
        target loses one health for each bullet over it (the C++ has no
        erase guard there) and dies at 0; a bullet erases once and its
        explosion takes the velocity of the highest source slot it hits
        (the reverse scan's first pair).  The explosions go into the decor
        pool in one push: for each slot a dead target's, then an erased
        bullet's; past the pool's cap they are dropped."""
        e = s.ents
        cap = e.cap
        slots = torch.arange(cap, device=e.x.device)
        is_bullet = e.active & (e.type == PLAYER_BULLET) & ~e.will_erase
        is_src = e.active & ~e.will_erase & (
            (e.type == TARGET) | (e.type == OBSTACLE) | (e.type == ENEMY)
            | (e.type == GOAL))
        a = lambda t: t[:, :, None]  # noqa: E731  the source axis
        b = lambda t: t[:, None, :]  # noqa: E731  the bullet axis
        dx = torch.abs(a(e.x) - b(e.x))
        dy = torch.abs(a(e.y) - b(e.y))
        overlap = ((dx < a(e.rx) + b(e.rx) + a(e.collision_margin))
                   & (dy < a(e.ry) + b(e.ry) + a(e.collision_margin)))
        pair = overlap & a(is_src) & b(is_bullet)

        # target damage: one per overlapping bullet
        is_target = e.type == TARGET
        nhits = pair.sum(dim=2).to(f32)
        new_health = e.health - torch.where(is_target, nhits, 0.0)
        target_dies = is_target & (new_health <= 0) & ~e.will_erase & (nhits > 0)
        s = s.replace(reward=s.reward + target_dies.sum(dim=1).to(f32) * TARGET_REWARD)

        # bullets: erased on any hit; the explosion's velocity is the
        # highest source slot's (0 for a bullet that hit nothing: its
        # record is masked off)
        bullet_hit = pair.any(dim=1)
        sw = torch.where(pair, slots[None, :, None], -1).amax(dim=1).clamp_min(0)
        s = s.replace(ents=e.replace(
            health=new_health, will_erase=e.will_erase | target_dies | bullet_hit))

        def inter(u, v):  # slot i's target record, then its bullet record
            return torch.stack([u.expand_as(e.x), v.expand_as(e.x)], dim=2).reshape(e.x.shape[0], -1)

        zero = torch.zeros_like(e.x)
        half_rx = 0.5 * e.rx
        f = default_fields(inter(e.x, e.x), inter(e.y, e.y),
                           inter(zero, e.vx.gather(1, sw)), inter(zero, e.vy.gather(1, sw)),
                           inter(half_rx, half_rx), inter(half_rx, half_rx), EXPLOSION)
        return s.replace(decor=s.decor.push_many(f, inter(target_dies, bullet_hit))), d

    # -- reset --------------------------------------------------------------

    def game_reset(self, s: BasicState) -> BasicState:
        s = self.game_reset_base(s)
        n = s.num
        dev = s.grid.device
        dim = self.world_dim
        A = dim * dim
        g = s.rand_gen

        # the random fill (caveflyer.cpp:139-147)
        g, rolls = rng.draw_n(g, A)
        grid = torch.where(rng._rand01_from(rolls) < 0.5, WALL_OBJ, SPACE)
        grid = grid.reshape(n, dim, dim).to(i32)
        for _ in range(4):
            grid = roomgen.ca_update(grid, WALL_OBJ, SPACE)

        best = roomgen.best_room_mask(grid, SPACE)
        grid = torch.where(best, SPACE, WALL_OBJ).to(i32)

        # the agent's and the goal's cells: simple_choose(free, 2) over the
        # free cells in ascending order
        flat_free = best.reshape(n, A)
        nfree = flat_free.sum(dim=1, dtype=i32).clamp_min(2)
        ranks = torch.cumsum(flat_free.to(i32), dim=1) - 1
        g, picks = rng.simple_choose(g, nfree, 2, 2, A)
        agent_cell = first_true(flat_free & (ranks == picks[:, 0:1]))
        goal_cell = first_true(flat_free & (ranks == picks[:, 1:2]))

        ents = s.ents.set_fields(
            0, x=torch.remainder(agent_cell, dim).to(f32) + 0.5,
            y=torch.div(agent_cell, dim, rounding_mode="floor").to(f32) + 0.5)
        gf = default_fields(torch.remainder(goal_cell, dim).to(f32) + 0.5,
                            torch.div(goal_cell, dim, rounding_mode="floor").to(f32) + 0.5,
                            0.0, 0.0, 0.5, 0.5, GOAL)
        gf["collides_with_entities"] = True
        ents = ents.push(gf)

        path = roomgen.bfs_path_mask(grid, SPACE, agent_cell, goal_cell)
        if self.options.distribution_mode != MEMORY_MODE:
            wide = roomgen.expand_mask(path, (grid == SPACE).reshape(n, A), 4, dim)
            grid = torch.where(wide.reshape(n, dim, dim), SPACE, WALL_OBJ).to(i32)

        # 4 CA rounds, the path carved again after each (caveflyer.cpp:201-207)
        path2 = path.reshape(n, dim, dim)
        for _ in range(4):
            grid = roomgen.ca_update(grid, WALL_OBJ, SPACE)
            grid = torch.where(path2, SPACE, grid).to(i32)

        # the path as MARKER, the walls as CAVEWALL; the free cells left
        grid = torch.where(path2, MARKER, grid)
        free2 = (grid == SPACE).reshape(n, A)
        grid = torch.where(grid == WALL_OBJ, CAVEWALL, grid)

        nfree2 = free2.sum(dim=1, dtype=i32)
        chunk = torch.div(nfree2, 80, rounding_mode="floor")
        num_objs = 3 * chunk
        g, sel = rng.simple_choose(g, nfree2.clamp_min(1), self.MAX_OBJS, num_objs, A)
        s = s.replace(ents=ents)
        s, g = self._place_objects(s, g, free2, sel, chunk)
        grid = torch.where(grid == MARKER, SPACE, grid)
        return s.replace(grid=grid.to(i32), rand_gen=g,
                         visibility=torch.full_like(s.visibility, self.visibility))

    def _place_objects(self, s, g, free2, sel, chunk):
        """The obstacles, targets and enemies on the picked cells ``sel``
        ([N, MAX_OBJS], -1 past each env's count): picks ``[0, chunk)``
        are obstacles, ``[chunk, 2 chunk)`` targets, the rest enemies
        (caveflyer.cpp:227-262).  Each enemy draws a speed, a sign and an
        axis; the enemies are the last picks, so the k-th enemy's three
        words are the stream's words 3k to 3k + 2, read from one window.
        Three batched pushes, one a kind, keep the C++ creation order.
        Returns (s, g)."""
        n, A = free2.shape
        dev = free2.device
        dim = self.world_dim
        K = self.MAX_OBJS
        # the cell of each pick: the free cell of that rank
        ranks2 = torch.cumsum(free2.to(i32), dim=1) - 1
        cell_of = torch.zeros((n, A + 1), dtype=torch.int64, device=dev)
        cell_of.scatter_(1, torch.where(free2, ranks2, A).long(),
                         torch.arange(A, device=dev).expand(n, A).contiguous())
        cell = cell_of.gather(1, sel.clamp_min(0).long())
        cx = torch.remainder(cell, dim).to(f32) + 0.5
        cy = torch.div(cell, dim, rounding_mode="floor").to(f32) + 0.5
        i = torch.arange(K, device=dev)[None, :]
        c = chunk[:, None]
        do = sel >= 0
        kind_obstacle = do & (i < c)
        kind_target = do & (i >= c) & (i < 2 * c)
        kind_enemy = do & (i >= 2 * c)

        # the enemies' draws: rand01 speed, randn(2) sign, rand01 axis
        n_words = 3 * (K // 3)
        g, words = rng.draw_n(g, n_words, 3 * chunk)
        at = (3 * (i - 2 * c)).clamp(0, n_words - 3)
        v01 = rng._rand01_from(words.gather(1, at))
        sgn = rng._randn_from(words.gather(1, at + 1), 2)
        axis01 = rng._rand01_from(words.gather(1, at + 2))
        # ``.1 * rand01() + .1`` in double, rounded once
        vel = (0.1 * v01.double() + 0.1).float() * (sgn * 2 - 1).to(f32)

        of = default_fields(cx, cy, 0.0, 0.0, 0.5, 0.5, OBSTACLE)
        of["collides_with_entities"] = True
        tf = default_fields(cx, cy, 0.0, 0.0, 0.5, 0.5, TARGET)
        tf["health"] = 5.0
        tf["collides_with_entities"] = True
        ef = default_fields(cx, cy, torch.where(axis01 < 0.5, vel, 0.0),
                            torch.where(axis01 < 0.5, 0.0, vel), 0.5, 0.5, ENEMY)
        ef["smart_step"] = True
        ef["collides_with_entities"] = True
        ents = s.ents
        for f, m in ((of, kind_obstacle), (tf, kind_target), (ef, kind_enemy)):
            ents = ents.push_many(f, m)
        return s.replace(ents=ents), g

    # -- per-step -----------------------------------------------------------

    def game_step(self, s: BasicState, d):
        s, d = self.game_step_base(s, d)
        e = s.ents

        # fire along the heading (caveflyer.cpp:293-301), C's double cos
        # and sin rounded to float
        theta = -e.rotation[:, 0] + HALF_PI
        sin_d, cos_d = libm.sincos_f64(theta)
        bf = default_fields(e.x[:, 0], e.y[:, 0], cos_d.float(), sin_d.float(), 0.1, 0.25,
                            PLAYER_BULLET)
        bf["expire_time"] = 10
        bf["rotation"] = e.rotation[:, 0]
        e = e.push(bf, do=s.special_action == 1)

        # the enemies face their motion (caveflyer.cpp:303-311): ``-1 *
        # atan2(vy, vx) - PI / 2`` with C's double atan2, rounded once
        is_enemy = e.active & (e.type == ENEMY)
        moving = (e.vx != 0) | (e.vy != 0)
        heading = (-libm.atan2_f64(e.vy, e.vx) - HALF_PI).float()
        rot = torch.where(is_enemy & moving, heading, e.rotation)
        e = e.replace(rotation=rot)

        # bullets explode on cave walls: any corner of the box in a wall
        # cell or outside the world (caveflyer.cpp:313-327)
        is_bullet = e.active & (e.type == PLAYER_BULLET)
        found_wall = torch.zeros_like(is_bullet)
        w = s.main_width[:, None]
        h = s.main_height[:, None]
        n = e.x.shape[0]
        flat = s.grid.reshape(n, -1)
        dim = self.world_dim
        for ci in (-1, 1):
            for cj in (-1, 1):
                px = e.x + e.rx * ci
                py = e.y + e.ry * cj
                fx = torch.floor(px).to(i32)
                fy = torch.floor(py).to(i32)
                neg = (px < 0) | (py < 0)
                inb = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
                cell = fy.clamp(0, dim - 1) * dim + fx.clamp(0, dim - 1)
                t2 = torch.where(neg | ~inb, self.out_of_bounds_object,
                                 flat.gather(1, cell.long()))
                found_wall = found_wall | (t2 == CAVEWALL)
        boom = is_bullet & found_wall
        f = default_fields(e.x, e.y, 0.0, 0.0, 0.5 * e.rx, 0.5 * e.rx, EXPLOSION)
        s = s.replace(ents=e.replace(will_erase=e.will_erase | boom),
                      decor=s.decor.push_many(f, boom))

        # the trailing erase_if_needed (caveflyer.cpp:329)
        return self.erase_if_needed(s), d
