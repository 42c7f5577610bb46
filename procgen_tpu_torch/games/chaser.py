"""Chaser (Pac-Man): eat the orbs (+0.04 each); a large orb makes the
enemies edible for a while; clearing every orb gives +10.  Reference:
procgen/src/games/chaser.cpp; JAX counterpart procgen_tpu/games/chaser.py.

The level is a Kruskal maze without dead ends (``levelgen.maze.
generate_maze_no_dead_ends``) filling the world, under the static camera
(chaser.cpp:161).  The small orbs are grid cells drawn as green squares of
0.3 of a cell (``grid_cell_colors``/``grid_cell_inset``); the large orbs,
the eggs and the enemies are entities.  The reset's rejection picks
(``rng.simple_choose``) run as masked rounds over the envs, one host read
a round.  The enemies' junction AI (chaser.cpp:291-345) runs over every slot
at once; the agent's collisions take the sequential reverse scan
(``dispatch_sequential``): a large orb eaten by a higher slot makes the
enemies below it edible the same step.  Every function works on the whole
batch: per-env values are ``[N]`` tensors, per-slot values ``[N, cap]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import rng
from ..core.constants import EASY_MODE, EXTREME_MODE, HARD_MODE, PLAYER, SPACE, WALL_OBJ
from ..core.entities import default_fields, stack_records
from ..core.game import BasicAbstractGame, BasicState, first_true, per_env
from ..levelgen import maze as mazegen
from .registry import register

i32 = torch.int32
f32 = torch.float32

ORB_REWARD = 0.04
COMPLETION_BONUS = 10.0
ORB_DIM = 0.3

LARGE_ORB = 2
ENEMY_WEAK = 3
ENEMY_EGG = 4
MAZE_WALL = 5
ENEMY = 6
ENEMY2 = 7
ENEMY3 = 8

MARKER = 1001
ORB = 1002

EAT_TIMEOUT = 75
EGG_TIMEOUT = 50

# the four neighbours in get_adjacent's order (chaser.cpp:300-310)
ADJACENT = ((-1, 0), (0, -1), (0, 1), (1, 0))


@dataclasses.dataclass
class ChaserState:
    eat_time: torch.Tensor  # int32 [N]
    total_orbs: torch.Tensor  # int32 [N]
    orbs_collected: torch.Tensor  # int32 [N]

    def replace(self, **kw) -> "ChaserState":
        return dataclasses.replace(self, **kw)


@register("chaser")
class Chaser(BasicAbstractGame):
    name = "chaser"
    ENT_CAP = 16
    MAX_STEP_DRAWS = 4
    MAX_SUB_STEPS = 4
    ONLY_AGENT_SMART = False  # the enemies
    SMART_VECTORIZABLE = True
    MAX_SMART = 8

    def __init__(self, options):
        super().__init__(options)
        self.mixrate = 1.0
        self.maxspeed = 0.5
        self.has_useful_vel_info = False
        self.center_agent = False  # forced (chaser.cpp:161)

        mode = options.distribution_mode
        if mode == EASY_MODE:
            self.maze_dim, self.total_enemies, self.extra_orb_sign = 11, 3, 0
        elif mode == HARD_MODE:
            self.maze_dim, self.total_enemies, self.extra_orb_sign = 13, 3, -1
        elif mode == EXTREME_MODE:
            self.maze_dim, self.total_enemies, self.extra_orb_sign = 19, 5, 1
        else:
            raise ValueError(f"chaser does not support distribution_mode {mode}")
        self.WORLD_DIM_MAX = (self.maze_dim, self.maze_dim)

    def background_names(self):
        from ..render.assets import TOPDOWN_SIMPLE_BACKGROUNDS

        return TOPDOWN_SIMPLE_BACKGROUNDS

    def asset_for_type(self, type_):
        # chaser.cpp:54-72
        return {
            PLAYER: ["misc_assets/enemyFloating_1b.png"],
            ENEMY: ["misc_assets/enemyFlying_1.png"],
            ENEMY2: ["misc_assets/enemyFlying_2.png"],
            ENEMY3: ["misc_assets/enemyFlying_3.png"],
            LARGE_ORB: ["misc_assets/yellowCrystal.png"],
            ENEMY_WEAK: ["misc_assets/enemyWalking_1b.png"],
            ENEMY_EGG: ["misc_assets/enemySpikey_1b.png"],
            MAZE_WALL: ["misc_assets/tileStone_slope.png"],
        }.get(type_, [])

    def use_block_asset(self, type_):
        return type_ == MAZE_WALL

    def game_init_state(self, n, device):
        def z():
            return torch.zeros((n,), dtype=i32, device=device)

        return ChaserState(eat_time=z(), total_orbs=z(), orbs_collected=z())

    def choose_world_dim(self, s):
        return s.replace(main_width=torch.full_like(s.main_width, self.maze_dim),
                         main_height=torch.full_like(s.main_height, self.maze_dim))

    # -- hooks ----------------------------------------------------------------

    def _can_eat(self, s):
        return s.cur_time - s.game.eat_time < EAT_TIMEOUT

    def update_agent_velocity(self, s):
        # chaser.cpp:79-88: the agent keeps moving at full speed
        e = s.ents
        vx = torch.where(s.action_vx != 0, s.maxspeed * s.action_vx, e.vx[:, 0])
        vy = torch.where(s.action_vy != 0, s.maxspeed * s.action_vy, e.vy[:, 0])
        return s.replace(ents=e.set_fields(0, vx=torch.sign(vx) * s.maxspeed,
                                           vy=torch.sign(vy) * s.maxspeed))

    def is_blocked(self, s, src_type, target_type, is_horizontal):
        return (target_type == MAZE_WALL) | super().is_blocked(
            s, src_type, target_type, is_horizontal)

    def image_for_type(self, s, type_):
        # chaser.cpp:100-112: the enemies flap, or go weak while edible
        rem = torch.remainder(torch.div(s.cur_time, 2, rounding_mode="floor"), 4)
        rem = torch.where(rem == 3, 1, rem)
        enemy_img = torch.where(self._can_eat(s), ENEMY_WEAK, ENEMY + rem)
        out = torch.where(type_ == ENEMY, per_env(enemy_img, type_), torch.abs(type_))
        return out.to(i32)

    def grid_cell_colors(self, s, gtype, u, v):
        """The small orbs: green, on the central 0.3 x 0.3 of their cell
        (chaser.cpp:114-120); ``u``/``v`` the pixel's fraction of its cell."""
        valid, r, g, b = super().grid_cell_colors(s, gtype, u, v)
        is_orb = gtype == ORB
        central = (torch.abs(u - 0.5) < ORB_DIM / 2) & (torch.abs(v - 0.5) < ORB_DIM / 2)
        return (torch.where(is_orb, central, valid), torch.where(is_orb, 0, r),
                torch.where(is_orb, 255, g), torch.where(is_orb, 0, b))

    def grid_cell_inset(self, s, gtype):
        # the orb's centred square in the frame kernel's inset model
        return torch.where(gtype == ORB, ORB_DIM, 2.0).to(f32)

    def handle_agent_collision(self, s, d, i: int):
        """chaser.cpp:122-137: a large orb makes the enemies edible; an
        enemy is eaten while they are, else it kills."""
        e = s.ents
        t = e.type[:, i]
        large = t == LARGE_ORB
        enemy = t == ENEMY
        can_eat = self._can_eat(s)
        g = s.game
        return s.replace(
            game=g.replace(eat_time=torch.where(large, s.cur_time, g.eat_time)),
            reward=s.reward + torch.where(large, ORB_REWARD, 0.0),
            ents=e.set_fields_where(i, large | (enemy & can_eat), will_erase=True),
            done=s.done | (enemy & ~can_eat),
        ), d

    # -- reset ----------------------------------------------------------------

    def game_reset(self, s: BasicState) -> BasicState:
        dim = self.maze_dim
        n = s.num
        dev = s.grid.device
        s = self.game_reset_base(s)
        s = s.replace(
            ents=s.ents.set_fields(0, rx=0.5, ry=0.5),
            game=ChaserState(
                eat_time=torch.full((n,), -EAT_TIMEOUT, dtype=i32, device=dev),
                total_orbs=torch.zeros((n,), dtype=i32, device=dev),
                orbs_collected=torch.zeros((n,), dtype=i32, device=dev),
            ),
        )
        g, mgrid, _, _, _ = mazegen.generate_maze_no_dead_ends(
            s.rand_gen, torch.full((n,), dim, dtype=i32, device=dev), dim)
        g, extra_quad = rng.randn(g, 4)

        # the maze fills the world, its walls as MAZE_WALL (chaser.cpp:185-200)
        adim = dim + 2
        pos = np.add.outer((np.arange(dim) + 1) * adim, np.arange(dim) + 1)
        world = mgrid[:, torch.as_tensor(pos.reshape(-1), device=dev)]
        world = torch.where(world == WALL_OBJ, MAZE_WALL, world)  # [N, dim*dim]
        space = world == SPACE

        # per-quadrant large orbs, the candidates listed column-major (x
        # outer), the C++ push order (chaser.cpp:190-199)
        xs = np.arange(dim * dim) // dim  # column-major position -> x
        ys = np.arange(dim * dim) % dim
        cell_of_cm = torch.as_tensor(ys * dim + xs, device=dev)  # -> row-major cell
        quad_cm = torch.as_tensor((xs >= dim / 2.0) * 2 + (ys >= dim / 2.0), device=dev)
        space_cm = space[:, cell_of_cm]
        recs, dos, cells = [], [], []
        for qi in range(4):
            num_orbs = 1 + torch.where(extra_quad == qi, self.extra_orb_sign, 0)
            cand = space_cm & (quad_cm == qi)
            ranks = torch.cumsum(cand.to(i32), dim=1) - 1
            g, sel = rng.simple_choose(g, cand.sum(dim=1, dtype=i32), 2, num_orbs, dim * dim)
            for j in range(2):
                cell = cell_of_cm[first_true(cand & (ranks == sel[:, j:j + 1]))]
                recs.append(default_fields(
                    torch.remainder(cell, dim).to(f32) + 0.5,
                    torch.div(cell, dim, rounding_mode="floor").to(f32) + 0.5,
                    0.0, 0.0, 0.4, 0.4, LARGE_ORB))
                dos.append(sel[:, j] >= 0)
                cells.append(cell)
        do = torch.stack(dos, dim=1)
        ents = s.ents.push_many(stack_records(recs, n, dev), do)
        # the large orbs' cells: MARKER, so that the agent and the eggs
        # avoid them, and SPACE in the end (a spare column takes the rest)
        wide = torch.cat([world, torch.zeros((n, 1), dtype=world.dtype, device=dev)], 1)
        wide.scatter_(1, torch.where(do, torch.stack(cells, 1), dim * dim).long(), MARKER)
        world = wide[:, :-1]

        # the agent and the eggs on the other SPACE cells, row-major
        space2 = world == SPACE
        count2 = space2.sum(dim=1, dtype=i32)
        ranks2 = torch.cumsum(space2.to(i32), dim=1) - 1
        k = 1 + self.total_enemies
        g, sel2 = rng.simple_choose(g, count2, k, k, dim * dim)
        picked = [first_true(space2 & (ranks2 == sel2[:, j:j + 1])) for j in range(k)]
        cx = [torch.remainder(c, dim).to(f32) + 0.5 for c in picked]
        cy = [torch.div(c, dim, rounding_mode="floor").to(f32) + 0.5 for c in picked]
        ents = ents.set_fields(0, x=cx[0], y=cy[0])
        eggs = []
        for ei in range(1, k):
            f = default_fields(cx[ei], cy[ei], 0.0, 0.0, 0.5, 0.5, ENEMY_EGG)
            f["health"] = float(EGG_TIMEOUT)
            eggs.append(f)
        ents = ents.push_many(stack_records(eggs, n, dev),
                              torch.ones((n, k - 1), dtype=torch.bool, device=dev))

        # every SPACE cell before the eggs' MARKERs becomes an orb, the
        # agent's and the eggs' cells included (the C++ counts the free
        # cells before it marks them, chaser.cpp:220-231; so their MARKERs
        # are not written here); the large orbs' MARKERs go back to SPACE
        world = torch.where(space2, ORB, world)
        world = torch.where(world == MARKER, SPACE, world)
        return s.replace(
            grid=world.reshape(n, dim, dim).to(i32),
            ents=ents,
            rand_gen=g,
            game=s.game.replace(total_orbs=count2),
        )

    # -- per-step -------------------------------------------------------------

    def game_step(self, s: BasicState, d):
        s, d = self.game_step_base(s, d)
        dim = self.maze_dim
        e = s.ents
        num_enemies = (e.active & ((e.type == ENEMY_EGG) | (e.type == ENEMY))).sum(dim=1)
        can_eat = self._can_eat(s)
        vscale = torch.where(can_eat, 0.25, 0.5)[:, None]

        # the eggs age and hatch at 0 (chaser.cpp:281-290)
        is_egg = e.active & (e.type == ENEMY_EGG)
        health = torch.where(is_egg, e.health - 1, e.health)
        hatch = is_egg & (health == 0)
        e = e.replace(health=health, will_erase=e.will_erase | hatch)

        # the enemies' junction AI (chaser.cpp:291-345), over every slot:
        # at a junction or standing, the next cell among the four that are
        # open and not the one it came from, the nearest to the agent (the
        # farthest while edible) half the time, the draw picking a tie
        ex = e.x - 0.5
        ey = e.y - 0.5
        is_enemy = e.active & (e.type == ENEMY)
        agent_idx = self.get_agent_index(s)
        ax = torch.remainder(agent_idx, s.main_width)[:, None, None]
        ay = torch.div(agent_idx, s.main_width, rounding_mode="floor")[:, None, None]
        junction = (torch.abs(ex - torch.round(ex)) + torch.abs(ey - torch.round(ey))) < 0.01
        trigger = is_enemy & (((e.vx == 0) & (e.vy == 0)) | junction)
        cx = torch.trunc(ex).to(i32)
        cy = torch.trunc(ey).to(i32)
        px = torch.trunc(ex - torch.sign(e.vx)).to(i32)
        py = torch.trunc(ey - torch.sign(e.vy)).to(i32)
        prev_valid = (px >= 0) & (px < dim) & (py >= 0) & (py < dim)
        prev_idx = torch.where(prev_valid, py * dim + px, -999)

        dist_scale = torch.where(can_eat, -1, 1)[:, None, None]
        sri = s.step_rand_int[:, None]
        be_aggressive = torch.remainder(sri, 2) == 0
        offs = torch.as_tensor(ADJACENT, dtype=i32, device=e.x.device)
        nx = cx[..., None] + offs[:, 0]  # [N, cap, 4]
        ny = cy[..., None] + offs[:, 1]
        inb = (nx >= 0) & (nx < dim) & (ny >= 0) & (ny < dim)
        valid = ((self.get_obj(s, nx, ny) != MAZE_WALL) & inb
                 & (ny * dim + nx != prev_idx[..., None]))
        md = (torch.abs(nx - ax) + torch.abs(ny - ay)) * dist_scale
        min_md = torch.where(valid, md, 2 * dim).amin(dim=2, keepdim=True)
        cands = torch.where(be_aggressive[..., None], valid & (md == min_md), valid)
        counts = cands.sum(dim=2, dtype=i32).clamp_min(1)
        pick = torch.remainder(sri, counts)
        cranks = torch.cumsum(cands.to(i32), dim=2) - 1
        sel = first_true(cands & (cranks == pick[..., None]))[..., None]
        new_vx = (nx.gather(2, sel)[..., 0].to(f32) - ex) * vscale
        new_vy = (ny.gather(2, sel)[..., 0].to(f32) - ey) * vscale
        s = s.replace(ents=e.replace(vx=torch.where(trigger, new_vx, e.vx),
                                     vy=torch.where(trigger, new_vy, e.vy)))

        # the hatched eggs become smart enemies, pushed from the highest
        # slot down (the reverse loop)
        f = default_fields(e.x.flip(1), e.y.flip(1), 0.0, 0.0, 0.5, 0.5, ENEMY)
        f["smart_step"] = True
        s = s.replace(ents=s.ents.push_many(f, hatch.flip(1)))

        # an egg respawns while the enemies are below quota (chaser.cpp:348-351),
        # on the free cell the step's draw picks, non-wall cells ascending
        free = (s.grid != MAZE_WALL).reshape(s.num, -1)
        ranks = torch.cumsum(free.to(i32), dim=1) - 1
        nfree = free.sum(dim=1, dtype=i32).clamp_min(1)
        cell = first_true(free & (ranks == torch.remainder(s.step_rand_int, nfree)[:, None]))
        f = default_fields(torch.remainder(cell, dim).to(f32) + 0.5,
                           torch.div(cell, dim, rounding_mode="floor").to(f32) + 0.5,
                           0.0, 0.0, 0.5, 0.5, ENEMY_EGG)
        f["health"] = float(EGG_TIMEOUT)
        s = s.replace(ents=s.ents.push(f, do=num_enemies < self.total_enemies))

        # orb pickup and the completion bonus (chaser.cpp:353-365)
        aidx = self.get_agent_index(s)
        aty = torch.div(aidx, s.main_width, rounding_mode="floor")
        atx = torch.remainder(aidx, s.main_width)
        on_orb = self.get_obj(s, atx, aty) == ORB
        s = self.set_obj_where(s, atx, aty, SPACE, on_orb)
        g = s.game
        collected = g.orbs_collected + on_orb.to(i32)
        complete = collected == g.total_orbs
        return s.replace(
            reward=s.reward + torch.where(on_orb, ORB_REWARD, 0.0)
            + torch.where(complete, COMPLETION_BONUS, 0.0),
            level_complete=s.level_complete | complete,
            done=s.done | complete,
            game=g.replace(orbs_collected=collected),
        ), d
