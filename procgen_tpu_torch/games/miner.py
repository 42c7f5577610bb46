"""Miner (BoulderDash): dig dirt, collect diamonds (+1), exit when all are
collected (+10); falling boulders kill.  Reference:
procgen/src/games/miner.cpp; JAX counterpart procgen_tpu/games/miner.py.

The cell-automaton gravity sweep is order-exact: cells are visited in
ascending (y, x) order, split around the agent's row (objects at or below
the agent move before the agent, those above after it, miner.cpp:246-249),
with the C++ operator-precedence quirk that lets boulders cascade within a
sweep.  The JAX package scans the cells inside one program; here the scan
is a Python loop over the cells whose body is batched over the envs on a
flat ``[N, dim*dim]`` grid and reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import rng
from ..core.constants import EASY_MODE, HARD_MODE, MEMORY_MODE, PLAYER, SPACE
from ..core.entities import default_fields
from ..core.game import BasicAbstractGame, BasicState, first_true, tree_where
from .registry import register

i32 = torch.int32
f32 = torch.float32

COMPLETION_BONUS = 10.0
DIAMOND_REWARD = 1.0

BOULDER = 1
DIAMOND = 2
MOVING_BOULDER = 3
MOVING_DIAMOND = 4
ENEMY = 5
EXIT = 6
DIRT = 9
MUD = 11
DEAD_PLAYER = 12
OOB_WALL = 10


def _stationary(t):
    return torch.where(
        t == MOVING_DIAMOND, DIAMOND, torch.where(t == MOVING_BOULDER, BOULDER, t)
    )


@dataclasses.dataclass
class MinerState:
    diamonds_remaining: torch.Tensor  # int32 [N]
    died: torch.Tensor  # bool [N]

    def replace(self, **kw) -> "MinerState":
        return dataclasses.replace(self, **kw)


@register("miner")
class Miner(BasicAbstractGame):
    name = "miner"
    ENT_CAP = 2  # agent + exit
    ENT_Z_LEVELS = (-1, 0, 1)  # the exit renders under the grid (render_z=-1)
    DISPATCH_VECTORIZED = True  # handlers commute (exit bonus, enemy death)
    MAX_STEP_DRAWS = 4
    MAX_SUB_STEPS = 1  # grid_step

    def __init__(self, options):
        super().__init__(options)
        self.mixrate = 0.5
        self.maxspeed = 0.5
        self.has_useful_vel_info = False
        self.out_of_bounds_object = OOB_WALL
        self.visibility = 8.0
        self.grid_step = True
        self.center_agent = options.distribution_mode == MEMORY_MODE

        mode = options.distribution_mode
        if mode == EASY_MODE:
            dim = 10
        elif mode == HARD_MODE:
            dim = 20
        elif mode == MEMORY_MODE:
            dim = 35
        else:
            raise ValueError(f"miner does not support distribution_mode {mode}")
        self.world_dim = dim
        self.WORLD_DIM_MAX = (dim, dim)

    def background_names(self):
        from ..render.assets import CAVES

        return CAVES

    def asset_for_type(self, type_):
        # miner.cpp:47-66
        return {
            PLAYER: ["misc_assets/robot_greenDrive1.png"],
            DEAD_PLAYER: ["misc_assets/fire_1.png"],
            BOULDER: ["misc_assets/elementStone007.png"],
            DIAMOND: ["misc_assets/gemBlue.png"],
            EXIT: ["misc_assets/window.png"],
            DIRT: ["misc_assets/dirt.png"],
            MUD: ["misc_assets/mud.png"],
            OOB_WALL: ["misc_assets/tile_bricksGrey.png"],
        }.get(type_, [])

    def game_init_state(self, n, device):
        return MinerState(
            diamonds_remaining=torch.full((n,), -1, dtype=i32, device=device),
            died=torch.zeros((n,), dtype=torch.bool, device=device),
        )

    def choose_world_dim(self, s: BasicState) -> BasicState:
        return s.replace(
            main_width=torch.full_like(s.main_width, self.world_dim),
            main_height=torch.full_like(s.main_height, self.world_dim),
        )

    # -- physics hooks ------------------------------------------------------

    def is_blocked(self, s, src_type, target_type, is_horizontal):
        b = super().is_blocked(s, src_type, target_type, is_horizontal)
        return b | (
            (src_type == PLAYER)
            & (
                (target_type == BOULDER)
                | (target_type == MOVING_BOULDER)
                | (target_type == OOB_WALL)
            )
        )

    def will_reflect(self, src_type, target_type):
        return (src_type == ENEMY) & (
            (target_type == BOULDER)
            | (target_type == DIAMOND)
            | (target_type == MOVING_BOULDER)
            | (target_type == MOVING_DIAMOND)
            | (target_type == self.out_of_bounds_object)
        )

    def set_action_xy(self, s: BasicState, move_action) -> BasicState:
        s = super().set_action_xy(s, move_action)
        return s.replace(
            action_vy=torch.where(s.action_vx != 0, 0.0, s.action_vy)
        )

    def handle_agent_collision_vec(self, s, d, hit):
        # miner.cpp:84-95
        e = s.ents
        enemy = (hit & (e.type == ENEMY)).any(dim=1)
        exit_done = (hit & (e.type == EXIT)).any(dim=1) & (
            s.game.diamonds_remaining == 0
        )
        return s.replace(
            done=s.done | enemy | exit_done,
            reward=s.reward + torch.where(exit_done, COMPLETION_BONUS, 0.0),
            level_complete=s.level_complete | exit_done,
        ), d

    def image_for_type(self, s, type_):
        out = torch.abs(type_)
        out = torch.where(type_ == MOVING_BOULDER, BOULDER, out)
        return torch.where(type_ == MOVING_DIAMOND, DIAMOND, out)

    def should_draw_entity_mask(self, s):
        m = torch.ones_like(s.ents.will_erase, dtype=torch.bool)
        m[:, 0] = ~s.game.died
        return m

    # -- reset --------------------------------------------------------------

    def game_reset(self, s: BasicState) -> BasicState:
        s = self.game_reset_base(s)
        dim = self.world_dim
        area = dim * dim
        n = s.num
        dev = s.grid.device

        s = s.replace(
            ents=s.ents.set_fields(0, rx=0.5, ry=0.5),
            game=self.game_init_state(n, dev),
        )

        num_diamonds = int(12 / 400.0 * area)
        num_boulders = int(80 / 400.0 * area)
        num_mud = int(12 / 400.0 * area)
        k = num_diamonds + num_boulders + num_mud + 1

        g, picks = rng.simple_choose(s.rand_gen, area, k, k, area)
        s = s.replace(rand_gen=g)

        agent_cell = picks[:, 0]
        ax = torch.remainder(agent_cell, dim)
        ay = torch.div(agent_cell, dim, rounding_mode="floor")
        s = s.replace(
            ents=s.ents.set_fields(0, x=ax.to(f32) + 0.5, y=ay.to(f32) + 0.5)
        )

        # all DIRT, then scatter diamonds/boulders/mud (miner.cpp:168-188)
        vals = torch.tensor(
            [DIAMOND] * num_diamonds + [BOULDER] * num_boulders + [MUD] * num_mud,
            dtype=i32, device=dev,
        )
        flat = torch.full((n, area), DIRT, dtype=i32, device=dev)
        flat.scatter_(1, picks[:, 1:].long(), vals.expand(n, -1))
        grid = flat.reshape(n, dim, dim)

        stale_dirt = grid == DIRT  # dirt_cells snapshot (miner.cpp:190)

        rows = torch.arange(n, device=dev)
        grid[rows, ay.long(), ax.long()] = SPACE
        # clear boulders in the agent's 3x3 neighbourhood (miner.cpp:196-203)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                ox = ax + di
                oy = ay + dj
                inb = (ox >= 0) & (ox < dim) & (oy >= 0) & (oy < dim)
                oxc = ox.clamp(0, dim - 1).long()
                oyc = oy.clamp(0, dim - 1).long()
                cur = grid[rows, oyc, oxc]
                grid[rows, oyc, oxc] = torch.where(inb & (cur == BOULDER), DIRT, cur)

        # exit: random stale-dirt cell whose above is DIRT or out-of-bounds
        # (checked against the *updated* grid, miner.cpp:205-218)
        above = torch.cat(
            [grid[:, 1:], torch.full((n, 1, dim), OOB_WALL, dtype=i32, device=dev)],
            dim=1,
        )
        cand = stale_dirt & ((above == DIRT) | (above == OOB_WALL))
        cand_flat = cand.reshape(n, area)
        count = cand_flat.sum(dim=1).to(i32)
        # count == 0 draws a word all the same and picks cell 0, as the
        # JAX package's clamped modulus and argmax do
        g, r = rng.randn(s.rand_gen, count)
        s = s.replace(rand_gen=g)
        ranks = torch.cumsum(cand_flat.to(i32), dim=1) - 1
        exit_cell = first_true(cand_flat & (ranks == r[:, None]))
        ex = torch.remainder(exit_cell, dim)
        ey = torch.div(exit_cell, dim, rounding_mode="floor")
        grid[rows, ey.long(), ex.long()] = SPACE
        f = default_fields(
            ex.to(f32) + 0.5, ey.to(f32) + 0.5, 0.0, 0.0, 0.5, 0.5, EXIT
        )
        f["render_z"] = -1
        return s.replace(grid=grid, ents=s.ents.push(f))

    # -- CA gravity sweep ---------------------------------------------------

    def _move_cells(self, s: BasicState, grid, has_moved, died, y_lo, y_hi):
        """move_cell over the cells with y in [y_lo, y_hi) ([N] bounds), in
        ascending (y, x) order (miner.cpp:296-346).  ``grid`` is int32
        [N, dim, dim], ``has_moved`` bool [N, dim*dim]; both are copied,
        then updated in place.  Returns (grid, has_moved, died).

        Cells are Python ints, so every neighbour read is a column of the
        flat grid and a neighbour outside the grid is OOB_WALL.  The JAX
        package clips such an index and writes the cell's own value back;
        those writes always carry a false condition, so they are skipped,
        and the two writes to one cell (which have disjoint conditions)
        are merged.  Types 1-4 are exactly the round ones (boulders and
        diamonds, still or moving), so range tests replace the type
        chains."""
        dim = self.world_dim
        area = dim * dim
        n = s.num
        dev = grid.device
        g = grid.reshape(n, area).clone()
        moved = has_moved.clone()
        cells = torch.arange(area, device=dev)
        not_agent = cells[None, :] != self.get_agent_index(s)[:, None]
        ys = torch.arange(dim, device=dev)[None, :]
        band = (ys >= torch.as_tensor(y_lo, device=dev).reshape(-1, 1)) & (
            ys < torch.as_tensor(y_hi, device=dev).reshape(-1, 1)
        )
        band = band.expand(n, dim)
        oob = torch.full((n,), OOB_WALL, dtype=i32, device=dev)
        no = torch.zeros((n,), dtype=torch.bool, device=dev)

        def gobj(i):
            return g[:, i] if 0 <= i < area else oob

        def is_free(i):
            return (g[:, i] == SPACE) & not_agent[:, i] if 0 <= i < area else no

        for idx in range(area):
            y, x = divmod(idx, dim)
            obj = g[:, idx]
            mv = (obj >= MOVING_BOULDER) & (obj <= MOVING_DIAMOND)
            stat = torch.where(mv, obj - 2, obj)
            # C++ precedence quirk: boulders ignore has_moved (miner.cpp:307)
            active = band[:, y] & (
                (stat == BOULDER) | ((stat == DIAMOND) & ~moved[:, idx])
            )

            below = idx - dim
            below_obj = gobj(below)
            agent_below = ~not_agent[:, below] if below >= 0 else no

            # 1) fall; an active cell is a boulder or a diamond, so its
            # moving type is stat + 2
            fall = active & (below_obj == SPACE) & ~agent_below
            fall_type = torch.where(gobj(below - dim) == SPACE, stat + 2, stat)
            # 2) crush the agent
            crush = active & agent_below & mv
            # 3) roll left / 4) roll right
            rest = active & ~fall & ~crush
            roll_base = rest & (below_obj >= BOULDER) & (below_obj <= MOVING_DIAMOND)
            roll_l = (roll_base & is_free(idx - 1) & is_free(idx - dim - 1)
                      if x > 0 else no)
            roll_r = (roll_base & ~roll_l & is_free(idx + 1) & is_free(idx - dim + 1)
                      if x < dim - 1 else no)
            # 5) settle
            leave = fall | roll_l | roll_r
            settle = rest & ~(roll_l | roll_r)

            if below >= 0:
                g[:, below] = torch.where(
                    fall, fall_type, torch.where(crush, DEAD_PLAYER, below_obj))
                moved[:, below] |= fall
            if x > 0:
                g[:, idx - 1] = torch.where(roll_l, stat, g[:, idx - 1])
                moved[:, idx - 1] |= roll_l
            if x < dim - 1:
                g[:, idx + 1] = torch.where(roll_r, stat, g[:, idx + 1])
                moved[:, idx + 1] |= roll_r
            g[:, idx] = torch.where(leave, SPACE, torch.where(settle, stat, obj))
            died = died | crush
        return g.reshape(n, dim, dim), moved, died

    def game_step(self, s: BasicState, d):
        dim = self.world_dim
        has_moved = torch.zeros((s.num, dim * dim), dtype=torch.bool,
                                device=s.grid.device)

        # phase 1: cells with y <= agent.y (miner.cpp:246-250)
        y_hi1 = torch.floor(s.ents.y[:, 0]).to(i32) + 1
        grid, has_moved, died1 = self._move_cells(
            s, s.grid, has_moved, s.game.died, 0, y_hi1
        )
        s = s.replace(grid=grid, game=s.game.replace(died=died1))

        pre_agent = {k: getattr(s.ents, k)[:, 0] for k in ("x", "y", "vx", "vy")}
        s, d = self.game_step_base(s, d)
        died = s.game.died

        # C++ returns right after the base step when died (miner.cpp:253-256):
        # the agent was erased, so undo its movement and stop here.
        s_dead = s.replace(
            ents=s.ents.set_fields(0, **pre_agent),
            done=torch.ones_like(s.done),
        )

        # live path continues:
        refl = torch.where(
            s.action_vx > 0,
            False,
            torch.where(s.action_vx < 0, True, s.ents.is_reflected[:, 0]),
        )
        s = s.replace(ents=s.ents.set_fields(0, is_reflected=refl))

        s, has_moved = self._handle_push2(s, has_moved)

        ix = s.ents.x[:, 0].to(i32)
        iy = s.ents.y[:, 0].to(i32)
        agent_obj = _stationary(self.get_obj(s, ix, iy))
        got_diamond = agent_obj == DIAMOND
        digs = (agent_obj == DIRT) | (agent_obj == MUD) | got_diamond
        s = s.replace(
            reward=s.reward + torch.where(got_diamond, DIAMOND_REWARD, 0.0),
            grid=torch.where(
                digs[:, None, None], self.set_obj(s, ix, iy, SPACE).grid, s.grid
            ),
        )

        # phase 2: cells with y > agent.y (miner.cpp:267-271)
        y_lo2 = torch.floor(s.ents.y[:, 0]).to(i32) + 1
        grid, has_moved, died2 = self._move_cells(
            s, s.grid, has_moved, s.game.died, y_lo2, dim
        )
        s = s.replace(grid=grid, game=s.game.replace(died=died2))

        remaining = (
            self.cells_with_type_mask(s, DIAMOND)
            | self.cells_with_type_mask(s, MOVING_DIAMOND)
        ).sum(dim=(1, 2)).to(i32)
        s = s.replace(game=s.game.replace(diamonds_remaining=remaining))

        s = tree_where(died, s_dead, s)
        return s, d

    def _handle_push2(self, s: BasicState, has_moved):
        """miner.cpp:272-287, exact if/else-if structure."""
        dim = self.world_dim
        area = dim * dim
        n = s.num
        agent_idx = self.get_agent_index(s)
        agentx = torch.remainder(agent_idx, dim)
        e = s.ents
        flat = s.grid.reshape(n, area).clone()

        def clip(idx):
            return idx.clamp(0, area - 1).long()[:, None]

        def read(t, idx):
            return t.gather(1, clip(idx))[:, 0]

        def write(t, idx, new):
            t.scatter_(1, clip(idx), new[:, None])

        def gobj(idx):
            inb = (idx >= 0) & (idx < area)
            return torch.where(inb, read(flat, idx), OOB_WALL)

        push_r = (
            (s.action_vx == 1)
            & (e.vx[:, 0] == 0)
            & (agentx < dim - 2)
            & (gobj(agent_idx + 1) == BOULDER)
            & (gobj(agent_idx + 2) == SPACE)
        )
        push_l = (
            ~push_r
            & (s.action_vx == -1)
            & (e.vx[:, 0] == 0)
            & (agentx > 1)
            & (gobj(agent_idx - 1) == BOULDER)
            & (gobj(agent_idx - 2) == SPACE)
        )

        # sequential clipped writes; where the condition is false a write
        # puts the cell's own value back, as in the JAX package
        write(flat, agent_idx + 1, torch.where(push_r, SPACE, read(flat, agent_idx + 1)))
        write(flat, agent_idx + 2, torch.where(push_r, BOULDER, read(flat, agent_idx + 2)))
        write(flat, agent_idx - 1, torch.where(push_l, SPACE, read(flat, agent_idx - 1)))
        write(flat, agent_idx - 2, torch.where(push_l, BOULDER, read(flat, agent_idx - 2)))
        has_moved = has_moved.clone()
        write(has_moved, agent_idx + 2, read(has_moved, agent_idx + 2) | push_r)
        write(has_moved, agent_idx - 2, read(has_moved, agent_idx - 2) | push_l)
        dx = torch.where(push_r, 1.0, torch.where(push_l, -1.0, 0.0))
        return (
            s.replace(
                grid=flat.reshape(s.grid.shape),
                ents=e.set_fields(0, x=e.x[:, 0] + dx),
            ),
            has_moved,
        )

    # -- latent state (miner.cpp:368-449) ------------------------------------

    def _exit_slot(self, e):
        return first_true(e.active & (e.type == EXIT))

    def latent_info(self, s: BasicState):
        e = s.ents
        slot = self._exit_slot(e)[:, None].long()
        return {
            "grid_size": torch.stack([s.main_width, s.main_height], dim=1),
            "grid": s.grid.reshape(s.grid.shape[0], -1),
            "agent_pos": torch.stack(
                [e.x[:, 0].to(i32), e.y[:, 0].to(i32)], dim=1
            ),
            "exit_pos": torch.stack(
                [e.x.gather(1, slot)[:, 0].to(i32),
                 e.y.gather(1, slot)[:, 0].to(i32)], dim=1
            ),
        }

    def set_latent_state(self, s: BasicState, latent) -> BasicState:
        """game_set_state (miner.cpp:423-449): overwrite grid, agent and exit
        positions from latent tensors with a leading ``[N]`` axis
        (``grid`` [N, dim*dim], ``agent_pos`` / ``exit_pos`` [N, 2])."""
        n = s.num
        dev = s.grid.device
        dim = self.world_dim
        grid = torch.as_tensor(latent["grid"], device=dev).to(i32).reshape(n, dim, dim)
        died = (grid == DEAD_PLAYER).reshape(n, -1).any(dim=1)
        apos = torch.as_tensor(latent["agent_pos"], device=dev)
        e = s.ents.set_fields_where(
            0, ~died, x=apos[:, 0].to(f32) + 0.5, y=apos[:, 1].to(f32) + 0.5
        )
        epos = torch.as_tensor(latent["exit_pos"], device=dev)
        at_exit = (
            torch.arange(e.cap, device=dev)[None, :] == self._exit_slot(e)[:, None]
        )
        e = e.replace(
            x=torch.where(at_exit, epos[:, :1].to(f32) + 0.5, e.x),
            y=torch.where(at_exit, epos[:, 1:].to(f32) + 0.5, e.y),
        )
        return s.replace(grid=grid, ents=e, game=s.game.replace(died=died))
