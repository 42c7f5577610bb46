"""Maze: navigate to the cheese (+10).  Reference: procgen/src/games/maze.cpp;
JAX counterpart procgen_tpu/games/maze.py.

Grid-quantised motion (grid_step), Kruskal level gen, latent state
(MazeState: grid + agent position, maze.cpp:144-188).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.constants import (
    EASY_MODE,
    HARD_MODE,
    MEMORY_MODE,
    SPACE,
    WALL_OBJ,
)
from ..core.game import BasicAbstractGame, BasicState, first_true
from ..levelgen import maze as mazegen
from .registry import register

i32 = torch.int32
f32 = torch.float32

REWARD = 10.0
GOAL = 2

EASY_GRID_SIZE = 15
HARD_GRID_SIZE = 25
MEMORY_GRID_SIZE = 31


@dataclasses.dataclass
class MazeGameState:
    maze_dim: torch.Tensor  # int32 [N]


@register("maze")
class Maze(BasicAbstractGame):
    name = "maze"
    ENT_CAP = 2
    DISPATCH_VECTORIZED = True  # no collision handlers
    MAX_STEP_DRAWS = 8
    MAX_SUB_STEPS = 1  # grid_step
    # the background, maze walls and cheese never change within an episode
    # as rendered, so the render prefix is composed once per level
    STATIC_RENDER_PREFIX = True

    def __init__(self, options):
        super().__init__(options)
        # maze.cpp:21-28
        self.timeout = 500
        self.random_agent_start = False
        self.has_useful_vel_info = False
        self.out_of_bounds_object = WALL_OBJ
        self.visibility = 8.0
        self.grid_step = True
        # maze.cpp:68: center_agent is forced to (mode == Memory)
        self.center_agent = options.distribution_mode == MEMORY_MODE

        mode = options.distribution_mode
        if mode == EASY_MODE:
            self.world_dim = EASY_GRID_SIZE
        elif mode == HARD_MODE:
            self.world_dim = HARD_GRID_SIZE
        elif mode == MEMORY_MODE:
            self.world_dim = MEMORY_GRID_SIZE
        else:
            raise ValueError(f"maze does not support distribution_mode {mode}")
        self.WORLD_DIM_MAX = (self.world_dim, self.world_dim)

    def background_names(self):
        # topdown_backgrounds (resources.cpp:914-926; maze.cpp:30-32)
        from ..render.assets import TOPDOWN_BACKGROUNDS

        return TOPDOWN_BACKGROUNDS

    def asset_for_type(self, type_):
        # maze.cpp:34-42
        if type_ == WALL_OBJ:
            return ["kenney/Ground/Sand/sandCenter.png"]
        if type_ == GOAL:
            return ["misc_assets/cheese.png"]
        if type_ == 0:  # PLAYER
            return ["kenney/Enemies/mouse_move.png"]
        return []

    def game_init_state(self, n, device):
        return MazeGameState(maze_dim=torch.zeros((n,), dtype=i32, device=device))

    def choose_world_dim(self, s: BasicState) -> BasicState:
        return s.replace(
            main_width=torch.full_like(s.main_width, self.world_dim),
            main_height=torch.full_like(s.main_height, self.world_dim),
        )

    def game_reset(self, s: BasicState) -> BasicState:
        s = self.game_reset_base(s)

        wd = self.world_dim
        s, k = self.randn(s, (wd - 1) // 2)
        maze_dim = k * 2 + 3
        margin = torch.div(wd - maze_dim, 2, rounding_mode="floor")

        s = s.replace(
            ents=s.ents.set_fields(
                0,
                rx=0.5,
                ry=0.5,
                x=margin.to(f32) + 0.5,
                y=margin.to(f32) + 0.5,
            ),
            game=MazeGameState(maze_dim=maze_dim),
        )

        g, mgrid, free_cells, num_free, _ = mazegen.generate_maze(
            s.rand_gen, maze_dim, wd
        )
        g, mgrid, _ = mazegen.place_objects(
            g, mgrid, free_cells, num_free, maze_dim, wd, GOAL, 1
        )
        s = s.replace(rand_gen=g)

        # world grid: maze block at `margin` offset, WALL elsewhere
        # (maze.cpp:84-106)
        dev = s.grid.device
        array_dim = (maze_dim + 2)[:, None, None]
        gx = torch.arange(wd, device=dev)[None, None, :]
        gy = torch.arange(wd, device=dev)[None, :, None]
        mg = margin[:, None, None]
        md = maze_dim[:, None, None]
        mi = gx - mg
        mj = gy - mg
        inside = (mi >= 0) & (mi < md) & (mj >= 0) & (mj < md)
        mpos = (mj + mazegen.MAZE_OFFSET) * array_dim + (mi + mazegen.MAZE_OFFSET)
        mpos = mpos.clamp(0, mgrid.shape[1] - 1).long()
        vals = mgrid.gather(1, mpos.reshape(mpos.shape[0], -1)).reshape(mpos.shape)
        world = torch.where(inside, vals, WALL_OBJ).to(i32)
        return s.replace(grid=world)

    def set_action_xy(self, s: BasicState, move_action) -> BasicState:
        s = super().set_action_xy(s, move_action)
        # maze.cpp:109-113: no diagonal moves
        return s.replace(
            action_vy=torch.where(s.action_vx != 0, 0.0, s.action_vy)
        )

    def game_step(self, s: BasicState, d):
        s, d = self.game_step_base(s, d)

        e = s.ents
        refl = torch.where(
            s.action_vx > 0,
            True,
            torch.where(s.action_vx < 0, False, e.is_reflected[:, 0]),
        )
        s = s.replace(ents=e.set_fields(0, is_reflected=refl))

        ix = s.ents.x[:, 0].to(i32)
        iy = s.ents.y[:, 0].to(i32)
        hit_goal = self.get_obj(s, ix, iy) == GOAL
        s = self.set_obj_where(s, ix, iy, SPACE, hit_goal)
        s = s.replace(
            reward=s.reward + torch.where(hit_goal, REWARD, 0.0),
            level_complete=s.level_complete | hit_goal,
        )
        s = s.replace(done=s.reward > 0)
        return s, d

    # -- latent state (maze.cpp:144-188) -----------------------------------

    def latent_info(self, s: BasicState):
        agent_pos = torch.stack(
            [s.ents.x[:, 0].to(i32), s.ents.y[:, 0].to(i32)], dim=1
        )
        goal_mask = self.cells_with_type_mask(s, GOAL)
        goal_idx = first_true(goal_mask.reshape(goal_mask.shape[0], -1))
        wmax = self.WORLD_DIM_MAX[0]
        exit_pos = torch.stack(
            [torch.remainder(goal_idx, wmax), torch.div(goal_idx, wmax, rounding_mode="floor")],
            dim=1,
        ).to(i32)
        return {
            "grid_size": torch.stack([s.main_width, s.main_height], dim=1),
            "grid": s.grid.reshape(s.grid.shape[0], -1),
            "agent_pos": agent_pos,
            "exit_pos": exit_pos,
        }
