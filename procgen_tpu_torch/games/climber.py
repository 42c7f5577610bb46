"""Climber: a vertical platformer; coins +1, every coin +10, patrolling
enemies kill.  Reference: procgen/src/games/climber.cpp; JAX counterpart
procgen_tpu/games/climber.py.

Coinrun's platform physics without crates (gravity, air control, jumps
from a wall or the world's edge), patrol enemies that turn within
``PATROL_RANGE`` of their spawn column, and a camera of the game's own:
the world's width, centred on it, following the agent upward.  The reset
draws the platforms from one peeked window, batched over the envs: up to
10 platforms of up to 11 cells, each with its masked draws, the cells
written in one scatter and the enemies and coins pushed in one
``push_many``.  Every function works on the whole batch: per-env values
are ``[N]`` tensors, per-slot values ``[N, cap]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import rng
from ..core.constants import EASY_MODE, PLAYER
from ..core.entities import default_fields, stack_records
from ..core.game import BasicAbstractGame, BasicState, first_true, per_env
from .registry import register

i32 = torch.int32
f32 = torch.float32

COIN_REWARD = 1.0
COMPLETION_BONUS = 10.0

COIN = 1
ENEMY = 5
ENEMY1 = 6
ENEMY2 = 7
PLAYER_JUMP = 9
PLAYER_RIGHT1 = 12
PLAYER_RIGHT2 = 13
WALL_MID = 15
WALL_TOP = 16
ENEMY_BARRIER = 19

PATROL_RANGE = 4
NUM_WALL_THEMES = 4
GRAVITY = 0.2
AIR_CONTROL = 0.15
MAX_PLATFORMS = 10
MAX_PLATFORM_LEN = 11


def _is_wall(t):
    return (t == WALL_MID) | (t == WALL_TOP)


@dataclasses.dataclass
class ClimberState:
    has_support: torch.Tensor  # bool [N]
    facing_right: torch.Tensor  # bool [N]
    coin_quota: torch.Tensor  # int32 [N]
    coins_collected: torch.Tensor  # int32 [N]
    wall_theme: torch.Tensor  # int32 [N]

    def replace(self, **kw) -> "ClimberState":
        return dataclasses.replace(self, **kw)


@register("climber")
class Climber(BasicAbstractGame):
    name = "climber"
    ENT_CAP = 24  # <= 10 platforms x (enemy + coin) + the agent
    DISPATCH_VECTORIZED = True  # an enemy's kill and the coins commute
    MAX_STEP_DRAWS = 4
    MAX_SUB_STEPS = 10  # vy reaches -2 falling
    ONLY_AGENT_SMART = False  # the patrol enemies
    SMART_VECTORIZABLE = True
    MAX_SMART = 12

    def __init__(self, options):
        super().__init__(options)
        self.out_of_bounds_object = WALL_MID
        self.world_w = 16 if options.distribution_mode == EASY_MODE else 20
        self.WORLD_DIM_MAX = (self.world_w, 64)

    def background_names(self):
        from ..render.assets import PLATFORM_BACKGROUNDS

        return PLATFORM_BACKGROUNDS

    def asset_for_type(self, type_):
        # climber.cpp:50-90
        colors = ["Blue", "Green", "Grey", "Red"]
        if type_ == PLAYER:
            return [f"platformer/player{c}_stand.png" for c in colors]
        if type_ == PLAYER_JUMP:
            return [f"platformer/player{c}_walk4.png" for c in colors]
        if type_ == PLAYER_RIGHT1:
            return [f"platformer/player{c}_walk1.png" for c in colors]
        if type_ == PLAYER_RIGHT2:
            return [f"platformer/player{c}_walk2.png" for c in colors]
        if type_ == WALL_TOP:
            return ["platformer/tileBlue_05.png", "platformer/tileGreen_05.png",
                    "platformer/tileYellow_06.png", "platformer/tileBrown_06.png"]
        if type_ == WALL_MID:
            return ["platformer/tileBlue_08.png", "platformer/tileGreen_08.png",
                    "platformer/tileYellow_09.png", "platformer/tileBrown_09.png"]
        if type_ == ENEMY1:
            return ["platformer/enemySwimming_1.png"]
        if type_ == ENEMY2:
            return ["platformer/enemySwimming_2.png"]
        if type_ == COIN:
            return ["platformer/yellowCrystal.png"]
        return []

    def use_block_asset(self, type_):
        return type_ in (WALL_MID, WALL_TOP)

    def game_init_state(self, n, device):
        def full(v, dtype):
            return torch.full((n,), v, dtype=dtype, device=device)

        return ClimberState(
            has_support=full(False, torch.bool), facing_right=full(True, torch.bool),
            coin_quota=full(0, i32), coins_collected=full(0, i32),
            wall_theme=full(0, i32),
        )

    def choose_world_dim(self, s):
        return s.replace(main_width=torch.full_like(s.main_width, self.world_w),
                         main_height=torch.full_like(s.main_height, 64))

    # -- physics --------------------------------------------------------------

    def is_blocked(self, s, src_type, target_type, is_horizontal):
        b = super().is_blocked(s, src_type, target_type, is_horizontal)
        return b | ((src_type == PLAYER) & _is_wall(target_type))

    def will_reflect(self, src_type, target_type):
        return (src_type == ENEMY) & (_is_wall(target_type)
                                      | (target_type == ENEMY_BARRIER))

    def _can_support(self, t):
        return _is_wall(t) | (t == self.out_of_bounds_object)

    def set_action_xy(self, s, move_action):
        # climber.cpp:236-257: a jump needs a wall or the edge under a foot
        avx = (torch.div(move_action, 3, rounding_mode="floor") - 1).to(f32)
        avy = torch.clamp_min((torch.remainder(move_action, 3) - 1).to(f32), 0.0)
        g = s.game
        facing = torch.where(avx > 0, True, torch.where(avx < 0, False, g.facing_right))
        e = s.ents
        x0, y0, rx0, ry0 = e.x[:, 0], e.y[:, 0], e.rx[:, 0], e.ry[:, 0]
        b1 = self.get_obj_from_floats(s, x0 - (rx0 - 0.01), y0 - (ry0 + 0.01))
        b2 = self.get_obj_from_floats(s, x0 + (rx0 - 0.01), y0 - (ry0 + 0.01))
        has_support = self._can_support(b1) | self._can_support(b2)
        return s.replace(
            action_vx=avx,
            action_vy=torch.where(has_support & (avy == 1), 1.0, 0.0),
            action_vrot=torch.zeros_like(s.action_vrot),
            game=g.replace(facing_right=facing, has_support=has_support),
        )

    def update_agent_velocity(self, s):
        # climber.cpp:107-117; every product and sum rounds on its own
        g = s.game
        e = s.ents
        mixrate_x = torch.where(g.has_support, s.mixrate, s.mixrate * AIR_CONTROL)
        vx = (1 - mixrate_x) * e.vx[:, 0] + mixrate_x * s.maxspeed * s.action_vx
        vy = torch.where(s.action_vy > 0, s.max_jump, e.vy[:, 0])
        vy = torch.where(~g.has_support & (vy > -2), vy - GRAVITY, vy)
        return s.replace(ents=e.set_fields(0, vx=vx, vy=vy))

    def handle_agent_collision_vec(self, s, d, hit):
        # climber.cpp:92-103
        e = s.ents
        enemy = (hit & (e.type == ENEMY)).any(dim=1)
        coins = hit & (e.type == COIN)
        ncoins = coins.sum(dim=1, dtype=i32)
        return s.replace(
            done=s.done | enemy,
            reward=s.reward + ncoins.to(f32) * COIN_REWARD,
            ents=e.replace(will_erase=e.will_erase | coins),
            game=s.game.replace(coins_collected=s.game.coins_collected + ncoins),
        ), d

    # -- rendering ------------------------------------------------------------

    def theme_for_grid_obj(self, s, type_):
        return torch.where(_is_wall(type_), per_env(s.game.wall_theme, type_), 0).to(i32)

    def image_for_type(self, s, type_):
        # climber.cpp:139-153
        e = s.ents
        sup = s.game.has_support
        standing = (torch.abs(e.vx[:, 0]) < 0.01) & (s.action_vx == 0) & sup
        half = torch.div(s.cur_time, 5, rounding_mode="floor")
        walk = torch.where((torch.remainder(half, 2) == 0) | ~sup,
                           PLAYER_RIGHT1, PLAYER_RIGHT2)
        player_img = torch.where(~sup, PLAYER_JUMP, torch.where(standing, PLAYER, walk))
        out = torch.abs(type_)
        out = torch.where(type_ == PLAYER, per_env(player_img, type_), out)
        out = torch.where(type_ == ENEMY_BARRIER, -1, out)
        return out.to(i32)

    def camera(self, s):
        """climber.cpp:261-265: the world's width in view, centred on it,
        the agent five of its half-heights below the centre."""
        w = s.main_width.to(f32)
        cx = w / 2.0
        cy = s.ents.y[:, 0] + w / 2.0 - 5 * s.ents.ry[:, 0]
        return cx, cy, w

    # -- reset ----------------------------------------------------------------

    def game_reset(self, s: BasicState) -> BasicState:
        s = self.game_reset_base(s)
        n = s.num
        dev = s.grid.device
        s = s.replace(
            maxspeed=torch.full((n,), 0.5, dtype=f32, device=dev),
            max_jump=torch.full((n,), 1.5, dtype=f32, device=dev),
            ents=s.ents.set_fields(0, rx=0.5, ry=0.5, x=1.5, y=1.5),
        )
        s = self.choose_random_theme(s, 0, PLAYER)
        s, wall_theme = self.randn(s, NUM_WALL_THEMES)
        s = s.replace(game=self.game_init_state(n, dev).replace(wall_theme=wall_theme))

        # init_floor_and_walls (climber.cpp:155-160)
        w, h = self.world_w, 64
        s = self.fill_elem(s, 0, 0, w, 1, WALL_TOP)
        s = self.fill_elem(s, 0, 0, 1, h, WALL_MID)
        s = self.fill_elem(s, w - 1, 0, 1, h, WALL_MID)
        s = self.fill_elem(s, 0, h - 1, w, 1, WALL_MID)
        return self._generate_platforms(s)

    def _generate_platforms(self, s: BasicState) -> BasicState:
        """climber.cpp:169-228, every platform's draws masked by whether
        the env has it.  The platforms' cells are only written, never
        read, here, so they go into the grid in one scatter at the end."""
        n = s.num
        dev = s.grid.device
        w = self.world_w
        d, norm = rng.peek_block(s.rand_gen, rng.N)

        d, difficulty = d.randn(3)
        min_p = difficulty * difficulty + 1
        max_p = (difficulty + 1) * (difficulty + 1) + 1
        d, np0 = d.randn(max_p - min_p + 1)
        num_platforms = np0 + min_p
        d, cx0 = d.randn(w - 4)
        curr_x = cx0 + 2
        curr_y = torch.zeros((n,), dtype=i32, device=dev)

        margin_x = 3
        enemy_prob = 0.2 if self.options.distribution_mode == EASY_MODE else 0.5
        max_dy = int(1.5 * 1.5 / (2 * GRAVITY))  # 5
        min_dy = 3
        # match_aspect_ratio of the enemy's first image, rounded as the
        # f32 quotient
        ry_enemy = float(np.float32(0.5) / np.float32(
            self.aspect_ratios(ENEMY1, "cpu")[0].item()))
        steps = torch.arange(1, MAX_PLATFORM_LEN + 1, device=dev)[None, :]

        recs, dos, cells_y, cells_x = [], [], [], []
        coin_quota = torch.zeros((n,), dtype=i32, device=dev)
        for i in range(MAX_PLATFORMS):
            live = i < num_platforms
            d, dy0 = d.randn_if(live, max_dy - min_dy + 1)

            can_enemy = (curr_x >= margin_x) & (curr_x <= w - margin_x)
            # `can_spawn_enemy && rand01() < p` draws only where it can
            d, eroll = d.rand01_if(live & can_enemy)
            spawn_enemy = live & can_enemy & (eroll < enemy_prob)
            # g++ evaluates add_entity's arguments right to left: the
            # direction's draw comes before the height's
            d, edir = d.randn_if(spawn_enemy, 2)
            d, ey0 = d.randn_if(spawn_enemy, 2)
            ef = default_fields(curr_x.to(f32) + 0.5, (curr_y + ey0 + 2).to(f32) + 0.5,
                                0.15 * (edir * 2 - 1).to(f32), 0.0, 0.5, ry_enemy, ENEMY)
            ef["image_type"] = ENEMY1
            ef["smart_step"] = True
            ef["climber_spawn_x"] = curr_x.to(f32) + 0.5
            recs.append(ef)
            dos.append(spawn_enemy)

            curr_y = torch.where(live, curr_y + dy0 + min_dy, curr_y)
            d, pl0 = d.randn_if(live, 10)
            plat_len = 2 + pl0
            d, vx0 = d.randn_if(live, 2)
            vx = vx0 * 2 - 1
            vx = torch.where(curr_x < margin_x, 1, vx)
            vx = torch.where(curr_x > w - margin_x, -1, vx)

            # the platform's cells up to the border (climber.cpp:203-211):
            # the run stops at the first cell past either wall
            nx = curr_x[:, None] + steps * vx[:, None]  # [N, 11]
            inside = (nx > 0) & (nx < w - 1)
            want = live[:, None] & (steps <= plat_len[:, None])
            ok = want & (torch.cumsum((want & ~inside).to(i32), dim=1) == 0)
            cand = torch.where(ok, nx, -1)
            cells_y.append(curr_y[:, None].expand_as(nx))
            cells_x.append(cand)
            ncand = ok.sum(dim=1, dtype=i32)
            ranks = torch.cumsum(ok.to(i32), dim=1) - 1

            # the coin (climber.cpp:213-217), its roll always drawn
            d, croll = d.rand01_if(live)
            place_coin = live & ((croll < 0.5) | (i == MAX_PLATFORMS - 1)
                                 | (i + 1 == num_platforms))
            d, ci = d.randn_if(place_coin, ncand.clamp_min(1))
            coin_x = cand.gather(1, first_true(ok & (ranks == ci[:, None]))[:, None])[:, 0]
            recs.append(default_fields(coin_x.to(f32) + 0.5, curr_y.to(f32) + 1.5,
                                       0.0, 0.0, 0.3, 0.3, COIN))
            dos.append(place_coin)
            coin_quota = coin_quota + place_coin.to(i32)

            # the next platform starts at one of these cells
            d, ni = d.randn_if(live, ncand.clamp_min(1))
            next_x = cand.gather(1, first_true(ok & (ranks == ni[:, None]))[:, None])[:, 0]
            curr_x = torch.where(live, next_x, curr_x)

        # the platforms' cells in one scatter (rows clipped as the JAX
        # package clips them; cells left out go to a spare column)
        ys = torch.cat(cells_y, dim=1).clamp(0, 63)
        xs = torch.cat(cells_x, dim=1)
        wmax = self.WORLD_DIM_MAX[0]
        flat = torch.cat([s.grid.reshape(n, -1),
                          torch.zeros((n, 1), dtype=i32, device=dev)], dim=1)
        idx = torch.where(xs >= 0, ys * wmax + xs, flat.shape[1] - 1).long()
        flat.scatter_(1, idx, WALL_TOP)
        grid = flat[:, :-1].reshape(s.grid.shape)
        return s.replace(
            grid=grid,
            ents=s.ents.push_many(stack_records(recs, n, dev), torch.stack(dos, dim=1)),
            game=s.game.replace(coin_quota=coin_quota),
            rand_gen=rng.commit(norm, d),
        )

    # -- per-step -------------------------------------------------------------

    def game_step(self, s: BasicState, d):
        s, d = self.game_step_base(s, d)
        refl = torch.where(s.action_vx > 0, False,
                           torch.where(s.action_vx < 0, True, s.ents.is_reflected[:, 0]))
        s = s.replace(ents=s.ents.set_fields(0, is_reflected=refl))

        # the patrol and the animation (climber.cpp:274-289)
        e = s.ents
        is_enemy = e.active & (e.type == ENEMY)
        vx = e.vx
        vx = torch.where(is_enemy & (e.x > e.climber_spawn_x + PATROL_RANGE),
                         -torch.abs(vx), vx)
        vx = torch.where(is_enemy & (e.x < e.climber_spawn_x - PATROL_RANGE),
                         torch.abs(vx), vx)
        half = torch.div(s.cur_time, 5, rounding_mode="floor")
        img = torch.where(torch.remainder(half, 2) == 0, ENEMY1, ENEMY2)
        s = s.replace(ents=e.replace(
            vx=vx,
            image_type=torch.where(is_enemy, img[:, None], e.image_type).to(i32),
            is_reflected=torch.where(is_enemy, vx < 0, e.is_reflected),
        ))

        g = s.game
        complete = g.coin_quota == g.coins_collected
        return s.replace(
            done=s.done | complete,
            reward=s.reward + torch.where(complete, COMPLETION_BONUS, 0.0),
            level_complete=s.level_complete | complete,
        ), d
