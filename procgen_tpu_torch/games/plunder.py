"""Plunder: shoot the enemy-colored ships (+1); friendly kills and shots
drain the timer; 20 targets give +10.  Reference: procgen/src/games/
plunder.cpp; JAX counterpart procgen_tpu/games/plunder.py.

The reset draws from one peeked window (refreshed before a rejection loop
that could run past its end): the theme permutation, the five lanes, in
hard mode up to three panels placed by ``place_by_rejection``, and the
agent's own rejection loop.  The step spawns lane ships, blocked by any
entity or explosion in the way (``spawn_blocked``), and fires a cannon
ball every third step at most.  The bullets against the ships and panels
follow the reference's sequential dispatch (``dispatch_entity_pairs``).
Every function works on the whole batch: per-env values are ``[N]``
tensors, per-slot values ``[N, cap]``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import rng
from ..core.constants import EASY_MODE, EXPLOSION
from ..core.entities import default_fields
from ..core.game import BasicAbstractGame, BasicState, place_by_rejection, reposition_agent
from ..render.renderer import fdiv, rdiv
from .registry import register

i32 = torch.int32
f32 = torch.float32

COMPLETION_BONUS = 10.0
POSITIVE_REWARD = 1.0

PLAYER_BULLET = 1
TARGET_LEGEND = 2
TARGET_BACKGROUND = 3
PANEL = 6
SHIP = 7

PI = math.pi
NUM_SHIP_TYPES = 6
NUM_LANES = 5
MAX_TRIES = 100  # reposition's retry bound (cpp:550-568)
JUICE_COLOR = (66, 245, 135)
PROGRESS_COLOR = (245, 66, 144)


@dataclasses.dataclass
class PlunderState:
    last_fire_time: torch.Tensor  # int32 [N]
    lane_directions: torch.Tensor  # bool [N, 5], a lane's ships move right
    target_bools: torch.Tensor  # bool [N, 6], the themes to shoot
    image_permutation: torch.Tensor  # int32 [N, 6]
    lane_vels: torch.Tensor  # f32 [N, 5]
    targets_hit: torch.Tensor  # int32 [N]
    juice_left: torch.Tensor  # f32 [N]
    min_agent_x: torch.Tensor  # f32 [N], the agent stays right of the legend

    def replace(self, **kw) -> "PlunderState":
        return dataclasses.replace(self, **kw)


@register("plunder")
class Plunder(BasicAbstractGame):
    name = "plunder"
    WORLD_DIM_MAX = (20, 20)
    ENT_CAP = 48
    STATIC_RENDER_PREFIX = True
    DECOR_CAP = 24  # explosions
    DISPATCH_VECTORIZED = True
    ANY_COLLIDES_WITH_ENTITIES = True
    MAX_STEP_DRAWS = 8
    MAX_SUB_STEPS = 6  # maxspeed .85
    TARGET_QUOTA = 20
    SPAWN_PROB = 0.06

    def __init__(self, options):
        super().__init__(options)
        self.timeout = 4000
        self.mixrate = 0.5
        self.maxspeed = 0.85
        self.has_useful_vel_info = False
        self.center_agent = False
        self.r_scale = 1.5 if options.distribution_mode == EASY_MODE else 1.0

    def background_names(self):
        from ..render.assets import WATER_SURFACE_BACKGROUNDS

        return WATER_SURFACE_BACKGROUNDS

    def should_preserve_type_themes(self, type_):
        # plunder.cpp:83-85
        return type_ == SHIP

    def asset_for_type(self, type_):
        # plunder.cpp:50-64
        if type_ == SHIP:
            return [f"misc_assets/ship_{i}.png" for i in range(1, 7)]
        if type_ == PLAYER_BULLET:
            return ["misc_assets/cannonBall.png"]
        if type_ == PANEL:
            return ["misc_assets/panel_wood.png"]
        if type_ == TARGET_BACKGROUND:
            return ["misc_assets/target_red2.png"]
        return []

    def game_init_state(self, n, device):
        def full(shape, v, dtype):
            return torch.full((n,) + shape, v, dtype=dtype, device=device)

        return PlunderState(
            last_fire_time=full((), 0, i32),
            lane_directions=full((NUM_LANES,), False, torch.bool),
            target_bools=full((NUM_SHIP_TYPES,), False, torch.bool),
            image_permutation=torch.arange(
                NUM_SHIP_TYPES, dtype=i32, device=device).expand(n, -1).clone(),
            lane_vels=full((NUM_LANES,), 0.0, f32),
            targets_hit=full((), 0, i32),
            juice_left=full((), 1.0, f32),
            min_agent_x=full((), 0.0, f32),
        )

    def choose_world_dim(self, s):
        return s.replace(main_width=torch.full_like(s.main_width, 20),
                         main_height=torch.full_like(s.main_height, 20))

    def set_action_xy(self, s, move_action):
        zf = torch.zeros_like(s.action_vx)
        return s.replace(
            action_vx=(torch.div(move_action, 3, rounding_mode="floor") - 1).to(f32),
            action_vy=zf, action_vrot=zf,
        )

    # -- collisions -----------------------------------------------------------

    def dispatch_entity_pairs(self, s, d):
        """Bullet against ship or panel (plunder.cpp:89-110) with the C++
        dispatch loop's sequential semantics (basic-abstract-game.cpp:
        728-746): the bullets act in reverse slot order and the
        ``!will_erase`` guards are read live, so a bullet kills only the
        highest live ship or panel it overlaps, and a ship dies to the
        first bullet that reaches it.  A loop over the slots that hold a
        bullet in some env (one host read), batched over the envs; then
        the killed ships' explosions are pushed in slot order."""
        e = s.ents
        cap = e.cap
        slots = torch.arange(cap, device=e.x.device)[None, :]
        is_ship = e.active & (e.type == SHIP)
        is_bullet = e.active & (e.type == PLAYER_BULLET)
        hittable = is_ship | (e.active & (e.type == PANEL))
        is_target = s.game.target_bools.gather(1, e.image_theme.clamp(0, 5).long())

        b = lambda t: t[:, :, None]  # noqa: E731  the bullet axis
        t_ = lambda t: t[:, None, :]  # noqa: E731  the target axis
        overlap = ((torch.abs(b(e.x) - t_(e.x)) < b(e.rx) + t_(e.rx) + b(e.collision_margin))
                   & (torch.abs(b(e.y) - t_(e.y)) < b(e.ry) + t_(e.ry) + b(e.collision_margin)))

        we = e.will_erase
        n_t = torch.zeros_like(s.reward)
        n_f = torch.zeros_like(s.reward)
        boom = torch.zeros_like(we)
        for i in reversed(torch.nonzero(is_bullet.any(dim=0)).flatten().tolist()):
            acts = is_bullet[:, i] & ~we[:, i]
            qual = overlap[:, i] & hittable & ~we & (slots != i) & acts[:, None]
            j = torch.where(qual, slots, -1).amax(dim=1)  # the highest, or -1
            killed = (slots == j[:, None]) & is_ship
            ship_kill = killed.any(dim=1)
            tgt_kill = (killed & is_target).any(dim=1)
            we = we | killed | ((slots == i) & (j >= 0)[:, None])
            n_t = n_t + tgt_kill.to(f32)
            n_f = n_f + (ship_kill & ~tgt_kill).to(f32)
            boom = boom | killed

        g = s.game
        s = s.replace(
            reward=s.reward + n_t * POSITIVE_REWARD,
            game=g.replace(
                targets_hit=g.targets_hit + n_t.to(i32),
                juice_left=g.juice_left + 0.1 * n_t - 0.1 * n_f,
            ),
            ents=e.replace(will_erase=we),
        )
        f = default_fields(e.x, e.y, e.vx / 2, e.vy / 2, 0.5 * e.rx, 0.5 * e.rx,
                           EXPLOSION)
        return s.replace(decor=s.decor.push_many(f, boom)), d

    # -- rendering ------------------------------------------------------------

    def render_overlay(self, s, obs, sx, sy, res, unit, vis):
        """The juice bar and the progress bar (plunder.cpp:66-77) over the
        int32 [N, res, res, 3] frames; ``sx``/``sy`` the pixel centres."""
        g = s.game
        w = s.main_width.to(f32)
        u = unit[:, None]
        bars = (
            (0.25, w * g.juice_left, JUICE_COLOR),
            (0.75, fdiv(w * g.targets_hit.to(f32), float(self.TARGET_QUOTA)),
             PROGRESS_COLOR),
        )
        for y0, length, color in bars:
            in_x = (sx >= 0.25 * u) & (sx < (0.25 + length[:, None]) * u)
            in_y = (sy >= y0 * u) & (sy < (y0 + 0.5) * u)
            mask = in_y[:, :, None] & in_x[:, None, :]
            col = torch.tensor(color, dtype=obs.dtype, device=obs.device)
            obs = torch.where(mask[..., None], col, obs)
        return obs

    # -- reset ----------------------------------------------------------------

    def game_reset(self, s: BasicState) -> BasicState:
        s = self.game_reset_base(s)
        n = s.num
        dev = s.grid.device
        r_scale = self.r_scale
        d, norm = rng.peek_block(s.rand_gen, rng.N)

        # image_permutation = choose_n([0..5], 6) (randgen.cpp:49-68): the
        # i-th draw picks among the 6 - i themes left, in index order
        words = d.peek_at(torch.arange(6 + 2 * NUM_LANES, device=dev)[None, :])
        alive = torch.ones((n, NUM_SHIP_TYPES), dtype=torch.bool, device=dev)
        picks = []
        for i in range(NUM_SHIP_TYPES):
            r = rng._randn_from(words[:, i], NUM_SHIP_TYPES - i)
            rank = torch.cumsum(alive.to(i32), dim=1) - 1
            pick = (alive & (rank == r[:, None])).to(i32).argmax(dim=1)
            picks.append(pick)
            alive = alive & (torch.arange(NUM_SHIP_TYPES, device=dev) != pick[:, None])
        perm = torch.stack(picks, dim=1).to(i32)
        target_bools = torch.arange(NUM_SHIP_TYPES, device=dev) == perm[:, :1]

        # the lanes' directions and speeds, two draws a lane
        d01 = rng._rand01_from(words[:, 6::2])
        v01 = rng._rand01_from(words[:, 7::2])
        lane_dirs = d01 < 0.5
        lane_vels = (0.15 + 0.1 * v01.double()).float()
        d = d.replace(cursor=d.cursor + 6 + 2 * NUM_LANES)

        # panels (plunder.cpp:155-163), each placed against the pool and
        # the panels before it
        if self.options.distribution_mode != EASY_MODE:
            d, num_panels = d.randn(4)
            for i in range(3):
                d, norm = rng.window(d, norm, 2 * (MAX_TRIES + 1))
                e = s.ents
                slot0 = torch.arange(e.cap, device=dev)[None, :] == 0
                blockers = [(e.x, e.y, e.rx, e.ry,
                             e.active & (slot0 | ~e.avoids_collisions))]
                do = i < num_panels
                d, px, py = place_by_rejection(
                    d, blockers, 1.2, 0.5, 0.0, 5.0, 20.0, 5.0, do, MAX_TRIES)
                s = s.replace(ents=s.ents.push(
                    default_fields(px, py, 0.0, 0.0, 1.2, 0.5, PANEL), do=do))

        # the legend (plunder.cpp:165-173)
        legend_r = 2.0
        s = s.replace(ents=s.ents.push(default_fields(
            legend_r, legend_r, 0.0, 0.0, legend_r, legend_r, TARGET_BACKGROUND)))
        lf = default_fields(legend_r, legend_r, 0.0, 0.0, r_scale * 1.5,
                            r_scale * 1.5, TARGET_LEGEND)
        lf["image_theme"] = perm[:, 0]
        lf["image_type"] = SHIP
        lf["ry"] = rdiv(r_scale * 1.5, self.aspect_of(SHIP, perm[:, 0].clamp(0, 5)))
        lf["rotation"] = PI / 2
        s = s.replace(ents=s.ents.push(lf))

        # the agent (plunder.cpp:175-190): its theme after a randn(1) that
        # still takes a word; reposition_agent's y is drawn and dropped
        d, th0 = d.randn(1)
        agent_theme = perm.gather(1, (th0 + 1).clamp(0, 5).long()[:, None])[:, 0]
        ar = self.aspect_of(SHIP, agent_theme.clamp(0, 5))
        s = s.replace(ents=s.ents.set_fields(
            0, image_type=SHIP, rx=r_scale, rotation=-PI / 2,
            image_theme=agent_theme, ry=rdiv(r_scale, ar)))
        d, norm = rng.window(d, norm, 2 * (MAX_TRIES + 1))
        d, ax, _ = reposition_agent(d, s.ents, 20.0, 20.0, MAX_TRIES)
        e = s.ents
        min_agent_x = 2 * legend_r + e.rx[:, 0]
        return s.replace(
            rand_gen=rng.commit(norm, d),
            ents=e.set_fields(0, x=torch.maximum(ax, min_agent_x), y=1 + e.ry[:, 0]),
            game=PlunderState(
                last_fire_time=torch.zeros((n,), dtype=i32, device=dev),
                lane_directions=lane_dirs,
                target_bools=target_bools,
                image_permutation=perm,
                lane_vels=lane_vels,
                targets_hit=torch.zeros((n,), dtype=i32, device=dev),
                juice_left=torch.ones((n,), dtype=f32, device=dev),
                min_agent_x=min_agent_x,
            ),
        )

    # -- per-step -------------------------------------------------------------

    def game_step(self, s: BasicState, d):
        s, d = self.game_step_base(s, d)
        s = s.replace(game=s.game.replace(juice_left=s.game.juice_left - 0.0015))

        # a lane ship (plunder.cpp:196-216), unless an entity or an
        # explosion is in its way
        d, roll = d.rand01()
        spawn = roll < self.SPAWN_PROB
        d, lane = d.randn_if(spawn, NUM_LANES)
        d, th0 = d.randn_if(spawn, 2)  # num_current_ship_types == 2
        g = s.game
        ent_r = self.r_scale
        ent_y = (lane.to(f32) * 0.11 + 0.4) * (10.0 - ent_r) + 10.0
        lane_i = lane.clamp(0, NUM_LANES - 1).long()[:, None]
        moves_right = g.lane_directions.gather(1, lane_i)[:, 0]
        ent_vx = g.lane_vels.gather(1, lane_i)[:, 0] * torch.where(moves_right, 1.0, -1.0)
        theme = g.image_permutation.gather(1, th0.clamp(0, 5).long()[:, None])[:, 0]
        ar = self.aspect_of(SHIP, theme.clamp(0, 5))
        x = torch.where(moves_right, -ent_r, 20.0 + ent_r)
        f = default_fields(x, ent_y, ent_vx, 0.0, ent_r, rdiv(ent_r, ar), SHIP)
        f["image_theme"] = theme
        f["is_reflected"] = ~moves_right
        blocked = self.spawn_blocked(s, x, ent_y, ent_r, f["ry"])
        s = s.replace(ents=s.ents.push(f, do=spawn & ~blocked))

        # fire (plunder.cpp:218-224)
        fire = (s.special_action == 1) & (s.cur_time - s.game.last_fire_time >= 3)
        bf = default_fields(s.ents.x[:, 0], s.ents.y[:, 0], 0.0, 1.0, 0.25, 0.25,
                            PLAYER_BULLET)
        bf["collides_with_entities"] = True
        bf["expire_time"] = 50
        g = s.game
        s = s.replace(
            ents=s.ents.push(bf, do=fire),
            game=g.replace(
                last_fire_time=torch.where(fire, s.cur_time, g.last_fire_time),
                juice_left=g.juice_left - torch.where(fire, 0.02, 0.0),
            ),
        )

        g = s.game
        out_of_juice = g.juice_left <= 0
        complete = g.targets_hit >= self.TARGET_QUOTA
        s = s.replace(
            done=s.done | out_of_juice | complete,
            reward=s.reward + torch.where(complete, COMPLETION_BONUS, 0.0),
            level_complete=s.level_complete | complete,
            game=g.replace(juice_left=torch.clamp_max(g.juice_left, 1.0)),
        )

        # keep clear of the legend (plunder.cpp:239-241)
        e = s.ents
        return s.replace(ents=e.set_fields(
            0, x=torch.maximum(e.x[:, 0], g.min_agent_x))), d
