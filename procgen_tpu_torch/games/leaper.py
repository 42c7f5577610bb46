"""Leaper (Frogger): cross the car lanes, then the log river; +10 at the
finish line.  Reference: procgen/src/games/leaper.cpp; JAX counterpart
procgen_tpu/games/leaper.py.

The reset lays out up to five road and five water lanes, each with a
speed, then pre-rolls the world: it spawns and moves cars and logs for
``width / min_speed`` steps (leaper.cpp:176-180), compacting the ones that
left the world after every step, as the JAX package does (its module
docstring shows the compaction changes nothing the reference sees).  The
step hops the frog with a linear decay, spawns on every lane, carries the
frog on the last log under it and drowns it in open water.

Lanes never touch each other (their rows are a unit apart and no pair of
radii reaches that far), so a step's spawns on the twelve lanes are taken
at once: the draws are walked lane by lane on the step's cursor, every
lane's spawn point is tested against the pool, and the spawns are pushed
in lane order.  The warm-up draws from one block (``rng.draw_block``).
Its draws depend on the words alone, so all its iterations' draws are
taken at once, on the step's own draw function.  Each iteration then
runs the step's spawn test, the move and the compaction on what varies:
each slot's kind (none, the agent, or a lane), x, age and theme.  Every
other field is the kind's; the agent stands still on the empty bottom
row, so only its age changes.  The pool is built from these once, after
the last iteration.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import rng
from ..core.constants import EASY_MODE, EXTREME_MODE, HARD_MODE, PLAYER
from ..core.entities import SLOT_FIELDS, default_fields, stack_records
from ..core.game import BasicAbstractGame, BasicState
from .registry import register

i32 = torch.int32
f32 = torch.float32

LOG = 1
ROAD = 2
WATER = 3
CAR = 4
FINISH_LINE = 5

MONSTER_RADIUS = 0.25
LOG_RADIUS = 0.45

GOAL_REWARD = 10.0

NSTEP = 5
FROG_ANIMATION_FRAMES = NSTEP
MAX_SPEED = 2 / (NSTEP - 1.0)
VEL_DECAY = MAX_SPEED / NSTEP

MAX_LANES = 6  # difficulty <= 4, +1 extra lane
PI = math.pi
# XLA turns the JAX package's ``abs(speed) / 6.0`` into a multiply by the
# f32 reciprocal; the division by 2.0 is exact either way
CAR_ROLL_SCALE = float(np.float32(1 / 6.0))
LOG_ROLL_SCALE = 0.5

# slot kinds in the warm-up: 0 an unused slot, 1 the agent, then the car
# lanes and the log lanes
KIND_CAR = 2
KIND_LOG = KIND_CAR + MAX_LANES
NUM_KINDS = KIND_LOG + MAX_LANES


@dataclasses.dataclass
class LeaperState:
    bottom_road_y: torch.Tensor  # int32 [N]
    road_lane_speeds: torch.Tensor  # f32 [N, MAX_LANES]
    num_road_lanes: torch.Tensor  # int32 [N]
    bottom_water_y: torch.Tensor  # int32 [N]
    water_lane_speeds: torch.Tensor  # f32 [N, MAX_LANES]
    num_water_lanes: torch.Tensor  # int32 [N]
    goal_y: torch.Tensor  # int32 [N]

    def replace(self, **kw) -> "LeaperState":
        return dataclasses.replace(self, **kw)


@register("leaper")
class Leaper(BasicAbstractGame):
    name = "leaper"
    ENT_CAP = 80
    STATIC_RENDER_PREFIX = True
    DISPATCH_VECTORIZED = True  # handlers commute (car death, finish bonus)
    MAX_STEP_DRAWS = 32
    MAX_SUB_STEPS = 4  # |v| <= 0.5

    def __init__(self, options):
        super().__init__(options)
        self.maxspeed = MAX_SPEED
        self.timeout = 500
        self.center_agent = False  # forced at reset (leaper.cpp:126)

        mode = options.distribution_mode
        dim = {EASY_MODE: 9, HARD_MODE: 15}.get(mode, 20)
        self.world_dim = dim
        self.WORLD_DIM_MAX = (dim, dim)
        # speed ranges (leaper.cpp:128-146)
        if mode == EASY_MODE:
            self.car_speed = (0.03, 0.12)
            self.log_speed = (0.025, 0.075)
        elif mode == EXTREME_MODE:
            self.car_speed = (0.1, 0.3)
            self.log_speed = (0.1, 0.2)
        else:
            self.car_speed = (0.05, 0.2)
            self.log_speed = (0.05, 0.1)
        self.warmup_steps = int(dim / min(self.car_speed[0], self.log_speed[0]))
        # the most lanes of a kind: difficulty 0..3 in easy mode, 0..4 plus
        # an extra lane in the others
        self.lanes = 3 if mode == EASY_MODE else 5

    def background_names(self):
        from ..render.assets import TOPDOWN_BACKGROUNDS

        return TOPDOWN_BACKGROUNDS

    def asset_for_type(self, type_):
        # leaper.cpp:45-68
        if type_ == ROAD:
            return ["misc_assets/roadTile6b.png"]
        if type_ == WATER:
            return ["misc_assets/terrainTile6.png"]
        if type_ == CAR:
            return [
                "misc_assets/car_yellow_5.png",
                "misc_assets/car_black_1.png",
                "misc_assets/car_blue_2.png",
                "misc_assets/car_green_3.png",
                "misc_assets/car_red_4.png",
            ]
        if type_ == LOG:
            return ["misc_assets/elementWood044.png"]
        if type_ == PLAYER:
            return [
                "misc_assets/frog1.png",
                "misc_assets/frog2.png",
                "misc_assets/frog4.png",
                "misc_assets/frog6.png",
                "misc_assets/frog7.png",
            ]
        if type_ == FINISH_LINE:
            return ["misc_assets/finish2.png"]
        return []

    def use_block_asset(self, type_):
        return type_ in (WATER, ROAD)

    def should_preserve_type_themes(self, type_):
        # leaper.cpp:91-93
        return type_ == PLAYER

    def entity_tile_ratio(self, s, e):
        # leaper.cpp:67-76: the finish line tiles horizontally
        return torch.where(e.type == FINISH_LINE, 1.0, 0.0)

    def adjust_image_rect(self, img, x0, y0, w2, h2):
        # leaper.cpp:242-248: the frog's sprite reaches 0.275 h above its box
        p = img == PLAYER
        return x0, torch.where(p, y0 - 0.275 * h2, y0), w2, torch.where(p, 1.55 * h2, h2)

    def game_init_state(self, n, device):
        def z(shape=(), dtype=i32):
            return torch.zeros((n,) + shape, dtype=dtype, device=device)

        return LeaperState(
            bottom_road_y=z(), road_lane_speeds=z((MAX_LANES,), f32),
            num_road_lanes=z(), bottom_water_y=z(),
            water_lane_speeds=z((MAX_LANES,), f32), num_water_lanes=z(),
            goal_y=z(),
        )

    def choose_world_dim(self, s):
        return s.replace(main_width=torch.full_like(s.main_width, self.world_dim),
                         main_height=torch.full_like(s.main_height, self.world_dim))

    def handle_agent_collision_vec(self, s, d, hit):
        # leaper.cpp:79-87
        e = s.ents
        car = (hit & (e.type == CAR)).any(dim=1)
        finish = ((hit & (e.type == FINISH_LINE)).any(dim=1)
                  & (e.vx[:, 0] == 0) & (e.vy[:, 0] == 0))
        return s.replace(
            done=s.done | car | finish,
            reward=s.reward + torch.where(finish, GOAL_REWARD, 0.0),
            level_complete=s.level_complete | finish,
        ), d

    def update_agent_velocity(self, s):
        """Discrete hops with a linear decay (leaper.cpp:215-239)."""
        e = s.ents
        vx0, vy0 = e.vx[:, 0], e.vy[:, 0]
        at_rest = (vx0 == 0) & (vy0 == 0)
        hop_x = at_rest & (s.action_vx != 0)
        hop_y = at_rest & ~hop_x & (s.action_vy != 0)
        vx = torch.where(hop_x, s.maxspeed * s.action_vx, vx0)
        vy = torch.where(hop_y, s.maxspeed * s.action_vy, vy0)
        theme = torch.where(hop_x | hop_y, 1, e.image_theme[:, 0])
        rot = e.rotation[:, 0]
        rot = torch.where(hop_x, torch.where(vx > 0, 1.0, -1.0) * (PI / 2), rot)
        rot = torch.where(hop_y, torch.where(vy > 0, 0.0, PI), rot)

        def decay(v):
            return torch.clamp_min(torch.abs(v) - VEL_DECAY, 0.0) * torch.sign(v)

        return s.replace(ents=e.set_fields(
            0, vx=decay(vx), vy=decay(vy), image_theme=theme, rotation=rot))

    # -- spawning -------------------------------------------------------------

    def _roll_consts(self, g: LeaperState):
        """What the spawn draws need of the lanes, per env: each car lane's
        roll threshold and existence as [N, 1, 1], the log lanes'
        thresholds [N, 1, L]; an absent lane's threshold is -1, which no
        roll is under."""
        L = self.lanes
        lanes = torch.arange(L, device=g.goal_y.device)[None, None, :]
        road_on = lanes < g.num_road_lanes[:, None, None]
        thr_car = torch.where(road_on, torch.abs(g.road_lane_speeds[:, None, :L])
                              * CAR_ROLL_SCALE, -1.0)
        thr_log = torch.where(lanes < g.num_water_lanes[:, None, None],
                              torch.abs(g.water_lane_speeds[:, None, :L]) * LOG_ROLL_SCALE,
                              -1.0)
        return ([thr_car[..., k:k + 1] for k in range(L)],
                [road_on[..., k:k + 1].long() for k in range(L)],
                thr_log, lanes, g.num_water_lanes.long()[:, None])

    def _lane_draws(self, block, at, consts):
        """The spawn draws of one step (leaper.cpp:184-213) from each
        position ``at`` (int64 [N, P]) of ``block``: in lane order, a car
        lane's roll where the lane exists and its theme where the roll
        hits, then a log lane's roll (``consts`` from ``_roll_consts``).
        Returns (the words used [N, P], hit [N, P, 2L], car themes
        [N, P, L]); ``hit`` is the roll's, before the spawn point is
        tested."""
        thr_car, road_on, thr_log, lanes, num_water = consts
        n, p = at.shape
        L = self.lanes
        K = block.shape[1]
        window = (at[:, :, None] + torch.arange(3 * L, device=block.device)).clamp_max(K - 1)
        words = block.gather(1, window.view(n, -1)).view(n, p, 3 * L)
        rolls = rng._rand01_from(words)
        idx = torch.zeros_like(words[..., :1])
        pos, hits = [], []
        for k in range(L):
            hit = rolls.gather(2, idx) < thr_car[k]
            pos.append(idx)
            hits.append(hit)
            idx = idx + road_on[k] + hit
        hits.append(rolls.gather(2, idx + lanes) < thr_log)
        themes = rng._randn_from(words.gather(2, torch.cat(pos, dim=2) + 1),
                                 self.num_themes(CAR))
        return idx[..., 0] + num_water, torch.cat(hits, dim=2), themes

    def _lane_points(self, s: BasicState):
        """Every lane's spawn point (leaper.cpp:190-210): (x, y, speed)
        [N, 2L] each, the car lanes first, and the radius of its spawn test
        [2L]."""
        g = s.game
        L = self.lanes
        lanes = torch.arange(L, device=s.grid.device)
        speed = torch.cat([g.road_lane_speeds[:, :L], g.water_lane_speeds[:, :L]], dim=1)
        base = torch.cat([g.bottom_road_y[:, None].expand(-1, L),
                          g.bottom_water_y[:, None].expand(-1, L)], dim=1)
        y = base.to(f32) + torch.cat([lanes, lanes])[None, :] + 0.5
        r = torch.tensor([MONSTER_RADIUS] * L + [LOG_RADIUS] * L, device=y.device)
        w = s.main_width.to(f32)[:, None]
        x = torch.where(speed > 0, -r, w + r)
        return x, y, speed, r

    def _lane_records(self, x, y, speed, themes):
        """The fields of each lane's spawn ([N, 2L] a field, the car lanes
        first; ``themes`` the cars' [N, L] or 0)."""
        L = self.lanes
        recs = [dict(default_fields(x[:, k], y[:, k], speed[:, k], 0.0,
                                    2 * MONSTER_RADIUS, MONSTER_RADIUS, CAR),
                     image_theme=themes if isinstance(themes, int) else themes[:, k],
                     rotation=torch.where(speed[:, k] < 0, PI, 0.0))
                for k in range(L)]
        recs += [dict(default_fields(x[:, k], y[:, k], speed[:, k], 0.0,
                                     LOG_RADIUS, LOG_RADIUS, LOG),
                      image_theme=0, rotation=0.0)
                 for k in range(L, 2 * L)]
        return stack_records(recs, x.shape[0], x.device)

    @staticmethod
    def _spawn_blocked(x, y, r, ex, ey, erx, ery, blocks):
        """has_any_collision (leaper.cpp:197,210) of every lane's spawn
        point (``x``, ``y`` [N, 2L], radius ``r`` [2L]) over the slots
        (``e*`` [N, S]; ``blocks`` [N, S]: live and not avoiding
        collisions): [N, 2L] bool."""
        c = lambda v: v[:, :, None]  # noqa: E731  the lane axis
        p = lambda v: v[:, None, :]  # noqa: E731  the slot axis
        rr = r[None, :, None]
        return ((torch.abs(c(x) - p(ex)) < rr + p(erx))
                & (torch.abs(c(y) - p(ey)) < rr + p(ery)) & p(blocks)).any(dim=2)

    def _spawn_entities(self, s: BasicState, d):
        """The step's spawns on every lane, each unless an entity is over
        its spawn point, pushed in lane order."""
        used, hit, themes = self._lane_draws(d.block, d.cursor[:, None].long(),
                                             self._roll_consts(s.game))
        d = d.replace(cursor=d.cursor + used[:, 0].to(i32))
        hit, themes = hit[:, 0], themes[:, 0]
        x, y, speed, r = self._lane_points(s)
        e = s.ents
        do = hit & ~self._spawn_blocked(x, y, r, e.x, e.y, e.rx, e.ry,
                                        e.active & ~e.avoids_collisions)
        return s.replace(ents=e.push_many(self._lane_records(x, y, speed, themes), do)), d

    # -- reset ----------------------------------------------------------------

    def game_reset(self, s: BasicState) -> BasicState:
        s = self.game_reset_base(s)
        n = s.num
        dev = s.grid.device
        easy = self.options.distribution_mode == EASY_MODE
        L = self.lanes
        s = s.replace(ents=s.ents.set_fields(0, y=s.ents.ry[:, 0]))
        # the lanes and the warm-up draw from one block: at most 24 words
        # for the lanes, then 3 a lane kind and step
        block, ctx = rng.draw_block(s.rand_gen, 24 + self.warmup_steps * 3 * L)
        d = rng.Draws(block=block, twisted=None, cursor=torch.zeros_like(s.rand_gen.pos))
        zero = torch.zeros((n,), dtype=i32, device=dev)

        def extra_space(d):
            return (d, zero) if easy else d.randn(2)

        d, ex1 = extra_space(d)
        bottom_road_y = ex1 + 1
        d, difficulty = d.randn((3 if easy else 4) + 1)
        d, extra_lane = (d, zero) if easy else d.randn(4)

        lo_c, hi_c = self.car_speed
        lo_l, hi_l = self.log_speed
        gy = torch.arange(self.world_dim, device=dev)[None, :, None]
        grid = s.grid

        num_road = difficulty + (extra_lane == 2).to(i32)
        road = []
        for lane in range(MAX_LANES):
            on = lane < num_road
            d, sgn01 = d.rand01_if(on)
            d, f01 = d.rand01_if(on)
            spd = rng._randrange_from(f01, lo_c, hi_c)
            road.append(torch.where(on, torch.where(sgn01 < 0.5, 1.0, -1.0) * spd, 0.0))
            grid = torch.where(on[:, None, None] & (gy == (bottom_road_y + lane)[:, None, None]),
                               ROAD, grid)

        d, ex2 = extra_space(d)
        bottom_water_y = bottom_road_y + num_road + ex2 + 1
        num_water = difficulty + (extra_lane == 3).to(i32)
        d, csgn01 = d.rand01()
        sign = torch.where(csgn01 < 0.5, 1.0, -1.0)
        water = []
        for lane in range(MAX_LANES):
            on = lane < num_water
            d, f01 = d.rand01_if(on)
            spd = rng._randrange_from(f01, lo_l, hi_l)
            water.append(torch.where(on, sign * spd, 0.0))
            sign = torch.where(on, -sign, sign)
            grid = torch.where(on[:, None, None] & (gy == (bottom_water_y + lane)[:, None, None]),
                               WATER, grid)

        goal_y = bottom_water_y + num_water + 1
        s = s.replace(grid=grid.to(i32), game=LeaperState(
            bottom_road_y=bottom_road_y.to(i32),
            road_lane_speeds=torch.stack(road, dim=1),
            num_road_lanes=num_road.to(i32),
            bottom_water_y=bottom_water_y.to(i32),
            water_lane_speeds=torch.stack(water, dim=1),
            num_water_lanes=num_water.to(i32),
            goal_y=goal_y.to(i32),
        ))
        s, d = self._warm_up(s, d)
        s = s.replace(rand_gen=rng.advance_block(s.rand_gen, ctx, d.cursor))

        w2 = self.world_dim / 2.0
        f = default_fields(w2, goal_y.to(f32) - 0.5, 0.0, 0.0, w2, 0.5, FINISH_LINE)
        return s.replace(ents=s.ents.push(f))

    def _kind_table(self, s: BasicState):
        """Every slot field of each warm-up kind, [N, NUM_KINDS] a field:
        zeros for an unused slot, the agent's record, each lane's spawn."""
        n = s.num
        dev = s.grid.device
        e = s.ents
        lanes = self._lane_records(*self._lane_points(s)[:3], 0)
        codes = list(range(KIND_CAR, KIND_CAR + self.lanes)) + list(
            range(KIND_LOG, KIND_LOG + self.lanes))
        out = {}
        for k in SLOT_FIELDS:
            arr = getattr(e, k)
            tab = torch.zeros((n, NUM_KINDS), dtype=arr.dtype, device=dev)
            tab[:, 1] = arr[:, 0]
            if k in lanes:
                tab[:, codes] = lanes[k]
            out[k] = tab
        return out, torch.tensor(codes, device=dev)

    def _warm_up(self, s: BasicState, d: rng.Draws):
        """``warmup_steps`` iterations of spawn, move and compaction
        (leaper.cpp:176-180) on each slot's x and its kind, theme and age
        packed in one integer (4, 4 and the remaining bits), with a spare
        column past ``cap`` that takes the pushes the full pool drops;
        every other field is its kind's (``_kind_table``), which neither
        the spawn test nor the move nor the compaction changes: lanes
        move only along x, and the agent stands at rest.  Then the pool
        from them.  No host read."""
        n = s.num
        dev = s.grid.device
        L = self.lanes
        cap = self.ENT_CAP
        e = s.ents
        slots = torch.arange(cap + 1, device=dev)[None, :]
        x = torch.where(slots == 0, e.x[:, :1], 0.0)
        meta = torch.where(slots == 0, 1 + (e.life_time[:, :1].long() << 8), 0)
        count = e.count.long()[:, None]
        lx, ly, _, r = self._lane_points(s)
        d, hits, themes = self._warm_up_draws(s, d)
        tab, codes = self._kind_table(s)
        blocks = ~tab["avoids_collisions"]
        w = s.main_width.to(f32)[:, None]
        h = s.main_height.to(f32)[:, None]
        log_codes = codes[L:].expand(n, L)
        for hit, theme in zip(hits.unbind(1), themes.unbind(1)):
            kind = meta & 15
            active = slots < count
            do = hit & ~self._spawn_blocked(
                lx, ly, r, x, tab["y"].gather(1, kind), tab["rx"].gather(1, kind),
                tab["ry"].gather(1, kind), active & blocks.gather(1, kind))
            # the pushes, in lane order, past the live slots; a push the
            # full pool drops lands in the spare column
            pos = count + torch.cumsum(do, dim=1) - 1
            at = torch.where(do & (pos < cap), pos, cap)
            x = x.scatter(1, at, lx)
            meta = meta.scatter(1, at, torch.cat([codes[:L] + (theme << 4), log_codes],
                                                 dim=1))
            count = torch.clamp_max(count + do.sum(dim=1, keepdim=True), cap)
            # move every live slot by its vx, age it
            kind = meta & 15
            active = slots < count
            x = torch.where(active, x + tab["vx"].gather(1, kind), x)
            meta = torch.where(active, meta + 256, meta)
            # erase what left the world (is_out_of_bounds_mask), keeping order
            y, rx, ry = (tab[k].gather(1, kind) for k in ("y", "rx", "ry"))
            out = (x + rx < 0) | (y + ry < 0) | (x - rx > w) | (y - ry > h)
            keep = active & ~(tab["auto_erase"].gather(1, kind) & out)
            src = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
            count = keep.sum(dim=1, keepdim=True)
            x, meta = x.gather(1, src), meta.gather(1, src)
        x, meta = x[:, :cap], meta[:, :cap]
        kind = meta & 15
        out = {k: v.gather(1, kind) for k, v in tab.items()}
        out["x"] = torch.where(kind > 1, x, out["x"])
        out["life_time"] = torch.where(kind > 0, (meta >> 8).to(i32), out["life_time"])
        out["image_theme"] = torch.where((kind >= KIND_CAR) & (kind < KIND_LOG),
                                         ((meta >> 4) & 15).to(i32), out["image_theme"])
        return s.replace(ents=e.replace(count=count[:, 0].to(i32), **out)), d

    def _warm_up_draws(self, s: BasicState, d: rng.Draws):
        """The spawn draws of every warm-up iteration at once: they depend
        on the words alone, not on the pool.  The draws from every position
        of the block give each position's next one; doubling the jumps
        walks the cursor through the iterations.  Returns (d at the
        cursor after them, hit [N, T, 2L], car themes [N, T, L])."""
        n, K = d.block.shape
        T = self.warmup_steps
        every = torch.arange(K, device=d.block.device).expand(n, K)
        used, hit, themes = self._lane_draws(d.block, every, self._roll_consts(s.game))
        nxt = (every + used).clamp_max(K - 1)
        at, jump = d.cursor[:, None].long(), nxt
        while at.shape[1] < T:  # the starts of iterations [0, 2^j), then [2^j, 2^j+1)
            at, jump = torch.cat([at, jump.gather(1, at)], dim=1), jump.gather(1, jump)
        at = at[:, :T]
        last = at[:, -1:]
        d = d.replace(cursor=(last + used.gather(1, last))[:, 0].to(i32))
        return (d, hit.gather(1, at[:, :, None].expand(-1, -1, hit.shape[2])),
                themes.gather(1, at[:, :, None].expand(-1, -1, themes.shape[2])))

    # -- per-step -------------------------------------------------------------

    def game_step(self, s: BasicState, d):
        # frog hop animation frames (leaper.cpp:250-252)
        e = s.ents
        th = e.image_theme[:, 0]
        th = torch.where(th >= 1, torch.remainder(th + 1, FROG_ANIMATION_FRAMES), th)
        s = s.replace(ents=e.set_fields(0, image_theme=th))

        s, d = self.game_step_base(s, d)
        s, d = self._spawn_entities(s, d)

        # standing on a log? (leaper.cpp:258-268; the last one under the
        # frog wins)
        e = s.ents
        margin = -e.rx[:, :1]
        on_log = (e.active & (e.type == LOG)
                  & (torch.abs(e.x[:, :1] - e.x) < e.rx[:, :1] + e.rx + margin)
                  & (torch.abs(e.y[:, :1] - e.y) < e.ry[:, :1] + e.ry + margin))
        standing = on_log.any(dim=1)
        slots = torch.arange(e.cap, device=e.x.device)[None, :]
        last = torch.where(on_log, slots, -1).amax(dim=1).clamp_min(0)
        log_vx = e.vx.gather(1, last[:, None])[:, 0]
        cell = self.get_obj(s, e.x[:, 0].to(i32), e.y[:, 0].to(i32))
        drown = (cell == WATER) & ~standing & (e.vx[:, 0] == 0) & (e.vy[:, 0] == 0)
        s = s.replace(
            done=s.done | drown,
            ents=e.set_fields(0, x=e.x[:, 0] + torch.where(standing, log_vx, 0.0)),
        )
        return s.replace(done=s.done | self.is_out_of_bounds_mask(s)[:, 0]), d
