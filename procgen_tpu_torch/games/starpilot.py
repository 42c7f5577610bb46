"""Starpilot: side-scrolling shooter; kills +1, the finish ship at t=500
+10.  Reference: procgen/src/games/starpilot.cpp; JAX counterpart
procgen_tpu/games/starpilot.py.

The reset rolls the level's whole spawn timeline into a ``spawners`` pool,
sorted by spawn time (starpilot.cpp:226-346); each step releases the due
spawners into the entity pool.  Enemies and turrets fire bullets aimed at
the agent, whose angle is an ``atan2``; the reset's headings are a
``cos`` and a ``sin``.  That trig goes through ``core/libm.py``, glibc's
algorithms as tensor ops, so the state is the JAX package's bit for bit on
every device.  The background scrolls left with time
(``paint_background``).  Every function works on the whole batch: per-env
values are ``[N]`` tensors, per-slot values ``[N, cap]``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import libm, rng
from ..core.constants import EASY_MODE, EXPLOSION, EXTREME_MODE, HARD_MODE, PLAYER
from ..core.entities import SLOT_FIELDS, Entities, default_fields
from ..core.game import BasicAbstractGame, BasicState
from ..render.renderer import scroll_lookup
from .registry import register

i32 = torch.int32
f32 = torch.float32

V_SCALE = 2.0 / 5.0
ENEMY_REWARD = 1.0
COMPLETION_BONUS = 10.0

BULLET_PLAYER = 1
BULLET2 = 2
BULLET3 = 3
FLYER = 4
METEOR = 5
CLOUD = 6
TURRET = 7
FAST_FLYER = 8
FINISH_LINE = 9

SHOOTER_WIN_TIME = 500
NUM_BASIC_OBJECTS = 9
PI = math.pi

SPAWNER_CAP = 288  # <=46 groups x <=6 flyers
MAX_GROUPS = 50  # spawn times start past 10 and step by 10 or more up to 500
MAX_MEMBERS = 6  # the JAX package's member loop; groups have at most 5
# words a reset draws at most: t0, 50 groups of 5 flyers (the type, group
# size, flyer theme, y, 4 a member and the next gap: 25 words), the agent's
# theme
RESET_WORDS = 1 + MAX_GROUPS * 25 + 1


def _f32(v: float) -> float:
    """``v`` rounded to f32, as the JAX package's weakly typed Python float
    constants are, so that every device multiplies by the same f32."""
    return float(torch.tensor(v, dtype=f32))


def _is_lethal(t):
    return ((t == FLYER) | (t == FAST_FLYER) | (t == BULLET2) | (t == BULLET3)
            | (t == TURRET) | (t == METEOR))


def _is_destructible(t):
    return (t == FLYER) | (t == FAST_FLYER) | (t == TURRET) | (t == METEOR)


@dataclasses.dataclass
class StarpilotState:
    spawners: Entities  # [N, SPAWNER_CAP], ascending spawn_time
    spawn_cursor: torch.Tensor  # int32 [N], spawners released so far

    def replace(self, **kw) -> "StarpilotState":
        return dataclasses.replace(self, **kw)


@register("starpilot")
class Starpilot(BasicAbstractGame):
    PALLAS_BG = "scroll"
    name = "starpilot"
    WORLD_DIM_MAX = (16, 16)
    ENT_CAP = 64
    DECOR_CAP = 32  # explosions
    DISPATCH_VECTORIZED = True
    ANY_COLLIDES_WITH_ENTITIES = True
    MAX_STEP_DRAWS = 8
    # enemy bullets aim at the agent (face_direction, starpilot.cpp:389)
    ARB_ROT_TYPES = (1, 2, 3)  # BULLET_PLAYER, BULLET2, BULLET3
    MAX_SUB_STEPS = 6

    def __init__(self, options):
        super().__init__(options)
        mode = options.distribution_mode
        if mode not in (EASY_MODE, HARD_MODE, EXTREME_MODE):
            raise ValueError(f"starpilot does not support mode {mode}")
        self.mode = mode

        # init_hps (starpilot.cpp:147-224)
        self.hp_vs = [1.0] * NUM_BASIC_OBJECTS
        self.hp_healths = [0.0] * NUM_BASIC_OBJECTS
        self.hp_weight = [1.0] * NUM_BASIC_OBJECTS
        self.hp_object_r = [0.5] * NUM_BASIC_OBJECTS
        default_bullet_r = 1 / 2.5
        if mode == EASY_MODE:
            for t in (METEOR, CLOUD, TURRET, FAST_FLYER):
                self.hp_weight[t] = 0.0
            self.hp_vs[FLYER] = 0.75
            self.hp_vs[BULLET2] = 1.25
            self.hp_healths[TURRET] = 5
            self.hp_healths[FLYER] = 2
            self.hp_healths[FAST_FLYER] = 1
            self.maxspeed = 0.75
        elif mode == HARD_MODE:
            self.hp_vs[BULLET2] = 2
            self.hp_healths[TURRET] = 5
            self.hp_healths[FLYER] = 2
            self.hp_healths[FAST_FLYER] = 1
            self.maxspeed = 0.75
        else:
            self.hp_vs[BULLET2] = 2
            self.hp_healths[TURRET] = 10
            self.hp_healths[FLYER] = 5
            self.hp_healths[FAST_FLYER] = 2
            self.maxspeed = 0.5
            default_bullet_r = 1 / 5
        self.hp_bullet_r = [default_bullet_r] * NUM_BASIC_OBJECTS
        self.hp_healths[METEOR] = 500
        self.hp_vs[FAST_FLYER] = 1.5
        self.hp_vs[BULLET_PLAYER] = 2
        self.hp_vs[BULLET3] = 2
        self.hp_object_r[TURRET] = 2.0
        self.hp_object_r[METEOR] = 2.0
        self.hp_object_r[CLOUD] = 2.0
        self.hp_weight[FLYER] = 3.0
        self.hp_slow_v = 0.5
        self.hp_max_group_size = 5
        self.hp_min_dt = 10
        self.hp_max_dt = 30
        self.hp_spawn_right_threshold = 0.9
        self.hp_weight[BULLET_PLAYER] = 0.0
        self.hp_weight[BULLET2] = 0.0
        self.hp_weight[BULLET3] = 0.0
        self.total_weight = sum(self.hp_weight[2:])

    def background_names(self):
        from ..render.assets import SPACE_BACKGROUNDS

        return SPACE_BACKGROUNDS

    def asset_for_type(self, type_):
        # starpilot.cpp:61-109
        if type_ == PLAYER:
            return ["misc_assets/playerShip2_blue.png"]
        if type_ == BULLET_PLAYER:
            return ["misc_assets/towerDefense_tile295.png"]
        if type_ == BULLET2:
            return ["misc_assets/towerDefense_tile296.png"]
        if type_ == BULLET3:
            return ["misc_assets/towerDefense_tile297.png"]
        if type_ in (FLYER, FAST_FLYER):
            return [f"misc_assets/spaceShips_00{i}.png" for i in range(1, 8)]
        if type_ == METEOR:
            return [
                "misc_assets/spaceMeteors_001.png",
                "misc_assets/spaceMeteors_002.png",
                "misc_assets/spaceMeteors_003.png",
                "misc_assets/spaceMeteors_004.png",
                "misc_assets/meteorGrey_big1.png",
                "misc_assets/meteorGrey_big2.png",
                "misc_assets/meteorGrey_big3.png",
                "misc_assets/meteorGrey_big4.png",
            ]
        if type_ == CLOUD:
            return [f"misc_assets/spaceEffect{i}.png" for i in range(1, 10)]
        if type_ == TURRET:
            return [
                "misc_assets/spaceStation_018.png",
                "misc_assets/spaceStation_019.png",
            ]
        if type_ == FINISH_LINE:
            return [f"misc_assets/spaceRockets_00{i}.png" for i in range(1, 5)]
        return []

    # -- the time-scrolled background (starpilot.cpp:107-122) ----------------

    def background_offset(self, s: BasicState, res: int) -> torch.Tensor:
        """The background's x offset in pixels, ``-cur_time * (res / h) *
        hp_slow_v * 2 / 5`` ([N] f32), as XLA computes the JAX package's
        expression: ``* hp_slow_v * 2`` is a multiply by 1, and the
        division by 5 a multiply by the f32 reciprocal of 5."""
        scale = torch.full_like(s.reward, float(res)) / s.main_height.to(f32)
        return -s.cur_time.to(f32) * scale * _f32(1 / 5)

    def paint_background(self, s, res, sx, sy, bg_atlas):
        """18 square tiles of side ``3 * res`` (bg_k = 3, BG_RATIO = 18),
        the top edge at ``-res``, scrolled left by ``background_offset``
        pixels; ``sx`` and ``sy`` are the pixel centres ([1, res]).
        Returns int32 [N, res, res, 3]."""
        pix, _ = bg_atlas.tensors(sx.device)
        BH, BW = pix.shape[1], pix.shape[2]
        bi = s.background_index.long().clamp(0, pix.shape[0] - 1)
        row_idx, col_idx, in_x = scroll_lookup(
            self.background_offset(s, res)[:, None], sx, sy, res, BH, BW)
        samp = pix[bi[:, None, None], row_idx.long()[:, :, None],
                   col_idx.long()[:, None, :]]
        return torch.where(in_x[:, None, :, None], samp.to(i32), 0)

    # -- state ----------------------------------------------------------------

    def game_init_state(self, n, device):
        return StarpilotState(
            spawners=Entities.zeros(n, SPAWNER_CAP, device),
            spawn_cursor=torch.zeros((n,), dtype=i32, device=device),
        )

    def choose_world_dim(self, s):
        return s.replace(main_width=torch.full_like(s.main_width, 16),
                         main_height=torch.full_like(s.main_height, 16))

    # -- collisions -----------------------------------------------------------

    def handle_agent_collision_vec(self, s, d, hit):
        # starpilot.cpp:126-136
        e = s.ents
        finish = (hit & (e.type == FINISH_LINE)).any(dim=1)
        lethal = (hit & _is_lethal(e.type)).any(dim=1)
        return s.replace(
            done=s.done | finish | lethal,
            reward=s.reward + torch.where(finish, COMPLETION_BONUS, 0.0),
            level_complete=s.level_complete | finish,
        ), d

    def dispatch_entity_pairs(self, s, d):
        """Player bullets damage destructibles (starpilot.cpp:138-146), on
        [N, bullet, target] pair matrices.  A bullet erases on its first
        dispatched pair (the reverse inner scan: its highest colliding
        target slot) and the will_erase guard stops the rest, so each
        bullet damages one target; each hit pushes an explosion into the
        decor pool, in bullet slot order."""
        e = s.ents
        cap = e.cap
        slots = torch.arange(cap, device=e.x.device)
        is_pb = e.active & (e.type == BULLET_PLAYER) & ~e.will_erase
        is_target = (e.active & ~e.will_erase & _is_destructible(e.type)
                     & (e.type != CLOUD))
        b = lambda t: t[:, :, None]  # noqa: E731  the bullet axis
        t_ = lambda t: t[:, None, :]  # noqa: E731  the target axis
        dx = torch.abs(b(e.x) - t_(e.x))
        dy = torch.abs(b(e.y) - t_(e.y))
        overlap = (dx < b(e.rx) + t_(e.rx) + b(e.collision_margin)) & (
            dy < b(e.ry) + t_(e.ry) + b(e.collision_margin))
        pair = overlap & b(is_pb) & t_(is_target)
        tgt = torch.where(pair, slots, -1).amax(dim=2)  # [N, bullet]
        pair_win = pair & (slots[None, None, :] == tgt[:, :, None])
        bullet_hit = tgt >= 0
        hits = pair_win.sum(dim=1).to(f32)
        s = s.replace(ents=e.replace(
            will_erase=e.will_erase | bullet_hit,
            health=e.health - torch.where(is_target, hits, 0.0),
        ))
        ti = tgt.clamp_min(0).long()
        f = default_fields(e.x, e.y, e.vx.gather(1, ti), e.vy.gather(1, ti),
                           0.5 * e.rx, 0.5 * e.rx, EXPLOSION)
        return s.replace(decor=s.decor.push_many(f, bullet_hit)), d

    # -- reset ----------------------------------------------------------------

    def game_reset(self, s: BasicState) -> BasicState:
        """add_spawners (starpilot.cpp:226-346): up to 50 groups of up to 5
        members rolled into the spawner pool, then sorted by spawn time.
        Every env draws from one peeked window of ``RESET_WORDS`` words
        (more than one MT block), indexed by its running count: a group
        draws only while its time is at most 500, a member only below its
        group's size.  The loop over the groups finds where each group's
        words start (a group's type sets how many it takes) and its time;
        the members' draws and fields are then read for all groups at
        once."""
        s = self.game_reset_base(s)
        n = s.num
        dev = s.grid.device
        g = s.rand_gen
        _, words = rng.draw_n(g, RESET_WORDS)

        def peek(at):  # the words at ``at`` ([N, ...] positions in the window)
            at = at.clamp(0, RESET_WORDS - 1).long()
            return words.gather(1, at.reshape(n, -1)).reshape(at.shape)

        def randint(x, low, high):  # rng._randint_from of a constant range
            return (x % (high - low) + low).to(i32)

        w = torch.tensor(self.hp_weight[2:], dtype=f32, device=dev)
        total_weight = _f32(self.total_weight)
        cursor = torch.zeros((n,), dtype=torch.int64, device=dev)
        t = 1 + randint(peek(cursor), self.hp_min_dt, self.hp_max_dt)
        cursor = cursor + 1
        starts, times, lives, types = [], [], [], []
        for _ in range(MAX_GROUPS):
            live = t <= SHOOTER_WIN_TIME
            # weighted type selection (starpilot.cpp:233-247): the first
            # type whose running remainder of the start weight is <= 0
            cw = rng._rand01_from(peek(cursor)) * total_weight
            left = []
            for k in range(NUM_BASIC_OBJECTS - 2):
                cw = cw - w[k]
                left.append(cw)
            hit = torch.stack(left, dim=1) <= 0
            type_ = torch.where(hit.any(dim=1), 2 + hit.to(i32).argmax(dim=1),
                                NUM_BASIC_OBJECTS - 1)
            is_flyer = (type_ == FLYER) | (type_ == FAST_FLYER)
            is_turret = type_ == TURRET
            is_mc = (type_ == METEOR) | (type_ == CLOUD)
            # the type, a flyer's group size and theme, y; the members'
            # words; the gap to the next group
            size = torch.where(is_flyer, randint(peek(cursor + 1), 0, 5) + 1, 1)
            per = 3 + is_turret.long() + is_flyer.long() + (is_mc | is_turret).long()
            used = 2 + 2 * is_flyer.long() + size * per
            dt0 = randint(peek(cursor + used), self.hp_min_dt, self.hp_max_dt)
            starts.append(cursor)
            times.append(t)
            lives.append(live)
            types.append(type_)
            cursor = torch.where(live, cursor + used + 1, cursor)
            t = torch.where(live, t + dt0, t)

        s = s.replace(game=StarpilotState(
            spawners=self._roll_spawners(
                peek, torch.stack(starts, 1), torch.stack(times, 1),
                torch.stack(lives, 1), torch.stack(types, 1)),
            spawn_cursor=torch.zeros((n,), dtype=i32, device=dev)))
        agent_theme = rng._randn_from(peek(cursor), self.num_themes(PLAYER))
        g, _ = rng.draw_n(g, RESET_WORDS, cursor + 1)
        return s.replace(
            rand_gen=g,
            ents=s.ents.set_fields(0, rotation=_f32(PI / 2), image_theme=agent_theme),
        )

    def _roll_spawners(self, peek, start, t, live, type_) -> Entities:
        """The spawner pool of every group's members ([N, G] each: the
        group's first word, time, whether it is live, type), pushed in
        group and member order and sorted by spawn time."""
        n, G = start.shape
        dev = start.device
        c = lambda v: v[..., None]  # noqa: E731  [N, G] -> [N, G, 1]
        j = torch.arange(MAX_MEMBERS, device=dev)
        tl = type_.long()
        r_tab = torch.tensor(self.hp_object_r, dtype=f32, device=dev)
        v_tab = torch.tensor(self.hp_vs, dtype=f32, device=dev)
        h_tab = torch.tensor(self.hp_healths, dtype=f32, device=dev)
        nth = {k: self.num_themes(k) for k in (FLYER, CLOUD, METEOR, TURRET)}
        is_flyer = (type_ == FLYER) | (type_ == FAST_FLYER)
        is_turret = type_ == TURRET
        is_mc = (type_ == METEOR) | (type_ == CLOUD)

        # the group's draws after its type word (starpilot.cpp:248-258)
        size = torch.where(is_flyer, rng._randint_from(peek(start + 1), 0, 5) + 1, 1)
        fth = rng._randn_from(peek(start + 2), nth[FLYER])
        o = start + 1 + 2 * is_flyer.long()
        r = r_tab[tl]
        ypos = (16.0 - 2 * r) * rng._rand01_from(peek(o)) + r  # rand_pos(r, 16)

        # the members' draws (starpilot.cpp:259-318), [N, G, 6]: fire time,
        # heading, the zero-heading roll, a turret's fire time, a flyer's
        # side, a meteor's, cloud's or turret's theme
        per = 3 + is_turret.long() + is_flyer.long() + (is_mc | is_turret).long()
        base = c(o + 1) + j * c(per)
        ft0 = rng._randint_from(peek(base), 10, 100)
        th01 = rng._rand01_from(peek(base + 1))
        zro = rng._randint_from(peek(base + 2), 0, 2)
        tft0 = rng._randint_from(peek(base + 3), 20, 30)
        sr01 = rng._rand01_from(peek(base + 3 + c(is_turret.long())))
        xraw = peek(base + 3 + c(is_turret.long() + is_flyer.long()))

        # C++ takes ``(rand01() - .5) * 2 * PI / 4`` in double (the .5 is a
        # double, PI a float) and rounds it to the float theta; its
        # ``-1 * cos(theta) * v_scale`` is the double cos, the product in
        # double, rounded once (libm.sincos_times)
        theta = torch.where((zro == 1) | c(is_mc | is_turret), 0.0,
                            ((th01.double() - 0.5) * (_f32(PI) / 2)).float())
        v_scale = torch.where(is_mc | is_turret, _f32(self.hp_slow_v), v_tab[tl])
        v_scale = c(v_scale * _f32(V_SCALE))
        sin_v, cos_v = libm.sincos_times(theta, v_scale)
        vx = -cos_v
        can_left = self.mode != EASY_MODE
        spawn_right = ~(c(is_flyer) & (sr01 > _f32(self.hp_spawn_right_threshold))
                        & can_left)
        vx = torch.where(spawn_right, vx, -vx)
        theme = torch.where(
            c(type_ == CLOUD), rng._randn_from(xraw, nth[CLOUD]),
            torch.where(c(type_ == METEOR), rng._randn_from(xraw, nth[METEOR]),
                        torch.where(c(is_turret), rng._randn_from(xraw, nth[TURRET]),
                                    torch.where(c(is_flyer), c(fth), 0))))
        ar = self.aspect_of(TURRET, theme.clamp(0, 1))
        rot = torch.where(vx > 0, -1.0, 1.0) * _f32(PI) / 2
        rec = {
            "x": torch.where(spawn_right, c(16.0 + r), c(-r)), "y": c(ypos),
            "vx": vx, "vy": sin_v, "rx": c(r),
            "ry": torch.where(c(is_turret), c(r) / ar, c(r)),
            "type": c(type_), "image_type": c(type_),
            "fire_time": torch.where(c(is_mc), -1, torch.where(c(is_turret), tft0, ft0)),
            "spawn_time": c(t) + j * 5, "health": c(h_tab[tl]), "image_theme": theme,
            "render_z": c(torch.where(type_ == CLOUD, 1, 0)),
            "rotation": torch.where(c(is_flyer), rot, 0.0),
        }
        # default_fields of a type that is neither an explosion nor a trail,
        # the rolled fields over it
        fields = default_fields(0.0, 0.0, 0.0, 0.0, 0.0, 0.0, FLYER)
        fields.update({k: v.expand(n, G, MAX_MEMBERS).reshape(n, G * MAX_MEMBERS)
                       for k, v in rec.items()})
        do = (c(live) & (j < c(size))).reshape(n, G * MAX_MEMBERS)
        spawners = Entities.zeros(n, SPAWNER_CAP, dev).push_many(fields, do)

        # sort ascending by spawn_time (the C++ sorts descending and pops the
        # back, starpilot.cpp:28-30,346)
        key = torch.where(spawners.active, spawners.spawn_time, 10**9)
        order = torch.sort(key, dim=1, stable=True).indices
        return spawners.replace(**{
            k: getattr(spawners, k).gather(1, order) for k in SLOT_FIELDS})

    # -- per-step -------------------------------------------------------------

    def game_step(self, s: BasicState, d):
        s, d = self.game_step_base(s, d)
        e = s.ents
        n, cap = e.x.shape
        dev = e.x.device
        slots = torch.arange(cap, device=dev)[None, :]

        # enemy fire and destruction (starpilot.cpp:366-392), vectorised
        nonplayer = e.active & (slots != 0)
        ft = e.fire_time
        age = s.cur_time[:, None] - e.spawn_time
        turret_fires = (nonplayer & (e.type == TURRET) & (ft > 0)
                        & (torch.remainder(age, ft.clamp_min(1)) == 0))
        other_fires = nonplayer & (e.type != TURRET) & (ft > 0) & (age == ft)
        fires = turret_fires | other_fires

        # bullets aimed at the agent, pushed in reverse slot order (the C++
        # loop is reverse), as one batched push
        btype = torch.where(e.type == TURRET, BULLET3, BULLET2)
        br = torch.tensor(self.hp_bullet_r, dtype=f32, device=dev)[
            e.type.clamp(0, NUM_BASIC_OBJECTS - 1).long()]
        bvx = e.x[:, :1] - e.x
        bvy = e.y[:, :1] - e.y
        norm = torch.sqrt(bvx * bvx + bvy * bvy)
        v_tab = torch.tensor(self.hp_vs, dtype=f32, device=dev)
        sc = v_tab[btype.long()] * _f32(V_SCALE) / norm.clamp_min(_f32(1e-6))
        bx, by = bvx * sc, bvy * sc
        rev = lambda t: t.flip(1)  # noqa: E731
        f = default_fields(rev(e.x), rev(e.y), rev(bx), rev(by), rev(br),
                           rev(br), FLYER)
        f["type"] = f["image_type"] = rev(btype)
        f["rotation"] = rev(-libm.atan2f(by, bx) + _f32(-PI / 2))
        s = s.replace(ents=s.ents.push_many(f, rev(fires)))

        e = s.ents
        dies = (e.active & (slots != 0) & (e.health <= 0)
                & _is_destructible(e.type) & ~e.will_erase)
        s = s.replace(
            reward=s.reward + dies.sum(dim=1).to(f32) * ENEMY_REWARD,
            ents=e.replace(will_erase=e.will_erase | dies),
        )
        f = default_fields(rev(e.x), rev(e.y), rev(e.vx), rev(e.vy),
                           rev(0.5 * e.rx), rev(0.5 * e.rx), EXPLOSION)
        s = s.replace(decor=s.decor.push_many(f, rev(dies)))

        s = self._release_spawners(s)

        # player fire (starpilot.cpp:399-414), forward or, for special
        # action 2, backward
        e = s.ents
        back = s.special_action == 2
        cos_t, vx, vy, rot = (torch.where(back, v_back, v_fwd)
                              for v_fwd, v_back in self._player_fire())
        br = self.hp_bullet_r[PLAYER]
        pb = default_fields(e.x[:, 0] + e.rx[:, 0] * cos_t, e.y[:, 0], vx, vy,
                            br, br, BULLET_PLAYER)
        pb["collides_with_entities"] = True
        pb["rotation"] = rot
        s = s.replace(ents=s.ents.push(pb, do=s.special_action != 0))

        # the finish line at t=500 (starpilot.cpp:416-424)
        at_end = s.cur_time == SHOOTER_WIN_TIME
        d, fth = d.randn_if(at_end, self.num_themes(FINISH_LINE))
        fin_ar = self.aspect_of(FINISH_LINE, fth.clamp(0, 3))
        rx = 8.0 * fin_ar  # match_aspect_ratio(match_width=False)
        ff = default_fields(16.0 + rx, 8.0, -_f32(self.hp_slow_v * V_SCALE), 0.0,
                            rx, 8.0, FINISH_LINE)
        ff["image_theme"] = fth
        return s.replace(ents=s.ents.push(ff, do=at_end)), d

    def _player_fire(self):
        """The player's bullet at its two headings, 0 and pi: (cos, vx, vy,
        rotation) of each, f32 values as Python floats.  The headings are
        constants, so ``core/libm.py`` runs once, on the CPU (it gives the
        same bits on every device)."""
        if not hasattr(self, "_fire_table"):
            theta = torch.tensor([0.0, _f32(PI)], dtype=f32)
            sin, cos = libm.sincosf(theta)
            v_scale = _f32(self.hp_vs[BULLET_PLAYER] * V_SCALE)
            vx, vy = cos * v_scale, sin * v_scale
            rot = -libm.atan2f(vy, vx) - _f32(PI / 2)
            self._fire_table = tuple(tuple(v.tolist()) for v in (cos, vx, vy, rot))
        return self._fire_table

    def _release_spawners(self, s: BasicState) -> BasicState:
        """starpilot.cpp:394-397: the spawners from the cursor on whose
        spawn time is now move to the entity pool, in order.  The run's
        length per env is the JAX while_loop's trip count; one masked
        push of the batch's longest run (a host read) places them all."""
        sp = s.game.spawners
        cursor = s.game.spawn_cursor
        k = torch.arange(SPAWNER_CAP, device=cursor.device)[None, :]
        due = (k < sp.count[:, None]) & (sp.spawn_time == s.cur_time[:, None])
        stop = (k >= cursor[:, None]) & ~due
        run = torch.where(stop, k, SPAWNER_CAP).amin(dim=1) - cursor
        longest = int(run.max()) if run.numel() else 0
        if longest > 0:
            i = torch.arange(longest, device=cursor.device)[None, :]
            src = (cursor[:, None] + i).clamp(0, SPAWNER_CAP - 1).long()
            f = {name: getattr(sp, name).gather(1, src) for name in SLOT_FIELDS}
            s = s.replace(ents=s.ents.push_many(f, i < run[:, None]))
        return s.replace(game=s.game.replace(spawn_cursor=cursor + run.to(i32)))

