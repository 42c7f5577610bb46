"""Bossfight: dodge the boss's attacks and shoot it while its shields are
down; +1 a round, +10 for the kill.  Reference: procgen/src/games/
bossfight.cpp; JAX counterpart procgen_tpu/games/bossfight.py.

The boss lives in slot 1 and its shield in slot 2.  The ``rand_pct*``
values the collision dispatch reads are the previous step's draws (the
C++ dispatch runs inside the base step, before this step's draws), so
they live in the game state.  The reset draws from one peeked window,
the agent's rejection loop included; the step fires up to 19 boss
bullets in one ``push_many``, each bullet's velocity the C++ double
``bv * cos(theta)`` rounded once (``libm.sincos_times``), and pushes
every enemy bullet's laser trail into the decor pool from the highest
slot down.  The boss hits follow the reference's sequential order: a
round crossing raises the shields for the bullets after it
(``dispatch_entity_pairs``).  Every
function works on the whole batch: per-env values are ``[N]`` tensors,
per-slot values ``[N, cap]``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import libm, rng
from ..core.constants import EASY_MODE, EXPLOSION, PLAYER
from ..core.entities import default_fields
from ..core.game import BasicAbstractGame, BasicState, f64_mul, reposition_agent, tree_where
from ..render.renderer import fdiv, rdiv
from .registry import register

i32 = torch.int32
f32 = torch.float32

COMPLETION_BONUS = 10.0
POSITIVE_REWARD = 1.0

PLAYER_BULLET = 1
BOSS = 2
SHIELDS = 3
ENEMY_BULLET = 4
LASER_TRAIL = 5
REFLECTED_BULLET = 6
BARRIER = 7

BOSS_R = 3.0
NUM_ATTACK_MODES = 4
NUM_LASER_THEMES = 3
PLAYER_BULLET_VEL = 1.0
BOTTOM_MARGIN = 6.0
BOSS_VEL_TIMEOUT = 20
BOSS_DAMAGED_TIMEOUT = 40
PI = math.pi
MAX_TRIES = 100  # reposition_agent's retry bound

BOSS_SLOT = 1
SHIELD_SLOT = 2

# The headings' constants as the C++ float expressions round them: PI is a
# float, an integer literal keeps a product in float, a literal with a
# point takes it to double (tests/data/refstate/bossfight_bridge.json
# holds mode 1's turning cross and the shield's height to the C++ bytes).
_f = np.float32
PI_F = float(_f(PI))
# mode 0, PI * 1.5 + (i - 2) * PI / 8: a double sum, rounded once
FAN_THETA = tuple(float(_f(PI_F * 1.5 + float(_f(_f(i - 2) * _f(PI_F)) / _f(8))))
                  for i in range(5))
# mode 1's i * PI / 2, a float
TURN_THETA = tuple(float(_f(_f(i) * _f(PI_F)) / _f(2)) for i in range(4))
# mode 2's 2 * PI / 8 * i, a float
RING_THETA = tuple(float(_f(_f(_f(2) * _f(PI_F)) / _f(8)) * _f(i)) for i in range(8))


@dataclasses.dataclass
class BossfightState:
    attack_modes: torch.Tensor  # int32 [N, 5], one a round
    last_fire_time: torch.Tensor  # int32 [N]
    time_to_swap: torch.Tensor  # int32 [N]
    invulnerable_duration: torch.Tensor  # int32 [N]
    num_rounds: torch.Tensor  # int32 [N]
    round_num: torch.Tensor  # int32 [N]
    round_health: torch.Tensor  # int32 [N]
    curr_vel_timeout: torch.Tensor  # int32 [N]
    attack_mode: torch.Tensor  # int32 [N]
    player_laser_theme: torch.Tensor  # int32 [N]
    boss_laser_theme: torch.Tensor  # int32 [N]
    damaged_until_time: torch.Tensor  # int32 [N]
    shields_are_up: torch.Tensor  # bool [N]
    boss_bullet_vel: torch.Tensor  # f32 [N]
    rand_pct: torch.Tensor  # f32 [N], last step's draws
    rand_fire_pct: torch.Tensor
    rand_pct_x: torch.Tensor
    rand_pct_y: torch.Tensor

    def replace(self, **kw) -> "BossfightState":
        return dataclasses.replace(self, **kw)


@register("bossfight")
class Bossfight(BasicAbstractGame):
    name = "bossfight"
    WORLD_DIM_MAX = (20, 20)
    ENT_CAP = 72
    ARB_ROT_TYPES = {4: 16}  # enemy bullets spin by pi/8 (16 buckets)
    DECOR_CAP = 160  # laser trails (one per enemy bullet a step), explosions
    DECOR_TYPES = frozenset(range(54, 60)) | {LASER_TRAIL}
    DISPATCH_VECTORIZED = True
    ANY_COLLIDES_WITH_ENTITIES = True
    MAX_STEP_DRAWS = 8
    MAX_SUB_STEPS = 6  # maxspeed .85
    VULNERABLE_DURATION = 500
    # the arena never writes the grid and the camera is the whole world,
    # so the background and the cells are per-level constants
    STATIC_RENDER_PREFIX = True

    def __init__(self, options):
        super().__init__(options)
        self.timeout = 4000
        self.mixrate = 0.5
        self.maxspeed = 0.85
        self.center_agent = False
        easy = options.distribution_mode == EASY_MODE
        self._boss_bullet_vel = 0.5 if easy else 0.75
        self.max_extra_invuln = 1 if easy else 3
        self.base_fire_prob = 0.1

    def background_names(self):
        from ..render.assets import SPACE_BACKGROUNDS

        return SPACE_BACKGROUNDS

    def asset_for_type(self, type_):
        # bossfight.cpp:77-108
        if type_ == PLAYER:
            return [
                "misc_assets/playerShip1_blue.png",
                "misc_assets/playerShip1_green.png",
                "misc_assets/playerShip2_orange.png",
                "misc_assets/playerShip3_red.png",
            ]
        if type_ == BOSS:
            return [
                "misc_assets/enemyShipBlack1.png",
                "misc_assets/enemyShipBlue2.png",
                "misc_assets/enemyShipGreen3.png",
                "misc_assets/enemyShipRed4.png",
            ]
        if type_ in (ENEMY_BULLET, PLAYER_BULLET):
            return [
                "misc_assets/laserGreen14.png",
                "misc_assets/laserRed11.png",
                "misc_assets/laserBlue09.png",
            ]
        if type_ == SHIELDS:
            return ["misc_assets/shield2.png"]
        if type_ == BARRIER:
            return [f"misc_assets/spaceMeteors_00{i}.png" for i in range(1, 5)] + [
                f"misc_assets/meteorGrey_big{i}.png" for i in range(1, 5)]
        return []

    def game_init_state(self, n, device):
        def full(v, dtype, shape=()):
            return torch.full((n,) + shape, v, dtype=dtype, device=device)

        return BossfightState(
            attack_modes=full(0, i32, (5,)),
            last_fire_time=full(0, i32), time_to_swap=full(0, i32),
            invulnerable_duration=full(0, i32), num_rounds=full(0, i32),
            round_num=full(0, i32), round_health=full(1, i32),
            curr_vel_timeout=full(0, i32), attack_mode=full(0, i32),
            player_laser_theme=full(0, i32), boss_laser_theme=full(0, i32),
            damaged_until_time=full(0, i32),
            shields_are_up=full(False, torch.bool),
            boss_bullet_vel=full(self._boss_bullet_vel, f32),
            rand_pct=full(0.0, f32), rand_fire_pct=full(0.0, f32),
            rand_pct_x=full(0.0, f32), rand_pct_y=full(0.0, f32),
        )

    def choose_world_dim(self, s):
        return s.replace(main_width=torch.full_like(s.main_width, 20),
                         main_height=torch.full_like(s.main_height, 20))

    def should_draw_entity_mask(self, s):
        """The shield slot shows only while the shields are up."""
        m = torch.ones_like(s.ents.will_erase, dtype=torch.bool)
        m[:, SHIELD_SLOT] = s.game.shields_are_up
        return m

    # -- collisions -----------------------------------------------------------

    def handle_agent_collision_vec(self, s, d, hit):
        # bossfight.cpp:110-122
        e = s.ents
        lethal = (hit & ((e.type == BOSS) | (e.type == BARRIER)
                         | (e.type == ENEMY_BULLET))).any(dim=1)
        return s.replace(done=s.done | lethal), d

    def _prepare_boss(self, s):
        """bossfight.cpp:196-203: the round's attack mode, shields up."""
        g = s.game
        r = torch.remainder(g.round_num, g.num_rounds.clamp_min(1)).clamp(0, 4)
        mode = g.attack_modes.gather(1, r.long()[:, None])[:, 0]
        return s.replace(
            game=g.replace(
                shields_are_up=torch.ones_like(g.shields_are_up),
                curr_vel_timeout=torch.full_like(g.curr_vel_timeout, BOSS_VEL_TIMEOUT),
                time_to_swap=g.invulnerable_duration,
                attack_mode=mode,
            ),
            ents=s.ents.set_fields(BOSS_SLOT, vx=0.0, vy=0.0),
        )

    def dispatch_entity_pairs(self, s, d):
        """Player bullets against the shield and the boss, barriers
        against bullets (bossfight.cpp:133-193), one overlap of every pair
        of slots ([N, cap, cap], the first axis the mover).  The boss hits
        run in reverse slot order, as the reference's dispatch loop does:
        a round crossing raises the shields and blocks every later bullet
        that step, so at most one crossing a step.  A loop over the slots
        that hold a candidate in some env (one host read), batched over
        the envs, carries the health, the shields and whether a round was
        crossed or the boss killed; the round's bookkeeping, the erased
        bullets and their explosions apply once after it."""
        e = s.ents
        g = s.game
        a = lambda t: t[:, :, None]  # noqa: E731  the mover axis
        b = lambda t: t[:, None, :]  # noqa: E731  the target axis
        overlap = ((torch.abs(a(e.x) - b(e.x)) < a(e.rx) + b(e.rx) + a(e.collision_margin))
                   & (torch.abs(a(e.y) - b(e.y)) < a(e.ry) + b(e.ry) + a(e.collision_margin)))

        # the shield reflects player bullets, at last step's rand_pct
        is_pb = e.active & (e.type == PLAYER_BULLET) & ~e.will_erase
        hit_shield = (is_pb & overlap[:, :, SHIELD_SLOT]
                      & (g.shields_are_up & e.active[:, SHIELD_SLOT])[:, None])
        # PI * (1.25 + .5 * rand_pct) and PLAYER_BULLET_VEL * sin(theta) * .5
        # in double, each rounded once
        theta = (PI_F * (1.25 + 0.5 * g.rand_pct.double())).float()
        sin_t, cos_t = libm.sincos_times(
            theta, torch.full_like(theta, PLAYER_BULLET_VEL * 0.5))
        rvy, rvx = sin_t[:, None], cos_t[:, None]
        e0 = e.replace(
            type=torch.where(hit_shield, REFLECTED_BULLET, e.type).to(i32),
            vy=torch.where(hit_shield, rvy, e.vy),
            vx=torch.where(hit_shield, rvx, e.vx),
            expire_time=torch.where(hit_shield, 4, e.expire_time).to(i32),
            life_time=torch.where(hit_shield, 0, e.life_time).to(i32),
            alpha_decay=torch.where(hit_shield, 0.8, e.alpha_decay),
        )

        # the boss hits, highest slot first
        cand = (e0.active & (e0.type == PLAYER_BULLET) & ~e0.will_erase
                & overlap[:, :, BOSS_SLOT])
        health = e0.health[:, BOSS_SLOT]
        shields = g.shields_are_up
        crossed_any = torch.zeros_like(shields)
        killed_any = torch.zeros_like(shields)
        round_health = g.round_health.clamp_min(1)
        hit_mask = torch.zeros_like(cand)
        for i in reversed(torch.nonzero(cand.any(dim=0)).flatten().tolist()):
            hit = cand[:, i] & ~shields
            health = health - torch.where(hit, 1.0, 0.0)
            crossed = hit & (torch.remainder(health.to(i32), round_health) == 0)
            killed = crossed & (health == 0)
            shields = shields | (crossed & ~killed)
            crossed_any = crossed_any | crossed
            killed_any = killed_any | killed
            hit_mask[:, i] = hit
        new_round = crossed_any & ~killed_any
        any_hit = hit_mask.any(dim=1)
        s = s.replace(
            ents=e0.set_fields_where(BOSS_SLOT, any_hit, health=health).replace(
                will_erase=e0.will_erase | hit_mask),
            reward=(s.reward + torch.where(crossed_any, POSITIVE_REWARD, 0.0)
                    + torch.where(killed_any, COMPLETION_BONUS, 0.0)),
            done=s.done | killed_any,
            level_complete=s.level_complete | killed_any,
            game=g.replace(round_num=g.round_num + new_round.to(i32)),
        )
        prepped = self._prepare_boss(s)
        prepped = prepped.replace(game=prepped.game.replace(
            curr_vel_timeout=torch.full_like(g.curr_vel_timeout, BOSS_DAMAGED_TIMEOUT),
            damaged_until_time=s.cur_time + BOSS_DAMAGED_TIMEOUT,
        ))
        s = tree_where(new_round, prepped, s)

        # the explosions take the boss's velocity, pushed highest slot first
        e2 = s.ents
        half_r = (0.5 * e2.rx).flip(1)
        bx = default_fields(e2.x.flip(1), e2.y.flip(1), e2.vx[:, BOSS_SLOT:BOSS_SLOT + 1],
                            e2.vy[:, BOSS_SLOT:BOSS_SLOT + 1], half_r, half_r, EXPLOSION)
        s = s.replace(decor=s.decor.push_many(bx, hit_mask.flip(1)))

        # barriers erase bullets; a spent barrier explodes
        e = s.ents
        is_barrier = e.active & (e.type == BARRIER)
        is_bullet = e.active & ((e.type == ENEMY_BULLET) | (e.type == PLAYER_BULLET))
        pair = overlap & a(is_barrier) & b(is_bullet)
        bullet_die = pair.any(dim=1)
        barrier_die = is_barrier & (e.health <= 0) & pair.any(dim=2)
        die = bullet_die | barrier_die
        s = s.replace(ents=e.replace(will_erase=e.will_erase | die))
        bf = default_fields(e.x, e.y, e.vx, e.vy, 0.5 * e.rx, 0.5 * e.rx, EXPLOSION)
        return s.replace(decor=s.decor.push_many(bf, die)), d

    # -- reset ----------------------------------------------------------------

    def game_reset(self, s: BasicState) -> BasicState:
        s = self.game_reset_base(s)
        n = s.num
        dev = s.grid.device
        # one window holds every draw: 12 before the agent, at most
        # 2 * (MAX_TRIES + 1) for it, 11 after
        d, norm = rng.peek_block(s.rand_gen, rng.N)

        # the boss and its shield (bossfight.cpp:216-224): slots 1 and 2
        d, boss_theme = d.randn(self.num_themes(BOSS))
        boss_ar = self.aspect_of(BOSS, boss_theme)
        bf = default_fields(10.0, 10.0, 0.0, 0.0, BOSS_R, rdiv(BOSS_R, boss_ar), BOSS)
        bf["image_theme"] = boss_theme
        s = s.replace(ents=s.ents.push(bf))
        # the shield 1.2 times the boss, its height in double
        s = s.replace(ents=s.ents.push(default_fields(
            10.0, 10.0, 0.0, 0.0, 1.2 * BOSS_R, f64_mul(bf["ry"], 1.2), SHIELDS)))

        d, rh0 = d.randn(9)
        round_health = rh0 + 1
        d, nr0 = d.randn(5)
        num_rounds = nr0 + 1
        d, inv0 = d.randn(self.max_extra_invuln + 1)
        s = s.replace(ents=s.ents.set_fields(
            BOSS_SLOT, health=(round_health * num_rounds).to(f32)))

        d, agent_theme = d.randn(self.num_themes(PLAYER))
        d, pl_theme = d.randn(NUM_LASER_THEMES)
        d, bl_theme = d.randn(NUM_LASER_THEMES)
        modes = []
        for i in range(5):
            on = i < num_rounds
            d, m0 = d.randn_if(on, NUM_ATTACK_MODES)
            modes.append(torch.where(on, m0, 0))

        g = self.game_init_state(n, dev)
        s = s.replace(game=g.replace(
            attack_modes=torch.stack(modes, dim=1).to(i32),
            invulnerable_duration=(inv0 + 2).to(i32),
            num_rounds=num_rounds.to(i32),
            round_health=round_health.to(i32),
            player_laser_theme=pl_theme.to(i32),
            boss_laser_theme=bl_theme.to(i32),
        ))
        s = self._prepare_boss(s)

        # the agent (bossfight.cpp:240-244): reposition_agent, then the
        # bottom row
        agent_ar = self.aspect_of(PLAYER, agent_theme)
        s = s.replace(ents=s.ents.set_fields(
            0, rx=0.75, ry=rdiv(0.75, agent_ar), image_theme=agent_theme))
        d, ax, _ = reposition_agent(d, s.ents, 20.0, 20.0, MAX_TRIES)
        s = s.replace(ents=s.ents.set_fields(0, x=ax, y=s.ents.ry[:, 0]))

        d, _ = d.randbool()  # barriers_moves_right (the barriers stay put)

        # spawn_barriers (bossfight.cpp:328-346), each blocked by anything
        # in either pool
        d, nb0 = d.randn(3)
        barrier_r = 0.6
        min_y = 2 * s.ents.ry[:, 0] + barrier_r + 0.5
        for i in range(3):
            do = i < nb0 + 1
            d, y01 = d.rand01_if(do)
            ent_y = y01 * (BOTTOM_MARGIN - min_y - barrier_r) + min_y
            d, x01 = d.rand01_if(do)
            ent_x = x01 * (20.0 - 2 * barrier_r) + barrier_r
            d, th0 = d.randn_if(do, self.num_themes(BARRIER))
            ry = rdiv(barrier_r, self.aspect_of(BARRIER, th0))
            f = default_fields(ent_x, ent_y, 0.0, 0.0, barrier_r, ry, BARRIER)
            f["image_theme"] = th0
            f["health"] = 3.0
            f["collides_with_entities"] = True
            hit = self.spawn_blocked(s, ent_x, ent_y, barrier_r, ry)
            s = s.replace(ents=s.ents.push(f, do=do & ~hit))
        return s.replace(rand_gen=rng.commit(norm, d))

    # -- per-step -------------------------------------------------------------

    def _bullet_theta(self, g, t):
        """The 19 headings of the passive shot and attack modes 0-3
        (bossfight.cpp:265-337), f32 [N, 19], and whether each fires (bool
        [N, 19]); ``t`` is the step's clock."""
        damaged = g.damaged_until_time >= t
        active = ~damaged & g.shields_are_up
        passive = ~damaged & ~g.shields_are_up
        mode = g.attack_mode
        aimed = PI * (1 + g.rand_pct)
        thetas, dos = [aimed], [passive & (g.rand_fire_pct < self.base_fire_prob)]
        # mode 0: a fan of 5 every 8 steps
        m0 = active & (mode == 0) & (torch.remainder(t, 8) == 0)
        for i in range(5):
            thetas.append(torch.full_like(aimed, FAN_THETA[i]))
            dos.append(m0)
        # mode 1: a turning cross of 4 every 5 steps
        k = torch.abs(8 - torch.remainder(torch.div(t, 5, rounding_mode="floor"), 16))
        m1 = active & (mode == 1) & (torch.remainder(t, 5) == 0)
        turn = PI_F * (1.25 + 0.5 * k.double() / 8.0)  # in double
        for i in range(4):
            thetas.append((turn + TURN_THETA[i]).float())
            dos.append(m1)
        # mode 2: a ring of 8 every 10 steps at a random offset
        m2 = active & (mode == 2) & (torch.remainder(t, 10) == 0)
        for i in range(8):
            thetas.append(RING_THETA[i] + g.rand_pct * 2 * PI)
            dos.append(m2)
        # mode 3: one aimed down every 4 steps
        thetas.append(aimed)
        dos.append(active & (mode == 3) & (torch.remainder(t, 4) == 0))
        return torch.stack(thetas, dim=1), torch.stack(dos, dim=1)

    def game_step(self, s: BasicState, d):
        s, d = self.game_step_base(s, d)
        e = s.ents
        # the shield follows the boss (bossfight.cpp:352-353)
        s = s.replace(ents=e.set_fields(SHIELD_SLOT, x=e.x[:, BOSS_SLOT],
                                        y=e.y[:, BOSS_SLOT]))
        d, rp = d.rand01()
        d, rfp = d.rand01()
        d, rpx = d.rand01()
        d, rpy = d.rand01()
        g = s.game.replace(rand_pct=rp, rand_fire_pct=rfp, rand_pct_x=rpx, rand_pct_y=rpy)

        # the boss's course and the shield swap (bossfight.cpp:360-381)
        timeout_hit = g.curr_vel_timeout <= 0
        e = s.ents
        dest_x = rpx * (20.0 - 2 * BOSS_R) + BOSS_R
        dest_y = rpy * (20.0 - 2 * BOSS_R - BOTTOM_MARGIN) + BOSS_R + BOTTOM_MARGIN
        nvx = fdiv(dest_x - e.x[:, BOSS_SLOT], float(BOSS_VEL_TIMEOUT))
        nvy = fdiv(dest_y - e.y[:, BOSS_SLOT], float(BOSS_VEL_TIMEOUT))
        e = e.set_fields_where(BOSS_SLOT, timeout_hit, vx=nvx, vy=nvy)
        swap = timeout_hit & (g.time_to_swap <= 0)
        tts = torch.where(
            timeout_hit,
            torch.where(swap, torch.where(g.shields_are_up, self.VULNERABLE_DURATION,
                                          g.invulnerable_duration),
                        g.time_to_swap - 1),
            g.time_to_swap)
        g = g.replace(
            time_to_swap=tts.to(i32),
            shields_are_up=torch.where(swap, ~g.shields_are_up, g.shields_are_up),
            curr_vel_timeout=torch.where(timeout_hit, BOSS_VEL_TIMEOUT,
                                         g.curr_vel_timeout - 1).to(i32),
        )

        # the player's shot (bossfight.cpp:383-390)
        fire = (s.special_action == 1) & (s.cur_time - g.last_fire_time >= 3)
        pb = default_fields(e.x[:, 0], e.y[:, 0], 0.0, PLAYER_BULLET_VEL, 0.25, 0.25,
                            PLAYER_BULLET)
        pb["image_theme"] = g.player_laser_theme
        pb["collides_with_entities"] = True
        pb["expire_time"] = 25
        e = e.push(pb, do=fire)
        g = g.replace(last_fire_time=torch.where(fire, s.cur_time, g.last_fire_time))

        # the attacks (bossfight.cpp:265-337, 392-398), one push_many
        bx0, by0 = e.x[:, BOSS_SLOT:BOSS_SLOT + 1], e.y[:, BOSS_SLOT:BOSS_SLOT + 1]
        # boss_bullet_vel * cos(theta) in double, rounded once
        theta, dos = self._bullet_theta(g, s.cur_time)
        vy, vx = libm.sincos_times(theta, g.boss_bullet_vel[:, None].expand_as(theta))
        f = default_fields(bx0, by0, vx, vy, 0.5, 0.5, ENEMY_BULLET)
        f["image_theme"] = g.boss_laser_theme[:, None]
        f["expire_time"] = 50
        f["vrot"] = PI / 8
        e2 = e.push_many(f, dos)

        # the damaged hull's explosions, every third step (bossfight.cpp:308-315)
        dmg = (g.damaged_until_time >= s.cur_time) & (torch.remainder(s.cur_time, 3) == 0)
        ex = default_fields(
            bx0[:, 0] + (2 * rpx - 1) * e.rx[:, BOSS_SLOT],
            by0[:, 0] + (2 * rpy - 1) * e.ry[:, BOSS_SLOT],
            0.0, 0.0, 0.75, 0.75, EXPLOSION)
        decor = s.decor.push(ex, do=dmg)

        # a laser trail per enemy bullet, highest slot first (bossfight.cpp:400-414)
        is_eb = e2.active & (e2.type == ENEMY_BULLET)
        tf = default_fields(e2.x.flip(1), e2.y.flip(1), (e2.vx * 0.5).flip(1),
                            (e2.vy * 0.5).flip(1), e2.rx.flip(1), e2.ry.flip(1),
                            LASER_TRAIL)
        tf["alpha_decay"] = 0.7
        tf["image_type"] = ENEMY_BULLET
        tf["image_theme"] = g.boss_laser_theme[:, None]
        tf["vrot"] = e2.vrot.flip(1)
        tf["rotation"] = e2.rotation.flip(1)
        tf["expire_time"] = 8
        decor = decor.push_many(tf, is_eb.flip(1))
        return s.replace(ents=e2, decor=decor, game=g), d
