"""CoinRun: run right to the coin (+10); saws, enemies, lava and chasms
kill.  Reference: procgen/src/games/coinrun.cpp; JAX counterpart
procgen_tpu/games/coinrun.py.

Platformer physics (gravity, air control, jumps, one-way crate support),
the section-based level generator drawing from one 624-word block, patrol
enemies reflecting off walls and barrier cells, and enemy trails in the
decorative pool.  Every function works on the whole batch: per-env values
are ``[N]`` tensors, per-slot values ``[N, cap]``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import rng
from ..core.constants import EASY_MODE, PLAYER, TRAIL
from ..core.entities import default_fields, stack_records
from ..core.game import BasicAbstractGame, BasicState, _where, per_env
from .registry import register

i32 = torch.int32
f32 = torch.float32

GOAL_REWARD = 10.0

GOAL = 1
SAW = 2
SAW2 = 3
ENEMY = 5
ENEMY1 = 6
ENEMY2 = 7
PLAYER_JUMP = 9
PLAYER_RIGHT1 = 12
PLAYER_RIGHT2 = 13
WALL_MID = 15
WALL_TOP = 16
LAVA_MID = 17
LAVA_TOP = 18
ENEMY_BARRIER = 19
CRATE = 20

WALKING_ENEMIES = [
    "slimeBlock", "slimePurple", "slimeBlue", "slimeGreen", "mouse",
    "snail", "ladybug", "wormGreen", "wormPink",
]
PLAYER_THEME_COLORS = ["Beige", "Blue", "Green", "Pink", "Yellow"]
GROUND_THEMES = ["Dirt", "Grass", "Planet", "Sand", "Snow", "Stone"]

GRAVITY = 0.2
AIR_CONTROL = 0.15


def _is_wall(t):
    return (t == WALL_MID) | (t == WALL_TOP)


def _is_lava(t):
    return (t == LAVA_MID) | (t == LAVA_TOP)


@dataclasses.dataclass
class CoinrunState:
    last_agent_y: torch.Tensor  # f32 [N]
    wall_theme: torch.Tensor  # int32 [N]
    has_support: torch.Tensor  # bool [N]
    facing_right: torch.Tensor  # bool [N]
    is_on_crate: torch.Tensor  # bool [N]

    def replace(self, **kw) -> "CoinrunState":
        return dataclasses.replace(self, **kw)


@register("coinrun")
class Coinrun(BasicAbstractGame):
    name = "coinrun"
    WORLD_DIM_MAX = (64, 64)
    ENT_CAP = 48
    DECOR_CAP = 96  # enemy trails (expire in 8 steps); overflow drops extras
    MAX_STEP_DRAWS = 8
    MAX_SUB_STEPS = 8  # |v| <= sqrt(.5^2+1.5^2)=1.58 -> 6 sub-steps
    ENTITY_SCAN = True  # crate landing (vectorised override below)
    DISPATCH_VECTORIZED = True  # handlers commute (death + goal/lava)
    ONLY_AGENT_SMART = False  # patrol enemies are smart_step
    SMART_VECTORIZABLE = True  # enemies only reflect off grid cells
    MAX_SMART = 16

    def __init__(self, options):
        super().__init__(options)
        self.visibility = 13.0
        self.mixrate = 0.2
        self.out_of_bounds_object = WALL_MID

    def background_names(self):
        from ..render.assets import PLATFORM_BACKGROUNDS

        return PLATFORM_BACKGROUNDS

    def use_block_asset(self, type_):
        return type_ in (WALL_MID, WALL_TOP)

    def asset_for_type(self, type_):
        # coinrun.cpp:75-127
        if type_ == PLAYER:
            return [f"kenney/Players/128x256/{c}/alien{c}_stand.png" for c in PLAYER_THEME_COLORS]
        if type_ == PLAYER_JUMP:
            return [f"kenney/Players/128x256/{c}/alien{c}_jump.png" for c in PLAYER_THEME_COLORS]
        if type_ == PLAYER_RIGHT1:
            return [f"kenney/Players/128x256/{c}/alien{c}_walk1.png" for c in PLAYER_THEME_COLORS]
        if type_ == PLAYER_RIGHT2:
            return [f"kenney/Players/128x256/{c}/alien{c}_walk2.png" for c in PLAYER_THEME_COLORS]
        if type_ == ENEMY1:
            return [f"kenney/Enemies/{e}.png" for e in WALKING_ENEMIES]
        if type_ == ENEMY2:
            return [f"kenney/Enemies/{e}_move.png" for e in WALKING_ENEMIES]
        if type_ == GOAL:
            return ["kenney/Items/coinGold.png"]
        if type_ == WALL_TOP:
            return [f"kenney/Ground/{g}/{g.lower()}Mid.png" for g in GROUND_THEMES]
        if type_ == WALL_MID:
            return [f"kenney/Ground/{g}/{g.lower()}Center.png" for g in GROUND_THEMES]
        if type_ == LAVA_TOP:
            return ["kenney/Tiles/lavaTop_low.png"]
        if type_ == LAVA_MID:
            return ["kenney/Tiles/lava.png"]
        if type_ == SAW:
            return ["kenney/Enemies/sawHalf.png"]
        if type_ == SAW2:
            return ["kenney/Enemies/sawHalf_move.png"]
        if type_ == CRATE:
            return [
                "kenney/Tiles/boxCrate.png",
                "kenney/Tiles/boxCrate_double.png",
                "kenney/Tiles/boxCrate_single.png",
                "kenney/Tiles/boxCrate_warning.png",
            ]
        return []

    def adjust_image_rect(self, img, x0, y0, w2, h2):
        # coinrun.cpp:64-70: the player sprite extends 0.7415*h above the
        # hitbox
        p = (img == PLAYER) | (img == PLAYER_JUMP) | (img == PLAYER_RIGHT1) | (
            img == PLAYER_RIGHT2
        )
        return (
            x0,
            torch.where(p, y0 - 0.7415 * h2, y0),
            w2,
            torch.where(p, 1.7415 * h2, h2),
        )

    def game_init_state(self, n, device):
        return CoinrunState(
            last_agent_y=torch.zeros((n,), dtype=f32, device=device),
            wall_theme=torch.zeros((n,), dtype=i32, device=device),
            has_support=torch.zeros((n,), dtype=torch.bool, device=device),
            facing_right=torch.ones((n,), dtype=torch.bool, device=device),
            is_on_crate=torch.zeros((n,), dtype=torch.bool, device=device),
        )

    def choose_world_dim(self, s):
        return s.replace(
            main_width=torch.full_like(s.main_width, 64),
            main_height=torch.full_like(s.main_height, 64),
        )

    # -- physics hooks ------------------------------------------------------

    def is_blocked(self, s, src_type, target_type, is_horizontal):
        b = super().is_blocked(s, src_type, target_type, is_horizontal)
        return b | ((src_type == PLAYER) & _is_wall(target_type))

    def will_reflect(self, src_type, target_type):
        return (src_type == ENEMY) & (
            _is_wall(target_type) | (target_type == ENEMY_BARRIER)
        )

    def _entity_scan(self, s, rec, vx, vy, depth):
        """Vectorised crate landing (coinrun.cpp:187-202): the agent, falling,
        lands on the top of the tallest crate it overlaps; one grid-resolved
        displacement replaces the C++ push chain (the JAX package's
        equivalence).  ``rec`` is the agent's record, ``[N]`` fields."""
        e = s.ents
        horiz = vx != 0
        slots = torch.arange(self.ENT_CAP, device=e.x.device)
        valid = e.active & (slots != 0) & ~e.will_erase & (e.type == CRATE)
        c = lambda t: t[:, None]  # noqa: E731  [N] -> [N, 1]
        coll = (
            (torch.abs(c(rec["x"]) - e.x) < c(rec["rx"]) + e.rx + (-0.001))
            & (torch.abs(c(rec["y"]) - e.y) < c(rec["ry"]) + e.ry + (-0.001))
        )
        top_all = e.y + e.ry + c(rec["ry"])
        landing = (
            valid
            & coll
            & c(~horiz)
            & c(rec["vy"] < 0)
            & c(s.action_vy >= 0)
            & (c(s.game.last_agent_y) >= top_all)
            & c(~rec["will_erase"])
        )
        any_hit = landing.any(dim=1)
        top = torch.where(landing, top_all, -torch.inf).amax(dim=1)

        t_vy = torch.where(any_hit, top - rec["y"], 0.0)
        # grid resolution of the push displacement (push_obj -> sub_step)
        _, rec2, _ = self._sub_step_rec(
            s, rec, torch.zeros_like(t_vy), t_vy, self.PUSH_DEPTH, False
        )
        rec = {k: rec[k] if rec2[k] is rec[k] else torch.where(any_hit, rec2[k], rec[k])
               for k in rec}
        rec["vy"] = torch.where(any_hit, 0.0, rec["vy"])
        s = s.replace(
            game=s.game.replace(is_on_crate=s.game.is_on_crate | any_hit)
        )
        return s, rec, any_hit

    def _can_support(self, t):
        return _is_wall(t) | (t == self.out_of_bounds_object)

    def set_action_xy(self, s, move_action):
        # coinrun.cpp:452-476
        avx = (torch.div(move_action, 3, rounding_mode="floor") - 1).to(f32)
        avy = (torch.remainder(move_action, 3) - 1).to(f32)
        g = s.game
        facing = torch.where(avx > 0, True, torch.where(avx < 0, False, g.facing_right))
        e = s.ents
        x0, y0, rx0, ry0 = e.x[:, 0], e.y[:, 0], e.rx[:, 0], e.ry[:, 0]
        b1 = self.get_obj_from_floats(s, x0 - (rx0 - 0.01), y0 - (ry0 + 0.01))
        b2 = self.get_obj_from_floats(s, x0 + (rx0 - 0.01), y0 - (ry0 + 0.01))
        has_support = (
            g.is_on_crate | self._can_support(b1) | self._can_support(b2)
        ) & (e.vy[:, 0] == 0)
        avy = torch.where((avy == 1) & ~has_support, 0.0, avy)
        return s.replace(
            action_vx=avx,
            action_vy=avy,
            action_vrot=torch.zeros_like(s.action_vrot),
            game=g.replace(
                facing_right=facing,
                has_support=has_support,
                is_on_crate=torch.zeros_like(g.is_on_crate),
            ),
        )

    def update_agent_velocity(self, s):
        # coinrun.cpp:160-177; every product and sum rounds on its own
        g = s.game
        e = s.ents
        mixrate_x = torch.where(g.has_support, s.mixrate, s.mixrate * AIR_CONTROL)
        vx = (1 - mixrate_x) * e.vx[:, 0] + mixrate_x * s.maxspeed * s.action_vx
        vx = torch.where(torch.abs(vx) < mixrate_x * s.maxspeed, 0.0, vx)
        vy = e.vy[:, 0]
        vy = torch.where(
            s.action_vy > 0,
            s.max_jump,
            torch.where(g.has_support, vy + 0.2 * s.action_vy, vy),
        )
        apply_grav = ~(g.has_support & (s.action_vy > 0))
        vy_g = torch.minimum(torch.maximum(vy - GRAVITY, -s.max_jump), s.max_jump)
        vy = torch.where(apply_grav, vy_g, vy)
        return s.replace(ents=e.set_fields(0, vx=vx, vy=vy))

    # -- collision handlers -------------------------------------------------

    def handle_agent_collision_vec(self, s, d, hit):
        # coinrun.cpp:129-137
        e = s.ents
        deadly = (hit & ((e.type == ENEMY) | (e.type == SAW))).any(dim=1)
        return s.replace(done=s.done | deadly), d

    def handle_grid_collision(self, s, d, slot, type_, ix, iy):
        is_player = s.ents.type[:, slot] == PLAYER
        goal = is_player & (type_ == GOAL)
        lava = is_player & _is_lava(type_)
        return s.replace(
            reward=s.reward + torch.where(goal, GOAL_REWARD, 0.0),
            done=s.done | goal | lava,
            level_complete=s.level_complete | goal,
        ), d

    # -- rendering hooks ----------------------------------------------------

    def theme_for_grid_obj(self, s, type_):
        return torch.where(_is_wall(type_), per_env(s.game.wall_theme, type_), 0).to(i32)

    def image_for_type(self, s, type_):
        # coinrun.cpp:222-234
        e = s.ents
        standing = (
            (torch.abs(e.vx[:, 0]) < 0.01) & (s.action_vx == 0) & s.game.has_support
        )
        walk_frame = torch.where(
            (torch.remainder(torch.div(s.cur_time, 5, rounding_mode="floor"), 2) == 0)
            | ~s.game.has_support,
            PLAYER_RIGHT1,
            PLAYER_RIGHT2,
        )
        player_img = per_env(torch.where(standing, PLAYER, walk_frame), type_)
        out = torch.abs(type_)
        out = torch.where(type_ == PLAYER, player_img, out)
        out = torch.where(type_ == ENEMY_BARRIER, -1, out)
        return out.to(i32)

    # -- level generation ---------------------------------------------------

    def _fill_block_top(self, s, x, y, dx, dy, fill, top):
        s = self.fill_elem(s, x, y, dx, dy - 1, fill)
        return self.fill_elem(s, x, y + dy - 1, dx, 1, top)

    def _saw_record(self, x, y):
        return default_fields(x + 0.5, y + 0.5, 0.0, 0.0, 0.5, 0.5, SAW)

    def _enemy_record(self, d, x, y, do):
        d, dir_ = d.randn_if(do, 2)
        d, theme = d.randn_if(do, self.num_themes(ENEMY1))
        f = default_fields(
            x + 0.5, y + 0.5, 0.15 * (dir_ * 2 - 1).to(f32), 0.0, 0.5, 0.5, ENEMY,
        )
        f["smart_step"] = True
        f["image_type"] = ENEMY1
        f["render_z"] = 1
        f["image_theme"] = theme
        return d, f

    def _crate_record(self, d, x, y, do):
        d, theme = d.randn_if(do, self.num_themes(CRATE))
        f = default_fields(x + 0.5, y + 0.5, 0.0, 0.0, 0.5, 0.5, CRATE)
        f["image_theme"] = theme
        return d, f

    def game_reset(self, s: BasicState) -> BasicState:
        s = self.game_reset_base(s)
        n = s.num
        dev = s.grid.device
        s = s.replace(
            maxspeed=torch.full((n,), 0.5, dtype=f32, device=dev),
            max_jump=torch.full((n,), 1.5, dtype=f32, device=dev),
        )

        if self.options.distribution_mode == EASY_MODE:
            s = s.replace(
                ents=s.ents.set_fields(0, image_theme=0),
                background_index=torch.zeros_like(s.background_index),
            )
            wall_theme = torch.zeros((n,), dtype=i32, device=dev)
        else:
            s = self.choose_random_theme(s, 0, PLAYER)
            s, wall_theme = self.randn(s, len(GROUND_THEMES))

        ay = 1 + 0.5787
        state = self.game_init_state(n, dev)
        s = s.replace(
            ents=s.ents.set_fields(0, rx=0.5, ry=0.5787, x=1.5, y=ay),
            game=state.replace(
                last_agent_y=torch.full((n,), ay, dtype=f32, device=dev),
                wall_theme=wall_theme,
            ),
        )

        # init_floor_and_walls (coinrun.cpp:253-258)
        w, h = 64, 64
        s = self.fill_elem(s, 0, 0, w, 1, WALL_TOP)
        s = self.fill_elem(s, 0, 0, 1, h, WALL_MID)
        s = self.fill_elem(s, w - 1, 0, 1, h, WALL_MID)
        s = self.fill_elem(s, 0, h - 1, w, 1, WALL_MID)

        return self._generate_coin_to_the_right(s)

    def _generate_coin_to_the_right(self, s: BasicState) -> BasicState:
        """coinrun.cpp:265-414: straight-line sections drawn from one
        pre-tempered 624-word block; every branch runs on every env with
        its draws and writes masked, as in the JAX package."""
        opts = self.options
        n = s.num
        dev = s.grid.device
        d, norm = rng.peek_block(s.rand_gen, rng.N)
        s = s.replace(rand_gen=norm)
        d, dif0 = d.randn(3)
        dif = dif0 + 1
        d, ns0 = d.randn(dif)
        num_sections = ns0 + dif
        pit_threshold = dif
        d, danger_type = d.randn(3)

        allow_pit = (opts.debug_mode & (1 << 1)) == 0
        allow_crate = (opts.debug_mode & (1 << 2)) == 0
        allow_dy = (opts.debug_mode & (1 << 3)) == 0
        allow_monsters = opts.distribution_mode != EASY_MODE

        max_jump, gravity, maxspeed = 1.5, GRAVITY, 0.5
        max_dy = int(max_jump * max_jump / (2 * gravity) - 0.5)  # 5
        max_dx = int(maxspeed * 2 * max_jump / gravity - 0.5)  # 7

        w = 64
        curr_x = torch.full((n,), 5, dtype=i32, device=dev)
        curr_y = torch.full((n,), 1, dtype=i32, device=dev)
        ended = torch.zeros((n,), dtype=torch.bool, device=dev)
        dif3 = torch.div(dif, 3, rounding_mode="floor")
        # entity records accumulate across sections; one batched push at
        # the end keeps the C++ creation order
        all_recs: list = []
        all_dos: list = []

        def masked_grid(cond, s_new, s_old):
            return s_old.replace(grid=_where(cond, s_new.grid, s_old.grid))

        for section in range(5):  # num_sections <= 2*3-1 = 5
            live = (section < num_sections) & ~ended
            hit_end = curr_x + 15 >= w
            ended = ended | (live & hit_end)
            live = live & ~hit_end

            d, dy0 = d.randn_if(live, 4)
            dy = dy0 + 1 + dif3
            if not allow_dy:
                dy = torch.zeros_like(dy)
            dy = torch.clamp_max(dy, max_dy)

            mid_band = (curr_y >= 5) & (curr_y < 20)
            d, flip0 = d.randn_if(live & mid_band, 2)
            neg = (curr_y >= 20) | (mid_band & (flip0 == 1))
            dy = torch.where(neg, -dy, dy)

            d, dx0 = d.randn_if(live, 2 * dif)
            dx = dx0 + 3 + dif3

            curr_y = torch.where(live, torch.clamp_min(curr_y + dy, 1), curr_y)

            pit_possible = live & allow_pit & (dx > 7) & (curr_y > 3)
            d, pitroll = d.randn_if(pit_possible, 20)
            use_pit = pit_possible & (pitroll >= pit_threshold)
            use_npit = live & ~use_pit

            # ---- pit branch (draws and fills masked by use_pit) ----
            d, x1_0 = d.randn_if(use_pit, 3)
            x1 = x1_0 + 1
            d, x2_0 = d.randn_if(use_pit, 3)
            x2 = x2_0 + 1
            pit_width = dx - x1 - x2
            clipped = pit_width > max_dx
            x2 = torch.where(clipped, dx - x1 - max_dx, x2)
            pit_width = torch.where(clipped, max_dx, pit_width)

            sp = self._fill_block_top(s, curr_x, 0, x1, curr_y, WALL_MID, WALL_TOP)
            sp = self._fill_block_top(
                sp, curr_x + dx - x2, 0, x2, curr_y, WALL_MID, WALL_TOP
            )
            s = masked_grid(use_pit, sp, s)

            d, lava0 = d.randn_if(use_pit, torch.clamp_min(curr_y - 3, 1))
            lava_height = lava0 + 1
            sl = self._fill_block_top(
                s, curr_x + x1, 1, pit_width, lava_height, LAVA_MID, LAVA_TOP
            )
            s = masked_grid(use_pit & (danger_type == 0), sl, s)

            for ei in range(7):  # pit_width <= max_dx = 7
                in_pit = use_pit & (ei < pit_width)
                px = (curr_x + x1 + ei).to(f32)
                one = torch.ones_like(px)
                all_recs.append(self._saw_record(px, one))
                all_dos.append(in_pit & (danger_type == 1))
                edo = in_pit & (danger_type == 2)
                d, erec = self._enemy_record(d, px, one, edo)
                all_recs.append(erec)
                all_dos.append(edo)

            wide = use_pit & (pit_width > 4)
            d, d1 = d.randn_if(wide, 2)
            d, d2 = d.randn_if(wide, 2)
            x3 = torch.where(pit_width == 5, 1 + d1, 2 + d1)
            w1 = torch.where(
                (pit_width == 5) | (pit_width == 6),
                1 + d2,
                pit_width - x3 - (2 + d2),
            )
            sb_ = self._fill_block_top(
                s, curr_x + x1 + x3, curr_y - 1, w1, 1, WALL_MID, WALL_TOP
            )
            s = masked_grid(wide, sb_, s)

            # ---- non-pit branch (draws and fills masked by use_npit) ----
            sn = self._fill_block_top(s, curr_x, 0, dx, curr_y, WALL_MID, WALL_TOP)
            s = masked_grid(use_npit, sn, s)

            d, sawroll = d.randn_if(use_npit, 10)
            saw_here = use_npit & (sawroll < 2 * dif) & (dx > 3)
            d, ob1_0 = d.randn_if(saw_here, torch.clamp_min(dx - 2, 1))
            ob1_x = torch.where(saw_here, curr_x + ob1_0 + 1, -1)
            all_recs.append(self._saw_record(ob1_x.to(f32), curr_y.to(f32)))
            all_dos.append(saw_here)

            d, enroll = d.randn_if(use_npit, 10)
            enemy_here = (
                use_npit & (enroll < dif) & (dx > 3) & (max_dx >= 4) & allow_monsters
            )
            d, ob2_0 = d.randn_if(enemy_here, torch.clamp_min(dx - 2, 1))
            ob2_x = torch.where(enemy_here, curr_x + ob2_0 + 1, -1)
            d, erec = self._enemy_record(
                d, ob2_x.to(f32), curr_y.to(f32), enemy_here
            )
            all_recs.append(erec)
            all_dos.append(enemy_here)

            if allow_crate:
                for _ci in range(2):
                    d, cx0 = d.randn_if(use_npit, torch.clamp_min(dx - 2, 1))
                    crate_x = curr_x + cx0 + 1
                    d, crroll = d.randn_if(use_npit, 2)
                    place = (
                        use_npit
                        & (crroll == 1)
                        & (ob1_x != crate_x)
                        & (ob2_x != crate_x)
                    )
                    d, pile0 = d.randn_if(place, 3)
                    pile = pile0 + 1
                    for j in range(3):
                        cdo = place & (j < pile)
                        d, crec = self._crate_record(
                            d, crate_x.to(f32), (curr_y + j).to(f32), cdo
                        )
                        all_recs.append(crec)
                        all_dos.append(cdo)

            # barriers (coinrun.cpp:398-404)
            pre = self.get_obj(s, curr_x - 1, curr_y)
            sb = self.set_obj(s, curr_x - 1, curr_y, ENEMY_BARRIER)
            s = masked_grid(live & ~_is_wall(pre), sb, s)
            curr_x = torch.where(live, curr_x + dx, curr_x)
            sb2 = self.set_obj(s, curr_x, curr_y, ENEMY_BARRIER)
            s = masked_grid(live, sb2, s)

        s = s.replace(
            ents=s.ents.push_many(
                stack_records(all_recs, n, dev), torch.stack(all_dos, dim=1)
            )
        )

        # goal (coinrun.cpp:406-411)
        s = self.set_obj(s, curr_x, curr_y, GOAL)
        s = self._fill_block_top(s, curr_x, 0, 1, curr_y, WALL_MID, WALL_TOP)
        s = self.fill_elem(s, curr_x + 1, 0, w - curr_x - 1, 64, WALL_MID)
        return s.replace(rand_gen=rng.commit(s.rand_gen, d))

    # -- per-step game logic ------------------------------------------------

    def game_step(self, s: BasicState, d):
        s, d = self.game_step_base(s, d)

        refl = torch.where(
            s.action_vx > 0,
            False,
            torch.where(s.action_vx < 0, True, s.ents.is_reflected[:, 0]),
        )
        s = s.replace(ents=s.ents.set_fields(0, is_reflected=refl))

        # enemy trails + animation (coinrun.cpp:484-499); trails push in
        # reverse entity order (the C++ loop, coinrun.cpp:482)
        e = s.ents
        is_enemy = e.active & (e.type == ENEMY)
        tf = default_fields(
            e.x.flip(1), (e.y - e.ry * 0.5).flip(1), 0.0, 0.01, 0.3, 0.2, TRAIL
        )
        tf["expire_time"] = 8
        tf["alpha"] = 0.5
        s = s.replace(decor=s.decor.push_many(tf, is_enemy.flip(1)))

        half = torch.div(s.cur_time, 5, rounding_mode="floor")
        enemy_img = torch.where(torch.remainder(half, 2) == 0, ENEMY1, ENEMY2)
        is_saw = e.active & (e.type == SAW)
        saw_img = torch.where(torch.remainder(s.cur_time, 2) == 0, SAW, SAW2)
        s = s.replace(
            ents=e.replace(
                image_type=torch.where(
                    is_enemy, enemy_img[:, None],
                    torch.where(is_saw, saw_img[:, None], e.image_type),
                ).to(i32),
                is_reflected=torch.where(is_enemy, e.vx > 0, e.is_reflected),
            )
        )

        s = s.replace(game=s.game.replace(last_agent_y=s.ents.y[:, 0]))
        return s, d
