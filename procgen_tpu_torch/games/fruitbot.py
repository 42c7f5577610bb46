"""Fruitbot: scrolling dodge; fruit +1, junk -4, the presents' finish line
+10; key bullets unlock gated doors.  Reference:
procgen/src/games/fruitbot.cpp; JAX counterpart procgen_tpu/games/fruitbot.py.

The agent flies up the world at a forced speed under a camera that follows
it; the background is tiled vertically (``bg_tile_ratio = -1``).  The reset
partitions the height into wall rows drawn from one 624-word block, places
the fruit and junk by rejection (``place_by_rejection``, batched over the
envs), then themes and fits them to their sprites' aspect ratios.  Every
function works on the whole batch: per-env values are ``[N]`` tensors,
per-slot values ``[N, cap]``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import rng
from ..core.constants import EASY_MODE, PLAYER, WALL_OBJ
from ..core.entities import default_fields, stack_records
from ..core.game import BasicAbstractGame, BasicState, place_by_rejection
from .registry import register

i32 = torch.int32
f32 = torch.float32

COMPLETION_BONUS = 10.0
POSITIVE_REWARD = 1.0
PENALTY = -4.0

BARRIER = 1
OUT_OF_BOUNDS_WALL = 2
PLAYER_BULLET = 3
BAD_OBJ = 4
GOOD_OBJ = 7
LOCKED_DOOR = 10
LOCK = 11
PRESENT = 12

KEY_DURATION = 8
DOOR_ASPECT_RATIO = 3.25
PI = math.pi

NUM_WALLS_HARD = 10
NUM_WALLS_EASY = 5

# good and bad objects each: randn(10) + 10 of them
OBJECTS_MAX = 19


def _f32_sum(*terms: float) -> float:
    """The f32 sum of ``terms`` in order, as XLA folds a chain ``x + a + b
    + ...`` of f32 constants into ``x + ((a + b) + ...)``."""
    total = np.float32(terms[0])
    for t in terms[1:]:
        total = np.float32(total + np.float32(t))
    return float(total)


def _f32_recip(a: float) -> float:
    """``1 / a`` in f32, as XLA turns ``x / a`` for a constant ``a`` into
    ``x * (1 / a)``."""
    return float(np.float32(1) / np.float32(a))


@dataclasses.dataclass
class FruitbotState:
    last_fire_time: torch.Tensor  # int32 [N]

    def replace(self, **kw) -> "FruitbotState":
        return dataclasses.replace(self, **kw)


@register("fruitbot")
class Fruitbot(BasicAbstractGame):
    name = "fruitbot"
    ENT_CAP = 112  # 2 walls/row x10 + door+lock + 20 presents + 38 objs + bullets
    DISPATCH_VECTORIZED = True
    ANY_COLLIDES_WITH_ENTITIES = True  # player bullets
    MAX_STEP_DRAWS = 4
    MAX_SUB_STEPS = 4  # |v| <= sqrt(.85^2+.2^2)

    def __init__(self, options):
        super().__init__(options)
        self.mixrate = 0.5
        self.maxspeed = 0.85
        self.bullet_vscale = 0.5
        self.bg_tile_ratio = -1
        self.out_of_bounds_object = OUT_OF_BOUNDS_WALL
        self.world_w = 10 if options.distribution_mode == EASY_MODE else 20
        self.WORLD_DIM_MAX = (self.world_w, 60)

    def background_names(self):
        from ..render.assets import TOPDOWN_BACKGROUNDS

        return TOPDOWN_BACKGROUNDS

    def use_block_asset(self, type_):
        return type_ in (BARRIER, LOCKED_DOOR, PRESENT)

    def asset_for_type(self, type_):
        # fruitbot.cpp:46-76
        if type_ == PLAYER:
            return ["misc_assets/robot_3Dblue.png"]
        if type_ in (BARRIER, OUT_OF_BOUNDS_WALL):
            return ["misc_assets/tileStone_slope.png"]
        if type_ == PLAYER_BULLET:
            return ["misc_assets/keyRed2.png"]
        if type_ == BAD_OBJ:
            return [f"misc_assets/food{i}.png" for i in range(1, 7)]
        if type_ == GOOD_OBJ:
            return [f"misc_assets/fruit{i}.png" for i in range(1, 7)]
        if type_ == LOCKED_DOOR:
            return ["misc_assets/fenceYellow.png"]
        if type_ == LOCK:
            return ["misc_assets/lockRed2.png"]
        if type_ == PRESENT:
            return [f"misc_assets/present{i}.png" for i in range(1, 4)]
        return []

    def entity_tile_ratio(self, s, e):
        # fruitbot.cpp:85-92
        return torch.where(
            e.type == BARRIER, 1.0,
            torch.where(e.type == LOCKED_DOOR, DOOR_ASPECT_RATIO, 0.0),
        ).to(f32)

    def game_init_state(self, n, device):
        return FruitbotState(last_fire_time=torch.zeros((n,), dtype=i32, device=device))

    def choose_world_dim(self, s):
        return s.replace(
            main_width=torch.full_like(s.main_width, self.world_w),
            main_height=torch.full_like(s.main_height, 60),
        )

    # -- physics ------------------------------------------------------------

    def will_reflect(self, src_type, target_type):
        return (src_type == BAD_OBJ) & (
            (target_type == BARRIER) | (target_type == WALL_OBJ)
        )

    def is_blocked(self, s, src_type, target_type, is_horizontal):
        b = super().is_blocked(s, src_type, target_type, is_horizontal)
        return b | ((src_type == PLAYER) & (target_type == OUT_OF_BOUNDS_WALL))

    def set_action_xy(self, s, move_action):
        # forced upward scroll (fruitbot.cpp:157-161)
        return s.replace(
            action_vx=(torch.div(move_action, 3, rounding_mode="floor") - 1).to(f32),
            action_vy=torch.full_like(s.action_vy, 0.2),
            action_vrot=torch.zeros_like(s.action_vrot),
        )

    def camera(self, s):
        # fruitbot.cpp:139-143; the halving is exact on every device
        w = s.main_width.to(f32)
        cx = w / 2.0
        cy = s.ents.y[:, 0] + w / 2.0 - 2 * s.ents.ry[:, 0]
        return cx, cy, w

    # -- collisions ---------------------------------------------------------

    def handle_agent_collision_vec(self, s, d, hit):
        # fruitbot.cpp:96-117
        e = s.ents
        deadly = (hit & ((e.type == BARRIER) | (e.type == LOCKED_DOOR))).any(dim=1)
        bad = hit & (e.type == BAD_OBJ)
        good = hit & (e.type == GOOD_OBJ)
        present = (hit & (e.type == PRESENT)).any(dim=1)
        s = s.replace(
            done=s.done | deadly | present,
            reward=s.reward
            + bad.sum(dim=1).to(f32) * PENALTY
            + good.sum(dim=1).to(f32) * POSITIVE_REWARD
            + torch.where(present, COMPLETION_BONUS, 0.0),
            level_complete=s.level_complete | present,
            ents=e.replace(will_erase=e.will_erase | bad | good),
        )
        return s, d

    def dispatch_entity_pairs(self, s, d):
        """Bullet against barrier or lock (fruitbot.cpp:119-137), on
        [N, bullet, target] pair matrices: each bullet's winner is its
        highest-slot colliding target (the reverse inner scan); a bullet that
        hits erases itself, a hit lock erases itself and the door in its row
        (|door.y - lock.y| < 1)."""
        e = s.ents
        cap = e.cap
        slots = torch.arange(cap, device=e.x.device)
        is_bullet = e.active & (e.type == PLAYER_BULLET) & ~e.will_erase
        b = lambda t: t[:, :, None]  # noqa: E731  the bullet axis
        t_ = lambda t: t[:, None, :]  # noqa: E731  the target axis
        dx = torch.abs(b(e.x) - t_(e.x))
        dy = torch.abs(b(e.y) - t_(e.y))
        overlap = (dx < b(e.rx) + t_(e.rx) + b(e.collision_margin)) & (
            dy < b(e.ry) + t_(e.ry) + b(e.collision_margin)
        )
        target_ok = (
            t_(e.active & ~e.will_erase & ((e.type == BARRIER) | (e.type == LOCK)))
            & (slots[None, :] != slots[:, None])
        )
        pair = overlap & b(is_bullet) & target_ok
        winner = torch.where(pair, slots, -1).amax(dim=2)  # [N, bullet]
        has_hit = winner >= 0
        wslot = winner.clamp_min(0)
        lock_hit = has_hit & (e.type.gather(1, wslot) == LOCK)
        # erase the hit locks; a miss goes to a spare column past cap
        lock_erase = torch.zeros((e.x.shape[0], cap + 1), dtype=torch.bool,
                                 device=e.x.device)
        lock_erase.scatter_(1, torch.where(lock_hit, winner, cap), True)
        # erase the door paired with each hit lock
        locks_hit_y = torch.where(lock_hit, e.y.gather(1, wslot), torch.inf)
        is_door = e.active & (e.type == LOCKED_DOOR)
        door_die = is_door & (torch.abs(b(e.y) - t_(locks_hit_y)) < 1).any(dim=2)
        return s.replace(ents=e.replace(
            will_erase=e.will_erase | has_hit | lock_erase[:, :cap] | door_die
        )), d

    # -- reset --------------------------------------------------------------

    def _wall_records(self, d, ry, use_door, min_pct):
        """fruitbot.cpp:163-190: the two barriers of the wall row at height
        ``ry`` ([N] f32) and, where ``use_door``, its door and lock.
        Returns (d, the four records)."""
        rw = float(self.world_w)
        wall_ry = 0.3
        lock_rx = 0.25
        lock_ry = 0.45

        d, p01 = d.rand01()
        pct = min_pct + 0.2 * p01

        lock_pct_w = 2 * lock_rx / rw
        door_pct_w = (wall_ry * 2 * DOOR_ASPECT_RATIO) / rw
        # the JAX package computes (pct + .1 - 2 * lock_pct_w) / door_pct_w
        # as XLA's algebraic simplifier rewrites it: min_pct and the two
        # constant terms folded into one f32 constant, the division by a
        # constant made a multiply by its f32 reciprocal
        num_doors = torch.ceil(
            (0.2 * p01 + _f32_sum(min_pct, 0.1, -2 * lock_pct_w))
            * _f32_recip(door_pct_w))
        pct_door = 2 * lock_pct_w + door_pct_w * num_doors
        pct = torch.where(use_door, pct_door, pct)

        gapw = pct * rw
        d, w01 = d.rand01()
        w1 = w01 * (rw - gapw)
        w2 = rw - w1 - gapw

        d, is_on_right = d.randn_if(use_door, 2)
        right = is_on_right.to(f32)
        lock_x = w1 + lock_rx + right * (gapw - 2 * lock_rx)
        door_x = w1 + gapw / 2 - (is_on_right * 2 - 1).to(f32) * lock_rx
        recs = [
            default_fields(w1 / 2, ry, 0.0, 0.0, w1 / 2, wall_ry, BARRIER),
            default_fields(rw - w2 / 2, ry, 0.0, 0.0, w2 / 2, wall_ry, BARRIER),
            default_fields(door_x, ry, 0.0, 0.0, gapw / 2 - lock_rx, wall_ry,
                           LOCKED_DOOR),
            # ry - lock_ry + wall_ry, its constants folded as XLA folds them
            default_fields(lock_x, ry + _f32_sum(-lock_ry, wall_ry), 0.0, 0.0,
                           lock_rx, lock_ry, LOCK),
        ]
        return d, recs

    def game_reset(self, s: BasicState) -> BasicState:
        s = self.game_reset_base(s)
        n = s.num
        dev = s.grid.device
        easy = self.options.distribution_mode == EASY_MODE
        min_sep = 4
        num_walls = NUM_WALLS_EASY if easy else NUM_WALLS_HARD
        object_group_size = 2 if easy else 6
        buf_h = 4
        door_prob = 0.0 if easy else 0.125
        min_pct = 0.2 if easy else 0.1
        h = 60

        d, norm = rng.peek_block(s.rand_gen, rng.N)
        s = s.replace(rand_gen=norm)

        # partition(x, n): x draws of randn(n) (randgen.cpp:33-41)
        x_total = h - min_sep * num_walls - buf_h
        ks = rng._randn_from(d.peek_at(torch.arange(x_total, device=dev)[None, :]),
                             num_walls)
        d = d.replace(cursor=d.cursor + x_total)
        parts = torch.zeros((n, num_walls), dtype=i32, device=dev)
        parts.scatter_add_(1, ks.long(), torch.ones_like(ks))

        always = torch.ones((n,), dtype=torch.bool, device=dev)
        recs, dos = [], []
        curr_h = torch.zeros((n,), dtype=i32, device=dev)
        for wi in range(num_walls):
            dy = min_sep + parts[:, wi]
            curr_h = curr_h + dy
            # `(dy > 5) && rand01() < door_prob` short-circuits: the roll is
            # drawn only for tall-enough gaps (fruitbot.cpp:224)
            d, droll = d.rand01_if(dy > 5)
            use_door = (dy > 5) & (droll < door_prob)
            d, wrecs = self._wall_records(d, curr_h.to(f32), use_door, min_pct)
            recs += wrecs
            dos += [always, always, use_door, use_door]

        s = s.replace(
            ents=s.ents.set_fields(0, y=s.ents.ry[:, 0], rotation=-PI / 2)
        )

        d, g0 = d.randn(10)
        num_good = g0 + 10
        d, b0 = d.randn(10)
        num_bad = b0 + 10

        # presents across the top row (fruitbot.cpp:216-219)
        themes = rng._randn_from(
            d.peek_at(torch.arange(self.world_w, device=dev)[None, :]),
            self.num_themes(PRESENT))
        d = d.replace(cursor=d.cursor + self.world_w)
        for i in range(self.world_w):
            f = default_fields(i + 0.5, h - 0.5, 0.0, 0.0, 0.5, 0.5, PRESENT)
            f["image_theme"] = themes[:, i]
            recs.append(f)
            dos.append(always)
        s = s.replace(
            ents=s.ents.push_many(stack_records(recs, n, dev), torch.stack(dos, dim=1)),
            rand_gen=rng.commit(s.rand_gen, d),
        )
        s = self._place_objects(s, num_good, num_bad)
        return self._theme_objects(s, object_group_size)

    def _place_objects(self, s: BasicState, num_good, num_bad) -> BasicState:
        """The good and bad objects (spawn_entities, fruitbot.cpp:220-223):
        each placed by rejection against the pool, the agent and the objects
        placed before it, and kept only where ``i < num``, its draws
        included.  One peeked window serves them all; it is refreshed
        before an object whose rejection loop could run past its end."""
        n = s.num
        dev = s.grid.device
        e = s.ents
        # reposition's blockers (cpp:550-568): the agent and every live slot
        # that does not avoid collisions
        slots = torch.arange(e.cap, device=dev)[None, :]
        pool = [(e.x, e.y, e.rx, e.ry,
                 e.active & ((slots == 0) | ~e.avoids_collisions))]
        max_tries = 100
        need = 2 * (max_tries + 1)
        g = s.rand_gen
        d, norm = rng.peek_block(g, rng.N)
        recs, dos, placed = [], [], []
        for kind, num in ((GOOD_OBJ, num_good), (BAD_OBJ, num_bad)):
            for i in range(OBJECTS_MAX):
                if int(d.cursor.max()) > rng.N - need:
                    g = rng.commit(norm, d)
                    d, norm = rng.peek_block(g, rng.N)
                do = i < num
                blockers = pool
                if placed:
                    px_, py_, do_ = (torch.stack(v, dim=1) for v in zip(*placed))
                    half = torch.full_like(px_, 0.5)
                    blockers = pool + [(px_, py_, half, half, do_)]
                d, px, py = place_by_rejection(
                    d, blockers, 0.5, 0.5, 0.0, 0.0, float(self.world_w), 60.0,
                    do, max_tries)
                placed.append((px, py, do))
                recs.append(default_fields(px, py, 0.0, 0.0, 0.5, 0.5, kind))
                dos.append(do)
        return s.replace(
            ents=s.ents.push_many(stack_records(recs, n, dev), torch.stack(dos, dim=1)),
            rand_gen=rng.commit(norm, d),
        )

    def _theme_objects(self, s: BasicState, group_size: int) -> BasicState:
        """Themes and fit_aspect_ratio for every good and bad object
        (fruitbot.cpp:224-229), in slot order: the k-th object takes the
        k-th word of the stream."""
        e = s.ents
        dev = e.x.device
        is_obj = e.active & ((e.type == GOOD_OBJ) | (e.type == BAD_OBJ))
        k = torch.cumsum(is_obj.to(i32), dim=1) - 1
        d, norm = rng.peek_block(s.rand_gen, e.cap)
        th = rng._randn_from(d.peek_at(k.clamp_min(0)), group_size)
        d = d.replace(cursor=is_obj.sum(dim=1, dtype=i32))
        tc = th.clamp(0, 5)
        ar = torch.where(e.type == GOOD_OBJ, self.aspect_of(GOOD_OBJ, tc),
                         self.aspect_of(BAD_OBJ, tc))
        s = s.replace(ents=e.replace(image_theme=torch.where(is_obj, th, e.image_theme)))
        s = self.fit_aspect_ratio(s, is_obj, ar)
        return s.replace(
            rand_gen=rng.commit(norm, d),
            game=self.game_init_state(s.num, dev),
        )

    # -- per-step -----------------------------------------------------------

    def game_step(self, s: BasicState, d):
        s, d = self.game_step_base(s, d)
        fire = (s.special_action == 1) & (
            (s.cur_time - s.game.last_fire_time) >= KEY_DURATION
        )
        f = default_fields(
            s.ents.x[:, 0], s.ents.y[:, 0], 0.0, 1.0 * self.bullet_vscale,
            0.25, 0.25, PLAYER_BULLET,
        )
        f["expire_time"] = KEY_DURATION
        f["collides_with_entities"] = True
        return s.replace(
            ents=s.ents.push(f, do=fire),
            game=s.game.replace(
                last_fire_time=torch.where(fire, s.cur_time, s.game.last_fire_time)
            ),
        ), d
