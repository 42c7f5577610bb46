"""Bigfish: eat smaller fish (+1 each), die to bigger ones; 30 fish give
+10.  Reference: procgen/src/games/bigfish.cpp; JAX counterpart
procgen_tpu/games/bigfish.py.

The game has no grid objects, a static render prefix and the entity pool
only.  Its collisions go through the sequential reverse scan
(``BasicAbstractGame.dispatch_sequential``): eating a fish grows the agent
at once, so a lower slot's fish meets the grown agent.  A fish spawns
with probability 1/10 a step, and its draws are taken only when it does.
The C++ evaluates the float expressions that hold a double literal in
double and rounds once (the radius with its double ``pow``, the speed);
the port does the same (``fish_radius``, ``fish_speed``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.constants import EASY_MODE, PLAYER
from ..core.entities import default_fields
from ..core.game import BasicAbstractGame, BasicState, tree_where
from .registry import register

i32 = torch.int32
f32 = torch.float32
f64 = torch.float64

COMPLETION_BONUS = 10.0
POSITIVE_REWARD = 1.0
FISH = 2
FISH_MIN_R = 0.25
FISH_MAX_R = 2.0
FISH_QUOTA = 30


def fish_radius(r01: torch.Tensor) -> torch.Tensor:
    """``(FISH_MAX_R - FISH_MIN_R) * pow(rand01(), 1.4) + FISH_MIN_R``
    (bigfish.cpp:85): C's double ``pow``, the product and the sum in
    double, rounded once to f32.  glibc's ``pow`` is needed only as far as
    it reaches the f32 result; torch's f64 ``pow`` is held to it over every
    distinct ``rand01`` value (``tools/torch_libm_sweep.py --pow``)."""
    p = torch.pow(r01.to(f64), 1.4)
    return (p * (FISH_MAX_R - FISH_MIN_R) + FISH_MIN_R).to(f32)


def fish_speed(v01: torch.Tensor) -> torch.Tensor:
    """``.15 + rand01() * .25`` (bigfish.cpp:89) in double, rounded once."""
    return (v01.to(f64) * 0.25 + 0.15).to(f32)


@dataclasses.dataclass
class BigfishState:
    fish_eaten: torch.Tensor  # int32 [N]
    r_inc: torch.Tensor  # f32 [N], the agent's growth a fish

    def replace(self, **kw) -> "BigfishState":
        return dataclasses.replace(self, **kw)


@register("bigfish")
class Bigfish(BasicAbstractGame):
    name = "bigfish"
    WORLD_DIM_MAX = (20, 20)
    ENT_CAP = 40
    STATIC_RENDER_PREFIX = True
    MAX_STEP_DRAWS = 16
    MAX_SUB_STEPS = 6

    def __init__(self, options):
        super().__init__(options)
        self.timeout = 6000  # bigfish.cpp:25
        self.center_agent = False  # forced at reset (bigfish.cpp:69)

    def background_names(self):
        from ..render.assets import WATER_BACKGROUNDS

        return WATER_BACKGROUNDS

    def asset_for_type(self, type_):
        if type_ == PLAYER:
            return ["misc_assets/fishTile_072.png"]
        if type_ == FISH:
            return [
                "misc_assets/fishTile_074.png",
                "misc_assets/fishTile_078.png",
                "misc_assets/fishTile_080.png",
            ]
        return []

    def game_init_state(self, n, device):
        return BigfishState(
            fish_eaten=torch.zeros((n,), dtype=i32, device=device),
            r_inc=torch.zeros((n,), dtype=f32, device=device),
        )

    def choose_world_dim(self, s):
        # set in the C++ ctor (bigfish.cpp:26-27)
        return s.replace(main_width=torch.full_like(s.main_width, 20),
                         main_height=torch.full_like(s.main_height, 20))

    def handle_agent_collision(self, s: BasicState, d, i: int):
        """bigfish.cpp:46-59: die to a bigger fish, eat a smaller one
        (the agent grows by ``r_inc`` at once)."""
        e = s.ents
        g = s.game
        is_fish = e.type[:, i] == FISH
        bigger = e.rx[:, i] > e.rx[:, 0]
        die = is_fish & bigger
        eat = is_fish & ~bigger
        ents = e.set_fields_where(i, eat, will_erase=True)
        ents = ents.set_fields_where(
            0, eat, rx=e.rx[:, 0] + g.r_inc, ry=e.ry[:, 0] + g.r_inc)
        return s.replace(
            done=s.done | die,
            reward=s.reward + torch.where(eat, POSITIVE_REWARD, 0.0),
            ents=ents,
            game=g.replace(fish_eaten=g.fish_eaten + eat.to(i32)),
        ), d

    def game_reset(self, s: BasicState) -> BasicState:
        s = self.game_reset_base(s)
        n = s.num
        dev = s.grid.device
        start_r = 1.0 if self.options.distribution_mode == EASY_MODE else 0.5
        r_inc = (FISH_MAX_R - start_r) / FISH_QUOTA
        return s.replace(
            game=BigfishState(
                fish_eaten=torch.zeros((n,), dtype=i32, device=dev),
                r_inc=torch.full((n,), r_inc, dtype=f32, device=dev),
            ),
            ents=s.ents.set_fields(0, rx=start_r, ry=start_r, y=1.0 + start_r),
        )

    def game_step(self, s: BasicState, d):
        s, d = self.game_step_base(s, d)

        # a fish (bigfish.cpp:83-95); its draws only when the roll hits
        d1, roll = d.randn(10)
        spawn = roll == 1
        d2, r01 = d1.rand01()
        ent_r = fish_radius(r01)
        d2, y01 = d2.rand01()
        ent_y = y01 * (s.main_height.to(f32) - 2 * ent_r)
        d2, m01 = d2.rand01()
        moves_right = m01 < 0.5
        d2, v01 = d2.rand01()
        ent_vx = fish_speed(v01) * torch.where(moves_right, 1.0, -1.0)
        ent_x = torch.where(moves_right, -ent_r, s.main_width.to(f32) + ent_r)
        d2, theme = d2.randn(self.num_themes(FISH))
        fields = default_fields(ent_x, ent_y, ent_vx, 0.0, ent_r,
                                ent_r / self.aspect_of(FISH, theme), FISH)
        fields["image_theme"] = theme
        fields["is_reflected"] = ~moves_right
        s = s.replace(ents=s.ents.push(fields, do=spawn))
        d = tree_where(spawn, d2, d1)

        g = s.game
        complete = g.fish_eaten >= FISH_QUOTA
        s = s.replace(
            done=s.done | complete,
            reward=s.reward + torch.where(complete, COMPLETION_BONUS, 0.0),
            level_complete=s.level_complete | complete,
        )

        e = s.ents
        refl = torch.where(s.action_vx > 0, False,
                           torch.where(s.action_vx < 0, True, e.is_reflected[:, 0]))
        return s.replace(ents=e.set_fields(0, is_reflected=refl)), d
