"""Jumper: an open-world cave platformer with a double jump; the carrot
gives +10, the spikes kill.  Reference: procgen/src/games/jumper.cpp; JAX
counterpart procgen_tpu/games/jumper.py.

The reset: a maze skeleton without dead ends at three cells a maze cell,
a random fill (walls likelier on the maze's walls), two CA rounds, the
biggest room (``levelgen.room``), the goal and the agent's ground cell,
the BFS path between them widened 4 rounds outside memory mode, then the
spike sweep and the anti-long-wall sweep (``_spike_sweep``,
``_wall_sweep``), the spikes as entities and the walls' tops.  A step
reflects the agent's sprite with its heading, drops a trail into the
decor pool and applies gravity after the move.  ``render_overlay`` draws
the compass toward the goal and the distance bar (not in memory mode).
Every function works on the whole batch: per-env values are ``[N]``
tensors, per-slot values ``[N, cap]``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import libm, rng
from ..core.constants import (
    EASY_MODE, MEMORY_MODE, PLAYER, SPACE, TRAIL, WALL_OBJ,
)
from ..core.entities import default_fields
from ..core.game import BasicAbstractGame, BasicState, first_true, per_env
from ..levelgen import maze as mazegen
from ..levelgen import room as roomgen
from .registry import register

i32 = torch.int32
f32 = torch.float32

GOAL_REWARD = 10.0

GOAL = 1
SPIKE = 2
CAVEWALL = 6
CAVEWALL_TOP = 7
PLAYER_JUMP = 9
PLAYER_LEFT1 = 10
PLAYER_LEFT2 = 11
PLAYER_RIGHT1 = 12
PLAYER_RIGHT2 = 13

MAZE_SCALE = 3
JUMP_COOLDOWN = 3
NUM_WALL_THEMES = 4
SPIKE_PROB = 0.2

COMPASS_CLOCK = (168, 166, 158)
COMPASS_HI = (252, 186, 3)


def _is_wall(t):
    return (t == CAVEWALL) | (t == CAVEWALL_TOP)


@dataclasses.dataclass
class JumperState:
    jump_count: torch.Tensor  # int32 [N]
    jump_delta: torch.Tensor  # int32 [N]
    jump_time: torch.Tensor  # int32 [N]
    has_support: torch.Tensor  # bool [N]
    facing_right: torch.Tensor  # bool [N]
    wall_theme: torch.Tensor  # int32 [N]

    def replace(self, **kw) -> "JumperState":
        return dataclasses.replace(self, **kw)


@register("jumper")
class Jumper(BasicAbstractGame):
    name = "jumper"
    ENT_CAP = 64  # agent + goal + spikes (~0.2 of ground cells)
    DECOR_CAP = 16  # movement trails, expire in 8 steps
    DISPATCH_VECTORIZED = True
    MAX_STEP_DRAWS = 4
    MAX_SUB_STEPS = 9  # |v| <= sqrt(.5^2 + 2^2)

    def __init__(self, options):
        super().__init__(options)
        mode = options.distribution_mode
        if mode == EASY_MODE:
            dim = 20
        elif mode == MEMORY_MODE:
            dim = 45
        else:
            dim = 40
        self.world_dim = dim
        self.WORLD_DIM_MAX = (dim, dim)
        if mode == MEMORY_MODE:
            self.timeout = 2000
        self.visibility = 12.0 if mode == EASY_MODE else 16.0
        self.compass_dim = 3.0 if mode == EASY_MODE else 2.0
        # the steady-state out_of_bounds_object (jumper.cpp:378); the CA
        # rounds count cells outside the grid as walls on their own
        self.out_of_bounds_object = CAVEWALL

    def background_names(self):
        from ..render.assets import PLATFORM_BACKGROUNDS

        return PLATFORM_BACKGROUNDS

    def asset_for_type(self, type_):
        # jumper.cpp:50-78
        return {
            PLAYER: ["misc_assets/bunny2_ready.png"],
            SPIKE: ["misc_assets/spikeMan_stand.png"],
            GOAL: ["misc_assets/carrot.png"],
            PLAYER_JUMP: ["misc_assets/bunny2_jump.png"],
            PLAYER_RIGHT1: ["misc_assets/bunny2_walk1.png"],
            PLAYER_LEFT1: ["misc_assets/bunny2_walk1.png"],
            PLAYER_RIGHT2: ["misc_assets/bunny2_walk2.png"],
            PLAYER_LEFT2: ["misc_assets/bunny2_walk2.png"],
            CAVEWALL_TOP: ["platformer/tileBlue_05.png", "platformer/tileGreen_05.png",
                           "platformer/tileYellow_06.png", "platformer/tileBrown_06.png"],
            CAVEWALL: ["platformer/tileBlue_08.png", "platformer/tileGreen_08.png",
                       "platformer/tileYellow_09.png", "platformer/tileBrown_09.png"],
        }.get(type_, [])

    def use_block_asset(self, type_):
        return type_ in (CAVEWALL, CAVEWALL_TOP)

    def game_init_state(self, n, device):
        def z(dtype=i32, v=0):
            return torch.full((n,), v, dtype=dtype, device=device)

        return JumperState(jump_count=z(), jump_delta=z(), jump_time=z(),
                           has_support=z(torch.bool, False),
                           facing_right=z(torch.bool, True), wall_theme=z())

    def choose_world_dim(self, s):
        return s.replace(main_width=torch.full_like(s.main_width, self.world_dim),
                         main_height=torch.full_like(s.main_height, self.world_dim))

    # -- physics ------------------------------------------------------------

    def is_blocked(self, s, src_type, target_type, is_horizontal):
        b = super().is_blocked(s, src_type, target_type, is_horizontal)
        return b | ((src_type == PLAYER) & _is_wall(target_type))

    def update_agent_velocity(self, s):
        # jumper.cpp:96-102; every product and sum rounds on its own
        e = s.ents
        vx = (1 - s.mixrate) * e.vx[:, 0] + s.mixrate * s.maxspeed * s.action_vx
        vy = torch.where(s.action_vy != 0, s.maxspeed * s.action_vy * 2, e.vy[:, 0])
        return s.replace(ents=e.set_fields(0, vx=vx, vy=vy))

    def set_action_xy(self, s, move_action):
        # jumper.cpp:389-423: the double jump with its cooldown
        avx = (torch.div(move_action, 3, rounding_mode="floor") - 1).to(f32)
        avy = (torch.remainder(move_action, 3) - 1).to(f32).clamp_min(0.0)
        g = s.game
        facing = torch.where(avx > 0, True, torch.where(avx < 0, False, g.facing_right))
        e = s.ents
        x0, y0, rx0, ry0 = e.x[:, 0], e.y[:, 0], e.rx[:, 0], e.ry[:, 0]
        b1 = self.get_obj_from_floats(s, x0 - (rx0 - 0.01), y0 - (ry0 + 0.01))
        b2 = self.get_obj_from_floats(s, x0 + (rx0 - 0.01), y0 - (ry0 + 0.01))
        has_support = _is_wall(b1) | _is_wall(b2)
        jump_count = torch.where(has_support, 2, g.jump_count)
        can_jump = ((avy == 1) & (jump_count > 0)
                    & (s.cur_time - g.jump_time > JUMP_COOLDOWN))
        jump_count = torch.where(can_jump, jump_count - 1, jump_count)
        avy = torch.where(can_jump, 1.0, 0.0)
        return s.replace(
            action_vx=avx,
            action_vy=avy,
            action_vrot=torch.zeros_like(s.action_vrot),
            game=g.replace(
                facing_right=facing,
                has_support=has_support,
                jump_count=jump_count.to(i32),
                jump_delta=torch.where(can_jump, -1, 0).to(i32),
                jump_time=torch.where(avy > 0, s.cur_time, g.jump_time).to(i32),
            ),
        )

    def handle_agent_collision_vec(self, s, d, hit):
        # jumper.cpp:81-89
        e = s.ents
        goal = (hit & (e.type == GOAL)).any(dim=1)
        spike = (hit & (e.type == SPIKE)).any(dim=1)
        return s.replace(
            done=s.done | goal | spike,
            reward=s.reward + torch.where(goal, GOAL_REWARD, 0.0),
            level_complete=s.level_complete | goal,
        ), d

    # -- rendering ----------------------------------------------------------

    def theme_for_grid_obj(self, s, type_):
        return torch.where(_is_wall(type_), per_env(s.game.wall_theme, type_), 0).to(i32)

    def image_for_type(self, s, type_):
        # jumper.cpp:120-135: standing, or the walk frames by heading
        e = s.ents
        g = s.game
        standing = (torch.abs(e.vx[:, 0]) < 0.01) & (s.action_vx == 0) & g.has_support
        frame1 = (torch.remainder(torch.div(s.cur_time, 5, rounding_mode="floor"), 2) == 0
                  ) | ~g.has_support
        right = torch.where(frame1, PLAYER_RIGHT1, PLAYER_RIGHT2)
        left = torch.where(frame1, PLAYER_LEFT1, PLAYER_LEFT2)
        player_img = torch.where(standing, PLAYER, torch.where(g.facing_right, right, left))
        return torch.where(type_ == PLAYER, per_env(player_img, type_),
                           torch.abs(type_)).to(i32)

    def render_overlay(self, s, obs, sx, sy, res, unit, vis):
        """The compass toward the goal and the distance bar (jumper.cpp:
        137-169), in frame coordinates over the int32 [N, res, res, 3]
        frames; ``sx``/``sy`` the pixel centres, ``unit``/``vis`` [N].
        The needle's angle, cosine and sine are glibc's (``core.libm``, one
        ``sincosf`` for both).
        Memory mode draws neither."""
        if self.options.distribution_mode == MEMORY_MODE:
            return obs
        cd = self.compass_dim
        e = s.ents
        slot = first_true(e.active & (e.type == GOAL))[:, None]
        gx, gy = e.x.gather(1, slot)[:, 0], e.y.gather(1, slot)[:, 0]
        ax, ay = e.x[:, 0], e.y[:, 0]
        col = lambda t: t[:, None, None]  # noqa: E731  [N] -> [N, 1, 1]

        # the compass's circle, at view_dim - cd - .25, .25
        x0 = (vis - cd - 0.25) * unit
        y0 = 0.25 * unit
        ccx = x0 + cd * unit / 2
        ccy = y0 + cd * unit / 2
        cr = cd * unit / 2
        dx2 = sx[None, None, :] - col(ccx)  # [N, 1, res]
        dy2 = sy[None, :, None] - col(ccy)  # [N, res, 1]
        in_circle = dx2 * dx2 + dy2 * dy2 < col(cr * cr)
        clock = torch.tensor(COMPASS_CLOCK, dtype=obs.dtype, device=obs.device)
        obs = torch.where(in_circle[..., None], clock, obs)

        # the needle toward the goal: pixels within ``thick`` of the segment
        sin_t, cos_t = libm.sincosf(libm.atan2f(gy - ay, gx - ax))
        nr = cr * 0.95
        vx_ = col(ccx + nr * cos_t - ccx)
        vy_ = col(ccy - nr * sin_t - ccy)
        seg_len2 = torch.clamp_min(vx_ * vx_ + vy_ * vy_, 1e-6)
        t = torch.clamp((dx2 * vx_ + dy2 * vy_) / seg_len2, 0.0, 1.0)
        ddx = dx2 - t * vx_
        ddy = dy2 - t * vy_
        thick = res / (256.0 / cd) / 2
        on_needle = ddx * ddx + ddy * ddy < thick * thick
        hi = torch.tensor(COMPASS_HI, dtype=obs.dtype, device=obs.device)
        obs = torch.where(on_needle[..., None], hi, obs)

        # the distance bar
        dist = torch.sqrt((ax - gx) ** 2 + (ay - gy) ** 2)
        dist_pct = dist / (s.main_width.to(f32) * math.sqrt(2))
        bx0 = (vis - cd - 0.25) * unit
        by0 = (0.25 + cd) * unit
        bw = cd * dist_pct * unit
        bh = (cd / 8) * unit
        in_bar = (((sy[None, :] >= by0[:, None]) & (sy[None, :] < (by0 + bh)[:, None]))[:, :, None]
                  & ((sx[None, :] >= bx0[:, None]) & (sx[None, :] < (bx0 + bw)[:, None]))[:, None, :])
        return torch.where(in_bar[..., None], hi, obs)

    # -- reset --------------------------------------------------------------

    def game_reset(self, s: BasicState) -> BasicState:
        s = self.game_reset_base(s)
        n = s.num
        dev = s.grid.device
        dim = self.world_dim
        A = dim * dim
        mode = self.options.distribution_mode

        s, wall_theme = self.randn(s, NUM_WALL_THEMES)
        s = s.replace(game=self.game_init_state(n, dev).replace(wall_theme=wall_theme))

        # the maze skeleton (jumper.cpp:242-256), three cells a maze cell
        maze_dim = dim // MAZE_SCALE
        g, mgrid, _, _, _ = mazegen.generate_maze_no_dead_ends(
            s.rand_gen, torch.full((n,), maze_dim, dtype=i32, device=dev), maze_dim)
        cells = torch.arange(A, device=dev)
        mpos = ((cells // dim) // MAZE_SCALE + 1) * (maze_dim + 2) + (cells % dim) // MAZE_SCALE + 1
        mobj = mgrid[:, mpos.clamp(0, mgrid.shape[1] - 1)]
        prob = torch.where(mobj == WALL_OBJ, torch.tensor(0.8, dtype=f32, device=dev),
                           torch.tensor(0.2, dtype=f32, device=dev))
        g, rolls = rng.draw_n(g, A)
        grid = torch.where(rng._rand01_from(rolls) < prob, WALL_OBJ, SPACE)
        grid = grid.reshape(n, dim, dim).to(i32)

        # 2 CA rounds (roomgen.cpp:21-36), the border (jumper.cpp:262-271)
        for _ in range(2):
            grid = roomgen.ca_update(grid, WALL_OBJ, SPACE)
        ar = torch.arange(dim, device=dev)
        border = ((ar[None, :] == 0) | (ar[None, :] == dim - 1)
                  | (ar[:, None] == 0) | (ar[:, None] == dim - 1))
        grid = torch.where(border, CAVEWALL, grid).to(i32)

        # the biggest room (roomgen.cpp:126-145); the goal on one of its
        # cells (jumper.cpp:288)
        best_room = roomgen.best_room_mask(grid, SPACE)
        grid = torch.where(best_room, SPACE, CAVEWALL).to(i32)
        g, goal_cell = _choose(g, best_room.reshape(n, A))

        # the agent on a SPACE cell on ground (jumper.cpp:292-304)
        cw_row = torch.full((n, 1, dim), CAVEWALL, dtype=i32, device=dev)
        below = torch.cat([cw_row, grid[:, :-1]], dim=1)
        above = torch.cat([grid[:, 1:], cw_row], dim=1)
        ground = (grid == SPACE) & (above == SPACE) & (below == CAVEWALL)
        g, agent_cell = _choose(g, ground.reshape(n, A))

        # the BFS path agent -> goal (roomgen.cpp:71-124), widened
        path = roomgen.bfs_path_mask(grid, SPACE, agent_cell, goal_cell)
        if mode != MEMORY_MODE:
            wide = roomgen.expand_mask(path, (grid == SPACE).reshape(n, A), 4, dim)
            grid = torch.where(wide.reshape(n, dim, dim), SPACE, CAVEWALL).to(i32)

        # the goal (jumper.cpp:325)
        ents = s.ents.push(default_fields(
            torch.remainder(goal_cell, dim).to(f32) + 0.5,
            torch.div(goal_cell, dim, rounding_mode="floor").to(f32) + 0.5,
            0.0, 0.0, 0.5, 0.5, GOAL))

        # the spikes and the anti-long-wall fixes (jumper.cpp:326-351)
        g, grid = sweeps(g, grid, 0.0 if mode == MEMORY_MODE else SPIKE_PROB)

        # the agent (jumper.cpp:353-355)
        ents = ents.set_fields(
            0, x=torch.remainder(agent_cell, dim).to(f32) + 0.5,
            y=torch.div(agent_cell, dim, rounding_mode="floor").to(f32) + 0.4,
            rx=0.254, ry=0.4)

        # the spikes as entities, in ascending cell order (jumper.cpp:357-365)
        spikes = (grid == SPIKE).reshape(n, A)
        grid = torch.where(grid == SPIKE, SPACE, grid)
        k = self.ENT_CAP - 2
        ranks = torch.cumsum(spikes.to(i32), dim=1) - 1
        slot = torch.where(spikes & (ranks < k), ranks, k).long()
        cell_of = torch.zeros((n, k + 1), dtype=torch.int64, device=dev)
        cell_of.scatter_(1, slot, cells.expand(n, A).contiguous())
        cell_of = cell_of[:, :k]
        f = default_fields(torch.remainder(cell_of, dim).to(f32) + 0.5,
                           torch.div(cell_of, dim, rounding_mode="floor").to(f32) + 0.4,
                           0.0, 0.0, 0.23, 0.4, SPIKE)
        do = torch.arange(k, device=dev)[None, :] < spikes.sum(dim=1)[:, None]
        ents = ents.push_many(f, do)

        # the walls' tops (jumper.cpp:367-374)
        above = torch.cat([grid[:, 1:], cw_row], dim=1)
        grid = torch.where((grid == CAVEWALL) & (above == SPACE), CAVEWALL_TOP, grid)
        return s.replace(grid=grid.to(i32), ents=ents, rand_gen=g)

    # -- per-step -----------------------------------------------------------

    def game_step(self, s: BasicState, d):
        s, d = self.game_step_base(s, d)
        e = s.ents
        refl = torch.where(s.action_vx > 0, False,
                           torch.where(s.action_vx < 0, True, e.is_reflected[:, 0]))
        e = e.set_fields(0, is_reflected=refl)

        # the movement trail (jumper.cpp:432-436)
        x0, y0, vx0, vy0 = e.x[:, 0], e.y[:, 0], e.vx[:, 0], e.vy[:, 0]
        moving = torch.abs(vx0) + torch.abs(vy0) > 0.05
        tf = default_fields(x0, y0 - e.ry[:, 0] * 0.5, 0.0, 0.01, 0.3, 0.2, TRAIL)
        tf["expire_time"] = 8
        tf["alpha"] = 0.5
        decor = s.decor.push(tf, do=moving)

        # gravity, after the move (jumper.cpp:438-440)
        vy = torch.where(vy0 > -2, vy0 - 0.15, vy0)
        return s.replace(ents=e.set_fields(0, vy=vy), decor=decor), d


def _choose(g: rng.MTState, mask: torch.Tensor):
    """choose_one of the True cells of ``mask`` [N, A], ascending: one
    randn draw of their count (at least 1); the first cell when none."""
    count = mask.sum(dim=1, dtype=i32).clamp_min(1)
    g, r = rng.randn(g, count)
    ranks = torch.cumsum(mask.to(i32), dim=1) - 1
    return g, first_true(mask & (ranks == r[:, None]))


def sweeps(g: rng.MTState, grid: torch.Tensor, prob: float):
    """The spike sweep, then the wall sweep, on ``grid`` [N, dim, dim]
    (jumper.cpp:326-351), their draws from one block of the stream ``g``,
    which then advances by the words drawn.  Returns (g, grid)."""
    elig = _spike_candidates(grid)
    need = int(elig.sum(dim=(1, 2)).max()) + int(_wall_candidates(grid).sum(dim=(1, 2)).max())
    block, ctx = rng.draw_block(g, max(need, 1))
    grid, cursor = _spike_sweep(grid, elig, block, prob)
    grid, cursor = _wall_sweep(grid, block, cursor)
    return rng.advance_block(g, ctx, cursor), grid


def _spike_candidates(grid: torch.Tensor) -> torch.Tensor:
    """The cells the spike sweep can draw at, [N, dim, dim] bool: a SPACE
    cell on ground with SPACE above it, and so are its left and right
    neighbours (is_space_on_ground, jumper.cpp:183-190), cells outside the
    grid reading as CAVEWALL.  The sweep only turns SPACE into SPIKE; a
    spike's own row reads the cell, and the rows after it read it only as
    "not CAVEWALL", which a spike leaves as it was, so a cell is eligible
    when it comes if and only if it is a candidate here and its left
    neighbour took no spike."""
    n, dim, _ = grid.shape
    sp = grid == SPACE
    cw = grid == CAVEWALL
    f = torch.zeros((n, 1, dim), dtype=torch.bool, device=grid.device)
    t = torch.ones((n, 1, dim), dtype=torch.bool, device=grid.device)
    above_sp = torch.cat([sp[:, 1:], f], dim=1)
    below_cw = torch.cat([t, cw[:, :-1]], dim=1)
    sog = sp & above_sp & below_cw  # [N, y, x]
    fc = torch.zeros((n, dim, 1), dtype=torch.bool, device=grid.device)
    left = torch.cat([fc, sog[:, :, :-1]], dim=2)
    right = torch.cat([sog[:, :, 1:], fc], dim=2)
    return sog & left & right


def _spike_sweep(grid, elig, block, prob: float):
    """The spike sweep (jumper.cpp:326-337): every eligible cell, in
    row-major order, draws one ``rand01`` and becomes a SPIKE below
    ``prob``.  Only the candidates of ``_spike_candidates`` can be
    eligible, and a candidate is skipped exactly when the candidate just
    before it, its left neighbour, took a spike (no candidate sits at
    either end of a row).  So the sweep walks the candidates in order,
    one masked iteration each, to the batch's largest count; ``block``
    holds the words from the stream's cursor.  Returns (grid, words
    drawn [N])."""
    n, dim, _ = grid.shape
    A = dim * dim
    dev = grid.device
    flat = elig.reshape(n, A)
    count = flat.sum(dim=1)
    kmax = int(count.max())
    cells = torch.arange(A, device=dev)
    ranks = torch.cumsum(flat.to(i32), dim=1) - 1
    pos = torch.zeros((n, kmax + 1), dtype=torch.int64, device=dev)
    pos.scatter_(1, torch.where(flat, ranks, kmax).long(), cells.expand(n, A).contiguous())
    pos = pos[:, :kmax]
    adj = torch.zeros_like(pos, dtype=torch.bool)
    adj[:, 1:] = pos[:, 1:] == pos[:, :-1] + 1
    p = torch.tensor(prob, dtype=f32, device=dev)
    cursor = torch.zeros((n,), dtype=torch.int64, device=dev)
    prev = torch.zeros((n,), dtype=torch.bool, device=dev)
    placed = torch.zeros((n, kmax + 1), dtype=torch.bool, device=dev)
    for k in range(kmax):
        act = (k < count) & ~(adj[:, k] & prev)
        word = block.gather(1, cursor[:, None].clamp_max(block.shape[1] - 1))[:, 0]
        prev = act & (rng._rand01_from(word) < p)
        placed[:, k] = prev
        cursor = cursor + act
    hit = torch.zeros((n, A + 1), dtype=torch.bool, device=dev)
    hit.scatter_(1, torch.where(placed[:, :kmax], pos, A), True)
    grid = torch.where(hit[:, :A].reshape(n, dim, dim), SPIKE, grid).to(i32)
    return grid, cursor.to(i32)


def _wall_candidates(grid: torch.Tensor) -> torch.Tensor:
    """The cells whose column holds CAVEWALL at rows y, y + 1 and y + 2:
    the wall sweep can fire only there (it turns CAVEWALL into SPACE and
    never back), once a cell at most; a bound on its draws."""
    cw = grid == CAVEWALL
    out = torch.zeros_like(cw)
    out[:, :-2] = cw[:, :-2] & cw[:, 1:-1] & cw[:, 2:]
    return out


def _wall_sweep(grid, block, cursor):
    """The anti-long-wall sweep (jumper.cpp:339-351): at each cell, in
    row-major order, a left wall (CAVEWALL at x with SPACE at x + 1, in
    rows y to y + 2) opens one of those three cells at x, picked by a
    ``randn(3)``; then a right wall likewise, against x - 1.  The cells of
    one row are independent of each other's writes: a cell that fires had
    CAVEWALL at x in the three rows and keeps two of them, so the right
    wall test of x + 1, which needs SPACE there, fails before and after;
    and a cell's left wall reads x and x + 1, which no earlier cell of the
    row writes.  A cell's own left wall opens a cell at x, so its right
    wall then fails.  So each row is one batched step from the grid of the
    rows before, its draws in column order; a cell fires only where row
    y + 2 is in the grid.  ``block`` holds the words from the stream's
    cursor, ``cursor`` [N] the words already drawn.  Returns (grid,
    cursor)."""
    n, dim, _ = grid.shape
    dev = grid.device
    cursor = cursor.long()
    fc = torch.zeros((n, 3, 1), dtype=torch.bool, device=dev)
    r3 = torch.arange(3, device=dev)[None, :, None]
    for y in range(dim - 2):
        rows = grid[:, y:y + 3]
        cw = rows == CAVEWALL
        sp = rows == SPACE
        right_sp = torch.cat([sp[:, :, 1:], fc], dim=2)
        left_sp = torch.cat([fc, sp[:, :, :-1]], dim=2)
        lw = (cw & right_sp).all(dim=1)
        rw = (cw & left_sp).all(dim=1) & ~lw
        fire = lw | rw  # [N, dim]
        at = cursor[:, None] + torch.cumsum(fire.to(torch.int64), dim=1) - 1
        word = block.gather(1, at.clamp(0, block.shape[1] - 1))
        r = rng._randn_from(word, 3)
        cursor = cursor + fire.sum(dim=1)
        opened = fire[:, None, :] & (r[:, None, :] == r3)
        grid = grid.clone()
        grid[:, y:y + 3] = torch.where(opened, SPACE, rows)
    return grid, cursor.to(i32)
