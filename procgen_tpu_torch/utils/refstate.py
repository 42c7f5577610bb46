"""Bidirectional bridge to the C++ engine's serialized states (WriteBuffer).

The counterpart of ``procgen_tpu.utils.refstate``.  The reference
checkpoints an env as a raw little-endian byte stream (game.cpp:196-304 ->
basic-abstract-game.cpp:1178-1280 -> entity.cpp:90-177 -> per-game
tails), with both mt19937 streams stored as libstdc++'s text state
(randgen.cpp:100-114: 624 words and the position).  This module converts
that layout to and from the port's batched ``BasicState``:

- ``import_reference_state``: the C++ engine's states of N envs become one
  batched state on the caller's device, to be stepped mid-episode;
- ``export_reference_state``: a batched state becomes one byte string an
  env, which the C++ engine's ``deserialize`` accepts.

The bytes are parsed and written on the host, over the state's numpy
form (``bridge.state_to_numpy``).  Fields the design derives on the fly
(the camera scalars unit/view_dim/x_off/y_off, recomputed by
prepare_for_drawing before any use, basic-abstract-game.cpp:828-847, and
the asset RNG, reseeded before each use, basic-abstract-game.cpp:103) are
written as placeholders on export and skipped on import; the fields only
the port has (the HUD's total_reward, step_draws, the static render
prefix) are rebuilt on import, the prefix by the port's own
``renderer.render_obs(..., prefix_only=True)``.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..bridge import state_from_numpy, state_to_numpy
from ..core import lifecycle
from ..core import rng as rnglib
from ..core.constants import SERIALIZE_VERSION
from .host_mt import HostMT19937


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def i(self) -> int:
        (v,) = struct.unpack_from("<i", self.data, self.off)
        self.off += 4
        return v

    def f(self) -> float:
        (v,) = struct.unpack_from("<f", self.data, self.off)
        self.off += 4
        return v

    def b(self) -> bool:
        return bool(self.i())

    def s(self) -> str:
        n = self.i()
        v = self.data[self.off:self.off + n].decode()
        self.off += n
        return v

    def vec_i(self) -> list:
        n = self.i()
        out = list(struct.unpack_from(f"<{n}i", self.data, self.off))
        self.off += 4 * n
        return out

    def vec_f(self) -> list:
        n = self.i()
        out = list(struct.unpack_from(f"<{n}f", self.data, self.off))
        self.off += 4 * n
        return out

    def vec_b(self) -> list:
        return [bool(v) for v in self.vec_i()]


class _Writer:
    """WriteBuffer mirror (buffer.h:84-133)."""

    def __init__(self):
        self.buf = bytearray()

    def i(self, v) -> None:
        self.buf += struct.pack("<i", int(v))

    def f(self, v) -> None:
        self.buf += struct.pack("<f", float(v))

    def b(self, v) -> None:
        self.i(1 if bool(v) else 0)

    def s(self, v: str) -> None:
        raw = v.encode()
        self.i(len(raw))
        self.buf += raw

    def vec_i(self, vals) -> None:
        vals = [int(v) for v in vals]
        self.i(len(vals))
        self.buf += struct.pack(f"<{len(vals)}i", *vals)

    def vec_f(self, vals) -> None:
        vals = [float(v) for v in vals]
        self.i(len(vals))
        self.buf += struct.pack(f"<{len(vals)}f", *vals)

    def vec_b(self, vals) -> None:
        self.i(len(vals))
        for v in vals:
            self.b(v)

    def bytes(self) -> bytes:
        return bytes(self.buf)


def _read_randgen(r: _Reader, out: dict) -> None:
    """RandGen::serialize: is_seeded, then the mt19937 text into one env's
    MTState row ``out``."""
    is_seeded = bool(r.i())
    words = r.s().split()
    # libstdc++ mersenne_twister operator<<: 624 state words then _M_p
    if len(words) != 625:
        raise ValueError(f"unexpected mt19937 text length {len(words)}")
    out["mt"][...] = np.array([int(w) for w in words[:624]], np.uint32)
    out["pos"][...] = int(words[624])
    out["is_seeded"][...] = is_seeded


def _write_randgen(w: _Writer, st: dict) -> None:
    """The inverse of ``_read_randgen``.  The port keeps pos < 624
    (rng.normalize), a valid libstdc++ stream position."""
    w.i(1 if bool(st["is_seeded"]) else 0)
    mt = np.asarray(st["mt"], np.uint32)
    pos = int(st["pos"])
    assert mt.shape == (624,) and 0 <= pos <= 624
    w.s(" ".join(str(int(x)) for x in mt) + " " + str(pos))


_FRESH_MT_TEXT = None


def _write_fresh_randgen(w: _Writer) -> None:
    """A freshly seeded generator's state (seed 0), for the stream the
    port does not carry (asset_rand_gen: reseeded with fixed_asset_seed +
    type before every use, basic-abstract-game.cpp:103)."""
    global _FRESH_MT_TEXT
    if _FRESH_MT_TEXT is None:
        g = HostMT19937(0)
        _FRESH_MT_TEXT = " ".join(str(int(x)) for x in g.mt) + " 624"
    w.i(1)
    w.s(_FRESH_MT_TEXT)


_ENTITY_FIELDS = [
    ("x", "f"), ("y", "f"), ("vx", "f"), ("vy", "f"), ("rx", "f"),
    ("ry", "f"), ("type", "i"), ("image_type", "i"), ("image_theme", "i"),
    ("render_z", "i"), ("will_erase", "b"), ("collides_with_entities", "b"),
    ("collision_margin", "f"), ("rotation", "f"), ("vrot", "f"),
    ("is_reflected", "b"), ("fire_time", "i"), ("spawn_time", "i"),
    ("life_time", "i"), ("expire_time", "i"), ("use_abs_coords", "b"),
    ("friction", "f"), ("smart_step", "b"), ("avoids_collisions", "b"),
    ("auto_erase", "b"), ("alpha", "f"), ("health", "f"), ("theta", "f"),
    ("grow_rate", "f"), ("alpha_decay", "f"), ("climber_spawn_x", "f"),
]


def _read_entity(r: _Reader) -> dict:
    out = {}
    for name, kind in _ENTITY_FIELDS:
        out[name] = r.f() if kind == "f" else r.i() if kind == "i" else bool(r.i())
    return out


def _read_entities(r: _Reader) -> list:
    """BasicAbstractGame::read_entities (basic-abstract-game.cpp:1169)."""
    n = r.i()
    return [_read_entity(r) for _ in range(n)]


def _write_entity_rows(w: _Writer, pools) -> None:
    """BasicAbstractGame::write_entities (basic-abstract-game.cpp:1161):
    the count, then each entity's 31 fields in entity.cpp:90-132 order.
    ``pools`` is a list of (one env's pool row, slot indices)."""
    w.i(sum(len(idxs) for _, idxs in pools))
    for ents, idxs in pools:
        for j in idxs:
            for name, kind in _ENTITY_FIELDS:
                v = ents[name][j]
                if kind == "f":
                    w.f(v)
                elif kind == "i":
                    w.i(v)
                else:
                    w.b(v)


def _set_entities(ents: dict, ents_list, what="entities") -> None:
    """One env's pool row: dense slots [0, n) from an ordered reference
    entity list, the rest zero."""
    cap = ents["x"].shape[0]
    n = len(ents_list)
    if n > cap:
        raise ValueError(f"{what}: {n} entities > cap {cap}")
    ents["count"][...] = n
    for fname, _ in _ENTITY_FIELDS:
        col = ents[fname]
        col[...] = 0
        if n:
            col[:n] = [e[fname] for e in ents_list]


def _options_ints(game) -> list:
    """The 12 GameOptions ints, in serialize order (game.cpp:201-212)."""
    o = game.options
    return [
        int(o.paint_vel_info), int(o.use_generated_assets),
        int(o.use_monochrome_assets), int(o.restrict_themes),
        int(o.use_backgrounds), int(o.center_agent), int(o.debug_mode),
        int(o.distribution_mode), int(o.use_sequential_levels),
        int(getattr(o, "use_easy_jump", False)),
        int(getattr(o, "plain_assets", 0)), int(getattr(o, "physics_mode", 0)),
    ]


def _row(tree, e: int):
    """Env ``e`` of a numpy state tree: writable views of its rows."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _row(v, e) for k, v in tree.items()}
    return tree[e, ...]


def _copy(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return np.array(tree)


def _check(cond, what) -> None:
    if not cond:
        raise ValueError(f"reference state: {what}")


def import_reference_state(game, blobs, template=None, device="cuda"):
    """Parse the C++ engine's serialized states of ``len(blobs)`` envs into
    one batched state.  ``template`` (a batched state of as many envs)
    gives the static shapes (grid padding, entity capacities) and the
    fields the bytes do not carry; by default ``initial_state`` of seed 0,
    as the JAX package's importer is given, on ``device``."""
    n = len(blobs)
    if template is None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not available")
        template = lifecycle.initial_state(
            game, torch.zeros((n,), dtype=torch.int64, device=dev))
    _check(template.num == n, f"a template of {template.num} envs for {n} blobs")
    dev = template.reward.device
    tree = _copy(state_to_numpy(template))
    for e, blob in enumerate(blobs):
        _import_one(game, _row(tree, e), blob)
    s = state_from_numpy(tree, game, dev)
    s = s.replace(rand_gen=rnglib.normalize(s.rand_gen))
    if game.static_prefix:
        from ..render.renderer import render_obs

        s = s.replace(frame=render_obs(game, s, 64, prefix_only=True))
    return s


def _import_one(game, s: dict, blob: bytes) -> None:
    r = _Reader(blob)
    _check(r.i() == SERIALIZE_VERSION, "serialize version")
    name = r.s()
    _check(name == game.name, f"a {name} state for {game.name}")
    for _ in range(12):
        r.i()  # GameOptions ints: the env's own options hold

    grid_step = r.i()
    _check(bool(grid_step) == bool(game.grid_step), "grid_step")
    game.level_seed_low = r.i()
    game.level_seed_high = r.i()
    r.i()  # game_type
    r.i()  # game_n

    _read_randgen(r, s["level_seed_rand_gen"])
    _read_randgen(r, s["rand_gen"])

    s["reward"][...] = r.f()
    s["done"][...] = r.b()
    s["level_complete"][...] = r.b()
    s["action"][...] = r.i()
    timeout = r.i()
    _check(timeout == game.timeout, f"timeout {timeout}, the game's {game.timeout}")
    s["current_level_seed"][...] = r.i()
    s["prev_level_seed"][...] = r.i()
    s["episodes_remaining"][...] = r.i()
    s["episode_done"][...] = r.b()
    s["last_reward_timer"][...] = r.i()
    s["last_reward"][...] = r.f()
    r.i()  # default_action (static config)
    r.i()  # fixed_asset_seed (static config)
    s["cur_time"][...] = r.i()
    r.i()  # is_waiting_for_step (the thread pool's bookkeeping)

    # ---- BasicAbstractGame (basic-abstract-game.cpp:1178-1225) ----------
    r.i()  # grid_size (the grid header below repeats it)
    ents_list = _read_entities(r)
    r.i()  # use_procgen_background
    s["background_index"][...] = r.i()
    r.f()  # bg_tile_ratio (static config)
    s["bg_pct_x"][...] = r.f()
    r.f()  # char_dim (static config)
    for k in ("last_move_action", "move_action", "special_action"):
        s[k][...] = r.i()
    for k in ("mixrate", "maxspeed", "max_jump", "action_vx", "action_vy",
              "action_vrot"):
        s[k][...] = r.f()
    r.f()  # center_x (derived per render)
    r.f()  # center_y
    r.i()  # random_agent_start (static config)
    r.i()  # has_useful_vel_info (static config)
    s["step_rand_int"][...] = r.i()
    _read_randgen(r, {"mt": np.zeros(624, np.uint32), "pos": np.zeros((), np.int32),
                      "is_seeded": np.zeros((), bool)})  # asset_rand_gen
    s["main_width"][...] = r.i()
    s["main_height"][...] = r.i()
    r.i()  # out_of_bounds_object (static config)
    for _ in range(6):
        r.f()  # unit, view_dim, x_off, y_off, visibility, min_visibility

    gw = r.i()
    gh = r.i()
    gdata = r.vec_i()
    _check(len(gdata) == gw * gh, "grid size")

    # the reference keeps decorative entities in the one entities vector;
    # the port keeps them in the render-only ``decor`` pool, split by the
    # game's DECOR_TYPES, each part in its order
    inter = [e for e in ents_list if e["type"] not in game.DECOR_TYPES]
    decs = [e for e in ents_list if e["type"] in game.DECOR_TYPES]
    _set_entities(s["ents"], inter)
    _check(not decs or s["decor"] is not None,
           f"{game.name}: {len(decs)} decorative entities but DECOR_CAP=0")
    if s["decor"] is not None:
        _set_entities(s["decor"], decs, what="decor")

    s["grid"][...] = 0
    s["grid"][:gh, :gw] = np.asarray(gdata, np.int32).reshape(gh, gw)
    s["total_reward"][...] = 0.0
    s["step_draws"][...] = 0

    imp, _ = _GAME_TAILS[game.name]
    imp(game, s, r)
    _check(r.off == len(blob), f"{len(blob) - r.off} bytes left over")


def export_reference_state(game, states) -> list:
    """One C++ byte string for each env of ``states``, accepted by
    Game::deserialize (game.cpp:257-304); env e is written as game_n e.
    Camera scalars that prepare_for_drawing recomputes are placeholders;
    the centre is ``choose_center``'s."""
    tree = state_to_numpy(states)
    cx, cy = (t.detach().cpu().numpy() for t in game.choose_center(states))
    return [_export_one(game, _row(tree, e), e, cx[e], cy[e])
            for e in range(states.num)]


def _export_one(game, s: dict, env_idx: int, cx, cy) -> bytes:
    w = _Writer()
    w.i(SERIALIZE_VERSION)
    w.s(game.name)
    for v in _options_ints(game):
        w.i(v)

    w.i(1 if game.grid_step else 0)
    w.i(game.level_seed_low)
    w.i(game.level_seed_high)
    w.i(game.game_type)
    w.i(env_idx)  # game_n = env index in the batch (vecgame.cpp:365)

    _write_randgen(w, s["level_seed_rand_gen"])
    _write_randgen(w, s["rand_gen"])

    w.f(s["reward"])
    w.b(s["done"])
    w.b(s["level_complete"])
    w.i(s["action"])
    w.i(game.timeout)
    w.i(s["current_level_seed"])
    w.i(s["prev_level_seed"])
    w.i(s["episodes_remaining"])
    w.b(s["episode_done"])
    w.i(s["last_reward_timer"])
    w.f(s["last_reward"])
    w.i(game.default_action)
    w.i(np.int32(np.uint32(game.fixed_asset_seed & 0xFFFFFFFF)))
    w.i(s["cur_time"])
    w.i(0)  # is_waiting_for_step

    # ---- BasicAbstractGame (basic-abstract-game.cpp:1178-1225) ----------
    mw = int(s["main_width"])
    mh = int(s["main_height"])
    w.i(mw * mh)  # grid_size
    pools = [(s["ents"], range(int(s["ents"]["count"])))]
    if s["decor"] is not None:
        pools.append((s["decor"], range(int(s["decor"]["count"]))))
    _write_entity_rows(w, pools)
    w.i(1 if game.options.use_generated_assets else 0)  # use_procgen_background
    w.i(s["background_index"])
    w.f(game.bg_tile_ratio)
    w.f(s["bg_pct_x"])
    w.f(game.char_dim)
    for k in ("last_move_action", "move_action", "special_action"):
        w.i(s[k])
    for k in ("mixrate", "maxspeed", "max_jump", "action_vx", "action_vy",
              "action_vrot"):
        w.f(s[k])
    w.f(cx)
    w.f(cy)
    w.b(game.random_agent_start)
    w.b(game.has_useful_vel_info)
    w.i(s["step_rand_int"])
    _write_fresh_randgen(w)  # asset_rand_gen (reseeded before use)
    w.i(mw)
    w.i(mh)
    w.i(game.out_of_bounds_object)
    for _ in range(4):
        w.f(0.0)  # unit, view_dim, x_off, y_off (prepare_for_drawing)
    w.f(s["visibility"])
    w.f(game.min_visibility)

    # Grid::serialize (grid.h): w, h, then the flat vector
    w.i(mw)
    w.i(mh)
    w.vec_i(np.asarray(s["grid"])[:mh, :mw].reshape(-1))

    _, exp = _GAME_TAILS[game.name]
    exp(game, s, w)
    return w.bytes()


# ---------------------------------------------------------------------------
# Per-game serialize tails (procgen_tpu/utils/refstate.py:526-1043).  An
# import writes the dynamic fields into one env's rows (statics are checked
# or skipped); an export writes them from the rows and the statics from the
# game's configuration.  ``g`` is the env's ``game`` rows.


def _maze_imp(game, s, r):  # maze.cpp serialize: maze_dim, world_dim
    s["game"]["maze_dim"][...] = r.i()
    r.i()  # world_dim (static per mode)


def _maze_exp(game, s, w):
    w.i(s["game"]["maze_dim"])
    w.i(game.world_dim)


def _miner_imp(game, s, r):  # miner.cpp: diamonds_remaining
    g = s["game"]
    g["diamonds_remaining"][...] = r.i()
    g["died"][...] = False


def _miner_exp(game, s, w):
    w.i(s["game"]["diamonds_remaining"])


def _bigfish_imp(game, s, r):  # bigfish.cpp:108-112
    g = s["game"]
    g["fish_eaten"][...] = r.i()
    g["r_inc"][...] = r.f()


def _bigfish_exp(game, s, w):
    w.i(s["game"]["fish_eaten"])
    w.f(s["game"]["r_inc"])


def _none_imp(game, s, r):  # caveflyer.cpp has no serialize override
    pass


def _none_exp(game, s, w):
    pass


def _bossfight_imp(game, s, r):  # bossfight.cpp:415-441
    g = s["game"]
    am = r.vec_i()
    g["attack_modes"][...] = 0
    g["attack_modes"][:len(am)] = am
    g["last_fire_time"][...] = r.i()
    g["time_to_swap"][...] = r.i()
    g["invulnerable_duration"][...] = r.i()
    r.i()  # vulnerable_duration = 500 const (bossfight.cpp:223)
    g["num_rounds"][...] = r.i()
    g["round_num"][...] = r.i()
    g["round_health"][...] = r.i()
    r.i()  # boss_vel_timeout = 20 const (bossfight.cpp:29,218)
    for k in ("curr_vel_timeout", "attack_mode", "player_laser_theme",
              "boss_laser_theme", "damaged_until_time"):
        g[k][...] = r.i()
    g["shields_are_up"][...] = r.b()
    r.b()  # barriers_moves_right (drawn, never read; bossfight.cpp:247)
    r.f()  # base_fire_prob = 0.1 const
    g["boss_bullet_vel"][...] = r.f()
    r.f()  # barrier_vel = 0.1 const
    r.f()  # barrier_spawn_prob = 0.025 const
    for k in ("rand_pct", "rand_fire_pct", "rand_pct_x", "rand_pct_y"):
        g[k][...] = r.f()


def _bossfight_exp(game, s, w):
    g = s["game"]
    n_rounds = int(g["num_rounds"])
    w.vec_i(g["attack_modes"][:n_rounds])
    w.i(g["last_fire_time"])
    w.i(g["time_to_swap"])
    w.i(g["invulnerable_duration"])
    w.i(500)  # vulnerable_duration (bossfight.cpp:223)
    w.i(n_rounds)
    w.i(g["round_num"])
    w.i(g["round_health"])
    w.i(20)  # boss_vel_timeout (bossfight.cpp:29)
    for k in ("curr_vel_timeout", "attack_mode", "player_laser_theme",
              "boss_laser_theme", "damaged_until_time"):
        w.i(g[k])
    w.b(g["shields_are_up"])
    w.b(False)  # barriers_moves_right: drawn but never read
    w.f(game.base_fire_prob)
    w.f(g["boss_bullet_vel"])
    w.f(0.1)  # barrier_vel (bossfight.cpp:246)
    w.f(0.025)  # barrier_spawn_prob (bossfight.cpp:248)
    for k in ("rand_pct", "rand_fire_pct", "rand_pct_x", "rand_pct_y"):
        w.f(g[k])


def _chaser_free_cells(s):
    """chaser.cpp:246-257: free_cells / is_space_vec are functions of the
    (wall-stable) grid, every non-wall cell in flat ascending order; the
    port derives them."""
    from ..games.chaser import MAZE_WALL

    mw, mh = int(s["main_width"]), int(s["main_height"])
    is_space = np.asarray(s["grid"])[:mh, :mw].reshape(-1) != MAZE_WALL
    return np.nonzero(is_space)[0], is_space


def _chaser_imp(game, s, r):  # chaser.cpp:388-398
    g = s["game"]
    free_cells = r.vec_i()
    is_space_vec = r.vec_b()
    r.i()  # eat_timeout = 75 const (chaser.cpp:43)
    r.i()  # egg_timeout = 50 const (chaser.cpp:44)
    g["eat_time"][...] = r.i()
    r.i()  # total_enemies (mode const, chaser.cpp:143-157)
    g["total_orbs"][...] = r.i()
    g["orbs_collected"][...] = r.i()
    maze_dim = r.i()
    _check(maze_dim == game.maze_dim, f"maze_dim {maze_dim}")
    want_free, want_space = _chaser_free_cells(s)
    _check(list(want_free) == free_cells and list(want_space) == is_space_vec,
           "chaser's free cells are not the grid's")


def _chaser_exp(game, s, w):
    free_cells, is_space = _chaser_free_cells(s)
    w.vec_i(free_cells)
    w.vec_b(is_space)
    w.i(75)  # eat_timeout (chaser.cpp:43)
    w.i(50)  # egg_timeout (chaser.cpp:44)
    w.i(s["game"]["eat_time"])
    w.i(game.total_enemies)
    w.i(s["game"]["total_orbs"])
    w.i(s["game"]["orbs_collected"])
    w.i(game.maze_dim)


def _climber_imp(game, s, r):  # climber.cpp:321-329
    g = s["game"]
    g["has_support"][...] = r.b()
    g["facing_right"][...] = r.b()
    g["coin_quota"][...] = r.i()
    g["coins_collected"][...] = r.i()
    g["wall_theme"][...] = r.i()
    r.f()  # gravity = 0.2 const (climber.cpp:238)
    r.f()  # air_control = 0.15 const (climber.cpp:240)


def _climber_exp(game, s, w):
    g = s["game"]
    w.b(g["has_support"])
    w.b(g["facing_right"])
    w.i(g["coin_quota"])
    w.i(g["coins_collected"])
    w.i(g["wall_theme"])
    w.f(0.2)  # gravity (climber.cpp:238)
    w.f(0.15)  # air_control (climber.cpp:240)


def _coinrun_imp(game, s, r):  # coinrun.cpp:506-514
    g = s["game"]
    g["last_agent_y"][...] = r.f()
    g["wall_theme"][...] = r.i()
    g["has_support"][...] = r.b()
    g["facing_right"][...] = r.b()
    g["is_on_crate"][...] = r.b()
    r.f()  # gravity = 0.2 const (coinrun.cpp:419)
    r.f()  # air_control = 0.15 const (coinrun.cpp:421)


def _coinrun_exp(game, s, w):
    g = s["game"]
    w.f(g["last_agent_y"])
    w.i(g["wall_theme"])
    w.b(g["has_support"])
    w.b(g["facing_right"])
    w.b(g["is_on_crate"])
    w.f(0.2)
    w.f(0.15)


def _dodgeball_imp(game, s, r):  # dodgeball.cpp:448-456
    g = s["game"]
    r.f()  # min_dim = agent_r*8 + .5 (dodgeball.cpp:316)
    r.f()  # hard_min_dim = 4*agent_r + 2*thickness + .5 (dodgeball.cpp:315)
    g["ball_vscale"][...] = r.f()
    g["ball_r"][...] = r.f()
    g["last_fire_time"][...] = r.i()
    g["num_enemies"][...] = r.i()
    r.i()  # enemy_fire_delay = 50 const (dodgeball.cpp:41)


def _dodgeball_exp(game, s, w):
    g = s["game"]
    w.f(game.agent_r * 8 + 0.5)  # min_dim (dodgeball.cpp:316)
    w.f(4 * game.agent_r + 2 * game.thickness + 0.5)  # hard_min_dim (:315)
    w.f(g["ball_vscale"])
    w.f(g["ball_r"])
    w.i(g["last_fire_time"])
    w.i(g["num_enemies"])
    w.i(50)  # enemy_fire_delay (dodgeball.cpp:41)


def _fruitbot_imp(game, s, r):  # fruitbot.cpp:266-270
    r.f()  # min_dim = 5 const (fruitbot.cpp:36)
    r.f()  # bullet_vscale = .5 const (fruitbot.cpp:37)
    s["game"]["last_fire_time"][...] = r.i()


def _fruitbot_exp(game, s, w):
    w.f(5.0)  # min_dim (fruitbot.cpp:36)
    w.f(game.bullet_vscale)
    w.i(s["game"]["last_fire_time"])


def _heist_imp(game, s, r):  # heist.cpp:208-212
    g = s["game"]
    num_keys = r.i()
    world_dim = r.i()
    _check(world_dim == game.world_dim, f"world_dim {world_dim}")
    has_keys = r.vec_b()
    _check(len(has_keys) == num_keys, "heist's key count")
    g["num_keys"][...] = num_keys
    g["has_keys"][...] = False
    g["has_keys"][:num_keys] = has_keys


def _heist_exp(game, s, w):
    g = s["game"]
    num_keys = int(g["num_keys"])
    w.i(num_keys)
    w.i(game.world_dim)
    w.vec_b(g["has_keys"][:num_keys])


def _jumper_imp(game, s, r):  # jumper.cpp:440-448
    g = s["game"]
    for k in ("jump_count", "jump_delta", "jump_time"):
        g[k][...] = r.i()
    g["has_support"][...] = r.b()
    g["facing_right"][...] = r.b()
    g["wall_theme"][...] = r.i()
    r.f()  # compass_dim (mode const, jumper.cpp)


def _jumper_exp(game, s, w):
    g = s["game"]
    for k in ("jump_count", "jump_delta", "jump_time"):
        w.i(g[k])
    w.b(g["has_support"])
    w.b(g["facing_right"])
    w.i(g["wall_theme"])
    w.f(game.compass_dim)


def _leaper_imp(game, s, r):  # leaper.cpp serialize
    g = s["game"]
    g["bottom_road_y"][...] = r.i()
    road = r.vec_f()
    g["bottom_water_y"][...] = r.i()
    water = r.vec_f()
    g["goal_y"][...] = r.i()
    for k, speeds in (("road", road), ("water", water)):
        g[f"{k}_lane_speeds"][...] = 0.0
        g[f"{k}_lane_speeds"][:len(speeds)] = speeds
        g[f"num_{k}_lanes"][...] = len(speeds)


def _leaper_exp(game, s, w):
    g = s["game"]
    w.i(g["bottom_road_y"])
    w.vec_f(g["road_lane_speeds"][:int(g["num_road_lanes"])])
    w.i(g["bottom_water_y"])
    w.vec_f(g["water_lane_speeds"][:int(g["num_water_lanes"])])
    w.i(g["goal_y"])


def _ninja_imp(game, s, r):  # ninja.cpp:419-428
    g = s["game"]
    g["has_support"][...] = r.b()
    g["facing_right"][...] = r.b()
    g["last_fire_time"][...] = r.i()
    g["wall_theme"][...] = r.i()
    r.f()  # gravity = 0.2 const (ninja.cpp:310)
    r.f()  # air_control = 0.15 const (ninja.cpp:312)
    g["jump_charge"][...] = r.f()
    r.f()  # jump_charge_inc (mode const, ninja.cpp)


def _ninja_exp(game, s, w):
    g = s["game"]
    w.b(g["has_support"])
    w.b(g["facing_right"])
    w.i(g["last_fire_time"])
    w.i(g["wall_theme"])
    w.f(0.2)
    w.f(0.15)
    w.f(g["jump_charge"])
    w.f(game.jump_charge_inc)


def _plunder_imp(game, s, r):  # plunder.cpp:250-264
    g = s["game"]
    g["last_fire_time"][...] = r.i()
    for k, read in (("lane_directions", r.vec_b), ("target_bools", r.vec_b),
                    ("image_permutation", r.vec_i), ("lane_vels", r.vec_f)):
        vals = read()
        g[k][...] = 0
        g[k][:len(vals)] = vals
    r.i()  # num_lanes = 5 const (plunder.cpp:128)
    r.i()  # num_current_ship_types = 2 const (plunder.cpp:141)
    g["targets_hit"][...] = r.i()
    r.i()  # target_quota = 20 const (plunder.cpp:123)
    g["juice_left"][...] = r.f()
    r.f()  # r_scale (mode const, plunder.cpp:125)
    r.f()  # spawn_prob = 0.06 const (plunder.cpp:124)
    r.f()  # legend_r = 2 const (plunder.cpp:166)
    g["min_agent_x"][...] = r.f()


def _plunder_exp(game, s, w):
    g = s["game"]
    w.i(g["last_fire_time"])
    w.vec_b(g["lane_directions"])
    w.vec_b(g["target_bools"])
    w.vec_i(g["image_permutation"])
    w.vec_f(g["lane_vels"])
    w.i(5)  # num_lanes (plunder.cpp:128)
    w.i(2)  # num_current_ship_types (plunder.cpp:141)
    w.i(g["targets_hit"])
    w.i(20)  # target_quota (plunder.cpp:123)
    w.f(g["juice_left"])
    w.f(game.r_scale)
    w.f(0.06)  # spawn_prob (plunder.cpp:124)
    w.f(2.0)  # legend_r (plunder.cpp:166)
    w.f(g["min_agent_x"])


# starpilot (starpilot.cpp:432-440): the remaining pre-rolled spawners,
# stored back to front (descending spawn_time; the engine pops from the
# back, starpilot.cpp:401-403).  The port keeps the whole list ascending
# and a cursor of the ones released.
def _starpilot_imp(game, s, r):
    g = s["game"]
    _set_entities(g["spawners"], _read_entities(r)[::-1], what="spawners")
    g["spawn_cursor"][...] = 0


def _starpilot_exp(game, s, w):
    g = s["game"]
    cur = int(g["spawn_cursor"])
    count = int(g["spawners"]["count"])
    _write_entity_rows(w, [(g["spawners"], range(count - 1, cur - 1, -1))])


_GAME_TAILS = {
    "maze": (_maze_imp, _maze_exp),
    "miner": (_miner_imp, _miner_exp),
    "bigfish": (_bigfish_imp, _bigfish_exp),
    "bossfight": (_bossfight_imp, _bossfight_exp),
    "caveflyer": (_none_imp, _none_exp),
    "chaser": (_chaser_imp, _chaser_exp),
    "climber": (_climber_imp, _climber_exp),
    "coinrun": (_coinrun_imp, _coinrun_exp),
    "dodgeball": (_dodgeball_imp, _dodgeball_exp),
    "fruitbot": (_fruitbot_imp, _fruitbot_exp),
    "heist": (_heist_imp, _heist_exp),
    "jumper": (_jumper_imp, _jumper_exp),
    "leaper": (_leaper_imp, _leaper_exp),
    "ninja": (_ninja_imp, _ninja_exp),
    "plunder": (_plunder_imp, _plunder_exp),
    "starpilot": (_starpilot_imp, _starpilot_exp),
}
