"""The port's states against the C++ engine's own state bytes.

Each ``tests/data/refstate/<game>_bridge.json`` holds the C++ engine's
serialized state of every env partway through a recorded run
(``bridge_states``, after the action of step ``bridge_step``).  For every
ported game the port runs on the CPU from the recording's seed and mode
through its actions to that step; the C++ bytes are parsed by the JAX
package's ``procgen_tpu.utils.refstate.import_reference_state`` and carried
into the port's ``BasicState`` by ``bridge.state_from_numpy``.  Then every
field the bytes carry must be equal: the live slots of both entity pools,
field by field, the grid, the game's own state, both RNG streams and the
scalars.  The rest are the JAX package's and the port's alone (the cached
frame, the painted canvas, the HUD's total, the step-draw count and the
reset count).  Starpilot's spawner queue is stored in the C++ from its
back, the next one to spawn last; the importer reverses it into slots from
0, and the port keeps its spawned ones before its cursor, so the port's
queue from the cursor is compared.

A one-ulp difference reaches the state long before it changes a reward
or an episode's end, which the oracle recordings check.  This file catches the C++ float expressions that hold a double literal
or call a double function (``v *= .9``, ``pow``, ``cos``), which C++
evaluates in double and rounds once to float.

The JAX package writes these expressions in f32.  The port's tests that
hold it against the JAX package leaf for leaf therefore patch them, in
their JAX child processes only, with ``patch_jax_cpp_arithmetic``: the
agent's velocity decay (``BasicAbstractGame.decay_agent_velocity``),
bigfish's fish radius and speed (``Bigfish.game_step``), starpilot's
spawner headings and velocities (``Starpilot.game_reset``) and plunder's
lane speeds (``Plunder.game_reset``) are evaluated in f64 under
``jax.enable_x64`` and rounded once to f32, each expression replaced by
its text; dodgeball's ball spin (``BALL_V_ROT``) and its dust cloud's
spin and growth take the C++ float constants (``CPP_F32``, products and
quotients of f32 operands); bossfight's bullets take ``bv * cos(theta)``
and ``bv * sin(theta)`` in f64, mode 1's heading and the shield's
reflection angle in f64, modes 0 and 2 their headings' C++ constants and
the shield its height ``1.2 * boss ry`` in f64, and the boss's course and
the barriers' rows pass ``jax.lax.optimization_barrier`` where XLA would
fold a chain of constants or turn a division by 20 into a multiply;
ninja's throwing star stops when a wall blocks it, both velocities zero,
as the C++ ``is_blocked`` makes it (``Ninja._sub_step_rec``, where the
package keeps the unblocked axis moving: the bytes hold stars stopped
flush against walls); heist's key ring takes its radius as the C++
float (``CPP_F32["ring_key_r"]``; the keys' x and y are double
expressions of it); caveflyer's thrust ``vx += p * .2``, the heading's
``accel * cos(theta)`` and ``sin``, the exhaust's ``x - rx * cos(theta)``
and ``y - ry * sin(theta)``, a bullet's ``cos(theta)`` and ``sin(theta)``,
an enemy's speed ``.1 * rand01() + .1`` and heading ``-1 * atan2(vy, vx) -
PI / 2`` are evaluated in f64 (the thrust is what the bytes decide; the
rest follow the C++ reading of its double literals and functions); nothing
else of the package changes.  XLA's f64 ``pow``,
``sin`` and ``cos`` on the CPU are glibc's (``test_patched_f64_is_glibc``).

Tolerance: zero.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from procgen_tpu_torch import ProcgenGym3Env  # noqa: E402
from procgen_tpu_torch.bridge import state_from_numpy  # noqa: E402

GAMES = ["maze", "miner", "coinrun", "fruitbot", "starpilot", "plunder",
         "leaper", "bigfish", "dodgeball", "bossfight", "climber", "ninja",
         "chaser", "heist", "jumper", "caveflyer"]
# the fields the C++ bytes do not carry
NOT_IN_BYTES = {"frame", "bg_canvas", "total_reward", "step_draws",
                "reset_count"}
PI_F = float(np.float32(np.pi))  # the C++ PI, a float


def _in_f64(fn):
    """``fn`` of f32 arrays evaluated in f64 (its Python float constants
    doubles), its result rounded once to f32: a C++ float expression with a
    double literal or a double function."""
    def wrapped(*args):
        with jax.enable_x64(True):
            out = fn(*[jnp.asarray(a).astype(jnp.float64) for a in args])
            return out.astype(jnp.float32)
    return wrapped


CPP_F64 = {
    "decay": _in_f64(lambda v: v * 0.9),  # basic-abstract-game.cpp:690-693
    "radius": _in_f64(lambda r: 1.75 * jnp.power(r, 1.4) + 0.25),  # bigfish.cpp:85
    "speed": _in_f64(lambda v: 0.15 + v * 0.25),  # bigfish.cpp:89
    "theta": _in_f64(lambda u: (u - 0.5) * (PI_F / 2)),  # starpilot spawners
    "cos": _in_f64(lambda t, v: jnp.cos(t) * v),
    "sin": _in_f64(lambda t, v: jnp.sin(t) * v),
    "lane_vel": _in_f64(lambda v: 0.15 + 0.1 * v),  # plunder's lanes
    # bossfight: mode 1's turning cross, the shield's reflection, the
    # shield's height
    "bf_turn": _in_f64(lambda k, c: PI_F * (1.25 + 0.5 * k / 8.0) + c),
    "bf_reflect": _in_f64(lambda r: PI_F * (1.25 + 0.5 * r)),
    "shield_ry": _in_f64(lambda r: 1.2 * r),
    # caveflyer: the thrust, the exhaust's place, the enemies' speed and
    # headings
    "fifth": _in_f64(lambda v, p: v + p * 0.2),
    "sub_cos": _in_f64(lambda x, r, t: x - r * jnp.cos(t)),
    "sub_sin": _in_f64(lambda y, r, t: y - r * jnp.sin(t)),
    "cf_vel": _in_f64(lambda v: 0.1 * v + 0.1),
    "heading": _in_f64(lambda y, x: -1 * jnp.arctan2(y, x) - PI_F / 2),
}

# (module, class, method): [(the JAX package's text, its replacement)]
_PATCHES = {
    ("procgen_tpu.games.bigfish", "Bigfish", "game_step"): [
        ("ent_r = (FISH_MAX_R - FISH_MIN_R) * jnp.power(r01, f32(1.4)) + FISH_MIN_R",
         "ent_r = CPP_F64['radius'](r01)"),
        ("ent_vx = (0.15 + v01 * 0.25) * jnp.where(",
         "ent_vx = CPP_F64['speed'](v01) * jnp.where("),
    ],
    ("procgen_tpu.games.starpilot", "Starpilot", "game_reset"): [
        ("theta = (th01 - 0.5) * (2 * PI / 4)", "theta = CPP_F64['theta'](th01)"),
        ("vx = -jnp.cos(theta) * v_scale", "vx = -CPP_F64['cos'](theta, v_scale)"),
        ("vy = jnp.sin(theta) * v_scale", "vy = CPP_F64['sin'](theta, v_scale)"),
    ],
    ("procgen_tpu.games.plunder", "Plunder", "game_reset"): [
        ("lane_vels.at[i].set(0.15 + 0.1 * v01)",
         "lane_vels.at[i].set(CPP_F64['lane_vel'](v01))"),
    ],
    ("procgen_tpu.games.dodgeball", "Dodgeball", "dispatch_entity_pairs"): [
        ('f["vrot"] = PI / 0.3', 'f["vrot"] = CPP_F32["dust_vrot"]'),
        ('f["grow_rate"] = 1.0 / 1.2', 'f["grow_rate"] = CPP_F32["dust_grow"]'),
    ],
    ("procgen_tpu.games.bossfight", "Bossfight", "game_step"): [
        ("bx0, by0, bv * jnp.cos(theta), bv * jnp.sin(theta), do_r, do_r,",
         "bx0, by0, CPP_F64['cos'](theta, bv), CPP_F64['sin'](theta, bv), do_r, do_r,"),
        ("recs.append(bullet_rec(PI * 1.5 + (i - 2) * PI / 8))",
         "recs.append(bullet_rec(CPP_F32['bf_fan'][i]))"),
        ("recs.append(bullet_rec(PI * (1.25 + 0.5 * k.astype(f32) / 8.0) + i * PI / 2))",
         "recs.append(bullet_rec(CPP_F64['bf_turn'](k, CPP_F32['bf_turn'][i])))"),
        ("recs.append(bullet_rec(2 * PI / 8 * i + g.rand_pct * 2 * PI))",
         "recs.append(bullet_rec(CPP_F32['bf_ring'][i] + g.rand_pct * 2 * PI))"),
        # the boss's course: XLA folds ``+ BOSS_R + BOTTOM_MARGIN`` into one
        # constant and divides by 20 as a multiply by f32(1 / 20)
        ("dest_y = rpy * (20.0 - 2 * BOSS_R - BOTTOM_MARGIN) + BOSS_R + BOTTOM_MARGIN",
         "dest_y = _OB(rpy * (20.0 - 2 * BOSS_R - BOTTOM_MARGIN) + BOSS_R) + BOTTOM_MARGIN"),
        ("nvx = (dest_x - e.x[BOSS_SLOT]) / BOSS_VEL_TIMEOUT",
         "nvx = (dest_x - e.x[BOSS_SLOT]) / _OB(f32(BOSS_VEL_TIMEOUT))"),
        ("nvy = (dest_y - e.y[BOSS_SLOT]) / BOSS_VEL_TIMEOUT",
         "nvy = (dest_y - e.y[BOSS_SLOT]) / _OB(f32(BOSS_VEL_TIMEOUT))"),
    ],
    ("procgen_tpu.games.bossfight", "Bossfight", "dispatch_entity_pairs"): [
        ("theta = PI * (1.25 + 0.5 * g.rand_pct)", "theta = CPP_F64['bf_reflect'](g.rand_pct)"),
        ("PLAYER_BULLET_VEL * jnp.sin(theta) * 0.5", "CPP_F64['sin'](theta, 0.5)"),
        ("PLAYER_BULLET_VEL * jnp.cos(theta) * 0.5", "CPP_F64['cos'](theta, 0.5)"),
    ],
    ("procgen_tpu.games.heist", "Heist", "game_reset"): [
        # the key ring's radius is a C++ float (heist.cpp:188-199)
        ("ring_key_r = 0.03", "ring_key_r = CPP_F32['ring_key_r']"),
    ],
    ("procgen_tpu.games.caveflyer", "Caveflyer", "update_agent_velocity"): [
        ("vx = e.vx[0] + s.mixrate * s.maxspeed * s.action_vx * 0.2",
         "vx = CPP_F64['fifth'](e.vx[0], s.mixrate * s.maxspeed * s.action_vx)"),
        ("vy = e.vy[0] + s.mixrate * s.maxspeed * s.action_vy * 0.2",
         "vy = CPP_F64['fifth'](e.vy[0], s.mixrate * s.maxspeed * s.action_vy)"),
    ],
    ("procgen_tpu.games.caveflyer", "Caveflyer", "set_action_xy"): [
        ("e.x[0] - e.rx[0] * jnp.cos(theta),", "CPP_F64['sub_cos'](e.x[0], e.rx[0], theta),"),
        ("e.y[0] - e.ry[0] * jnp.sin(theta),", "CPP_F64['sub_sin'](e.y[0], e.ry[0], theta),"),
        ("action_vy=accel * jnp.sin(theta),", "action_vy=CPP_F64['sin'](theta, accel),"),
        ("action_vx=accel * jnp.cos(theta),", "action_vx=CPP_F64['cos'](theta, accel),"),
    ],
    ("procgen_tpu.games.caveflyer", "Caveflyer", "game_reset"): [
        ("vel0 = 0.1 * v01 + 0.1", "vel0 = CPP_F64['cf_vel'](v01)"),
    ],
    ("procgen_tpu.games.caveflyer", "Caveflyer", "game_step"): [
        ("e.x[0], e.y[0], jnp.cos(theta), jnp.sin(theta), 0.1, 0.25,",
         "e.x[0], e.y[0], CPP_F64['cos'](theta, 1.0), CPP_F64['sin'](theta, 1.0), 0.1, 0.25,"),
        ("-jnp.arctan2(e.vy, e.vx) + (-PI / 2),", "CPP_F64['heading'](e.vy, e.vx),"),
    ],
    ("procgen_tpu.games.bossfight", "Bossfight", "game_reset"): [
        ("1.2 * BOSS_R, 1.2 * BOSS_R / boss_ar, SHIELDS",
         "1.2 * BOSS_R, CPP_F64['shield_ry'](BOSS_R / boss_ar), SHIELDS"),
        # the barriers' rows, which XLA would fold into other constants
        ("min_y = 2 * e.ry[0] + barrier_r + 0.5",
         "min_y = _OB(2 * e.ry[0] + barrier_r) + 0.5"),
        ("ent_y = y01 * (BOTTOM_MARGIN - min_y - barrier_r) + min_y",
         "ent_y = y01 * (_OB(BOTTOM_MARGIN - min_y) - barrier_r) + min_y"),
    ],
}

# C++ float constants of f32 operands, each rounded once from f32: the
# JAX package takes them from Python doubles.  Dodgeball's ball spin
# ``PI * .23`` is an ulp off that way; the dust cloud's spin and growth
# give the same bits either way.
_F = np.float32
CPP_F32 = {
    "ball_vrot": float(_F(PI_F) * _F(0.23)),
    "dust_vrot": float(_F(PI_F) / _F(0.3)),
    "dust_grow": float(_F(1.0) / _F(1.2)),
    # bossfight's headings: mode 0's PI * 1.5 + (i - 2) * PI / 8 (a double
    # sum of a float term), mode 1's i * PI / 2 and mode 2's 2 * PI / 8 * i
    # (floats)
    "bf_fan": [float(_F(PI_F * 1.5 + float(_F(_F(i - 2) * _F(PI_F)) / _F(8))))
               for i in range(5)],
    "bf_turn": [float(_F(_F(i) * _F(PI_F)) / _F(2)) for i in range(4)],
    "bf_ring": [float(_F(_F(_F(2) * _F(PI_F)) / _F(8)) * _F(i)) for i in range(8)],
    # heist's key ring: its radius a float, the keys' x and y double
    # expressions of it
    "ring_key_r": float(_F(0.03)),
}


def _patched_methods():
    """{(class, method name): the method with its ``_PATCHES`` edits},
    each edit's text found exactly once, nothing installed."""
    import importlib
    import inspect
    import textwrap

    out = {}
    for (mod_name, cls_name, meth), edits in _PATCHES.items():
        mod = importlib.import_module(mod_name)
        cls = getattr(mod, cls_name)
        src = textwrap.dedent(inspect.getsource(getattr(cls, meth)))
        for old, new in edits:
            assert src.count(old) == 1, (cls_name, meth, old)
            src = src.replace(old, new)
        ns = dict(vars(mod), CPP_F64=CPP_F64, CPP_F32=CPP_F32,
                  _OB=jax.lax.optimization_barrier)
        exec(compile(src, inspect.getsourcefile(cls), "exec"), ns)
        out[cls, meth] = ns[meth]
    return out


def _decay_agent_velocity(self, s):
    e = s.ents
    return s.replace(ents=e.set_fields(
        0, vx=CPP_F64["decay"](e.vx[0]), vy=CPP_F64["decay"](e.vy[0])))


def _ninja_sub_step_rec(self, s, rec, vx, vy, depth, is_agent):
    """Ninja's micro-move as the C++ runs it: a throwing star that a wall
    blocks stops, both velocities zeroed inside ``is_blocked``
    (ninja.cpp:139-152), after the move has snapped it to the wall."""
    from procgen_tpu.core.game import BasicAbstractGame
    from procgen_tpu.games.ninja import THROWING_STAR

    s, rec, blocked = BasicAbstractGame._sub_step_rec(self, s, rec, vx, vy, depth,
                                                      is_agent)
    stop = blocked & (rec["type"] == THROWING_STAR)
    rec = dict(rec, vx=jnp.where(stop, 0.0, rec["vx"]),
               vy=jnp.where(stop, 0.0, rec["vy"]))
    return s, rec, blocked


def patch_jax_cpp_arithmetic():
    """Hold the JAX package, in this process, to the C++ arithmetic of the
    expressions in ``CPP_F64`` (the module docstring) and to the C++'s
    stop of a blocked throwing star in ninja.  Call it in a JAX child
    process before anything is traced, never in the test process: the
    other test files hold the package as it is."""
    import procgen_tpu.games.dodgeball as jdodgeball
    import procgen_tpu.games.ninja as jninja
    from procgen_tpu.core.game import BasicAbstractGame

    BasicAbstractGame.decay_agent_velocity = _decay_agent_velocity
    jninja.Ninja._sub_step_rec = _ninja_sub_step_rec
    jdodgeball.BALL_V_ROT = CPP_F32["ball_vrot"]
    for (cls, meth), fn in _patched_methods().items():
        setattr(cls, meth, fn)


def _record(game):
    with open(os.path.join(HERE, "data", "refstate", f"{game}_bridge.json")) as f:
        return json.load(f)


def _cpp_states(game, rec, port_game):
    """The recording's C++ states, parsed by the JAX package and carried
    into the port's BasicState (both envs in one batch)."""
    from procgen_tpu.core import lifecycle
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game
    from procgen_tpu.utils.refstate import import_reference_state

    jax.config.update("jax_platforms", "cpu")
    modes = {"easy": 0, "hard": 1, "extreme": 2, "memory": 10}
    jg = make_game(game, JGameOptions(distribution_mode=modes[rec["distribution_mode"]]))
    template = lifecycle.initial_state(jg, jnp.uint32(0))
    states = [import_reference_state(jg, template, bytes.fromhex(h))
              for h in rec["bridge_states"]]
    batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
    tree = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(batched))
    return state_from_numpy(tree, port_game, "cpu")


def _port_state(game, rec):
    """The port's env after the recording's actions through
    ``bridge_step``, on the CPU."""
    actions = np.asarray(rec["actions"], np.int32)
    env = ProcgenGym3Env(num=actions.shape[1], env_name=game,
                         rand_seed=rec["rand_seed"],
                         num_levels=rec["num_levels"],
                         start_level=rec["start_level"],
                         distribution_mode=rec["distribution_mode"], device="cpu")
    for t in range(rec["bridge_step"] + 1):
        env.act(actions[t])
    return env._vec.game, env._vec.states


def _pool_diffs(tag, got, want):
    """(field, env, slot, got, want) of every live slot that differs."""
    out = []
    gc, wc = got.count.tolist(), want.count.tolist()
    for env, (a, b) in enumerate(zip(gc, wc)):
        if a != b:
            out.append((f"{tag}.count", env, None, a, b))
    from procgen_tpu_torch.core.entities import SLOT_FIELDS

    for k in SLOT_FIELDS:
        g, w = getattr(got, k), getattr(want, k)
        for env, c in enumerate(wc):
            if gc[env] != c:
                continue
            for slot in torch.nonzero(g[env, :c] != w[env, :c]).flatten().tolist():
                out.append((f"{tag}.{k}", env, slot, g[env, slot].item(),
                            w[env, slot].item()))
    return out


def _leaf_diffs(tag, got, want):
    """(field, env, None, got, want) of every per-env leaf that differs."""
    import dataclasses

    out = []
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            out += _leaf_diffs(f"{tag}.{f.name}", getattr(got, f.name),
                               getattr(want, f.name))
        return out
    if want is None:
        return out
    for env in range(want.shape[0]):
        if not torch.equal(got[env], want[env]):
            out.append((tag, env, None, got[env].tolist(), want[env].tolist()))
    return out


def _spawner_queue(q, cursor):
    """Starpilot's spawners from each env's cursor, moved to slot 0 (the
    rest zero), as the importer lays out the C++ queue."""
    from procgen_tpu_torch.core.entities import SLOT_FIELDS

    cap = q.cap
    slots = torch.arange(cap)[None, :]
    src = (slots + cursor[:, None]).clamp_max(cap - 1)
    live = slots < (q.count - cursor)[:, None]
    upd = {k: torch.where(live, getattr(q, k).gather(1, src),
                          torch.zeros((), dtype=getattr(q, k).dtype))
           for k in SLOT_FIELDS}
    return q.replace(count=q.count - cursor, **upd)


def _diffs(game, got, want):
    import dataclasses

    out = _pool_diffs("ents", got.ents, want.ents)
    if want.decor is not None:
        out += _pool_diffs("decor", got.decor, want.decor)
    for f in dataclasses.fields(want):
        if f.name in NOT_IN_BYTES | {"ents", "decor", "game"}:
            continue
        out += _leaf_diffs(f.name, getattr(got, f.name), getattr(want, f.name))
    g, w = got.game, want.game
    if game == "starpilot":
        out += _pool_diffs("game.spawners",
                           _spawner_queue(g.spawners, g.spawn_cursor), w.spawners)
        assert (w.spawn_cursor == 0).all()
        g = g.replace(spawners=w.spawners, spawn_cursor=w.spawn_cursor)
    out += _leaf_diffs("game", g, w)
    return out


@pytest.mark.parametrize("game", GAMES)
def test_state_equals_cpp_bytes(game):
    """Every field the C++ bytes carry, at ``bridge_step``, equal."""
    rec = _record(game)
    port_game, got = _port_state(game, rec)
    want = _cpp_states(game, rec, port_game)
    assert int(want.cur_time.max()) > 0 and int(want.ents.count.min()) >= 1
    diffs = _diffs(game, got, want)
    assert not diffs, "\n".join(map(str, diffs[:40]))


def test_cpp_double_arithmetic():
    """The port's forms of the C++ expressions with a double literal or a
    double function on a few values, against numpy's f64 and glibc's
    ``pow``, ``sin`` and ``cos`` (ctypes): one double evaluation, one
    rounding to f32, on values where the f32 form differs."""
    import ctypes

    from procgen_tpu_torch.core.game import f64_mul
    from procgen_tpu_torch.core.libm import sincos_times
    from procgen_tpu_torch.games.bigfish import fish_radius, fish_speed

    libm = ctypes.CDLL("libm.so.6")
    for fn in ("pow", "sin", "cos"):
        getattr(libm, fn).restype = ctypes.c_double
    libm.pow.argtypes = [ctypes.c_double, ctypes.c_double]
    libm.sin.argtypes = libm.cos.argtypes = [ctypes.c_double]
    f32 = np.float32
    v = np.random.RandomState(0).uniform(-0.6, 0.6, 4096).astype(f32)
    want = (v.astype(np.float64) * 0.9).astype(f32)
    np.testing.assert_array_equal(f64_mul(torch.from_numpy(v), 0.9).numpy(), want)
    assert (want != v * f32(0.9)).any()

    r = (np.random.RandomState(1).randint(0, 2**32, 4096, dtype=np.uint64)
         .astype(f32) * f32(2.0**-32))
    rad = np.array([f32(1.75 * libm.pow(float(x), 1.4) + 0.25) for x in r])
    np.testing.assert_array_equal(fish_radius(torch.from_numpy(r)).numpy(), rad)
    assert (rad != f32(1.75) * np.power(r, f32(1.4)) + f32(0.25)).any()
    np.testing.assert_array_equal(fish_speed(torch.from_numpy(r)).numpy(),
                                  (0.15 + r.astype(np.float64) * 0.25).astype(f32))

    theta = ((r.astype(np.float64) - 0.5) * (float(f32(np.pi)) / 2)).astype(f32)
    vs = np.full_like(theta, f32(f32(0.75) * f32(0.4)))
    s, c = sincos_times(torch.from_numpy(theta), torch.from_numpy(vs))
    np.testing.assert_array_equal(
        s.numpy(), [f32(libm.sin(float(t)) * float(u)) for t, u in zip(theta, vs)])
    np.testing.assert_array_equal(
        c.numpy(), [f32(libm.cos(float(t)) * float(u)) for t, u in zip(theta, vs)])


def test_patched_f64_is_glibc():
    """The patch's pieces: every edit finds its text once and compiles;
    XLA's f64 ``pow``, ``sin`` and ``cos`` (under ``jax.enable_x64``) are
    glibc's on 20,000 values each; the patched decay, radius, heading and
    velocity equal the port's on 4,096."""
    import ctypes

    from procgen_tpu_torch.core.game import f64_mul
    from procgen_tpu_torch.core.libm import sincos_times
    from procgen_tpu_torch.games.bigfish import fish_radius, fish_speed

    assert len(_patched_methods()) == len(_PATCHES)
    libm = ctypes.CDLL("libm.so.6")
    for fn in ("pow", "sin", "cos"):
        getattr(libm, fn).restype = ctypes.c_double
    libm.pow.argtypes = [ctypes.c_double, ctypes.c_double]
    libm.sin.argtypes = libm.cos.argtypes = [ctypes.c_double]
    f32 = np.float32
    r = (np.random.RandomState(2).randint(0, 2**32, 20000, dtype=np.uint64)
         .astype(f32) * f32(2.0**-32))
    t = (r - f32(0.5)) * f32(1.6)
    with jax.enable_x64(True):
        p = np.asarray(jnp.power(jnp.asarray(r, jnp.float64), 1.4))
        c = np.asarray(jnp.cos(jnp.asarray(t, jnp.float64)))
        sn = np.asarray(jnp.sin(jnp.asarray(t, jnp.float64)))
    np.testing.assert_array_equal(p, [libm.pow(float(x), 1.4) for x in r])
    np.testing.assert_array_equal(c, [libm.cos(float(x)) for x in t])
    np.testing.assert_array_equal(sn, [libm.sin(float(x)) for x in t])

    r, t = r[:4096], t[:4096]
    vs = np.full_like(t, f32(f32(1.5) * f32(0.4)))
    tr, tt, tv = (torch.from_numpy(a) for a in (r, t, vs))
    sin_v, cos_v = sincos_times(tt, tv)
    for name, args, want in (
        ("decay", (t,), f64_mul(tt, 0.9)), ("radius", (r,), fish_radius(tr)),
        ("speed", (r,), fish_speed(tr)), ("cos", (t, vs), cos_v),
        ("sin", (t, vs), sin_v),
    ):
        got = np.asarray(jax.jit(CPP_F64[name])(*args))
        np.testing.assert_array_equal(got, want.numpy(), err_msg=name)
