"""The port's bossfight against the JAX package's and the C++ recordings.

* Easy and hard, 3 envs, 40 random steps each, an episode's end resetting
  its env at once (both packages' ``env_step``, then ``env_reset`` where
  an env is done): every ``BasicState`` leaf (``BossfightState``, both
  pools and ``rand_gen`` included), bit-equal.  The seeds give shots,
  boss volleys, laser trails and a forced reset.
* A set-up step over the states of every step of each run, at the clock
  ``t = 120`` where every attack mode fires, in four kinds of env: two
  player bullets over the boss with its shields down and one hit left in
  the round (the higher slot's hit crosses the round, raises the shields
  and blocks the other); a player bullet over the raised shield (it
  reflects at the last step's ``rand_pct``, before the boss-hit scan);
  the damaged hull (its explosions); the passive shot.  Every env also
  holds a barrier with an enemy bullet on it and a spinning enemy bullet
  in the open.  Stepped once: every leaf.
* The frames of every eighth step's states and of a quarter of the
  set-up step's states (the static prefix and both pools at caps
  72 + 160: rotated bullets from the rotation banks, laser trails, the
  shield shown or hidden): ``render_kernel.render_obs_batch`` (on CPU
  tensors, the plain version of the sprite-suffix kernel over the cached
  prefix) against the Pallas kernel run in interpret mode and against the
  XLA ``render_obs``; the port's ``renderer.render_obs`` against the XLA
  one; ``prep_suffix`` against the Pallas kernel's ``_prep_one``.
* Generated assets: 3 envs reset and stepped 4 times, every leaf, and
  the frames of both states against Pallas and XLA.
* The order rules on their own: the crossing's bookkeeping, the
  reflected bullet's velocity.
* The bullets' ``bv * cos(theta)``: the port's double cosine against
  glibc's (ctypes) at every heading of modes 0 and 1 and at 4,096 random
  ones.
* bossfight_easy and bossfight_hard replay exactly.

The JAX reference runs in one child process (this file run as a script)
for both modes, while the port runs its own and replays the recordings;
its XLA is held to AVX (``--xla_cpu_max_isa=AVX``): XLA's CPU backend
otherwise contracts ``a * b + c`` into a fused multiply-add, which
neither the C++ reference nor the port does.  The child also holds the
JAX package to the C++ arithmetic (``test_torch_refstate.
patch_jax_cpp_arithmetic``: the bullets' velocities, the headings of
modes 0-2, the shield's reflection and height), in the child only.

Tolerance: zero.
"""

import contextlib
import copy
import ctypes
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from procgen_tpu_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from procgen_tpu_torch.conformance import replay  # noqa: E402
from procgen_tpu_torch.core import libm  # noqa: E402
from procgen_tpu_torch.core import lifecycle as tlife  # noqa: E402
from procgen_tpu_torch.core.constants import EXPLOSION, INT32_MAX, fnv1a_32  # noqa: E402
from procgen_tpu_torch.core.entities import default_fields  # noqa: E402
from procgen_tpu_torch.core.game import tree_map, tree_where  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.games.bossfight import (  # noqa: E402
    BARRIER, BOSS_SLOT, ENEMY_BULLET, FAN_THETA, LASER_TRAIL, PI_F, PLAYER_BULLET,
    REFLECTED_BULLET, SHIELD_SLOT, TURN_THETA, Bossfight, BossfightState,
)
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402
from procgen_tpu_torch.utils.host_mt import HostMT19937  # noqa: E402

N = 3
STEPS = 40
# run -> (distribution mode, master seed, action seed)
RUNS = {"easy": (0, 11, 0), "hard": (1, 12, 1)}
GEN_STEPS = 4  # the generated-assets run (easy)
SEP = "::"
FORCED = 20  # env 1 is forced to reset at this step

# the set-up step: the clock before it (t = 120 fires every mode and the
# damaged hull's explosions), the boss, the two bullets over it
SETUP_TIME = 119
BOSS_AT = (10.0, 14.0)
CROSS_X = (9.5, 10.5)


def _seeds(master_seed):
    m = HostMT19937(master_seed)
    return np.array([m.next_u32() for _ in range(N)], np.int64)


def _actions(action_seed, steps=STEPS):
    """[steps, N] actions, half of them a shot (9) or a move; env 1 is
    forced to reset at step ``FORCED``."""
    rng = np.random.RandomState(action_seed)
    out = []
    for t in range(steps):
        a = np.where(rng.rand(N) < 0.5, rng.choice([9, 9, 1, 3, 5, 7], N),
                     rng.randint(0, 15, N)).astype(np.int32)
        if t == FORCED:
            a[1] = -1
        out.append(a)
    return np.stack(out)


def _setup_actions(n):
    return np.random.RandomState(11).choice([4, 9, 3, 5], n).astype(np.int32)


def _frame_steps():
    return np.arange(0, STEPS + 1, 8)


def _asset_seed():
    return int(np.int32(np.uint32(fnv1a_32("bossfight"))))


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        elif v is not None:
            out[pre + k] = np.asarray(v)
    return out


def _setup(tree):
    """The set-up step's input: a state dict (numpy leaves, ``[B, ...]``)
    at the clock ``SETUP_TIME``, the agent in the bottom-left corner, the
    boss and its shield at ``BOSS_AT`` and, by env ``b % 4``: 0, the
    shields down, the boss one hit from the round's end (health 3 of
    rounds of 2) under two player bullets (slots 3 and 4); 1, the shields
    up under one player bullet (slot 3); 2, the shields down and the hull
    damaged; 3, the shields down (the passive shot).  Then a barrier
    (slot 5) with an enemy bullet on it (slot 6) and a spinning enemy
    bullet in the open (slot 7).  The attack mode is ``b // 4 % 4``; half
    the envs reach the boss's course timeout, a quarter swap the shields.
    The decor pool is emptied."""
    t = copy.deepcopy(tree)
    e, dec, g = t["ents"], t["decor"], t["game"]
    B = e["x"].shape[0]
    b = np.arange(B)
    kind = b % 4

    def pb(x, y):
        return dict(default_fields(x, y, 0.0, 1.0, 0.25, 0.25, PLAYER_BULLET),
                    collides_with_entities=True, expire_time=25)

    def eb(x, y, vx, vy, rot):
        return dict(default_fields(x, y, vx, vy, 0.5, 0.5, ENEMY_BULLET),
                    expire_time=50, vrot=math.pi / 8, rotation=rot, image_theme=1)

    recs = [
        [pb(CROSS_X[0], BOSS_AT[1] - 1), pb(10.0, 11.0), pb(16.0, 3.0), pb(16.0, 3.0)],
        [pb(CROSS_X[1], BOSS_AT[1] - 1), pb(17.0, 3.0), pb(17.0, 3.0), pb(17.0, 3.0)],
        [dict(default_fields(4.0, 5.0, 0.0, 0.0, 0.6, 0.6, BARRIER), health=3.0,
              collides_with_entities=True, image_theme=2)] * 4,
        [eb(4.2, 5.0, 0.0, 0.0, 0.0)] * 4,
        [eb(15.0, 8.0, 0.1, -0.2, 0.3)] * 4,
    ]
    e["x"][:, 0], e["y"][:, 0] = 2.5, 1.5
    e["vx"][:, 0] = e["vy"][:, 0] = 0.0
    for slot in (BOSS_SLOT, SHIELD_SLOT):
        e["x"][:, slot], e["y"][:, slot] = BOSS_AT
        e["vx"][:, slot] = e["vy"][:, slot] = 0.0
    e["health"][:, BOSS_SLOT] = np.where(kind == 0, 3.0, e["health"][:, BOSS_SLOT])
    e["count"][:] = 3
    for by_kind in recs:
        for k, v in by_kind[0].items():
            vals = np.array([by_kind[kk][k] for kk in kind])
            e[k][b, e["count"]] = vals.astype(e[k].dtype)
        e["count"] += 1
    dec["count"][:] = 0
    t["cur_time"][:] = SETUP_TIME
    g["round_health"][:] = np.where(kind == 0, 2, g["round_health"])
    g["num_rounds"][:] = np.where(kind == 0, 2, g["num_rounds"])
    g["round_num"][:] = 0
    g["shields_are_up"][:] = kind == 1
    g["damaged_until_time"][:] = np.where(kind == 2, SETUP_TIME + 10, 0)
    g["attack_mode"][:] = b // 4 % 4
    g["curr_vel_timeout"][:] = np.where(b % 2 == 0, 0, 5)
    g["time_to_swap"][:] = np.where(b % 8 < 2, 0, 3)
    g["last_fire_time"][:] = -100
    return t


# ---------------------------------------------------------------------------
# the JAX reference (child process)
# ---------------------------------------------------------------------------


def _jax_game(mode, generated=False):
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game

    game = make_game("bossfight", JGameOptions(distribution_mode=mode,
                                               use_generated_assets=generated))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    if generated:
        game.fixed_asset_seed = _asset_seed()
    return game


def _to_tree(state):
    return jax.tree_util.tree_map(np.array, serialization.to_state_dict(state))


def _jax_reference(out_path):
    """Run both modes, step the set-up states once and render the states
    of ``_frame_steps`` and a quarter of the set-up step's; then the
    generated-assets run.  Saves the arrays, keyed ``run::part::leaf``."""
    from procgen_tpu.core import lifecycle
    from procgen_tpu.parallel.vec import _tree_select
    from procgen_tpu.render import atlas, pallas_kernel
    from procgen_tpu.render.renderer import render_obs

    jax.config.update("jax_platforms", "cpu")
    out = {}

    def frames(run, game, batch, with_prep):
        out[SEP.join((run, "pallas"))] = np.asarray(jax.jit(
            lambda st: pallas_kernel.render_obs_batch(game, st, 64, interpret=True)
        )(batch))
        out[SEP.join((run, "xla"))] = np.asarray(
            jax.jit(jax.vmap(lambda st: render_obs(game, st, 64)))(batch))
        if with_prep:
            plan = pallas_kernel.get_plan(game, 64)
            prep = jax.jit(jax.vmap(lambda st: pallas_kernel._prep_one(plan, st)))(batch)
            for k in ("si", "ent_f", "ent_i", "dec_f", "dec_i"):
                out[SEP.join((run, "prep", k))] = np.asarray(prep[k])

    def save_states(run, states):
        trees = [_flat(serialization.to_state_dict(st)) for st in states]
        for leaf in trees[0]:
            out[SEP.join((run, "states", leaf))] = np.stack([t[leaf] for t in trees])

    for run, (mode, mseed, aseed) in RUNS.items():
        game = _jax_game(mode)
        init = jax.jit(jax.vmap(lambda sd: lifecycle.initial_state(game, sd)))
        reset = jax.jit(jax.vmap(lambda s: lifecycle.env_reset(game, s)))
        step = jax.jit(jax.vmap(lambda s, a: lifecycle.env_step(game, s, a)))
        s = reset(init(jnp.asarray(_seeds(mseed), jnp.uint32)))
        states = [s]
        for a in _actions(aseed):
            s, done = step(s, jnp.asarray(a))
            s = _tree_select(done, reset(s), s)
            states.append(s)
        save_states(run, states)

        everything = jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs), *states)
        tree = _setup(_to_tree(everything))
        B = len(states) * N
        template = jax.eval_shape(
            jax.vmap(lambda sd: lifecycle.initial_state(game, sd)),
            jax.ShapeDtypeStruct((B,), jnp.uint32))
        setup = serialization.from_state_dict(template, tree)
        stepped, _ = step(setup, jnp.asarray(_setup_actions(B)))
        for leaf, v in _flat(serialization.to_state_dict(stepped)).items():
            out[SEP.join((run, "setup", leaf))] = v
        batch = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs), *[states[t] for t in _frame_steps()],
            jax.tree_util.tree_map(lambda x: x[::4], stepped))
        frames(run, game, batch, True)

    # generated assets (the atlas cache keys leave the option out)
    atlas._CACHE.clear()
    pallas_kernel._PLANS.clear()
    game = _jax_game(0, generated=True)
    s = jax.jit(jax.vmap(lambda s: lifecycle.env_reset(game, s)))(
        jax.jit(jax.vmap(lambda sd: lifecycle.initial_state(game, sd)))(
            jnp.asarray(_seeds(13), jnp.uint32)))
    step = jax.jit(jax.vmap(lambda s, a: lifecycle.env_step(game, s, a)))
    states = [s]
    for a in _actions(2, GEN_STEPS):
        s, _ = step(s, jnp.asarray(a))
        states.append(s)
    save_states("genassets", states)
    frames("genassets", game, jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs), states[0], states[-1]), False)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_child(tmp_path_factory):
    """Start the JAX reference in one child process; yields (output path,
    process, stderr path)."""
    out_dir = tmp_path_factory.mktemp("bossfight")
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"{flags} --xla_cpu_max_isa=AVX".strip(),
        JAX_COMPILATION_CACHE_DIR=jax.config.jax_compilation_cache_dir or "",
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="1",
    )
    path, log = out_dir / "ref.npz", out_dir / "ref.log"
    with open(log, "w") as err:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(path)],
                                env=env, stdout=subprocess.DEVNULL, stderr=err)
    yield path, proc, log
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def ref(jax_child, port, replays):
    """The JAX reference's arrays (waited for after the port's runs and
    replays)."""
    path, proc, log = jax_child
    assert proc.wait(timeout=1800) == 0, log.read_text()[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def _torch_game(mode, generated=False):
    game = Bossfight(GameOptions(distribution_mode=mode, use_generated_assets=generated))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    if generated:
        game.fixed_asset_seed = _asset_seed()
    return game


@contextlib.contextmanager
def _one_thread():
    """The port's ops are small, and the JAX child holds other cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _cat(states):
    return tree_map(lambda *xs: torch.cat(xs), *states)


def _setup_state(game, states):
    return state_from_numpy(_setup(state_to_numpy(states)), game, "cpu")


@pytest.fixture(scope="module")
def port(jax_child):
    """Per run: the port's states of every step, the set-up step's input
    and output, and the frames of the rendered states on both of the
    port's render paths with ``prep_suffix``; then the generated-assets
    run's states and frames.  Computed while the JAX reference runs."""
    out = {}
    with _one_thread():
        for run, (mode, mseed, aseed) in RUNS.items():
            game = _torch_game(mode)
            s = tlife.env_reset(game, tlife.initial_state(game, torch.as_tensor(_seeds(mseed))))
            states = [s]
            for a in _actions(aseed):
                s, done = tlife.env_step(game, s, torch.as_tensor(a))
                s = tree_where(done, tlife.env_reset(game, s), s)
                states.append(s)
            setup = _setup_state(game, _cat(states))
            stepped, _ = tlife.env_step(game, setup, torch.as_tensor(_setup_actions(setup.num)))
            batch = _cat([states[t] for t in _frame_steps()]
                         + [tree_map(lambda x: x[::4], stepped)])
            frames = (batch, rk.render_obs_batch(game, batch).numpy(),
                      trender_obs(game, batch, 64).numpy(),
                      rk.prep_suffix(rk.get_plan(game), batch))
            out[run] = (states, (setup, stepped), frames)

        game = _torch_game(0, generated=True)
        s = tlife.env_reset(game, tlife.initial_state(game, torch.as_tensor(_seeds(13))))
        states = [s]
        for a in _actions(2, GEN_STEPS):
            s, _ = tlife.env_step(game, s, torch.as_tensor(a))
            states.append(s)
        batch = _cat([states[0], states[-1]])
        out["genassets"] = (states, None, (batch, rk.render_obs_batch(game, batch).numpy(),
                                           trender_obs(game, batch, 64).numpy(), None))
    return out


REPLAYS = ("bossfight_easy", "bossfight_hard")


@pytest.fixture(scope="module")
def replays(jax_child):
    """Each recording and the port's replay of it on the CPU, computed
    while the JAX reference runs."""
    out = {}
    with _one_thread():
        for name in REPLAYS:
            with open(os.path.join(HERE, "data", "conformance", f"{name}.json")) as f:
                rec = json.load(f)
            out[name] = (rec, replay(rec, device="cpu"))
    return out


def _leaves(ref, prefix):
    return {k[len(prefix) + len(SEP):]: v for k, v in ref.items()
            if k.startswith(prefix + SEP)}


@pytest.mark.parametrize("run", list(RUNS) + ["genassets"])
def test_states_match(run, ref, port):
    states = port[run][0]
    want = _leaves(ref, SEP.join((run, "states")))
    got = [_flat(state_to_numpy(t)) for t in states]
    assert set(want) == set(got[0]), set(want) ^ set(got[0])
    for leaf, w in want.items():
        g = np.stack([t[leaf] for t in got])
        assert g.dtype == w.dtype, (run, leaf, g.dtype, w.dtype)
        for t in range(len(got)):
            np.testing.assert_array_equal(g[t], w[t], err_msg=f"{run} step {t}: {leaf}")
    assert isinstance(states[-1].game, BossfightState)


@pytest.mark.parametrize("run", list(RUNS))
def test_setup_step_matches(run, ref, port):
    stepped = port[run][1][1]
    want = _leaves(ref, SEP.join((run, "setup")))
    got = _flat(state_to_numpy(stepped))
    assert want.keys() == got.keys()
    for leaf, w in want.items():
        assert got[leaf].dtype == w.dtype, leaf
        np.testing.assert_array_equal(got[leaf], w, err_msg=leaf)


def _count(pool, type_):
    return (pool.active & (pool.type == type_)).sum(dim=1)


@pytest.mark.parametrize("run", list(RUNS))
def test_trajectories_reach_the_machinery(run, port):
    """The random runs fire, the boss fires volleys that leave laser
    trails, and an episode ends (the forced reset among them)."""
    states = port[run][0]
    shots = volleys = 0
    for s0, s1 in zip(states, states[1:]):
        shots += int((_count(s1.ents, PLAYER_BULLET) > _count(s0.ents, PLAYER_BULLET)).sum())
        volleys += int((_count(s1.ents, ENEMY_BULLET) > _count(s0.ents, ENEMY_BULLET)).sum())
    assert shots >= 5 and volleys >= 3
    assert max(int(_count(s.decor, LASER_TRAIL).max()) for s in states) >= 8
    resets = sum(int((s1.cur_time < s0.cur_time).sum()) for s0, s1 in zip(states, states[1:]))
    assert resets >= 1 and int(states[FORCED + 1].cur_time[1]) == 0


@pytest.mark.parametrize("run", list(RUNS))
def test_boss_hit_order(run, port):
    """Kind 0: the higher slot's bullet hits first and crosses the round
    (+1), the shields rise and the other bullet stays; the boss is
    prepared for the next round and damaged.  Kind 1: the bullet over the
    raised shield reflects at the last step's ``rand_pct``.  Every env:
    the enemy bullet on the barrier is erased and explodes."""
    setup, stepped = port[run][1]
    kind = torch.arange(setup.num) % 4
    e, g = stepped.ents, stepped.game
    f32 = np.float32

    def has(type_, x):
        return (e.active & (e.type == type_) & (e.x == float(f32(x)))).any(dim=1)

    k0 = kind == 0
    assert (stepped.reward[k0] == 1.0).all() and not stepped.done[k0].any()
    assert has(PLAYER_BULLET, CROSS_X[0])[k0].all()
    assert not has(PLAYER_BULLET, CROSS_X[1])[k0].any()
    assert (g.round_num[k0] == 1).all() and g.shields_are_up[k0].all()
    assert (g.damaged_until_time[k0] == SETUP_TIME + 1 + 40).all()
    assert (g.curr_vel_timeout[k0] == 39).all()
    assert (e.health[k0, BOSS_SLOT] == 2.0).all()

    k1 = kind == 1
    theta = (PI_F * (1.25 + 0.5 * setup.game.rand_pct.double())).float()
    vy, vx = libm.sincos_times(theta, torch.full_like(theta, 0.5))
    refl = e.active & (e.type == REFLECTED_BULLET)
    assert (refl.sum(dim=1)[k1] == 1).all() and not refl[~k1].any()
    j = refl.to(torch.int32).argmax(dim=1)
    assert torch.equal(e.vx.gather(1, j[:, None])[k1, 0], vx[k1])
    assert torch.equal(e.vy.gather(1, j[:, None])[k1, 0], vy[k1])
    assert (e.expire_time.gather(1, j[:, None])[k1] == 4).all()

    # the bullet on the barrier went, leaving an explosion at its place
    assert not ((e.type == ENEMY_BULLET) & (e.x == float(f32(4.2))) & e.active).any()
    d = stepped.decor
    assert ((d.type == EXPLOSION) & (d.x == float(f32(4.2))) & d.active).any(dim=1).all()


def test_bullet_cosine_is_glibc():
    """``libm.sincos_times`` (fdlibm's reduction and kernels in f64) times
    a bullet speed, rounded once, equals glibc's double ``sin``/``cos``
    (ctypes) times it at every heading of modes 0 and 1 and at 4,096
    random headings of modes 2, 3 and the passive shot, for both
    speeds."""
    lib = ctypes.CDLL("libm.so.6")
    for fn in ("sin", "cos"):
        getattr(lib, fn).restype = ctypes.c_double
        getattr(lib, fn).argtypes = [ctypes.c_double]
    f32 = np.float32
    turn = [f32(PI_F * (1.25 + 0.5 * k / 8.0) + c) for k in range(9) for c in TURN_THETA]
    r = (np.random.RandomState(3).randint(0, 2**32, 4096, dtype=np.uint64)
         .astype(f32) * f32(2.0**-32))
    theta = np.concatenate([np.array(FAN_THETA + tuple(turn), f32),
                            f32(PI_F) * (f32(1) + r), r * f32(2) * f32(PI_F) + f32(5.497787)])
    for v in (0.5, 0.75):
        s, c = libm.sincos_times(torch.from_numpy(theta), torch.full(theta.shape, v))
        np.testing.assert_array_equal(s.numpy(), [f32(lib.sin(float(t)) * v) for t in theta])
        np.testing.assert_array_equal(c.numpy(), [f32(lib.cos(float(t)) * v) for t in theta])


def _frames_case(run, port):
    """(state batch, kernel-path frames, plain-renderer frames, prep)."""
    return port[run][2]


@pytest.mark.parametrize("run", list(RUNS) + ["genassets"])
def test_frames_match_pallas_interpret(run, ref, port):
    got = _frames_case(run, port)[1]
    np.testing.assert_array_equal(got, ref[SEP.join((run, "pallas"))])


@pytest.mark.parametrize("run", list(RUNS) + ["genassets"])
def test_frames_match_xla_render_obs(run, ref, port):
    """The port's plain renderer equals the XLA renderer, which equals the
    Pallas kernel on these states."""
    plain = _frames_case(run, port)[2]
    want = ref[SEP.join((run, "xla"))]
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(want, ref[SEP.join((run, "pallas"))])


@pytest.mark.parametrize("run", list(RUNS))
def test_prep_matches_pallas_prep(run, ref, port):
    batch, _, _, (ent_f, ent_i, decor) = _frames_case(run, port)
    plan = rk.get_plan(_torch_game(RUNS[run][0]))
    assert plan.static and plan.dz_levels == (0,) and ent_f.shape[1] == 72
    assert decor.nzd == 1 and decor.dec_f.shape[1] == 160
    key = SEP.join((run, "prep")) + SEP
    np.testing.assert_array_equal(ent_f.numpy(), ref[key + "ent_f"])
    np.testing.assert_array_equal(ent_i.numpy(), ref[key + "ent_i"])
    np.testing.assert_array_equal(decor.dec_f.numpy(), ref[key + "dec_f"])
    np.testing.assert_array_equal(decor.dec_i.numpy(), ref[key + "dec_i"])
    si = ref[key + "si"]
    np.testing.assert_array_equal(decor.counts[:, 0].numpy(), si[:, rk.SI_ENT_COUNT])
    np.testing.assert_array_equal(decor.counts[:, 1].numpy(), si[:, rk.SI_DEC_COUNT])
    # the enemy bullets and their trails sample the rotation banks; the
    # shield slot is hidden while the shields are down
    bank = lambda i: (i[..., rk.EI_ROW] > plan.ent_atlas.transparent_row) & (  # noqa: E731
        i[..., rk.EI_ROW] < plan.n1e) & (i[..., rk.EI_LIVE] > 0)
    assert bool(bank(ent_i).any()) and bool(bank(decor.dec_i).any())
    shown = ent_i[:, SHIELD_SLOT, rk.EI_LIVE] > 0
    assert torch.equal(shown, batch.game.shields_are_up)


@pytest.mark.parametrize("name", REPLAYS)
def test_conformance_replay(name, replays):
    rec, res = replays[name]
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == res["steps"] == len(rec["actions"])


def test_supports_the_static_path_at_its_caps():
    """Both modes take the static path with both pools at caps 72 + 160:
    69,104 bytes of the suffix kernel's shared memory a block."""
    for mode in (0, 1):
        plan = rk.get_plan(_torch_game(mode))
        assert rk.supports(plan.game) and plan.static
        assert plan.z_levels == (0, 1) and plan.dz_levels == (0,)
    assert rk.suffix_smem(72, 160) == 69104


if __name__ == "__main__":
    from test_torch_refstate import patch_jax_cpp_arithmetic

    patch_jax_cpp_arithmetic()
    _jax_reference(sys.argv[1])
