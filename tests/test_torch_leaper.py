"""The port's leaper against the JAX package's and the C++ recordings.

* Easy, hard and extreme, 4 envs, 64 random steps each, through the pooled
  runtime (easy: ``procgen_tpu_torch.entry.make_env_fns(4, "leaper")``
  against ``__graft_entry__._make_env_fns(4, "leaper")``; hard and
  extreme: the same program over that game): every ``BasicState`` leaf
  (``LeaperState``, the pool after the reset's warm-up and ``rand_gen``
  included), the next-level pool and its validity, obs, reward and done,
  bit-equal.  The seeds give hops, cars, logs, episode ends and a forced
  reset.
* A set-up step over the states of every other step of a run, the frog
  at rest: a quarter of the states put it on the first water lane over
  two logs that drift apart (it rides the higher slot's), a quarter on
  open water (it drowns where no log of the lane is under it), a quarter
  on the finish line (+10) and a quarter under a car pushed onto the
  first road lane (it dies). Stepped once, every leaf.
* The frames of every fourth step's states and of a quarter of the
  set-up step's states (the finish line tiled across the frame, the frog's
  tall rectangle in quarter turns, cars turned by pi):
  ``render_kernel.render_obs_batch`` (on CPU tensors,
  ``render_suffix_reference`` over the cached prefix) against the Pallas
  kernel run in interpret mode and against the XLA ``render_obs``; the
  port's ``renderer.render_obs`` against the XLA one; ``prep_suffix``
  against the Pallas kernel's ``_prep_one``.
* The spawn roll's threshold: the JAX package writes ``abs(speed) / 6.0``,
  which XLA computes as a multiply by ``f32(1/6)``; the port writes that
  form, checked here against the JAX package under ``jax.jit`` over
  2^20 lane speeds of every mode.
* leaper_easy, leaper_hard and leaper_extreme replay exactly.
* The bridge carries a leaper state both ways.

The JAX reference runs in three child processes (this file run as a
script, one for each run, while the port runs its own and replays the
recordings) whose XLA is held to AVX (``--xla_cpu_max_isa=AVX``), as in
tests/test_torch_plunder.py.  Leaper overrides the agent's velocity
update, so the children need no C++-arithmetic patch; they install
``test_torch_refstate.patch_jax_cpp_arithmetic`` all the same, which
touches nothing leaper runs.

Tolerance: zero.
"""

import contextlib
import copy
import dataclasses
import json
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
from procgen_tpu_torch.core import lifecycle as tlife  # noqa: E402
from procgen_tpu_torch.core.constants import INT32_MAX  # noqa: E402
from procgen_tpu_torch.core.entities import default_fields  # noqa: E402
from procgen_tpu_torch.core.game import BasicState, tree_map  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.entry import make_env_fns  # noqa: E402
from procgen_tpu_torch.games.leaper import (  # noqa: E402
    CAR, LOG, MONSTER_RADIUS, LOG_RADIUS, Leaper, LeaperState,
)
from procgen_tpu_torch.parallel.vec import Carry, render_batch, step_pool  # noqa: E402
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402
from procgen_tpu_torch.utils.host_mt import HostMT19937  # noqa: E402

N = 4
STEPS = 64
# run -> (distribution mode, master seed, action seed)
RUNS = {"easy": (0, 5, 0), "hard": (1, 9, 1), "extreme": (2, 13, 2)}
SEP = "::"


def _seeds(master_seed):
    m = HostMT19937(master_seed)
    return np.array([m.next_u32() for _ in range(N)], np.int64)


def _actions(action_seed):
    """[STEPS, N] random actions; env 2 is forced to reset at step 30."""
    rng = np.random.RandomState(action_seed)
    out = rng.randint(0, 15, (STEPS, N)).astype(np.int32)
    out[30, 2] = -1
    return out


def _frame_steps():
    return np.arange(0, STEPS + 1, 4)


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        elif v is not None:
            out[pre + k] = np.asarray(v)
    return out


def _cases(B):
    """The set-up case of each of ``B`` states (``N`` a step): the four
    turn with the env and the step, so every env meets each."""
    b = np.arange(B)
    return (b + b // N) % 4


def _setup(tree):
    """The set-up step's input (numpy leaves, ``[B, ...]``): the frog at
    rest on a log pair, on open water, on the finish line or under a car,
    by ``_cases`` (the module docstring)."""
    t = copy.deepcopy(tree)
    g, e = t["game"], t["ents"]
    B = e["x"].shape[0]
    f = np.float32
    case = _cases(B)
    w = t["main_width"].astype(f)
    water_y = g["bottom_water_y"].astype(f) + f(0.5)
    road_y = g["bottom_road_y"].astype(f) + f(0.5)
    goal_y = g["goal_y"].astype(f) - f(0.5)
    e["vx"][:, 0] = 0.0
    e["vy"][:, 0] = 0.0
    e["x"][:, 0] = np.where(case % 2 == 0, f(2.0), w / f(2))
    e["y"][:, 0] = np.select([case < 2, case == 2], [water_y, goal_y], road_y)

    def push(rec, where):
        assert (e["count"] < e["x"].shape[1]).all()
        rows = np.nonzero(where)[0]
        for k, v in rec.items():
            e[k][rows, e["count"][rows]] = np.broadcast_to(
                np.asarray(v, e[k].dtype), (B,))[rows]
        e["count"][rows] += 1

    push(default_fields(2.0, water_y, 0.05, 0.0, LOG_RADIUS, LOG_RADIUS, LOG),
         case == 0)
    push(default_fields(2.3, water_y, -0.07, 0.0, LOG_RADIUS, LOG_RADIUS, LOG),
         case == 0)
    car = default_fields(w / f(2), road_y, 0.0, 0.0, 2 * MONSTER_RADIUS,
                         MONSTER_RADIUS, CAR)
    car["image_theme"] = 2
    push(car, case == 3)
    return t


SETUP_ACTION = 4  # no move
SETUP_EVERY = 2  # the set-up step takes the states of every other step


# ---------------------------------------------------------------------------
# the JAX reference (child process)
# ---------------------------------------------------------------------------


def _jax_game(mode):
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game

    game = make_game("leaper", JGameOptions(distribution_mode=mode))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _jax_env_fns(mode):
    """(init, step) of ``__graft_entry__._make_env_fns(N, "leaper")`` for
    easy; for hard, the same program over the hard game."""
    from __graft_entry__ import _make_env_fns

    if mode == 0:
        init, step, _ = _make_env_fns(N, "leaper")
        return init, step

    from procgen_tpu.core import lifecycle
    from procgen_tpu.parallel.vec import (
        _tree_select, render_batch as jrender_batch, replenish_pool,
        reset_pending, splice_pool,
    )

    game = _jax_game(mode)
    k = N

    def init(seeds):
        states = jax.vmap(lambda sd: lifecycle.initial_state(game, sd))(seeds)
        states = jax.vmap(lambda s: lifecycle.env_reset(game, s))(states)
        pool = jax.vmap(lambda s: lifecycle.env_reset(game, s))(states)
        return states, pool, jnp.ones((N,), bool), jnp.zeros((), jnp.int32)

    def step(carry, actions):
        states, pool, valid, t = carry
        states, needs_reset = jax.vmap(
            lambda s, a: lifecycle.env_step(game, s, a))(states, actions)
        use = needs_reset & valid
        states = _tree_select(use, splice_pool(pool, states), states)
        valid = valid & ~needs_reset
        states = reset_pending(game, states, needs_reset & ~use, k)
        due = (jnp.sum(~valid) >= k) | ((t % 8) == 7)
        pool, valid = jax.lax.cond(
            due,
            lambda a: replenish_pool(game, a[0], a[1], a[2], k, max_iters=1),
            lambda a: (a[1], a[2]),
            (states, pool, valid),
        )
        obs = jrender_batch(game, states, 64)
        return (states, pool, valid, t + 1), obs, states.reward, states.done

    return init, step


def _to_tree(state):
    return jax.tree_util.tree_map(np.array, serialization.to_state_dict(state))


def _save_tree(out, key, tree):
    for leaf, v in _flat(serialization.to_state_dict(tree)).items():
        out[SEP.join((key, leaf))] = v


def _jax_reference(out_path, run):
    """Run one program, step the set-up states once and render the
    states of ``_frame_steps`` and a quarter of the set-up step's.  Saves
    the arrays, keyed ``run::part::leaf``."""
    from procgen_tpu.core import lifecycle
    from procgen_tpu.render import pallas_kernel
    from procgen_tpu.render.renderer import render_obs

    jax.config.update("jax_platforms", "cpu")
    lifecycle.env_reset = jax.jit(lifecycle.env_reset, static_argnums=0)
    out = {}
    mode, mseed, aseed = RUNS[run]
    init, step = _jax_env_fns(mode)
    init, step = jax.jit(init), jax.jit(step)
    carry = init(jnp.asarray(_seeds(mseed), jnp.uint32))
    steps = [(carry, None)]
    for a in _actions(aseed):
        carry, obs, rew, done = step(carry, jnp.asarray(a))
        steps.append((carry, (obs, rew, done)))
    for part, j in (("states", 0), ("pool", 1)):
        trees = [_flat(serialization.to_state_dict(c[j])) for c, _ in steps]
        for leaf in trees[0]:
            out[SEP.join((run, part, leaf))] = np.stack([t[leaf] for t in trees])
    out[SEP.join((run, "valid"))] = np.stack([np.asarray(c[2]) for c, _ in steps])
    out[SEP.join((run, "t"))] = np.stack([np.asarray(c[3]) for c, _ in steps])
    for k, name in enumerate(("obs", "reward", "done")):
        out[SEP.join((run, name))] = np.stack(
            [np.asarray(o[k]) for _, o in steps[1:]])

    game = _jax_game(mode)
    everything = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs), *[c[0] for c, _ in steps[::SETUP_EVERY]])
    B = len(steps[::SETUP_EVERY]) * N
    template = jax.eval_shape(
        jax.vmap(lambda sd: lifecycle.initial_state(game, sd)),
        jax.ShapeDtypeStruct((B,), jnp.uint32))
    setup = serialization.from_state_dict(template, _setup(_to_tree(everything)))
    stepped, _ = jax.jit(jax.vmap(lambda s, a: lifecycle.env_step(game, s, a)))(
        setup, jnp.full((B,), SETUP_ACTION, jnp.int32))
    _save_tree(out, SEP.join((run, "setup")), stepped)

    batch = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs),
        *[steps[t][0][0] for t in _frame_steps()],
        jax.tree_util.tree_map(lambda x: x[::4], stepped))
    out[SEP.join((run, "pallas"))] = np.asarray(jax.jit(
        lambda st: pallas_kernel.render_obs_batch(game, st, 64, interpret=True)
    )(batch))
    out[SEP.join((run, "xla"))] = np.asarray(
        jax.jit(jax.vmap(lambda s: render_obs(game, s, 64)))(batch))
    plan = pallas_kernel.get_plan(game, 64)
    prep = jax.jit(jax.vmap(lambda s: pallas_kernel._prep_one(plan, s)))(batch)
    for k in ("si", "ent_f", "ent_i"):
        out[SEP.join((run, "prep", k))] = np.asarray(prep[k])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_children(tmp_path_factory):
    """Start the JAX reference: one child process per run, all at once;
    yields run -> (output path, process, stderr path)."""
    out_dir = tmp_path_factory.mktemp("leaper")
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"{flags} --xla_cpu_max_isa=AVX".strip(),
        JAX_COMPILATION_CACHE_DIR=jax.config.jax_compilation_cache_dir or "",
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="1",
    )
    children = {}
    for run in RUNS:
        path, log = out_dir / f"{run}.npz", out_dir / f"{run}.log"
        with open(log, "w") as err:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(path), run],
                env=env, stdout=subprocess.DEVNULL, stderr=err)
        children[run] = (path, proc, log)
    yield children
    for _, proc, _ in children.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def ref(jax_children, port, replays):
    """The JAX reference's arrays (waited for after the port's runs and
    replays)."""
    out = {}
    for path, proc, log in jax_children.values():
        assert proc.wait(timeout=1800) == 0, log.read_text()[-4000:]
        with np.load(path) as z:
            out.update({k: z[k] for k in z.files})
    return out


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def _torch_game(mode):
    game = Leaper(GameOptions(distribution_mode=mode))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _torch_env_fns(mode):
    if mode == 0:
        init, step, _ = make_env_fns(N, "leaper", device="cpu")
        return init, step
    game = _torch_game(mode)

    def init(seeds):
        states = tlife.env_reset(game, tlife.initial_state(game, seeds))
        pool = tlife.env_reset(game, states)
        return Carry(states, pool, torch.ones((N,), dtype=torch.bool), 0)

    def step(carry, actions):
        carry = step_pool(game, carry, actions, N)
        obs = render_batch(game, carry.states, 64)
        return carry, obs, carry.states.reward, carry.states.done

    return init, step


@contextlib.contextmanager
def _one_thread():
    """The port's ops are small, and the JAX children hold the other
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _cat(states):
    return tree_map(lambda *xs: torch.cat(xs), *states)


@pytest.fixture(scope="module")
def port(jax_children):
    """Per run: the carries (step 0 the initial one), the step outputs,
    the set-up step and the frames of the rendered states on both of the
    port's render paths with their ``prep_suffix``."""
    out = {}
    with _one_thread():
        for run, (mode, mseed, aseed) in RUNS.items():
            init, step = _torch_env_fns(mode)
            carry = init(torch.as_tensor(_seeds(mseed)))
            carries, outs = [carry], []
            for a in _actions(aseed):
                carry, obs, rew, done = step(carry, torch.as_tensor(a))
                carries.append(carry)
                outs.append((obs, rew, done))
            game = _torch_game(mode)
            everything = _cat([c.states for c in carries[::SETUP_EVERY]])
            setup = state_from_numpy(_setup(state_to_numpy(everything)), game, "cpu")
            stepped, _ = tlife.env_step(
                game, setup, torch.full((setup.num,), SETUP_ACTION, dtype=torch.int32))
            batch = _cat([carries[t].states for t in _frame_steps()]
                         + [tree_map(lambda x: x[::4], stepped)])
            frames = (batch, rk.render_obs_batch(game, batch).numpy(),
                      trender_obs(game, batch, 64).numpy(),
                      rk.prep_suffix(rk.get_plan(game), batch))
            out[run] = (carries, outs, (setup, stepped), frames)
    return out


REPLAYS = ("leaper_easy", "leaper_hard", "leaper_extreme")


@pytest.fixture(scope="module")
def replays(jax_children):
    out = {}
    with _one_thread():
        for name in REPLAYS:
            with open(os.path.join(HERE, "data", "conformance", f"{name}.json")) as f:
                rec = json.load(f)
            out[name] = (rec, replay(rec, device="cpu"))
    return out


def _assert_leaves(ref, prefix, trees, tag):
    want = {k[len(prefix) + len(SEP):]: v for k, v in ref.items()
            if k.startswith(prefix + SEP)}
    got = [_flat(state_to_numpy(t)) for t in trees]
    assert set(want) == set(got[0]), set(want) ^ set(got[0])
    for leaf, w in want.items():
        g = np.stack([t[leaf] for t in got])
        assert g.dtype == w.dtype, (tag, leaf, g.dtype, w.dtype)
        for t in range(len(got)):
            np.testing.assert_array_equal(g[t], w[t], err_msg=f"{tag} step {t}: {leaf}")


@pytest.mark.parametrize("run", list(RUNS))
def test_states_match(run, ref, port):
    carries = port[run][0]
    _assert_leaves(ref, SEP.join((run, "states")), [c.states for c in carries], run)
    _assert_leaves(ref, SEP.join((run, "pool")), [c.pool for c in carries],
                   f"{run} pool")
    np.testing.assert_array_equal(
        np.stack([c.valid.numpy() for c in carries]), ref[SEP.join((run, "valid"))])
    assert [c.t for c in carries] == ref[SEP.join((run, "t"))].tolist()
    assert isinstance(carries[-1].states.game, LeaperState)


@pytest.mark.parametrize("run", list(RUNS))
def test_outputs_match(run, ref, port):
    outs = port[run][1]
    for k, name in enumerate(("obs", "reward", "done")):
        got = np.stack([o[k].numpy() for o in outs])
        np.testing.assert_array_equal(got, ref[SEP.join((run, name))], err_msg=name)


@pytest.mark.parametrize("run", list(RUNS))
def test_setup_step_matches(run, ref, port):
    stepped = port[run][2][1]
    prefix = SEP.join((run, "setup"))
    want = {k[len(prefix) + len(SEP):]: v for k, v in ref.items()
            if k.startswith(prefix + SEP)}
    got = _flat(state_to_numpy(stepped))
    assert want.keys() == got.keys()
    for leaf, w in want.items():
        assert got[leaf].dtype == w.dtype, leaf
        np.testing.assert_array_equal(got[leaf], w, err_msg=leaf)


@pytest.mark.parametrize("run", list(RUNS))
def test_trajectories_reach_the_machinery(run, port):
    """The random runs hop (the frog's theme animates), keep cars and logs
    on the lanes and end episodes (a forced reset at step 30); the set-up
    step carries the frog by the higher log's -0.07 where it stands on the
    pair over water, drowns it on open water, pays +10 on the finish line
    and kills it under the car."""
    carries, outs, (setup, stepped) = port[run][:3]
    e = carries[-1].states.ents
    assert ((e.type == CAR) & e.active).any() and ((e.type == LOG) & e.active).any()
    themes = torch.stack([c.states.ents.image_theme[:, 0] for c in carries])
    assert (themes > 1).any() and bool(outs[30][2][2])

    case = torch.as_tensor(_cases(setup.num))
    water = setup.game.num_water_lanes > 0
    riding = (case == 0) & water
    assert int(riding.sum()) >= 4
    carried = torch.tensor(2.0) + torch.tensor(-0.07)
    assert (stepped.ents.x[riding, 0] == carried).all()
    drown = (case == 1) & water
    assert stepped.done[drown].float().mean() > 0.3
    assert stepped.level_complete[case == 2].all()
    assert (stepped.reward[case == 2] >= 10).all()
    assert stepped.done[case == 3].all() and not stepped.level_complete[case == 3].any()


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_spawn_roll_threshold_is_xlas(mode):
    """Every lane speed a mode's reset draws (2^20 of them), its car and
    log thresholds against the JAX package's expressions under
    ``jax.jit``."""
    from procgen_tpu_torch.core import rng
    from procgen_tpu_torch.games.leaper import CAR_ROLL_SCALE, LOG_ROLL_SCALE

    game = _torch_game(mode)
    words = torch.from_numpy(np.random.RandomState(mode).randint(
        0, 2**32, 2**20, dtype=np.uint64).astype(np.int64))
    f01 = rng._rand01_from(words)
    for (lo, hi), scale, denom in ((game.car_speed, CAR_ROLL_SCALE, 6.0),
                                   (game.log_speed, LOG_ROLL_SCALE, 2.0)):
        speed = rng._randrange_from(f01, lo, hi)
        speed = torch.where(words % 2 == 0, speed, -speed)
        want = np.asarray(jax.jit(lambda v: jnp.abs(v) / denom)(speed.numpy()))
        np.testing.assert_array_equal((torch.abs(speed) * scale).numpy(), want)


@pytest.mark.parametrize("run", list(RUNS))
def test_frames_match_pallas_interpret(run, ref, port):
    np.testing.assert_array_equal(port[run][3][1], ref[SEP.join((run, "pallas"))])


@pytest.mark.parametrize("run", list(RUNS))
def test_frames_match_xla_render_obs(run, ref, port):
    want = ref[SEP.join((run, "xla"))]
    np.testing.assert_array_equal(port[run][3][2], want)
    np.testing.assert_array_equal(want, ref[SEP.join((run, "pallas"))])


@pytest.mark.parametrize("run", list(RUNS))
def test_prep_matches_pallas_prep(run, ref, port):
    batch, _, _, (ent_f, ent_i, extra) = port[run][3]
    plan = rk.get_plan(_torch_game(RUNS[run][0]))
    assert plan.static and plan.z_levels in ((0,), (0, 1)) and extra is None
    key = SEP.join((run, "prep")) + SEP
    np.testing.assert_array_equal(ent_f.numpy(), ref[key + "ent_f"])
    np.testing.assert_array_equal(ent_i.numpy(), ref[key + "ent_i"])
    # the frog in several quarter turns, cars turned by pi, a tiled slot
    e = batch.ents
    frog = e.rotation[:, 0]
    assert len(set(frog.tolist())) >= 3
    assert ((e.type == CAR) & e.active & (e.rotation != 0)).any()
    live = ent_i[..., rk.EI_LIVE] > 0
    assert (live & (ent_i[..., rk.EI_TILEH] > 0)).any()  # the finish line


@pytest.mark.parametrize("name", REPLAYS)
def test_conformance_replay(name, replays):
    rec, res = replays[name]
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == res["steps"] == len(rec["actions"])


def test_bridge_round_trip(ref, port):
    """The JAX state of the set-up step -> the port's state -> numpy, leaf
    for leaf, and back into a JAX BasicState."""
    from procgen_tpu.core import lifecycle as jlife

    prefix = SEP.join(("hard", "setup")) + SEP
    tree = {}
    for k, v in ref.items():
        if k.startswith(prefix):
            node = tree
            *path, leaf = k[len(prefix):].split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    for f in dataclasses.fields(BasicState):
        tree.setdefault(f.name, None)
    ts = state_from_numpy(tree, _torch_game(1), "cpu")
    assert isinstance(ts.game, LeaperState)
    a, b = _flat(tree), _flat(state_to_numpy(ts))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jg = _jax_game(1)
    template = jax.eval_shape(
        jax.vmap(lambda sd: jlife.initial_state(jg, sd)),
        jax.ShapeDtypeStruct((ts.num,), jnp.uint32))
    back = serialization.from_state_dict(template, state_to_numpy(ts))
    np.testing.assert_array_equal(np.asarray(back.ents.x), tree["ents"]["x"])
    np.testing.assert_array_equal(np.asarray(back.game.water_lane_speeds),
                                  tree["game"]["water_lane_speeds"])


def test_supports_the_static_path():
    for mode in (0, 1, 2):
        game = _torch_game(mode)
        plan = rk.get_plan(game)
        assert rk.supports(game) and plan.static and not game.DECOR_CAP


if __name__ == "__main__":
    from test_torch_refstate import patch_jax_cpp_arithmetic

    patch_jax_cpp_arithmetic()
    _jax_reference(sys.argv[1], sys.argv[2])
