"""The port's plunder against the JAX package's and the C++ recordings.

* Easy and hard, 4 envs, 64 random steps each, through the pooled runtime
  (easy: ``procgen_tpu_torch.entry.make_env_fns(4, "plunder")`` against
  ``__graft_entry__._make_env_fns(4, "plunder")``; hard: the same program
  over the hard game): every ``BasicState`` leaf (``PlunderState``, both
  pools and ``rand_gen`` included), the next-level pool and its validity,
  obs, reward and done, bit-equal.  The seeds give lane ships, shots,
  kills with their explosions, episode ends and a forced reset.
* A set-up step: the states of every step of a run, with a target ship and
  a friendly ship each over a bullet in flight, a volley (one bullet over
  two ships) and in hard mode a wooden panel over a bullet,
  ``targets_hit`` at 19 in half of the envs and ``juice_left`` near 0 in
  the others, and explosions on every lane's two spawn points, stepped
  once: every leaf.  It reaches the target and the
  friendly kill, the sequential dispatch's one kill a bullet, the panel
  hit, the completion bonus, the empty timer and spawns that the
  explosions block.
* The frames of every fourth step's states and of a quarter of the set-up
  step's states (live explosions in every one):
  ``render_kernel.render_obs_batch`` (on CPU tensors,
  ``render_suffix_reference`` over the cached prefix) against the Pallas
  kernel run in interpret mode and against the XLA ``render_obs``; the
  port's ``renderer.render_obs`` against the XLA one; ``prep_suffix``
  against the Pallas kernel's ``_prep_one``.
* plunder_easy and plunder_hard replay exactly.
* The bridge carries a plunder state with live explosions both ways.

The JAX reference runs once, in two child processes (this file run as a
script, one for each run, while the port runs its own and replays the
recordings) whose XLA is held to AVX (``--xla_cpu_max_isa=AVX``), as in
tests/test_torch_starpilot.py: XLA's CPU backend otherwise contracts ``a *
b + c`` into a fused multiply-add, which neither the C++ reference nor the
port does.  The children trace ``lifecycle.env_reset`` once, under
``jax.jit``.

The children also hold the JAX package to the C++ arithmetic where C++
evaluates a float expression in double (the agent's velocity decay and
the lane speeds): ``test_torch_refstate.patch_jax_cpp_arithmetic``
evaluates those expressions in f64 and rounds once, in the children
only.

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

from procgen_tpu_torch import ProcgenGym3Env  # noqa: E402
from procgen_tpu_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from procgen_tpu_torch.conformance import replay  # noqa: E402
from procgen_tpu_torch.core import lifecycle as tlife  # noqa: E402
from procgen_tpu_torch.core.constants import EXPLOSION, INT32_MAX  # noqa: E402
from procgen_tpu_torch.core.entities import default_fields  # noqa: E402
from procgen_tpu_torch.core.game import BasicState, tree_map  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.entry import make_env_fns  # noqa: E402
from procgen_tpu_torch.games.plunder import (  # noqa: E402
    PANEL, PLAYER_BULLET, SHIP, Plunder, PlunderState,
)
from procgen_tpu_torch.parallel.vec import Carry, render_batch, step_pool  # noqa: E402
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402
from procgen_tpu_torch.utils.host_mt import HostMT19937  # noqa: E402

N = 4
STEPS = 64
# run -> (distribution mode, master seed, action seed)
RUNS = {"easy": (0, 7, 0), "hard": (1, 4, 1)}
SEP = "::"


def _seeds(master_seed):
    m = HostMT19937(master_seed)
    return np.array([m.next_u32() for _ in range(N)], np.int64)


def _actions(action_seed):
    """[STEPS, N] actions, more than half of them a shot (9) or a shot
    that moves (10 and up are shots in plunder too); env 2 is forced to
    reset at step 30."""
    rng = np.random.RandomState(action_seed)
    out = []
    for t in range(STEPS):
        a = np.where(rng.rand(N) < 0.6, rng.choice([9, 9, 1, 7, 4], N),
                     rng.randint(0, 15, N)).astype(np.int32)
        if t == 30:
            a[2] = -1
        out.append(a)
    return np.stack(out)


def _setup_actions(n):
    return np.random.RandomState(11).randint(0, 15, n).astype(np.int32)


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


def _lane_y(lane, r):
    """A lane ship's centre height, in f32 as the step computes it."""
    f = np.float32
    return (f(lane) * f(0.11) + f(0.4)) * f(10.0 - r) + f(10.0)


def _setup(tree, mode, explosions=True):
    """The set-up step's input: a state dict (numpy leaves, ``[B, ...]``)
    with a target ship and a friendly ship, each over a bullet that
    reaches it this step, two friendly ships over one bullet (and, in hard
    mode, a panel over a fourth bullet) pushed into the entity pool;
    ``targets_hit`` 19 in the even envs (the kill completes the level) and
    ``juice_left`` 0.001 in the odd ones (the step empties it); with
    ``explosions``, the decor pool holds explosions on both spawn points of
    every lane."""
    t = copy.deepcopy(tree)
    g, e, dec = t["game"], t["ents"], t["decor"]
    B = e["x"].shape[0]
    r = 1.5 if mode == 0 else 1.0
    g["targets_hit"][0::2] = 19
    g["targets_hit"][1::2] = 5
    g["juice_left"][1::2] = np.float32(0.001)
    perm = g["image_permutation"]

    def record(x, y, vx, vy, rx, ry, type_, **extra):
        rec = default_fields(x, y, vx, vy, rx, ry, type_)
        rec.update(extra)
        return rec

    bullet = dict(collides_with_entities=True, expire_time=50)
    recs = [
        record(6.0, 10.0, 0.1, 0.0, r, 1.0, SHIP, image_theme=perm[:, 0]),
        record(6.0, 9.0, 0.0, 1.0, 0.25, 0.25, PLAYER_BULLET, **bullet),
        record(12.0, 10.0, -0.1, 0.0, r, 1.0, SHIP, image_theme=perm[:, 1],
               is_reflected=True),
        record(12.0, 9.0, 0.0, 1.0, 0.25, 0.25, PLAYER_BULLET, **bullet),
        # a volley: one bullet over two ships
        record(9.0, 14.0, 0.0, 0.0, r, 1.0, SHIP, image_theme=perm[:, 2]),
        record(9.4, 14.0, 0.0, 0.0, r, 1.0, SHIP, image_theme=perm[:, 3]),
        record(9.0, 13.0, 0.0, 1.0, 0.25, 0.25, PLAYER_BULLET, **bullet),
    ]
    if mode != 0:
        recs += [record(16.0, 8.0, 0.0, 0.0, 1.2, 0.5, PANEL),
                 record(16.0, 7.0, 0.0, 1.0, 0.25, 0.25, PLAYER_BULLET, **bullet)]

    def push(pool, rec):  # at each env's count, which grows by one
        assert (pool["count"] < pool["x"].shape[1]).all()
        for k, v in rec.items():
            pool[k][np.arange(B), pool["count"]] = np.asarray(v, pool[k].dtype)
        pool["count"] += 1

    for rec in recs:
        push(e, rec)
    dec["count"][:] = 0
    if explosions:
        for lane in range(5):
            for x in (-r, 20.0 + r):
                push(dec, record(x, _lane_y(lane, r), 0.0, 0.0, r, r, EXPLOSION))
    return t


# ---------------------------------------------------------------------------
# the JAX reference (child process)
# ---------------------------------------------------------------------------


def _jax_game(mode):
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game

    game = make_game("plunder", JGameOptions(distribution_mode=mode))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _jax_env_fns(mode):
    """(init, step) of ``__graft_entry__._make_env_fns(N, "plunder")`` for
    easy; for hard, the same program over the hard game."""
    from __graft_entry__ import _make_env_fns

    if mode == 0:
        init, step, _ = _make_env_fns(N, "plunder")
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

    # the set-up step over the states of every step
    game = _jax_game(mode)
    everything = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs), *[c[0] for c, _ in steps])
    tree = _setup(_to_tree(everything), mode)
    B = len(steps) * N
    template = jax.eval_shape(
        jax.vmap(lambda sd: lifecycle.initial_state(game, sd)),
        jax.ShapeDtypeStruct((B,), jnp.uint32))
    setup = serialization.from_state_dict(template, tree)
    stepped, _ = jax.jit(jax.vmap(lambda s, a: lifecycle.env_step(game, s, a)))(
        setup, jnp.asarray(_setup_actions(B)))
    _save_tree(out, SEP.join((run, "setup")), stepped)

    # the rendered states as one batch
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
    for k in ("si", "ent_f", "ent_i", "dec_f", "dec_i"):
        out[SEP.join((run, "prep", k))] = np.asarray(prep[k])
    np.savez(out_path, **out)


def _save_tree(out, key, tree):
    for leaf, v in _flat(serialization.to_state_dict(tree)).items():
        out[SEP.join((key, leaf))] = v


@pytest.fixture(scope="module")
def jax_children(tmp_path_factory):
    """Start the JAX reference: one child process per run, all at once;
    yields run -> (output path, process, stderr path)."""
    out_dir = tmp_path_factory.mktemp("plunder")
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
    game = Plunder(GameOptions(distribution_mode=mode))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _torch_env_fns(mode):
    """(init, step) of ``make_env_fns(N, "plunder")`` for easy; for hard,
    the same program over the hard game."""
    if mode == 0:
        init, step, _ = make_env_fns(N, "plunder", device="cpu")
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


def _setup_step(game, mode, states, explosions=True):
    """The set-up step in the port: (set-up states, stepped states)."""
    tree = _setup(state_to_numpy(states), mode, explosions)
    s = state_from_numpy(tree, game, "cpu")
    stepped, _ = tlife.env_step(game, s, torch.as_tensor(_setup_actions(s.num)))
    return s, stepped


@pytest.fixture(scope="module")
def port(jax_children):
    """Per run: the port's carries (step 0 is the initial one), step
    outputs, the set-up step with and without the explosions, and the
    frames of the rendered states on both of the port's render paths with
    their ``prep_suffix``; computed while the JAX reference runs."""
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
            everything = _cat([c.states for c in carries])
            setup, stepped = _setup_step(game, mode, everything)
            _, free = _setup_step(game, mode, everything, explosions=False)
            batch = _cat([carries[t].states for t in _frame_steps()]
                         + [tree_map(lambda x: x[::4], stepped)])
            frames = (batch, rk.render_obs_batch(game, batch).numpy(),
                      trender_obs(game, batch, 64).numpy(),
                      rk.prep_suffix(rk.get_plan(game), batch))
            out[run] = (carries, outs, (setup, stepped, free), frames)
    return out


REPLAYS = ("plunder_easy", "plunder_hard")


@pytest.fixture(scope="module")
def replays(jax_children):
    """Each recording and the port's replay of it on the CPU, computed
    while the JAX reference runs."""
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
    assert isinstance(carries[-1].states.game, PlunderState)


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


def _count(e, type_):
    return (e.active & (e.type == type_)).sum(dim=1)


@pytest.mark.parametrize("run", list(RUNS))
def test_trajectories_reach_the_machinery(run, port):
    """The random runs spawn lane ships, fire, kill ships into explosions
    and end an episode by the forced reset; the set-up step kills a target
    ship and a friendly one in every env (each bullet only its ship, the
    volley's bullet only the higher of its two), hits the panel in hard
    mode (the bullet goes, the panel stays), completes the level with +10
    where 19 targets were hit, empties the timer where it was near 0, and
    its explosions block lane ships that spawn without them."""
    carries, outs, (setup, stepped, free) = port[run][:3]
    ships = booms = 0
    for c0, c1, o in zip(carries, carries[1:], outs):
        ships += int((_count(c1.states.ents, SHIP) > _count(c0.states.ents, SHIP)).sum())
        booms += int(((c1.states.decor.type == EXPLOSION) & c1.states.decor.active).any(1).sum())
    assert ships >= 4 and booms >= 1
    assert bool(outs[30][2][2])  # the forced reset; the set-up step ends the rest

    g0, g1 = setup.game, stepped.game
    even = torch.arange(setup.num) % 2 == 0
    assert (g1.targets_hit > g0.targets_hit).all()
    assert (stepped.level_complete == even).all()
    assert (stepped.reward[even] >= 11).all() and (stepped.reward[~even] < 10).all()
    # the odd envs whose juice the kills did not raise run dry
    dry = ~even & (g1.targets_hit == g0.targets_hit + 1)
    assert int(dry.sum()) >= setup.num // 2 - 4
    assert (g1.juice_left[dry] <= 0).all() and stepped.done[dry | even].all()
    # three kills an env, each one explosion (pushed before the blocked
    # spawns); the volley's bullet kills only the higher of its two ships
    kills = _count(setup.ents, SHIP) - _count(stepped.ents, SHIP)
    assert (stepped.decor.count >= 3).all()
    e = stepped.ents

    def at(type_, x, y):
        return (e.active & (e.type == type_) & (e.x == x) & (e.y == y)).any(dim=1)

    # (a bullet already in flight may take the lower one in a few envs)
    assert float(at(SHIP, 9.0, 14.0).float().mean()) > 0.9
    assert not at(SHIP, 9.4, 14.0).any()
    if run == "hard":
        assert at(PANEL, 16.0, 8.0).all() and not at(PLAYER_BULLET, 16.0, 8.0).any()
    blocked = _count(stepped.ents, SHIP) < _count(free.ents, SHIP)
    assert int(blocked.sum()) >= 1 and (kills >= 1).all()


def _frames_case(run, port):
    """(state batch, kernel-path frames, plain-renderer frames, prep)."""
    return port[run][3]


@pytest.mark.parametrize("run", list(RUNS))
def test_frames_match_pallas_interpret(run, ref, port):
    got = _frames_case(run, port)[1]
    np.testing.assert_array_equal(got, ref[SEP.join((run, "pallas"))])


@pytest.mark.parametrize("run", list(RUNS))
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
    assert plan.static and plan.dz_levels == (0,)
    assert decor.nzd == 1 and decor.z_slots == (0, 1) and decor.dz_slots == (0, -1)
    key = SEP.join((run, "prep")) + SEP
    np.testing.assert_array_equal(ent_f.numpy(), ref[key + "ent_f"])
    np.testing.assert_array_equal(ent_i.numpy(), ref[key + "ent_i"])
    np.testing.assert_array_equal(decor.dec_f.numpy(), ref[key + "dec_f"])
    np.testing.assert_array_equal(decor.dec_i.numpy(), ref[key + "dec_i"])
    si = ref[key + "si"]
    np.testing.assert_array_equal(decor.counts[:, 0].numpy(), si[:, rk.SI_ENT_COUNT])
    np.testing.assert_array_equal(decor.counts[:, 1].numpy(), si[:, rk.SI_DEC_COUNT])
    # explosions live at several frames of their advance
    live = decor.dec_i[..., rk.EI_LIVE] > 0
    assert live.any(dim=1).sum() >= 16
    assert len(set(batch.decor.image_type[batch.decor.active].tolist())) >= 2


@pytest.mark.parametrize("name", REPLAYS)
def test_conformance_replay(name, replays):
    rec, res = replays[name]
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == res["steps"] == len(rec["actions"])


def test_bridge_round_trip(ref, port):
    """The JAX state of the set-up step (live explosions in every env) ->
    the port's state -> numpy, leaf for leaf, and back into a JAX
    BasicState."""
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
    for f in dataclasses.fields(BasicState):  # the unused fields
        tree.setdefault(f.name, None)
    assert (tree["decor"]["count"] > 0).all()
    ts = state_from_numpy(tree, _torch_game(1), "cpu")
    assert isinstance(ts.game, PlunderState)
    a, b = _flat(tree), _flat(state_to_numpy(ts))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jg = _jax_game(1)
    B = ts.num
    template = jax.eval_shape(
        jax.vmap(lambda sd: jlife.initial_state(jg, sd)),
        jax.ShapeDtypeStruct((B,), jnp.uint32))
    back = serialization.from_state_dict(template, state_to_numpy(ts))
    np.testing.assert_array_equal(np.asarray(back.decor.x), tree["decor"]["x"])
    np.testing.assert_array_equal(np.asarray(back.game.lane_vels),
                                  tree["game"]["lane_vels"])


def test_supports_the_static_decor_path():
    for mode in (0, 1):
        game = _torch_game(mode)
        plan = rk.get_plan(game)
        assert rk.supports(game) and plan.static
        assert plan.z_levels == (0, 1) and plan.dz_levels == (0,)


@pytest.mark.parametrize("entry", ["ProcgenGym3Env", "make_env_fns"])
def test_default_device_is_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    call = {
        "ProcgenGym3Env": lambda: ProcgenGym3Env(num=2, env_name="plunder"),
        "make_env_fns": lambda: make_env_fns(2, "plunder"),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_gym3_env_runs():
    """``ProcgenGym3Env`` plunder keeps the static camera (the game turns
    the centred one off) and its frames are the plain renderer's."""
    env = ProcgenGym3Env(num=2, env_name="plunder", distribution_mode="hard",
                         rand_seed=3, device="cpu")
    game = env._vec.game
    assert not game.center_agent and game.static_prefix
    env.act(np.array([9, 10], np.int32))
    _, obs, _ = env.observe()
    np.testing.assert_array_equal(obs["rgb"], trender_obs(game, env._vec.states, 64).numpy())


if __name__ == "__main__":
    from test_torch_refstate import patch_jax_cpp_arithmetic

    patch_jax_cpp_arithmetic()
    _jax_reference(sys.argv[1], sys.argv[2])
