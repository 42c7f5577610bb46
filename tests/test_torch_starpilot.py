"""The port's starpilot against the JAX package's and the C++ recordings.

* Easy and hard, 4 envs, 64 random steps each, through the pooled runtime
  (easy: ``procgen_tpu_torch.entry.make_env_fns(4, "starpilot")`` against
  ``__graft_entry__._make_env_fns(4, "starpilot")``; hard: the same program
  over the hard game): every ``BasicState`` leaf (``StarpilotState`` with
  its spawner pool, ``rand_gen`` and the decor pool included), the
  next-level pool and its validity, obs, reward and done, bit-equal.  The
  seeds give released spawners, enemy and player bullets, kills with their
  explosions, episode ends and a forced reset.
* The step at t = 500 (the finish line and its theme draw): the last states
  of each run with their clocks set to 499, stepped once, every leaf.
* The frames of every fourth step's states and of the states after each
  episode end, under both cameras, the whole-world camera of
  ``make_env_fns`` and the agent-centred one that ``ProcgenGym3Env``
  defaults to: ``render_kernel.render_obs_batch`` (on CPU tensors,
  ``render_frame_reference``) against the Pallas kernel run in interpret
  mode and against the XLA ``render_obs``; the port's
  ``renderer.render_obs`` against the XLA one; ``prep_frame`` against the
  Pallas kernel's ``_prep_one``.
* The scroll offset ``SF_BGRX`` for every clock from 0 to 1000 against
  ``_prep_one``'s, and the background the plain renderer paints there
  against the JAX package's ``paint_background``, byte for byte.
* starpilot_easy, starpilot_hard and starpilot_extreme replay exactly.
* The bridge carries a starpilot state, spawners included, both ways.

The JAX reference runs once, in two child processes (this file run as a
script, one for each run, while the port runs its own and replays the
recordings) whose XLA is held to AVX (``--xla_cpu_max_isa=AVX``), as in
tests/test_torch_coinrun.py: XLA's CPU backend otherwise contracts ``a * b
+ c`` into a fused multiply-add, which neither the C++ reference nor the
port does.  The children clear the JAX package's atlas and render-plan
caches between the two cameras and trace ``lifecycle.env_reset`` once,
under ``jax.jit``.

The children also hold the JAX package to the C++ arithmetic where C++
evaluates a float expression in double (the agent's velocity decay and
the spawners' headings and velocities):
``test_torch_refstate.patch_jax_cpp_arithmetic`` evaluates those
expressions in f64 and rounds once, in the children only.

Tolerance: zero.
"""

import contextlib
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
from procgen_tpu_torch.core.game import BasicState, tree_map  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.entry import make_env_fns  # noqa: E402
from procgen_tpu_torch.games.starpilot import (  # noqa: E402
    BULLET2, BULLET3, BULLET_PLAYER, CLOUD, FINISH_LINE, FLYER, METEOR, TURRET,
    Starpilot, StarpilotState,
)
from procgen_tpu_torch.parallel.vec import Carry, render_batch, step_pool  # noqa: E402
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402
from procgen_tpu_torch.utils.host_mt import HostMT19937  # noqa: E402

N = 4
STEPS = 64
# run -> (distribution mode, master seed, action seed)
RUNS = {"easy": (0, 7, 0), "hard": (1, 4, 0)}
CAMERAS = ("world", "centred")
SEP = "::"
CLOCKS = 1001  # the scroll offset's inputs: cur_time 0..1000


def _seeds(master_seed):
    m = HostMT19937(master_seed)
    return np.array([m.next_u32() for _ in range(N)], np.int64)


def _actions(action_seed):
    """[STEPS, N] actions, half of them a shot (9, forward; 10, backward)
    or a move; env 2 is forced to reset at step 30."""
    rng = np.random.RandomState(action_seed)
    out = []
    for t in range(STEPS):
        a = np.where(rng.rand(N) < 0.5, rng.choice([9, 9, 10, 1, 7, 3, 5], N),
                     rng.randint(0, 15, N)).astype(np.int32)
        if t == 30:
            a[2] = -1
        out.append(a)
    return np.stack(out)


def _frame_steps(done):
    """Steps whose states are rendered: every fourth, and each one right
    after an episode end (``done`` [STEPS, N]; state t + 1 follows action
    t)."""
    ends = np.flatnonzero(done.any(axis=1)) + 1
    return np.union1d(np.arange(0, STEPS + 1, 4), ends)


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        elif v is not None:
            out[pre + k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# the JAX reference (child process)
# ---------------------------------------------------------------------------


def _jax_game(mode, centred=False):
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game

    game = make_game("starpilot", JGameOptions(distribution_mode=mode,
                                               center_agent=centred))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _jax_env_fns(mode):
    """(init, step) of ``__graft_entry__._make_env_fns(N, "starpilot")`` for
    easy; for hard, the same program over the hard game."""
    from __graft_entry__ import _make_env_fns

    if mode == 0:
        init, step, _ = _make_env_fns(N, "starpilot")
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


def _save_tree(out, key, tree):
    for leaf, v in _flat(serialization.to_state_dict(tree)).items():
        out[SEP.join((key, leaf))] = v


def _jax_reference(out_path, run):
    """Run one program, step its last states at t = 500 and render the
    states of ``_frame_steps``; for easy also the scroll offsets and
    backgrounds of every clock.  Saves the arrays, keyed
    ``run::part::leaf``."""
    from procgen_tpu.core import lifecycle
    from procgen_tpu.render import atlas, pallas_kernel
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

    # the step at t = 500: the last states, their clocks set to 499
    game = _jax_game(mode)
    late = carry[0].replace(cur_time=jnp.full((N,), 499, jnp.int32))
    late, _ = jax.jit(jax.vmap(lambda s, a: lifecycle.env_step(game, s, a)))(
        late, jnp.asarray(_actions(aseed)[0]))
    _save_tree(out, SEP.join((run, "late")), late)

    # the rendered steps' states as one batch, under both cameras
    frame_steps = _frame_steps(out[SEP.join((run, "done"))])
    out[SEP.join((run, "frame_steps"))] = frame_steps
    batch = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs), *[steps[t][0][0] for t in frame_steps])
    for cam in CAMERAS:
        atlas._CACHE.clear()
        pallas_kernel._PLANS.clear()
        game = _jax_game(mode, centred=cam == "centred")
        out[SEP.join((run, cam, "pallas"))] = np.asarray(jax.jit(
            lambda st: pallas_kernel.render_obs_batch(game, st, 64,
                                                      interpret=True)
        )(batch))
        out[SEP.join((run, cam, "xla"))] = np.asarray(
            jax.jit(jax.vmap(lambda s: render_obs(game, s, 64)))(batch))
        plan = pallas_kernel.get_plan(game, 64)
        prep = jax.jit(jax.vmap(lambda s: pallas_kernel._prep_one(plan, s)))(batch)
        for k in ("sf", "si", "cell5", "ent_f", "ent_i", "dec_f", "dec_i"):
            out[SEP.join((run, cam, "prep", k))] = np.asarray(prep[k])

    if run == "easy":
        atlas._CACHE.clear()
        pallas_kernel._PLANS.clear()
        game = _jax_game(mode)
        clocks = jax.vmap(lambda t: jax.tree_util.tree_map(
            lambda x: x[0], steps[0][0][0]).replace(cur_time=t))(
                jnp.arange(CLOCKS, dtype=jnp.int32))
        plan = pallas_kernel.get_plan(game, 64)
        out["clocks::sf"] = np.asarray(jax.jit(jax.vmap(
            lambda s: pallas_kernel._prep_one(plan, s)["sf"]))(clocks))
        _, bg_atlas, _ = atlas.get_atlases(game, 64)
        sx = jnp.arange(64, dtype=jnp.float32) + 0.5
        out["clocks::bg"] = np.asarray(jax.jit(jax.vmap(
            lambda s: game.paint_background(s, 64, sx, sx, bg_atlas)))(clocks))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_children(tmp_path_factory):
    """Start the JAX reference: one child process per run, all at once;
    yields run -> (output path, process, stderr path)."""
    out_dir = tmp_path_factory.mktemp("starpilot")
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


def _torch_game(mode, centred=False):
    game = Starpilot(GameOptions(distribution_mode=mode, center_agent=centred))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _torch_env_fns(mode):
    """(init, step) of ``make_env_fns(N, "starpilot")`` for easy; for hard,
    the same program over the hard game."""
    if mode == 0:
        init, step, _ = make_env_fns(N, "starpilot", device="cpu")
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


def _batch(carries, steps):
    """The states of ``steps`` as one port state batch."""
    return tree_map(lambda *xs: torch.cat(xs), *[carries[t].states for t in steps])


@pytest.fixture(scope="module")
def port(jax_children):
    """Per run: the port's carries (step 0 is the initial one), step
    outputs, the step at t = 500, and per camera the frames of
    ``_frame_steps`` on both of the port's render paths and their
    ``prep_frame``; computed while the JAX reference runs."""
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
            late = carry.states.replace(cur_time=torch.full((N,), 499, dtype=torch.int32))
            late, _ = tlife.env_step(_torch_game(mode), late,
                                     torch.as_tensor(_actions(aseed)[0]))
            steps = _frame_steps(np.stack([o[2].numpy() for o in outs]))
            batch = _batch(carries, steps)
            frames = {}
            for cam in CAMERAS:
                game = _torch_game(mode, centred=cam == "centred")
                frames[cam] = (game, batch, rk.render_obs_batch(game, batch).numpy(),
                               trender_obs(game, batch, 64).numpy(),
                               rk.prep_frame(rk.get_plan(game), batch))
            out[run] = (carries, outs, steps, frames, late)
    return out


REPLAYS = ("starpilot_easy", "starpilot_hard", "starpilot_extreme")


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
    assert isinstance(carries[-1].states.game, StarpilotState)


@pytest.mark.parametrize("run", list(RUNS))
def test_outputs_match(run, ref, port):
    outs = port[run][1]
    for k, name in enumerate(("obs", "reward", "done")):
        got = np.stack([o[k].numpy() for o in outs])
        np.testing.assert_array_equal(got, ref[SEP.join((run, name))], err_msg=name)


@pytest.mark.parametrize("run", list(RUNS))
def test_finish_line_step_matches(run, ref, port):
    """The step at t = 500 pushes the finish line, its theme drawn from
    the step's window, in every env."""
    late = port[run][4]
    prefix = SEP.join((run, "late"))
    want = {k[len(prefix) + len(SEP):]: v for k, v in ref.items()
            if k.startswith(prefix + SEP)}
    got = _flat(state_to_numpy(late))
    assert want.keys() == got.keys()
    for leaf, w in want.items():
        assert got[leaf].dtype == w.dtype, leaf
        np.testing.assert_array_equal(got[leaf], w, err_msg=leaf)
    e = late.ents
    assert ((e.type == FINISH_LINE) & e.active).any(dim=1).all()


def _count(e, type_):
    return (e.active & (e.type == type_)).sum(dim=1)


@pytest.mark.parametrize("run", list(RUNS))
def test_trajectories_reach_the_machinery(run, port):
    """The runs go through what this slice ports: spawners released, enemy
    and player bullets (aimed with atan2), kills with their explosions,
    episode ends (the forced reset among them); on hard, spawners of the
    hard mode's other types."""
    carries, outs = port[run][:2]
    released = kills = 0
    seen = set()
    for c0, c1, o in zip(carries, carries[1:], outs):
        alive = ~o[2]
        g0, g1 = c0.states.game, c1.states.game
        released += int(((g1.spawn_cursor > g0.spawn_cursor) & alive).sum())
        kills += int(((o[1] >= 1) & alive).sum())
        e = c1.states.ents
        for t in (BULLET_PLAYER, BULLET2, BULLET3, FLYER, METEOR, CLOUD, TURRET):
            if bool(_count(e, t).any()):
                seen.add(t)
        if bool(((c1.states.decor.type == EXPLOSION) & c1.states.decor.active).any()):
            seen.add(EXPLOSION)
    assert released >= 4 and kills >= 1
    assert {BULLET_PLAYER, BULLET2, FLYER, EXPLOSION} <= seen
    assert sum(int(o[2].sum()) for o in outs) >= 3
    assert bool(outs[30][2][2])  # the forced reset
    if run == "hard":
        sp = carries[0].states.game.spawners
        types = set(sp.type[sp.active].tolist())
        assert {METEOR, CLOUD, TURRET} & types


def _frames_case(run, cam, ref, port):
    """(game, state batch, kernel-path frames, plain-renderer frames,
    prep) of the rendered steps, which are the JAX reference's."""
    steps, frames = port[run][2:4]
    np.testing.assert_array_equal(steps, ref[SEP.join((run, "frame_steps"))])
    return frames[cam]


@pytest.mark.parametrize("cam", CAMERAS)
@pytest.mark.parametrize("run", list(RUNS))
def test_frames_match_pallas_interpret(run, cam, ref, port):
    got = _frames_case(run, cam, ref, port)[2]
    np.testing.assert_array_equal(got, ref[SEP.join((run, cam, "pallas"))])


@pytest.mark.parametrize("cam", CAMERAS)
@pytest.mark.parametrize("run", list(RUNS))
def test_frames_match_xla_render_obs(run, cam, ref, port):
    """The port's plain renderer equals the XLA renderer, which equals the
    Pallas kernel on these states."""
    plain = _frames_case(run, cam, ref, port)[3]
    want = ref[SEP.join((run, cam, "xla"))]
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(want, ref[SEP.join((run, cam, "pallas"))])


@pytest.mark.parametrize("cam", CAMERAS)
@pytest.mark.parametrize("run", list(RUNS))
def test_prep_matches_pallas_prep(run, cam, ref, port):
    game, batch, _, _, x = _frames_case(run, cam, ref, port)
    plan = rk.get_plan(game)
    assert plan.NC == (19 if cam == "centred" else 16)
    assert plan.bg_mode == rk.BG_SCROLL
    key = SEP.join((run, cam, "prep")) + SEP
    np.testing.assert_array_equal(x.sf.numpy(), ref[key + "sf"])
    np.testing.assert_array_equal(x.si.numpy(), ref[key + "si"][:, :rk.SI_N])
    np.testing.assert_array_equal(x.cell5.numpy(), ref[key + "cell5"])
    for k in ("ent_f", "ent_i", "dec_f", "dec_i"):
        np.testing.assert_array_equal(getattr(x, k).numpy(), ref[key + k],
                                      err_msg=k)
    # bullets at angles off the quarter turns (the rotation bank), decor
    # slots live
    qf = batch.ents.rotation * (2 / np.pi)
    assert (batch.ents.active & (torch.abs(qf - torch.round(qf)) > 1e-4)).any()
    assert (x.dec_i[..., rk.EI_LIVE] > 0).any()
    assert (x.sf[:, rk.SF_BGRX] < 0).any()


def test_scroll_offset_every_clock(ref):
    """``prep_frame``'s ``SF_BGRX`` for cur_time 0..1000 (every value a
    1000-step timeout allows) equals ``_prep_one``'s bit for bit, and the
    plain renderer's background there equals the JAX package's
    ``paint_background`` byte for byte.  XLA computes the offset as
    ``-t * (64 / h) * f32(1 / 5)``; the source's order, ``* 0.5 * 2 /
    5``, gives another value at 199 of the clocks."""
    game = _torch_game(0)
    seeds = torch.as_tensor(_seeds(RUNS["easy"][1]))[:1]  # the easy run's env 0
    s = tlife.env_reset(game, tlife.initial_state(game, seeds))
    clocks = tree_map(lambda v: v.expand((CLOCKS,) + v.shape[1:]).clone(), s)
    clocks = clocks.replace(cur_time=torch.arange(CLOCKS, dtype=torch.int32))
    x = rk.prep_frame(rk.get_plan(game), clocks)
    want = ref["clocks::sf"]
    np.testing.assert_array_equal(x.sf[:, rk.SF_BGRX].numpy(), want[:, rk.SF_BGRX])
    f = np.float32
    t = np.arange(CLOCKS, dtype=f)
    source = -(t * f(4)) * f(0.5) * f(2) / f(5)
    assert (source != want[:, rk.SF_BGRX]).sum() == 199
    # the background alone: the same game and clocks, every sprite cleared
    bare = clocks.replace(ents=clocks.ents.replace(count=torch.zeros_like(clocks.ents.count)))
    from procgen_tpu_torch.render.atlas import get_atlases

    _, bg_atlas, _ = get_atlases(game, 64)
    sx = (torch.arange(64, dtype=torch.float32) + 0.5)[None, :]
    got = game.paint_background(bare, 64, sx, sx, bg_atlas).numpy()
    np.testing.assert_array_equal(got, ref["clocks::bg"])
    assert (got[0] != got[-1]).any()


@pytest.mark.parametrize("name", REPLAYS)
def test_conformance_replay(name, replays):
    rec, res = replays[name]
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == res["steps"] == len(rec["actions"])


def test_bridge_round_trip(ref, port):
    """The JAX state of a step with released spawners and live bullets ->
    the port's state -> numpy, leaf for leaf, and back into a JAX
    BasicState."""
    from procgen_tpu.core import lifecycle as jlife

    prefix = SEP.join(("hard", "states")) + SEP
    cursor = ref[prefix + "game.spawn_cursor"]
    t = int(np.flatnonzero((cursor > 0).all(axis=1))[0])
    tree = {}
    for k, v in ref.items():
        if k.startswith(prefix):
            node = tree
            *path, leaf = k[len(prefix):].split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v[t]
    for f in dataclasses.fields(BasicState):  # the unused fields
        tree.setdefault(f.name, None)
    ts = state_from_numpy(tree, _torch_game(1), "cpu")
    assert isinstance(ts.game, StarpilotState)
    assert ts.game.spawners.x.shape == (N, 288)
    a, b = _flat(tree), _flat(state_to_numpy(ts))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jg = _jax_game(1)
    template = jax.eval_shape(
        jax.vmap(lambda sd: jlife.initial_state(jg, sd)),
        jax.ShapeDtypeStruct((N,), jnp.uint32))
    back = serialization.from_state_dict(template, state_to_numpy(ts))
    np.testing.assert_array_equal(np.asarray(back.game.spawners.spawn_time),
                                  tree["game"]["spawners"]["spawn_time"])
    np.testing.assert_array_equal(np.asarray(back.game.spawn_cursor), cursor[t])


def test_supports_both_cameras():
    for mode in (0, 1, 2):
        for centred in (False, True):
            game = _torch_game(mode, centred)
            assert rk.supports(game) and rk.get_plan(game).bg_mode == rk.BG_SCROLL


@pytest.mark.parametrize("entry", ["ProcgenGym3Env", "make_env_fns"])
def test_default_device_is_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    call = {
        "ProcgenGym3Env": lambda: ProcgenGym3Env(num=2, env_name="starpilot"),
        "make_env_fns": lambda: make_env_fns(2, "starpilot"),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_gym3_env_runs_centred():
    """``ProcgenGym3Env`` starpilot defaults to the centred camera and its
    frames are the plain renderer's."""
    env = ProcgenGym3Env(num=2, env_name="starpilot", distribution_mode="hard",
                         rand_seed=3, device="cpu")
    game = env._vec.game
    assert game.center_agent and rk.get_plan(game).NC == 19
    env.act(np.array([9, 10], np.int32))
    _, obs, _ = env.observe()
    np.testing.assert_array_equal(obs["rgb"], trender_obs(game, env._vec.states, 64).numpy())


if __name__ == "__main__":
    from test_torch_refstate import patch_jax_cpp_arithmetic

    patch_jax_cpp_arithmetic()
    _jax_reference(sys.argv[1], sys.argv[2])
