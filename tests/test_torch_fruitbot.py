"""The port's fruitbot against the JAX package's and the C++ recordings.

* Easy and hard, 4 envs, 64 random steps each, through the pooled runtime
  (easy: ``procgen_tpu_torch.entry.make_env_fns(4, "fruitbot")`` against
  ``__graft_entry__._make_env_fns(4, "fruitbot")``; hard: the same program
  over the hard game): every ``BasicState`` leaf (``FruitbotState`` and
  ``rand_gen`` included), the next-level pool and its validity, obs,
  reward and done, bit-equal.  The seeds give bullets stopped by a
  barrier, a lock shot open with its door (hard), episode ends and a
  forced reset.
* The frames of every fourth step's states and of the states after each
  episode end, under both cameras, the whole-world camera of
  ``make_env_fns`` and the agent-centred one that ``ProcgenGym3Env``
  defaults to: ``render_kernel.render_obs_batch`` (on CPU tensors,
  ``render_frame_reference``) against the Pallas kernel run in interpret
  mode and against the XLA ``render_obs``; the port's
  ``renderer.render_obs`` against the XLA one.
* ``prep_frame`` against the Pallas kernel's ``_prep_one`` on those
  states, the tile height ``SF_TILEH`` bit for bit among them.
* The door-width arithmetic of ``_add_walls`` over a dense sweep of its
  draw, against the JAX package's (which XLA rewrites, see
  ``games/fruitbot.py``).
* fruitbot_easy and fruitbot_hard replay exactly.
* The bridge carries a fruitbot state both ways.

The JAX reference runs once, in two child processes (this file run as a
script, one for each run, while the port runs its own and replays the
recordings) whose XLA is held to AVX (``--xla_cpu_max_isa=AVX``), as in
tests/test_torch_coinrun.py: XLA's CPU backend otherwise contracts ``a * b
+ c`` into a fused multiply-add, which neither the C++ reference nor the
port does.  The children clear the JAX package's atlas and render-plan
caches between the two cameras (their keys leave out ``center_agent``)
and trace ``lifecycle.env_reset`` once, under ``jax.jit``.

The children also hold the JAX package to the C++ arithmetic where C++
evaluates a float expression in double (the agent's velocity decay):
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
from procgen_tpu_torch.core import rng as trng  # noqa: E402
from procgen_tpu_torch.core.constants import INT32_MAX  # noqa: E402
from procgen_tpu_torch.core.game import BasicState, tree_map  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.entry import make_env_fns  # noqa: E402
from procgen_tpu_torch.games.fruitbot import (  # noqa: E402
    BAD_OBJ, BARRIER, GOOD_OBJ, LOCK, LOCKED_DOOR, OUT_OF_BOUNDS_WALL, PLAYER_BULLET,
    Fruitbot, FruitbotState,
)
from procgen_tpu_torch.parallel.vec import Carry, render_batch, step_pool  # noqa: E402
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402
from procgen_tpu_torch.utils.host_mt import HostMT19937  # noqa: E402

N = 4
STEPS = 64
# run -> (distribution mode, master seed, action seed)
RUNS = {"easy": (0, 12, 0), "hard": (1, 48, 0)}
CAMERAS = ("world", "centred")
SEP = "::"
# the door sweep: 2048 draws of _add_walls's rand01, door forced on
SWEEP = 2048


def _seeds(master_seed):
    m = HostMT19937(master_seed)
    return np.array([m.next_u32() for _ in range(N)], np.int64)


def _actions(action_seed):
    """[STEPS, N] actions, half of them a shot (9) or a shot's neighbours;
    env 2 is forced to reset at step 30."""
    rng = np.random.RandomState(action_seed)
    out = []
    for t in range(STEPS):
        a = np.where(rng.rand(N) < 0.5, rng.choice([9, 9, 9, 1, 4, 7], N),
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


def _door_constants(mode):
    """(min_pct, lock_pct_w, door_pct_w) of _add_walls."""
    rw, min_pct = (10.0, 0.2) if mode == 0 else (20.0, 0.1)
    return min_pct, 2 * 0.25 / rw, (0.3 * 2 * 3.25) / rw


def _door_counts(words, mode):
    """_add_walls's door count for p01 words, in the JAX source's order
    and in the order XLA computes it (constants folded, the division a
    multiply by the f32 reciprocal); numpy f32."""
    f = np.float32
    min_pct, lock, door = _door_constants(mode)
    m = f(0.2) * (words.astype(f) * f(2.0**-32))
    source = np.ceil((((f(min_pct) + m) + f(0.1)) - f(2 * lock)) / f(door))
    folded = f(f(f(min_pct) + f(0.1)) - f(2 * lock))
    xla = np.ceil((m + folded) * (f(1) / f(door)))
    return source, xla


def _sweep_words(mode):
    """[SWEEP, 4] words for _add_walls's draws: p01 over [0, 1) at 2**-11
    steps plus a per-row offset, the first rows replaced by up to 96 draws
    next to a door-count boundary where the source order and XLA's give
    different counts; w01 and the door side made up."""
    rng = np.random.RandomState(11 + mode)
    p = (np.arange(SWEEP, dtype=np.int64) << 21) + rng.randint(0, 2**21, SWEEP)
    min_pct, lock, door = _door_constants(mode)
    edges = [(k * door - (0.1 - 2 * lock) - min_pct) / 0.2 for k in range(1, 8)]
    near = np.concatenate([np.arange(int(e * 2**32) - 2**20, int(e * 2**32) + 2**20)
                           for e in edges if 0 <= e < 1])
    near = near[(near >= 0) & (near < 2**32)]
    source, xla = _door_counts(near, mode)
    parted = near[source != xla][::8][:96]
    p[:len(parted)] = parted
    rest = rng.randint(0, 2**32, (SWEEP, 3), dtype=np.uint64).astype(np.int64)
    return np.concatenate([p[:, None], rest], axis=1)


def _sweep_rows():
    """The wall heights of the door sweep: every row of the world."""
    return (np.arange(SWEEP) % 60 + 1).astype(np.float32)


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


def _jax_env_fns(mode):
    """(init, step) of ``__graft_entry__._make_env_fns(N, "fruitbot")`` for
    easy; for hard, the same program over the hard game."""
    from __graft_entry__ import _make_env_fns

    if mode == 0:
        init, step, _ = _make_env_fns(N, "fruitbot")
        return init, step

    from procgen_tpu.core import lifecycle
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game
    from procgen_tpu.parallel.vec import (
        _tree_select, render_batch as jrender_batch, replenish_pool,
        reset_pending, splice_pool,
    )

    game = make_game("fruitbot", JGameOptions(distribution_mode=mode))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
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


def _jax_door_sweep(game, state, words):
    """The door (slot count+2) and lock (count+3) of ``_add_walls`` with
    the door forced, for every row of ``words``: [SWEEP, 4] f32 of door x,
    door rx, lock x, lock y."""
    from procgen_tpu.core import rng

    def one(w, ry):
        blk = jnp.zeros((rng.N,), jnp.uint32).at[:4].set(w.astype(jnp.uint32))
        d = rng.Draws(block=blk, twisted=state.rand_gen.mt,
                      cursor=jnp.zeros((), jnp.int32))
        s, _ = game._add_walls(state, d, ry, jnp.bool_(True),
                               0.2 if game.world_w == 10 else 0.1)
        c = state.ents.count
        e = s.ents
        return jnp.stack([e.x[c + 2], e.rx[c + 2], e.x[c + 3], e.y[c + 3]])

    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(words),
                                             jnp.asarray(_sweep_rows())))


def _jax_reference(out_path, run):
    """Run one program and render the states of ``_frame_steps``; save the
    arrays, keyed ``run::part::leaf``."""
    from procgen_tpu.core import lifecycle
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game
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

    # the rendered steps' states as one batch, under both cameras
    frame_steps = _frame_steps(out[SEP.join((run, "done"))])
    out[SEP.join((run, "frame_steps"))] = frame_steps
    batch = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs), *[steps[t][0][0] for t in frame_steps])
    for cam in CAMERAS:
        atlas._CACHE.clear()
        pallas_kernel._PLANS.clear()
        game = make_game("fruitbot", JGameOptions(
            distribution_mode=mode, center_agent=cam == "centred"))
        out[SEP.join((run, cam, "pallas"))] = np.asarray(jax.jit(
            lambda st: pallas_kernel.render_obs_batch(game, st, 64,
                                                      interpret=True)
        )(batch))
        out[SEP.join((run, cam, "xla"))] = np.asarray(
            jax.jit(jax.vmap(lambda s: render_obs(game, s, 64)))(batch))
        plan = pallas_kernel.get_plan(game, 64)
        prep = jax.jit(jax.vmap(lambda s: pallas_kernel._prep_one(plan, s)))(batch)
        for k in ("sf", "si", "cell5", "ent_f", "ent_i"):
            out[SEP.join((run, cam, "prep", k))] = np.asarray(prep[k])

    game = make_game("fruitbot", JGameOptions(distribution_mode=mode))
    first = jax.tree_util.tree_map(lambda x: x[0], steps[0][0][0])
    out[SEP.join((run, "door_sweep"))] = _jax_door_sweep(
        game, first, _sweep_words(mode))
    if run == "easy":
        _jax_placement(out)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_children(tmp_path_factory):
    """Start the JAX reference: one child process per run, all at once;
    yields run -> (output path, process, stderr path)."""
    out_dir = tmp_path_factory.mktemp("fruitbot")
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
    game = Fruitbot(GameOptions(distribution_mode=mode, center_agent=centred))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _torch_env_fns(mode):
    """(init, step) of ``make_env_fns(N, "fruitbot")`` for easy; for hard,
    the same program over the hard game."""
    if mode == 0:
        init, step, _ = make_env_fns(N, "fruitbot", device="cpu")
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


@pytest.fixture(scope="module")
def port(jax_children):
    """Per run: the port's carries (step 0 is the initial one) and step
    outputs, and per camera the frames of ``_frame_steps`` on both of the
    port's render paths and their ``prep_frame``; computed while the JAX
    reference runs."""
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
            steps = _frame_steps(np.stack([o[2].numpy() for o in outs]))
            batch = _batch(carries, steps)
            frames = {}
            for cam in CAMERAS:
                game = _torch_game(mode, centred=cam == "centred")
                frames[cam] = (game, batch, rk.render_obs_batch(game, batch).numpy(),
                               trender_obs(game, batch, 64).numpy(),
                               rk.prep_frame(rk.get_plan(game), batch))
            out[run] = (carries, outs, steps, frames)
    return out


REPLAYS = ("fruitbot_easy", "fruitbot_hard")


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


def _batch(carries, steps):
    """The states of ``steps`` as one port state batch."""
    return tree_map(lambda *xs: torch.cat(xs), *[carries[t].states for t in steps])


def _assert_leaves(ref, run, part, trees, tag):
    want = {k.split(SEP)[2]: v for k, v in ref.items()
            if k.startswith(SEP.join((run, part)) + SEP)}
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
    _assert_leaves(ref, run, "states", [c.states for c in carries], run)
    _assert_leaves(ref, run, "pool", [c.pool for c in carries], f"{run} pool")
    np.testing.assert_array_equal(
        np.stack([c.valid.numpy() for c in carries]), ref[SEP.join((run, "valid"))])
    assert [c.t for c in carries] == ref[SEP.join((run, "t"))].tolist()
    assert isinstance(carries[-1].states.game, FruitbotState)


@pytest.mark.parametrize("run", list(RUNS))
def test_outputs_match(run, ref, port):
    outs = port[run][1]
    for k, name in enumerate(("obs", "reward", "done")):
        got = np.stack([o[k].numpy() for o in outs])
        np.testing.assert_array_equal(got, ref[SEP.join((run, name))], err_msg=name)


def _count(e, type_, extra=None):
    m = e.active & (e.type == type_)
    return (m if extra is None else m & extra).sum(dim=1)


@pytest.mark.parametrize("run", list(RUNS))
def test_trajectories_reach_the_machinery(run, port):
    """The runs go through what this slice ports: bullets fired and stopped
    by a barrier before they expire, episode ends (the forced reset among
    them), and on hard a lock shot open, its door erased with it."""
    carries, outs = port[run][:2]
    stopped = locks_shot = 0
    for c0, c1, o in zip(carries, carries[1:], outs):
        e0, e1 = c0.states.ents, c1.states.ents
        alive = ~o[2]
        # bullets that would live another step, against the old ones a
        # step later
        young = _count(e0, PLAYER_BULLET, (e0.life_time <= 7) & (e0.y < 55))
        stopped += int(((_count(e1, PLAYER_BULLET, e1.life_time >= 1) < young)
                        & alive).sum())
        shot = (_count(e1, LOCK) < _count(e0, LOCK)) & alive
        locks_shot += int(shot.sum())
        assert torch.equal(_count(e1, LOCKED_DOOR)[shot], _count(e0, LOCKED_DOOR)[shot] - 1)
    assert stopped >= 1
    assert sum(int(o[2].sum()) for o in outs) >= 3
    assert bool(outs[30][2][2])  # the forced reset
    if run == "hard":
        assert locks_shot >= 1


def _frames_case(run, cam, ref, port):
    """(game, state batch, kernel-path frames, plain-renderer frames,
    prep) of the rendered steps, which are the JAX reference's."""
    _, _, steps, frames = port[run]
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
    """The port's plain renderer equals the XLA renderer.  The XLA renderer
    equals the Pallas kernel except on hard under the centred camera: its
    20-cell view is wider than the 19-cell window (visibility 16 + 3) that
    both JAX paths draw tiles from, and past the window, where the world
    ends, the XLA renderer paints the out-of-bounds wall's colored cell
    (its pick is floor(wxs) over the whole grid) and the Pallas kernel
    paints nothing (its pick is the window's).  The port's two paths part
    there the same way (ROADMAP Queue 3)."""
    game, batch, _, plain, x = _frames_case(run, cam, ref, port)
    want = ref[SEP.join((run, cam, "xla"))]
    np.testing.assert_array_equal(plain, want)
    part = (want != ref[SEP.join((run, cam, "pallas"))]).any(axis=-1)
    if (run, cam) != ("hard", "centred"):
        assert not part.any()
        return
    _, _, inside, *_ = rk.grid_lookup(x)
    _, r, g, b = game.grid_cell_colors(batch, torch.tensor(OUT_OF_BOUNDS_WALL), 0.5, 0.5)
    assert part.any() and not (part & inside.numpy()).any()
    assert (want[part] == np.array([int(r), int(g), int(b)])).all()


@pytest.mark.parametrize("cam", CAMERAS)
@pytest.mark.parametrize("run", list(RUNS))
def test_prep_matches_pallas_prep(run, cam, ref, port):
    game, _, _, _, x = _frames_case(run, cam, ref, port)
    plan = rk.get_plan(game)
    assert plan.NC == (19 if cam == "centred" else 60)
    assert plan.bg_mode == rk.BG_TILED
    key = SEP.join((run, cam, "prep"))
    np.testing.assert_array_equal(x.sf.numpy(), ref[key + SEP + "sf"])
    np.testing.assert_array_equal(x.si.numpy(), ref[key + SEP + "si"][:, :rk.SI_N])
    np.testing.assert_array_equal(x.cell5.numpy(), ref[key + SEP + "cell5"])
    for k in ("ent_f", "ent_i"):
        np.testing.assert_array_equal(getattr(x, k).numpy(), ref[key + SEP + k],
                                      err_msg=k)
    # the whole-world camera's easy rect is 6 wide tiles high, give or take
    # an ulp; the tile height splits the rect into whole tiles
    tile_h, mr_h = x.sf[:, rk.SF_TILEH], x.sf[:, rk.SF_MRH]
    assert (tile_h > 0).all() and (tile_h <= mr_h).all()
    # barriers tiled across, the agent on its quarter turn
    live = x.ent_i[..., rk.EI_LIVE] > 0
    assert (x.ent_i[..., rk.EI_TILEH][live] > 0).any()
    assert (x.ent_i[..., rk.EI_PFLIP][:, 0] > 0).all()


@pytest.mark.parametrize("run", list(RUNS))
def test_door_arithmetic_matches(run, ref, port):
    """_add_walls's door and lock, door forced, over 2048 draws of its
    width roll and every wall height: the port computes them in the order
    XLA computes the JAX package's code (``min_pct + m + .1 - c`` folded
    to ``m + f32(min_pct + .1 - c)``, ``y - .45 + .3`` to ``y + f32(.3 -
    .45)``, ``/ door_pct_w`` made a multiply by the f32 reciprocal), bit
    for bit.  The sweep holds rows where the source order gives another
    lock y and another door count."""
    mode = RUNS[run][0]
    game = _torch_game(mode)
    raw = _sweep_words(mode)
    source, xla = _door_counts(raw[:, 0], mode)
    assert (source != xla).any()
    f = np.float32
    ry = _sweep_rows()
    assert ((ry - f(0.45)) + f(0.3) != ry + f(f(0.3) - f(0.45))).any()
    words = torch.as_tensor(raw)
    d = trng.Draws(block=words, twisted=torch.zeros((SWEEP, trng.N), dtype=torch.int64),
                   cursor=torch.zeros((SWEEP,), dtype=torch.int32))
    _, recs = game._wall_records(d, torch.as_tensor(_sweep_rows()),
                                 torch.ones((SWEEP,), dtype=torch.bool),
                                 0.2 if mode == 0 else 0.1)
    got = torch.stack([recs[2]["x"], recs[2]["rx"], recs[3]["x"],
                       recs[3]["y"]], dim=1).numpy()
    np.testing.assert_array_equal(got, ref[SEP.join((run, "door_sweep"))])


@pytest.mark.parametrize("name", REPLAYS)
def test_conformance_replay(name, replays):
    rec, res = replays[name]
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == res["steps"] == len(rec["actions"])


def test_bridge_round_trip(ref, port):
    """The JAX state of a step with live bullets -> the port's state ->
    numpy, leaf for leaf, and back into a JAX BasicState."""
    from procgen_tpu.core import lifecycle as jlife
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game

    prefix = SEP.join(("hard", "states")) + SEP
    types = ref[prefix + "ents.type"]
    t = int(np.flatnonzero((types == PLAYER_BULLET).any(axis=(1, 2)))[0])
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
    assert isinstance(ts.game, FruitbotState)
    assert ts.game.last_fire_time.dtype == torch.int32
    a, b = _flat(tree), _flat(state_to_numpy(ts))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jg = make_game("fruitbot", JGameOptions(distribution_mode=1))
    template = jax.eval_shape(
        jax.vmap(lambda sd: jlife.initial_state(jg, sd)),
        jax.ShapeDtypeStruct((N,), jnp.uint32))
    back = serialization.from_state_dict(template, state_to_numpy(ts))
    np.testing.assert_array_equal(np.asarray(back.game.last_fire_time),
                                  tree["game"]["last_fire_time"])
    np.testing.assert_array_equal(np.asarray(back.ents.type), types[t])


def _crowded_states():
    """Four easy reset states of the port with their good and bad objects
    taken out, each set for one path of ``_place_objects``: env 0 walled in
    whole by its first barrier (every object gives up after 100 tries, and
    four of them use up more than one peeked window); env 1 left a strip
    0.6 wide at the right edge (long rejection runs that refresh the window,
    and give up once the strip fills); env 2 with its stream 4 words before
    the end of an MT block; env 3 as reset.  Returns (game, state,
    num_good, num_bad)."""
    game = _torch_game(0)
    s = tlife.env_reset(game, tlife.initial_state(game, torch.as_tensor(_seeds(12))))
    e = s.ents
    obj = e.active & ((e.type == GOOD_OBJ) | (e.type == BAD_OBJ))
    x, y, rx, ry = e.x.clone(), e.y.clone(), e.rx.clone(), e.ry.clone()
    assert e.type[0, 1] == BARRIER and e.type[1, 1] == BARRIER
    x[0, 1], y[0, 1], rx[0, 1], ry[0, 1] = 5.0, 30.0, 6.0, 31.0
    x[1, 1], y[1, 1], rx[1, 1], ry[1, 1] = 0.0, 30.0, 8.4, 31.0
    pos = s.rand_gen.pos.clone()
    pos[2] = trng.N - 4
    count = e.count - obj.sum(dim=1, dtype=torch.int32)
    assert torch.equal(obj, e.active & (torch.arange(e.cap)[None, :] >= count[:, None]))
    s = s.replace(ents=e.replace(count=count, x=x, y=y, rx=rx, ry=ry),
                  rand_gen=s.rand_gen.replace(pos=pos))
    return game, s, torch.tensor([2, 19, 14, 10]), torch.tensor([2, 19, 17, 12])


def _jax_placement(out):
    """The JAX package's object placement (``Fruitbot.game_reset``'s loop:
    ``reposition`` for every object, pushed where ``i < num``) on the
    states of ``_crowded_states``, carried across by the bridge; saves the
    resulting state's leaves, keyed ``placement::leaf``."""
    from procgen_tpu.core import lifecycle
    from procgen_tpu.core.entities import default_fields
    from procgen_tpu.core.game import tree_where
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game

    game = make_game("fruitbot", JGameOptions(distribution_mode=0))
    _, s, num_good, num_bad = _crowded_states()
    template = jax.eval_shape(
        jax.vmap(lambda sd: lifecycle.initial_state(game, sd)),
        jax.ShapeDtypeStruct((N,), jnp.uint32))
    batch = serialization.from_state_dict(template, state_to_numpy(s))

    def place(s, kind, do):
        fields = default_fields(0.0, 0.0, 0.0, 0.0, 0.5, 0.5, kind)
        s2, fields2 = game.reposition(s, fields, 0.0, 0.0, float(game.world_w),
                                      60.0, True)
        return tree_where(do, s2.replace(ents=s2.ents.push(fields2)), s)

    place = jax.jit(jax.vmap(place, in_axes=(0, None, 0)))
    for kind, num in ((GOOD_OBJ, num_good), (BAD_OBJ, num_bad)):
        for i in range(19):  # the JAX loop's cap
            batch = place(batch, jnp.int32(kind), jnp.asarray(i < num.numpy()))
    for leaf, v in _flat(serialization.to_state_dict(batch)).items():
        out[SEP.join(("placement", leaf))] = v


def test_placement_matches_reposition(ref, monkeypatch):
    """``_place_objects`` against the JAX package's ``reposition`` on the
    same streams, where placements give up after 100 tries and where the
    rejection runs outgrow the peeked window: every state leaf bit-equal."""
    game, s, num_good, num_bad = _crowded_states()
    peeks = []
    peek_block = trng.peek_block
    monkeypatch.setattr(trng, "peek_block",
                        lambda *a, **k: peeks.append(a[1]) or peek_block(*a, **k))
    with _one_thread():
        got = game._place_objects(s, num_good, num_bad)
    assert peeks.count(trng.N) >= 3  # the first window and two refreshes at least
    e = got.ents
    placed = e.active & ~s.ents.active
    assert torch.equal(placed.sum(dim=1), (num_good + num_bad).to(torch.int64))
    # env 0 gave up on each of its 4 objects: 101 tries of 2 words
    drawn = int(got.rand_gen.pos[0] - s.rand_gen.pos[0]) % trng.N
    assert drawn == 4 * 101 * 2 % trng.N
    want = {k.split(SEP)[1]: v for k, v in ref.items() if k.startswith("placement" + SEP)}
    have = _flat(state_to_numpy(got))
    assert want.keys() == have.keys()
    for leaf, w in want.items():
        assert have[leaf].dtype == w.dtype, leaf
        np.testing.assert_array_equal(have[leaf], w, err_msg=leaf)


def test_supports_both_cameras():
    for mode in (0, 1):
        for centred in (False, True):
            game = _torch_game(mode, centred)
            assert rk.supports(game) and rk.get_plan(game).bg_mode == rk.BG_TILED


@pytest.mark.parametrize("entry", ["ProcgenGym3Env", "make_env_fns"])
def test_default_device_is_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    call = {
        "ProcgenGym3Env": lambda: ProcgenGym3Env(num=2, env_name="fruitbot"),
        "make_env_fns": lambda: make_env_fns(2, "fruitbot"),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_gym3_env_runs_centred():
    """``ProcgenGym3Env`` fruitbot defaults to the centred camera and its
    frames are the plain renderer's."""
    env = ProcgenGym3Env(num=2, env_name="fruitbot", distribution_mode="easy",
                         rand_seed=3, device="cpu")
    game = env._vec.game
    assert game.center_agent and rk.get_plan(game).NC == 19
    env.act(np.array([9, 7], np.int32))
    _, obs, _ = env.observe()
    states = env._vec.states
    np.testing.assert_array_equal(obs["rgb"], trender_obs(game, states, 64).numpy())


if __name__ == "__main__":
    from test_torch_refstate import patch_jax_cpp_arithmetic

    patch_jax_cpp_arithmetic()
    _jax_reference(sys.argv[1], sys.argv[2])
