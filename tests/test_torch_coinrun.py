"""The port's coinrun against the JAX package's and the C++ recordings.

* Easy and hard, 4 envs, 64 random steps each, through the pooled runtime
  (easy: ``procgen_tpu_torch.entry.make_env_fns(4, "coinrun")`` against
  ``__graft_entry__._make_env_fns(4, "coinrun")``; hard: the same program
  over the hard game): every ``BasicState`` leaf (``CoinrunState``, the
  decor pool, the smart movers' fields and ``rand_gen`` included), the
  next-level pool and its validity, obs, reward and done, bit-equal.  The
  seeds give pit enemies whose trails fill the 96-slot decor pool (and
  overflow it), crate landings, episode ends and a forced reset.
* The frames of every fourth step's states and of the states after each
  episode end (``_frame_steps``; live trails overlap in every one after
  the first), under both cameras, the whole-world camera of
  ``make_env_fns`` and the agent-centred one that ``ProcgenGym3Env``
  defaults to: ``render_kernel.render_obs_batch`` (on
  CPU tensors, ``render_frame_reference``) against the Pallas kernel run in
  interpret mode, the JAX package's production path, and against the XLA
  ``render_obs``; the port's ``renderer.render_obs`` against the XLA one.
* ``prep_frame`` against the Pallas kernel's ``_prep_one`` on those states.
* coinrun_easy, coinrun_hard and coinrun_exploration replay exactly.
* The bridge carries a state with live trails both ways.
* More smart movers than ``MAX_SMART`` (made-up), and the base class's
  continuous velocity update, whose decay C++ takes in double: the
  children evaluate it so (``test_torch_refstate.patch_jax_cpp_arithmetic``,
  in the children only; coinrun's own velocity update does not decay).

The JAX reference runs once, in two child processes (this file run as a
script, one for each run, while the port runs its own and replays the
recordings) whose XLA is held to AVX (``--xla_cpu_max_isa=AVX``).  XLA's
CPU backend otherwise contracts ``a * b + c`` into a fused multiply-add,
which the C++ reference does not do and the port does not do either (the
JAX package guards its RNG against it, procgen_tpu/core/rng.py:410-420).
Left on, it puts coinrun's agent velocity one ulp off within a few dozen
random steps.
The children also clear the JAX package's atlas and render-plan caches
between the two cameras: their keys leave out ``center_agent``
(procgen_tpu/render/atlas.py:241-244, pallas_kernel.py:196-198).  They
trace ``lifecycle.env_reset`` once, under ``jax.jit``: the program calls
it in four places (the initial states, the pool, the in-step resets and
the replenish), and tracing coinrun's level generator is most of a
child's time.

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
from procgen_tpu_torch.core.constants import INT32_MAX  # noqa: E402
from procgen_tpu_torch.core.game import (  # noqa: E402
    BasicAbstractGame, BasicState, tree_map,
)
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.entry import make_env_fns  # noqa: E402
from procgen_tpu_torch.games.coinrun import CRATE, ENEMY, Coinrun, CoinrunState  # noqa: E402
from procgen_tpu_torch.parallel.vec import Carry, render_batch, step_pool  # noqa: E402
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402
from procgen_tpu_torch.utils.host_mt import HostMT19937  # noqa: E402

N = 4
STEPS = 64
# run -> (distribution mode, master seed, action seed); the master seeds'
# levels hold pit enemies
RUNS = {"easy": (0, 1, 0), "hard": (1, 3, 0)}
CAMERAS = ("world", "centred")
SEP = "::"


def _seeds(master_seed):
    m = HostMT19937(master_seed)
    return np.array([m.next_u32() for _ in range(N)], np.int64)


def _actions(action_seed):
    """[STEPS, N] actions, half of them right, jump or right-jump; env 2
    is forced to reset at step 30."""
    rng = np.random.RandomState(action_seed)
    out = []
    for t in range(STEPS):
        a = np.where(rng.rand(N) < 0.5, rng.choice([5, 7, 8, 8], N),
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


def _jax_env_fns(mode):
    """(init, step) of ``__graft_entry__._make_env_fns(N, "coinrun")`` for
    easy; for hard, the same program over the hard game."""
    from __graft_entry__ import _make_env_fns

    if mode == 0:
        init, step, _ = _make_env_fns(N, "coinrun")
        return init, step

    from procgen_tpu.core import lifecycle
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game
    from procgen_tpu.parallel.vec import (
        _tree_select, render_batch as jrender_batch, replenish_pool,
        reset_pending, splice_pool,
    )

    game = make_game("coinrun", JGameOptions(distribution_mode=mode))
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


def _jax_reference(out_path, run):
    """Run one program and render the states of ``_frame_steps``; save the
    arrays, keyed ``run::part::leaf``.  The hard run adds the made-up
    states."""
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
        game = make_game("coinrun", JGameOptions(
            distribution_mode=mode, center_agent=cam == "centred"))
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

    if run == "hard":
        # made-up states: more smart movers than MAX_SMART, and the base
        # class's continuous velocity update
        from procgen_tpu.core.game import BasicAbstractGame

        jg = make_game("coinrun", JGameOptions(distribution_mode=mode))
        live = steps[MADE_UP_STEP][0][0]
        tree = _made_up(jax.tree_util.tree_map(
            np.asarray, serialization.to_state_dict(live)))
        s = serialization.from_state_dict(live, tree)
        for name, fn in (
            ("smart", jg.step_smart_entities_vectorized),
            ("velocity", lambda st: BasicAbstractGame.update_agent_velocity(jg, st)),
        ):
            res = jax.jit(jax.vmap(fn))(s)
            for leaf, v in _flat(serialization.to_state_dict(res)).items():
                out[SEP.join(("made_up", name, leaf))] = v
    np.savez(out_path, **out)


MADE_UP_STEP = 40


def _made_up(tree):
    """A coinrun-hard state dict (numpy leaves, batched) with 24 patrol
    enemies in slots 1-24, more than ``MAX_SMART`` = 16, at made-up
    positions and speeds, and made-up action velocities."""
    rng = np.random.RandomState(9)
    e = {k: v.copy() for k, v in tree["ents"].items()}
    sl = slice(1, 25)
    shape = e["x"][:, sl].shape
    e["type"][:, sl] = ENEMY
    e["smart_step"][:, sl] = True
    e["will_erase"][:, sl] = False
    e["x"][:, sl] = rng.uniform(1.5, 62.5, shape)
    e["y"][:, sl] = rng.uniform(1.5, 40.5, shape)
    e["vx"][:, sl] = rng.choice([-0.15, 0.15, 0.9], shape)
    e["vy"][:, sl] = rng.choice([0.0, 0.0, -0.4], shape)
    e["rx"][:, sl] = e["ry"][:, sl] = 0.5
    e["count"] = np.maximum(e["count"], 25).astype(np.int32)
    out = dict(tree, ents=e)
    n = e["count"].shape[0]
    out["action_vx"] = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    out["action_vy"] = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_children(tmp_path_factory):
    """Start the JAX reference: one child process per run, all at once;
    yields run -> (output path, process, stderr path)."""
    out_dir = tmp_path_factory.mktemp("coinrun")
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
    game = Coinrun(GameOptions(distribution_mode=mode, center_agent=centred))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _torch_env_fns(mode):
    """(init, step) of ``make_env_fns(N, "coinrun")`` for easy; for hard,
    the same program over the hard game."""
    if mode == 0:
        init, step, _ = make_env_fns(N, "coinrun", device="cpu")
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
    outputs, computed while the JAX reference runs."""
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
            out[run] = (carries, outs)
    return out


REPLAYS = ("coinrun_easy", "coinrun_hard", "coinrun_exploration")


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
    carries, _ = port[run]
    _assert_leaves(ref, run, "states", [c.states for c in carries], run)
    _assert_leaves(ref, run, "pool", [c.pool for c in carries], f"{run} pool")
    np.testing.assert_array_equal(
        np.stack([c.valid.numpy() for c in carries]), ref[SEP.join((run, "valid"))])
    assert [c.t for c in carries] == ref[SEP.join((run, "t"))].tolist()
    assert isinstance(carries[-1].states.game, CoinrunState)


@pytest.mark.parametrize("run", list(RUNS))
def test_outputs_match(run, ref, port):
    _, outs = port[run]
    for k, name in enumerate(("obs", "reward", "done")):
        got = np.stack([o[k].numpy() for o in outs])
        np.testing.assert_array_equal(got, ref[SEP.join((run, name))], err_msg=name)


@pytest.mark.parametrize("run", list(RUNS))
def test_trajectories_reach_the_machinery(run, port):
    """The runs go through what this slice ports: trails filling the decor
    pool to its cap, patrol enemies, episode ends (the forced reset among
    them), and, over both runs, crate landings and a coin."""
    carries, outs = port[run]
    decor = np.stack([c.states.decor.count.numpy() for c in carries])
    ents = [c.states.ents for c in carries]
    assert decor.max() >= 72 and (decor > 0).sum() >= STEPS
    assert max(int(((e.type == ENEMY) & e.active).sum()) for e in ents) >= 3
    assert sum(int(o[2].sum()) for o in outs) >= 2
    assert any(bool(c.states.game.is_on_crate.any()) for c in carries) or run == "hard"
    if run == "easy":
        assert decor.max() == 96  # full pool: later trails are dropped
        assert sum(int((o[1] > 0).sum()) for o in outs) >= 1
        assert max(int(((e.type == CRATE) & e.active).sum()) for e in ents) >= 3


def _frames_case(run, cam, ref, port):
    mode = RUNS[run][0]
    carries, outs = port[run]
    steps = ref[SEP.join((run, "frame_steps"))]
    np.testing.assert_array_equal(
        steps, _frame_steps(np.stack([o[2].numpy() for o in outs])))
    return _torch_game(mode, centred=cam == "centred"), _batch(carries, steps)


@pytest.mark.parametrize("cam", CAMERAS)
@pytest.mark.parametrize("run", list(RUNS))
def test_frames_match_pallas_interpret(run, cam, ref, port):
    game, batch = _frames_case(run, cam, ref, port)
    got = rk.render_obs_batch(game, batch).numpy()
    np.testing.assert_array_equal(got, ref[SEP.join((run, cam, "pallas"))])


@pytest.mark.parametrize("cam", CAMERAS)
@pytest.mark.parametrize("run", list(RUNS))
def test_frames_match_xla_render_obs(run, cam, ref, port):
    """The port's plain renderer equals the XLA renderer, and on these
    states the XLA renderer equals the Pallas kernel."""
    game, batch = _frames_case(run, cam, ref, port)
    want = ref[SEP.join((run, cam, "xla"))]
    np.testing.assert_array_equal(want, ref[SEP.join((run, cam, "pallas"))])
    np.testing.assert_array_equal(trender_obs(game, batch, 64).numpy(), want)


@pytest.mark.parametrize("cam", CAMERAS)
@pytest.mark.parametrize("run", list(RUNS))
def test_prep_matches_pallas_prep(run, cam, ref, port):
    game, batch = _frames_case(run, cam, ref, port)
    plan = rk.get_plan(game)
    assert plan.NC == (16 if cam == "centred" else 64)
    x = rk.prep_frame(plan, batch)
    key = SEP.join((run, cam, "prep"))
    np.testing.assert_array_equal(x.sf.numpy(), ref[key + SEP + "sf"])
    np.testing.assert_array_equal(x.si.numpy(), ref[key + SEP + "si"][:, :rk.SI_N])
    np.testing.assert_array_equal(x.cell5.numpy(), ref[key + SEP + "cell5"])
    for k in ("ent_f", "ent_i", "dec_f", "dec_i"):
        np.testing.assert_array_equal(getattr(x, k).numpy(), ref[key + SEP + k],
                                      err_msg=k)
    # live trails at z=0 of the decor pool, drawn with alpha 0.5, two of
    # them on the same pixels of one frame (so their order shows); no
    # colored cell reaches the frame (every valid cell is under an opaque
    # tile), so the XLA and Pallas cell picks cannot part here
    live = x.dec_i[..., rk.EI_LIVE] > 0
    assert live.any() and (x.dec_f[..., rk.EF_ALPHA][live] < 1).all()
    f = x.dec_f
    lo_x, lo_y = f[..., rk.EF_X0], f[..., rk.EF_Y0]
    hi_x, hi_y = lo_x + f[..., rk.EF_W2], lo_y + f[..., rk.EF_H2]
    meet = ((lo_x[:, :, None] < hi_x[:, None, :]) & (lo_x[:, None, :] < hi_x[:, :, None])
            & (lo_y[:, :, None] < hi_y[:, None, :]) & (lo_y[:, None, :] < hi_y[:, :, None]))
    pairs = live[:, :, None] & live[:, None, :] & ~torch.eye(live.shape[1], dtype=torch.bool)
    assert (meet & pairs).any()
    assert not ((x.cell5[:, 3] > 0.5) & (x.gtab >= x.grid_opaque)).any()


@pytest.mark.parametrize("name", ["smart", "velocity"])
def test_made_up_state_matches(name, ref, port):
    """``step_smart_entities_vectorized`` with 24 patrol enemies (the first
    16 in slot order move, the rest keep their fields, as in the JAX
    package) and the base class's ``update_agent_velocity``, on the hard
    run's state at step 40 with made-up movers."""
    carries, _ = port["hard"]
    before = _made_up(state_to_numpy(carries[MADE_UP_STEP].states))
    game = _torch_game(RUNS["hard"][0])
    fn = {
        "smart": game.step_smart_entities_vectorized,
        "velocity": lambda st: BasicAbstractGame.update_agent_velocity(game, st),
    }[name]
    got = _flat(state_to_numpy(fn(state_from_numpy(before, game, "cpu"))))
    prefix = SEP.join(("made_up", name)) + SEP
    want = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    x0, x1 = before["ents"]["x"], got["ents.x"]
    if name == "smart":
        assert (x1[:, 1:17] != x0[:, 1:17]).any(axis=1).all()
        np.testing.assert_array_equal(x1[:, 17:25], x0[:, 17:25])
    else:
        assert (got["ents.vx"][:, 0] != before["ents"]["vx"][:, 0]).any()


@pytest.mark.parametrize("name", REPLAYS)
def test_conformance_replay(name, replays):
    rec, res = replays[name]
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == res["steps"] == len(rec["actions"])


def test_bridge_round_trip(ref, port):
    """The JAX state of a step with live trails -> the port's state ->
    numpy, leaf for leaf, and back into a JAX BasicState."""
    from procgen_tpu.core import lifecycle as jlife
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game

    t = 40
    prefix = SEP.join(("easy", "states")) + SEP
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
    ts = state_from_numpy(tree, _torch_game(0), "cpu")
    assert isinstance(ts.game, CoinrunState) and int(ts.decor.count.max()) > 0
    assert ts.decor.x.dtype == torch.float32 and ts.decor.count.dtype == torch.int32
    a, b = _flat(tree), _flat(state_to_numpy(ts))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jg = make_game("coinrun", JGameOptions(distribution_mode=0))
    template = jax.eval_shape(
        jax.vmap(lambda sd: jlife.initial_state(jg, sd)),
        jax.ShapeDtypeStruct((N,), jnp.uint32))
    back = serialization.from_state_dict(template, state_to_numpy(ts))
    assert int(np.asarray(back.decor.count).max()) > 0
    np.testing.assert_array_equal(np.asarray(back.decor.x), tree["decor"]["x"])


def test_add_decor_and_push_many_drop_past_cap():
    """``add_decor`` appends one decorative entity where asked; a
    ``push_many`` past the decor pool's cap keeps the first records in mask
    order and drops the rest, as sequential pushes do."""
    from procgen_tpu_torch.core.constants import TRAIL
    from procgen_tpu_torch.core.entities import default_fields

    game = _torch_game(0)
    s = tlife.env_reset(game, tlife.initial_state(game, torch.as_tensor(_seeds(1))))
    do = torch.tensor([True, False, True, False])
    f = default_fields(torch.full((N,), 3.0), 2.0, 0.0, 0.0, 0.3, 0.2, TRAIL)
    s2 = game.add_decor(s, f, do=do)
    d0, d1 = s.decor, s2.decor
    assert torch.equal(d1.count, d0.count + do.to(torch.int32))
    for e in range(N):
        if do[e]:
            assert float(d1.x[e, int(d0.count[e])]) == 3.0
    k = 2 * game.DECOR_CAP
    vals = torch.arange(k, dtype=torch.float32).expand(N, k)
    mask = torch.rand(N, k, generator=torch.Generator().manual_seed(0)) < 0.7
    d2 = d0.push_many({"x": vals, "type": TRAIL}, mask)
    seq = d0
    for j in range(k):
        seq = seq.push({"x": vals[:, j], "type": TRAIL}, do=mask[:, j])
    assert int(d2.count.max()) == game.DECOR_CAP
    for name in ("x", "type", "count"):
        assert torch.equal(getattr(d2, name), getattr(seq, name)), name


def test_supports_both_cameras():
    for mode in (0, 1):
        for centred in (False, True):
            assert rk.supports(_torch_game(mode, centred))


@pytest.mark.parametrize("entry", ["ProcgenGym3Env", "make_env_fns"])
def test_default_device_is_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    call = {
        "ProcgenGym3Env": lambda: ProcgenGym3Env(num=2, env_name="coinrun"),
        "make_env_fns": lambda: make_env_fns(2, "coinrun"),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_gym3_env_runs_centred():
    """``ProcgenGym3Env`` coinrun defaults to the centred camera and its
    frames are the plain renderer's."""
    env = ProcgenGym3Env(num=2, env_name="coinrun", distribution_mode="easy",
                         rand_seed=3, device="cpu")
    game = env._vec.game
    assert game.center_agent and rk.get_plan(game).NC == 16
    env.act(np.array([8, 7], np.int32))
    _, obs, _ = env.observe()
    states = env._vec.states
    np.testing.assert_array_equal(obs["rgb"], trender_obs(game, states, 64).numpy())


if __name__ == "__main__":
    from test_torch_refstate import patch_jax_cpp_arithmetic

    patch_jax_cpp_arithmetic()
    _jax_reference(sys.argv[1], sys.argv[2])
