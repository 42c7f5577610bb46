"""The port's climber against the JAX package's and the C++ recordings.

* Easy and hard, 3 envs, 40 random steps each, an episode's end resetting
  its env at once (both packages' ``env_step``, then ``env_reset`` where
  an env is done): every ``BasicState`` leaf (``ClimberState``, the grid
  of platforms and ``rand_gen`` included), bit-equal.  The seeds give
  jumps, patrolling enemies and a forced reset.
* The frames of every eighth step's states under both cameras: the
  whole world (``make_env_fns``: a 64-cell window) and the game's own
  centred camera (``ProcgenGym3Env``: the world's width in view, a window
  of ``visibility + 3`` = 19 cells).  ``render_kernel.render_obs_batch``
  (on CPU tensors, the plain version of the whole-frame kernel) against
  the Pallas kernel run in interpret mode, the port's
  ``renderer.render_obs`` against the XLA ``render_obs``, and
  ``prep_frame`` against the Pallas kernel's ``_prep_one``.  Hard mode's
  centred view is 20 cells wide, past the 19-cell window: there the XLA
  renderer paints the cells' colors and the Pallas kernel nothing, and
  the port's two paths part the same way (ROADMAP Queue 3).
* Generated assets: 3 envs reset and stepped 4 times, every leaf, and
  the frames of both states against Pallas and XLA.
* climber_easy and climber_hard replay exactly.

The JAX reference runs in one child process (this file run as a script)
for both modes and cameras, while the port runs its own and replays the
recordings; its XLA is held to AVX (``--xla_cpu_max_isa=AVX``): XLA's
CPU backend otherwise contracts ``a * b + c`` into a fused multiply-add,
which neither the C++ reference nor the port does.

Tolerance: zero.
"""

import contextlib
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

from procgen_tpu_torch.bridge import state_to_numpy  # noqa: E402
from procgen_tpu_torch.conformance import replay  # noqa: E402
from procgen_tpu_torch.core import lifecycle as tlife  # noqa: E402
from procgen_tpu_torch.core.constants import INT32_MAX, fnv1a_32  # noqa: E402
from procgen_tpu_torch.core.game import tree_map, tree_where  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.games.climber import (  # noqa: E402
    COIN, ENEMY, Climber, ClimberState,
)
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import center  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402
from procgen_tpu_torch.utils.host_mt import HostMT19937  # noqa: E402

N = 3
STEPS = 40
# run -> (distribution mode, master seed, action seed)
RUNS = {"easy": (0, 21, 0), "hard": (1, 22, 1)}
CAMERAS = ("world", "centred")
GEN_STEPS = 4  # the generated-assets run (easy, the whole world)
SEP = "::"
FORCED = 20  # env 1 is forced to reset at this step


def _seeds(master_seed):
    m = HostMT19937(master_seed)
    return np.array([m.next_u32() for _ in range(N)], np.int64)


def _actions(action_seed, steps=STEPS):
    """[steps, N] actions, most of them a jump to either side or up;
    env 1 is forced to reset at step ``FORCED``."""
    rng = np.random.RandomState(action_seed)
    out = []
    for t in range(steps):
        a = np.where(rng.rand(N) < 0.6, rng.choice([2, 5, 8, 8, 6, 0], N),
                     rng.randint(0, 15, N)).astype(np.int32)
        if t == FORCED:
            a[1] = -1
        out.append(a)
    return np.stack(out)


def _frame_steps():
    return np.arange(0, STEPS + 1, 8)


def _asset_seed():
    return int(np.int32(np.uint32(fnv1a_32("climber"))))


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


def _jax_game(mode, centred=False, generated=False):
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game

    game = make_game("climber", JGameOptions(distribution_mode=mode, center_agent=centred,
                                             use_generated_assets=generated))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    if generated:
        game.fixed_asset_seed = _asset_seed()
    return game


def _jax_reference(out_path):
    """Run both modes and render the states of ``_frame_steps`` under both
    cameras; then the generated-assets run.  Saves the arrays, keyed
    ``run::part::leaf``."""
    from procgen_tpu.core import lifecycle
    from procgen_tpu.parallel.vec import _tree_select
    from procgen_tpu.render import atlas, pallas_kernel
    from procgen_tpu.render.renderer import render_obs

    jax.config.update("jax_platforms", "cpu")
    out = {}

    def frames(key, game, batch):
        # the atlas and plan caches ignore center_agent and the assets
        atlas._CACHE.clear()
        pallas_kernel._PLANS.clear()
        out[SEP.join((key, "pallas"))] = np.asarray(jax.jit(
            lambda st: pallas_kernel.render_obs_batch(game, st, 64, interpret=True)
        )(batch))
        out[SEP.join((key, "xla"))] = np.asarray(
            jax.jit(jax.vmap(lambda st: render_obs(game, st, 64)))(batch))
        plan = pallas_kernel.get_plan(game, 64)
        prep = jax.jit(jax.vmap(lambda st: pallas_kernel._prep_one(plan, st)))(batch)
        for k in ("sf", "si", "cell5", "ent_f", "ent_i"):
            out[SEP.join((key, "prep", k))] = np.asarray(prep[k])

    def run_states(game, seeds, actions, auto_reset):
        init = jax.jit(jax.vmap(lambda sd: lifecycle.initial_state(game, sd)))
        reset = jax.jit(jax.vmap(lambda s: lifecycle.env_reset(game, s)))
        step = jax.jit(jax.vmap(lambda s, a: lifecycle.env_step(game, s, a)))
        s = reset(init(jnp.asarray(seeds, jnp.uint32)))
        states = [s]
        for a in actions:
            s, done = step(s, jnp.asarray(a))
            if auto_reset:
                s = _tree_select(done, reset(s), s)
            states.append(s)
        return states

    def save_states(run, states):
        trees = [_flat(serialization.to_state_dict(st)) for st in states]
        for leaf in trees[0]:
            out[SEP.join((run, "states", leaf))] = np.stack([t[leaf] for t in trees])

    for run, (mode, mseed, aseed) in RUNS.items():
        states = run_states(_jax_game(mode), _seeds(mseed), _actions(aseed), True)
        save_states(run, states)
        batch = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs), *[states[t] for t in _frame_steps()])
        for cam in CAMERAS:
            frames(SEP.join((run, cam)), _jax_game(mode, centred=cam == "centred"), batch)

    game = _jax_game(0, generated=True)
    states = run_states(game, _seeds(23), _actions(2, GEN_STEPS), False)
    save_states("genassets", states)
    frames(SEP.join(("genassets", "world")), game, jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs), states[0], states[-1]))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_child(tmp_path_factory):
    """Start the JAX reference in one child process; yields (output path,
    process, stderr path)."""
    out_dir = tmp_path_factory.mktemp("climber")
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


def _torch_game(mode, centred=False, generated=False):
    game = Climber(GameOptions(distribution_mode=mode, center_agent=centred,
                               use_generated_assets=generated))
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


def _frames(game, batch):
    """(game, state batch, kernel-path frames, plain-renderer frames,
    prep_frame's inputs)."""
    return (game, batch, rk.render_obs_batch(game, batch).numpy(),
            trender_obs(game, batch, 64).numpy(), rk.prep_frame(rk.get_plan(game), batch))


@pytest.fixture(scope="module")
def port(jax_child):
    """Per run: the port's states of every step and, per camera, the
    frames of the rendered states on both of the port's render paths;
    then the generated-assets run's.  Computed while the JAX reference
    runs."""
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
            batch = _cat([states[t] for t in _frame_steps()])
            out[run] = (states, {cam: _frames(_torch_game(mode, cam == "centred"), batch)
                                 for cam in CAMERAS})

        game = _torch_game(0, generated=True)
        s = tlife.env_reset(game, tlife.initial_state(game, torch.as_tensor(_seeds(23))))
        states = [s]
        for a in _actions(2, GEN_STEPS):
            s, _ = tlife.env_step(game, s, torch.as_tensor(a))
            states.append(s)
        out["genassets"] = (states, {"world": _frames(game, _cat([states[0], states[-1]]))})
    return out


REPLAYS = ("climber_easy", "climber_hard")


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


@pytest.mark.parametrize("run", list(RUNS) + ["genassets"])
def test_states_match(run, ref, port):
    states = port[run][0]
    prefix = SEP.join((run, "states")) + SEP
    want = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    got = [_flat(state_to_numpy(t)) for t in states]
    assert set(want) == set(got[0]), set(want) ^ set(got[0])
    for leaf, w in want.items():
        g = np.stack([t[leaf] for t in got])
        assert g.dtype == w.dtype, (run, leaf, g.dtype, w.dtype)
        for t in range(len(got)):
            np.testing.assert_array_equal(g[t], w[t], err_msg=f"{run} step {t}: {leaf}")
    assert isinstance(states[-1].game, ClimberState)


@pytest.mark.parametrize("run", list(RUNS))
def test_trajectories_reach_the_machinery(run, port):
    """The runs jump (the agent rises), hold patrolling enemies and coins,
    and end an episode (the forced reset among them)."""
    states = port[run][0]
    rises = sum(int((s1.ents.y[:, 0] > s0.ents.y[:, 0]).sum())
                for s0, s1 in zip(states, states[1:]))
    assert rises >= 10
    enemy_moves = sum(int(((s1.ents.type == ENEMY) & s1.ents.active
                           & (s1.ents.x != s0.ents.x)).sum())
                      for s0, s1 in zip(states, states[1:]))
    assert enemy_moves >= 10
    assert all(int((s.ents.active & (s.ents.type == COIN)).sum()) >= N for s in states)
    resets = sum(int((s1.cur_time < s0.cur_time).sum()) for s0, s1 in zip(states, states[1:]))
    assert resets >= 1 and int(states[FORCED + 1].cur_time[1]) == 0


def _key(run, cam):
    return SEP.join((run, cam))


CASES = [(run, cam) for run in RUNS for cam in CAMERAS] + [("genassets", "world")]


@pytest.mark.parametrize("run,cam", CASES)
def test_frames_match_pallas_interpret(run, cam, ref, port):
    got = port[run][1][cam][2]
    np.testing.assert_array_equal(got, ref[SEP.join((_key(run, cam), "pallas"))])


@pytest.mark.parametrize("run,cam", CASES)
def test_frames_match_xla_render_obs(run, cam, ref, port):
    """The port's plain renderer equals the XLA renderer.  The XLA renderer
    equals the Pallas kernel except on hard under the centred camera: the
    game's view is the world's width, 20 cells, past the 19-cell window
    (``visibility`` 16 + 3) that both JAX paths draw tiles from, and past
    the window the XLA renderer paints the cells' colors (its pick is
    floor(wxs) over the whole grid) where the Pallas kernel paints
    nothing.  The port's two paths part there the same way (ROADMAP
    Queue 3)."""
    _, _, _, plain, x = port[run][1][cam]
    want = ref[SEP.join((_key(run, cam), "xla"))]
    np.testing.assert_array_equal(plain, want)
    part = (want != ref[SEP.join((_key(run, cam), "pallas"))]).any(axis=-1)
    if (run, cam) != ("hard", "centred"):
        assert not part.any()
        return
    _, _, inside, *_ = rk.grid_lookup(x)
    assert part.any() and not (part & inside.numpy()).any()


@pytest.mark.parametrize("run,cam", CASES)
def test_prep_matches_pallas_prep(run, cam, ref, port):
    game, batch, _, _, x = port[run][1][cam]
    plan = rk.get_plan(game)
    assert not plan.static and plan.NC == (19 if cam == "centred" else 64)
    assert plan.bg_mode == rk.BG_CROP
    key = SEP.join((_key(run, cam), "prep")) + SEP
    np.testing.assert_array_equal(x.sf.numpy(), ref[key + "sf"])
    si = ref[key + "si"][:, :rk.SI_N].copy()
    if run == "genassets":
        # each env reads its own painted canvas: the port's background row
        # is the env's index into the canvases
        assert x.per_env_bg
        si[:, rk.SI_BGROW] = np.arange(si.shape[0])
    np.testing.assert_array_equal(x.si.numpy(), si)
    np.testing.assert_array_equal(x.cell5.numpy(), ref[key + "cell5"])
    for k in ("ent_f", "ent_i"):
        np.testing.assert_array_equal(getattr(x, k).numpy(), ref[key + k], err_msg=k)


@pytest.mark.parametrize("run", list(RUNS))
def test_camera_is_the_games(run, port):
    """Under ``center_agent`` the frame's camera is the game's hook: the
    world's width in view, centred on it, the agent five of its
    half-heights below the centre; the window's origin follows it.  The
    whole-world camera shows the 64-row world."""
    mode = RUNS[run][0]
    _, batch, _, _, x = port[run][1]["centred"]
    w = 16.0 if mode == 0 else 20.0
    cx, cy, vis = center(_torch_game(mode, True), batch)
    assert (cx == w / 2).all() and (vis == w).all()
    assert torch.equal(cy, batch.ents.y[:, 0] + w / 2 - 5 * batch.ents.ry[:, 0])
    assert torch.equal(x.sf[:, rk.SF_VIS], vis)
    assert torch.equal(x.sf[:, rk.SF_LOWX], torch.trunc(cx - (vis / 2 + 1)))
    assert torch.equal(x.sf[:, rk.SF_TOPY], torch.trunc(cy - (vis / 2 + 1)) + 19)
    _, _, _, _, xw = port[run][1]["world"]
    assert (xw.sf[:, rk.SF_VIS] == 64).all()


@pytest.mark.parametrize("name", REPLAYS)
def test_conformance_replay(name, replays):
    rec, res = replays[name]
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == res["steps"] == len(rec["actions"])


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
