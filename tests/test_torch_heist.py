"""The port's heist against the JAX package's and the C++ recordings.

* Easy, hard and memory, 3 envs, 40 random steps each, an episode's end
  resetting its env at once (both packages' ``env_step``, then
  ``env_reset`` where an env is done), env 1 forced to reset at step 20:
  every ``BasicState`` leaf (``HeistState``, the maze, the keys, doors,
  exit and key ring, ``rand_gen`` included), bit-equal.
* ``levelgen.maze.generate_maze_with_doors`` against the JAX function on
  64 seeded streams for every maze size the modes draw (5 to 23 cells,
  each in the smallest world that holds it: 9, 13 or 23 cells), 16
  streams asking for each door count from 0 to 3, each stream first
  advanced by 0 to 623 words: the grid, the doors placed and the stream
  after it, bit-equal.
* ``env_step`` twice on made-up scenes, every leaf of both steps
  bit-equal: a locked door that blocks the agent (env 0); a key picked up
  under the agent, whose door then opens as the agent walks into it
  (env 1); the exit under the agent (env 2: its reward assigned, the
  level complete).  The frames of the scenes' states, the key ring's key
  drawn once its key is held.
* The frames of every tenth step's states, and of the same states with
  every key held (the key ring drawn in screen coordinates, above the
  world, a quarter turn), under the static camera (easy, hard) and
  memory mode's centred one (11 cells), the agent in its 8 facings:
  ``render_kernel.render_obs_batch`` (on CPU tensors, the plain version
  of the whole-frame kernel) against the Pallas kernel run in interpret
  mode, the port's ``renderer.render_obs`` against the XLA
  ``render_obs``, and ``prep_frame`` against the Pallas kernel's
  ``_prep_one``.
* Generated assets: 3 envs reset and stepped 4 times, every leaf, and
  the frames of both states against Pallas and XLA.
* heist_easy, heist_hard, heist_exploration (hard mode on one fixed
  level, through ``ProcgenGym3Env``'s mapping) and heist_memory replay
  exactly.

The JAX reference runs in one child process (this file run as a script)
for every mode, while the port runs its own and replays the recordings;
its XLA is held to AVX (``--xla_cpu_max_isa=AVX``), and it takes the C++
arithmetic of ``test_torch_refstate.patch_jax_cpp_arithmetic`` (the
agent's velocity decay in f64; the key ring's radius a C++ float).

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

from procgen_tpu_torch import ProcgenGym3Env  # noqa: E402
from procgen_tpu_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from procgen_tpu_torch.conformance import replay  # noqa: E402
from procgen_tpu_torch.core import lifecycle as tlife  # noqa: E402
from procgen_tpu_torch.core import rng as trng  # noqa: E402
from procgen_tpu_torch.core.constants import INT32_MAX, SPACE, fnv1a_32  # noqa: E402
from procgen_tpu_torch.core.game import tree_map, tree_where  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.games.heist import (  # noqa: E402
    EXIT, KEY, KEY_ON_RING, LOCKED_DOOR, RING_KEY_R, Heist, HeistState,
)
from procgen_tpu_torch.levelgen import maze as tmaze  # noqa: E402
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402
from procgen_tpu_torch.utils.host_mt import HostMT19937  # noqa: E402

N = 3
STEPS = 40
# run -> (distribution mode, master seed, action seed)
RUNS = {"easy": (0, 71, 0), "hard": (1, 72, 1), "memory": (10, 73, 2)}
# generate_maze_with_doors's cases: (world size, maze size), every maze
# size a mode can draw, each in the smallest world that holds it
MAZES = [(9, 5), (9, 7), (9, 9), (13, 11), (13, 13), (23, 15), (23, 17), (23, 19),
         (23, 21), (23, 23)]
GEN_STEPS = 4  # the generated-assets run (easy)
MAZE_SEEDS = 64
SEP = "::"
FORCED = 20  # env 1 is forced to reset at this step
RIGHT = 7  # move action: vx = 1, vy = 0


def _seeds(master_seed, n=N):
    m = HostMT19937(master_seed)
    return np.array([m.next_u32() for _ in range(n)], np.int64)


def _actions(action_seed, steps=STEPS):
    """[steps, N] actions, most of them moves in the 8 directions; env 1
    is forced to reset at step ``FORCED``."""
    rng = np.random.RandomState(action_seed)
    out = []
    for t in range(steps):
        a = np.where(rng.rand(N) < 0.85, rng.choice([0, 1, 2, 3, 5, 6, 7, 8], N),
                     rng.randint(0, 15, N)).astype(np.int32)
        if t == FORCED:
            a[1] = -1
        out.append(a)
    return np.stack(out)


def _frame_steps():
    return np.arange(0, STEPS + 1, 10)


def _asset_seed():
    return int(np.int32(np.uint32(fnv1a_32("heist"))))


def _maze_offsets(i):
    return np.random.RandomState(5 + i).randint(0, 624, MAZE_SEEDS).astype(np.int32)


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        elif v is not None:
            out[pre + k] = np.asarray(v)
    return out


def _unflat(flat):
    """The nested state dict of ``_flat``'s leaves (None where a field had
    none)."""
    import dataclasses

    from procgen_tpu_torch.core.game import BasicState

    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    for f in dataclasses.fields(BasicState):
        out.setdefault(f.name, None)
    return out


def _leaves(ref, prefix):
    prefix = prefix + SEP
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# the made-up scenes (an easy reset state, edited)
# ---------------------------------------------------------------------------


def _ent(e, env, slot, x, y, type_, rx, ry, theme=0, **extra):
    fields = dict(x=x, y=y, vx=0.0, vy=0.0, rx=rx, ry=ry, type=type_, image_type=type_,
                  image_theme=theme, smart_step=False, will_erase=False, alpha=1.0,
                  grow_rate=1.0, friction=1.0, auto_erase=True, expire_time=-1,
                  rotation=0.0, render_z=0, use_abs_coords=False)
    fields.update(extra)
    for k, v in fields.items():
        e[k][env, slot] = v


def _scene(tree, key_ar):
    """Edit a 3-env heist reset state (``serialization.to_state_dict``
    leaves as numpy) into the scenes of the module docstring: an open
    world, the agent at (2.5, 4.5), at rest."""
    e, g = tree["ents"], tree["game"]
    tree["grid"][:] = SPACE
    g["has_keys"][:] = False
    for env in range(N):
        _ent(e, env, 0, 2.5, 4.5, 0, 0.375, 0.375, smart_step=True, render_z=1)
    # env 0: a locked blue door to the right
    _ent(e, 0, 1, 3.5, 4.5, LOCKED_DOOR, 0.5, 0.5, theme=0)
    e["count"][0] = 2
    # env 1: the green door to the right, its key under the agent, and the
    # key ring's green key
    _ent(e, 1, 1, 3.5, 4.5, LOCKED_DOOR, 0.5, 0.5, theme=1)
    _ent(e, 1, 2, 2.5, 4.5, KEY, 0.375, np.float32(0.375) / key_ar[1], theme=1)
    _ent(e, 1, 3, np.float32(1 - RING_KEY_R * 3.25), np.float32(RING_KEY_R * 0.75),
         KEY_ON_RING, RING_KEY_R, np.float32(RING_KEY_R) / key_ar[1], theme=1,
         image_type=KEY, rotation=np.float32(np.pi / 2), render_z=1, use_abs_coords=True)
    e["count"][1] = 4
    # env 2: the exit under the agent
    _ent(e, 2, 1, 2.5, 4.5, EXIT, 0.375, 0.375)
    e["count"][2] = 2
    return tree


def _held(tree):
    """The state dict with every key held (the key ring drawn)."""
    tree = jax.tree_util.tree_map(np.array, tree)
    tree["game"]["has_keys"][:] = True
    return tree


# ---------------------------------------------------------------------------
# the JAX reference (child process)
# ---------------------------------------------------------------------------


def _jax_game(mode, generated=False):
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game

    game = make_game("heist", JGameOptions(distribution_mode=mode,
                                           use_generated_assets=generated))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    if generated:
        game.fixed_asset_seed = _asset_seed()
    return game


def _jax_reference(out_path):
    """Every mode's run and the frames of ``_frame_steps`` (as they are
    and with every key held); the mazes; the scenes; then the
    generated-assets run.  Saves the arrays, keyed ``run::part::leaf``."""
    from procgen_tpu.core import lifecycle
    from procgen_tpu.core import rng as jrng
    from procgen_tpu.levelgen import maze as jmaze
    from procgen_tpu.parallel.vec import _tree_select
    from procgen_tpu.render import atlas, pallas_kernel
    from procgen_tpu.render.renderer import render_obs

    jax.config.update("jax_platforms", "cpu")
    out = {}

    def frames(parts, game, *states):
        """The frames and Pallas prep of ``states`` (batches, rendered as
        one), split into ``parts``: (key, batch size) each."""
        batch = jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs), *states)
        atlas._CACHE.clear()
        pallas_kernel._PLANS.clear()
        plan = pallas_kernel.get_plan(game, 64)

        def xla_and_prep(st):
            prep = pallas_kernel._prep_one(plan, st)
            return {"xla": render_obs(game, st, 64), **{
                "prep" + SEP + k: prep[k] for k in ("sf", "si", "cell5", "ent_f", "ent_i")}}

        arrays = {"pallas": jax.jit(
            lambda st: pallas_kernel.render_obs_batch(game, st, 64, interpret=True)
        )(batch), **jax.jit(jax.vmap(xla_and_prep))(batch)}
        at = 0
        for key, size in parts:
            for name, v in arrays.items():
                out[SEP.join((key, name))] = np.asarray(v[at:at + size])
            at += size

    def run_states(game, seeds, actions, auto_reset):
        init = jax.jit(jax.vmap(lambda sd: lifecycle.initial_state(game, sd)))
        reset = jax.jit(jax.vmap(lambda s: lifecycle.env_reset(game, s)))
        step = jax.jit(jax.vmap(lambda s, a: lifecycle.env_step(game, s, a)))
        # every state as host arrays: their types carry no weak flags, so
        # that each program is traced and compiled once
        host = lambda st: jax.tree_util.tree_map(np.asarray, st)  # noqa: E731
        s = host(reset(host(init(jnp.asarray(seeds, jnp.uint32)))))
        states = [s]
        for a in actions:
            s, done = step(s, jnp.asarray(a))
            if auto_reset:
                s = _tree_select(done, reset(s), s)
            s = host(s)
            states.append(s)
        return states, step

    def save(key, st):
        for leaf, v in _flat(serialization.to_state_dict(st)).items():
            out[SEP.join((key, leaf))] = v

    def save_states(run, states):
        trees = [_flat(serialization.to_state_dict(st)) for st in states]
        for leaf in trees[0]:
            out[SEP.join((run, "states", leaf))] = np.stack([t[leaf] for t in trees])

    def with_held(batch):
        tree = serialization.to_state_dict(batch)
        both = [tree, _held(jax.tree_util.tree_map(np.asarray, tree))]
        return serialization.from_state_dict(batch, jax.tree_util.tree_map(
            lambda *xs: np.concatenate(xs), *both))

    nf = len(_frame_steps()) * N
    runs = {}
    for run, (mode, mseed, aseed) in RUNS.items():
        game = _jax_game(mode)
        states, step = run_states(game, _seeds(mseed), _actions(aseed), True)
        save_states(run, states)
        batch = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs), *[states[t] for t in _frame_steps()])
        runs[run] = (game, step, states[0], with_held(batch))

    for i, wd in enumerate(sorted({wd for wd, _ in MAZES})):
        sizes = [md for w, md in MAZES if w == wd]
        g = jax.vmap(jrng.seed)(jnp.asarray(_seeds(60 + i, MAZE_SEEDS), jnp.uint32))
        g, _ = jax.vmap(lambda st, k: jrng.draw_n(st, jrng.N, k))(
            g, jnp.asarray(_maze_offsets(i)))
        fn = jax.jit(jax.vmap(lambda st, md, nd: jmaze.generate_maze_with_doors(
            st, md, wd, nd)))
        doors = jnp.arange(MAZE_SEEDS, dtype=jnp.int32) % 4
        for md in sizes:
            res = fn(g, jnp.full((MAZE_SEEDS,), md, jnp.int32), doors)
            for k, v in zip(("mt", "pos", "grid", "doors"),
                            (res[0].mt, res[0].pos, res[1], res[2])):
                out[SEP.join(("maze", str(md), str(wd), k))] = np.asarray(v)

    # the scenes: easy's reset state, edited, and easy's step
    game, step, s0, _ = runs["easy"]
    tree = jax.tree_util.tree_map(np.array, serialization.to_state_dict(s0))
    s_in = serialization.from_state_dict(s0, _scene(tree, np.asarray(game.aspect_ratios(KEY))))
    act = jnp.full((N,), RIGHT, jnp.int32)
    s1, done1 = step(s_in, act)
    s2, done2 = step(s1, act)
    for part, st in (("in", s_in), ("out1", s1), ("out2", s2)):
        save(SEP.join(("scene", part)), st)
    out[SEP.join(("scene", "done1"))] = np.asarray(done1)
    out[SEP.join(("scene", "done2"))] = np.asarray(done2)

    for run, (game, _, _, held) in runs.items():
        parts = [(SEP.join((run, "frames")), 2 * nf)]
        if run == "easy":
            frames(parts + [(SEP.join(("scene", "frames")), 3 * N)], game, held, s_in, s1, s2)
        else:
            frames(parts, game, held)

    game = _jax_game(0, generated=True)
    states, _ = run_states(game, _seeds(23), _actions(2, GEN_STEPS), False)
    save_states("genassets", states)
    frames([(SEP.join(("genassets", "frames")), 2 * N)], game, states[0], states[-1])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_child(tmp_path_factory):
    """Start the JAX reference in one child process; yields (output path,
    process, stderr path)."""
    out_dir = tmp_path_factory.mktemp("heist")
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
    game = Heist(GameOptions(distribution_mode=mode, use_generated_assets=generated))
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


def _with_held(batch):
    """The batch twice: as it is, then with every key held."""
    held = batch.replace(game=batch.game.replace(
        has_keys=torch.ones_like(batch.game.has_keys)))
    return _cat([batch, held])


def _frames(game, batch):
    """(game, state batch, kernel-path frames, plain-renderer frames,
    prep_frame's inputs)."""
    return (game, batch, rk.render_obs_batch(game, batch).numpy(),
            trender_obs(game, batch, 64).numpy(), rk.prep_frame(rk.get_plan(game), batch))


@pytest.fixture(scope="module")
def port(jax_child):
    """Per run: the port's states of every step and the frames of the
    rendered states on both of the port's render paths; the mazes; then
    the generated-assets run's.  Computed while the JAX reference runs."""
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
            batch = _with_held(_cat([states[t] for t in _frame_steps()]))
            out[run] = (states, _frames(game, batch))

        for i, wd in enumerate(sorted({wd for wd, _ in MAZES})):
            g = trng.seed(torch.as_tensor(_seeds(60 + i, MAZE_SEEDS)))
            g, _ = trng.draw_n(g, trng.N, torch.as_tensor(_maze_offsets(i)))
            doors = torch.arange(MAZE_SEEDS, dtype=torch.int32) % 4
            for md in [m for w, m in MAZES if w == wd]:
                stats = {}
                res = tmaze.generate_maze_with_doors(
                    g, torch.full((MAZE_SEEDS,), md, dtype=torch.int32), wd, doors, stats)
                out[("maze", md, wd)] = dict(zip(
                    ("mt", "pos", "grid", "doors"), (res[0].mt, res[0].pos) + res[1:]))
                out[("maze", md, wd)]["rounds"] = stats["rounds"]

        game = _torch_game(0, generated=True)
        s = tlife.env_reset(game, tlife.initial_state(game, torch.as_tensor(_seeds(23))))
        states = [s]
        for a in _actions(2, GEN_STEPS):
            s, _ = tlife.env_step(game, s, torch.as_tensor(a))
            states.append(s)
        out["genassets"] = (states, _frames(game, _cat([states[0], states[-1]])))
    return out


REPLAYS = ("heist_easy", "heist_hard", "heist_exploration", "heist_memory")


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
    want = _leaves(ref, SEP.join((run, "states")))
    got = [_flat(state_to_numpy(t)) for t in states]
    assert set(want) == set(got[0]), set(want) ^ set(got[0])
    for leaf, w in want.items():
        g = np.stack([t[leaf] for t in got])
        assert g.dtype == w.dtype, (run, leaf, g.dtype, w.dtype)
        for t in range(len(got)):
            np.testing.assert_array_equal(g[t], w[t], err_msg=f"{run} step {t}: {leaf}")
    assert isinstance(states[-1].game, HeistState)


@pytest.mark.parametrize("run", list(RUNS))
def test_trajectories_reach_the_machinery(run, port):
    """The runs move the agent, face it in several of the 8 directions,
    hold levels with doors and the key ring's keys, and end an episode
    (the forced reset among them)."""
    states = port[run][0]
    moves = sum(int((s1.ents.x[:, 0] != s0.ents.x[:, 0]).sum())
                for s0, s1 in zip(states, states[1:]))
    assert moves >= 40
    facings = {round(float(r) / (np.pi / 4)) % 8 for s in states for r in s.ents.rotation[:, 0]}
    assert len(facings) >= 5
    doors = sum(int((s.ents.active & (s.ents.type == LOCKED_DOOR)).sum()) for s in states)
    ring = sum(int((s.ents.active & (s.ents.type == KEY_ON_RING)).sum()) for s in states)
    assert doors >= 10 and ring == sum(int(s.game.num_keys.sum()) for s in states)
    resets = sum(int((s1.cur_time < s0.cur_time).sum()) for s0, s1 in zip(states, states[1:]))
    assert resets >= 1 and int(states[FORCED + 1].cur_time[1]) == 0


@pytest.mark.parametrize("wd,md", MAZES)
def test_maze_with_doors(wd, md, ref, port):
    got = port[("maze", md, wd)]
    for k in ("mt", "pos", "grid", "doors"):
        want = ref[SEP.join(("maze", str(md), str(wd), k))]
        if k == "mt":
            want = want.astype(np.int64)
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)
    # the doors asked for, or every fork when there are fewer; a key for
    # each door, one exit, one agent
    grid = got["grid"]
    doors = got["doors"]
    asked = torch.arange(MAZE_SEEDS) % 4
    assert bool((doors <= asked).all()) and bool((doors == asked).any())
    assert bool((((grid >= 200) & (grid < 300)).sum(1) == doors).all())
    for c in range(3):
        assert bool(((grid == 301 + c).sum(1) == (doors > c).int()).all())
    assert bool(((grid == 52).sum(1) == 1).all()) and bool(((grid == 53).sum(1) == 1).all())
    assert got["rounds"] > 0


def test_scenes(ref):
    """``env_step`` twice on the made-up scenes: every leaf of both steps
    equals the JAX package's, and the scenes do what the module docstring
    says."""
    tree = _unflat(_leaves(ref, SEP.join(("scene", "in"))))
    game = _torch_game(0)
    s = state_from_numpy(tree, game)
    act = torch.full((N,), RIGHT, dtype=torch.int32)
    s1, done1 = tlife.env_step(game, s, act)
    s2, done2 = tlife.env_step(game, s1, act)
    for part, st, done in (("out1", s1, done1), ("out2", s2, done2)):
        got = _flat(state_to_numpy(st))
        want = _leaves(ref, SEP.join(("scene", part)))
        assert set(want) == set(got), set(want) ^ set(got)
        for leaf, w in want.items():
            assert got[leaf].dtype == w.dtype, leaf
            np.testing.assert_array_equal(got[leaf], w, err_msg=f"{part}: {leaf}")
        np.testing.assert_array_equal(done.numpy(), ref[SEP.join(("scene", "done" + part[-1]))])

    # env 0: the locked door stops the agent flush against it, both steps
    for st in (s1, s2):
        assert float(st.ents.x[0, 0]) == 3.0 - 0.375 and int(st.ents.count[0]) == 2
    # env 1: the key taken in the first step while the door blocks; the
    # door opens in the second
    e1 = s1.ents
    assert s1.game.has_keys[1].tolist() == [False, True, False]
    assert e1.type[1, :int(e1.count[1])].tolist() == [0, LOCKED_DOOR, KEY_ON_RING]
    assert float(e1.x[1, 0]) == 3.0 - 0.375
    assert s2.ents.type[1, :int(s2.ents.count[1])].tolist() == [0, KEY_ON_RING]
    assert float(s2.ents.x[1, 0]) > 3.0 - 0.375
    # env 2: the exit assigns its reward and ends the level
    assert float(s1.reward[2]) == 10.0 and bool(done1[2]) and bool(s1.level_complete[2])

    # the key ring's green key is drawn once its key is held
    key = SEP.join(("scene", "frames"))
    batch = _cat([s, s1, s2])
    frames = rk.render_obs_batch(game, batch).numpy()
    np.testing.assert_array_equal(frames, ref[key + SEP + "pallas"])
    np.testing.assert_array_equal(trender_obs(game, batch, 64).numpy(), ref[key + SEP + "xla"])
    drawn = (frames[N + 1] != frames[1]).any(-1)  # env 1 after the step against before
    assert drawn[:8, 48:].any()


@pytest.mark.parametrize("run", list(RUNS) + ["genassets"])
def test_frames_match_pallas_interpret_and_xla(run, ref, port):
    """The kernel path equals the Pallas kernel, the plain renderer the
    XLA renderer.  With every key held, the key ring's keys, at render_z
    1 in screen coordinates, change the frame's top right corner and
    nothing else, under either camera."""
    game, batch, kernel, plain, x = port[run][1]
    key = SEP.join((run, "frames"))
    pallas = ref[key + SEP + "pallas"]
    xla = ref[key + SEP + "xla"]
    np.testing.assert_array_equal(kernel, pallas, err_msg=run)
    np.testing.assert_array_equal(plain, xla, err_msg=run)
    np.testing.assert_array_equal(pallas, xla, err_msg=run)
    if run != "genassets":
        half = kernel.shape[0] // 2
        ring = (kernel[:half] != kernel[half:]).any(-1)
        assert ring.any() and not ring[:, 8:].any() and not ring[:, :, :40].any()
        # a frame changes where a ring key shows with every key held and
        # not as the run left it
        shown = (batch.ents.active & (batch.ents.type == KEY_ON_RING)
                 & game.should_draw_entity_mask(batch))
        new = (shown[half:] & ~shown[:half]).any(dim=1).numpy()
        assert new.any() and bool((ring.any(axis=(1, 2)) == new).all())


@pytest.mark.parametrize("run", list(RUNS) + ["genassets"])
def test_prep_matches_pallas_prep(run, ref, port):
    game, batch, _, _, x = port[run][1]
    plan = rk.get_plan(game)
    assert not plan.static and plan.bg_mode == rk.BG_CROP
    assert plan.NC == (11 if game.center_agent else game.world_dim)
    key = SEP.join((run, "frames", "prep")) + SEP
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


@pytest.mark.parametrize("mode", ["easy", "hard", "memory"])
def test_gym3_env_camera(mode):
    """``ProcgenGym3Env`` asks for the centred camera by default; heist
    centres only in memory mode (11 cells), else shows the whole world,
    through the kernel path."""
    env = ProcgenGym3Env(num=2, env_name="heist", rand_seed=0, distribution_mode=mode,
                         device="cpu")
    game = env._vec.game
    assert game.center_agent == (mode == "memory") and rk.supports(game)
    plan = rk.get_plan(game)
    assert plan.NC == {"easy": 9, "hard": 13, "memory": 11}[mode]
    _, obs, _ = env.observe()
    np.testing.assert_array_equal(obs["rgb"], rk.render_obs_batch(game, env._vec.states).numpy())


@pytest.mark.parametrize("name", REPLAYS)
def test_conformance_replay(name, replays):
    rec, res = replays[name]
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == res["steps"] == len(rec["actions"])


if __name__ == "__main__":
    from test_torch_refstate import patch_jax_cpp_arithmetic

    patch_jax_cpp_arithmetic()
    _jax_reference(sys.argv[1])
