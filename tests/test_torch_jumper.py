"""The port's jumper against the JAX package's and the C++ recordings.

* Easy, hard and memory, 3 envs, 40 random steps each (most of them
  jumps and runs), an episode's end resetting its env at once (both
  packages' ``env_step``, then ``env_reset`` where an env is done), env 1
  forced to reset at step 20: every ``BasicState`` leaf (``JumperState``,
  the cave, the spikes, the trails of the decor pool, ``rand_gen``
  included), bit-equal.
* ``levelgen.room``'s ``ca_update`` (two rounds), ``best_room_mask``,
  ``bfs_path_mask`` and ``expand_mask`` against the JAX functions on 64
  grids at each of 20, 40 and 45 cells: random caves, their biggest rooms,
  the paths between random cells of them (the same cell, and a wall cell
  that reaches nothing, among them) and the paths widened 4 rounds.
* The spike sweep and the wall sweep (``games.jumper.sweeps``) against
  the JAX package's own scans (``spike_body`` and ``wall_body`` of
  ``Jumper.game_reset``, compiled from its source) on 64 seeded streams
  per mode (20, 40 and 45 cells; spikes at 0.2, none in memory mode),
  each stream first advanced by 0 to 623 words, on random caves: the
  grid and the stream after them, bit-equal.
* The frames of the states of steps 0, 20 and 40 under the whole-world
  camera (20, 40 and 45 cells) and the agent-centred one (15 cells easy,
  19 in memory mode), the trails among the sprites: ``render_kernel.
  render_obs_batch`` (on CPU tensors, the plain version of the
  whole-frame kernel, then the compass and distance bar of ``post``)
  against the Pallas kernel run in interpret mode, the port's
  ``renderer.render_obs`` against the XLA ``render_obs``, and
  ``prep_frame`` against the Pallas kernel's ``_prep_one``.  The easy
  batches add 12 states with the goal moved to 12 bearings around the
  agent, at distances from 0 to 15 cells: the compass's needle and the
  bar's length.
* Generated assets: 3 envs reset and stepped 4 times, every leaf, and
  the frames of both states against Pallas and XLA.
* jumper_easy, jumper_hard and jumper_memory replay exactly.

The JAX reference runs in one child process (this file run as a script)
for every mode, while the port runs its own and replays the recordings;
its XLA is held to AVX (``--xla_cpu_max_isa=AVX``) and takes the C++
arithmetic of ``test_torch_refstate.patch_jax_cpp_arithmetic``.

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
from procgen_tpu_torch.games import jumper as tjumper  # noqa: E402
from procgen_tpu_torch.games.jumper import (  # noqa: E402
    CAVEWALL, GOAL, SPIKE, Jumper, JumperState,
)
from procgen_tpu_torch.levelgen import room as troom  # noqa: E402
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402
from procgen_tpu_torch.utils.host_mt import HostMT19937  # noqa: E402

N = 3
STEPS = 40
# run -> (distribution mode, master seed, action seed)
RUNS = {"easy": (0, 81, 0), "hard": (1, 82, 1), "memory": (10, 83, 2)}
DIMS = {0: 20, 1: 40, 10: 45}
# the cameras each run's frames are drawn under
CAMERAS = {"easy": ("world", "centred"), "hard": ("world",), "memory": ("world", "centred")}
CASES = [(run, cam) for run, cams in CAMERAS.items() for cam in cams]
GEN_STEPS = 4  # the generated-assets run (easy)
SEEDS = 64
SEP = "::"
FORCED = 20  # env 1 is forced to reset at this step
BEARINGS = 12  # the compass batch: the goal at 12 bearings
WALL = 51  # WALL_OBJ, the CA's wall


def _seeds(master_seed, n=N):
    m = HostMT19937(master_seed)
    return np.array([m.next_u32() for _ in range(n)], np.int64)


def _actions(action_seed, steps=STEPS):
    """[steps, N] actions, most of them jumps and runs; env 1 is forced to
    reset at step ``FORCED``."""
    rng = np.random.RandomState(action_seed)
    out = []
    for t in range(steps):
        a = np.where(rng.rand(N) < 0.85, rng.choice([2, 5, 8, 8, 6, 0, 3], N),
                     rng.randint(0, 15, N)).astype(np.int32)
        if t == FORCED:
            a[1] = -1
        out.append(a)
    return np.stack(out)


FRAME_STEPS = (0, 20, 40)


def _asset_seed():
    return int(np.int32(np.uint32(fnv1a_32("jumper"))))


def _offsets(seed):
    return np.random.RandomState(seed).randint(0, 624, SEEDS).astype(np.int32)


def _fill(dim, seed):
    """64 random fills [64, dim, dim] of walls (WALL_OBJ) at 0.45 to 0.55,
    the rest SPACE."""
    rs = np.random.RandomState(seed)
    wall = rs.rand(SEEDS, dim, dim) < rs.choice([0.45, 0.5, 0.55], (SEEDS, 1, 1))
    return np.where(wall, WALL, SPACE).astype(np.int32)


def _walled(grid):
    """``grid``'s walls as CAVEWALL, and a CAVEWALL border (jumper.cpp:
    262-271)."""
    grid = np.where(np.asarray(grid) == WALL, CAVEWALL, np.asarray(grid)).astype(np.int32)
    grid[:, 0] = grid[:, -1] = CAVEWALL
    grid[:, :, 0] = grid[:, :, -1] = CAVEWALL
    return grid


def _caves(dim, seed):
    """64 random caves of SPACE and CAVEWALL [64, dim, dim]: a fill, two CA
    rounds (numpy), the border."""
    wall = _fill(dim, seed) == WALL
    for _ in range(2):
        p = np.pad(wall, ((0, 0), (1, 1), (1, 1)), constant_values=True)
        wall = sum(p[:, 1 + dy:1 + dy + dim, 1 + dx:1 + dx + dim]
                   for dy in (-1, 0, 1) for dx in (-1, 0, 1)) >= 5
    return _walled(np.where(wall, WALL, SPACE))


def _ends(room, seed):
    """(src, dst) cells of the BFS case: random cells of each room; env 0
    to 3 from a cell to itself, env 4 from a corner wall cell."""
    rs = np.random.RandomState(seed)
    flat = room.reshape(SEEDS, -1)
    src = np.array([rs.choice(np.flatnonzero(f)) for f in flat])
    dst = np.array([rs.choice(np.flatnonzero(f)) for f in flat])
    dst[:4] = src[:4]
    src[4] = 0
    return src, dst


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


def _bearings(tree):
    """The compass batch from a 3-env state dict (numpy leaves): each env
    4 times, the goal moved to bearings k * 30 degrees (k = 0..11) around
    the agent, at 0 to 15 cells (the first at the agent itself)."""
    reps = BEARINGS // N
    tree = jax.tree_util.tree_map(lambda a: np.concatenate([a] * reps), tree)
    e = tree["ents"]
    for i in range(BEARINGS):
        slot = int(np.argmax((e["type"][i] == GOAL) & (np.arange(e["x"].shape[1]) < e["count"][i])))
        b = np.deg2rad(30 * i)
        r = 0.0 if i == 0 else [2.0, 7.5, 15.0][i % 3]
        e["x"][i, slot] = np.float32(e["x"][i, 0] + r * np.cos(b))
        e["y"][i, slot] = np.float32(e["y"][i, 0] + r * np.sin(b))
    return tree


def _jax_sweeps():
    """The JAX package's spike and wall sweeps, the ``spike_body`` and
    ``wall_body`` scans of ``Jumper.game_reset`` compiled from its source
    as ``fn(g, grid, dim, spike_prob) -> (g, grid)``."""
    import inspect
    import textwrap

    import procgen_tpu.games.jumper as jj

    lines = textwrap.dedent(inspect.getsource(jj.Jumper.game_reset)).splitlines()
    start = next(i for i, ln in enumerate(lines) if "def spike_body" in ln)
    stop = next(i for i, ln in enumerate(lines) if "wall_body, (g, grid), jnp.arange(A)" in ln)
    body = textwrap.dedent("\n".join(lines[start:stop + 2]))
    src = ("def sweeps(g, grid, dim, spike_prob):\n    A = dim * dim\n"
           + textwrap.indent(body, "    ") + "\n    return g, grid\n")
    ns = dict(vars(jj))
    exec(compile(src, inspect.getsourcefile(jj), "exec"), ns)
    return ns["sweeps"]


# ---------------------------------------------------------------------------
# the JAX reference (child process)
# ---------------------------------------------------------------------------


def _jax_game(mode, centred=False, generated=False):
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game

    game = make_game("jumper", JGameOptions(distribution_mode=mode, center_agent=centred,
                                            use_generated_assets=generated))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    if generated:
        game.fixed_asset_seed = _asset_seed()
    return game


def _jax_reference(out_path):
    """Every mode's run and its frames under its cameras (easy's with the
    compass batch); the room functions; the sweeps; then the
    generated-assets run.  Saves the arrays, keyed ``run::part::leaf``."""
    from procgen_tpu.core import lifecycle
    from procgen_tpu.core import rng as jrng
    from procgen_tpu.levelgen import room as jroom
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
        return states

    def save(key, st):
        for leaf, v in _flat(serialization.to_state_dict(st)).items():
            out[SEP.join((key, leaf))] = v

    def save_states(run, states):
        trees = [_flat(serialization.to_state_dict(st)) for st in states]
        for leaf in trees[0]:
            out[SEP.join((run, "states", leaf))] = np.stack([t[leaf] for t in trees])

    for run, (mode, mseed, aseed) in RUNS.items():
        states = run_states(_jax_game(mode), _seeds(mseed), _actions(aseed), True)
        save_states(run, states)
        batch = [states[t] for t in FRAME_STEPS]
        parts = [(SEP.join((run, "frames")), len(FRAME_STEPS) * N)]
        if run == "easy":
            tree = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(states[10]))
            comp = serialization.from_state_dict(
                jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs), *[states[10]] * 4),
                _bearings(tree))
            save(SEP.join(("bearings", "in")), comp)
            batch.append(comp)
            parts.append(("bearings", BEARINGS))
        for cam in CAMERAS[run]:
            frames([(SEP.join((k, cam)), n) for k, n in parts],
                   _jax_game(mode, centred=cam == "centred"), *batch)

    for dim in sorted(DIMS.values()):
        ca = jax.vmap(lambda g: jroom.ca_update(jroom.ca_update(
            g, WALL, SPACE, dim), WALL, SPACE, dim))(_fill(dim, dim))
        out[SEP.join(("room", str(dim), "ca"))] = np.asarray(ca)
        room = np.asarray(jax.jit(jax.vmap(lambda g: jroom.best_room_mask(g, SPACE, dim)))(
            _walled(ca)))
        out[SEP.join(("room", str(dim), "best"))] = room
        cave = np.where(room, SPACE, CAVEWALL).astype(np.int32)
        src, dst = _ends(room, dim)

        def path_and_wide(g, a, b):
            path = jroom.bfs_path_mask(g, SPACE, a, b, dim)
            return path, jroom.expand_mask(path, (g == SPACE).reshape(-1), 4, dim)

        path, wide = jax.jit(jax.vmap(path_and_wide))(cave, src, dst)
        out[SEP.join(("room", str(dim), "path"))] = np.asarray(path)
        out[SEP.join(("room", str(dim), "wide"))] = np.asarray(wide)

    sweeps = _jax_sweeps()
    for mode, dim in DIMS.items():
        g = jax.vmap(jrng.seed)(jnp.asarray(_seeds(90 + mode, SEEDS), jnp.uint32))
        g, _ = jax.vmap(lambda st, k: jrng.draw_n(st, jrng.N, k))(
            g, jnp.asarray(_offsets(mode)))
        cave = _caves(dim, 100 + dim)
        prob = 0.0 if mode == 10 else 0.2
        g, grid = jax.jit(jax.vmap(lambda st, c: sweeps(st, c, dim, prob)))(g, cave)
        for k, v in (("mt", g.mt), ("pos", g.pos), ("grid", grid)):
            out[SEP.join(("sweeps", str(mode), k))] = np.asarray(v)

    game = _jax_game(0, generated=True)
    states = run_states(game, _seeds(23), _actions(2, GEN_STEPS), False)
    save_states("genassets", states)
    frames([(SEP.join(("genassets", "frames", "world")), 2 * N)], game, states[0], states[-1])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_child(tmp_path_factory):
    """Start the JAX reference in one child process; yields (output path,
    process, stderr path)."""
    out_dir = tmp_path_factory.mktemp("jumper")
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
    game = Jumper(GameOptions(distribution_mode=mode, center_agent=centred,
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
    """Per run: the port's states of every step and the frames of
    ``FRAME_STEPS`` under each camera; the room functions and the sweeps;
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
            batch = _cat([states[t] for t in FRAME_STEPS])
            out[run] = (states, {cam: _frames(_torch_game(mode, cam == "centred"), batch)
                                 for cam in CAMERAS[run]})

        for dim in sorted(DIMS.values()):
            ca = troom.ca_update(troom.ca_update(torch.as_tensor(_fill(dim, dim)), WALL, SPACE),
                                 WALL, SPACE)
            best = troom.best_room_mask(torch.as_tensor(_walled(ca)), SPACE)
            cave = torch.where(best, SPACE, CAVEWALL).to(torch.int32)
            src, dst = _ends(best.numpy(), dim)
            path = troom.bfs_path_mask(cave, SPACE, torch.as_tensor(src), torch.as_tensor(dst))
            wide = troom.expand_mask(path, (cave == SPACE).reshape(SEEDS, -1), 4, dim)
            out[("room", dim)] = {"ca": ca, "best": best, "path": path, "wide": wide}

        for mode, dim in DIMS.items():
            g = trng.seed(torch.as_tensor(_seeds(90 + mode, SEEDS)))
            g, _ = trng.draw_n(g, trng.N, torch.as_tensor(_offsets(mode)))
            cave = _caves(dim, 100 + dim)
            g, grid = tjumper.sweeps(g, torch.as_tensor(cave), 0.0 if mode == 10 else 0.2)
            out[("sweeps", mode)] = {"mt": g.mt, "pos": g.pos, "grid": grid,
                                     "cave": torch.as_tensor(cave)}

        game = _torch_game(0, generated=True)
        s = tlife.env_reset(game, tlife.initial_state(game, torch.as_tensor(_seeds(23))))
        states = [s]
        for a in _actions(2, GEN_STEPS):
            s, _ = tlife.env_step(game, s, torch.as_tensor(a))
            states.append(s)
        out["genassets"] = (states, {"world": _frames(game, _cat([states[0], states[-1]]))})
    return out


REPLAYS = ("jumper_easy", "jumper_hard", "jumper_memory")


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
    assert isinstance(states[-1].game, JumperState)


@pytest.mark.parametrize("run", list(RUNS))
def test_trajectories_reach_the_machinery(run, port):
    """The runs jump (the agent rises), leave trails, hold spikes outside
    memory mode, and end an episode (the forced reset among them)."""
    states = port[run][0]
    rises = sum(int((s1.ents.y[:, 0] > s0.ents.y[:, 0]).sum())
                for s0, s1 in zip(states, states[1:]))
    assert rises >= 10
    assert sum(int(s.decor.count.sum()) for s in states) >= 20
    spikes = sum(int((s.ents.active & (s.ents.type == SPIKE)).sum()) for s in states)
    assert (spikes == 0) == (run == "memory")
    resets = sum(int((s1.cur_time < s0.cur_time).sum()) for s0, s1 in zip(states, states[1:]))
    assert resets >= 1 and int(states[FORCED + 1].cur_time[1]) == 0


@pytest.mark.parametrize("fn", ["ca", "best", "path", "wide"])
@pytest.mark.parametrize("dim", sorted(DIMS.values()))
def test_room_functions(fn, dim, ref, port):
    got = port[("room", dim)]
    np.testing.assert_array_equal(got[fn].numpy(), ref[SEP.join(("room", str(dim), fn))])
    if fn == "path":
        lengths = got["path"].sum(dim=1)
        assert bool((lengths[:4] == 1).all()) and int(lengths[4]) == 0
        assert int(lengths.max()) > 10


@pytest.mark.parametrize("mode", list(DIMS))
def test_sweeps(mode, ref, port):
    got = port[("sweeps", mode)]
    for k in ("mt", "pos", "grid"):
        want = ref[SEP.join(("sweeps", str(mode), k))]
        if k == "mt":
            want = want.astype(np.int64)
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)
    spikes = (got["grid"] == SPIKE).sum(dim=(1, 2))
    opened = ((got["cave"] == CAVEWALL) & (got["grid"] == SPACE)).sum(dim=(1, 2))
    assert (int(spikes.sum()) == 0) == (mode == 10)
    assert int(opened.sum()) > 0


@pytest.mark.parametrize("run,cam", CASES + [("genassets", "world")])
def test_frames_match_pallas_interpret_and_xla(run, cam, ref, port):
    """The kernel path (with the compass and bar of ``post``) equals the
    Pallas kernel, the plain renderer the XLA renderer.  The two JAX paths
    agree except, under the centred camera, where they pick another cell
    for a pixel (ROADMAP Queue 3): the XLA renderer takes ``floor(wxs)``
    and ``floor(wys)``, the Pallas kernel the window's cell, whose index
    ``floor((wxs - low_x) * sA)`` rounds up to the next cell when ``wxs``
    lies within an ulp below an integer (easy's centred frames: one pixel
    column of one state, whose ``wxs`` is 0.99999994).  The port's two
    paths part the same way."""
    _, _, kernel, plain, x = port[run][1][cam]
    key = SEP.join((run, "frames", cam)) + SEP
    np.testing.assert_array_equal(kernel, ref[key + "pallas"])
    np.testing.assert_array_equal(plain, ref[key + "xla"])
    part = (ref[key + "pallas"] != ref[key + "xla"]).any(axis=-1)
    wxs, wys, inside, crow, ccol, _, _ = rk.grid_lookup(x)
    low_x = x.sf[:, rk.SF_LOWX, None, None]
    top_y = x.sf[:, rk.SF_TOPY, None, None]
    other = ((torch.floor(wxs)[:, None, :] != low_x + ccol)
             | (torch.floor(wys)[:, :, None] != top_y - 1 - crow))
    assert not (part & ~(other & inside).numpy()).any()
    assert part.any() == ((run, cam) == ("easy", "centred"))


@pytest.mark.parametrize("run,cam", CASES + [("genassets", "world")])
def test_prep_matches_pallas_prep(run, cam, ref, port):
    game, batch, _, _, x = port[run][1][cam]
    plan = rk.get_plan(game)
    assert not plan.static and plan.bg_mode == rk.BG_CROP
    assert plan.NC == (int(game.visibility) + 3 if cam == "centred" else game.world_dim)
    key = SEP.join((run, "frames", cam, "prep")) + SEP
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
    if run != "genassets":
        assert int(x.si[:, rk.SI_DEC_COUNT].sum()) > 0  # trails drawn


@pytest.mark.parametrize("cam", CAMERAS["easy"])
def test_compass_bearings(cam, ref):
    """The goal at 12 bearings: both of the port's paths equal the Pallas
    kernel's and the XLA renderer's frames; the needle (its colour) turns
    with the bearing and the bar grows with the distance."""
    tree = _unflat(_leaves(ref, SEP.join(("bearings", "in"))))
    game = _torch_game(0, cam == "centred")
    s = state_from_numpy(tree, game)
    kernel = rk.render_obs_batch(game, s).numpy()
    plain = trender_obs(game, s, 64).numpy()
    key = SEP.join(("bearings", cam)) + SEP
    np.testing.assert_array_equal(kernel, ref[key + "pallas"])
    np.testing.assert_array_equal(plain, ref[key + "xla"])
    # the bar's rows (by0 <= sy < by0 + bh) and the needle's above them
    unit = 64 / (float(s.visibility[0]) if cam == "centred" else game.world_dim)
    sy = np.arange(64) + 0.5
    cd = game.compass_dim
    bar_rows = (sy >= (0.25 + cd) * unit) & (sy < (0.25 + cd + cd / 8) * unit)
    hi = (kernel == tjumper.COMPASS_HI).all(-1)
    needle = hi[:, :int(np.argmax(bar_rows))]
    assert len({needle[i].tobytes() for i in range(BEARINGS)}) == BEARINGS
    bar = hi[:, bar_rows].any(axis=1).sum(axis=-1)  # the bar's length in pixels
    assert int(bar[0]) == 0  # the goal at the agent
    for k in range(0, BEARINGS, 3):  # 2 (0 at k = 0), 7.5 and 15 cells away
        assert bar[k] < bar[k + 1] < bar[k + 2]


@pytest.mark.parametrize("mode", ["easy", "hard", "memory"])
def test_gym3_env_camera(mode):
    """``ProcgenGym3Env``'s default centred camera: 15 cells easy, 19 hard
    and memory, through the kernel path; the compass drawn except in
    memory mode."""
    env = ProcgenGym3Env(num=2, env_name="jumper", rand_seed=0, distribution_mode=mode,
                         device="cpu")
    game = env._vec.game
    assert game.center_agent and rk.supports(game)
    assert rk.get_plan(game).NC == {"easy": 15, "hard": 19, "memory": 19}[mode]
    _, obs, _ = env.observe()
    np.testing.assert_array_equal(obs["rgb"], rk.render_obs_batch(game, env._vec.states).numpy())
    clock = (obs["rgb"] == tjumper.COMPASS_CLOCK).all(-1).any(axis=(1, 2))
    assert bool(clock.all()) == (mode != "memory")


@pytest.mark.parametrize("name", REPLAYS)
def test_conformance_replay(name, replays):
    rec, res = replays[name]
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == res["steps"] == len(rec["actions"])


if __name__ == "__main__":
    from test_torch_refstate import patch_jax_cpp_arithmetic

    patch_jax_cpp_arithmetic()
    _jax_reference(sys.argv[1])
