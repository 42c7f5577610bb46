"""The port's chaser against the JAX package's and the C++ recordings.

* Easy, hard and extreme, 3 envs, 64 random steps each (the eggs hatch
  at step 50, and the enemies chase for the rest), an episode's end
  resetting its env at once (both packages' ``env_step``, then
  ``env_reset`` where an env is done): every ``BasicState`` leaf
  (``ChaserState``, the maze of orbs, the eggs and enemies, ``rand_gen``
  included), bit-equal.
* ``levelgen.maze.generate_maze_no_dead_ends`` against the JAX function
  on 64 seeded streams for each mode's maze (11, 13 and 19 cells) and an
  even one (10 cells, whose last row and column no wall carves), each
  stream first advanced by 0 to 623 words so that the draw block crosses
  the twist at every offset: the grid, the carved-cell bookkeeping and the
  stream after it, bit-equal.
* ``env_step`` on made-up scenes, every leaf bit-equal: a large orb in a
  higher slot than an enemy, both on the agent (the orb is eaten first, so
  the enemy is eaten too); the enemy in the higher slot (the agent dies,
  then eats the orb); an egg hatching into an enemy while the agent eats
  the last small orb (the completion bonus).
* The frames of every sixteenth step's states under the static camera (the
  game forces it: ``ProcgenGym3Env``'s ``center_agent=True`` draws the
  same window of the whole maze).  ``render_kernel.render_obs_batch`` (on
  CPU tensors, the plain version of the whole-frame kernel, the orbs'
  inset of 0.3 among its colored cells) against the Pallas kernel run in
  interpret mode, the port's ``renderer.render_obs`` (the orbs evaluated
  per pixel, as the XLA renderer does) against the XLA ``render_obs``,
  the two JAX paths against each other, and ``prep_frame`` against the
  Pallas kernel's ``_prep_one``.
* Generated assets: 3 envs reset and stepped 4 times, every leaf, and
  the frames of both states against Pallas and XLA.
* chaser_easy, chaser_hard and chaser_extreme replay exactly.

The JAX reference runs in one child process (this file run as a script)
for every mode, while the port runs its own and replays the recordings;
its XLA is held to AVX (``--xla_cpu_max_isa=AVX``): XLA's CPU backend
otherwise contracts ``a * b + c`` into a fused multiply-add, which neither
the C++ reference nor the port does.

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
from procgen_tpu_torch.core.constants import INT32_MAX, fnv1a_32  # noqa: E402
from procgen_tpu_torch.core.game import tree_map, tree_where  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.games.chaser import (  # noqa: E402
    ENEMY, ENEMY_EGG, LARGE_ORB, Chaser, ChaserState,
)
from procgen_tpu_torch.levelgen import maze as tmaze  # noqa: E402
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402
from procgen_tpu_torch.utils.host_mt import HostMT19937  # noqa: E402

N = 3
STEPS = 64  # the eggs hatch after 50 steps
# run -> (distribution mode, master seed, action seed)
RUNS = {"easy": (0, 41, 0), "hard": (1, 42, 1), "extreme": (2, 43, 2)}
DIMS = {0: 11, 1: 13, 2: 19}
# the mazes of generate_maze_no_dead_ends's test: each mode's, and an even
# size (the generator's other fixable cells, its uncarved last row and
# column)
MAZE_DIMS = {**DIMS, 3: 10}
GEN_STEPS = 4  # the generated-assets run (easy)
MAZE_SEEDS = 64
SEP = "::"
FORCED = 20  # env 1 is forced to reset at this step


def _seeds(master_seed, n=N):
    m = HostMT19937(master_seed)
    return np.array([m.next_u32() for _ in range(n)], np.int64)


def _actions(action_seed, steps=STEPS):
    """[steps, N] actions, most of them moves along the corridors; env 1
    is forced to reset at step ``FORCED``."""
    rng = np.random.RandomState(action_seed)
    out = []
    for t in range(steps):
        a = np.where(rng.rand(N) < 0.8, rng.choice([1, 3, 5, 7], N),
                     rng.randint(0, 15, N)).astype(np.int32)
        if t == FORCED:
            a[1] = -1
        out.append(a)
    return np.stack(out)


def _frame_steps():
    return np.arange(0, STEPS + 1, 16)


def _asset_seed():
    return int(np.int32(np.uint32(fnv1a_32("chaser"))))


def _maze_offsets():
    return np.random.RandomState(5).randint(0, 624, MAZE_SEEDS).astype(np.int32)


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


# ---------------------------------------------------------------------------
# the made-up scenes (an easy reset state, edited)
# ---------------------------------------------------------------------------


def _ent(e, env, slot, x, y, type_, r, smart=False, health=1.0):
    for k, v in dict(x=x, y=y, vx=0.0, vy=0.0, rx=r, ry=r, type=type_, image_type=type_,
                     smart_step=smart, will_erase=False, health=health, alpha=1.0,
                     grow_rate=1.0, friction=1.0, auto_erase=True, expire_time=-1).items():
        e[k][env, slot] = v


def _scene(tree):
    """Edit a 3-env chaser reset state (``serialization.to_state_dict``
    leaves as numpy) into the scenes of the module docstring."""
    e, g = tree["ents"], tree["game"]
    ax, ay = e["x"][:, 0].copy(), e["y"][:, 0].copy()
    # env 0: the orb above the enemy; env 1: the enemy above the orb
    _ent(e, 0, 1, ax[0], ay[0], ENEMY, 0.5, smart=True)
    _ent(e, 0, 2, ax[0], ay[0], LARGE_ORB, 0.4)
    _ent(e, 1, 1, ax[1], ay[1], LARGE_ORB, 0.4)
    _ent(e, 1, 2, ax[1], ay[1], ENEMY, 0.5, smart=True)
    e["count"][:2] = 3
    # env 2: an egg about to hatch, away from the agent; the agent's cell
    # holds the last small orb
    ex = ax[2] + (3.0 if ax[2] < 6 else -3.0)
    _ent(e, 2, 1, ex, ay[2], ENEMY_EGG, 0.5, health=1.0)
    e["count"][2] = 2
    g["total_orbs"][2] = g["orbs_collected"][2] + 1
    return tree


# ---------------------------------------------------------------------------
# the JAX reference (child process)
# ---------------------------------------------------------------------------


def _jax_game(mode, generated=False):
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game

    game = make_game("chaser", JGameOptions(distribution_mode=mode,
                                            use_generated_assets=generated))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    if generated:
        game.fixed_asset_seed = _asset_seed()
    return game


def _jax_reference(out_path):
    """Every mode's run and the frames of ``_frame_steps``; the mazes; the
    scenes; then the generated-assets run.  Saves the arrays, keyed
    ``run::part::leaf``."""
    from procgen_tpu.core import lifecycle
    from procgen_tpu.core import rng as jrng
    from procgen_tpu.levelgen import maze as jmaze
    from procgen_tpu.parallel.vec import _tree_select
    from procgen_tpu.render import atlas, pallas_kernel
    from procgen_tpu.render.renderer import render_obs

    jax.config.update("jax_platforms", "cpu")
    out = {}

    def frames(key, game, batch):
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
        return states, step

    def save(key, st):
        for leaf, v in _flat(serialization.to_state_dict(st)).items():
            out[SEP.join((key, leaf))] = v

    def save_states(run, states):
        trees = [_flat(serialization.to_state_dict(st)) for st in states]
        for leaf in trees[0]:
            out[SEP.join((run, "states", leaf))] = np.stack([t[leaf] for t in trees])

    for run, (mode, mseed, aseed) in RUNS.items():
        states, _ = run_states(_jax_game(mode), _seeds(mseed), _actions(aseed), True)
        save_states(run, states)
        batch = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs), *[states[t] for t in _frame_steps()])
        frames(SEP.join((run, "world")), _jax_game(mode), batch)

    for mode, dim in MAZE_DIMS.items():
        g = jax.vmap(jrng.seed)(jnp.asarray(_seeds(50 + mode, MAZE_SEEDS), jnp.uint32))
        g, _ = jax.vmap(lambda st, k: jrng.draw_n(st, jrng.N, k))(
            g, jnp.asarray(_maze_offsets()))
        res = jax.jit(jax.vmap(lambda st: jmaze.generate_maze_no_dead_ends(
            st, jnp.asarray(dim, jnp.int32), dim)))(g)
        for k, v in zip(("mt", "pos", "grid", "free_cells", "num_free", "in_free"),
                        (res[0].mt, res[0].pos) + tuple(res[1:])):
            out[SEP.join(("maze", str(mode), k))] = np.asarray(v)

    game = _jax_game(0)
    (s0,), step = run_states(game, _seeds(44), [], False)
    tree = jax.tree_util.tree_map(np.array, serialization.to_state_dict(s0))
    s_in = serialization.from_state_dict(s0, _scene(tree))
    s_out, done = step(s_in, jnp.full((N,), 4, jnp.int32))
    save(SEP.join(("scene", "in")), s_in)
    save(SEP.join(("scene", "out")), s_out)
    out[SEP.join(("scene", "done"))] = np.asarray(done)

    game = _jax_game(0, generated=True)
    states, _ = run_states(game, _seeds(23), _actions(2, GEN_STEPS), False)
    save_states("genassets", states)
    frames(SEP.join(("genassets", "world")), game, jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs), states[0], states[-1]))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_child(tmp_path_factory):
    """Start the JAX reference in one child process; yields (output path,
    process, stderr path)."""
    out_dir = tmp_path_factory.mktemp("chaser")
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
    game = Chaser(GameOptions(distribution_mode=mode, center_agent=centred,
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
            batch = _cat([states[t] for t in _frame_steps()])
            out[run] = (states, {"world": _frames(_torch_game(mode), batch)})

        for mode, dim in MAZE_DIMS.items():
            g = trng.seed(torch.as_tensor(_seeds(50 + mode, MAZE_SEEDS)))
            g, _ = trng.draw_n(g, trng.N, torch.as_tensor(_maze_offsets()))
            res = tmaze.generate_maze_no_dead_ends(
                g, torch.full((MAZE_SEEDS,), dim, dtype=torch.int32), dim)
            out[("maze", mode)] = dict(zip(
                ("mt", "pos", "grid", "free_cells", "num_free", "in_free"),
                (res[0].mt, res[0].pos) + tuple(res[1:])))

        game = _torch_game(0, generated=True)
        s = tlife.env_reset(game, tlife.initial_state(game, torch.as_tensor(_seeds(23))))
        states = [s]
        for a in _actions(2, GEN_STEPS):
            s, _ = tlife.env_step(game, s, torch.as_tensor(a))
            states.append(s)
        out["genassets"] = (states, {"world": _frames(game, _cat([states[0], states[-1]]))})
    return out


REPLAYS = ("chaser_easy", "chaser_hard", "chaser_extreme")


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
    assert isinstance(states[-1].game, ChaserState)


@pytest.mark.parametrize("run", list(RUNS))
def test_trajectories_reach_the_machinery(run, port):
    """The runs eat small orbs, hatch eggs into enemies that move, and end
    an episode (the forced reset among them)."""
    states = port[run][0]
    eaten = sum(int((s1.game.orbs_collected > s0.game.orbs_collected).sum())
                for s0, s1 in zip(states, states[1:]))
    assert eaten >= 10
    enemies = [s.ents.active & (s.ents.type == ENEMY) for s in states]
    assert any(bool(m.any()) for m in enemies)
    moves = sum(int((m & (s1.ents.x != s0.ents.x)).sum())
                for m, s0, s1 in zip(enemies[1:], states, states[1:]))
    assert moves >= 5
    resets = sum(int((s1.cur_time < s0.cur_time).sum()) for s0, s1 in zip(states, states[1:]))
    assert resets >= 1 and int(states[FORCED + 1].cur_time[1]) == 0


@pytest.mark.parametrize("mode", list(MAZE_DIMS))
def test_maze_without_dead_ends(mode, ref, port):
    got = port[("maze", mode)]
    for k, v in got.items():
        want = ref[SEP.join(("maze", str(mode), k))]
        if k == "mt":
            want = want.astype(np.int64)
        np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
    # no dead end is left in an odd maze: every SPACE cell has two SPACE
    # neighbours or more
    dim = MAZE_DIMS[mode]
    if dim % 2 == 0:
        return
    grid = got["grid"].reshape(MAZE_SEEDS, dim + 2, dim + 2)[:, 1:-1, 1:-1] == 100
    pad = torch.nn.functional.pad(grid, (1, 1, 1, 1))
    nbrs = (pad[:, :-2, 1:-1].int() + pad[:, 2:, 1:-1] + pad[:, 1:-1, :-2] + pad[:, 1:-1, 2:])
    assert bool((nbrs[grid] >= 2).all())


def test_scenes(ref):
    """``env_step`` on the made-up scenes: every leaf equals the JAX
    package's, and the scenes do what the module docstring says."""
    prefix = SEP.join(("scene", "in")) + SEP
    tree = _unflat({k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)})
    game = _torch_game(0)
    s = state_from_numpy(tree, game)
    out, done = tlife.env_step(game, s, torch.full((N,), 4, dtype=torch.int32))
    got = _flat(state_to_numpy(out))
    prefix = SEP.join(("scene", "out")) + SEP
    want = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    assert set(want) == set(got), set(want) ^ set(got)
    for leaf, w in want.items():
        assert got[leaf].dtype == w.dtype, leaf
        np.testing.assert_array_equal(got[leaf], w, err_msg=leaf)
    np.testing.assert_array_equal(done.numpy(), ref[SEP.join(("scene", "done"))])

    e = out.ents
    live = [e.type[i, :int(e.count[i])].tolist() for i in range(N)]
    # env 0: both eaten (erased within the step), the orb first; an egg
    # respawns
    assert live[0] == [0, ENEMY_EGG] and not bool(done[0])
    assert int(out.game.eat_time[0]) == int(out.cur_time[0])
    # env 1: the enemy kills, then the orb is eaten
    assert bool(done[1]) and live[1] == [0, ENEMY, ENEMY_EGG]
    # env 2: the egg hatched (marked to go, an enemy pushed at its place),
    # the last orb eaten, the level complete
    assert live[2] == [0, ENEMY_EGG, ENEMY, ENEMY_EGG] and e.will_erase[2, 1]
    assert float(e.x[2, 2]) == float(e.x[2, 1])
    assert bool(out.level_complete[2]) and bool(done[2])
    assert abs(float(out.reward[2]) - 10.04) < 1e-5


def test_frames_match_pallas_interpret_and_xla(ref, port):
    """For every run: the kernel path equals the Pallas kernel, the plain
    renderer the XLA renderer, and the two JAX paths agree (the static
    camera over the whole maze: the window's pick of each cell is the
    XLA renderer's).  The orbs' inset cuts their cells: some pixels of an
    orb's cell are green and some are not."""
    for run in list(RUNS) + ["genassets"]:
        _, batch, kernel, plain, x = port[run][1]["world"]
        pallas = ref[SEP.join((run, "world", "pallas"))]
        xla = ref[SEP.join((run, "world", "xla"))]
        np.testing.assert_array_equal(kernel, pallas, err_msg=run)
        np.testing.assert_array_equal(plain, xla, err_msg=run)
        np.testing.assert_array_equal(pallas, xla, err_msg=run)
        if run != "genassets":
            orb = (x.cell5[:, 4] < 1).numpy()
            assert orb.any() and (x.cell5[:, 4][torch.as_tensor(orb)] == np.float32(0.3)).all()
            green = (kernel == (0, 255, 0)).all(axis=-1)
            assert 0 < green.mean() < 0.2


@pytest.mark.parametrize("run", list(RUNS) + ["genassets"])
def test_prep_matches_pallas_prep(run, ref, port):
    game, batch, _, _, x = port[run][1]["world"]
    plan = rk.get_plan(game)
    assert not plan.static and plan.NC == game.maze_dim and plan.bg_mode == rk.BG_CROP
    key = SEP.join((run, "world", "prep")) + SEP
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


@pytest.mark.parametrize("mode", ["easy", "hard", "extreme"])
def test_gym3_env_keeps_the_static_camera(mode):
    """``ProcgenGym3Env`` asks for the centred camera by default; chaser
    forces the static one: the window is the whole maze, drawn through the
    kernel path (``supports`` admits the orbs' cell colors)."""
    env = ProcgenGym3Env(num=2, env_name="chaser", rand_seed=0, distribution_mode=mode,
                         device="cpu")
    game = env._vec.game
    assert game.options.center_agent and not game.center_agent
    assert rk.supports(game)
    plan = rk.get_plan(game)
    assert plan.NC == {"easy": 11, "hard": 13, "extreme": 19}[mode]
    _, obs, _ = env.observe()
    x = rk.prep_frame(plan, env._vec.states)
    np.testing.assert_array_equal(obs["rgb"], rk.render_obs_batch(game, env._vec.states).numpy())
    assert float(x.sf[0, rk.SF_VIS]) == game.maze_dim


@pytest.mark.parametrize("name", REPLAYS)
def test_conformance_replay(name, replays):
    rec, res = replays[name]
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == res["steps"] == len(rec["actions"])


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
