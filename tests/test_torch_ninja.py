"""The port's ninja against the JAX package's and the C++ recordings.

* Easy and hard, 3 envs, 40 random steps each (most of them jumps and
  throwing stars), an episode's end resetting its env at once (both
  packages' ``env_step``, then ``env_reset`` where an env is done): every
  ``BasicState`` leaf (``NinjaState``, the 64x64 grid, the stars and
  ``rand_gen`` included), bit-equal.
* The grid dispatch of the stars (``dispatch_grid_vec``) on made-up
  scenes, every leaf after ``dispatch_collisions`` bit-equal: two stars
  probing one BOMB cell (the higher slot booms it, one explosion, the
  lower star lives on) with the agent on that cell (it survives: the
  cell is SPACE when its turn comes); the agent on a BOMB no star probes
  (it dies), a star stuck on a wall and one booming alone; thirteen
  stars booming thirteen cells with one free slot (the highest slot's
  explosion is pushed, the rest dropped).  On the same scenes the port's
  ``dispatch_grid_vec`` equals its own per-slot reverse scan of the grid
  handler, the reference's order.
* The frames of every eighth step's states under both cameras: the whole
  world (``make_env_fns``: a 64-cell window) and the agent-centred one
  (``ProcgenGym3Env``: ``visibility + 3`` cells, 13 easy and 19 hard),
  the jump-charge bar included.  ``render_kernel.render_obs_batch`` (on
  CPU tensors, the plain version of the whole-frame kernel) against the
  Pallas kernel run in interpret mode, the port's ``renderer.render_obs``
  against the XLA ``render_obs``, and ``prep_frame`` against the Pallas
  kernel's ``_prep_one``.
* Generated assets: 3 envs reset and stepped 4 times, every leaf, and
  the frames of both states against Pallas and XLA.
* ninja_easy and ninja_hard replay exactly.

The JAX reference runs in one child process (this file run as a script)
for both modes, cameras and scenes, while the port runs its own and
replays the recordings; its XLA is held to AVX
(``--xla_cpu_max_isa=AVX``): XLA's CPU backend otherwise contracts
``a * b + c`` into a fused multiply-add, which neither the C++ reference
nor the port does.  The child takes ``test_torch_refstate.
patch_jax_cpp_arithmetic``: in ninja, a throwing star that a wall blocks
stops, both velocities zero, as the C++ ``is_blocked`` makes it
(ninja.cpp:139-152) and the C++ state bytes show; the package keeps the
unblocked axis moving.

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

from procgen_tpu_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from procgen_tpu_torch.conformance import replay  # noqa: E402
from procgen_tpu_torch.core import lifecycle as tlife  # noqa: E402
from procgen_tpu_torch.core import rng as trng  # noqa: E402
from procgen_tpu_torch.core.constants import INT32_MAX, fnv1a_32  # noqa: E402
from procgen_tpu_torch.core.game import tree_map, tree_where  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.games.ninja import (  # noqa: E402
    BOMB, THROWING_STAR, WALL_MID, Ninja, NinjaState,
)
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402
from procgen_tpu_torch.utils.host_mt import HostMT19937  # noqa: E402

N = 3
STEPS = 40
# run -> (distribution mode, master seed, action seed)
RUNS = {"easy": (0, 31, 0), "hard": (1, 32, 1)}
CAMERAS = ("world", "centred")
GEN_STEPS = 4  # the generated-assets run (easy, the whole world)
SEP = "::"
FORCED = 20  # env 1 is forced to reset at this step
SPACE = 100
EXPLOSION = 54


def _seeds(master_seed):
    m = HostMT19937(master_seed)
    return np.array([m.next_u32() for _ in range(N)], np.int64)


def _actions(action_seed, steps=STEPS):
    """[steps, N] actions, most of them a jump or a throwing star; env 1
    is forced to reset at step ``FORCED``."""
    rng = np.random.RandomState(action_seed)
    out = []
    for t in range(steps):
        a = np.where(rng.rand(N) < 0.7, rng.choice([2, 5, 8, 8, 7, 1, 9, 10, 11, 12], N),
                     rng.randint(0, 15, N)).astype(np.int32)
        if t == FORCED:
            a[1] = -1
        out.append(a)
    return np.stack(out)


def _frame_steps():
    return np.arange(0, STEPS + 1, 8)


def _asset_seed():
    return int(np.int32(np.uint32(fnv1a_32("ninja"))))


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
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    import dataclasses

    from procgen_tpu_torch.core.game import BasicState

    for f in dataclasses.fields(BasicState):
        out.setdefault(f.name, None)
    return out


# ---------------------------------------------------------------------------
# the made-up scenes of the star dispatch (a reset state, edited)
# ---------------------------------------------------------------------------


def _star(e, env, slot, x, y):
    """A throwing star in ``slot`` of env ``env`` (numpy leaves, the JAX
    package's layout), standing still at (x, y)."""
    for k, v in dict(x=x, y=y, vx=0.0, vy=0.0, rx=0.25, ry=0.25, type=THROWING_STAR,
                     image_type=THROWING_STAR, smart_step=True, will_erase=False,
                     collides_with_entities=True, expire_time=15, life_time=2,
                     alpha=1.0, grow_rate=1.0, health=1.0, friction=1.0,
                     auto_erase=True).items():
        e[k][env, slot] = v


def _scene(tree):
    """Edit a 3-env ninja reset state (``serialization.to_state_dict``
    leaves as numpy) into the dispatch scenes of the module docstring."""
    grid, e = tree["grid"], tree["ents"]
    tree["done"][:] = False
    grid[:, 1:63, 1:63] = SPACE
    e["x"][:, 1], e["y"][:, 1] = 60.5, 60.5  # the mushroom, out of the way
    # env 0: stars in slots 2 and 3 both probe the BOMB at (10, 40); the
    # agent stands on it
    grid[0, 40, 10] = BOMB
    grid[0, 20, 30] = 14  # a FIRE cell nobody touches
    _star(e, 0, 2, 10.2, 40.5)
    _star(e, 0, 3, 10.8, 40.5)
    e["x"][0, 0], e["y"][0, 0] = 10.5, 40.5
    e["count"][0] = 4
    # env 1: the agent on a BOMB nobody booms; a star probing a wall, one
    # booming a BOMB alone
    grid[1, 30, 20] = BOMB
    grid[1, 30, 5] = WALL_MID
    grid[1, 30, 40] = BOMB
    _star(e, 1, 2, 5.6, 30.5)
    _star(e, 1, 3, 40.5, 30.5)
    e["x"][1, 0], e["y"][1, 0] = 20.5, 30.5
    e["count"][1] = 4
    # env 2: 13 stars booming 13 BOMBs, one free slot
    for i in range(13):
        grid[2, 50, 3 + 4 * i] = BOMB
        _star(e, 2, 2 + i, 3.5 + 4 * i, 50.5)
    e["x"][2, 0], e["y"][2, 0] = 30.5, 10.5
    e["count"][2] = 15
    return tree


# ---------------------------------------------------------------------------
# the JAX reference (child process)
# ---------------------------------------------------------------------------


def _jax_game(mode, centred=False, generated=False):
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game

    game = make_game("ninja", JGameOptions(distribution_mode=mode, center_agent=centred,
                                           use_generated_assets=generated))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    if generated:
        game.fixed_asset_seed = _asset_seed()
    return game


def _jax_reference(out_path):
    """Run both modes and render the states of ``_frame_steps`` under both
    cameras; the dispatch scenes; then the generated-assets run.  Saves the
    arrays, keyed ``run::part::leaf``."""
    from procgen_tpu.core import lifecycle
    from procgen_tpu.core import rng as jrng
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

    # the dispatch scenes
    game = _jax_game(0)
    s0 = run_states(game, _seeds(33), [], False)[0]
    tree = jax.tree_util.tree_map(np.array, serialization.to_state_dict(s0))
    s_in = serialization.from_state_dict(s0, _scene(tree))
    s_out = jax.jit(jax.vmap(lambda s: game.dispatch_collisions(
        s, jrng.peek_block(s.rand_gen, game.MAX_STEP_DRAWS)[0])[0]))(s_in)
    for part, st in (("in", s_in), ("out", s_out)):
        for leaf, v in _flat(serialization.to_state_dict(st)).items():
            out[SEP.join(("scene", part, leaf))] = v

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
    out_dir = tmp_path_factory.mktemp("ninja")
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
    game = Ninja(GameOptions(distribution_mode=mode, center_agent=centred,
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


REPLAYS = ("ninja_easy", "ninja_hard")


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
    assert isinstance(states[-1].game, NinjaState)


@pytest.mark.parametrize("run", list(RUNS))
def test_trajectories_reach_the_machinery(run, port):
    """The runs jump (the agent rises), throw stars, stop some of them
    against a wall (a star at rest), charge a jump, and end an episode
    (the forced reset among them)."""
    states = port[run][0]
    rises = sum(int((s1.ents.y[:, 0] > s0.ents.y[:, 0]).sum())
                for s0, s1 in zip(states, states[1:]))
    assert rises >= 10
    stars = [(s.ents.active & (s.ents.type == THROWING_STAR)) for s in states]
    assert sum(int(m.sum()) for m in stars) >= 20
    stopped = sum(int((m & (s.ents.vx == 0) & (s.ents.vy == 0)).sum())
                  for m, s in zip(stars, states))
    assert stopped >= 1
    if run == "hard":  # easy charges a jump in one step
        assert any(bool(((s.game.jump_charge > 0) & (s.game.jump_charge < 1)).any())
                   for s in states)
    resets = sum(int((s1.cur_time < s0.cur_time).sum()) for s0, s1 in zip(states, states[1:]))
    assert resets >= 1 and int(states[FORCED + 1].cur_time[1]) == 0


def test_star_dispatch_scenes(ref):
    """``dispatch_collisions`` (the agent's hits, then ``dispatch_grid_vec``)
    on the made-up scenes: every leaf equals the JAX package's, and the
    scenes do what the module docstring says."""
    prefix = SEP.join(("scene", "in")) + SEP
    tree = _unflat({k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)})
    game = _torch_game(0)
    s = state_from_numpy(tree, game)
    out, _ = game.dispatch_collisions(s, trng.peek_block(s.rand_gen, game.MAX_STEP_DRAWS)[0])
    got = _flat(state_to_numpy(out))
    prefix = SEP.join(("scene", "out")) + SEP
    want = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    assert set(want) == set(got), set(want) ^ set(got)
    for leaf, w in want.items():
        assert got[leaf].dtype == w.dtype, leaf
        np.testing.assert_array_equal(got[leaf], w, err_msg=leaf)

    e = out.ents
    expl = e.active & (e.type == EXPLOSION)
    # env 0: slot 3 booms (10, 40), slot 2 lives, the agent too
    assert e.will_erase[0].tolist()[:4] == [False, False, False, True]
    assert int(expl[0].sum()) == 1 and float(e.x[0, 4]) == 10.5
    assert int(out.grid[0, 40, 10]) == SPACE and not bool(out.done[0])
    # env 1: the agent dies on its BOMB; the wall star sticks, the other booms
    assert bool(out.done[1]) and int(out.grid[1, 30, 20]) == BOMB
    assert e.will_erase[1, 2] and e.will_erase[1, 3] and int(expl[1].sum()) == 1
    assert int(out.grid[1, 30, 40]) == SPACE
    # env 2: 13 booms, one explosion fits: the highest slot's
    assert int(e.count[2]) == 16 and int(expl[2].sum()) == 1
    assert float(e.x[2, 15]) == 3 + 4 * 12 + 0.5
    assert bool((out.grid[2, 50] == BOMB).sum() == 0)


def test_star_dispatch_is_the_reverse_scan():
    """``dispatch_grid_vec`` on the scenes equals the reference's own
    order, the grid handler (``handle_grid_collision``) run slot by slot
    from the highest live smart slot down (``check_grid_collisions``),
    every leaf."""
    game = _torch_game(0)
    s = tlife.env_reset(game, tlife.initial_state(game, torch.as_tensor(_seeds(33))))
    s = state_from_numpy(_scene(state_to_numpy(s)), game)
    d = trng.peek_block(s.rand_gen, game.MAX_STEP_DRAWS)[0]
    vec, _ = game.dispatch_grid_vec(s, d)
    seq = s
    for i in range(game.ENT_CAP - 1, -1, -1):
        do = (i < seq.ents.count) & seq.ents.smart_step[:, i]
        s2, _ = game.check_grid_collisions(seq, d, i)
        seq = tree_where(do, s2, seq)
    got, want = _flat(state_to_numpy(vec)), _flat(state_to_numpy(seq))
    assert set(got) == set(want)
    for leaf, w in want.items():
        np.testing.assert_array_equal(got[leaf], w, err_msg=leaf)
    assert int((vec.ents.active & (vec.ents.type == EXPLOSION)).sum()) == 3


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
    equals the Pallas kernel (the centred view of ``visibility`` cells fits
    the ``visibility + 3`` window) except on pixel rows whose world y is an
    integer, a cell boundary: the XLA renderer's ``floor(wys)`` picks the
    cell above it, the Pallas window's top-down pick the cell below.  Hard
    mode's centred camera (16 cells, 4 pixels a cell) puts rows there when
    the agent stands on a platform; the port's two paths part the same way
    (ROADMAP Queue 3)."""
    _, _, _, plain, x = port[run][1][cam]
    want = ref[SEP.join((_key(run, cam), "xla"))]
    np.testing.assert_array_equal(plain, want)
    part = (want != ref[SEP.join((_key(run, cam), "pallas"))]).any(axis=-1)
    _, wys, inside, *_ = rk.grid_lookup(x)
    boundary = (wys == torch.floor(wys))[:, :, None] & inside
    assert not (part & ~boundary.numpy()).any()
    if (run, cam) == ("hard", "centred"):
        assert part.any()


@pytest.mark.parametrize("run,cam", CASES)
def test_prep_matches_pallas_prep(run, cam, ref, port):
    game, batch, _, _, x = port[run][1][cam]
    plan = rk.get_plan(game)
    window = {"world": 64, "centred": int(game.visibility) + 3}[cam]
    assert not plan.static and plan.NC == window
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
def test_jump_charge_bar_is_drawn(run, port):
    """Under the centred camera a charge of 0.25 or more is a bar of
    3 x charge cells above the bottom-left corner, in (66, 245, 135): the
    frames of the charged states show it there, the others do not."""
    _, batch, frames, _, _ = port[run][1]["centred"]
    bar = (frames[:, 32:, 1:3] == (66, 245, 135)).all(axis=-1).any(axis=(1, 2))
    charged = (batch.game.jump_charge > 0).numpy()
    assert charged.any()
    np.testing.assert_array_equal(bar, charged)


@pytest.mark.parametrize("name", REPLAYS)
def test_conformance_replay(name, replays):
    rec, res = replays[name]
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == res["steps"] == len(rec["actions"])


if __name__ == "__main__":
    from test_torch_refstate import patch_jax_cpp_arithmetic

    patch_jax_cpp_arithmetic()
    _jax_reference(sys.argv[1])
