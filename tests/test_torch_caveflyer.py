"""The port's caveflyer against the JAX package's and the C++ recordings.

* Easy, hard and memory (30, 40 and 60 cells), 3 envs, 40 steps each (a
  third of them shots), an episode's end resetting its env at once (both
  packages' ``env_step``, then ``env_reset`` where an env is done), env 1
  forced to reset at step 20, env 2's ship set turning at 118.25, -119 or
  10^4 rad after the first reset so that its heading runs past 120 rad:
  every ``BasicState`` leaf (the cave, both pools, ``rand_gen`` included),
  bit-equal.
* A scene a mode: the states of step 10 with the free slots of the
  entity pool filled with bullets over the targets, obstacles, enemies and
  the goal (two on each in turn, the targets at health 1 or 2) and over
  empty cells, stepped once: every leaf bit-equal; targets die, bullets
  explode with their highest source's velocity, and the decor pool of 32
  drops the explosions past its cap.
* The frames of the states of steps 0, 20 and 40 under the whole-world
  camera (30, 40 and 60 cells: memory's is 151 entity and 32 decor slots
  over a 60x60 window) and the agent-centred one (13 cells easy, 19 hard
  and memory): ``render_kernel.render_obs_batch`` (on CPU tensors, the
  plain version of the whole-frame kernel) against the Pallas kernel run
  in interpret mode, the port's ``renderer.render_obs`` against the XLA
  ``render_obs``, and ``prep_frame`` against the Pallas kernel's
  ``_prep_one``.  The easy batches add 6 states whose every live slot of
  both pools (the ship, its bullets and exhaust among them) turns to
  angles from -10^4 to 10^4 rad: quarter turns and angles within 1e-4 of
  them, the rotation banks' bucket edges and angles drawn at random.
* Generated assets: 3 envs reset and stepped 4 times, every leaf, and
  the frames of both states against Pallas and XLA.
* ``ProcgenGym3Env``'s centred camera in the three modes, and
  caveflyer_easy, caveflyer_hard and caveflyer_memory replay exactly.

The JAX reference runs in two child processes (this file run as a
script), memory mode in one and the other runs in the other, while the
port runs its own and replays the recordings; their XLA is held
to AVX (``--xla_cpu_max_isa=AVX``) and takes the C++ arithmetic of
``test_torch_refstate.patch_jax_cpp_arithmetic`` (caveflyer's thrust,
headings and exhaust in double).

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
from procgen_tpu_torch.core.constants import EXPLOSION, INT32_MAX, fnv1a_32  # noqa: E402
from procgen_tpu_torch.core.game import tree_map, tree_where  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.games.caveflyer import (  # noqa: E402
    ENEMY, EXHAUST, GOAL, OBSTACLE, PLAYER_BULLET, TARGET, Caveflyer,
)
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402
from procgen_tpu_torch.utils.host_mt import HostMT19937  # noqa: E402

N = 3
STEPS = 40
# run -> (distribution mode, master seed, action seed)
RUNS = {"easy": (0, 91, 0), "hard": (1, 92, 1), "memory": (10, 93, 2)}
# env 2's ship after the first reset, and the way it turns
SPIN = {"easy": (118.25, 1), "hard": (-119.0, -1), "memory": (1.0e4, 1)}
CAMERAS = ("world", "centred")
CASES = [(run, cam) for run in RUNS for cam in CAMERAS]
GEN_STEPS = 4  # the generated-assets run (easy)
SEP = "::"
FORCED = 20  # env 1 is forced to reset at this step
FRAME_STEPS = (0, 20, 40)
SCENE_STEP = 10
BANK = 6  # the easy batches' turned states


def _seeds(master_seed, n=N):
    m = HostMT19937(master_seed)
    return np.array([m.next_u32() for _ in range(n)], np.int64)


def _actions(run, steps=STEPS):
    """[steps, N] actions: envs 0 and 1 fire a third of the time and
    thrust, turn or drift otherwise; env 2 turns one way, thrusting every
    other step; env 1 is forced to reset at step ``FORCED``."""
    rng = np.random.RandomState(RUNS[run][2])
    sign = SPIN[run][1]
    out = []
    for t in range(steps):
        a = np.where(rng.rand(N) < 0.33, 9, rng.choice([8, 5, 2, 6, 0, 7, 1, 4], N))
        a[2] = (8 if t % 2 else 6) if sign > 0 else (2 if t % 2 else 0)
        if t == FORCED:
            a[1] = -1
        out.append(a.astype(np.int32))
    return np.stack(out)


def _asset_seed():
    return int(np.int32(np.uint32(fnv1a_32("caveflyer"))))


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


def _spin(tree, run):
    """``tree`` (a state dict, numpy leaves) with env 2's ship at
    ``SPIN[run]``'s angle."""
    tree["ents"]["rotation"] = np.array(tree["ents"]["rotation"])
    tree["ents"]["rotation"][2, 0] = np.float32(SPIN[run][0])
    return tree


def _scene(tree):
    """The scene of a state dict (numpy leaves): in each env the free
    slots of the entity pool become bullets, two at a time over each
    target, obstacle, enemy and goal in turn, one in eight over a random
    cell instead; the targets at health 1 or 2."""
    tree = jax.tree_util.tree_map(np.array, tree)
    e = tree["ents"]
    n, cap = e["x"].shape
    rs = np.random.RandomState(5)
    for env in range(n):
        c = int(e["count"][env])
        src = [i for i in range(c) if e["type"][env, i] in (TARGET, OBSTACLE, ENEMY, GOAL)]
        for i in src:
            if e["type"][env, i] == TARGET:
                e["health"][env, i] = np.float32(1 + i % 2)
        w = int(tree["main_width"][env])
        k = 0
        while c < cap:
            if k % 8 == 7 or not src:
                x, y = np.float32(rs.randint(0, w) + 0.5), np.float32(rs.randint(0, w) + 0.5)
            else:
                i = src[(k - k // 8) // 2 % len(src)]
                x, y = e["x"][env, i], e["y"][env, i]
            k += 1
            for f, v in dict(x=x, y=y, vx=0.0, vy=0.0, rx=0.1, ry=0.25, type=PLAYER_BULLET,
                             image_type=PLAYER_BULLET, image_theme=0, will_erase=False,
                             collides_with_entities=False, collision_margin=0.0,
                             rotation=rs.uniform(-7, 7), is_reflected=False, vrot=0.0,
                             alpha=1.0, grow_rate=1.0, alpha_decay=1.0, fire_time=-1,
                             spawn_time=-1, expire_time=10, life_time=0, health=1.0,
                             theta=-100.0, friction=1.0, smart_step=False,
                             avoids_collisions=False, auto_erase=True, render_z=0,
                             use_abs_coords=False, climber_spawn_x=0.0).items():
                e[f][env, c] = v
            c += 1
        e["count"][env] = c
    return tree


def _banked(tree, seed):
    """``tree`` (a 3-env state dict) twice, every live slot of both pools
    turned: a quarter turn k pi / 2 (|k| up to 6366, so up to 10^4 rad),
    one within 1e-4 of one (inside or outside the threshold), a bucket edge
    (b + 1/2) 2 pi / 32 of the banks, or an angle from -10^4 to 10^4."""
    tree = jax.tree_util.tree_map(lambda a: np.concatenate([np.asarray(a)] * 2), tree)
    rs = np.random.RandomState(seed)
    f32 = np.float32
    for pool in ("ents", "decor"):
        rot = tree[pool]["rotation"]
        shape = rot.shape
        k = rs.randint(-6366, 6367, shape)
        quarter = f32(k * (np.pi / 2))
        near = f32(k * (np.pi / 2) + rs.choice([-2e-4, -5e-5, 5e-5, 2e-4], shape))
        edge = f32((rs.randint(-50000, 50000, shape) + 0.5) * (2 * np.pi / 32))
        wide = rs.uniform(-1e4, 1e4, shape).astype(f32)
        tree[pool]["rotation"] = np.choose(rs.randint(0, 4, shape),
                                           [quarter, near, edge, wide]).astype(f32)
    return tree


# ---------------------------------------------------------------------------
# the JAX reference (child process)
# ---------------------------------------------------------------------------


def _jax_game(mode, centred=False, generated=False):
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game

    game = make_game("caveflyer", JGameOptions(distribution_mode=mode, center_agent=centred,
                                               use_generated_assets=generated))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    if generated:
        game.fixed_asset_seed = _asset_seed()
    return game


def _jax_reference(out_path, runs):
    """The runs ``runs`` (of ``RUNS`` and "genassets"): each mode's run,
    its scene and its frames under both cameras (easy's with the turned
    states); the generated-assets run.  Saves the arrays, keyed
    ``run::part::leaf``."""
    from procgen_tpu.core import lifecycle
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
                "prep" + SEP + k: prep[k]
                for k in ("sf", "si", "cell5", "ent_f", "ent_i", "dec_f", "dec_i")}}

        arrays = {"pallas": jax.jit(
            lambda st: pallas_kernel.render_obs_batch(game, st, 64, interpret=True)
        )(batch), **jax.jit(jax.vmap(xla_and_prep))(batch)}
        at = 0
        for key, size in parts:
            for name, v in arrays.items():
                out[SEP.join((key, name))] = np.asarray(v[at:at + size])
            at += size

    host = lambda st: jax.tree_util.tree_map(np.asarray, st)  # noqa: E731

    def tree_of(st):
        return jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(st))

    def run_states(game, seeds, actions, auto_reset, run=None):
        init = jax.jit(jax.vmap(lambda sd: lifecycle.initial_state(game, sd)))
        reset = jax.jit(jax.vmap(lambda s: lifecycle.env_reset(game, s)))
        step = jax.jit(jax.vmap(lambda s, a: lifecycle.env_step(game, s, a)))
        # every state as host arrays: their types carry no weak flags, so
        # that each program is traced and compiled once
        s = host(reset(host(init(jnp.asarray(seeds, jnp.uint32)))))
        if run is not None:
            s = serialization.from_state_dict(s, _spin(tree_of(s), run))
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

    for run, (mode, mseed, _) in RUNS.items():
        if run not in runs:
            continue
        states, step = run_states(_jax_game(mode), _seeds(mseed), _actions(run), True, run)
        save_states(run, states)
        scene = serialization.from_state_dict(states[SCENE_STEP],
                                              _scene(tree_of(states[SCENE_STEP])))
        save(SEP.join((run, "scene", "in")), scene)
        save(SEP.join((run, "scene", "out")),
             host(step(scene, jnp.full((N,), 4, jnp.int32))[0]))
        batch = [states[t] for t in FRAME_STEPS]
        parts = [(SEP.join((run, "frames")), len(FRAME_STEPS) * N)]
        if run == "easy":
            banked = serialization.from_state_dict(
                jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs), *[states[20]] * 2),
                _banked(tree_of(states[20]), 7))
            save(SEP.join(("bank", "in")), banked)
            batch.append(banked)
            parts.append(("bank", BANK))
        for cam in CAMERAS:
            frames([(SEP.join((k, cam)), n) for k, n in parts],
                   _jax_game(mode, centred=cam == "centred"), *batch)

    if "genassets" in runs:
        game = _jax_game(0, generated=True)
        states, _ = run_states(game, _seeds(23), _actions("easy", GEN_STEPS), False)
        save_states("genassets", states)
        frames([(SEP.join(("genassets", "frames", "world")), 2 * N)], game, states[0],
               states[-1])
    np.savez(out_path, **out)


# the JAX children and their runs: memory mode's reset alone traces and
# compiles for about 80 s (151 objects, a 60x60 cave), so it has a child
# of its own beside the other three runs' (a third child, for hard mode,
# saves no time on 8 cores)
CHILDREN = (("easy", "hard", "genassets"), ("memory",))


@pytest.fixture(scope="module")
def jax_child(tmp_path_factory):
    """Start the JAX reference in child processes (``CHILDREN``); yields
    [(output path, process, stderr path)] of each."""
    out_dir = tmp_path_factory.mktemp("caveflyer")
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"{flags} --xla_cpu_max_isa=AVX".strip(),
        JAX_COMPILATION_CACHE_DIR=jax.config.jax_compilation_cache_dir or "",
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="1",
    )
    children = []
    for i, runs in enumerate(CHILDREN):
        path, log = out_dir / f"ref{i}.npz", out_dir / f"ref{i}.log"
        with open(log, "w") as err:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(path), *runs],
                env=env, stdout=subprocess.DEVNULL, stderr=err)
        children.append((path, proc, log))
    yield children
    for _, proc, _ in children:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def ref(jax_child, port, replays):
    """The JAX reference's arrays (waited for after the port's runs and
    replays)."""
    out = {}
    for path, proc, log in jax_child:
        assert proc.wait(timeout=1800) == 0, log.read_text()[-4000:]
        with np.load(path) as z:
            out.update({k: z[k] for k in z.files})
    return out


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def _torch_game(mode, centred=False, generated=False):
    game = Caveflyer(GameOptions(distribution_mode=mode, center_agent=centred,
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


def _run(game, seeds, actions, auto_reset, run=None):
    s = tlife.env_reset(game, tlife.initial_state(game, torch.as_tensor(seeds)))
    if run is not None:
        s = state_from_numpy(_spin(state_to_numpy(s), run), game)
    states = [s]
    for a in actions:
        s, done = tlife.env_step(game, s, torch.as_tensor(a))
        if auto_reset:
            s = tree_where(done, tlife.env_reset(game, s), s)
        states.append(s)
    return states


@pytest.fixture(scope="module")
def port(jax_child):
    """Per run: the port's states of every step and the frames of
    ``FRAME_STEPS`` under each camera; then the generated-assets run's.
    Computed while the JAX reference runs."""
    out = {}
    with _one_thread():
        for run, (mode, mseed, _) in RUNS.items():
            states = _run(_torch_game(mode), _seeds(mseed), _actions(run), True, run)
            batch = _cat([states[t] for t in FRAME_STEPS])
            out[run] = (states, {cam: _frames(_torch_game(mode, cam == "centred"), batch)
                                 for cam in CAMERAS})
        game = _torch_game(0, generated=True)
        states = _run(game, _seeds(23), _actions("easy", GEN_STEPS), False)
        out["genassets"] = (states, {"world": _frames(game, _cat([states[0], states[-1]]))})
    return out


REPLAYS = ("caveflyer_easy", "caveflyer_hard", "caveflyer_memory")


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


def _assert_leaves(want, got, what):
    assert set(want) == set(got[0]), set(want) ^ set(got[0])
    for leaf, w in want.items():
        g = np.stack([t[leaf] for t in got])
        assert g.dtype == w.dtype, (what, leaf, g.dtype, w.dtype)
        for t in range(len(got)):
            np.testing.assert_array_equal(g[t], w[t], err_msg=f"{what} {t}: {leaf}")


@pytest.mark.parametrize("run", list(RUNS) + ["genassets"])
def test_states_match(run, ref, port):
    states = port[run][0]
    _assert_leaves(_leaves(ref, SEP.join((run, "states"))),
                   [_flat(state_to_numpy(t)) for t in states], run)
    assert states[-1].game is None  # caveflyer keeps no state of its own


@pytest.mark.parametrize("run", list(RUNS))
def test_trajectories_reach_the_machinery(run, port):
    """The runs fire, thrust (exhaust), explode bullets on cave walls,
    turn env 2's ship past 120 rad, and end an episode (the forced reset
    among them)."""
    states = port[run][0]
    ents = [s.ents for s in states]
    decor = [s.decor for s in states]
    assert sum(int((e.active & (e.type == PLAYER_BULLET)).sum()) for e in ents) >= 20
    assert any(bool((d.active & (d.type == EXHAUST)).any()) for d in decor)
    assert any(bool((d.active & (d.type == EXPLOSION)).any()) for d in decor)
    assert max(abs(float(e.rotation[2, 0])) for e in ents) > 120
    resets = sum(int((s1.cur_time < s0.cur_time).sum()) for s0, s1 in zip(states, states[1:]))
    assert resets >= 1 and int(states[FORCED + 1].cur_time[1]) == 0


@pytest.mark.parametrize("run", list(RUNS))
def test_scene_matches(run, ref):
    """The bullet scene stepped once: every leaf equal; targets die (+3
    each), every bullet over a source explodes with that source's
    velocity or the highest one's, and the decor pool fills to its cap
    with explosions dropped past it."""
    game = _torch_game(RUNS[run][0])
    s_in = state_from_numpy(_unflat(_leaves(ref, SEP.join((run, "scene", "in")))), game)
    with _one_thread():
        s_out, _ = tlife.env_step(game, s_in, torch.full((N,), 4, dtype=torch.int32))
    want = _leaves(ref, SEP.join((run, "scene", "out")))
    _assert_leaves({k: v[None] for k, v in want.items()}, [_flat(state_to_numpy(s_out))],
                   f"{run} scene")
    e = s_in.ents
    bullets = int((e.active & (e.type == PLAYER_BULLET)).sum())
    assert bullets >= 3 * 20
    kills = (e.active & (e.type == TARGET)).sum(dim=1) - (
        s_out.ents.active & (s_out.ents.type == TARGET)).sum(dim=1)
    assert int(kills.sum()) > 0 and bool((s_out.reward >= 3 * kills.to(torch.float32)).all())
    # more explosions than room: the pool is full and the rest dropped
    hits = int((e.active & (e.type == PLAYER_BULLET)).sum(dim=1).min())
    assert hits > game.DECOR_CAP and bool((s_out.decor.count == game.DECOR_CAP).any())


@pytest.mark.parametrize("run,cam", CASES + [("genassets", "world")])
def test_frames_match_pallas_interpret_and_xla(run, cam, ref, port):
    """The kernel path equals the Pallas kernel, the plain renderer the
    XLA renderer.  The two JAX paths agree except, under the centred
    camera, where they pick another cell for a pixel (ROADMAP Queue 3):
    the XLA renderer takes ``floor(wxs)`` and ``floor(wys)``, the Pallas
    kernel the window's cell, ``floor((wxs - low_x) * sA) / sA``; the
    port's two paths part the same way."""
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


@pytest.mark.parametrize("run,cam", CASES + [("genassets", "world")])
def test_prep_matches_pallas_prep(run, cam, ref, port):
    game, batch, _, _, x = port[run][1][cam]
    plan = rk.get_plan(game)
    assert not plan.static and plan.bg_mode == rk.BG_CROP
    assert plan.NC == (int(game.visibility) + 3 if cam == "centred" else game.world_dim)
    assert x.ent_f.shape[1] == game.ENT_CAP and x.dec_f.shape[1] == game.DECOR_CAP == 32
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
    for k in ("ent_f", "ent_i", "dec_f", "dec_i"):
        np.testing.assert_array_equal(getattr(x, k).numpy(), ref[key + k], err_msg=k)


@pytest.mark.parametrize("cam", CAMERAS)
def test_banked_angles(cam, ref):
    """The turned states: both of the port's paths equal the Pallas
    kernel's and the XLA renderer's frames, the slots' rows (the banks'
    buckets, the quarter-turn test) equal the Pallas prep's, and the ship,
    the bullets and the exhaust sit on bank rows at angles beyond 120
    rad."""
    tree = _unflat(_leaves(ref, SEP.join(("bank", "in"))))
    game = _torch_game(0, cam == "centred")
    s = state_from_numpy(tree, game)
    kernel = rk.render_obs_batch(game, s).numpy()
    plain = trender_obs(game, s, 64).numpy()
    key = SEP.join(("bank", cam)) + SEP
    np.testing.assert_array_equal(kernel, ref[key + "pallas"])
    np.testing.assert_array_equal(plain, ref[key + "xla"])
    x = rk.prep_frame(rk.get_plan(game), s)
    for k in ("ent_f", "ent_i", "dec_f", "dec_i"):
        np.testing.assert_array_equal(getattr(x, k).numpy(), ref[key + "prep" + SEP + k],
                                      err_msg=k)
    # the bank rows follow the transparent row among the untransposed ones
    first = rk.get_plan(game).ent_atlas.transparent_row + 1
    n1e = rk.get_plan(game).n1e
    for pool, xi, types in ((s.ents, x.ent_i, (0, PLAYER_BULLET)), (s.decor, x.dec_i, (EXHAUST,))):
        row = xi[..., rk.EI_ROW]
        banked = (row >= first) & (row < n1e)
        far = pool.active & (torch.abs(pool.rotation) > 120)
        for t in types:
            assert bool((banked & far & (pool.type == t)).any()), (t, cam)


@pytest.mark.parametrize("mode", ["easy", "hard", "memory"])
def test_gym3_env_camera(mode):
    """``ProcgenGym3Env``'s default centred camera: 13 cells easy, 19 hard
    and memory, through the kernel path."""
    env = ProcgenGym3Env(num=2, env_name="caveflyer", rand_seed=0, distribution_mode=mode,
                         device="cpu")
    game = env._vec.game
    assert game.center_agent and rk.supports(game)
    assert rk.get_plan(game).NC == {"easy": 13, "hard": 19, "memory": 19}[mode]
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
    _jax_reference(sys.argv[1], sys.argv[2:])
