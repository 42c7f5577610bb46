"""The eight ported games under ``use_generated_assets`` against the JAX
package.

For each of maze, miner, coinrun, fruitbot, starpilot, plunder, leaper
and bigfish (easy, the whole-world camera), 2 envs with generated
assets: ``initial_state``, ``env_reset`` and 8 random ``env_step``s,
every ``BasicState`` leaf of every step bit-equal (``bg_canvas``, the
painted background, and ``rand_gen``, advanced by the painter's words,
among them); the frames of steps 0, 4 and 8, and of coinrun's under the
agent-centred camera too, through ``render_kernel.render_obs_batch`` (on
CPU tensors, the plain versions of the frame kernels with the painted
canvas as the background) and ``renderer.render_obs`` against the XLA
``render_obs``, and for coinrun, miner and starpilot against the Pallas
kernel in interpret mode. Fruitbot's tiled canvas is where the JAX
package's two renderers part: its Pallas prep never sets the tile height
of a painted canvas (pallas_kernel.py:279 before :292), so the kernel
divides by 0; the port follows XLA, and the test asserts both facts
(ROADMAP Queue 3).

The JAX reference runs in four child processes started together (this
file run as a script; tracing and compiling the reset with the painter is
most of their time, 120 s for fruitbot alone with a cold cache) whose XLA
is held to AVX (``--xla_cpu_max_isa=AVX``), as in
tests/test_torch_plunder.py: XLA's CPU backend otherwise contracts ``a *
b + c`` into a fused multiply-add, which the painter's colors and blends
would show.  The port runs meanwhile.

The children also hold the JAX package to the C++ arithmetic where C++
evaluates a float expression in double (the agent's velocity decay of
fruitbot, starpilot and plunder, starpilot's spawner velocities and
plunder's lane speeds): ``test_torch_refstate.patch_jax_cpp_arithmetic``
evaluates those expressions in f64 and rounds once, in the children only.

Tolerance: zero.
"""

import contextlib
import dataclasses
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
from procgen_tpu_torch.core import lifecycle as tlife  # noqa: E402
from procgen_tpu_torch.core.constants import EASY_MODE, INT32_MAX, fnv1a_32  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.games.registry import make_game  # noqa: E402
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402
from procgen_tpu_torch.utils.host_mt import HostMT19937  # noqa: E402

N = 2
STEPS = 8
FRAME_STEPS = (0, 4, 8)
GAMES = ("maze", "miner", "coinrun", "fruitbot", "starpilot", "plunder", "leaper",
         "bigfish")
# rendered runs -> (game, centred camera); the camera leaves the step
# logic alone, so the centred run renders coinrun's states
RUNS = {name: (name, False) for name in GAMES}
RUNS["coinrun_centred"] = ("coinrun", True)
PALLAS = ("miner", "coinrun", "coinrun_centred", "starpilot", "fruitbot")
# the JAX children's games, about the same time each
CHILDREN = (("fruitbot",), ("coinrun", "starpilot"), ("maze", "miner", "plunder"),
            ("leaper", "bigfish"))
SEP = "::"


def _seeds(name):
    m = HostMT19937(100 + GAMES.index(name))
    return np.array([m.next_u32() for _ in range(N)], np.int64)


def _actions(name):
    return np.random.RandomState(GAMES.index(name)).randint(
        0, 15, (STEPS, N)).astype(np.int32)


def _asset_seed(name):
    """The vector runtime's fixed_asset_seed (vecgame.cpp): the game name's
    FNV-1a hash as an int32."""
    return int(np.int32(np.uint32(fnv1a_32(name))))


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


def _jax_reference(out_path, names):
    from procgen_tpu.core import lifecycle
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game as jmake_game
    from procgen_tpu.render import atlas, pallas_kernel
    from procgen_tpu.render.renderer import render_obs

    jax.config.update("jax_platforms", "cpu")
    out = {}
    states_of = {}
    for run, (name, centred) in RUNS.items():
        if name not in names:
            continue
        # the JAX package's atlas and plan caches ignore center_agent
        atlas._CACHE.clear()
        pallas_kernel._PLANS.clear()
        game = jmake_game(name, JGameOptions(
            distribution_mode=EASY_MODE, use_generated_assets=True,
            center_agent=centred))
        game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        game.fixed_asset_seed = _asset_seed(name)
        if name not in states_of:
            init = jax.jit(jax.vmap(lambda sd: lifecycle.initial_state(game, sd)))
            reset = jax.jit(jax.vmap(lambda s: lifecycle.env_reset(game, s)))
            step = jax.jit(jax.vmap(lambda s, a: lifecycle.env_step(game, s, a)))
            s = reset(init(jnp.asarray(_seeds(name), jnp.uint32)))
            states = [s]
            for a in _actions(name):
                s, _ = step(s, jnp.asarray(a))
                states.append(s)
            trees = [_flat(serialization.to_state_dict(t)) for t in states]
            for leaf in trees[0]:
                out[SEP.join((name, "states", leaf))] = np.stack([t[leaf] for t in trees])
            states_of[name] = states
        states = states_of[name]
        batch = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs), *[states[t] for t in FRAME_STEPS])
        out[SEP.join((run, "xla"))] = np.asarray(
            jax.jit(jax.vmap(lambda st: render_obs(game, st, 64)))(batch))
        if run in PALLAS:
            out[SEP.join((run, "pallas"))] = np.asarray(jax.jit(
                lambda st: pallas_kernel.render_obs_batch(game, st, 64, interpret=True)
            )(batch))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_children(tmp_path_factory):
    """Start the JAX reference, one child per entry of CHILDREN, all at
    once; yields a list of (output path, process, stderr path)."""
    out_dir = tmp_path_factory.mktemp("genassets")
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"{flags} --xla_cpu_max_isa=AVX".strip(),
        JAX_COMPILATION_CACHE_DIR=jax.config.jax_compilation_cache_dir or "",
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="1",
    )
    children = []
    for k, names in enumerate(CHILDREN):
        path, log = out_dir / f"ref{k}.npz", out_dir / f"ref{k}.log"
        with open(log, "w") as err:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(path), *names],
                env=env, stdout=subprocess.DEVNULL, stderr=err)
        children.append((path, proc, log))
    yield children
    for _, proc, _ in children:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def ref(jax_children, port):
    """The JAX reference's arrays (waited for after the port's runs)."""
    out = {}
    for path, proc, log in jax_children:
        assert proc.wait(timeout=1800) == 0, log.read_text()[-4000:]
        with np.load(path) as z:
            out.update({k: z[k] for k in z.files})
    return out


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def _torch_game(name, centred):
    game = make_game(name, GameOptions(distribution_mode=EASY_MODE,
                                       use_generated_assets=True,
                                       center_agent=centred))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    game.fixed_asset_seed = _asset_seed(name)
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


@pytest.fixture(scope="module")
def port(jax_children):
    """Per run: the states of every step and the frames of FRAME_STEPS on
    both of the port's render paths; computed while the JAX reference
    runs."""
    from procgen_tpu_torch.core.game import tree_map

    out = {}
    states_of = {}
    with _one_thread():
        for run, (name, centred) in RUNS.items():
            game = _torch_game(name, centred)
            if name not in states_of:
                s = tlife.env_reset(game, tlife.initial_state(
                    game, torch.as_tensor(_seeds(name))))
                states_of[name] = [s]
                for a in _actions(name):
                    s, _ = tlife.env_step(game, s, torch.as_tensor(a))
                    states_of[name].append(s)
            states = states_of[name]
            batch = tree_map(lambda *xs: torch.cat(xs), *[states[t] for t in FRAME_STEPS])
            out[run] = (states, rk.render_obs_batch(game, batch).numpy(),
                        trender_obs(game, batch, 64).numpy())
    return out


@pytest.mark.parametrize("run", GAMES)
def test_states_match(run, ref, port):
    prefix = SEP.join((run, "states")) + SEP
    want = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    got = [_flat(state_to_numpy(t)) for t in port[run][0]]
    assert set(want) == set(got[0]), set(want) ^ set(got[0])
    assert "bg_canvas" in want and want["bg_canvas"].shape == (STEPS + 1, N, 128, 128, 3)
    for leaf, w in want.items():
        g = np.stack([t[leaf] for t in got])
        assert g.dtype == w.dtype, (leaf, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{run}: {leaf}")
    # the painted canvases differ from env to env and are not blank
    canvas = want["bg_canvas"][0]
    assert not np.array_equal(canvas[0], canvas[1]) and canvas.std() > 10


@pytest.mark.parametrize("run", list(RUNS))
def test_frames_match_xla_render_obs(run, ref, port):
    want = ref[SEP.join((run, "xla"))]
    np.testing.assert_array_equal(port[run][1], want, err_msg="render_obs_batch")
    np.testing.assert_array_equal(port[run][2], want, err_msg="renderer.render_obs")


@pytest.mark.parametrize("run", [r for r in PALLAS if r != "fruitbot"])
def test_frames_match_pallas_interpret(run, ref, port):
    np.testing.assert_array_equal(port[run][1], ref[SEP.join((run, "pallas"))])


def test_fruitbot_tiled_canvas_follows_xla(ref, port):
    """The JAX package's Pallas prep leaves SF_TILEH unset for a painted
    canvas, so its tiled branch divides by 0 and its frames part from the
    XLA renderer's; the port tiles the canvas as XLA does."""
    pallas = ref[SEP.join(("fruitbot", "pallas"))]
    xla = ref[SEP.join(("fruitbot", "xla"))]
    assert (pallas != xla).any(axis=-1).sum() > 100
    np.testing.assert_array_equal(port["fruitbot"][1], xla)


@pytest.mark.parametrize("run", ["coinrun", "fruitbot", "starpilot"])
def test_frame_takes_the_painted_canvas(run, port):
    """The whole-frame path reads each env's own canvas, cropped (coinrun,
    starpilot: never scrolled) or tiled (fruitbot), with aspect 1."""
    name, centred = RUNS[run]
    game = _torch_game(name, centred)
    plan = rk.get_plan(game)
    assert plan.procgen_bg and plan.bg_mode == (rk.BG_TILED if name == "fruitbot"
                                                else rk.BG_CROP)
    s = port[run][0][-1]
    x = rk.prep_frame(plan, s)
    assert x.per_env_bg and x.bg_atlas.data_ptr() == s.bg_canvas.data_ptr()
    assert x.si[:, rk.SI_BGROW].tolist() == list(range(N))
    if name == "fruitbot":
        assert (x.sf[:, rk.SF_TILEH] > 0).all()
    # another env's canvas changes the frame
    swapped = dataclasses.replace(x, bg_atlas=x.bg_atlas.flip(0).contiguous())
    assert (rk.render_frame_reference(swapped) != rk.render_frame_reference(x)).any()


if __name__ == "__main__":
    from test_torch_refstate import patch_jax_cpp_arithmetic

    patch_jax_cpp_arithmetic()
    _jax_reference(sys.argv[1], sys.argv[2:])
