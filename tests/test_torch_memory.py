"""Memory mode's frames in the port against the JAX package's.

Memory mode centres the camera on the agent (``center_agent``) over a
larger world: maze's 31x31, miner's 35x35 and dodgeball's 40x40 with both
sprite pools.  The frame goes through the whole-frame path with the cell
window of ``visibility + 3`` cells around the agent: 11 for maze and
miner, 19 for dodgeball (procgen_tpu/render/pallas_kernel.py:91,
renderer.py:532).

* For each game, the port's memory-mode states of 3 envs at every sixth
  of 24 random steps (an episode's end resetting its env at once) are
  carried into the JAX package by the state bridge, and then:
  ``render_kernel.render_obs_batch`` (on CPU tensors,
  ``render_frame_reference``) against the Pallas kernel run in interpret
  mode; the port's ``renderer.render_obs`` against the XLA ``render_obs``;
  ``prep_frame`` against the Pallas kernel's ``_prep_one`` (the scalars,
  the colored-cell planes, both pools' slots and the per-cell row table
  through the grid atlas against the tile canvas).
* The window's size and origin: ``grid_window`` against the reference's
  rule, and the cells outside the world drawn as the game's
  out-of-bounds object.
* maze_memory and miner_memory replay exactly (dodgeball_memory in
  tests/test_torch_dodgeball.py).

The JAX side runs in one child process (this file run as a script) whose
XLA is held to AVX (``--xla_cpu_max_isa=AVX``): the centred camera's
offsets are not zero, and XLA's CPU backend would fuse their
multiply-adds.  It traces only the renderers.

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
from procgen_tpu_torch.core.constants import INT32_MAX, MEMORY_MODE  # noqa: E402
from procgen_tpu_torch.core.game import tree_map, tree_where  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.games.registry import make_game  # noqa: E402
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import grid_window  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402
from procgen_tpu_torch.utils.host_mt import HostMT19937  # noqa: E402

GAMES = ("maze", "miner", "dodgeball")
N = 3
STEPS = 24
EVERY = 6
SEP = "::"


def _torch_game(name):
    game = make_game(name, GameOptions(distribution_mode=MEMORY_MODE))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _jax_game(name):
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game as jmake_game

    game = jmake_game(name, JGameOptions(distribution_mode=MEMORY_MODE))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        elif v is not None:
            out[pre + k] = np.asarray(v)
    return out


def _nest(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# ---------------------------------------------------------------------------
# the JAX reference (child process)
# ---------------------------------------------------------------------------


def _jax_reference(states_path, out_path):
    """Render each game's states (the port's, from ``states_path``) with
    the Pallas kernel in interpret mode and the XLA renderer, and prep
    them with ``_prep_one``."""
    from procgen_tpu.core import lifecycle
    from procgen_tpu.core.game import BasicState
    from procgen_tpu.render import pallas_kernel
    from procgen_tpu.render.renderer import render_obs

    jax.config.update("jax_platforms", "cpu")
    out = {}
    with np.load(states_path) as z:
        saved = {k: z[k] for k in z.files}
    for name in GAMES:
        game = _jax_game(name)
        pre = name + SEP
        tree = _nest({k[len(pre):]: v for k, v in saved.items() if k.startswith(pre)})
        B = tree["reward"].shape[0]
        for f in BasicState.__dataclass_fields__:
            tree.setdefault(f, None)
        template = jax.eval_shape(
            jax.vmap(lambda sd: lifecycle.initial_state(game, sd)),
            jax.ShapeDtypeStruct((B,), jnp.uint32))
        batch = serialization.from_state_dict(template, tree)
        out[pre + "pallas"] = np.asarray(jax.jit(
            lambda st: pallas_kernel.render_obs_batch(game, st, 64, interpret=True)
        )(batch))
        out[pre + "xla"] = np.asarray(
            jax.jit(jax.vmap(lambda st: render_obs(game, st, 64)))(batch))
        plan = pallas_kernel.get_plan(game, 64)
        prep = jax.jit(jax.vmap(lambda st: pallas_kernel._prep_one(plan, st)))(batch)
        for k in ("sf", "si", "cell5", "gcanvas", "ent_f", "ent_i", "dec_f", "dec_i"):
            out[pre + "prep" + SEP + k] = np.asarray(prep[k])
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _states(game, seed):
    """The port's states at every ``EVERY``-th of ``STEPS`` random steps,
    as one batch."""
    m = HostMT19937(seed)
    seeds = torch.as_tensor(np.array([m.next_u32() for _ in range(N)], np.int64))
    s = tlife.env_reset(game, tlife.initial_state(game, seeds))
    rng = np.random.RandomState(seed)
    kept = [s]
    for t in range(1, STEPS + 1):
        s, done = tlife.env_step(game, s, torch.as_tensor(rng.randint(0, 15, N)))
        s = tree_where(done, tlife.env_reset(game, s), s)
        if t % EVERY == 0:
            kept.append(s)
    return tree_map(lambda *xs: torch.cat(xs), *kept)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Per game: its state batch, the port's frames on both render paths
    and ``prep_frame``; then the JAX child on the same states."""
    out_dir = tmp_path_factory.mktemp("memory")
    saved = {}
    out = {}
    with _one_thread():
        for i, name in enumerate(GAMES):
            game = _torch_game(name)
            batch = _states(game, 20 + i)
            for k, v in _flat(state_to_numpy(batch)).items():
                saved[name + SEP + k] = v
            out[name] = (game, batch, rk.render_obs_batch(game, batch).numpy(),
                         trender_obs(game, batch, 64).numpy(),
                         rk.prep_frame(rk.get_plan(game), batch))
    states_path = out_dir / "states.npz"
    np.savez(states_path, **saved)
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"{flags} --xla_cpu_max_isa=AVX".strip(),
        JAX_COMPILATION_CACHE_DIR=jax.config.jax_compilation_cache_dir or "",
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="1",
    )
    ref_path, log = out_dir / "ref.npz", out_dir / "ref.log"
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(states_path), str(ref_path)],
            env=env, stdout=subprocess.DEVNULL, stderr=err)
    try:
        yield out, (ref_path, proc, log)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


REPLAYS = ("maze_memory", "miner_memory")


@pytest.fixture(scope="module")
def replays(port):
    """Each recording and the port's replay of it on the CPU, computed
    while the JAX child renders."""
    out = {}
    with _one_thread():
        for name in REPLAYS:
            with open(os.path.join(HERE, "data", "conformance", f"{name}.json")) as f:
                rec = json.load(f)
            out[name] = (rec, replay(rec, device="cpu"))
    return out


@pytest.fixture(scope="module")
def ref(port, replays):
    ref_path, proc, log = port[1]
    assert proc.wait(timeout=1800) == 0, log.read_text()[-4000:]
    with np.load(ref_path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", GAMES)
def test_frames_match_pallas_interpret(name, port, ref):
    got = port[0][name][2]
    np.testing.assert_array_equal(got, ref[name + SEP + "pallas"])


@pytest.mark.parametrize("name", GAMES)
def test_frames_match_xla_render_obs(name, port, ref):
    """The port's plain renderer equals the XLA renderer, which equals the
    Pallas kernel on these states."""
    got = port[0][name][3]
    want = ref[name + SEP + "xla"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, ref[name + SEP + "pallas"])


@pytest.mark.parametrize("name", GAMES)
def test_prep_matches_pallas_prep(name, port, ref):
    game, batch, _, _, x = port[0][name]
    key = name + SEP + "prep" + SEP
    np.testing.assert_array_equal(x.sf.numpy(), ref[key + "sf"])
    jsi = ref[key + "si"]
    np.testing.assert_array_equal(x.si.numpy(), jsi[:, :rk.SI_N])
    np.testing.assert_array_equal(x.cell5.numpy(), ref[key + "cell5"])
    np.testing.assert_array_equal(x.ent_f.numpy(), ref[key + "ent_f"])
    np.testing.assert_array_equal(x.ent_i.numpy(), ref[key + "ent_i"])
    if game.DECOR_CAP:
        np.testing.assert_array_equal(x.dec_f.numpy(), ref[key + "dec_f"])
        np.testing.assert_array_equal(x.dec_i.numpy(), ref[key + "dec_i"])
    # the row table through the grid atlas is the TPU kernel's tile canvas
    ga = x.grid_atlas.numpy()
    sA, NC = ga.shape[1], x.gtab.shape[1]
    covered = np.where(np.arange(ga.shape[0]) < x.grid_opaque, 255, 0).astype(np.uint8)
    aug = np.concatenate(
        [ga, np.broadcast_to(covered[:, None, None, None], ga.shape[:3] + (1,))], -1)
    canvas = aug[x.gtab.numpy()].transpose(0, 5, 1, 3, 2, 4).reshape(
        batch.num, 5, NC * sA, NC * sA)
    np.testing.assert_array_equal(canvas, ref[key + "gcanvas"])


@pytest.mark.parametrize("name", GAMES)
def test_centred_window(name, port):
    """The cell window: ``visibility + 3`` cells (11 for maze and miner, 19
    for dodgeball) from the agent's cell less ``visibility / 2 + 1``,
    truncated; cells off the world are the game's out-of-bounds object.
    ``render_frame_reference`` draws from that window, and the kernel
    takes it (its shared memory fits)."""
    game, batch, frames, _, x = port[0][name]
    NC = {"maze": 11, "miner": 11, "dodgeball": 19}[name]
    plan = rk.get_plan(game)
    assert not plan.static and plan.NC == NC and x.gtab.shape[1:] == (NC, NC)
    assert rk.frame_smem(NC, game.ENT_CAP, game.DECOR_CAP) <= rk.SMEM_MAX
    gt, top_y, low_x = grid_window(game, batch)
    e = batch.ents
    margin = batch.visibility / 2 + 1
    assert torch.equal(low_x, torch.trunc(e.x[:, 0] - margin).to(torch.int32))
    assert torch.equal(top_y, torch.trunc(e.y[:, 0] - margin).to(torch.int32) + NC)
    assert torch.equal(x.sf[:, rk.SF_LOWX], low_x.float())
    # some window reaches past the world's edge, drawn as out of bounds
    assert bool((gt == game.out_of_bounds_object).any())
    np.testing.assert_array_equal(rk.render_frame_reference(x).numpy(), frames)


@pytest.mark.parametrize("name", REPLAYS)
def test_conformance_replay(name, replays):
    rec, res = replays[name]
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == res["steps"] == len(rec["actions"])


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2])
