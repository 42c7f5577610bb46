"""Monochrome sprites (``use_monochrome_assets``) in the port against the
JAX package.

Every sprite and grid tile is replaced by its ``color_for_type`` colour;
the backgrounds stay images.  For coinrun (easy, under the whole-world
camera and the agent-centred one), chaser (easy, the whole world) and
maze (easy, the static prefix and the sprite suffix), 4 envs are reset
and stepped 12 times with random actions in both packages:

* every ``BasicState`` leaf of every step is bit-equal (maze's cached
  prefix frame, drawn by the plain renderer's coloured cells, among them);
* the frames of steps 0, 6 and 12: ``render_kernel.render_obs_batch`` (on
  CPU tensors the plain versions of ``render_frame`` and
  ``render_suffix``, every slot on their fallback-colour branch, the grid
  with no tile atlas) against the Pallas kernel run in interpret mode,
  the port's ``renderer.render_obs`` against the XLA ``render_obs`` (the
  winner slot's colour), and ``prep_frame`` / ``prep_suffix`` against the
  Pallas prep.

The two JAX paths part on monochrome frames: the XLA renderer tests a
pixel against a slot's world rectangle (``|wx - x| < rx``) before any
``adjust_image_rect`` (coinrun's player sprite), the Pallas kernel against
the adjusted screen rectangle.  The port's kernel path follows Pallas and
its plain renderer XLA; the test asserts that the two JAX paths part only
on pixels that a live slot covers under either rectangle, and only on
coinrun's frames (11 pixels of its 12 whole-world frames, 192 of its 12
centred ones; none of chaser's or maze's).

The JAX reference runs in one child process of its own (this file run as
a script), which clears the JAX package's atlas and plan caches before
each game: its atlas cache key leaves out ``use_monochrome_assets``.

Tolerance: zero.
"""

import contextlib
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
from procgen_tpu_torch.core.constants import INT32_MAX  # noqa: E402
from procgen_tpu_torch.core.game import tree_map, tree_where  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.games.registry import make_game  # noqa: E402
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import camera  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402
from procgen_tpu_torch.utils.host_mt import HostMT19937  # noqa: E402

N = 4
STEPS = 12
FRAME_STEPS = (0, 6, 12)
SEP = "::"
# case -> (game, master seed, centred camera)
CASES = {"coinrun_world": ("coinrun", 31, False), "coinrun_centred": ("coinrun", 31, True),
         "chaser_world": ("chaser", 32, False), "maze_world": ("maze", 33, False)}


def _seeds(master_seed):
    m = HostMT19937(master_seed)
    return np.array([m.next_u32() for _ in range(N)], np.int64)


def _actions(seed):
    return np.random.RandomState(seed).randint(0, 15, (STEPS, N)).astype(np.int32)


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        elif v is not None:
            out[pre + k] = np.asarray(v)
    return out


def _leaves(ref, prefix):
    prefix = prefix + SEP
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# the JAX reference (child process)
# ---------------------------------------------------------------------------


def _jax_reference(out_path):
    from procgen_tpu.core import lifecycle
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game as jmake_game
    from procgen_tpu.parallel.vec import _tree_select
    from procgen_tpu.render import atlas, pallas_kernel
    from procgen_tpu.render.renderer import render_obs

    jax.config.update("jax_platforms", "cpu")
    out = {}
    host = lambda st: jax.tree_util.tree_map(np.asarray, st)  # noqa: E731
    for case, (name, mseed, centred) in CASES.items():
        # the atlas cache key leaves out use_monochrome_assets
        atlas._CACHE.clear()
        pallas_kernel._PLANS.clear()
        game = jmake_game(name, JGameOptions(distribution_mode=0, use_monochrome_assets=True,
                                            center_agent=centred))
        game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        init = jax.jit(jax.vmap(lambda sd: lifecycle.initial_state(game, sd)))
        reset = jax.jit(jax.vmap(lambda s: lifecycle.env_reset(game, s)))
        step = jax.jit(jax.vmap(lambda s, a: lifecycle.env_step(game, s, a)))
        s = host(reset(host(init(jnp.asarray(_seeds(mseed), jnp.uint32)))))
        states = [s]
        for a in _actions(mseed):
            s, done = step(s, jnp.asarray(a))
            s = host(_tree_select(done, reset(s), s))
            states.append(s)
        trees = [_flat(serialization.to_state_dict(st)) for st in states]
        for leaf in trees[0]:
            out[SEP.join((case, "states", leaf))] = np.stack([t[leaf] for t in trees])
        batch = jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs),
                                       *[states[t] for t in FRAME_STEPS])
        plan = pallas_kernel.get_plan(game, 64)
        assert plan.ent_atlas is None and plan.grid_atlas is None

        def xla_and_prep(st):
            prep = pallas_kernel._prep_one(plan, st)
            return {"xla": render_obs(game, st, 64), **{
                "prep" + SEP + k: prep[k] for k in ("sf", "si", "ent_f", "ent_i", "cell5")}}

        arrays = {"pallas": jax.jit(
            lambda st: pallas_kernel.render_obs_batch(game, st, 64, interpret=True)
        )(batch), **jax.jit(jax.vmap(xla_and_prep))(batch)}
        for k, v in arrays.items():
            out[SEP.join((case, "frames", k))] = np.asarray(v)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_child(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("mono")
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
def ref(jax_child, port):
    path, proc, log = jax_child
    assert proc.wait(timeout=1800) == 0, log.read_text()[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


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


def _torch_game(name, centred):
    game = make_game(name, GameOptions(distribution_mode=0, use_monochrome_assets=True,
                                       center_agent=centred))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


@pytest.fixture(scope="module")
def port(jax_child):
    """Per case: the port's states of every step, and the frames of
    ``FRAME_STEPS`` on both paths with the kernel path's inputs."""
    out = {}
    with _one_thread():
        for case, (name, mseed, centred) in CASES.items():
            game = _torch_game(name, centred)
            s = tlife.env_reset(game, tlife.initial_state(game, torch.as_tensor(_seeds(mseed))))
            states = [s]
            for a in _actions(mseed):
                s, done = tlife.env_step(game, s, torch.as_tensor(a))
                s = tree_where(done, tlife.env_reset(game, s), s)
                states.append(s)
            batch = tree_map(lambda *xs: torch.cat(xs), *[states[t] for t in FRAME_STEPS])
            plan = rk.get_plan(game)
            prep = (rk.prep_suffix(plan, batch) if plan.static
                    else rk.prep_frame(plan, batch))
            out[case] = (game, states, batch, rk.render_obs_batch(game, batch).numpy(),
                         trender_obs(game, batch, 64).numpy(), prep)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_states_match(case, ref, port):
    states = port[case][1]
    want = _leaves(ref, SEP.join((case, "states")))
    got = [_flat(state_to_numpy(t)) for t in states]
    assert set(want) == set(got[0]), set(want) ^ set(got[0])
    for leaf, w in want.items():
        g = np.stack([t[leaf] for t in got])
        assert g.dtype == w.dtype, (case, leaf, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{case}: {leaf}")


def _covered(game, s, res=64):
    """[N, 64, 64] bool: pixels inside a live, drawn slot's rectangle of
    either pool, under the XLA renderer's world test or the Pallas prep's
    screen rectangle."""
    unit, vis, x_off, y_off = camera(game, s, res)
    pix = torch.arange(res, dtype=torch.float32) + 0.5
    wxs = (pix[None, :] + x_off[:, None]) / unit[:, None]
    wys = vis[:, None] - (pix[None, :] - y_off[:, None]) / unit[:, None]
    plan = rk.get_plan(game)
    cov = torch.zeros((s.num, res, res), dtype=torch.bool)
    pools = [(s.ents, rk.prep(plan, s))]
    if plan.dz_levels:
        pools.append((s.decor, rk.prep_decor(plan, s, (unit, vis, x_off, y_off))))
    for e, (ef, ei) in pools:
        live = ei[..., rk.EI_LIVE] > 0
        for i in range(e.cap):
            c = lambda t: t[:, i:i + 1]  # noqa: E731
            world = ((torch.abs(wys - c(e.y)) < c(e.ry))[:, :, None]
                     & (torch.abs(wxs - c(e.x)) < c(e.rx))[:, None, :])
            u = (pix[None, :] - ef[:, i, rk.EF_X0:rk.EF_X0 + 1]) / ef[:, i, rk.EF_W2:rk.EF_W2 + 1]
            v = (pix[None, :] - ef[:, i, rk.EF_Y0:rk.EF_Y0 + 1]) / ef[:, i, rk.EF_H2:rk.EF_H2 + 1]
            screen = (((v >= 0) & (v < 1))[:, :, None] & ((u >= 0) & (u < 1))[:, None, :])
            cov |= (world | screen) & live[:, i, None, None]
    return cov


@pytest.mark.parametrize("case", list(CASES))
def test_frames_match_pallas_interpret_and_xla(case, ref, port):
    """The kernel path equals the Pallas kernel, the plain renderer the
    XLA renderer; where the two JAX paths part, a live slot covers the
    pixel."""
    game, _, batch, kernel, plain, _ = port[case]
    key = SEP.join((case, "frames")) + SEP
    np.testing.assert_array_equal(kernel, ref[key + "pallas"])
    np.testing.assert_array_equal(plain, ref[key + "xla"])
    part = (ref[key + "pallas"] != ref[key + "xla"]).any(axis=-1)
    assert not (part & ~_covered(game, batch).numpy()).any()
    # coinrun's player sprite is adjusted (``adjust_image_rect``); chaser's
    # and maze's slots cover the same pixels under both tests
    assert part.any() == (game.name == "coinrun")


@pytest.mark.parametrize("case", list(CASES))
def test_prep_matches_pallas_prep(case, ref, port):
    """Every slot on the fallback-colour branch, no bank rows, the grid
    drawn by the cell planes alone; the slots (and for the whole frame the
    scalars and cells) equal the Pallas prep's."""
    game, _, _, _, _, prep = port[case]
    plan = rk.get_plan(game)
    assert plan.ent_atlas is None and plan.S == 2 and plan.n1e == 1
    key = SEP.join((case, "frames", "prep")) + SEP
    if plan.static:
        ent_f, ent_i, _ = prep
    else:
        assert plan.grid_atlas is None and plan.sA == 2 and plan.grid_opaque == 0
        ent_f, ent_i = prep.ent_f, prep.ent_i
        assert int(prep.gtab.abs().sum()) == 0
        np.testing.assert_array_equal(prep.sf.numpy(), ref[key + "sf"])
        np.testing.assert_array_equal(prep.si.numpy(), ref[key + "si"][:, :rk.SI_N])
        np.testing.assert_array_equal(prep.cell5.numpy(), ref[key + "cell5"])
        assert float(prep.cell5[:, 3].sum()) > 0  # cells drawn as colours
    np.testing.assert_array_equal(ent_f.numpy(), ref[key + "ent_f"])
    np.testing.assert_array_equal(ent_i.numpy(), ref[key + "ent_i"])
    assert bool((ent_i[..., rk.EI_FB] == 1).all())
    assert bool((ent_i[..., rk.EI_ROW] <= 1).all())


if __name__ == "__main__":
    from test_torch_refstate import patch_jax_cpp_arithmetic

    patch_jax_cpp_arithmetic()
    _jax_reference(sys.argv[1])
