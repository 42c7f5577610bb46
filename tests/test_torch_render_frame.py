"""The port's whole-frame render (miner's path) against the JAX package's.

* ``prep_frame`` against the Pallas kernel's ``_prep_one``: the scalars,
  the colored-cell planes and the sprite slots equal, and the per-cell row
  table, expanded through the grid atlas, equal to the resampled tile
  canvas ``gcanvas``;
* ``render_frame_reference`` (``render_kernel.render_obs_batch`` on CPU
  tensors) against the Pallas kernel run in interpret mode, as
  tests/test_pallas_render.py runs it, and against ``render_obs`` of both
  packages;
* on real miner states, easy (10x10 cells of 7 px) and hard (20x20 of
  4 px), and on made-up ones: grid cells of types that have no tile (so
  they are painted as colored cells), agents and exits moved anywhere,
  the exit above or below the grid, random background offsets.

The CUDA kernel against its plain version is in tests/test_torch_kernels.py.

Tolerance: zero — every frame and every prep value must match exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from procgen_tpu.core import lifecycle as jlife
from procgen_tpu.core.constants import INT32_MAX
from procgen_tpu.core.options import GameOptions as JGameOptions
from procgen_tpu.games.miner import Miner as JMiner
from procgen_tpu.render import pallas_kernel
from procgen_tpu.render.renderer import render_obs as jrender_obs
from procgen_tpu.utils.host_mt import HostMT19937

from procgen_tpu_torch.bridge import state_to_numpy
from procgen_tpu_torch.core import lifecycle as tlife
from procgen_tpu_torch.core.options import GameOptions
from procgen_tpu_torch.games.miner import Miner as TMiner
from procgen_tpu_torch.render import render_kernel as rk
from procgen_tpu_torch.render.renderer import render_obs as trender_obs

N = 4


def _games(mode):
    jg, tg = JMiner(JGameOptions(distribution_mode=mode)), TMiner(
        GameOptions(distribution_mode=mode))
    for g in (jg, tg):
        g.level_seed_low, g.level_seed_high = 0, INT32_MAX
    return jg, tg


def _states(tg, seed, steps):
    master = HostMT19937(seed)
    seeds = np.array([master.next_u32() for _ in range(N)], np.int64)
    s = tlife.env_reset(tg, tlife.initial_state(tg, torch.as_tensor(seeds)))
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        s, _ = tlife.env_step(tg, s, torch.as_tensor(rng.randint(0, 15, N)))
    return s


def _made_up(s, tg):
    """Miner-easy states with made-up grids, positions and backgrounds."""
    rng = np.random.RandomState(7)
    dim = tg.world_dim
    # 5 (enemy), 7, 8 and 13 have no tile: colored cells
    grid = rng.choice([1, 2, 3, 4, 5, 7, 8, 9, 11, 12, 13, 100, 100],
                      (N, dim, dim)).astype(np.int32)
    e = s.ents
    shape = e.x.shape
    ents = e.replace(
        x=torch.as_tensor(rng.uniform(-0.6, dim + 0.6, shape).astype(np.float32)),
        y=torch.as_tensor(rng.uniform(-0.6, dim + 0.6, shape).astype(np.float32)),
        render_z=torch.as_tensor(rng.choice([-1, 0, 1], shape).astype(np.int32)),
        is_reflected=torch.as_tensor(rng.rand(*shape) < 0.5),
    )
    return s.replace(
        grid=torch.as_tensor(grid), ents=ents,
        bg_pct_x=torch.as_tensor(rng.rand(N).astype(np.float32)),
        background_index=torch.as_tensor(rng.randint(0, 3, N).astype(np.int32)),
    )


def _jax_state(jg, ts):
    template = jax.eval_shape(
        jax.vmap(lambda sd: jlife.initial_state(jg, sd)),
        jax.ShapeDtypeStruct((N,), jnp.uint32),
    )
    return serialization.from_state_dict(
        template, jax.tree_util.tree_map(jnp.asarray, state_to_numpy(ts))
    )


CASES = ["easy", "hard", "made_up"]


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name, mode, seed, steps in (("easy", 0, 0, 12), ("hard", 1, 1, 6),
                                    ("made_up", 0, 2, 0)):
        jg, tg = _games(mode)
        ts = _states(tg, seed, steps)
        if name == "made_up":
            ts = _made_up(ts, tg)
        out[name] = (jg, tg, ts, _jax_state(jg, ts))
    return out


@pytest.mark.parametrize("which", CASES)
def test_prep_matches_pallas_prep(which, cases):
    jg, tg, ts, js = cases[which]
    jplan = pallas_kernel.get_plan(jg, 64)
    want = jax.jit(jax.vmap(lambda s: pallas_kernel._prep_one(jplan, s)))(js)
    x = rk.prep_frame(rk.get_plan(tg), ts)
    np.testing.assert_array_equal(x.sf.numpy(), np.asarray(want["sf"]))
    jsi = np.asarray(want["si"])
    np.testing.assert_array_equal(x.si.numpy(), jsi[:, :rk.SI_N])
    assert not jsi[:, rk.SI_N:].any()  # sprite-group columns, unused here
    np.testing.assert_array_equal(x.cell5.numpy(), np.asarray(want["cell5"]))
    np.testing.assert_array_equal(x.ent_f.numpy(), np.asarray(want["ent_f"]))
    np.testing.assert_array_equal(x.ent_i.numpy(), np.asarray(want["ent_i"]))
    # the row table through the atlas is the TPU kernel's tile canvas
    ga = x.grid_atlas.numpy()
    sA, NC = ga.shape[1], x.gtab.shape[1]
    covered = np.where(np.arange(ga.shape[0]) < x.grid_opaque, 255, 0).astype(np.uint8)
    aug = np.concatenate(
        [ga, np.broadcast_to(covered[:, None, None, None], ga.shape[:3] + (1,))], -1)
    canvas = aug[x.gtab.numpy()].transpose(0, 5, 1, 3, 2, 4).reshape(
        N, 5, NC * sA, NC * sA)
    np.testing.assert_array_equal(canvas, np.asarray(want["gcanvas"]))
    if which == "made_up":
        # colored cells in the window, uncovered
        assert ((x.cell5[:, 3] > 0.5) & (x.gtab >= x.grid_opaque)).any()


@pytest.mark.parametrize("which", CASES)
def test_frame_matches_pallas_interpret(which, cases):
    jg, tg, ts, js = cases[which]
    got = rk.render_obs_batch(tg, ts).numpy()
    want = np.asarray(jax.jit(
        lambda st: pallas_kernel.render_obs_batch(jg, st, 64, interpret=True)
    )(js))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", CASES)
def test_frame_matches_render_obs(which, cases):
    jg, tg, ts, js = cases[which]
    want = np.asarray(jax.jit(jax.vmap(lambda s: jrender_obs(jg, s, 64)))(js))
    np.testing.assert_array_equal(trender_obs(tg, ts, 64).numpy(), want)
    np.testing.assert_array_equal(rk.render_obs_batch(tg, ts).numpy(), want)


def test_supports_the_ported_paths_only():
    """The whole-frame path takes miner easy and hard; the centred camera
    (memory mode) and monochrome sprites still raise."""
    for mode in (0, 1):
        assert rk.supports(TMiner(GameOptions(distribution_mode=mode)))
    memory = TMiner(GameOptions(distribution_mode=10))
    mono = TMiner(GameOptions(distribution_mode=0, use_monochrome_assets=True))
    for g in (memory, mono):
        assert not rk.supports(g)
        with pytest.raises(NotImplementedError):
            rk.render_obs_batch(g, _states(g, 0, 0))
