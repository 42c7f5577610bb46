"""The port's renderers against the JAX package's, byte for byte.

* the per-level prefix frame against ``render_obs(prefix_only=True)``;
* the per-step sprite suffix (``render_kernel.render_obs_batch`` on CPU
  tensors, i.e. ``render_suffix_reference``) against the Pallas kernel run
  in interpret mode, as tests/test_pallas_render.py runs it, and against
  ``render_obs(base=frame)`` of both packages — on real maze states and on
  made-up slots (more slots than maze has, fallback colors, alpha, tall
  and clipped rects, quarter turns, reflection, tiling, rotation banks).

The CUDA kernel against its plain version is in tests/test_torch_kernels.py,
which imports no JAX so that it runs on the GPU machine.

Tolerance: zero — every frame must match exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from procgen_tpu.core import lifecycle as jlife
from procgen_tpu.core.constants import EASY_MODE, INT32_MAX
from procgen_tpu.core.options import GameOptions
from procgen_tpu.games.maze import Maze as JMaze
from procgen_tpu.render import pallas_kernel
from procgen_tpu.render.renderer import render_obs as jrender_obs
from procgen_tpu.utils.host_mt import HostMT19937

from procgen_tpu_torch.bridge import state_to_numpy
from procgen_tpu_torch.core import lifecycle as tlife
from procgen_tpu_torch.games.maze import Maze as TMaze
from procgen_tpu_torch.render import render_kernel
from procgen_tpu_torch.render.renderer import render_obs as trender_obs

N = 4


def _tile_ratio_from_health(self, s, e):
    # made-up per-slot tile ratio: health 1 -> stretch, 3 -> tile x, -1 ->
    # tile y (maze itself never tiles)
    return e.health - 1.0


class JMazeMadeUp(JMaze):
    ENT_CAP = 6
    ARB_ROT_TYPES = {0: 8}
    entity_tile_ratio = _tile_ratio_from_health


class TMazeMadeUp(TMaze):
    ENT_CAP = 6
    ARB_ROT_TYPES = {0: 8}
    entity_tile_ratio = _tile_ratio_from_health


def _games(jcls, tcls):
    opts = GameOptions(distribution_mode=EASY_MODE)
    jg, tg = jcls(opts), tcls(opts)
    for g in (jg, tg):
        g.level_seed_low, g.level_seed_high = 0, INT32_MAX
    return jg, tg


def _seeds(n, seed=0):
    master = HostMT19937(seed)
    return np.array([master.next_u32() for _ in range(n)], np.int64)


def _jax_state(jgame, tree):
    """A JAX BasicState holding the numpy leaves of ``tree``."""
    template = jax.eval_shape(
        jax.vmap(lambda sd: jlife.initial_state(jgame, sd)),
        jax.ShapeDtypeStruct((N,), jnp.uint32),
    )
    return serialization.from_state_dict(
        template, jax.tree_util.tree_map(jnp.asarray, tree)
    )


def _real_states():
    """The port's maze states after a few random steps (CPU)."""
    _, tg = _games(JMaze, TMaze)
    s = tlife.initial_state(tg, torch.as_tensor(_seeds(N)))
    s = tlife.env_reset(tg, s)
    rng = np.random.RandomState(0)
    for _ in range(5):
        s, _ = tlife.env_step(tg, s, torch.as_tensor(rng.randint(0, 15, N)))
    return s


def _made_up_states():
    """Maze states with 6 slots per env of made-up entities."""
    _, tg = _games(JMazeMadeUp, TMazeMadeUp)
    s = tlife.initial_state(tg, torch.as_tensor(_seeds(N, 3)))
    s = tlife.env_reset(tg, s)
    rng = np.random.RandomState(1)
    shape = (N, 6)
    e = s.ents
    f32, i32 = torch.float32, torch.int32

    def t(a, dt):
        return torch.as_tensor(np.asarray(a)).to(dt)

    ents = e.replace(
        x=t(rng.uniform(-1, 16, shape), f32),
        y=t(rng.uniform(-1, 16, shape), f32),
        rx=t(rng.choice([0.1, 0.5, 1.0, 3.5], shape), f32),
        ry=t(rng.choice([0.1, 0.5, 2.5, 4.0], shape), f32),
        alpha=t(np.where(rng.rand(*shape) < 0.5, 1.0, rng.uniform(0, 1, shape)), f32),
        rotation=t(rng.choice([0.0, np.pi / 2, np.pi, 1.5 * np.pi, 0.3, 2.2],
                              shape), f32),
        is_reflected=t(rng.rand(*shape) < 0.5, torch.bool),
        image_type=t(rng.choice([0, 2, 51, 5, 54, 59, 100], shape), i32),
        image_theme=t(rng.randint(0, 2, shape), i32),
        render_z=t(rng.choice([0, 1, 1, 2], shape), i32),
        use_abs_coords=t(rng.rand(*shape) < 0.15, torch.bool),
        health=t(rng.choice([1.0, 1.0, 3.0, -1.0], shape), f32),
        count=t(rng.randint(3, 7, (N,)), i32),
    )
    # abs-coord rects live in [0, 1] units
    ents = ents.replace(
        x=torch.where(ents.use_abs_coords, ents.x / 16, ents.x),
        y=torch.where(ents.use_abs_coords, ents.y / 16, ents.y),
        rx=torch.where(ents.use_abs_coords, ents.rx / 16, ents.rx),
        ry=torch.where(ents.use_abs_coords, ents.ry / 16, ents.ry),
    )
    return s.replace(ents=ents)


@pytest.fixture(scope="module")
def real():
    jg, tg = _games(JMaze, TMaze)
    ts = _real_states()
    return jg, tg, ts, _jax_state(jg, state_to_numpy(ts))


@pytest.fixture(scope="module")
def made_up():
    jg, tg = _games(JMazeMadeUp, TMazeMadeUp)
    ts = _made_up_states()
    return jg, tg, ts, _jax_state(jg, state_to_numpy(ts))


def _pallas(jg, js):
    return np.asarray(jax.jit(
        lambda st: pallas_kernel.render_obs_batch(jg, st, 64, interpret=True)
    )(js))


def test_prefix_frame_matches_jax(real):
    jg, tg, ts, js = real
    want = jax.jit(jax.vmap(lambda s: jrender_obs(jg, s, 64, prefix_only=True)))(js)
    got = trender_obs(tg, ts, 64, prefix_only=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ts.frame.numpy(), np.asarray(want))


@pytest.mark.parametrize("which", ["real", "made_up"])
def test_suffix_matches_pallas_interpret(which, request):
    jg, tg, ts, js = request.getfixturevalue(which)
    got = render_kernel.render_obs_batch(tg, ts).numpy()
    want = _pallas(jg, js)
    np.testing.assert_array_equal(got, want)
    if which == "made_up":
        # the made-up sprites really paint over the prefix frame
        assert (got != ts.frame.numpy()).any(axis=(1, 2, 3)).all()


@pytest.mark.parametrize("which", ["real", "made_up"])
def test_suffix_matches_render_obs_base(which, request):
    jg, tg, ts, js = request.getfixturevalue(which)
    want = jax.jit(jax.vmap(lambda s: jrender_obs(jg, s, 64, base=s.frame)))(js)
    got_renderer = trender_obs(tg, ts, 64, base=ts.frame)
    got_plain = render_kernel.render_obs_batch(tg, ts)
    np.testing.assert_array_equal(got_renderer.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_plain.numpy(), np.asarray(want))


def test_prep_matches_pallas_prep(made_up):
    jg, tg, ts, js = made_up
    jplan = pallas_kernel.get_plan(jg, 64)
    prep = jax.jit(jax.vmap(lambda s: pallas_kernel._prep_one(jplan, s)))(js)
    ent_f, ent_i = render_kernel.prep(render_kernel.get_plan(tg), ts)
    np.testing.assert_array_equal(ent_f.numpy(), np.asarray(prep["ent_f"]))
    np.testing.assert_array_equal(ent_i.numpy(), np.asarray(prep["ent_i"]))
    # the atlas: JAX's planar bf16 layout holds the same texels
    plan = render_kernel.get_plan(tg)
    S, n2 = plan.S, plan.atlas_np.shape[0]
    planar = np.asarray(jplan.ent_flat, np.float32).reshape(n2, S, 4, S)
    np.testing.assert_array_equal(
        np.transpose(planar, (0, 1, 3, 2)), plan.atlas_np.astype(np.float32)
    )
