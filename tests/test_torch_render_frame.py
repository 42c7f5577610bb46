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
Coinrun's frames (the decor pool, the agent-centred 16x16 window and the
whole-world 64x64 one) are held against the Pallas kernel in
tests/test_torch_coinrun.py, whose JAX reference runs without fused
multiply-adds.

Made-up tiled backgrounds (fruitbot's K1d mode): fruitbot-easy states
with world sizes whose height is not a whole number of wide tiles (so the
tile height does not divide into square tiles and falls between pixel
rows) and agents anywhere (so the world rect lies partly off the frame,
above or below it), under both cameras; their frames and ``prep_frame``
scalars against the Pallas kernel in interpret mode, the XLA ``render_obs``
and ``_prep_one``.  Their JAX side runs in a child process held to AVX,
as in tests/test_torch_coinrun.py: the camera offsets of these states are
not zero, and XLA's CPU backend would fuse their multiply-adds.

Made-up time-scrolled backgrounds (starpilot's K1d mode): starpilot states
of every mode with their clocks spread over 0..1000 and their sprites
anywhere, under both cameras: the port's plain renderer against
``render_frame_reference``, and, on a card, ``render_frame`` against it.
Starpilot's frames against the JAX package are in
tests/test_torch_starpilot.py.

Tolerance: zero — every frame and every prep value must match exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from procgen_tpu.core import lifecycle as jlife  # noqa: E402
from procgen_tpu.core.constants import INT32_MAX  # noqa: E402
from procgen_tpu.core.options import GameOptions as JGameOptions  # noqa: E402
from procgen_tpu.games.miner import Miner as JMiner  # noqa: E402
from procgen_tpu.render import pallas_kernel  # noqa: E402
from procgen_tpu.render.renderer import render_obs as jrender_obs  # noqa: E402
from procgen_tpu.utils.host_mt import HostMT19937  # noqa: E402

from procgen_tpu_torch.bridge import state_to_numpy  # noqa: E402
from procgen_tpu_torch.core import lifecycle as tlife  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.games.miner import Miner as TMiner  # noqa: E402
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402

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
    """The whole-frame path takes miner easy, hard and memory (the centred
    window of 11 cells), and monochrome sprites: their frames equal the
    Pallas kernel's in interpret mode (the kernel path) and the XLA
    renderer's (the plain renderer).  The JAX package's atlas cache key
    leaves out ``use_monochrome_assets``, so its atlas and plan caches are
    emptied for the monochrome game and given back their entries after."""
    from procgen_tpu.render import atlas as jatlas

    for mode in (0, 1, 10):
        assert rk.supports(TMiner(GameOptions(distribution_mode=mode)))
    assert rk.get_plan(TMiner(GameOptions(distribution_mode=10))).NC == 11
    mono = TMiner(GameOptions(distribution_mode=0, use_monochrome_assets=True))
    mono.level_seed_low, mono.level_seed_high = 0, INT32_MAX
    jmono = JMiner(JGameOptions(distribution_mode=0, use_monochrome_assets=True))
    jmono.level_seed_low, jmono.level_seed_high = 0, INT32_MAX
    assert rk.supports(mono)
    ts = _states(mono, 0, 12)
    js = _jax_state(jmono, ts)
    saved = dict(jatlas._CACHE), dict(pallas_kernel._PLANS)
    jatlas._CACHE.clear()
    pallas_kernel._PLANS.clear()
    try:
        pallas = np.asarray(jax.jit(
            lambda st: pallas_kernel.render_obs_batch(jmono, st, 64, interpret=True))(js))
        xla = np.asarray(jax.jit(jax.vmap(lambda st: jrender_obs(jmono, st, 64)))(js))
    finally:
        for cache, entries in zip((jatlas._CACHE, pallas_kernel._PLANS), saved):
            cache.clear()
            cache.update(entries)
    np.testing.assert_array_equal(rk.render_obs_batch(mono, ts).numpy(), pallas)
    np.testing.assert_array_equal(trender_obs(mono, ts, 64).numpy(), xla)


# ---------------------------------------------------------------------------
# made-up tiled backgrounds: fruitbot states, the JAX side in a child
# ---------------------------------------------------------------------------

TILED_N = 8
TILED_CAMERAS = ("world", "centred")


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


def _fruitbot(centred=False):
    from procgen_tpu_torch.games.fruitbot import Fruitbot

    game = Fruitbot(GameOptions(distribution_mode=0, center_agent=centred))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _tiled_states():
    """Fruitbot-easy states with made-up world sizes (3 to 10 wide, 17 to
    60 high) and agents anywhere in them (two at the world's ends), after
    a few steps."""
    tg = _fruitbot()
    master = HostMT19937(21)
    seeds = np.array([master.next_u32() for _ in range(TILED_N)], np.int64)
    s = tlife.env_reset(tg, tlife.initial_state(tg, torch.as_tensor(seeds)))
    for a in np.random.RandomState(3).randint(0, 15, (3, TILED_N)):
        s, _ = tlife.env_step(tg, s, torch.as_tensor(a))
    rng = np.random.RandomState(8)
    w = np.array([3, 7, 9, 10, 10, 6, 4, 10], np.int32)
    h = np.array([17, 33, 47, 59, 60, 25, 60, 41], np.int32)
    e = s.ents
    ax = rng.uniform(0.5, w - 0.5).astype(np.float32)
    ay = rng.uniform(0.5, h - 0.5).astype(np.float32)
    ay[0], ay[1] = 0.5, h[1] - 0.5  # the world's bottom, its top in view
    return s.replace(
        main_width=torch.as_tensor(w), main_height=torch.as_tensor(h),
        ents=e.set_fields(0, x=torch.as_tensor(ax), y=torch.as_tensor(ay)),
        background_index=torch.as_tensor(rng.randint(0, 4, TILED_N).astype(np.int32)),
    )


def _jax_tiled(in_path, out_path):
    """The JAX package's frames and prep scalars of the saved states, under
    both cameras (child process)."""
    from procgen_tpu.games.fruitbot import Fruitbot as JFruitbot
    from procgen_tpu.render import atlas

    jax.config.update("jax_platforms", "cpu")
    with np.load(in_path) as z:
        tree = _nest({k: z[k] for k in z.files})
    out = {}
    for cam in TILED_CAMERAS:
        atlas._CACHE.clear()
        pallas_kernel._PLANS.clear()
        jg = JFruitbot(JGameOptions(distribution_mode=0,
                                    center_agent=cam == "centred"))
        template = jax.eval_shape(
            jax.vmap(lambda sd: jlife.initial_state(jg, sd)),
            jax.ShapeDtypeStruct((TILED_N,), jnp.uint32))
        full = {k: tree.get(k) for k in serialization.to_state_dict(template)}
        js = serialization.from_state_dict(
            template, jax.tree_util.tree_map(jnp.asarray, full))
        out[f"{cam}.pallas"] = np.asarray(jax.jit(
            lambda st: pallas_kernel.render_obs_batch(jg, st, 64, interpret=True)
        )(js))
        out[f"{cam}.xla"] = np.asarray(
            jax.jit(jax.vmap(lambda st: jrender_obs(jg, st, 64)))(js))
        plan = pallas_kernel.get_plan(jg, 64)
        out[f"{cam}.sf"] = np.asarray(
            jax.jit(jax.vmap(lambda st: pallas_kernel._prep_one(plan, st)["sf"]))(js))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def tiled(tmp_path_factory):
    """(the port's made-up states, the JAX child's arrays)."""
    ts = _tiled_states()
    d = tmp_path_factory.mktemp("tiled")
    np.savez(d / "in.npz", **_flat(state_to_numpy(ts)))
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"{flags} --xla_cpu_max_isa=AVX".strip(),
        JAX_COMPILATION_CACHE_DIR=jax.config.jax_compilation_cache_dir or "",
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="1",
    )
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(d / "in.npz"),
         str(d / "out.npz")], env=env, capture_output=True, text=True,
        timeout=1800)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(d / "out.npz") as z:
        return ts, {k: z[k] for k in z.files}


@pytest.mark.parametrize("cam", TILED_CAMERAS)
def test_tiled_prep_matches_pallas_prep(cam, tiled):
    """The tile height and the world rect, bit for bit: the tiles are not
    square, and under the centred camera the rects run off the frame above
    and below it."""
    ts, want = tiled
    game = _fruitbot(cam == "centred")
    x = rk.prep_frame(rk.get_plan(game), ts)
    np.testing.assert_array_equal(x.sf.numpy(), want[f"{cam}.sf"])
    sf = x.sf
    mr_y, mr_h, mr_w = sf[:, rk.SF_MRY], sf[:, rk.SF_MRH], sf[:, rk.SF_MRW]
    assert (torch.abs(sf[:, rk.SF_TILEH] - mr_w) > 0.5).any()
    if cam == "centred":
        assert (mr_y < 0).any() and (mr_y + mr_h > 64).any()
        assert ((mr_y > 0) | (mr_y + mr_h < 64)).any()


@pytest.mark.parametrize("cam", TILED_CAMERAS)
def test_tiled_frame_matches_pallas_and_xla(cam, tiled):
    ts, want = tiled
    game = _fruitbot(cam == "centred")
    got = rk.render_obs_batch(game, ts).numpy()
    np.testing.assert_array_equal(got, want[f"{cam}.pallas"])
    np.testing.assert_array_equal(want[f"{cam}.xla"], want[f"{cam}.pallas"])
    np.testing.assert_array_equal(trender_obs(game, ts, 64).numpy(), want[f"{cam}.xla"])



# ---------------------------------------------------------------------------
# made-up time-scrolled backgrounds: starpilot states
# ---------------------------------------------------------------------------

SCROLL_N = 8
CLOCKS = [0, 1, 17, 125, 333, 499, 777, 1000]


def _starpilot(mode=0, centred=False):
    from procgen_tpu_torch.games.starpilot import Starpilot

    game = Starpilot(GameOptions(distribution_mode=mode, center_agent=centred))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _scroll_states(mode, device="cpu"):
    """Starpilot states after 20 steps with made-up clocks (0 to 1000, the
    offsets of a whole episode), background images and sprites anywhere
    on or off the world."""
    tg = _starpilot(mode)
    master = HostMT19937(31 + mode)
    seeds = np.array([master.next_u32() for _ in range(SCROLL_N)], np.int64)
    s = tlife.env_reset(tg, tlife.initial_state(tg, torch.as_tensor(seeds, device=device)))
    for a in np.random.RandomState(mode).choice([9, 10, 1, 4, 7], (20, SCROLL_N)):
        s, _ = tlife.env_step(tg, s, torch.as_tensor(a, device=device))
    rng = np.random.RandomState(9 + mode)
    e = s.ents
    shape = tuple(e.x.shape)

    def made_up(v):
        return torch.as_tensor(v.astype(np.float32), device=device)

    ents = e.replace(x=torch.where(e.active, made_up(rng.uniform(-2, 18, shape)), e.x),
                     y=torch.where(e.active, made_up(rng.uniform(-2, 18, shape)), e.y))
    bi = rng.randint(0, 13, SCROLL_N).astype(np.int32)
    return s.replace(ents=ents.set_fields(0, x=made_up(rng.uniform(0.5, 15.5, SCROLL_N))),
                     cur_time=torch.as_tensor(np.array(CLOCKS, np.int32), device=device),
                     background_index=torch.as_tensor(bi, device=device))


@pytest.mark.parametrize("centred", [False, True], ids=["world", "centred"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_scroll_plain_renderer_matches_frame_reference(mode, centred):
    """The plain renderer (the game's ``paint_background``) and
    ``render_frame_reference`` (``prep_frame``'s scroll offset through
    ``background_lookup``) paint the same frames."""
    game = _starpilot(mode, centred)
    s = _scroll_states(mode)
    x = rk.prep_frame(rk.get_plan(game), s)
    assert x.bg_mode == rk.BG_SCROLL
    assert (x.sf[:, rk.SF_BGRX] == -s.cur_time.float() * 4 * np.float32(0.2)).all()
    np.testing.assert_array_equal(trender_obs(game, s, 64).numpy(),
                                  rk.render_obs_batch(game, s).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_cuda_scroll_frame_matches_frame_reference(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = _scroll_states(mode, device="cuda")
    for centred in (False, True):
        x = rk.prep_frame(rk.get_plan(_starpilot(mode, centred)), s)
        before = rk.LAUNCHES["render_frame"]
        got = rk.render_frame(x)
        want = rk.render_frame_reference(x)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["render_frame"] == before + 1
        assert torch.equal(got, want)


if __name__ == "__main__":
    _jax_tiled(sys.argv[1], sys.argv[2])
