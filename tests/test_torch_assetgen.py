"""The port's generated assets against the JAX package's.

* The painted background: ``assetgen.generate_background_reference`` (the
  plain torch version of ``csrc/assetgen_bg.cu``) against the JAX
  package's ``generate_background`` under ``jax.jit(jax.vmap(...))``, on
  the draw blocks of eight seeded streams and on a made-up block that
  takes the longest path (99 outer blotches, each recursing into 19 inner
  ones): the canvases and the words used, bit-equal.  The words used
  also against a count of the draws of the port's host copy of AssetGen
  (``render/assetgen_host.py``), as tests/test_assetgen.py counts the JAX
  package's.
* ``rng.draw_block`` / ``advance_block``: the window of words and the
  stream advanced by the words used, against the JAX package's.
* The generated sprites: ``assetgen_host.bake_generated_asset`` and the
  generated rows of ``atlas.GridAtlas`` (coinrun and fruitbot, whose
  walls are blocks, at both cameras' tile sizes) against the JAX
  package's, byte for byte.

The JAX painter runs in a child process (this file run as a script) whose
XLA is held to AVX (``--xla_cpu_max_isa=AVX``): XLA's CPU backend would
otherwise contract the colors' ``v * len + start`` and the blends into
fused multiply-adds, which the port does not do.  Tolerance: zero.
"""

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

from procgen_tpu_torch.core import rng  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.games.registry import make_game  # noqa: E402
from procgen_tpu_torch.core import assetgen  # noqa: E402
from procgen_tpu_torch.render.assetgen_host import (  # noqa: E402
    HostRandGen, _paint_rect_resource, bake_generated_asset,
)

SEEDS = np.array([0, 1, 7, 1234, 999999, 2**31 - 1, 2**32 - 1, 424242], np.int64)


def _jax_reference(out_path):
    from procgen_tpu.core import rng as jrng
    from procgen_tpu.render import assetgen as jassetgen

    jax.config.update("jax_platforms", "cpu")

    @jax.jit
    def seeded(sd):
        def one(s):
            st = jrng.seed(s)
            vals, ctx = jrng.draw_block(st, jassetgen.N_MAX)
            canvas, used = jassetgen.generate_background(vals)
            st2 = jrng.advance_block(st, ctx, used)
            return vals, canvas, used, st2.mt, st2.pos
        return jax.vmap(one)(sd)

    vals, canvas, used, mt, pos = seeded(jnp.asarray(SEEDS, jnp.uint32))
    long_canvas, long_used = jax.jit(jax.vmap(jassetgen.generate_background))(
        jnp.asarray(assetgen.longest_path_words(0)[None], jnp.uint32))
    np.savez(out_path, vals=np.asarray(vals), canvas=np.asarray(canvas),
             used=np.asarray(used), mt=np.asarray(mt), pos=np.asarray(pos),
             long_canvas=np.asarray(long_canvas), long_used=np.asarray(long_used))


@pytest.fixture(scope="module")
def jax_child(tmp_path_factory):
    out = tmp_path_factory.mktemp("assetgen")
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"{flags} --xla_cpu_max_isa=AVX".strip(),
        JAX_COMPILATION_CACHE_DIR=jax.config.jax_compilation_cache_dir or "",
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="1",
    )
    path, log = out / "ref.npz", out / "ref.log"
    with open(log, "w") as err:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(path)],
                                env=env, stdout=subprocess.DEVNULL, stderr=err)
    yield path, proc, log
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def port(jax_child):
    """The port's painter on the seeded streams' words and on the
    longest path, computed while the JAX reference runs."""
    state = rng.seed(torch.as_tensor(SEEDS))
    vals, ctx = rng.draw_block(state, assetgen.N_MAX)
    canvas, used = assetgen.generate_background_reference(vals)
    long_canvas, long_used = assetgen.generate_background_reference(
        torch.as_tensor(assetgen.longest_path_words(0))[None])
    return dict(vals=vals, canvas=canvas, used=used,
                advanced=rng.advance_block(state, ctx, used),
                long_canvas=long_canvas, long_used=long_used)


@pytest.fixture(scope="module")
def ref(jax_child, port):
    path, proc, log = jax_child
    assert proc.wait(timeout=1800) == 0, log.read_text()[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_draw_block_matches_jax(ref, port):
    np.testing.assert_array_equal(port["vals"].numpy(), ref["vals"].astype(np.int64))
    adv = port["advanced"]
    np.testing.assert_array_equal(adv.mt.numpy(), ref["mt"].astype(np.int64))
    np.testing.assert_array_equal(adv.pos.numpy(), ref["pos"])


@pytest.mark.parametrize("block", ["seeded", "longest"])
def test_painter_matches_jax(block, ref, port):
    pre = "" if block == "seeded" else "long_"
    got_c, got_u = port[pre + "canvas"].numpy(), port[pre + "used"].numpy()
    assert got_c.dtype == np.uint8 and got_c.shape[1:] == (128, 128, 3)
    np.testing.assert_array_equal(got_u, ref[pre + "used"])
    bad = (got_c != ref[pre + "canvas"]).any(axis=-1)
    assert not bad.any(), (bad.sum(axis=(1, 2)), np.argwhere(bad)[:5])
    if block == "longest":
        assert got_u.tolist() == [50701]


class _CountingRandGen(HostRandGen):
    def __init__(self, seed):
        super().__init__(seed)
        self.count = 0

    def randint(self, low, high):
        self.count += 1
        return super().randint(low, high)

    def randn(self, high):
        self.count += 1
        return super().randn(high)

    def rand01(self):
        self.count += 1
        return super().rand01()


def test_used_matches_host_count(port):
    """The words used equal the draws of AssetGen's control flow, walked
    on the host (assetgen.cpp:104-132, num_recurse=1, blotch_scale=50)."""
    for seed, used in zip(SEEDS.tolist(), port["used"].tolist()):
        rg = _CountingRandGen(seed)
        _paint_rect_resource(np.zeros((4, 4, 4), np.uint8), rg, (0.0, 0.0, 500.0, 500.0), 1, 50)
        assert used == rg.count <= assetgen.N_MAX


@pytest.mark.parametrize("seed,type_,is_rect", [
    (0, 1, True), (1234, 7, True), (1234, 7, False), (-5, 54, False),
    (2**31 - 100, 99, True), (17, 12, False)])
def test_generated_sprite_matches_jax(seed, type_, is_rect):
    from procgen_tpu.render.assetgen_host import bake_generated_asset as jbake

    got = bake_generated_asset(seed, type_, is_rect)
    assert got.shape == (64, 64, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jbake(seed, type_, is_rect))


@pytest.mark.parametrize("name", ["coinrun", "fruitbot"])
def test_generated_atlas_matches_jax(name):
    """One generated theme a drawable type, rect resources for the game's
    block types, resized to both cameras' tile sizes and the sprites'."""
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game as jmake_game
    from procgen_tpu.render.atlas import GridAtlas as JGridAtlas
    from procgen_tpu_torch.render.atlas import GridAtlas

    game = make_game(name, GameOptions(use_generated_assets=True))
    jgame = jmake_game(name, JGameOptions(use_generated_assets=True))
    game.fixed_asset_seed = jgame.fixed_asset_seed = 31337
    blocks = [t for t in range(100) if game.use_block_asset(t)]
    assert blocks and blocks == [t for t in range(100) if jgame.use_block_asset(t)]
    for tile_px in (4, 7, 32):
        got, want = GridAtlas(game, tile_px), JGridAtlas(jgame, tile_px)
        assert got.entries == want.entries and all(th == 0 for _, th in got.entries)
        np.testing.assert_array_equal(got.rows, want.rows)


def test_painter_wrapper_takes_cuda_only():
    """The kernel wrapper raises on CPU tensors; the reset's background
    step takes the plain version for CPU states and counts no launch."""
    vals = torch.as_tensor(assetgen.longest_path_words(1))[None]
    with pytest.raises(ValueError):
        assetgen.generate_background(vals)
    before = dict(assetgen.LAUNCHES)
    game = make_game("maze", GameOptions(use_generated_assets=True))
    from procgen_tpu_torch.core import lifecycle

    s = lifecycle.initial_state(game, torch.as_tensor([3, 4]))
    assert s.bg_canvas.shape == (2, 128, 128, 3) and not s.bg_canvas.any()
    s2 = assetgen.consume_background_draws(game, s)
    assert assetgen.LAUNCHES == before
    assert s2.bg_canvas.dtype == torch.uint8 and s2.bg_canvas.float().std() > 10


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
