"""The port's host-side copies against the JAX package's originals:
constants, options, the host MT19937, and the baked atlases (byte-equal
to ``procgen_tpu.render.atlas.get_atlases``), including the torch row
lookups against the JAX where-chains.  Tolerance: zero."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from procgen_tpu.core import constants as jconst
from procgen_tpu.core import options as jopts
from procgen_tpu.core.constants import EASY_MODE, HARD_MODE
from procgen_tpu.games.maze import Maze as JMaze
from procgen_tpu.render import assets as jassets
from procgen_tpu.render import atlas as jatlas
from procgen_tpu.utils.host_mt import HostMT19937 as JHostMT

from procgen_tpu_torch.core import constants as tconst
from procgen_tpu_torch.core import options as topts
from procgen_tpu_torch.games.maze import Maze as TMaze
from procgen_tpu_torch.render import assets as tassets
from procgen_tpu_torch.render import atlas as tatlas
from procgen_tpu_torch.utils.host_mt import HostMT19937 as THostMT


def test_constants_equal():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names == [n for n in dir(tconst) if n.isupper()]
    for n in names:
        assert getattr(jconst, n) == getattr(tconst, n), n
    for s in ("maze", "coinrun", "", "bossfight"):
        assert jconst.fnv1a_32(s) == tconst.fnv1a_32(s)


@pytest.mark.parametrize("opts", [
    {},
    {"distribution_mode": HARD_MODE, "paint_vel_info": True},
    {"use_sequential_levels": True, "restrict_themes": True, "game_type": 3},
])
def test_options_equal(opts):
    assert [f.name for f in dataclasses.fields(jopts.GameOptions)] == [
        f.name for f in dataclasses.fields(topts.GameOptions)]
    jo, jt = jopts.parse_game_options("maze", jopts.VecOptions(dict(opts)))
    to, tt = topts.parse_game_options("maze", topts.VecOptions(dict(opts)))
    assert dataclasses.asdict(jo) == dataclasses.asdict(to) and jt == tt
    with pytest.raises(ValueError):
        topts.parse_game_options("maze", topts.VecOptions({"bogus": 1}))


@pytest.mark.parametrize("seed", [0, 1, 23, 2**31 - 1, 2**32 - 1])
def test_host_mt_equal(seed):
    j, t = JHostMT(seed), THostMT(seed)
    assert [j.next_u32() for _ in range(1300)] == [t.next_u32() for _ in range(1300)]
    assert [j.randint(3, 1000) for _ in range(50)] == [t.randint(3, 1000) for _ in range(50)]
    assert [j.randint_raw() for _ in range(50)] == [t.randint_raw() for _ in range(50)]


def test_asset_tables_equal():
    for name in ("TOPDOWN_BACKGROUNDS", "PLATFORM_BACKGROUNDS", "SPACE_BACKGROUNDS",
                 "WATER_BACKGROUNDS", "CAVES"):
        assert getattr(jassets, name) == getattr(tassets, name)
    for rel in ("misc_assets/cheese.png", "kenney/Enemies/mouse_move.png"):
        np.testing.assert_array_equal(jassets.load_rgba(rel), tassets.load_rgba(rel))
        assert jassets.aspect_for(rel) == tassets.aspect_for(rel)
    types = np.arange(-5, 120)
    themes = np.arange(-2, 4)
    jr = jassets.monochrome_color(jnp.asarray(types)[:, None], jnp.asarray(themes)[None])
    tr = tassets.monochrome_color(torch.as_tensor(types)[:, None], torch.as_tensor(themes)[None])
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


class JMazeBank(JMaze):
    ARB_ROT_TYPES = {0: 8, 2: 5}


class TMazeBank(TMaze):
    ARB_ROT_TYPES = {0: 8, 2: 5}


@pytest.mark.parametrize("classes,mode", [
    ((JMaze, TMaze), EASY_MODE),
    ((JMaze, TMaze), HARD_MODE),
    ((JMazeBank, TMazeBank), EASY_MODE),
])
def test_atlases_equal(classes, mode):
    jcls, tcls = classes
    jg = jcls(jopts.GameOptions(distribution_mode=mode))
    tg = tcls(topts.GameOptions(distribution_mode=mode))
    ja = jatlas.get_atlases(jg, 64)
    ta = tatlas.get_atlases(tg, 64)
    for j, t in ((ja[0], ta[0]), (ja[2], ta[2])):
        assert j.tile_px == t.tile_px and j.entries == t.entries
        assert j.transparent_row == t.transparent_row
        np.testing.assert_array_equal(j.rows, t.rows)
        np.testing.assert_array_equal(j.bank_start, t.bank_start)
        np.testing.assert_array_equal(j.bank_k, t.bank_k)
        img = np.arange(-3, 105)[:, None].repeat(7, 1)
        theme = np.arange(-2, 5)[None, :].repeat(len(img), 0)
        np.testing.assert_array_equal(
            np.asarray(j.row_for(jnp.asarray(img), jnp.asarray(theme))),
            t.row_for(torch.as_tensor(img), torch.as_tensor(theme)).numpy(),
        )
        rng = np.random.RandomState(0)
        base = rng.randint(0, len(j.rows) + 2, 200)
        refl = rng.randint(0, 2, 200)
        rot = rng.uniform(-7, 7, 200).astype(np.float32)
        jb, jh = j.bank_row_for(jnp.asarray(base), jnp.asarray(refl), jnp.asarray(rot))
        tb, th = t.bank_row_for(torch.as_tensor(base), torch.as_tensor(refl),
                                torch.as_tensor(rot))
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
        np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    np.testing.assert_array_equal(ja[1].pixels, ta[1].pixels)
    np.testing.assert_array_equal(ja[1].aspects, ta[1].aspects)


def test_atlas_cache_keeps_monochrome_apart():
    """A monochrome game cached first must not hand its sprite-less
    atlases to a textured game of the same name and mode (the JAX
    package's cache key, procgen_tpu/render/atlas.py:241-244, leaves
    use_monochrome_assets out)."""
    mono = TMaze(topts.GameOptions(distribution_mode=EASY_MODE,
                                   use_monochrome_assets=True))
    textured = TMaze(topts.GameOptions(distribution_mode=EASY_MODE))
    assert tatlas.get_atlases(mono, 64)[2] is None
    ent = tatlas.get_atlases(textured, 64)[2]
    assert ent is not None and ent.rows.shape[0] > 1
