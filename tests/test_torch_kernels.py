"""The port's CUDA frame kernels against their plain torch versions.

Imports no JAX, so the file also runs on the GPU machine, where the
``cuda``-marked tests launch the kernels:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest.py imports jax.)  On the CPU the
``cuda`` tests skip and the rest check the wrappers' contracts.
"""

import dataclasses

import numpy as np
import pytest
import torch

from procgen_tpu_torch.core.options import GameOptions
from procgen_tpu_torch.core import lifecycle
from procgen_tpu_torch.core.constants import INT32_MAX
from procgen_tpu_torch.games.bossfight import BARRIER, Bossfight
from procgen_tpu_torch.games.chaser import Chaser
from procgen_tpu_torch.games.climber import Climber
from procgen_tpu_torch.games.coinrun import Coinrun
from procgen_tpu_torch.games.dodgeball import LAVA_WALL, Dodgeball
from procgen_tpu_torch.games.fruitbot import Fruitbot
from procgen_tpu_torch.games.maze import Maze
from procgen_tpu_torch.games.miner import Miner
from procgen_tpu_torch.games.plunder import Plunder
from procgen_tpu_torch.games.starpilot import Starpilot
from procgen_tpu_torch.render import render_kernel as rk


def _atlas(device="cpu"):
    return rk.get_plan(Maze(GameOptions(distribution_mode=0))).atlas(device)


def test_cpu_tensors_never_reach_the_kernel():
    """The kernel entry point takes CUDA tensors only; the plain version
    serves CPU tensors and counts no launch."""
    ent_f, ent_i = rk.synthetic_slots(2, 3, 4)
    base = torch.zeros((2, 64, 64, 3), dtype=torch.uint8)
    atlas = torch.zeros((4, 8, 8, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        rk.render_suffix(base, ent_f, ent_i, atlas, 2)
    before = dict(rk.LAUNCHES)
    out = rk.render_suffix_reference(base, ent_f, ent_i, atlas, 2)
    assert out.shape == (2, 64, 64, 3) and out.dtype == torch.uint8
    assert rk.LAUNCHES == before


def test_dead_slots_leave_the_frame():
    """Blending with alpha 0 is an exact identity: a batch whose slots are
    all dead or at a foreign z returns the base frame."""
    atlas = _atlas()
    ent_f, ent_i = rk.synthetic_slots(8, 5, atlas.shape[0], seed=4)
    ent_i[..., rk.EI_LIVE] = torch.as_tensor(np.arange(40).reshape(8, 5) % 2)
    ent_i[..., rk.EI_Z] = torch.where(ent_i[..., rk.EI_LIVE] > 0, -1, 1)
    base = torch.as_tensor(
        np.random.RandomState(0).randint(0, 256, (8, 64, 64, 3)).astype(np.uint8))
    out = rk.render_suffix_reference(base, ent_f, ent_i, atlas, 2)
    assert torch.equal(out, base)


def test_synthetic_slots_cover_the_modes():
    ent_f, ent_i = rk.synthetic_slots(64, 8, 20, seed=0)
    live = ent_i[..., rk.EI_LIVE] > 0
    for col in (rk.EI_FB, rk.EI_PFLIP, rk.EI_QFLIP, rk.EI_TILEH, rk.EI_TILEV):
        assert (ent_i[..., col][live] > 0).any()
    assert (~live).any() and (ent_i[..., rk.EI_Z] < 0).any()
    assert (ent_f[..., rk.EF_H2] > 24).any() and (ent_f[..., rk.EF_ALPHA] < 1).any()
    assert (ent_f[..., rk.EF_X0] < 0).any() and (
        ent_f[..., rk.EF_X0] + ent_f[..., rk.EF_W2] > 64).any()
    assert (ent_i[..., rk.EI_ROW] >= 10).any()  # transposed-variant rows


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    atlas = _atlas(torch.device("cuda"))
    rng = np.random.RandomState(5)
    base = torch.as_tensor(
        rng.randint(0, 256, (256, 64, 64, 3)).astype(np.uint8)).cuda()
    for cap, nz in ((2, 2), (9, 1), (40, 2)):
        ent_f, ent_i = rk.synthetic_slots(256, cap, atlas.shape[0], seed=cap)
        ent_f, ent_i = ent_f.cuda(), ent_i.cuda()
        before = rk.LAUNCHES["render_suffix"]
        got = rk.render_suffix(base, ent_f, ent_i, atlas, nz)
        want = rk.render_suffix_reference(base, ent_f, ent_i, atlas, nz)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["render_suffix"] == before + 1
        assert torch.equal(got, want)


def _miner_plan(mode=0):
    return rk.get_plan(Miner(GameOptions(distribution_mode=mode)))


def _synthetic_frame(n, seed=0, device="cpu"):
    plan = _miner_plan()
    return rk.synthetic_frame_inputs(
        n, plan.NC, 5, plan.on("grid", device), plan.on("bg", device),
        plan.atlas(device), plan.grid_opaque, seed=seed,
    ).to(device)


def test_frame_cpu_tensors_never_reach_the_kernel():
    """render_frame takes CUDA tensors only; the plain version serves CPU
    tensors and counts no launch."""
    x = _synthetic_frame(3)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        rk.render_frame(x)
    before = dict(rk.LAUNCHES)
    out = rk.render_frame_reference(x)
    assert out.shape == (3, 64, 64, 3) and out.dtype == torch.uint8
    assert rk.LAUNCHES == before


@pytest.mark.parametrize("field", ["sf", "gtab", "cell5", "ent_i", "grid_atlas"])
def test_frame_bad_inputs_raise(field):
    """A wrong dtype, shape or layout raises before anything launches."""
    x = _synthetic_frame(2)
    bad = {
        "sf": x.sf[:, :5],
        "gtab": x.gtab.to(torch.int64),
        "cell5": x.cell5[:, :4],
        "ent_i": x.ent_i.transpose(0, 1),
        "grid_atlas": x.grid_atlas[..., :3],
    }[field]
    with pytest.raises(ValueError, match="must be"):
        rk.render_frame(dataclasses.replace(x, **{field: bad}))


def test_synthetic_frame_covers_the_modes():
    """The made-up batch reaches what miner's textured states do not."""
    x = _synthetic_frame(64)
    out = rk.render_frame_reference(x)
    valid = x.cell5[:, 3] > 0.5
    opaque = x.gtab < x.grid_opaque
    assert (valid & ~opaque).any() and (valid & opaque).any()
    assert (valid & (x.cell5[:, 4] < 1) & (x.cell5[:, 4] > 0)).any()
    assert (x.sf[:, rk.SF_BGRX] > 0).any() and (x.sf[:, rk.SF_MRY] > 0).any()
    z = x.ent_i[..., rk.EI_Z][x.ent_i[..., rk.EI_LIVE] > 0]
    assert all((z == k).any() for k in (0, 1, 2))
    # colored cells and background both reach the frame
    assert out.float().std() > 10


def _coinrun(mode=0, centred=True):
    game = Coinrun(GameOptions(distribution_mode=mode, center_agent=centred))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _synthetic_decor(n, cap, dcap, seed=0, device="cpu"):
    plan = rk.get_plan(_coinrun())
    return rk.synthetic_frame_inputs(
        n, plan.NC, cap, plan.on("grid", device), plan.on("bg", device),
        plan.atlas(device), plan.grid_opaque, seed=seed, dcap=dcap,
    ).to(device)


def _live_below_count(ent_i, count):
    """The live flags with every slot at or past the pool's count cleared."""
    slots = torch.arange(ent_i.shape[1])[None, :]
    return torch.where(slots < count[:, None], ent_i[..., rk.EI_LIVE], 0)


def test_synthetic_frame_covers_the_decor_pool():
    """The made-up batch fills the entity pool at z = -1, 0 and 1 (three
    canvases) and the decor pool at z = 0, as every game with one has it
    (z indices past it clip to it), with counts below the capacity in some
    envs, and the decor pool reaches the frame."""
    x = _synthetic_decor(64, 6, 10)
    assert x.nz == 3 and x.z_slots == (0, 1, 2)
    assert x.nzd == 1 and x.dz_slots == (-1, 0, -1)
    for f, i, c, zs in ((x.ent_f, x.ent_i, rk.SI_ENT_COUNT, (0, 1, 2)),
                        (x.dec_f, x.dec_i, rk.SI_DEC_COUNT, (0, 1))):
        count = x.si[:, c]
        live = _live_below_count(i, count) > 0
        z = i[..., rk.EI_Z][live]
        assert all((z == k).any() for k in zs)
        assert (count < i.shape[1]).any() and (count == i.shape[1]).any()
        assert (i[..., rk.EI_FB][live] > 0).any() and (f[..., rk.EF_ALPHA][live] < 1).any()
    no_decor = dataclasses.replace(x, dec_i=x.dec_i.clone())
    no_decor.dec_i[..., rk.EI_LIVE] = 0
    assert not torch.equal(rk.render_frame_reference(x),
                           rk.render_frame_reference(no_decor))


def test_slots_past_the_count_do_not_paint():
    """Each pool is walked to its live count: clearing the live flag of
    every slot at or past the count changes no pixel."""
    x = _synthetic_decor(32, 6, 10, seed=2)
    cleared = dataclasses.replace(x, ent_i=x.ent_i.clone(), dec_i=x.dec_i.clone())
    cleared.ent_i[..., rk.EI_LIVE] = _live_below_count(x.ent_i, x.si[:, rk.SI_ENT_COUNT])
    cleared.dec_i[..., rk.EI_LIVE] = _live_below_count(x.dec_i, x.si[:, rk.SI_DEC_COUNT])
    assert not torch.equal(cleared.ent_i, x.ent_i)
    assert torch.equal(rk.render_frame_reference(x), rk.render_frame_reference(cleared))


def test_decor_composites_after_the_entity_pool():
    """At one z level the decor pool's canvas goes over the entity pool's
    (the JAX package's paint order): two opaque fallback rects on the same
    pixels, one in each pool, show the decor rect's colour."""
    x = _synthetic_decor(1, 1, 1, seed=3)
    for f, i, rgb in ((x.ent_f, x.ent_i, (200, 10, 10)), (x.dec_f, x.dec_i, (10, 200, 10))):
        f[0, 0, :rk.EF_R] = torch.tensor([8.0, 8.0, 16.0, 16.0, 1.0])
        f[0, 0, rk.EF_R:] = torch.tensor(rgb, dtype=torch.float32)
        i[0, 0] = 0
        i[0, 0, rk.EI_LIVE] = i[0, 0, rk.EI_FB] = i[0, 0, rk.EI_Z] = 1
    x.ent_i[0, 0, rk.EI_NTH] = x.ent_i[0, 0, rk.EI_NTV] = 1
    x.dec_i[0, 0, rk.EI_NTH] = x.dec_i[0, 0, rk.EI_NTV] = 1
    x.si[:, rk.SI_ENT_COUNT] = x.si[:, rk.SI_DEC_COUNT] = 1
    out = rk.render_frame_reference(x)
    assert out[0, 12, 12].tolist() == [10, 200, 10]


def test_frame_kernel_takes_64x64_windows():
    """The whole-world camera's 64x64 cell window (80 KB of cell planes an
    env) passes the wrapper's checks: the planes are read from global
    memory, so only the frame, the slot tables, the scalars, the row table
    (16 KB) and the row and column terms count against shared memory.
    Pools past a block's 227 KiB, or more than four canvases, are
    refused."""
    plan = rk.get_plan(_coinrun(centred=False))
    assert plan.NC == 64
    x = rk.synthetic_frame_inputs(
        2, plan.NC, 48, plan.on("grid", "cpu"), plan.on("bg", "cpu"),
        plan.atlas("cpu"), plan.grid_opaque, dcap=96)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        rk.render_frame(x)
    assert rk.frame_smem(plan.NC, 48, 96) > 48 * 1024
    too_many = dataclasses.replace(x, dec_f=x.dec_f.repeat(1, 9, 1),
                                   dec_i=x.dec_i.repeat(1, 9, 1))
    assert rk.frame_smem(plan.NC, 48, 96 * 9) > rk.SMEM_MAX
    with pytest.raises(ValueError, match="out of range"):
        rk.render_frame(too_many)
    too_deep = dataclasses.replace(x, nzd=2, dz_slots=(-1, 0, 1))
    with pytest.raises(ValueError, match="out of range"):
        rk.render_frame(too_deep)


@pytest.mark.cuda
def test_cuda_frame_kernel_decor_matches_plain_version():
    """Both pools, both cameras: made-up full pools and coinrun states
    with live trails."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    syn = _synthetic_decor(256, 48, 96, seed=4, device=dev)
    # and the decor pool's canvases at z = -1 and 1 (no game has them yet)
    inputs = [syn, dataclasses.replace(syn, nz=2, z_slots=(-1, 0, 1),
                                       nzd=2, dz_slots=(0, -1, 1))]
    seeds = torch.arange(64, dtype=torch.int64, device=dev) * 7919 + 3
    for mode in (0, 1):
        game = _coinrun(mode, centred=False)
        s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
        acts = np.random.RandomState(mode).randint(0, 15, (30, 64))
        for a in acts:
            s, _ = lifecycle.env_step(game, s, torch.as_tensor(a, device=dev))
        assert int(s.decor.count.sum()) > 0
        for centred in (False, True):
            inputs.append(rk.prep_frame(rk.get_plan(_coinrun(mode, centred)), s))
    for x in inputs:
        before = rk.LAUNCHES["render_frame"]
        got = rk.render_frame(x)
        want = rk.render_frame_reference(x)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["render_frame"] == before + 1
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_frame_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    inputs = [_synthetic_frame(256, seed=1, device=dev)]
    for mode in (0, 1):
        game = Miner(GameOptions(distribution_mode=mode))
        game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        seeds = torch.arange(64, dtype=torch.int64, device=dev) * 7919 + 1
        s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
        acts = np.random.RandomState(mode).randint(0, 15, (5, 64))
        for a in acts:
            s, _ = lifecycle.env_step(game, s, torch.as_tensor(a, device=dev))
        inputs.append(rk.prep_frame(rk.get_plan(game), s))
    for x in inputs:
        before = rk.LAUNCHES["render_frame"]
        got = rk.render_frame(x)
        want = rk.render_frame_reference(x)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["render_frame"] == before + 1
        assert torch.equal(got, want)


def _fruitbot(mode=0, centred=False):
    game = Fruitbot(GameOptions(distribution_mode=mode, center_agent=centred))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _synthetic_tiled(n, cap, seed=0, device="cpu"):
    plan = rk.get_plan(_fruitbot())
    return rk.synthetic_frame_inputs(
        n, plan.NC, cap, plan.on("grid", device), plan.on("bg", device),
        plan.atlas(device), plan.grid_opaque, seed=seed, bg_mode=rk.BG_TILED,
    ).to(device)


def test_synthetic_frame_covers_tiling():
    """The made-up tiled batch: tile heights that do not divide the world
    rect, rects above, across and below the frame and partly off it
    sideways; the tiled background reaches the frame and differs from the
    crop of the same scalars."""
    x = _synthetic_tiled(64, 4)
    assert x.bg_mode == rk.BG_TILED
    sf = x.sf
    mr_x, mr_y = sf[:, rk.SF_MRX], sf[:, rk.SF_MRY]
    mr_w, mr_h = sf[:, rk.SF_MRW], sf[:, rk.SF_MRH]
    tiles = mr_h / sf[:, rk.SF_TILEH]
    assert (torch.abs(tiles - torch.round(tiles)) > 0.05).any()
    assert (torch.abs(tiles - torch.round(tiles)) < 1e-4).any()
    assert (mr_y < 0).any() and (mr_y > 0).any() and (mr_y + mr_h < 64).any()
    assert (mr_x < 0).any() and (mr_x + mr_w > 64).any()
    crop = dataclasses.replace(x, bg_mode=rk.BG_CROP)
    assert not torch.equal(rk.render_frame_reference(x), rk.render_frame_reference(crop))


def test_tiled_background_repeats_by_tile_height():
    """One env, nothing over the background: pixel row r shows image row
    int(frac((r + 0.5 - mr_y) / tile_h) * BH) inside the world rect, and
    black outside it; rows one tile apart match."""
    x = _synthetic_tiled(1, 1, seed=5)
    x.ent_i[..., rk.EI_LIVE] = 0
    x.gtab.fill_(x.grid_opaque)
    x.cell5[:, 3] = 0
    x.sf[0, rk.SF_MRX], x.sf[0, rk.SF_MRW] = 0.0, 64.0
    x.sf[0, rk.SF_MRY], x.sf[0, rk.SF_MRH], x.sf[0, rk.SF_TILEH] = -3.0, 60.0, 20.0
    out = rk.render_frame_reference(x)[0]
    img = x.bg_atlas[int(x.si[0, rk.SI_BGROW].clamp(0, x.bg_atlas.shape[0] - 1))]
    BH, BW = img.shape[0], img.shape[1]
    for r in range(64):
        if r + 0.5 >= 57.0:
            assert not out[r].any()
            continue
        row = int((((r + 0.5 + 3.0) / 20.0) % 1.0) * BH)
        cols = (np.arange(64) + 0.5) / 64.0 * BW
        assert torch.equal(out[r], img[row, cols.astype(np.int64)])
    assert torch.equal(out[5], out[25]) and torch.equal(out[25], out[45])


def test_frame_bad_bg_mode_raises():
    x = dataclasses.replace(_synthetic_tiled(2, 2), bg_mode=rk.BG_SCROLL + 1)
    with pytest.raises(ValueError, match="out of range"):
        rk.render_frame(x)


@pytest.mark.cuda
def test_cuda_frame_kernel_tiled_matches_plain_version():
    """The tiled background: made-up rects and tile heights, and fruitbot
    easy and hard states (112-slot pools, tiled barriers and doors, the
    agent's quarter turn) under both cameras."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    inputs = [_synthetic_tiled(256, 24, seed=6, device=dev)]
    seeds = torch.arange(64, dtype=torch.int64, device=dev) * 7919 + 5
    for mode in (0, 1):
        game = _fruitbot(mode)
        s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
        acts = np.random.RandomState(mode).choice([1, 4, 7, 9], (20, 64))
        for a in acts:
            s, _ = lifecycle.env_step(game, s, torch.as_tensor(a, device=dev))
        for centred in (False, True):
            inputs.append(rk.prep_frame(rk.get_plan(_fruitbot(mode, centred)), s))
    for x in inputs:
        assert x.bg_mode == rk.BG_TILED
        before = rk.LAUNCHES["render_frame"]
        got = rk.render_frame(x)
        want = rk.render_frame_reference(x)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["render_frame"] == before + 1
        assert torch.equal(got, want)


def _starpilot(mode=0, centred=False):
    game = Starpilot(GameOptions(distribution_mode=mode, center_agent=centred))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _synthetic_scroll(n, cap, seed=0, device="cpu"):
    plan = rk.get_plan(_starpilot())
    return rk.synthetic_frame_inputs(
        n, plan.NC, cap, plan.on("grid", device), plan.on("bg", device),
        plan.atlas(device), plan.grid_opaque, seed=seed, bg_mode=rk.BG_SCROLL,
    ).to(device)


def test_synthetic_frame_covers_scrolling():
    """The made-up scrolled batch: offsets that leave the frame on the
    tiles, part of it past their right end, and all of it past it; the
    scrolled background differs from the crop of the same scalars."""
    x = _synthetic_scroll(64, 4)
    assert x.bg_mode == rk.BG_SCROLL
    _, _, _, _, in_x = rk.background_lookup(x)
    on = in_x.sum(dim=1)
    assert (on == 64).any() and ((on > 0) & (on < 64)).any() and (on == 0).any()
    crop = dataclasses.replace(x, bg_mode=rk.BG_CROP)
    assert not torch.equal(rk.render_frame_reference(x), rk.render_frame_reference(crop))


def test_scrolled_background_follows_the_offset():
    """One env, nothing over the background: pixel (r, c) shows image row
    int((r + 0.5 + 64) / 192 * BH) and column int(frac((c + 0.5 - off) /
    192) * BW) of the 18 tiles, black past their end; an offset of one
    tile side shows the same frame."""
    x = _synthetic_scroll(1, 1, seed=5)
    x.ent_i[..., rk.EI_LIVE] = 0
    x.gtab.fill_(x.grid_opaque)
    x.cell5[:, 3] = 0
    img = x.bg_atlas[int(x.si[0, rk.SI_BGROW].clamp(0, x.bg_atlas.shape[0] - 1))]
    BH, BW = img.shape[0], img.shape[1]
    frames = {}
    for off in (-40.0, -232.0, -3440.0):
        x.sf[0, rk.SF_BGRX] = off
        out = rk.render_frame_reference(x)[0]
        tx = np.arange(64) + 0.5 - off
        cols = (((tx / 192.0) % 1.0) * BW).astype(np.int64)
        for r in (0, 31, 63):
            row = int((r + 0.5 + 64) / 192 * BH)
            on = tx < 18 * 192
            assert torch.equal(out[r][torch.as_tensor(on)], img[row, cols[on]])
            assert not out[r][torch.as_tensor(~on)].any()
        frames[off] = out
    assert torch.equal(frames[-40.0], frames[-232.0])
    assert not frames[-3440.0][:, 48:].any() and frames[-3440.0][:, :16].any()


@pytest.mark.cuda
def test_cuda_frame_kernel_scroll_matches_plain_version():
    """The time-scrolled background: made-up offsets, and starpilot easy,
    hard and extreme states (bullets on the rotation bank, explosions in
    the decor pool) under both cameras."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    inputs = [_synthetic_scroll(256, 24, seed=6, device=dev)]
    seeds = torch.arange(64, dtype=torch.int64, device=dev) * 7919 + 9
    for mode in (0, 1, 2):
        game = _starpilot(mode)
        s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
        acts = np.random.RandomState(mode).choice([9, 10, 1, 7], (40, 64))
        for a in acts:
            s, _ = lifecycle.env_step(game, s, torch.as_tensor(a, device=dev))
        for centred in (False, True):
            inputs.append(rk.prep_frame(rk.get_plan(_starpilot(mode, centred)), s))
    for x in inputs:
        assert x.bg_mode == rk.BG_SCROLL
        before = rk.LAUNCHES["render_frame"]
        got = rk.render_frame(x)
        want = rk.render_frame_reference(x)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["render_frame"] == before + 1
        assert torch.equal(got, want)


# -- the decor pool on the static-prefix path (plunder) ----------------------


def _plunder(mode=0):
    game = Plunder(GameOptions(distribution_mode=mode))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _synthetic_suffix(n, cap, dcap, dz_levels=(0,), seed=0, device="cpu"):
    atlas = rk.get_plan(_plunder()).atlas(device)
    base, ent_f, ent_i, decor = rk.synthetic_suffix_inputs(
        n, cap, dcap, atlas.shape[0], dz_levels=dz_levels, seed=seed)
    return base.to(device), ent_f.to(device), ent_i.to(device), atlas, decor.to(device)


def test_synthetic_suffix_covers_the_decor_pool():
    """The made-up static batch fills the decor pool (counts below the
    capacity in some envs), at z = 0 and past it (clipped to it), and the
    decor pool reaches the frame."""
    base, ent_f, ent_i, atlas, decor = _synthetic_suffix(64, 6, 10, seed=1)
    assert decor.nzd == 1 and decor.z_slots == (0, 1) and decor.dz_slots == (0, -1)
    for i, count, zs in ((ent_i, decor.counts[:, 0], (0, 1)),
                         (decor.dec_i, decor.counts[:, 1], (0, 1))):
        live = _live_below_count(i, count) > 0
        z = i[..., rk.EI_Z][live]
        assert all((z == k).any() for k in zs)
        assert (count < i.shape[1]).any() and (count == i.shape[1]).any()
    no_decor = dataclasses.replace(decor, dec_i=decor.dec_i.clone())
    no_decor.dec_i[..., rk.EI_LIVE] = 0
    assert not torch.equal(
        rk.render_suffix_reference(base, ent_f, ent_i, atlas, 2, decor),
        rk.render_suffix_reference(base, ent_f, ent_i, atlas, 2, no_decor))


def test_suffix_decor_composites_after_the_entity_pool():
    """At z = 0 the decor pool's canvas goes over the entity pool's, and
    the entity pool's z = 1 canvas over both: opaque fallback rects on the
    same pixels show the decor rect's colour, or the z = 1 rect's."""
    base, ent_f, ent_i, atlas, decor = _synthetic_suffix(2, 2, 1, seed=3)
    rects = ((ent_f, ent_i, 0, 0, (200, 10, 10)), (decor.dec_f, decor.dec_i, 0, 0, (10, 200, 10)),
             (ent_f, ent_i, 1, 1, (10, 10, 200)))
    for f, i, slot, z, rgb in rects:
        f[:, slot, :rk.EF_R] = torch.tensor([8.0, 8.0, 16.0, 16.0, 1.0])
        f[:, slot, rk.EF_R:] = torch.tensor(rgb, dtype=torch.float32)
        i[:, slot] = 0
        i[:, slot, rk.EI_LIVE] = i[:, slot, rk.EI_FB] = 1
        i[:, slot, rk.EI_Z] = z
        i[:, slot, rk.EI_NTH] = i[:, slot, rk.EI_NTV] = 1
    decor.counts[0] = torch.tensor([1, 1])  # env 0: the z = 1 rect is past the count
    decor.counts[1] = torch.tensor([2, 1])
    out = rk.render_suffix_reference(base, ent_f, ent_i, atlas, 2, decor)
    assert out[0, 12, 12].tolist() == [10, 200, 10]
    assert out[1, 12, 12].tolist() == [10, 10, 200]


def test_suffix_slots_past_the_count_do_not_paint():
    """With the decor pool each pool is walked to its live count: clearing
    the live flag of every slot at or past the count changes no pixel."""
    base, ent_f, ent_i, atlas, decor = _synthetic_suffix(32, 6, 10, seed=2)
    cleared = dataclasses.replace(decor, dec_i=decor.dec_i.clone())
    cleared.dec_i[..., rk.EI_LIVE] = _live_below_count(decor.dec_i, decor.counts[:, 1])
    ent_live = ent_i.clone()
    ent_live[..., rk.EI_LIVE] = _live_below_count(ent_i, decor.counts[:, 0])
    assert not torch.equal(ent_live, ent_i)
    assert torch.equal(
        rk.render_suffix_reference(base, ent_f, ent_i, atlas, 2, decor),
        rk.render_suffix_reference(base, ent_f, ent_live, atlas, 2, cleared))


def test_suffix_with_an_empty_decor_pool_is_the_entity_pass():
    """The two instances agree where they overlap: an empty decor pool and
    full entity counts give the frame of the entity-only path."""
    base, ent_f, ent_i, atlas, decor = _synthetic_suffix(16, 6, 4, seed=5)
    empty = dataclasses.replace(decor, counts=torch.stack(
        [torch.full((16,), 6), torch.zeros(16, dtype=torch.int64)], 1).to(torch.int32))
    assert torch.equal(rk.render_suffix_reference(base, ent_f, ent_i, atlas, 2, empty),
                       rk.render_suffix_reference(base, ent_f, ent_i, atlas, 2))


def test_suffix_decor_bad_inputs_raise():
    """On CPU tensors the wrapper raises before any launch; more than four
    canvases, a z index past a pool's canvases or pools past a block's 227
    KiB of shared memory are refused."""
    base, ent_f, ent_i, atlas, decor = _synthetic_suffix(2, 6, 4, dz_levels=(0, 1))
    before = dict(rk.LAUNCHES)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        rk.render_suffix(base, ent_f, ent_i, atlas, 2, decor)
    for bad in (dataclasses.replace(decor, nzd=3),
                dataclasses.replace(decor, dz_slots=(0, 2)),
                dataclasses.replace(decor, dec_f=decor.dec_f.repeat(1, 300, 1),
                                    dec_i=decor.dec_i.repeat(1, 300, 1))):
        with pytest.raises(ValueError, match="out of range"):
            rk.render_suffix(base, ent_f, ent_i, atlas, 2, bad)
    assert rk.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_suffix_kernel_decor_matches_plain_version():
    """The decor instance: made-up full pools with the decor canvas at
    z = 0 (plunder's) and at z = 0 and 1 (four canvases), and plunder easy
    and hard states with live explosions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    inputs = [_synthetic_suffix(256, 48, 24, seed=7, device=dev),
              _synthetic_suffix(256, 40, 160, dz_levels=(0, 1), seed=8, device=dev)]
    seeds = torch.arange(64, dtype=torch.int64, device=dev) * 7919 + 5
    for mode in (0, 1):
        game = _plunder(mode)
        s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
        acts = np.random.RandomState(mode).choice([9, 10, 1, 7, 4], (60, 64))
        for a in acts:
            s, _ = lifecycle.env_step(game, s, torch.as_tensor(a, device=dev))
        assert int(s.decor.count.sum()) > 0
        plan = rk.get_plan(game)
        ent_f, ent_i, decor = rk.prep_suffix(plan, s)
        inputs.append((s.frame.contiguous(), ent_f, ent_i, plan.atlas(dev), decor))
    for base, ent_f, ent_i, atlas, decor in inputs:
        before = rk.LAUNCHES["render_suffix"]
        got = rk.render_suffix(base, ent_f, ent_i, atlas, 2, decor)
        want = rk.render_suffix_reference(base, ent_f, ent_i, atlas, 2, decor)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["render_suffix"] == before + 1
        assert torch.equal(got, want)


# -- generated assets: the painter and the painted canvas (K1d) ---------------


def _genassets(game_cls, mode=0, centred=False):
    game = game_cls(GameOptions(distribution_mode=mode, center_agent=centred,
                                use_generated_assets=True))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    game.fixed_asset_seed = 4242
    return game


def test_painter_bad_inputs_raise():
    """The painter's wrapper takes int64 (N, N_MAX) CUDA words only."""
    from procgen_tpu_torch.core import assetgen

    vals = torch.as_tensor(assetgen.longest_path_words(0))[None]
    before = dict(assetgen.LAUNCHES)
    for bad in (vals, vals[:, :100], vals.to(torch.int32)):
        with pytest.raises(ValueError):
            assetgen.generate_background(bad)
    assert assetgen.LAUNCHES == before


def test_painted_canvas_frame_inputs():
    """Under generated assets the whole-frame path reads each env's own
    canvas (``SI_BGROW`` its index), cropped or tiled, and the wrapper
    states the [N, 128, 128, 3] shape it takes."""
    seeds = torch.arange(3, dtype=torch.int64) * 31 + 1
    for cls, mode in ((Coinrun, rk.BG_CROP), (Fruitbot, rk.BG_TILED),
                      (Starpilot, rk.BG_CROP)):
        game = _genassets(cls)
        s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
        x = rk.prep_frame(rk.get_plan(game), s)
        assert x.per_env_bg and x.bg_mode == mode and x.bg_atlas.shape == (3, 128, 128, 3)
        assert x.si[:, rk.SI_BGROW].tolist() == [0, 1, 2]
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            rk.render_frame(x)
        with pytest.raises(ValueError, match="bg_atlas"):
            rk.render_frame(dataclasses.replace(x, bg_atlas=x.bg_atlas[:2].contiguous()))


@pytest.mark.cuda
def test_cuda_painter_matches_plain_version():
    """``csrc/assetgen_bg.cu`` against the plain version: the draw blocks
    of 64 seeded streams (and one stream twice, in two chunks' worth of
    envs) and the longest path, byte-equal canvases and equal words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from procgen_tpu_torch.core import rng
    from procgen_tpu_torch.core import assetgen

    dev = torch.device("cuda")
    vals, _ = rng.draw_block(rng.seed(torch.arange(64, dtype=torch.int64) * 104729 + 3),
                             assetgen.N_MAX)
    vals = torch.cat([vals, torch.as_tensor(assetgen.longest_path_words(2))[None]])
    want_c, want_u = assetgen.generate_background_reference(vals)
    before = assetgen.LAUNCHES["assetgen_bg"]
    got_c, got_u = assetgen.generate_background(vals.to(dev))
    torch.cuda.synchronize()
    assert assetgen.LAUNCHES["assetgen_bg"] == before + 1
    assert torch.equal(got_u.cpu(), want_u) and torch.equal(got_c.cpu(), want_c)
    big = vals[:1].repeat(assetgen.CHUNK + 5, 1).to(dev)
    c2, u2 = assetgen.generate_background(big)
    torch.cuda.synchronize()
    assert (c2 == got_c[:1]).all() and (u2 == got_u[:1]).all()


@pytest.mark.cuda
def test_cuda_frame_kernel_painted_canvas_matches_plain_version():
    """``render_frame`` on the painted canvas: coinrun under both cameras
    (cropped, a world that is not square), fruitbot (tiled), miner and
    starpilot (cropped, not scrolled), after 30 random steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    seeds = torch.arange(64, dtype=torch.int64, device=dev) * 7919 + 11
    for cls, centred in ((Coinrun, False), (Coinrun, True), (Fruitbot, False),
                         (Miner, False), (Starpilot, True)):
        game = _genassets(cls, centred=centred)
        s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
        for a in np.random.RandomState(1).randint(0, 15, (30, 64)):
            s, _ = lifecycle.env_step(game, s, torch.as_tensor(a, device=dev))
        x = rk.prep_frame(rk.get_plan(game), s)
        assert x.per_env_bg
        before = rk.LAUNCHES["render_frame"]
        got = rk.render_frame(x)
        want = rk.render_frame_reference(x)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["render_frame"] == before + 1
        assert torch.equal(got, want)


# -- the kernels' plan: per-axis texel tables, per-row slot lists ------------


def _pix():
    return torch.arange(64, dtype=torch.float32) + 0.5


def _covers(ent_f, origin, extent):
    """[N, cap, 64]: the plain version's own rectangle test along one axis,
    (pix - origin) / extent in [0, 1)."""
    u = (_pix()[None, None, :] - ent_f[..., origin, None]) / ent_f[..., extent, None]
    return (u >= 0) & (u < 1)


def _cut_frame(ent_f, ent_i):
    """ent_i with every slot whose rectangle misses the whole frame dead."""
    hit = (_covers(ent_f, rk.EF_X0, rk.EF_W2).any(-1)
           & _covers(ent_f, rk.EF_Y0, rk.EF_H2).any(-1))
    out = ent_i.clone()
    out[..., rk.EI_LIVE] = torch.where(hit, ent_i[..., rk.EI_LIVE], 0)
    return out


def _per_row(t):
    """[N, ...] -> [N * 64, ...]: each env once for every pixel row."""
    return t.repeat_interleave(64, dim=0)


def _cut_rows(ent_f, ent_i):
    """[N * 64, cap, EI_N]: copy r of each env keeps live only the slots
    whose rectangle covers pixel row r, the slots of row r's list."""
    n, cap = ent_i.shape[:2]
    rows = _covers(ent_f, rk.EF_Y0, rk.EF_H2).permute(0, 2, 1)  # [N, 64, cap]
    out = _per_row(ent_i).reshape(n, 64, cap, rk.EI_N).clone()
    out[..., rk.EI_LIVE] = torch.where(rows, out[..., rk.EI_LIVE], 0)
    return out.reshape(n * 64, cap, rk.EI_N)


def _row_of_each(frames, n):
    """Row r of copy r of each env: [N * 64, 64, 64, 3] -> [N, 64, 64, 3]."""
    r = torch.arange(64)
    return frames.reshape(n, 64, 64, 64, 3)[:, r, r]


def test_edge_slots_reach_the_boundaries():
    """The edge cases: rect edges on pixel centres with u == 0 at the first
    pixel and the float just below 1 at the last, extents at the 1e-6
    clamp, origins of -0.0, rects off the frame along one axis only and over
    the whole frame, tiled slots with u * ntiles on integers, and envs where
    only the slots at the row masks' word ends live."""
    ent_f, ent_i = rk.synthetic_slots(16, 112, 20, seed=3, edges=True)
    pix = _pix()
    u = (pix[None, None, :] - ent_f[..., rk.EF_X0, None]) / ent_f[..., rk.EF_W2, None]
    below1 = torch.tensor(np.nextafter(np.float32(1), np.float32(0)))
    assert (u == 0).any() and (u == below1).any()
    assert (ent_f[..., rk.EF_W2] == np.float32(1e-6)).any()
    assert (ent_f[..., rk.EF_H2] == np.float32(1e-6)).any()
    x0 = ent_f[..., rk.EF_X0]
    assert ((x0 == 0) & torch.signbit(x0)).any()
    cx = _covers(ent_f, rk.EF_X0, rk.EF_W2)
    cy = _covers(ent_f, rk.EF_Y0, rk.EF_H2)
    assert (~cx.any(-1) & cy.any(-1)).any() and (cx.any(-1) & ~cy.any(-1)).any()
    assert (cx.all(-1) & cy.all(-1)).any()
    tiled = ent_i[..., rk.EI_TILEH] > 0
    ut = u * ent_i[..., rk.EI_NTH, None].float()
    assert ((ut == torch.floor(ut)) & (ut > 0) & cx & tiled[..., None]).any()
    live = ent_i[..., rk.EI_LIVE] > 0
    only = torch.as_tensor(rk.edge_envs(16))
    assert torch.equal(live[only].nonzero()[:, 1].unique(), torch.tensor(rk.EDGE_LIVE))
    assert (ent_i[..., rk.EI_Z][only][:, list(rk.EDGE_LIVE)] >= 0).all()


def test_suffix_culling_is_exact():
    """The identity the kernels' plan rests on, in the plain static-path
    version, on the edge cases with both pools: killing every slot whose
    rectangle misses the frame, or, row by row, every slot whose rectangle
    misses the row, leaves the frame byte-equal."""
    n = 2
    atlas = rk.get_plan(_plunder()).atlas("cpu")
    base, ent_f, ent_i, decor = rk.synthetic_suffix_inputs(
        n, 40, 24, atlas.shape[0], seed=11, edges=True)
    want = rk.render_suffix_reference(base, ent_f, ent_i, atlas, 2, decor)
    cut = dataclasses.replace(decor, dec_i=_cut_frame(decor.dec_f, decor.dec_i))
    ent_cut = _cut_frame(ent_f, ent_i)
    assert not torch.equal(ent_cut, ent_i)
    assert torch.equal(rk.render_suffix_reference(base, ent_f, ent_cut, atlas, 2, cut), want)
    rows = dataclasses.replace(decor, dec_f=_per_row(decor.dec_f),
                               dec_i=_cut_rows(decor.dec_f, decor.dec_i),
                               counts=_per_row(decor.counts))
    got = rk.render_suffix_reference(_per_row(base), _per_row(ent_f),
                                     _cut_rows(ent_f, ent_i), atlas, 2, rows)
    assert torch.equal(_row_of_each(got, n), want)
    # the entity-only instance's path walks every slot, with no counts
    want = rk.render_suffix_reference(base, ent_f, ent_i, atlas, 2)
    got = rk.render_suffix_reference(_per_row(base), _per_row(ent_f),
                                     _cut_rows(ent_f, ent_i), atlas, 2)
    assert torch.equal(_row_of_each(got, n), want)


def test_frame_culling_is_exact():
    """The same identity in the plain whole-frame version (background, grid,
    cells, three entity canvases and the decor pool's): slots cut per env
    and per row leave the frame byte-equal."""
    n = 2
    plan = rk.get_plan(_coinrun())
    x = rk.synthetic_frame_inputs(
        n, plan.NC, 24, plan.on("grid", "cpu"), plan.on("bg", "cpu"),
        plan.atlas("cpu"), plan.grid_opaque, seed=12, dcap=12, edges=True)
    want = rk.render_frame_reference(x)
    cut = dataclasses.replace(x, ent_i=_cut_frame(x.ent_f, x.ent_i),
                              dec_i=_cut_frame(x.dec_f, x.dec_i))
    assert not torch.equal(cut.ent_i, x.ent_i)
    assert torch.equal(rk.render_frame_reference(cut), want)
    rows = dataclasses.replace(
        x, sf=_per_row(x.sf), si=_per_row(x.si), gtab=_per_row(x.gtab),
        cell5=_per_row(x.cell5), ent_f=_per_row(x.ent_f),
        ent_i=_cut_rows(x.ent_f, x.ent_i), dec_f=_per_row(x.dec_f),
        dec_i=_cut_rows(x.dec_f, x.dec_i))
    assert torch.equal(_row_of_each(rk.render_frame_reference(rows), n), want)


def test_kernel_shared_memory_fits_the_games():
    """Every ported path's block fits a block's shared memory, the largest
    (coinrun's whole world: a 64x64 row table, 48 + 96 slots) above the
    default 48 KB; tiles past 254 px (the uint8 axis tables) are refused.
    Memory mode's centred windows (maze and miner 11 cells, dodgeball 19
    with 72 + 16 slots), dodgeball's static path (72 + 16), climber's two
    windows (64 and 19 cells, 24 slots) and bossfight's static path, the
    largest suffix block (72 + 160: 69,104 B, past 48 KB), fit too."""
    assert rk.frame_smem(64, 48, 96) > 48 * 1024
    for NC, cap, dcap in ((64, 48, 96), (60, 112, 0), (16, 64, 32), (16, 2, 0),
                          (11, 2, 0), (19, 72, 16), (64, 24, 0), (19, 24, 0)):
        assert rk.frame_smem(NC, cap, dcap) <= rk.SMEM_MAX
    for cap, dcap in ((2, 0), (48, 24), (72, 16), (72, 160)):
        assert rk.suffix_smem(cap, dcap) <= rk.SMEM_MAX
    assert rk.suffix_smem(72, 16) > rk.suffix_smem(48, 24)
    assert rk.suffix_smem(72, 160) == 69104 > 48 * 1024
    base, ent_f, ent_i, _, decor = _synthetic_suffix(2, 3, 2)
    big = torch.zeros((2, 255, 255, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="out of range"):
        rk.render_suffix(base, ent_f, ent_i, big, 2, decor)
    x = _synthetic_frame(2)
    with pytest.raises(ValueError, match="out of range"):
        rk.render_frame(dataclasses.replace(x, ent_atlas=big))


def _dodgeball_edge_inputs(n, seed, dev):
    """Made-up static-path inputs at dodgeball's full caps (72 + 16): the
    edge cases, with lava walls tiled along x and y and rotation-bank rows
    among the entity slots."""
    plan = rk.get_plan(Dodgeball(GameOptions(distribution_mode=0)))
    wall = int(plan.ent_atlas.row_for(torch.tensor([LAVA_WALL]), torch.tensor([0]))[0])
    base, ent_f, ent_i, decor = rk.synthetic_wall_inputs(n, plan, wall, seed=seed)
    return base.to(dev), ent_f.to(dev), ent_i.to(dev), plan.atlas(dev), decor.to(dev)


def _bossfight_edge_inputs(n, seed, dev):
    """Made-up static-path inputs at bossfight's full caps (72 + 160): the
    edge cases, with tiled slots and rotation-bank rows among the entity
    slots."""
    plan = rk.get_plan(Bossfight(GameOptions(distribution_mode=0)))
    meteor = int(plan.ent_atlas.row_for(torch.tensor([BARRIER]), torch.tensor([0]))[0])
    base, ent_f, ent_i, decor = rk.synthetic_wall_inputs(n, plan, meteor, seed=seed)
    return base.to(dev), ent_f.to(dev), ent_i.to(dev), plan.atlas(dev), decor.to(dev)


def _edge_inputs(case, n, dev):
    """Made-up inputs with the edge cases at a game's full caps."""
    if case == "dodgeball":
        return _dodgeball_edge_inputs(n, 24, dev)
    if case == "bossfight":
        return _bossfight_edge_inputs(n, 25, dev)
    if case in ("maze", "plunder"):
        atlas = rk.get_plan(_plunder()).atlas(dev)
        if case == "maze":  # the entity-only instance, fruitbot's cap
            ent_f, ent_i = rk.synthetic_slots(n, 112, atlas.shape[0], seed=21, edges=True)
            base = torch.as_tensor(np.random.RandomState(21).randint(
                0, 256, (n, 64, 64, 3)).astype(np.uint8))
            return base.to(dev), ent_f.to(dev), ent_i.to(dev), atlas, None
        base, ent_f, ent_i, decor = rk.synthetic_suffix_inputs(
            n, 48, 24, atlas.shape[0], seed=22, edges=True)
        return base.to(dev), ent_f.to(dev), ent_i.to(dev), atlas, decor.to(dev)
    game, cap, dcap, mode = {
        "miner": (_miner_plan().game, 112, 0, rk.BG_CROP),
        "coinrun": (_coinrun(centred=False), 48, 96, rk.BG_CROP),
        "fruitbot": (_fruitbot(), 112, 0, rk.BG_TILED),
        "starpilot": (_starpilot(), 64, 32, rk.BG_SCROLL),
        "climber": (Climber(GameOptions(distribution_mode=1, center_agent=True)), 24, 0,
                    rk.BG_CROP),
        # caveflyer memory's whole world: the largest frame block (60 cells)
        "caveflyer": (_caveflyer(10, False), 151, 32, rk.BG_CROP),
    }[case]
    plan = rk.get_plan(game)
    return rk.synthetic_frame_inputs(
        n, plan.NC, cap, plan.on("grid", dev), plan.on("bg", dev), plan.atlas(dev),
        plan.grid_opaque, seed=23, dcap=dcap, bg_mode=mode, edges=True).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["maze", "plunder", "dodgeball", "bossfight", "miner",
                                  "coinrun", "fruitbot", "starpilot", "climber", "caveflyer"])
def test_cuda_kernels_match_plain_version_on_edge_slots(case):
    """Both kernels on the edge cases at full caps (masks of several words),
    byte-equal to their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _edge_inputs(case, 256, torch.device("cuda"))
    if case in ("maze", "plunder", "dodgeball", "bossfight"):
        base, ent_f, ent_i, atlas, decor = x
        got = rk.render_suffix(base, ent_f, ent_i, atlas, 2, decor)
        want = rk.render_suffix_reference(base, ent_f, ent_i, atlas, 2, decor)
    else:
        got = rk.render_frame(x)
        want = rk.render_frame_reference(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_suffix_kernel_at_bossfights_caps():
    """The decor instance at the largest pools (72 + 160, 69,104 B of
    dynamic shared memory a block) on bossfight easy and hard states with
    volleys and laser trails, byte-equal to its plain version; the
    instance reports that shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    assert rk.suffix_occupancy(72, 160)["smem_bytes"] == 69104
    seeds = torch.arange(64, dtype=torch.int64, device=dev) * 7919 + 11
    for mode in (0, 1):
        game = Bossfight(GameOptions(distribution_mode=mode))
        game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
        acts = np.random.RandomState(mode).choice([9, 10, 1, 7, 4], (40, 64))
        for a in acts:
            s, _ = lifecycle.env_step(game, s, torch.as_tensor(a, device=dev))
        assert int(s.decor.count.max()) >= 8
        plan = rk.get_plan(game)
        ent_f, ent_i, decor = rk.prep_suffix(plan, s)
        assert ent_f.shape[1] == 72 and decor.dec_f.shape[1] == 160
        base, atlas = s.frame.contiguous(), plan.atlas(dev)
        got = rk.render_suffix(base, ent_f, ent_i, atlas, 2, decor)
        want = rk.render_suffix_reference(base, ent_f, ent_i, atlas, 2, decor)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _orb_inputs(mode, n, dev="cpu"):
    """``synthetic_orb_inputs`` in chaser's window of ``mode`` (11, 13 or 19
    cells) with its atlases."""
    plan = rk.get_plan(Chaser(GameOptions(distribution_mode=mode)))
    return rk.synthetic_orb_inputs(n, plan.NC, plan.on("grid", dev), plan.on("bg", dev),
                                   plan.atlas(dev), plan.grid_opaque, seed=31 + mode).to(dev)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_orb_edge_pixels_on_both_sides(mode):
    """The orb-edge inputs put pixels within 8 ulps of the 0.3 inset's
    edges, on both sides of them; the plain version draws a cell's color at
    exactly the pixels whose ``|u - 0.5|`` and ``|v - 0.5|`` are below
    half the inset, unless a slot paints over them."""
    x = _orb_inputs(mode, 128)
    edge = rk.orb_edge_pixels(x)
    wxs, wys, inside, crow, ccol, _, _ = rk.grid_lookup(x)
    nidx = torch.arange(128)[:, None, None]
    cell = x.cell5.permute(0, 2, 3, 1)[nidx, crow, ccol]
    half = cell[..., 4] / 2
    u = (wxs - torch.floor(wxs))[:, None, :]
    v = (wys - torch.floor(wys))[:, :, None]
    drawn = inside & (torch.abs(u - 0.5) < half) & (torch.abs(v - 0.5) < half)
    assert int((edge & drawn).sum()) > 100 and int((edge & ~drawn).sum()) > 100
    out = rk.render_frame_reference(x)
    x_bare = dataclasses.replace(x, si=x.si.clone())
    x_bare.si[:, rk.SI_ENT_COUNT] = 0
    bare = rk.render_frame_reference(x_bare)
    shows = (bare.int() == cell[..., :3].int()).all(dim=-1)
    assert bool(shows[drawn].all())
    under = rk.render_frame_reference(dataclasses.replace(
        x_bare, cell5=torch.cat([x.cell5[:, :3], torch.zeros_like(x.cell5[:, 3:])], 1)))
    assert torch.equal(bare[~drawn], under[~drawn])
    assert out.shape == bare.shape


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_cuda_frame_kernel_orb_inset_edges(mode):
    """``render_frame`` on pixels a few ulps from the edges of chaser's orb
    cells (inset 0.3) in its 11-, 13- and 19-cell windows, byte-equal to
    its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _orb_inputs(mode, 512, torch.device("cuda"))
    assert bool(rk.orb_edge_pixels(x).any())
    got = rk.render_frame(x)
    want = rk.render_frame_reference(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _heist_ring_states(n, dev="cpu"):
    """``n`` heist memory-mode states (the centred 11-cell window) with
    every key held, so that each env's key ring (up to 3 keys in screen
    coordinates at render_z 1) shows, env i's agent in facing i mod 8."""
    from procgen_tpu_torch.core.constants import MEMORY_MODE
    from procgen_tpu_torch.games.heist import Heist, with_ring_and_facings

    game = Heist(GameOptions(distribution_mode=MEMORY_MODE))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    seeds = torch.arange(n, dtype=torch.int64, device=dev) * 104729 + 3
    s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
    return game, with_ring_and_facings(s)


def test_screen_slots_hold_still_over_a_centred_window():
    """Heist's key ring in memory mode's centred window, on the plain
    version: the ring's slots take screen coordinates (64 px a unit) at
    render_z 1, the same whatever the camera; moving the agent (and the
    window) moves every world slot and no ring slot; the ring changes the
    frame in its rectangles only."""
    from procgen_tpu_torch.games.heist import KEY_ON_RING

    game, s = _heist_ring_states(16)
    plan = rk.get_plan(game)
    assert game.center_agent and plan.NC == 11 and rk.supports(game)
    x = rk.prep_frame(plan, s)
    ring = s.ents.active & (s.ents.type == KEY_ON_RING)
    assert int(ring.sum()) >= 8
    assert bool((x.ent_i[..., rk.EI_Z][ring] == plan.z_slots[2]).all())
    assert bool((x.ent_i[..., rk.EI_LIVE][ring] == 1).all())
    e = s.ents
    np.testing.assert_array_equal(x.ent_f[..., rk.EF_X0][ring], (64 * (e.x - e.rx))[ring])
    moved = s.replace(ents=s.ents.set_fields(0, x=s.ents.x[:, 0] + 1.5,
                                             y=s.ents.y[:, 0] - 2.25))
    xm = rk.prep_frame(plan, moved)
    world = s.ents.active & ~ring & (torch.arange(s.ents.cap) > 0)
    assert torch.equal(xm.ent_f[ring], x.ent_f[ring])
    assert bool((xm.ent_f[..., rk.EF_X0][world] != x.ent_f[..., rk.EF_X0][world]).all())
    frame = rk.render_frame_reference(x)
    bare_i = x.ent_i.clone()
    bare_i[..., rk.EI_LIVE] = torch.where(ring, 0, bare_i[..., rk.EI_LIVE])
    bare = rk.render_frame_reference(dataclasses.replace(x, ent_i=bare_i))
    diff = (frame != bare).any(-1)
    covered = (_covers(x.ent_f, rk.EF_X0, rk.EF_W2)[..., None, :]
               & _covers(x.ent_f, rk.EF_Y0, rk.EF_H2)[..., :, None]
               & ring[..., None, None]).any(1)
    assert bool(diff.any()) and not bool((diff & ~covered).any())


@pytest.mark.cuda
def test_cuda_frame_kernel_screen_slots_over_a_centred_window():
    """``render_frame`` on heist memory states with the key ring showing
    (screen-coordinate slots at render_z 1 over the centred 11-cell
    window) and the agent in its 8 facings (rotation banks), byte-equal
    to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    game, s = _heist_ring_states(256, torch.device("cuda"))
    x = rk.prep_frame(rk.get_plan(game), s)
    got = rk.render_frame(x)
    want = rk.render_frame_reference(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _caveflyer(mode, centred):
    from procgen_tpu_torch.games.caveflyer import Caveflyer

    game = Caveflyer(GameOptions(distribution_mode=mode, center_agent=centred))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _caveflyer_states(mode, n, dev="cpu", steps=12):
    """``n`` caveflyer states of ``mode`` after ``steps`` steps, shots a
    third of the time; and the same states with every slot of both pools
    turned (``render_kernel.turned_states``)."""
    game = _caveflyer(mode, False)
    seeds = torch.arange(n, dtype=torch.int64, device=dev) * 7919 + 5
    s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
    rs = np.random.RandomState(mode)
    for _ in range(steps):
        a = np.where(rs.rand(n) < 0.33, 9, rs.randint(0, 9, n))
        s, _ = lifecycle.env_step(game, s, torch.as_tensor(a, device=dev))
    return s, rk.turned_states(s, mode)


def test_caveflyer_blocks_fit():
    """Caveflyer's six windows fit a block's shared memory: the whole
    world of memory mode (60 cells, 151 entity and 32 decor slots) is the
    largest frame block, 74,592 B, past coinrun's whole world (67,104 B);
    memory's centred window (19 cells, the same pools) 61,648 B; the
    easy and hard windows under the default 48 KB."""
    sizes = {}
    for mode, dim in ((0, 30), (1, 40), (10, 60)):
        for centred in (False, True):
            game = _caveflyer(mode, centred)
            plan = rk.get_plan(game)
            assert plan.NC == ((13 if mode == 0 else 19) if centred else dim)
            sizes[(mode, centred)] = rk.frame_smem(plan.NC, game.ENT_CAP, game.DECOR_CAP)
    assert max(sizes.values()) == sizes[(10, False)] == 74592 <= rk.SMEM_MAX
    assert sizes[(10, False)] > rk.frame_smem(64, 48, 96) == 67104
    assert sizes[(10, True)] == 61648
    assert max(v for (mode, _), v in sizes.items() if mode != 10) < 48 * 1024


def test_monochrome_plans_have_no_atlases():
    """Under ``use_monochrome_assets`` the plans keep the Pallas plan's
    placeholders: a 2x2 entity atlas of one transparent row and its
    transpose, a 2x2 grid row that covers nothing; every slot's prep is on
    the fallback-colour branch, off the banks, and the frame's cells are
    the colored-cell planes alone."""
    for name, mode in (("coinrun", 0), ("chaser", 0), ("maze", 0), ("caveflyer", 10)):
        from procgen_tpu_torch.games.registry import make_game

        game = make_game(name, GameOptions(distribution_mode=mode, use_monochrome_assets=True))
        game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        assert rk.supports(game)
        plan = rk.get_plan(game)
        assert plan.ent_atlas is None and (plan.S, plan.n1e) == (2, 1)
        assert plan.atlas("cpu").shape == (2, 2, 2, 4) and int(plan.atlas("cpu").sum()) == 0
        if not plan.static:
            assert (plan.sA, plan.grid_opaque) == (2, 0)
            assert tuple(plan.on("grid", "cpu").shape) == (1, 2, 2, 4)
        seeds = torch.arange(4, dtype=torch.int64) + 11
        s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
        ent_f, ent_i = rk.prep(plan, s)
        assert bool((ent_i[..., rk.EI_FB] == 1).all())
        assert bool((ent_i[..., rk.EI_ROW] <= 1).all())
        if not plan.static:
            x = rk.prep_frame(plan, s)
            assert int(x.gtab.abs().sum()) == 0 and float(x.cell5[:, 3].sum()) > 0
            out = rk.render_frame_reference(x)
            assert out.shape == (4, 64, 64, 3)


def test_turned_states_reach_the_banks():
    """``turned_states`` puts caveflyer's ship, bullets and exhaust on the
    rotation banks and leaves some slots on quarter turns (transposed or
    flipped variants), in both pools; the plain frame renders them."""
    plan = rk.get_plan(_caveflyer(0, False))
    _, s = _caveflyer_states(0, 16)
    x = rk.prep_frame(plan, s)
    first = plan.ent_atlas.transparent_row + 1
    for xi in (x.ent_i, x.dec_i):
        live = xi[..., rk.EI_LIVE] > 0
        row = xi[..., rk.EI_ROW]
        assert bool((live & (row >= first) & (row < plan.n1e)).any())
        assert bool((live & ((row < first) | (row >= plan.n1e))).any())
    assert bool((x.ent_i[..., rk.EI_ROW] >= plan.n1e).any())  # transposed
    assert rk.render_frame_reference(x).shape == (16, 64, 64, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, 10])
@pytest.mark.parametrize("centred", [False, True])
def test_cuda_frame_kernel_caveflyer_windows(mode, centred):
    """``render_frame`` in caveflyer's six windows (30, 40, 60 cells; 13,
    19, 19 centred) on states with bullets, exhaust and explosions, and
    on the same states with every slot turned to angles up to 10^4 rad
    (the rotation banks), byte-equal to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    plan = rk.get_plan(_caveflyer(mode, centred))
    for s in _caveflyer_states(mode, 256, dev):
        x = rk.prep_frame(plan, s)
        got = rk.render_frame(x)
        want = rk.render_frame_reference(x)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["coinrun", "chaser", "maze"])
def test_cuda_kernels_fallback_colour_slots(name):
    """Monochrome states: every slot on the kernels' fallback-colour
    branch, the grid without a tile atlas (``render_frame`` for coinrun,
    under both cameras, and chaser; ``render_suffix`` for maze over its
    coloured prefix), byte-equal to the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from procgen_tpu_torch.games.registry import make_game

    dev = torch.device("cuda")
    seeds = torch.arange(256, dtype=torch.int64, device=dev) * 104729 + 7
    for centred in ((False, True) if name == "coinrun" else (False,)):
        game = make_game(name, GameOptions(distribution_mode=0, center_agent=centred,
                                           use_monochrome_assets=True))
        game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
        for a in np.random.RandomState(3).randint(0, 15, (12, 256)):
            s, _ = lifecycle.env_step(game, s, torch.as_tensor(a, device=dev))
        plan = rk.get_plan(game)
        if plan.static:
            ent_f, ent_i, decor = rk.prep_suffix(plan, s)
            args = (s.frame.contiguous(), ent_f, ent_i, plan.atlas(dev),
                    len(plan.z_levels), decor)
            got, want = rk.render_suffix(*args), rk.render_suffix_reference(*args)
        else:
            x = rk.prep_frame(plan, s)
            ent_i = x.ent_i
            got, want = rk.render_frame(x), rk.render_frame_reference(x)
        torch.cuda.synchronize()
        assert bool((ent_i[..., rk.EI_FB] == 1).all())
        assert torch.equal(got, want)
