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
from procgen_tpu_torch.games.maze import Maze
from procgen_tpu_torch.games.miner import Miner
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
