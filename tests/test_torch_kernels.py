"""The port's CUDA frame kernel against its plain torch version.

Imports no JAX, so the file also runs on the GPU machine, where the
``cuda``-marked test launches the kernel:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest.py imports jax.)  On the CPU the
``cuda`` test skips and the rest check the wrapper's contract.
"""

import numpy as np
import pytest
import torch

from procgen_tpu_torch.core.options import GameOptions
from procgen_tpu_torch.games.maze import Maze
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
    before = rk.LAUNCHES
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
        before = rk.LAUNCHES
        got = rk.render_suffix(base, ent_f, ent_i, atlas, nz)
        want = rk.render_suffix_reference(base, ent_f, ent_i, atlas, nz)
        torch.cuda.synchronize()
        assert rk.LAUNCHES == before + 1
        assert torch.equal(got, want)
