"""The option recordings of the ported games replayed through the port.

The recordings in tests/data/conformance_opts/ come from the C++ engine
under non-default options (restricted themes, sequential levels, no
backgrounds with velocity info, generated assets, monochrome sprites) and as
adversarial stress runs (coinrun's crate push chains, plunder's bullet
volleys, dodgeball's ball volleys).  Each one of a ported game
replays exactly through ``procgen_tpu_torch.conformance.replay`` on the
CPU: rewards, firsts, level seeds, the previous level's seed and
completion, and maze's latents at every step.  The three 500-step, 8-env
stress runs are marked ``slow``, as in tests/test_conformance_options.py.
Every option recording of the conformance_opts folder replays here.
"""

import json
import os

import pytest
import torch

from procgen_tpu_torch.conformance import replay

HERE = os.path.dirname(os.path.abspath(__file__))
REC_DIR = os.path.join(HERE, "data", "conformance_opts")

FAST = ("chaser_mono", "coinrun_mono", "coinrun_restrict", "coinrun_seq",
        "dodgeball_genassets", "heist_restrict", "leaper_seq", "maze_genassets",
        "maze_nobg_vel", "maze_seq")
SLOW = ("coinrun_pushchain", "dodgeball_volley", "plunder_volley")


def _replay_exact(name):
    with open(os.path.join(REC_DIR, f"{name}.json")) as f:
        rec = json.load(f)
    # the port's ops here are small: one thread runs them fastest
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = replay(rec, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == res["steps"] == len(rec["actions"])


@pytest.mark.parametrize("name", FAST)
def test_option_recording_exact(name):
    _replay_exact(name)


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW)
def test_stress_recording_exact(name):
    _replay_exact(name)
