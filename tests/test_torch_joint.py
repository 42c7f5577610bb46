"""Joint-game mode of the port (a comma-separated ``env_name``; env n runs
game n % k), on the CPU.

* Both joint oracle recordings of the C++ engine
  (``tests/data/conformance/joint_*.json``) replay exactly through
  ``conformance.replay``: rewards, firsts, level seeds and the previous
  level's seed and completion at every step.
* ``parallel.vec._pad_union_infos`` equals the JAX package's on fixed
  info dicts: maze's and miner's latents (different grid widths) beside a
  game without them.
* ``tests/test_env.py``'s ``test_joint_games`` and
  ``test_joint_info_union_keys`` hold on the port: the master seed stream
  in global env order, the union of info keys with zeros where a game
  lacks one, state blobs split and joined round-robin.
* ``num % k != 0`` raises.

Tolerance: zero.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from procgen_tpu_torch import ProcgenGym3Env  # noqa: E402
from procgen_tpu_torch.conformance import replay  # noqa: E402
from procgen_tpu_torch.parallel import vec as tvec  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's operations are small, and the other test workers and the
    JAX children hold the other cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["joint_maze+miner_easy",
                                  "joint_bossfight+chaser+dodgeball_easy"])
def test_joint_replay(name):
    with open(os.path.join(HERE, "data", "conformance", f"{name}.json")) as f:
        rec = json.load(f)
    res = replay(rec, device="cpu")
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == len(rec["actions"]) == 64


def _infos(rng):
    """Per-game info dicts of 3 envs each: maze-like latents (13x13 grid),
    miner-like ones (a 20x20 grid and an exit), a game with none."""
    def base():
        return {"level_seed": rng.randint(0, 2**31 - 1, 3).astype(np.int32),
                "prev_level_complete": rng.randint(0, 2, 3).astype(np.uint8)}
    maze = dict(base(), grid=rng.randint(0, 60, (3, 169)).astype(np.int32),
                grid_size=rng.randint(1, 13, (3, 2)).astype(np.int32),
                agent_pos=rng.randint(0, 13, (3, 2)).astype(np.int32))
    miner = dict(base(), grid=rng.randint(0, 60, (3, 400)).astype(np.int32),
                 grid_size=rng.randint(1, 20, (3, 2)).astype(np.int32),
                 agent_pos=rng.randint(0, 20, (3, 2)).astype(np.int32),
                 exit_pos=rng.randint(0, 20, (3, 2)).astype(np.int32))
    return [maze, base(), miner]


def test_pad_union_infos_equals_jax():
    import jax.numpy as jnp

    from procgen_tpu.parallel.vec import _pad_union_infos as jpad

    infos = _infos(np.random.RandomState(0))

    def jil(parts):
        st = jnp.stack(parts, axis=1)
        return st.reshape((-1,) + st.shape[2:])

    want = jpad([{k: jnp.asarray(v) for k, v in inf.items()} for inf in infos], jil)
    got = tvec._pad_union_infos([{k: torch.as_tensor(v) for k, v in inf.items()}
                                 for inf in infos])
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert got["exit_pos"].shape == (9, 2) and got["grid"].shape == (9, 400)


def _env(name, num=4, **kw):
    return ProcgenGym3Env(num=num, env_name=name, rand_seed=3, distribution_mode="easy",
                          use_monochrome_assets=True, device="cpu", **kw)


def test_joint_games():
    """Round-robin games over the single-game master seed stream
    (vecgame.cpp:343-363); blobs round-trip."""
    env = _env("maze,miner")
    rew, obs, first = env.observe()
    assert obs["rgb"].shape == (4, 64, 64, 3)
    env.act(np.array([4, 7, 2, 5], np.int32))
    info = env.get_info()

    single = _env("maze")
    si = single.get_info()
    # joint envs 0, 2 are maze and see master draws 0, 2
    assert info[0]["level_seed"] == si[0]["level_seed"]
    assert info[2]["level_seed"] == si[2]["level_seed"]

    # the joint frames are the sub-games' frames, interleaved
    sub_obs = env._vec.subs[0].observe()[0]
    np.testing.assert_array_equal(env.observe()[1]["rgb"][0::2], sub_obs.numpy())

    # state blobs round-trip through the per-game codecs, split [gi::k]
    st = env.callmethod("get_state")
    assert st[0] == env._vec.subs[0].get_state_blobs()[0]
    assert st[1] == env._vec.subs[1].get_state_blobs()[0]
    _, obs1, _ = env.observe()
    env.callmethod("set_state", st)
    _, obs2, _ = env.observe()
    np.testing.assert_array_equal(obs1["rgb"], obs2["rgb"])
    acts = np.array([1, 3, 6, 8], np.int32)
    env.act(acts)
    twin = _env("maze,miner")
    twin.act(np.array([4, 7, 2, 5], np.int32))
    twin.act(acts)
    np.testing.assert_array_equal(env.observe()[1]["rgb"], twin.observe()[1]["rgb"])
    assert env.get_state() == twin.get_state()


def test_joint_info_union_keys():
    """The union of per-game info keys with fixed padded shapes (the
    reference's one joint tensortype set, vecgame.cpp:270-330)."""
    env = _env("maze,bigfish")
    env.act(np.zeros(4, np.int32))
    info = env.get_info()
    for i in info:
        assert "grid" in i and "agent_pos" in i and "grid_size" in i
    # maze envs (0, 2) have real latents; bigfish envs (1, 3) read zeros
    assert tuple(info[0]["grid_size"]) != (0, 0)
    assert tuple(info[1]["grid_size"]) == (0, 0)
    single = _env("maze")
    single.act(np.zeros(4, np.int32))
    si = single.get_info()
    np.testing.assert_array_equal(info[0]["grid"], si[0]["grid"])
    np.testing.assert_array_equal(info[0]["agent_pos"], si[0]["agent_pos"])


def test_joint_needs_whole_groups():
    with pytest.raises(ValueError):
        _env("maze,miner", num=3)
    with pytest.raises(ValueError):
        _env("maze,miner,bigfish", num=4)
