"""The port's miner against the JAX package's and the C++ recordings.

* ``procgen_tpu_torch.entry.make_env_fns(4, "miner")`` against
  ``__graft_entry__._make_env_fns(4, "miner")``: every ``BasicState`` leaf
  (``MinerState`` included), the next-level pool and its validity, obs,
  reward and done, bit-equal, for 64 random steps with episode ends.
* The C++ engine's miner_easy and miner_hard recordings (latents
  included) replayed exactly through the port's ``ProcgenGym3Env``.
* ``set_latent_state`` against the JAX package's on the same states, and
  through ``ProcgenGym3Env.callmethod``.
* The state bridge carries ``MinerState`` both ways without loss.

Tolerance: zero.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from __graft_entry__ import _make_env_fns
from procgen_tpu.core.options import GameOptions as JGameOptions
from procgen_tpu.games.miner import Miner as JMiner
from procgen_tpu_torch import ProcgenGym3Env
from procgen_tpu_torch.bridge import state_from_numpy, state_to_numpy
from procgen_tpu_torch.conformance import replay
from procgen_tpu_torch.core.options import GameOptions
from procgen_tpu_torch.entry import make_env_fns
from procgen_tpu_torch.games.miner import DEAD_PLAYER, Miner, MinerState

HERE = os.path.dirname(os.path.abspath(__file__))
N = 4
STEPS = 64


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        else:
            out[pre + k] = v
    return out


def _jax_tree(jstate):
    return jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(jstate))


def _assert_tree_equal(jstate, tstate, tag):
    a = _flat(_jax_tree(jstate))
    b = _flat(state_to_numpy(tstate))
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None:
            assert b[k] is None, (tag, k)
            continue
        assert a[k].dtype == b[k].dtype, (tag, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{tag}: {k}")


@pytest.fixture(scope="module")
def trajectories():
    """Both programs stepped with the same actions; per step the JAX
    carry and outputs and the port's."""
    ji, js, jseeds = _make_env_fns(N, "miner")
    jinit, jstep = jax.jit(ji), jax.jit(js)
    ti, ts, tseeds = make_env_fns(N, "miner", device="cpu")
    np.testing.assert_array_equal(np.asarray(jseeds), tseeds.numpy())
    jc, tc = jinit(jseeds), ti(tseeds)
    out = [(jc, None, tc, None)]
    rng = np.random.RandomState(1)
    for t in range(STEPS):
        a = rng.randint(0, 15, size=N).astype(np.int32)
        if t == 30:
            a[2] = -1  # forced reset
        jc, jo, jr, jd = jstep(jc, jnp.asarray(a))
        tc, to, tr, td = ts(tc, torch.as_tensor(a))
        out.append((jc, (jo, jr, jd), tc, (to, tr, td)))
    return out


def test_init_matches(trajectories):
    jc, _, tc, _ = trajectories[0]
    _assert_tree_equal(jc[0], tc.states, "init states")
    _assert_tree_equal(jc[1], tc.pool, "init pool")
    np.testing.assert_array_equal(np.asarray(jc[2]), tc.valid.numpy())
    assert isinstance(tc.states.game, MinerState)


def test_steps_match(trajectories):
    ends = rewards = deaths = 0
    for t, (jc, (jo, jr, jd), tc, (to, tr, td)) in enumerate(trajectories[1:]):
        _assert_tree_equal(jc[0], tc.states, f"step {t} states")
        _assert_tree_equal(jc[1], tc.pool, f"step {t} pool")
        np.testing.assert_array_equal(np.asarray(jc[2]), tc.valid.numpy())
        assert int(jc[3]) == tc.t
        np.testing.assert_array_equal(np.asarray(jo), to.numpy(), err_msg=f"obs {t}")
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
        ends += int(td.sum())
        rewards += int((tr > 0).sum())
        deaths += int(tc.states.game.died.sum())
    assert ends >= 2 and rewards >= 1 and deaths >= 1, (ends, rewards, deaths)


@pytest.mark.parametrize("name", ["miner_easy", "miner_hard"])
def test_conformance_replay(name):
    with open(os.path.join(HERE, "data", "conformance", f"{name}.json")) as f:
        rec = json.load(f)
    res = replay(rec, device="cpu")
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == res["steps"] == len(rec["actions"])


def _latents(tc, rng):
    """Per-env latent dicts: env 0 keeps its own, env 1 takes env 2's grid
    and positions, env 2 gets a moved agent and exit, env 3 a grid with a
    DEAD_PLAYER cell (the agent position is then left alone)."""
    info = {k: v.numpy() for k, v in
            Miner(GameOptions(distribution_mode=0)).latent_info(tc.states).items()}
    lat = [{k: info[k][e].copy() for k in ("grid", "agent_pos", "exit_pos")}
           for e in range(N)]
    lat[1] = {k: info[k][2].copy() for k in lat[1]}
    lat[2]["agent_pos"] = rng.randint(0, 10, 2).astype(np.int32)
    lat[2]["exit_pos"] = rng.randint(0, 10, 2).astype(np.int32)
    lat[3]["grid"][37] = DEAD_PLAYER
    lat[3]["agent_pos"] = np.array([1, 1], np.int32)
    return lat


def test_set_latent_state_matches_jax(trajectories):
    jc, _, tc, _ = trajectories[20]
    lat = _latents(tc, np.random.RandomState(4))
    jgame = JMiner(JGameOptions(distribution_mode=0))
    batched = {k: np.stack([d[k] for d in lat]) for k in lat[0]}
    want = jax.jit(jax.vmap(jgame.set_latent_state))(
        jc[0], {k: jnp.asarray(v) for k, v in batched.items()})
    got = Miner(GameOptions(distribution_mode=0)).set_latent_state(
        tc.states, {k: torch.as_tensor(v) for k, v in batched.items()})
    _assert_tree_equal(want, got, "set_latent_state")
    assert bool(got.game.died[3]) and not bool(got.game.died[:3].any())


def test_callmethod_set_latent_state():
    """callmethod("set_latent_state") rewrites the live states: the next
    info holds the new latents and the next frame shows them."""
    env = ProcgenGym3Env(num=N, env_name="miner", distribution_mode="easy",
                         rand_seed=5, device="cpu")
    _, obs0, _ = env.observe()
    vec = env._vec
    lat = _latents(vec.carry, np.random.RandomState(6))
    env.callmethod("set_latent_state", lat)
    info = env.get_info()
    for e in range(N):
        np.testing.assert_array_equal(info[e]["grid"], lat[e]["grid"])
        np.testing.assert_array_equal(info[e]["exit_pos"], lat[e]["exit_pos"])
    np.testing.assert_array_equal(info[2]["agent_pos"], lat[2]["agent_pos"])
    _, obs1, _ = env.observe()
    assert not np.array_equal(obs0["rgb"][1], obs1["rgb"][1])
    with pytest.raises(AttributeError):
        env.callmethod("no_such_method")


def test_bridge_round_trip(trajectories):
    """JAX state -> numpy -> the port's state -> numpy, MinerState
    included, leaf for leaf; and back into a JAX BasicState."""
    jc, _, _, _ = trajectories[10]
    tree = _jax_tree(jc[0])
    ts = state_from_numpy(tree, Miner(GameOptions(distribution_mode=0)), "cpu")
    assert isinstance(ts.game, MinerState)
    assert ts.game.died.dtype == torch.bool
    assert ts.game.diamonds_remaining.dtype == torch.int32
    back = state_to_numpy(ts)
    a, b = _flat(tree), _flat(back)
    assert a.keys() == b.keys() and "game.died" in a
    for k in a:
        if a[k] is None:
            assert b[k] is None, k
            continue
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    restored = serialization.from_state_dict(jc[0], back)
    for x, y in zip(jax.tree_util.tree_leaves(jc[0]),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
