"""The port's main path against the JAX package's, end to end.

* ``procgen_tpu_torch.entry.make_env_fns(4)`` against
  ``__graft_entry__._make_env_fns(4)``: every ``BasicState`` leaf, the
  next-level pool and its validity, obs, reward and done, bit-equal, for 64
  random steps with two episode ends (a forced reset, action -1, and a
  goal reached).
* The C++ engine's maze recordings replayed exactly through the port's
  ``ProcgenGym3Env`` (rewards, firsts, level seeds, prev-level info,
  latents).
* ``TorchVecGame.rollout`` against a loop of ``act``.
* ``import procgen_tpu_torch`` (and chip_smoke.py) with jax blocked.
* The entry points default to the card and raise without one.

Tolerance: zero.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from __graft_entry__ import _make_env_fns
from procgen_tpu_torch import ProcgenGym3Env
from procgen_tpu_torch.bridge import state_to_numpy
from procgen_tpu_torch.conformance import replay
from procgen_tpu_torch.entry import make_env_fns
from procgen_tpu_torch.parallel.vec import TorchVecGame

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


def _assert_tree_equal(jstate, tstate, tag):
    a = _flat(jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(jstate)))
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
    ji, js, jseeds = _make_env_fns(N)
    jinit, jstep = jax.jit(ji), jax.jit(js)
    ti, ts, tseeds = make_env_fns(N, device="cpu")
    np.testing.assert_array_equal(np.asarray(jseeds), tseeds.numpy())
    jc, tc = jinit(jseeds), ti(tseeds)
    out = [(jc, None, tc, None)]
    rng = np.random.RandomState(1)  # env 2 reaches its goal at step 28
    for t in range(STEPS):
        a = rng.randint(0, 15, size=N).astype(np.int32)
        if t == 20:
            a[1] = -1  # forced reset
        jc, jo, jr, jd = jstep(jc, jnp.asarray(a))
        tc, to, tr, td = ts(tc, torch.as_tensor(a))
        out.append((jc, (jo, jr, jd), tc, (to, tr, td)))
    return out


def test_init_matches(trajectories):
    jc, _, tc, _ = trajectories[0]
    _assert_tree_equal(jc[0], tc.states, "init states")
    _assert_tree_equal(jc[1], tc.pool, "init pool")
    np.testing.assert_array_equal(np.asarray(jc[2]), tc.valid.numpy())


def test_steps_match(trajectories):
    ends = rewards = 0
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
    assert ends >= 2 and rewards >= 1


@pytest.mark.parametrize("name", ["maze_easy", "maze_hard", "maze_exploration"])
def test_conformance_replay(name):
    with open(os.path.join(HERE, "data", "conformance", f"{name}.json")) as f:
        rec = json.load(f)
    res = replay(rec, device="cpu")
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == res["steps"] == len(rec["actions"])


def test_rollout_matches_act_loop():
    """``TorchVecGame.rollout`` stacks what the same actions give one
    ``act`` at a time, and rejects actions of the wrong shape."""
    vecs = [ProcgenGym3Env(num=N, env_name="maze", distribution_mode="easy",
                           rand_seed=0, device="cpu")._vec for _ in range(2)]
    acts = np.random.RandomState(6).randint(0, 15, size=(8, N)).astype(np.int32)
    obs, rew, first = vecs[0].rollout(acts)
    assert obs.shape == (8, N, 64, 64, 3) and obs.dtype == torch.uint8
    for t, a in enumerate(acts):
        vecs[1].act(a)
        o, r, f, _ = vecs[1].observe()
        assert torch.equal(obs[t], o) and torch.equal(rew[t], r)
        assert torch.equal(first[t], f)
    with pytest.raises(ValueError):
        vecs[1].act(acts[0, :2])
    with pytest.raises(ValueError):
        vecs[1].rollout(acts[:, :2])


def test_import_without_jax():
    """The port, its miner module and chip_smoke.py import with jax, flax
    and the JAX package blocked."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['flax'] = None; "
        "sys.modules['procgen_tpu'] = None\n"
        "import pkgutil, importlib, procgen_tpu_torch\n"
        "import procgen_tpu_torch.games.miner, chip_smoke\n"
        "for m in pkgutil.walk_packages(procgen_tpu_torch.__path__, "
        "'procgen_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'procgen_tpu') "
        "and sys.modules[k] is not None for k in sys.modules)\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=os.path.dirname(HERE), timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


@pytest.mark.parametrize("entry", ["ProcgenGym3Env", "TorchVecGame", "replay",
                                   "make_env_fns"])
def test_default_device_is_the_card(entry):
    """With no ``device``, every entry point asks for the card; on a
    machine without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from procgen_tpu_torch.core.options import GameOptions
    from procgen_tpu_torch.games.maze import Maze

    with open(os.path.join(HERE, "data", "conformance", "maze_easy.json")) as f:
        rec = json.load(f)
    call = {
        "ProcgenGym3Env": lambda: ProcgenGym3Env(num=2, env_name="maze"),
        "TorchVecGame": lambda: TorchVecGame(
            2, Maze(GameOptions(distribution_mode=0)), rand_seed=0),
        "replay": lambda: replay(rec),
        "make_env_fns": lambda: make_env_fns(2, "maze"),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
