"""State blobs and the C++ state import and export of the port against the
JAX package.

For each of the 16 ``tests/data/refstate/<game>_bridge.json`` (the C++
engine's serialized states of 2 envs partway through a recorded run), a
JAX child process (this file run as a script; it parses and renders, and
traces no step) imports the bytes with
``procgen_tpu.utils.refstate.import_reference_state``, packs the batch with
``procgen_tpu.utils.serialization.states_to_bytes`` and exports each env
with ``export_reference_state``.  Then, on the CPU:

* the port's ``utils.refstate.import_reference_state`` equals the JAX
  import on every leaf, dtype included, the static ``frame`` (the port's
  own prefix render) among them;
* the port's ``export_reference_state`` bytes equal the JAX package's;
* the port's blobs of its import equal the JAX blobs byte for byte;
* the JAX blobs load into a port env (``set_state_blobs``) and give the
  same leaves.

A round trip with a cross-seed restore, as ``tests/test_state.py``'s
``_torture``: maze, coinrun and starpilot on the port alone, 2 envs, 64
steps, a state saved every 8; saving and restoring an env's own state
changes nothing, and a restore into a differently seeded env replays the
tail bit-equal (rewards, firsts, 64x64 frames).  Malformed blobs raise.

Tolerance: zero.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from procgen_tpu_torch import ProcgenGym3Env  # noqa: E402
from procgen_tpu_torch.bridge import state_to_numpy  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.games.registry import make_game  # noqa: E402
from procgen_tpu_torch.parallel.vec import TorchVecGame  # noqa: E402
from procgen_tpu_torch.utils import refstate, serialization  # noqa: E402

GAMES = ["maze", "miner", "coinrun", "fruitbot", "starpilot", "plunder",
         "leaper", "bigfish", "dodgeball", "bossfight", "climber", "ninja",
         "chaser", "heist", "jumper", "caveflyer"]
MODES = {"easy": 0, "hard": 1, "extreme": 2, "memory": 10}
SEP = "::"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's operations are small, and the other test workers and the
    JAX children hold the other cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _record(game):
    with open(os.path.join(HERE, "data", "refstate", f"{game}_bridge.json")) as f:
        return json.load(f)


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        elif v is not None:
            out[pre + k] = np.asarray(v)
    return out


def _bytes_array(b: bytes) -> np.ndarray:
    return np.frombuffer(b, np.uint8)


# ---------------------------------------------------------------------------
# the JAX reference (child process)
# ---------------------------------------------------------------------------


def _jax_reference(out_path):
    import jax
    import jax.numpy as jnp
    from flax import serialization as fser

    from procgen_tpu.core import lifecycle
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game as jmake_game
    from procgen_tpu.utils import serialization as jser
    from procgen_tpu.utils.refstate import export_reference_state, import_reference_state

    jax.config.update("jax_platforms", "cpu")
    out = {}
    for game in GAMES:
        rec = _record(game)
        jg = jmake_game(game, JGameOptions(distribution_mode=MODES[rec["distribution_mode"]]))
        template = lifecycle.initial_state(jg, jnp.uint32(0))
        states = [import_reference_state(jg, template, bytes.fromhex(h))
                  for h in rec["bridge_states"]]
        batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
        for k, v in _flat(fser.to_state_dict(batched)).items():
            out[SEP.join((game, "leaf", k))] = v
        for e, b in enumerate(jser.states_to_bytes(batched, len(states))):
            out[SEP.join((game, "blob", str(e)))] = _bytes_array(b)
        for e, s in enumerate(states):
            out[SEP.join((game, "export", str(e)))] = _bytes_array(
                export_reference_state(jg, s, env_idx=e))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import jax

    out_dir = tmp_path_factory.mktemp("state")
    path, log = out_dir / "ref.npz", out_dir / "ref.log"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=jax.config.jax_compilation_cache_dir or "",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="1")
    with open(log, "w") as err:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(path)],
                                env=env, stdout=subprocess.DEVNULL, stderr=err)
    try:
        assert proc.wait(timeout=1800) == 0, log.read_text()[-4000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _part(ref, game, kind):
    pre = SEP.join((game, kind)) + SEP
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


def _blobs(ref, game, kind):
    part = _part(ref, game, kind)
    return [part[str(e)].tobytes() for e in range(len(part))]


def _game(name, rec):
    return make_game(name, GameOptions(distribution_mode=MODES[rec["distribution_mode"]]))


def _assert_leaves(got_state, want, what):
    got = _flat(state_to_numpy(got_state))
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype, (what, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("game", GAMES)
def test_refstate_and_blobs_equal_jax(game, ref):
    rec = _record(game)
    cpp = [bytes.fromhex(h) for h in rec["bridge_states"]]
    leaves = _part(ref, game, "leaf")
    jax_blobs = _blobs(ref, game, "blob")

    tg = _game(game, rec)
    s = refstate.import_reference_state(tg, cpp, device="cpu")
    _assert_leaves(s, leaves, f"{game} import")
    assert refstate.export_reference_state(tg, s) == _blobs(ref, game, "export")
    assert serialization.states_to_bytes(s) == jax_blobs

    vec = TorchVecGame(num=len(cpp), game=_game(game, rec), rand_seed=7, device="cpu")
    vec.set_state_blobs(jax_blobs)
    _assert_leaves(vec.states, leaves, f"{game} set_state_blobs")
    assert vec.get_state_blobs() == jax_blobs


def _signature(env):
    rew, obs, first = env.observe()
    return rew.tobytes(), first.tobytes(), obs["rgb"].tobytes()


@pytest.mark.parametrize("env_name", ["maze", "coinrun", "starpilot"])
def test_cross_seed_restore(env_name):
    """tests/test_state.py's ``_torture`` on the port: 64 steps, a state
    saved every 8."""
    steps, save_every, n = 64, 8, 2
    actions = np.random.RandomState(3).randint(0, 15, (steps, n)).astype(np.int32)

    def make(seed):
        return ProcgenGym3Env(num=n, env_name=env_name, rand_seed=seed,
                              distribution_mode="easy", device="cpu")

    env = make(0)
    sigs, saved = [], []
    for t in range(steps):
        env.act(actions[t])
        sigs.append(_signature(env))
        if t % save_every == 0:
            saved.append(env.callmethod("get_state"))

    # saving and restoring the env's own state every 8 steps changes nothing
    env2 = make(0)
    for t in range(steps):
        env2.act(actions[t])
        assert sigs[t] == _signature(env2), f"{env_name} diverged at {t}"
        if t % save_every == 0:
            st = env2.callmethod("get_state")
            assert st == saved[t // save_every], f"{env_name}: states differ at {t}"
            env2.callmethod("set_state", st)

    # a restore into a differently seeded env replays the tail exactly
    k = (3 * steps) // 4 // save_every
    env3 = make(999)
    env3.act(np.full((n,), 4, np.int32))
    assert sigs[0] != _signature(env3)
    env3.set_state(saved[k])
    for t in range(k * save_every + 1, steps):
        env3.act(actions[t])
        assert sigs[t] == _signature(env3), f"{env_name}: cross-seed restore diverged at {t}"


def test_malformed_blobs_raise():
    vec = TorchVecGame(num=2, game=make_game("maze", GameOptions(distribution_mode=0)),
                       rand_seed=1, device="cpu")
    good = vec.get_state_blobs()
    assert len(good) == 2 and good[0][:8] == serialization.MAGIC
    assert good[0][-4:] == (0xCAFECAFE).to_bytes(4, "little")
    bad_magic = b"PGTPU002" + good[0][8:]
    truncated = good[0][:-4] + b"\0\0\0\0"
    wrong_len = bytearray(good[0])
    wrong_len[8:12] = (int.from_bytes(good[0][8:12], "little") + 1).to_bytes(4, "little")
    for blobs in ([good[0], bad_magic], [truncated, good[1]], [bytes(wrong_len), good[1]],
                  [good[0], good[1][:-1]], [good[0]], [good[0], good[1] + b"\0"]):
        with pytest.raises(ValueError):
            vec.set_state_blobs(blobs)
    vec.set_state_blobs(good)  # the env is whole after the refusals
    assert vec.get_state_blobs() == good
    with pytest.raises(ValueError):
        refstate.import_reference_state(make_game("maze", GameOptions()), [b"\0" * 8],
                                        device="cpu")


if __name__ == "__main__":
    torch.set_num_threads(1)
    _jax_reference(sys.argv[1])
