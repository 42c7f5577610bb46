"""``render_mode="rgb_array"``: the port's 512x512 ``info["rgb"]`` against
the JAX package's ``render_obs(game, s, 512)``, and ``rollout_full``.

For each case a 2-env ``ProcgenGym3Env`` of the port runs on the CPU with
``render_mode="rgb_array"`` for a few seeded steps; its ``info["rgb"]``
after the reset and after the last step is held against the JAX package's
XLA renderer at 512 (``jit(vmap(render_obs(game, s, 512)))``, as
``JaxVecGame._info_impl`` renders it) on the same states, carried across
by the state bridge, so that no JAX reset or step is compiled.  The cases:
maze textured and monochrome (in separate JAX child processes: the JAX
package's atlas cache key leaves out ``use_monochrome_assets``), coinrun
under the centred camera (its decor pool), fruitbot (the tiled
background), starpilot (the scrolled background), jumper (the compass
drawn in ``post``) and coinrun with generated assets (the painted canvas).
The JAX side runs in child processes (this file run as a script) under
``--xla_cpu_max_isa=AVX``, so that XLA fuses no multiply-add the port does
not.

``rollout_full`` over k steps equals k ``act`` + ``get_info`` calls on
maze, the 512 frame among the infos.

Tolerance: zero.
"""

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

N = 2
STEPS = 3
SEP = "::"
# case -> (env_name, options, master seed, JAX child)
CASES = {
    "maze": ("maze", {}, 41, 0),
    "coinrun": ("coinrun", {}, 42, 0),
    "coinrun_genassets": ("coinrun", {"use_generated_assets": True}, 43, 0),
    "fruitbot": ("fruitbot", {}, 44, 1),
    "starpilot": ("starpilot", {}, 45, 1),
    "jumper": ("jumper", {}, 46, 1),
    "maze_mono": ("maze", {"use_monochrome_assets": True}, 47, 2),
    "plunder": ("plunder", {}, 48, 2),
    "ninja": ("ninja", {}, 49, 2),
    "coinrun_velinfo": ("coinrun", {"paint_vel_info": True}, 50, 1),
}
CHILDREN = sorted({c for *_, c in CASES.values()})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's operations are small, and the other test workers and the
    JAX children hold the other cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        elif v is not None:
            out[pre + k] = np.asarray(v)
    return out


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        d = out
        *path, leaf = k.split(".")
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def _merge(template, tree):
    """``tree`` (a state dict without its None leaves) laid over the
    template's state dict, which holds them."""
    if isinstance(template, dict):
        return {k: _merge(v, tree.get(k, {})) for k, v in template.items()}
    return template if template is None else tree


def _env(case, **kw):
    name, opts, seed, _ = CASES[case]
    return ProcgenGym3Env(num=N, env_name=name, rand_seed=seed, distribution_mode="easy",
                          device="cpu", **opts, **kw)


# ---------------------------------------------------------------------------
# the JAX reference (child processes)
# ---------------------------------------------------------------------------


def _jax_reference(in_path, out_path):
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from procgen_tpu.core import lifecycle
    from procgen_tpu.core.constants import fnv1a_32
    from procgen_tpu.core.options import VecOptions, parse_game_options
    from procgen_tpu.games.registry import make_game
    from procgen_tpu.render import atlas
    from procgen_tpu.render.renderer import render_obs

    jax.config.update("jax_platforms", "cpu")
    with np.load(in_path, allow_pickle=True) as z:
        src = {k: z[k] for k in z.files}
    out = {}
    for case in sorted({k.split(SEP)[0] for k in src}):
        name = CASES[case][0]
        options = src[SEP.join((case, "options"))].item()
        atlas._CACHE.clear()
        game_options, game_type = parse_game_options(name, VecOptions(dict(options)))
        game = make_game(name, game_options)
        game.game_type = game_type
        game.fixed_asset_seed = int(np.int32(np.uint32(fnv1a_32(game.name))))
        template = jax.vmap(lambda sd: lifecycle.initial_state(game, sd))(
            jnp.zeros((N,), jnp.uint32))
        render = jax.jit(jax.vmap(lambda s: render_obs(game, s, 512)))
        for tag in ("reset", "last"):
            pre = SEP.join((case, tag)) + SEP
            tree = _unflat({k[len(pre):]: v for k, v in src.items() if k.startswith(pre)})
            tree = _merge(serialization.to_state_dict(template), tree)
            states = serialization.from_state_dict(template, tree)
            out[SEP.join((case, tag))] = np.asarray(render(states))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Per case: the port's 512 frames after the reset and after the last
    step, and the states the JAX children render (saved per child)."""
    out_dir = tmp_path_factory.mktemp("hires")
    frames = {}
    inputs = {c: {} for c in CHILDREN}
    for case, (_, _, seed, child) in CASES.items():
        env = _env(case, render_mode="rgb_array")
        acts = np.random.RandomState(seed).randint(0, 15, (STEPS, N)).astype(np.int32)
        for t in range(STEPS + 1):
            if t:
                env.act(acts[t - 1])
            if t in (0, STEPS):
                tag = "reset" if t == 0 else "last"
                frames[case, tag] = np.stack([i["rgb"] for i in env.get_info()])
                for k, v in _flat(state_to_numpy(env._vec.states)).items():
                    inputs[child][SEP.join((case, tag, k))] = v
        inputs[child][SEP.join((case, "options"))] = np.array(env.options, dtype=object)
    paths = {}
    for child, arrays in inputs.items():
        paths[child] = (out_dir / f"in{child}.npz", out_dir / f"ref{child}.npz",
                        out_dir / f"ref{child}.log")
        np.savez(paths[child][0], **arrays)
    return frames, paths


@pytest.fixture(scope="module")
def ref(port):
    """The JAX children's frames, the children run side by side."""
    import jax

    _, paths = port
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"{flags} --xla_cpu_max_isa=AVX".strip(),
        JAX_COMPILATION_CACHE_DIR=jax.config.jax_compilation_cache_dir or "",
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="1",
    )
    procs = []
    try:
        for child, (src, dst, log) in paths.items():
            with open(log, "w") as err:
                procs.append((subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), str(src), str(dst)],
                    env=env, stdout=subprocess.DEVNULL, stderr=err), log))
        for proc, log in procs:
            assert proc.wait(timeout=1800) == 0, log.read_text()[-4000:]
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = {}
    for _, dst, _ in paths.values():
        with np.load(dst) as z:
            out.update({k: z[k] for k in z.files})
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_hires_equals_jax(case, port, ref):
    frames, _ = port
    for tag in ("reset", "last"):
        got, want = frames[case, tag], ref[SEP.join((case, tag))]
        assert got.shape == want.shape == (N, 512, 512, 3), (got.shape, want.shape)
        assert got.dtype == want.dtype == np.uint8
        bad = int((got != want).any(axis=-1).sum())
        assert bad == 0, f"{case} {tag}: {bad} of {N * 512 * 512} pixels differ"
        assert got.std() > 0, f"{case} {tag}: a blank frame"


def test_rollout_full_equals_act():
    """``rollout_full`` over k steps: (obs, rew, first, info) stacked [k,
    num, ...], equal to k ``act`` + ``observe`` + ``get_info`` calls."""
    k = 4
    acts = np.random.RandomState(5).randint(0, 15, (k, N)).astype(np.int32)
    a = _env("maze", render_mode="rgb_array")
    obs, rew, first, info = a._vec.rollout_full(acts)
    assert obs.shape == (k, N, 64, 64, 3) and info["rgb"].shape == (k, N, 512, 512, 3)
    b = _env("maze", render_mode="rgb_array")
    for t in range(k):
        b.act(acts[t])
        r, o, f = b.observe()
        np.testing.assert_array_equal(obs[t].numpy(), o["rgb"])
        np.testing.assert_array_equal(rew[t].numpy(), r)
        np.testing.assert_array_equal(first[t].numpy(), f)
        want = b.get_info()
        assert set(info) == set(want[0])
        for key, v in info.items():
            np.testing.assert_array_equal(v[t].numpy(), np.stack([w[key] for w in want]),
                                          err_msg=key)
    # both envs stand at the same states afterwards
    np.testing.assert_array_equal(a.observe()[1]["rgb"], b.observe()[1]["rgb"])
    assert a.get_state() == b.get_state()


def test_render_mode_rejects_others():
    with pytest.raises(ValueError):
        _env("maze", render_mode="human")
    env = _env("maze")
    assert "rgb" not in env.get_info()[0]
    from procgen_tpu_torch.env import _ToBaselinesVecEnv

    frame = _ToBaselinesVecEnv(_env("maze", render_mode="rgb_array")).render("rgb_array")
    assert frame.shape == (512, 512, 3)
    assert _ToBaselinesVecEnv(env).render("rgb_array").shape == (64, 64, 3)


if __name__ == "__main__":
    torch.set_num_threads(1)
    _jax_reference(sys.argv[1], sys.argv[2])
