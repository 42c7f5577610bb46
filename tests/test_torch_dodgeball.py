"""The port's dodgeball against the JAX package's and the C++ recordings.

* Easy, hard, extreme and memory, 3 envs, 40 random steps each, an
  episode's end resetting its env at once (both packages' ``env_step``,
  then ``env_reset`` where an env is done): every ``BasicState`` leaf
  (``DodgeballState``, both pools and ``rand_gen`` included), bit-equal.
  The seeds give shots, episode ends by the walls and a forced reset
  (the enemies' volleys, deaths and dust clouds come in the recordings
  and the set-up step).
* A set-up step over the states of every step of each run: the pool
  cleared to the agent and set with a horizontal and a vertical lava wall,
  an enemy over two walls, two enemies that fire at the agent in the same
  step (one redraws its course first), one player ball over two enemies,
  and balls over the walls; stepped once: every leaf.
* The frames of every eighth step's states and of a quarter of the set-up
  step's states (the walls tiled along both axes, dust clouds, rotated
  balls, the door open or shut): ``render_kernel.render_obs_batch`` (on
  CPU tensors, the plain versions of the kernels: the sprite suffix over
  the cached prefix, or memory mode's centred whole frame) against the
  Pallas kernel run in interpret mode and against the XLA ``render_obs``;
  the port's ``renderer.render_obs`` against the XLA one; ``prep_suffix``
  against the Pallas kernel's ``_prep_one`` on the static path.
* The order rules on their own: an enemy over two walls reflects off the
  higher slot (``Dodgeball._entity_scan``), the two enemies' balls land in
  descending slot order, the ball kills both enemies and leaves two dust
  clouds, the vertical wall tiles along y in the kernels' slot records.
* dodgeball_easy, _hard, _extreme and _memory replay exactly.

The JAX reference runs once, in one child process a mode (this file run
as a script, all at once, while the port runs its own and replays the
recordings) whose XLA is held to AVX (``--xla_cpu_max_isa=AVX``): XLA's CPU
backend otherwise contracts ``a * b + c`` into a fused multiply-add, which
neither the C++ reference nor the port does.  The children also hold the
JAX package to the C++ arithmetic (``test_torch_refstate.
patch_jax_cpp_arithmetic``: the agent's velocity decay in f64, the ball's
spin ``BALL_V_ROT`` as the C++ float product), in the children only.

Tolerance: zero.
"""

import contextlib
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from procgen_tpu_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from procgen_tpu_torch.conformance import replay  # noqa: E402
from procgen_tpu_torch.core import lifecycle as tlife  # noqa: E402
from procgen_tpu_torch.core.constants import INT32_MAX  # noqa: E402
from procgen_tpu_torch.core.entities import default_fields  # noqa: E402
from procgen_tpu_torch.core.game import tree_map, tree_where  # noqa: E402
from procgen_tpu_torch.core.options import GameOptions  # noqa: E402
from procgen_tpu_torch.games.dodgeball import (  # noqa: E402
    BALL_V_ROT, DOOR, DUST_CLOUD, ENEMY, ENEMY_BALL, LAVA_WALL, PLAYER_BALL,
    Dodgeball, DodgeballState,
)
from procgen_tpu_torch.render import render_kernel as rk  # noqa: E402
from procgen_tpu_torch.render.renderer import render_obs as trender_obs  # noqa: E402
from procgen_tpu_torch.utils.host_mt import HostMT19937  # noqa: E402

N = 3
STEPS = 40
# run -> (distribution mode, master seed, action seed)
RUNS = {"easy": (0, 5, 0), "hard": (1, 6, 1), "extreme": (2, 7, 2), "memory": (10, 8, 3)}
SEP = "::"
FORCED = 20  # env 1 is forced to reset at this step

# the set-up step's layout: (x, y) of the agent, the two enemies that
# fire, the ball over two enemies and those two enemies
AGENT = (10.0, 2.0)
SHOOTERS = ((10.3, 7.0), (9.6, 17.5))
BALL = (4.6, 4.0)
PAIR = ((4.0, 4.0), (5.2, 4.0))


def _seeds(master_seed):
    m = HostMT19937(master_seed)
    return np.array([m.next_u32() for _ in range(N)], np.int64)


def _actions(action_seed):
    """[STEPS, N] actions, half of them a throw (9) or a move; env 1 is
    forced to reset at step ``FORCED``."""
    rng = np.random.RandomState(action_seed)
    out = []
    for t in range(STEPS):
        a = np.where(rng.rand(N) < 0.5, rng.choice([9, 9, 1, 3, 5, 7], N),
                     rng.randint(0, 15, N)).astype(np.int32)
        if t == FORCED:
            a[1] = -1
        out.append(a)
    return np.stack(out)


def _setup_actions(n):
    return np.random.RandomState(11).choice([4, 9, 1, 7], n).astype(np.int32)


def _frame_steps():
    return np.arange(0, STEPS + 1, 8)


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        elif v is not None:
            out[pre + k] = np.asarray(v)
    return out


def _setup(tree, game):
    """The set-up step's input: a state dict (numpy leaves, ``[B, ...]``)
    whose entity pool holds the agent at ``AGENT`` and then, in slot
    order: a horizontal and a vertical lava wall; two walls (slots 3 and
    4) over an enemy that walks right into them; the two enemies of
    ``SHOOTERS``, ready to fire (the first redraws its course as well);
    the two enemies of ``PAIR`` under the player ball at ``BALL``; an
    enemy ball over the horizontal wall, a player ball over the vertical
    one; a door.  The decor pool is emptied."""
    t = copy.deepcopy(tree)
    e, dec = t["ents"], t["decor"]
    B = e["x"].shape[0]
    er, br, th = game.enemy_r, game._ball_r, game.thickness
    cur = t["cur_time"]

    def wall(x, y, rx, ry):
        return dict(default_fields(x, y, 0.0, 0.0, rx, ry, LAVA_WALL),
                    collides_with_entities=True)

    def enemy(x, y, vx, vy, spawn, fire):
        return dict(default_fields(x, y, vx, vy, er, er, ENEMY), health=1.0,
                    spawn_time=spawn, fire_time=fire, collides_with_entities=True,
                    smart_step=True, image_theme=3)

    def ball(x, y, vx, vy, type_):
        return dict(default_fields(x, y, vx, vy, br, br, type_), expire_time=50,
                    vrot=BALL_V_ROT, collides_with_entities=type_ == PLAYER_BALL)

    recs = [
        wall(5.0, 9.0, 3.5, th),  # horizontal
        wall(16.0, 12.0, th, 4.0),  # vertical
        wall(8.0 + er + 0.3, 15.0, 0.5, 0.5),  # the lower of two over one enemy
        wall(8.0 + er + 0.1, 15.5, 0.4, 0.5),  # the higher
        enemy(8.0, 15.0, 0.05, 0.0, 30, cur),
        enemy(*SHOOTERS[0], 0.0, -0.05, 0, -100),
        enemy(*SHOOTERS[1], 0.0, 0.05, 7, -100),
        enemy(*PAIR[0], 0.0, 0.0, 30, cur),
        enemy(*PAIR[1], 0.0, 0.0, 30, cur),
        ball(*BALL, 0.0, 0.0, PLAYER_BALL),
        ball(5.0, 9.1, 0.0, 0.0, ENEMY_BALL),
        ball(16.0, 8.5, 0.0, 0.1, PLAYER_BALL),
        default_fields(18.5, 1.5, 0.0, 0.0, 1.5, 1.5, DOOR),
    ]
    e["x"][:, 0], e["y"][:, 0] = AGENT
    e["vx"][:, 0] = e["vy"][:, 0] = 0.0
    e["count"][:] = 1
    for rec in recs:
        for k, v in rec.items():
            e[k][np.arange(B), e["count"]] = np.asarray(v, e[k].dtype)
        e["count"] += 1
    dec["count"][:] = 0
    t["game"]["num_enemies"][:] = 5
    return t


# ---------------------------------------------------------------------------
# the JAX reference (child process)
# ---------------------------------------------------------------------------


def _jax_game(mode):
    from procgen_tpu.core.options import GameOptions as JGameOptions
    from procgen_tpu.games.registry import make_game

    game = make_game("dodgeball", JGameOptions(distribution_mode=mode))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def _to_tree(state):
    return jax.tree_util.tree_map(np.array, serialization.to_state_dict(state))


def _jax_reference(out_path, run):
    """Run one mode, step the set-up states once and render the states of
    ``_frame_steps`` and a quarter of the set-up step's.  Saves the
    arrays, keyed ``run::part::leaf``."""
    from procgen_tpu.core import lifecycle
    from procgen_tpu.parallel.vec import _tree_select
    from procgen_tpu.render import pallas_kernel
    from procgen_tpu.render.renderer import render_obs

    jax.config.update("jax_platforms", "cpu")
    mode, mseed, aseed = RUNS[run]
    game = _jax_game(mode)
    init = jax.jit(jax.vmap(lambda sd: lifecycle.initial_state(game, sd)))
    reset = jax.jit(jax.vmap(lambda s: lifecycle.env_reset(game, s)))
    step = jax.jit(jax.vmap(lambda s, a: lifecycle.env_step(game, s, a)))
    s = reset(init(jnp.asarray(_seeds(mseed), jnp.uint32)))
    states = [s]
    for a in _actions(aseed):
        s, done = step(s, jnp.asarray(a))
        s = _tree_select(done, reset(s), s)
        states.append(s)
    out = {}
    trees = [_flat(serialization.to_state_dict(st)) for st in states]
    for leaf in trees[0]:
        out[SEP.join((run, "states", leaf))] = np.stack([t[leaf] for t in trees])

    # the set-up step over the states of every step
    everything = jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs), *states)
    tree = _setup(_to_tree(everything), game)
    B = len(states) * N
    template = jax.eval_shape(
        jax.vmap(lambda sd: lifecycle.initial_state(game, sd)),
        jax.ShapeDtypeStruct((B,), jnp.uint32))
    setup = serialization.from_state_dict(template, tree)
    stepped, _ = step(setup, jnp.asarray(_setup_actions(B)))
    for leaf, v in _flat(serialization.to_state_dict(stepped)).items():
        out[SEP.join((run, "setup", leaf))] = v

    # the rendered states as one batch
    batch = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs), *[states[t] for t in _frame_steps()],
        jax.tree_util.tree_map(lambda x: x[::4], stepped))
    out[SEP.join((run, "pallas"))] = np.asarray(jax.jit(
        lambda st: pallas_kernel.render_obs_batch(game, st, 64, interpret=True)
    )(batch))
    out[SEP.join((run, "xla"))] = np.asarray(
        jax.jit(jax.vmap(lambda st: render_obs(game, st, 64)))(batch))
    if game.static_prefix:
        plan = pallas_kernel.get_plan(game, 64)
        prep = jax.jit(jax.vmap(lambda st: pallas_kernel._prep_one(plan, st)))(batch)
        for k in ("si", "ent_f", "ent_i", "dec_f", "dec_i"):
            out[SEP.join((run, "prep", k))] = np.asarray(prep[k])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_children(tmp_path_factory):
    """Start the JAX reference: one child process per mode, all at once;
    yields run -> (output path, process, stderr path)."""
    out_dir = tmp_path_factory.mktemp("dodgeball")
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"{flags} --xla_cpu_max_isa=AVX".strip(),
        JAX_COMPILATION_CACHE_DIR=jax.config.jax_compilation_cache_dir or "",
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="1",
    )
    children = {}
    for run in RUNS:
        path, log = out_dir / f"{run}.npz", out_dir / f"{run}.log"
        with open(log, "w") as err:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(path), run],
                env=env, stdout=subprocess.DEVNULL, stderr=err)
        children[run] = (path, proc, log)
    yield children
    for _, proc, _ in children.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def ref(jax_children, port, replays):
    """The JAX reference's arrays (waited for after the port's runs and
    replays)."""
    out = {}
    for path, proc, log in jax_children.values():
        assert proc.wait(timeout=1800) == 0, log.read_text()[-4000:]
        with np.load(path) as z:
            out.update({k: z[k] for k in z.files})
    return out


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def _torch_game(mode):
    game = Dodgeball(GameOptions(distribution_mode=mode))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


@contextlib.contextmanager
def _one_thread():
    """The port's ops are small, and the JAX children hold the other
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _cat(states):
    return tree_map(lambda *xs: torch.cat(xs), *states)


def _setup_state(game, states):
    return state_from_numpy(_setup(state_to_numpy(states), game), game, "cpu")


@pytest.fixture(scope="module")
def port(jax_children):
    """Per run: the port's states of every step, the set-up step's input
    and output, and the frames of the rendered states on both of the
    port's render paths with the static path's ``prep_suffix``; computed
    while the JAX reference runs."""
    out = {}
    with _one_thread():
        for run, (mode, mseed, aseed) in RUNS.items():
            game = _torch_game(mode)
            s = tlife.env_reset(game, tlife.initial_state(game, torch.as_tensor(_seeds(mseed))))
            states = [s]
            for a in _actions(aseed):
                s, done = tlife.env_step(game, s, torch.as_tensor(a))
                s = tree_where(done, tlife.env_reset(game, s), s)
                states.append(s)
            setup = _setup_state(game, _cat(states))
            stepped, _ = tlife.env_step(game, setup, torch.as_tensor(_setup_actions(setup.num)))
            batch = _cat([states[t] for t in _frame_steps()]
                         + [tree_map(lambda x: x[::4], stepped)])
            prep = rk.prep_suffix(rk.get_plan(game), batch) if game.static_prefix else None
            frames = (batch, rk.render_obs_batch(game, batch).numpy(),
                      trender_obs(game, batch, 64).numpy(), prep)
            out[run] = (states, (setup, stepped), frames)
    return out


REPLAYS = ("dodgeball_easy", "dodgeball_hard", "dodgeball_extreme", "dodgeball_memory")


@pytest.fixture(scope="module")
def replays(jax_children):
    """Each recording and the port's replay of it on the CPU, computed
    while the JAX reference runs."""
    out = {}
    with _one_thread():
        for name in REPLAYS:
            with open(os.path.join(HERE, "data", "conformance", f"{name}.json")) as f:
                rec = json.load(f)
            out[name] = (rec, replay(rec, device="cpu"))
    return out


def _assert_leaves(ref, prefix, trees, tag):
    want = {k[len(prefix) + len(SEP):]: v for k, v in ref.items()
            if k.startswith(prefix + SEP)}
    got = [_flat(state_to_numpy(t)) for t in trees]
    assert set(want) == set(got[0]), set(want) ^ set(got[0])
    for leaf, w in want.items():
        g = np.stack([t[leaf] for t in got])
        assert g.dtype == w.dtype, (tag, leaf, g.dtype, w.dtype)
        for t in range(len(got)):
            np.testing.assert_array_equal(g[t], w[t], err_msg=f"{tag} step {t}: {leaf}")


@pytest.mark.parametrize("run", list(RUNS))
def test_states_match(run, ref, port):
    states = port[run][0]
    _assert_leaves(ref, SEP.join((run, "states")), states, run)
    assert isinstance(states[-1].game, DodgeballState)


@pytest.mark.parametrize("run", list(RUNS))
def test_setup_step_matches(run, ref, port):
    stepped = port[run][1][1]
    prefix = SEP.join((run, "setup"))
    want = {k[len(prefix) + len(SEP):]: v for k, v in ref.items()
            if k.startswith(prefix + SEP)}
    got = _flat(state_to_numpy(stepped))
    assert want.keys() == got.keys()
    for leaf, w in want.items():
        assert got[leaf].dtype == w.dtype, leaf
        np.testing.assert_array_equal(got[leaf], w, err_msg=leaf)


def _count(e, type_):
    return (e.active & (e.type == type_)).sum(dim=1)


@pytest.mark.parametrize("run", list(RUNS))
def test_trajectories_reach_the_machinery(run, port):
    """The random runs throw balls, end episodes (the forced reset among
    them) and reset; no enemy fires before its episode's step 60, so the
    set-up step holds the volleys: it fires both shooters' balls in
    descending slot order, kills both enemies under the one ball (+2 each,
    two dust clouds) and erases the balls over the walls."""
    states, (setup, stepped) = port[run][:2]
    pballs = 0
    for s0, s1 in zip(states, states[1:]):
        pballs += int((_count(s1.ents, PLAYER_BALL) > _count(s0.ents, PLAYER_BALL)).sum())
    assert pballs >= 5
    resets = sum(int((s1.cur_time < s0.cur_time).sum()) for s0, s1 in zip(states, states[1:]))
    assert resets >= 1 and int(states[FORCED + 1].cur_time[1]) == 0

    e = stepped.ents
    f32 = np.float32

    def slot_at(type_, x):
        hit = e.active & (e.type == type_) & (e.x == float(f32(x)))
        return torch.where(hit.any(dim=1), hit.to(torch.int32).argmax(dim=1), -1)

    first, second = (slot_at(ENEMY_BALL, x) for x, _ in SHOOTERS)
    assert (first >= 0).all() and (second >= 0).all()
    assert (second < first).all()  # the higher shooter's ball first
    assert (stepped.reward == 2 * 2.0).all()
    for x, _ in PAIR:
        assert (slot_at(ENEMY, x) < 0).all()
    dust = stepped.decor.active & (stepped.decor.type == DUST_CLOUD)
    assert (dust.sum(dim=1) == 2).all()
    for type_, x in ((PLAYER_BALL, BALL[0]), (PLAYER_BALL, 16.0), (ENEMY_BALL, 5.0)):
        assert (slot_at(type_, x) < 0).all()
    assert (stepped.game.num_enemies == 3).all()


def test_enemy_reflects_off_the_higher_wall():
    """An enemy's micro-move into two lava walls reflects off the higher
    slot's: ``_entity_scan`` on the set-up enemy's record against the set-up
    pool, and the other wall's reflection differs."""
    game = _torch_game(0)
    s = tlife.env_reset(game, tlife.initial_state(game, torch.as_tensor(_seeds(5))))
    s = _setup_state(game, s)
    e = s.ents
    k = 5  # the enemy; its walls are slots 3 (lower) and 4 (higher)
    assert (e.type[:, k] == ENEMY).all() and (e.type[:, 3:5] == LAVA_WALL).all()
    rec = {f: getattr(e, f)[:, k:k + 1] for f in ("x", "vx", "vy", "rx", "ry", "type")}
    vx = torch.full_like(rec["x"], 0.0125)
    rec["x"] = rec["x"] + vx
    rec["y"] = e.y[:, k:k + 1]
    rec["will_erase"] = torch.zeros_like(rec["x"], dtype=torch.bool)
    _, out, blocked = game._entity_scan(s, rec, vx, torch.zeros_like(vx), 0)
    assert not blocked.any()

    def reflected(j):
        delx = e.x[:, j:j + 1] - rec["x"]
        return rec["x"] - 2 * ((e.rx[:, j:j + 1] + rec["rx"]) - delx)

    assert torch.equal(out["x"], reflected(4)) and not torch.equal(out["x"], reflected(3))
    assert torch.equal(out["vx"], -rec["vx"]) and torch.equal(out["y"], rec["y"])


@pytest.mark.parametrize("run", ["easy", "memory"])
def test_walls_tile_along_their_long_axis(run, port):
    """The set-up pool's horizontal wall (slot 1) tiles along x and its
    vertical wall (slot 2) along y, several tiles each, in the slot
    records of the kernels' prep."""
    game = _torch_game(RUNS[run][0])
    setup = port[run][1][0]
    ent_f, ent_i = rk.prep(rk.get_plan(game), setup)
    h, v = ent_i[:, 1], ent_i[:, 2]
    assert (h[:, rk.EI_TILEH] == 1).all() and (h[:, rk.EI_TILEV] == 0).all()
    assert (v[:, rk.EI_TILEV] == 1).all() and (v[:, rk.EI_TILEH] == 0).all()
    assert (h[:, rk.EI_NTH] > 1).all() and (v[:, rk.EI_NTV] > 1).all()


def _frames_case(run, port):
    """(state batch, kernel-path frames, plain-renderer frames, prep)."""
    return port[run][2]


@pytest.mark.parametrize("run", list(RUNS))
def test_frames_match_pallas_interpret(run, ref, port):
    got = _frames_case(run, port)[1]
    np.testing.assert_array_equal(got, ref[SEP.join((run, "pallas"))])


@pytest.mark.parametrize("run", list(RUNS))
def test_frames_match_xla_render_obs(run, ref, port):
    """The port's plain renderer equals the XLA renderer, which equals the
    Pallas kernel on these states."""
    plain = _frames_case(run, port)[2]
    want = ref[SEP.join((run, "xla"))]
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(want, ref[SEP.join((run, "pallas"))])


@pytest.mark.parametrize("run", ["easy", "hard", "extreme"])
def test_prep_matches_pallas_prep(run, ref, port):
    batch, _, _, (ent_f, ent_i, decor) = _frames_case(run, port)
    plan = rk.get_plan(_torch_game(RUNS[run][0]))
    assert plan.static and plan.dz_levels == (0,) and ent_f.shape[1] == 72
    assert decor.nzd == 1 and decor.dec_f.shape[1] == 16
    key = SEP.join((run, "prep")) + SEP
    np.testing.assert_array_equal(ent_f.numpy(), ref[key + "ent_f"])
    np.testing.assert_array_equal(ent_i.numpy(), ref[key + "ent_i"])
    np.testing.assert_array_equal(decor.dec_f.numpy(), ref[key + "dec_f"])
    np.testing.assert_array_equal(decor.dec_i.numpy(), ref[key + "dec_i"])
    si = ref[key + "si"]
    np.testing.assert_array_equal(decor.counts[:, 0].numpy(), si[:, rk.SI_ENT_COUNT])
    np.testing.assert_array_equal(decor.counts[:, 1].numpy(), si[:, rk.SI_DEC_COUNT])
    # the rotation banks of the balls and enemies are sampled
    row = ent_i[..., rk.EI_ROW]
    bank = (row > plan.ent_atlas.transparent_row) & (row < plan.n1e)
    assert bool((bank & (ent_i[..., rk.EI_LIVE] > 0)).any())
    assert bool((decor.dec_i[..., rk.EI_LIVE] > 0).any())


@pytest.mark.parametrize("name", REPLAYS)
def test_conformance_replay(name, replays):
    rec, res = replays[name]
    assert res["first_divergence"] is None, res["first_divergence"]
    assert res["checked"] == res["steps"] == len(rec["actions"])


def test_supports_both_paths():
    """Easy, hard and extreme take the static path with both pools; memory
    mode the centred whole frame over its 40x40 world."""
    for mode in (0, 1, 2):
        plan = rk.get_plan(_torch_game(mode))
        assert rk.supports(plan.game) and plan.static
        assert plan.z_levels == (0, 1) and plan.dz_levels == (0,)
    plan = rk.get_plan(_torch_game(10))
    assert rk.supports(plan.game) and not plan.static
    assert plan.game.center_agent and plan.NC == int(plan.game.visibility) + 3


if __name__ == "__main__":
    from test_torch_refstate import patch_jax_cpp_arithmetic

    patch_jax_cpp_arithmetic()
    _jax_reference(sys.argv[1], sys.argv[2])
