"""The state bridge and the entity struct-of-arrays ops.  The bridge: the
JAX package's batched state -> numpy -> the
port's torch state -> numpy, leaf for leaf, without loss; and the port's
state through the bridge back into a JAX ``BasicState``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from procgen_tpu.core import lifecycle as jlife
from procgen_tpu.core.entities import Entities as JEntities
from procgen_tpu.core.game import BasicState as JBasicState
from procgen_tpu.core.constants import EASY_MODE, INT32_MAX
from procgen_tpu.core.options import GameOptions
from procgen_tpu.games.maze import Maze as JMaze
from procgen_tpu.utils.host_mt import HostMT19937

from procgen_tpu_torch.bridge import state_from_numpy, state_to_numpy
from procgen_tpu_torch.core import rng as trng
from procgen_tpu_torch.core.entities import Entities
from procgen_tpu_torch.core.game import BasicState
from procgen_tpu_torch.games.maze import Maze as TMaze


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        else:
            out[pre + k] = v
    return out


@pytest.fixture(scope="module")
def jax_tree():
    game = JMaze(GameOptions(distribution_mode=EASY_MODE))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    master = HostMT19937(11)
    seeds = jnp.asarray([master.next_u32() for _ in range(4)], jnp.uint32)

    @jax.jit
    def make(seeds):
        s = jax.vmap(lambda sd: jlife.initial_state(game, sd))(seeds)
        s = jax.vmap(lambda s: jlife.env_reset(game, s))(s)
        return jax.vmap(lambda s, a: jlife.env_step(game, s, a)[0])(
            s, jnp.asarray([1, 3, 5, 7], jnp.int32))

    states = make(seeds)
    tree = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(states))
    return states, tree


def test_round_trip_lossless(jax_tree):
    _, tree = jax_tree
    tmaze = TMaze(GameOptions(distribution_mode=EASY_MODE))
    ts = state_from_numpy(tree, tmaze, "cpu")
    back = state_to_numpy(ts)
    a, b = _flat(tree), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None:
            assert b[k] is None, k
            continue
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_layout(jax_tree):
    """The port's state keeps the JAX field names and order, with int64
    mt19937 words and torch tensors on the requested device."""
    _, tree = jax_tree
    ts = state_from_numpy(tree, TMaze(GameOptions(distribution_mode=EASY_MODE)))
    for tcls, jcls in ((BasicState, JBasicState), (Entities, JEntities)):
        assert [f.name for f in dataclasses.fields(tcls)] == [
            f.name for f in dataclasses.fields(jcls)]
    assert {f.name for f in dataclasses.fields(BasicState)} == set(tree)
    assert isinstance(ts.rand_gen, trng.MTState)
    assert ts.rand_gen.mt.dtype == torch.int64 and ts.rand_gen.mt.shape == (4, 624)
    assert ts.grid.dtype == torch.int32 and ts.grid.shape == (4, 15, 15)
    assert ts.frame.dtype == torch.uint8 and ts.frame.shape == (4, 64, 64, 3)
    assert ts.game.maze_dim.shape == (4,)


def test_into_jax_state(jax_tree):
    """The port's state, via the bridge dict, restores a JAX BasicState
    that equals the original leaf for leaf."""
    states, tree = jax_tree
    ts = state_from_numpy(tree, TMaze(GameOptions(distribution_mode=EASY_MODE)))
    restored = serialization.from_state_dict(states, state_to_numpy(ts))
    for x, y in zip(jax.tree_util.tree_leaves(states),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype


def _random_ents(n=4, cap=6, seed=0):
    rng = np.random.RandomState(seed)
    d = {}
    for f in dataclasses.fields(JEntities):
        if f.name == "count":
            d[f.name] = rng.randint(0, cap + 1, n).astype(np.int32)
        elif f.name in ("type", "image_type"):
            d[f.name] = rng.choice([0, 2, 54, 58, 59], (n, cap)).astype(np.int32)
        elif f.name in ("expire_time", "life_time"):
            d[f.name] = rng.randint(-1, 5, (n, cap)).astype(np.int32)
        elif f.name in (
                "will_erase", "collides_with_entities", "is_reflected",
                "use_abs_coords", "smart_step", "avoids_collisions", "auto_erase"):
            d[f.name] = rng.rand(n, cap) < 0.4
        elif f.name in ("render_z", "fire_time", "spawn_time", "image_theme"):
            d[f.name] = rng.randint(-2, 3, (n, cap)).astype(np.int32)
        else:
            d[f.name] = rng.uniform(-3, 3, (n, cap)).astype(np.float32)
    return d


@pytest.mark.parametrize("op", ["compact", "push", "step_masked"])
def test_entities_ops_match_jax(op):
    d = _random_ents()
    je = JEntities(**{k: jnp.asarray(v) for k, v in d.items()})
    te = Entities(**{k: torch.as_tensor(v) for k, v in d.items()})
    rng = np.random.RandomState(1)
    mask = rng.rand(4, 6) < 0.6
    if op == "compact":
        jo = jax.vmap(lambda e, m: e.compact(m))(je, jnp.asarray(mask))
        to = te.compact(torch.as_tensor(mask))
    elif op == "push":
        from procgen_tpu.core.entities import default_fields as jdef
        from procgen_tpu_torch.core.entities import default_fields as tdef

        do = np.array([True, False, True, True])
        xs = rng.uniform(0, 5, 4).astype(np.float32)
        jo = jax.vmap(lambda e, x, m: e.push(jdef(x, 1.0, 0.0, 0.0, 0.5, 0.5, 58), do=m))(
            je, jnp.asarray(xs), jnp.asarray(do))
        to = te.push(tdef(torch.as_tensor(xs), 1.0, 0.0, 0.0, 0.5, 0.5, 58),
                     do=torch.as_tensor(do))
    else:
        jo = jax.vmap(lambda e, m: e.step_masked(m))(je, jnp.asarray(mask))
        to = te.step_masked(torch.as_tensor(mask))
    for f in dataclasses.fields(JEntities):
        a, b = np.asarray(getattr(jo, f.name)), getattr(to, f.name).numpy()
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
