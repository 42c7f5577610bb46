"""The port's batched MT19937 against std::mt19937 golden values
(tests/data/mt_golden.json, from tools/gen_mt_golden.cpp) and against the
JAX package's rng at random states.  Every env of a batch runs its own
stream.  Tolerance: zero."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from procgen_tpu.core import rng as jrng
from procgen_tpu_torch.core import rng as trng

GOLDEN = json.load(
    open(os.path.join(os.path.dirname(__file__), "data", "mt_golden.json"))
)

SEEDS = [0, 1, 42, 1949448038, 2147483647]


def _draws(st, n, fn):
    out = []
    for _ in range(n):
        st, v = fn(st)
        out.append(v)
    return st, torch.stack(out, dim=1)


def test_raw_streams_match_golden_batched():
    st = trng.seed(torch.as_tensor(SEEDS))
    _, ys = _draws(st, 1400, trng.next_u32)
    for i, s in enumerate(SEEDS):
        np.testing.assert_array_equal(ys[i].numpy(), GOLDEN[f"raw_seed_{s}"])


@pytest.mark.parametrize("key,seed,fn", [
    ("randint_lo3_hi17_seed7", 7, lambda st: trng.randint(st, 3, 17)),
    ("randn_10_seed9", 9, lambda st: trng.randn(st, 10)),
    ("rand01_bits_seed23", 23, trng.rand01),
    ("randrange_bits_seed31", 31, lambda st: trng.randrange(st, -1.5, 2.5)),
])
def test_helpers_match_golden(key, seed, fn):
    st = trng.seed(torch.as_tensor([seed]))
    _, v = _draws(st, 256, fn)
    v = v[0]
    if v.dtype == torch.float32:
        v = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert v.tolist() == GOLDEN[key]


def test_reseed_resets_stream():
    st = trng.seed(torch.as_tensor([5]))
    st, _ = _draws(st, 100, trng.next_u32)
    st = trng.seed(torch.as_tensor([77]))
    _, ys = _draws(st, 64, trng.next_u32)
    assert ys[0].tolist() == GOLDEN["reseed_77_after_100_draws_of_5"]


def _jstate(st: trng.MTState):
    return jrng.MTState(
        mt=jnp.asarray(st.mt.numpy().astype(np.uint32)),
        pos=jnp.asarray(st.pos.numpy()),
        is_seeded=jnp.asarray(st.is_seeded.numpy()),
    )


def _assert_state(js, ts: trng.MTState):
    np.testing.assert_array_equal(np.asarray(js.mt), ts.mt.numpy().astype(np.uint32))
    assert ts.mt.dtype == torch.int64 and int(ts.mt.max()) < 2**32
    np.testing.assert_array_equal(np.asarray(js.pos), ts.pos.numpy())
    np.testing.assert_array_equal(np.asarray(js.is_seeded), ts.is_seeded.numpy())


@pytest.fixture(scope="module")
def rand_states():
    """8 streams at random positions (some at the twist boundary)."""
    rng = np.random.RandomState(0)
    seeds = rng.randint(0, 2**32, 8, dtype=np.uint64).astype(np.int64)
    st = trng.seed(torch.as_tensor(seeds))
    pos = torch.as_tensor(rng.randint(0, 625, 8), dtype=torch.int32)
    pos[0], pos[1] = 624, 623
    return seeds, st.replace(pos=pos)


def test_seed_twist_temper_match_jax(rand_states):
    seeds, st = rand_states
    js = jax.vmap(jrng.seed)(jnp.asarray(seeds.astype(np.uint32)))
    _assert_state(js, trng.seed(torch.as_tensor(seeds)))
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jrng.twist)(js.mt)), trng.twist(st.mt).numpy()
    )
    w = np.random.RandomState(1).randint(0, 2**32, (8, 100), dtype=np.uint64)
    np.testing.assert_array_equal(
        np.asarray(jrng.temper(jnp.asarray(w.astype(np.uint32)))),
        trng.temper(torch.as_tensor(w.astype(np.int64))).numpy(),
    )
    u = trng.unseeded(3, "cpu")
    _assert_state(jax.vmap(lambda _: jrng.unseeded())(jnp.arange(3)), u)


@pytest.mark.parametrize("helper", ["randint", "randn", "rand01", "randbool",
                                    "randrange"])
def test_checked_helpers_match_jax(rand_states, helper):
    _, st = rand_states
    args = {"randint": (-5, 1000), "randn": (7,), "rand01": (), "randbool": (),
            "randrange": (-2.25, 9.5)}[helper]
    js = _jstate(st)
    jf = jax.vmap(lambda s: getattr(jrng, helper)(s, *args))
    for _ in range(3):
        js, jv = jf(js)
        st, tv = getattr(trng, helper)(st, *args)
        _assert_state(js, st)
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def test_arith_helpers_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randint(0, 2**32, 64, dtype=np.uint64)
    lo = rng.randint(-2**31, 2**31 - 1, 64).astype(np.int32)
    hi = rng.randint(-2**31, 2**31 - 1, 64).astype(np.int32)
    jx, tx = jnp.asarray(x.astype(np.uint32)), torch.as_tensor(x.astype(np.int64))
    np.testing.assert_array_equal(
        np.asarray(jrng._randint_from(jx, jnp.asarray(lo), jnp.asarray(hi))),
        trng._randint_from(tx, torch.as_tensor(lo), torch.as_tensor(hi)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jrng._randn_from(jx, jnp.asarray(hi))),
        trng._randn_from(tx, torch.as_tensor(hi)).numpy())
    f = rng.uniform(0, 1, 64).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jrng._randrange_from(jnp.asarray(f), -3.3, 7.1)),
        trng._randrange_from(torch.as_tensor(f), -3.3, 7.1).numpy())


def test_peek_block_commit_match_jax(rand_states):
    _, st = rand_states
    js = jax.vmap(jrng.normalize)(_jstate(st))
    st = trng.normalize(st)
    _assert_state(js, st)
    rng = np.random.RandomState(3)
    for k in (8, 64):
        used = rng.randint(0, k + 1, 8).astype(np.int32)
        jd, jn = jax.vmap(lambda s: jrng.peek_block(s, k, assume_normalized=True))(js)
        td, tn = trng.peek_block(st, k, assume_normalized=True)
        np.testing.assert_array_equal(np.asarray(jd.block), td.block.numpy())
        np.testing.assert_array_equal(np.asarray(jd.twisted), td.twisted.numpy())
        _assert_state(jn, tn)
        # cursor draws, a masked draw and peek_at offsets
        jd2, jy = jax.vmap(lambda d: d.randint(0, 1000000))(jd)
        td2, ty = td.randint(0, 1000000)
        np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
        cond = np.arange(8) % 2 == 0
        jd2, jy = jax.vmap(lambda d, c: d.randn_if(c, 9))(jd2, jnp.asarray(cond))
        td2, ty = td2.randn_if(torch.as_tensor(cond), 9)
        np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
        offs = np.tile(np.arange(-1, 5, dtype=np.int32), (8, 1))
        np.testing.assert_array_equal(
            np.asarray(jax.vmap(lambda d, o: d.peek_at(o))(jd2, jnp.asarray(offs))),
            td2.peek_at(torch.as_tensor(offs)).numpy())
        jd2 = jd2.replace(cursor=jnp.asarray(used))
        td2 = td2.replace(cursor=torch.as_tensor(used))
        js = jax.vmap(jrng.commit)(jn, jd2)
        st = trng.commit(tn, td2)
        _assert_state(js, st)
    # the unnormalised entry (pos == 624 twists first)
    st = st.replace(pos=torch.full_like(st.pos, 624))
    jd, jn = jax.vmap(lambda s: jrng.peek_block(s, 8))(_jstate(st))
    td, tn = trng.peek_block(st, 8)
    np.testing.assert_array_equal(np.asarray(jd.block), td.block.numpy())
    _assert_state(jn, tn)


_DRAW_ARGS = {"randint": (-5, 1000), "randn": (7,), "rand01": (),
              "randbool": (), "randrange": (-2.25, 9.5)}


@pytest.mark.parametrize("helper,masked", [
    (h, False) for h in sorted(_DRAW_ARGS)
] + [(h, True) for h in ("randint", "randn", "rand01", "randbool")])
def test_draws_helpers_match_jax(rand_states, helper, masked):
    """Every cursor draw of a peeked block, plain and ``*_if`` (a word
    consumed only where the condition holds), against the JAX ``Draws``."""
    _, st = rand_states
    js = jax.vmap(jrng.normalize)(_jstate(st))
    jd, _ = jax.vmap(lambda s: jrng.peek_block(s, 16, assume_normalized=True))(js)
    td, _ = trng.peek_block(trng.normalize(st), 16, assume_normalized=True)
    args = _DRAW_ARGS[helper]
    conds = np.random.RandomState(4).rand(4, 8) < 0.5
    for cond in conds:
        if masked:
            name = helper + "_if"
            jd, jv = jax.vmap(lambda d, c: getattr(d, name)(c, *args))(
                jd, jnp.asarray(cond))
            td, tv = getattr(td, name)(torch.as_tensor(cond), *args)
        else:
            jd, jv = jax.vmap(lambda d: getattr(d, helper)(*args))(jd)
            td, tv = getattr(td, helper)(*args)
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        np.testing.assert_array_equal(np.asarray(jd.cursor), td.cursor.numpy())


@pytest.mark.parametrize("n_max", [112, 700])
def test_draw_n_matches_jax(rand_states, n_max):
    _, st = rand_states
    n = np.random.RandomState(n_max).randint(0, n_max + 1, 8).astype(np.int32)
    js, jv = jax.vmap(lambda s, k: jrng.draw_n(s, n_max, k))(_jstate(st), jnp.asarray(n))
    ts, tv = trng.draw_n(st, n_max, torch.as_tensor(n))
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    _assert_state(js, ts)
