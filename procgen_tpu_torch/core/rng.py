"""MT19937-compatible batched RNG on torch tensors.

The counterpart of ``procgen_tpu.core.rng``: every env carries its own
``std::mt19937`` stream and the helpers reproduce the reference's draw
arithmetic (procgen/src/randgen.cpp):

  * ``randint(low, high)`` = ``low + x % (high - low)``
  * ``randn(high)``        = ``x % high``
  * ``rand01()``           = ``float((double)x / 2**32)``
  * ``randrange(lo, hi)``  = ``rand01() * (hi-lo) + lo``
  * ``randbool()``         = ``rand01() > .5``

Words are uint32 values held in int64 tensors and masked to 32 bits after
every operation that can carry past bit 31 (torch's uint32 lacks shifts,
``%`` and comparisons on the CPU).  Every tensor is batch-first: ``mt`` is
``[N, 624]``, ``pos`` and ``is_seeded`` are ``[N]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

N = 624
M = 397
MATRIX_A = 0x9908B0DF
UPPER_MASK = 0x80000000
LOWER_MASK = 0x7FFFFFFF
MASK = 0xFFFFFFFF


@dataclasses.dataclass
class MTState:
    """One mt19937 stream per env: 624 words + position in the block.

    ``pos == N`` means the next draw twists first (a freshly seeded
    engine); ``is_seeded`` exists for serialization parity."""

    mt: torch.Tensor  # int64 [N_env, 624], values in [0, 2**32)
    pos: torch.Tensor  # int32 [N_env]
    is_seeded: torch.Tensor  # bool [N_env]

    def replace(self, **kw) -> "MTState":
        return dataclasses.replace(self, **kw)


def as_i32(v: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) reinterpreted as int32, wrapping like a cast."""
    v = v & MASK
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def as_u32(v: torch.Tensor) -> torch.Tensor:
    """int32 values reinterpreted as uint32 words in int64."""
    return v.to(torch.int64) & MASK


def seed(s: torch.Tensor) -> MTState:
    """Seed exactly like std::mt19937::seed (init_genrand); ``s`` holds
    one uint32 seed per env (any int dtype, taken modulo 2**32).  The
    recurrence's 623 sequential steps run over the batch in numpy on the
    host (uint64: each product stays below 2**63), one copy each way,
    rather than as some 3,100 small device operations."""
    dev = s.device
    x = s.detach().to("cpu", torch.int64).numpy().astype(np.uint64) & np.uint64(MASK)
    n = x.shape[0]
    cols = np.empty((N, n), np.uint64)
    cols[0] = x
    for i in range(1, N):
        prev = cols[i - 1]
        cols[i] = (np.uint64(1812433253) * (prev ^ (prev >> np.uint64(30)))
                   + np.uint64(i)) & np.uint64(MASK)
    return MTState(
        mt=torch.from_numpy(np.ascontiguousarray(cols.T).astype(np.int64)).to(dev),
        pos=torch.full((n,), N, dtype=torch.int32, device=dev),
        is_seeded=torch.ones((n,), dtype=torch.bool, device=dev),
    )


def unseeded(n: int, device) -> MTState:
    """A default-constructed RandGen per env (seeded with 5489)."""
    st = seed(torch.full((n,), 5489, dtype=torch.int64, device=device))
    return st.replace(is_seeded=torch.zeros_like(st.is_seeded))


def twist(mt: torch.Tensor) -> torch.Tensor:
    """One full MT19937 twist of ``[..., 624]`` words, in the same three
    dependency chunks + tail as the JAX package (dependency distance 227)."""
    up = mt & UPPER_MASK
    lo = mt & LOWER_MASK

    def mix(y, old_far):
        mag = torch.where((y & 1).bool(), MATRIX_A, 0)
        return old_far ^ (y >> 1) ^ mag

    y_a = up[..., 0:227] | lo[..., 1:228]
    new_a = mix(y_a, mt[..., M:M + 227])
    y_b = up[..., 227:454] | lo[..., 228:455]
    new_b = mix(y_b, new_a[..., 0:227])
    y_c = up[..., 454:623] | lo[..., 455:624]
    new_c = mix(y_c, new_b[..., 0:169])
    y_last = (mt[..., 623:624] & UPPER_MASK) | (new_a[..., 0:1] & LOWER_MASK)
    new_last = mix(y_last, new_b[..., 169:170])
    return torch.cat([new_a, new_b, new_c, new_last], dim=-1)


def temper(y: torch.Tensor) -> torch.Tensor:
    y = y ^ (y >> 11)
    y = y ^ ((y << 7) & 0x9D2C5680)
    y = y ^ ((y << 15) & 0xEFC60000)
    y = y ^ (y >> 18)
    return y & MASK


def _sel(cond: torch.Tensor, a: MTState, b: MTState) -> MTState:
    return MTState(
        mt=torch.where(cond[:, None], a.mt, b.mt),
        pos=torch.where(cond, a.pos, b.pos),
        is_seeded=torch.where(cond, a.is_seeded, b.is_seeded),
    )


# ---------------------------------------------------------------------------
# Checked per-draw path (reset / level-gen).
# ---------------------------------------------------------------------------


def next_u32(state: MTState):
    """Draw one tempered word per env, twisting where the block is spent."""
    needs = state.pos >= N
    mt = torch.where(needs[:, None], twist(state.mt), state.mt)
    pos = torch.where(needs, torch.zeros_like(state.pos), state.pos)
    y = temper(mt.gather(1, pos.long()[:, None])[:, 0])
    return state.replace(mt=mt, pos=pos + 1), y


def randint(state: MTState, low, high):
    state, x = next_u32(state)
    return state, _randint_from(x, low, high)


def randn(state: MTState, high):
    state, x = next_u32(state)
    return state, _randn_from(x, high)


def rand01(state: MTState):
    state, x = next_u32(state)
    return state, _rand01_from(x)


def randbool(state: MTState):
    state, f = rand01(state)
    return state, f > 0.5


def randrange(state: MTState, low, high):
    state, f = rand01(state)
    return state, _randrange_from(f, low, high)


def simple_choose(state: MTState, count, k_max: int, num, size: int):
    """RandGen::simple_choose (randgen.cpp:70-88): up to ``k_max`` distinct
    picks of ``[0, count)`` per env by rejection, ``num`` of them (an int
    or [N]); ``count`` (an int or [N]) is at most ``size``.  Returns
    (stream, picks int32 [N, k_max], -1 past ``num``).  A pick an env does
    not make draws nothing; each rejection round draws only for the envs
    whose last pick was taken, and costs one host read, of whether any
    env is still rejecting."""
    n = state.pos.shape[0]
    dev = state.pos.device
    high = torch.as_tensor(count, device=dev).expand(n).clamp_min(1)
    used = torch.zeros((n, size), dtype=torch.bool, device=dev)
    picks = []
    for j in range(k_max):
        do = torch.as_tensor(j < num, device=dev).expand(n)
        st, v = randn(state, high)
        rej = do & used.gather(1, v.long()[:, None])[:, 0]
        while bool(rej.any()):
            st2, v2 = randn(st, high)
            st = _sel(rej, st2, st)
            v = torch.where(rej, v2, v)
            rej = rej & used.gather(1, v.long()[:, None])[:, 0]
        state = _sel(do, st, state)
        used.scatter_(1, v.long()[:, None], used.gather(1, v.long()[:, None]) | do[:, None])
        picks.append(torch.where(do, v, -1))
    return state, torch.stack(picks, dim=1)


# ---------------------------------------------------------------------------
# Hot-path block draws: one twist per step, cheap cursor draws.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Draws:
    """A step-local window of pre-tempered words plus a consumption cursor
    per env.  ``peek_block`` makes it; ``commit`` folds the consumed count
    back into the stream."""

    block: torch.Tensor  # int64 [N_env, K] tempered words
    twisted: torch.Tensor  # int64 [N_env, 624] the post-twist state
    cursor: torch.Tensor  # int32 [N_env] words consumed so far

    def replace(self, **kw) -> "Draws":
        return dataclasses.replace(self, **kw)

    def peek_at(self, offsets) -> torch.Tensor:
        """Words at ``cursor + offsets`` (offsets ``[N_env, ...]`` or a
        scalar), clipped to the window, without advancing."""
        K = self.block.shape[1]
        offs = torch.as_tensor(offsets, dtype=torch.int32, device=self.block.device)
        cur = self.cursor.reshape((-1,) + (1,) * max(offs.dim() - 1, 0))
        idx = (cur + offs).clamp(0, K - 1).long()
        if idx.dim() == 1:
            return self.block.gather(1, idx[:, None])[:, 0]
        flat = idx.reshape(idx.shape[0], -1)
        return self.block.gather(1, flat).reshape(idx.shape)

    def take_u32(self):
        y = self.peek_at(0)
        return self.replace(cursor=self.cursor + 1), y

    def randint(self, low, high):
        d, x = self.take_u32()
        return d, _randint_from(x, low, high)

    def randn(self, high):
        d, x = self.take_u32()
        return d, _randn_from(x, high)

    def rand01(self):
        d, x = self.take_u32()
        return d, _rand01_from(x)

    def randbool(self):
        d, f = self.rand01()
        return d, f > 0.5

    def randrange(self, low, high):
        d, f = self.rand01()
        return d, _randrange_from(f, low, high)

    # masked draws: consume a word only where ``cond``; the value is only
    # meaningful there

    def take_u32_if(self, cond):
        y = self.peek_at(0)
        cond = torch.as_tensor(cond, device=self.cursor.device)
        return self.replace(cursor=self.cursor + cond.to(torch.int32)), y

    def randn_if(self, cond, high):
        d, x = self.take_u32_if(cond)
        return d, _randn_from(x, high)

    def randint_if(self, cond, low, high):
        d, x = self.take_u32_if(cond)
        return d, _randint_from(x, low, high)

    def rand01_if(self, cond):
        d, x = self.take_u32_if(cond)
        return d, _rand01_from(x)

    def randbool_if(self, cond):
        d, f = self.rand01_if(cond)
        return d, f > 0.5


def normalize(state: MTState) -> MTState:
    """Fold a pending boundary twist so that pos < N."""
    needs = state.pos >= N
    mt = torch.where(needs[:, None], twist(state.mt), state.mt)
    return state.replace(
        mt=mt, pos=torch.where(needs, torch.zeros_like(state.pos), state.pos)
    )


def peek_block(state: MTState, k: int, assume_normalized: bool = False):
    """The next ``k`` tempered words per env, not yet consumed; returns
    (Draws, normalised state)."""
    assert k <= N, "peek window larger than one MT block"
    if assume_normalized:
        mt, pos = state.mt, state.pos
    else:
        at_boundary = state.pos >= N
        mt = torch.where(at_boundary[:, None], twist(state.mt), state.mt)
        pos = torch.where(at_boundary, torch.zeros_like(state.pos), state.pos)
    twisted = twist(mt)
    cat = torch.cat([mt, twisted], dim=1)
    idx = pos.long()[:, None] + torch.arange(k, device=mt.device)
    vals = cat.gather(1, idx)
    draws = Draws(
        block=temper(vals),
        twisted=twisted,
        cursor=torch.zeros_like(state.pos),
    )
    return draws, MTState(mt=mt, pos=pos, is_seeded=state.is_seeded)


def commit(norm_state: MTState, draws: Draws) -> MTState:
    """Advance the normalised stream by the words actually drawn."""
    pos = norm_state.pos + draws.cursor
    crossed = pos >= N
    mt = torch.where(crossed[:, None], draws.twisted, norm_state.mt)
    pos = torch.where(crossed, pos - N, pos)
    return norm_state.replace(mt=mt, pos=pos)


def window(draws: Draws, norm_state: MTState, need: int):
    """``(draws, norm_state)``, or a fresh peeked window of ``N`` words
    where some env has fewer than ``need`` words left in its window (one
    host read)."""
    if int(draws.cursor.max()) > N - need:
        draws, norm_state = peek_block(commit(norm_state, draws), N)
    return draws, norm_state


def draw_block(state: MTState, n_max: int):
    """The next ``n_max`` tempered words per env (``[N_env, n_max]``)
    WITHOUT advancing; pass ``ctx`` to ``advance_block`` with the count
    each env consumed.  Pays ceil(n_max/624)+1 twists past the
    (normalised) current block, the JAX package's schedule."""
    at_boundary = state.pos >= N
    mt = torch.where(at_boundary[:, None], twist(state.mt), state.mt)
    pos = torch.where(at_boundary, torch.zeros_like(state.pos), state.pos)
    k_blocks = (n_max + N - 1) // N + 1
    blocks = [mt]
    for _ in range(k_blocks):
        blocks.append(twist(blocks[-1]))
    all_out = temper(torch.cat(blocks, dim=1))
    # dynamic_slice clamps the start so the window stays in bounds
    start = pos.long().clamp(0, all_out.shape[1] - n_max)
    vals = all_out.gather(
        1, start[:, None] + torch.arange(n_max, device=mt.device)
    )
    return vals, (torch.stack(blocks, dim=1), pos, k_blocks)


def advance_block(state: MTState, ctx, n) -> MTState:
    """Advance each stream by ``n`` (``[N_env]``) words drawn from
    ``draw_block``'s window."""
    stack, pos, k_blocks = ctx  # stack: [N_env, k_blocks+1, 624]
    new_abs = pos + torch.as_tensor(n, dtype=torch.int32, device=pos.device)
    blk = torch.div(new_abs, N, rounding_mode="floor")
    new_pos = torch.remainder(new_abs, N)
    b = blk.long().clamp(0, k_blocks)
    new_mt = stack[torch.arange(stack.shape[0], device=stack.device), b]
    return state.replace(mt=new_mt, pos=new_pos.to(torch.int32))


def draw_n(state: MTState, n_max: int, n=None):
    """The next ``n_max`` tempered words per env (``[N_env, n_max]``);
    advances each stream by ``n`` (``[N_env]``, <= n_max; default
    n_max): ``draw_block`` then ``advance_block``."""
    vals, ctx = draw_block(state, n_max)
    if n is None:
        n = torch.full_like(state.pos, n_max)
    return advance_block(state, ctx, n), vals


# ---------------------------------------------------------------------------
# Shared helper arithmetic (uint32 / f32 semantics of RandGen).
# ---------------------------------------------------------------------------


def _i32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int32, device=like.device)


def _randint_from(x: torch.Tensor, low, high) -> torch.Tensor:
    low = _i32(low, x)
    high = _i32(high, x)
    rng = as_u32(high - low).clamp_min(1)
    return low + as_i32(x % rng)


def _randn_from(x: torch.Tensor, high) -> torch.Tensor:
    rng = as_u32(_i32(high, x)).clamp_min(1)
    return as_i32(x % rng)


def _rand01_from(x: torch.Tensor) -> torch.Tensor:
    # uint32 -> f32 rounds to nearest even (int64 holds the word exactly);
    # the power-of-two scale is exact
    return x.to(torch.float32) * (2.0**-32)


def _randrange_from(f01: torch.Tensor, low, high) -> torch.Tensor:
    low = torch.as_tensor(low, dtype=torch.float32, device=f01.device)
    high = torch.as_tensor(high, dtype=torch.float32, device=f01.device)
    # separate multiply and add: eager torch never fuses them into an FMA
    prod = f01 * (high - low)
    return prod + low
