"""Vectorized env runtime: N lockstep envs of one game as torch tensors.

The counterpart of ``procgen_tpu.parallel.vec``.  A step is
``env_step`` over the whole batch, the auto-reset of finished envs, and
the frame render.  Level generation is the expensive part of a reset, so
finished envs consume a precomputed next-level state from a pool (a
select), and the pool is replenished at most one K-wide chunk per step
(the hybrid pacing of the JAX package).  Where JAX branches on device
(``lax.cond``/``while_loop``), the port reads the condition on the host:
one synchronisation per decision.  ``JointTorchVecGame`` runs several
games round-robin over one batch (env n runs game n % k).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import lifecycle
from ..core.constants import INT32_MAX, fnv1a_32
from ..core.game import BasicAbstractGame, tree_map, tree_where
from ..utils.host_mt import HostMT19937

i32 = torch.int32

# replenish backstop period of the hybrid pacing (procgen_tpu/parallel/
# vec.py:282, :352-368)
REPLENISH_BACKSTOP = 8


def render_batch(game, states, res: int = 64):
    """Batched observation render: the frame kernel's path (CUDA kernel on
    CUDA states, its plain version on CPU states)."""
    from ..render import render_kernel

    return render_kernel.render_obs_batch(game, states, res)


# the human-view frame of render_mode="rgb_array" (procgen_tpu/parallel/
# vec.py:436-439), rendered by the plain renderer a chunk of envs at a time:
# its f32 canvases take 4 MiB an env for each z level and pool
HIRES = 512
HIRES_CHUNK = 16


def render_hires(game, states):
    """uint8 [N, 512, 512, 3]: ``renderer.render_obs`` of the whole frame
    (no cached prefix), ``HIRES_CHUNK`` envs at a time, as the JAX package
    renders ``info["rgb"]`` with XLA's ``render_obs(game, s, 512)``."""
    from ..render.renderer import render_obs

    return torch.cat([
        render_obs(game, tree_map(lambda a: a[lo:lo + HIRES_CHUNK], states), HIRES)
        for lo in range(0, states.num, HIRES_CHUNK)
    ])


def _tree_gather(tree, idx):
    return tree_map(lambda a: a[idx], tree)


def _tree_scatter(tree, idx, sub):
    def put(a, b):
        a = a.clone()
        a[idx] = b
        return a

    return tree_map(put, tree, sub)


def reset_pending(game: BasicAbstractGame, states, pending):
    """Reset envs where ``pending``.  ``env_reset`` is per-env pure, so
    resetting the pending envs as one sub-batch gives what the JAX
    package's K-at-a-time loop gives."""
    idx = torch.nonzero(pending).flatten()
    if idx.numel() == 0:
        return states
    sub = lifecycle.env_reset(game, _tree_gather(states, idx))
    return _tree_scatter(states, idx, sub)


# Fields whose post-reset value comes from the FINISHING step's state, not
# from the precomputed next-level state (procgen_tpu/parallel/vec.py:
# 115-141): Game::reset keeps step_data on the new-seed branch and never
# touches the episode-crossing bookkeeping.
_KEEP_LIVE_ON_RESET = (
    "reward",
    "done",
    "step_draws",
    "level_complete",
    "episode_done",
    "prev_level_seed",
    "last_reward",
    "last_reward_timer",
    "last_move_action",
    "move_action",
    "special_action",
    "action_vx",
    "action_vy",
    "action_vrot",
    "step_rand_int",
)


def splice_pool(pool, states):
    """The post-reset state an env gets from its precomputed pool entry:
    everything from the pool except the episode-crossing fields."""
    return pool.replace(**{f: getattr(states, f) for f in _KEEP_LIVE_ON_RESET})


def replenish_pool(game: BasicAbstractGame, states, pool, valid, k: int,
                   max_iters: Optional[int] = None):
    """Rebuild next-level pool entries for invalid slots, K at a time (at
    most ``max_iters`` chunks): each chunk is the first K invalid slots in
    env order, rebuilt from the live states."""
    it = 0
    while max_iters is None or it < max_iters:
        inval = torch.nonzero(~valid).flatten()
        if inval.numel() == 0:
            break
        idx = inval[:k]
        new_sub = lifecycle.env_reset(game, _tree_gather(states, idx))
        pool = _tree_scatter(pool, idx, new_sub)
        valid = valid.clone()
        valid[idx] = True
        it += 1
    return pool, valid


@dataclasses.dataclass
class Carry:
    """The step carry of the pooled runtime: live states, next-level pool,
    pool validity and the step counter (a host int)."""

    states: object
    pool: object
    valid: Optional[torch.Tensor]
    t: int


def step_pool(game, carry: Carry, actions, k: int):
    """One pooled step (procgen_tpu/parallel/vec.py step_pool_core and
    __graft_entry__._make_env_fns): logic, pool consumption, in-step
    resets for pool misses, the hybrid replenish.  Returns the new carry;
    rendering is the caller's."""
    states, needs_reset = lifecycle.env_step(game, carry.states, actions)
    use = needs_reset & carry.valid
    states = tree_where(use, splice_pool(carry.pool, states), states)
    valid = carry.valid & ~needs_reset
    states = reset_pending(game, states, needs_reset & ~use)
    t = carry.t
    due = (t % REPLENISH_BACKSTOP) == REPLENISH_BACKSTOP - 1 or bool(
        (~valid).sum() >= k
    )
    pool = carry.pool
    if due:
        pool, valid = replenish_pool(game, states, pool, valid, k, max_iters=1)
    return Carry(states, pool, valid, t + 1)


class TorchVecGame:
    """N lockstep envs of one game on one torch device; the counterpart of
    ``procgen_tpu.parallel.vec.JaxVecGame`` (no mesh).  ``render_human``
    adds the 512x512 frame ``info["rgb"]``; ``seed_values`` gives the
    per-env level-seed generator seeds (joint mode) in place of the master
    stream."""

    def __init__(
        self,
        num: int,
        game: BasicAbstractGame,
        rand_seed: int,
        num_levels: int = 0,
        start_level: int = 0,
        render_human: bool = False,
        seed_values=None,
        device="cuda",
    ):
        self.num = num
        self.game = game
        self.render_human = render_human
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not available")

        # level seed range (vecgame.cpp:330-341)
        if num_levels == 0:
            game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        else:
            game.level_seed_low = start_level
            game.level_seed_high = start_level + num_levels
        if game.fixed_asset_seed == 0:
            game.fixed_asset_seed = int(np.int32(np.uint32(fnv1a_32(game.name))))

        # per-env level_seed_rand_gen seeds from the master stream
        # (vecgame.cpp:349-363), or the joint wrapper's interleaved slice
        # of it
        if seed_values is not None:
            seeds = np.asarray(seed_values, np.uint32).astype(np.int64)
            if seeds.shape != (num,):
                raise ValueError(f"seed_values must have shape ({num},), got {seeds.shape}")
        else:
            master = HostMT19937(rand_seed)
            seeds = np.array([master.next_u32() for _ in range(num)], np.int64)
        self._k = max(1, min(num, 64))
        self._use_pool = not game.options.use_sequential_levels

        states = lifecycle.initial_state(game, torch.as_tensor(seeds, device=self.device))
        states = lifecycle.env_reset(game, states)
        self.carry = Carry(states, None, None, 0)
        self._rebuild_pool()

    @property
    def states(self):
        return self.carry.states

    def _rebuild_pool(self) -> None:
        """The next-level pool from the live states, every slot valid
        (init and state restore; procgen_tpu/parallel/vec.py:572-574); the
        cached observation is dropped."""
        if self._use_pool:
            pool = lifecycle.env_reset(self.game, self.carry.states)
            valid = torch.ones((self.num,), dtype=torch.bool, device=self.device)
        else:
            pool = valid = None
        self.carry = dataclasses.replace(self.carry, pool=pool, valid=valid)
        self._cached = None
        self._cached_for = None

    def _info_impl(self, states):
        info = {
            "prev_level_seed": states.prev_level_seed,
            "prev_level_complete": states.level_complete.to(torch.uint8),
            "level_seed": states.current_level_seed,
        }
        if hasattr(self.game, "latent_info"):
            info.update(self.game.latent_info(states))
        if self.render_human:
            info["rgb"] = render_hires(self.game, states)
        return info

    def _observe_impl(self, states):
        obs = render_batch(self.game, states, 64)
        return obs, states.reward, states.done, self._info_impl(states)

    def act(self, actions) -> None:
        actions = torch.as_tensor(actions, dtype=i32, device=self.device)
        if actions.shape != (self.num,):
            raise ValueError(
                f"actions must have shape ({self.num},), got {tuple(actions.shape)}"
            )
        if self._use_pool:
            self.carry = step_pool(self.game, self.carry, actions, self._k)
        else:
            states, needs_reset = lifecycle.env_step(self.game, self.carry.states, actions)
            states = reset_pending(self.game, states, needs_reset)
            self.carry = Carry(states, None, None, self.carry.t + 1)
        self._cached = self._observe_impl(self.carry.states)
        self._cached_for = self.carry.states

    def observe(self):
        """(obs uint8 [N, 64, 64, 3], reward, done, info) of the current
        states, as device tensors."""
        if self._cached is None or self._cached_for is not self.carry.states:
            self._cached = self._observe_impl(self.carry.states)
            self._cached_for = self.carry.states
        return self._cached

    def set_latent_state(self, latents: list) -> None:
        """Apply per-env latent-state dicts (games with game_set_state:
        miner, miner.cpp:423-449); the counterpart of
        ``JaxVecGame.set_latent_state``.  The pool is left as it is."""
        if not hasattr(self.game, "set_latent_state"):
            raise AttributeError(
                f"{self.game.name} does not support set_latent_state"
            )
        if len(latents) != self.num:
            raise ValueError(f"need {self.num} latent dicts, got {len(latents)}")
        batched = {
            k: torch.as_tensor(np.stack([np.asarray(l[k]) for l in latents]),
                               device=self.device)
            for k in latents[0]
        }
        states = self.game.set_latent_state(self.carry.states, batched)
        self.carry = dataclasses.replace(self.carry, states=states)

    def _check_rollout(self, actions):
        actions = torch.as_tensor(actions, dtype=i32, device=self.device)
        if actions.dim() != 2 or actions.shape[1] != self.num:
            raise ValueError(
                f"actions must have shape (k, {self.num}), got {tuple(actions.shape)}"
            )
        return actions

    def rollout(self, actions):
        """Step ``k`` times (``actions`` [k, num]); returns (obs, rew,
        first) stacked [k, num, ...]."""
        outs = []
        for a in self._check_rollout(actions):
            self.act(a)
            outs.append(self._cached[:3])
        return tuple(torch.stack(x) for x in zip(*outs))

    def rollout_full(self, actions):
        """``rollout`` with the info dicts: (obs, rew, first, info) stacked
        [k, num, ...], equal to ``k`` ``act()`` + ``observe()`` calls
        (procgen_tpu/parallel/vec.py:526-550)."""
        outs = []
        for a in self._check_rollout(actions):
            self.act(a)
            outs.append(self._cached)
        obs, rew, first, infos = zip(*outs)
        info = {k: torch.stack([inf[k] for inf in infos]) for k in infos[0]}
        return torch.stack(obs), torch.stack(rew), torch.stack(first), info

    # -- checkpointing (procgen_tpu/parallel/vec.py:564-585) -----------------

    def get_state_pytree(self):
        """The live states, copied to the host."""
        return tree_map(lambda a: a.cpu(), self.carry.states)

    def set_state_pytree(self, states) -> None:
        """Restore the live states; the pool is derived state and is
        rebuilt from them."""
        states = tree_map(lambda a: a.to(self.device), states)
        self.carry = dataclasses.replace(self.carry, states=states)
        self._rebuild_pool()

    def get_state_blobs(self) -> list:
        from ..utils import serialization

        return serialization.states_to_bytes(self.carry.states)

    def set_state_blobs(self, blobs) -> None:
        from ..utils import serialization

        self.set_state_pytree(serialization.states_from_bytes(blobs, self.carry.states))


def interleave(parts):
    """Round-robin join on the device: ``parts[g]`` holds the envs of game
    g ([num // k, ...]); env n of the result is env n // k of game n % k."""
    st = torch.stack(parts, dim=1)
    return st.reshape((-1,) + st.shape[2:])


def _pad_union_infos(infos):
    """Per-game info dicts merged into the union of keys with fixed shapes
    (procgen_tpu/parallel/vec.py:604-634): the reference declares one
    tensortype set for the whole joint batch (vecgame.cpp:270-330), so a
    game without a key gives zeros and smaller latents are zero-padded up
    to the elementwise-largest shape."""
    keys = sorted({kk for inf in infos for kk in inf})
    out = {}
    for kk in keys:
        present = [inf[kk] for inf in infos if kk in inf]
        target = tuple(
            max(v.shape[1 + d] for v in present)
            for d in range(present[0].dim() - 1)
        )
        ref = present[0]
        parts = []
        for inf in infos:
            if kk in inf:
                v = inf[kk]
                pad = torch.zeros((v.shape[0],) + target, dtype=ref.dtype,
                                  device=v.device)
                pad[(slice(None),) + tuple(slice(0, s) for s in v.shape[1:])] = v
                parts.append(pad)
            else:
                n_sub = next(iter(inf.values())).shape[0]
                parts.append(torch.zeros((n_sub,) + target, dtype=ref.dtype,
                                         device=ref.device))
        out[kk] = interleave(parts)
    return out


class JointTorchVecGame:
    """Round-robin joint-game vec env (vecgame.cpp:343-363): env n runs
    ``games[n % k]``.  The per-env level-seed generators are seeded from one
    master stream drawn in global env order, as a single-game batch's
    would be, so env n's levels do not depend on k.  The sub-games are
    stepped in turn and their results interleaved on the device; the
    counterpart of ``procgen_tpu.parallel.vec.JointJaxVecGame``."""

    def __init__(
        self,
        num: int,
        games: list,
        rand_seed: int,
        num_levels: int = 0,
        start_level: int = 0,
        render_human: bool = False,
        device="cuda",
    ):
        k = len(games)
        if num % k != 0:
            raise ValueError(
                f"num_envs ({num}) must be divisible by the number of joint "
                f"games ({k})"  # vecgame.cpp:347
            )
        self.num = num
        self.k = k
        self.device = torch.device(device)
        master = HostMT19937(rand_seed)
        seeds = np.array([master.next_u32() for _ in range(num)], np.uint32)
        self.subs = [
            TorchVecGame(
                num=num // k, game=g, rand_seed=0, num_levels=num_levels,
                start_level=start_level, render_human=render_human,
                seed_values=seeds[gi::k], device=device,
            )
            for gi, g in enumerate(games)
        ]
        self._cached = None
        self._cached_for = None

    def act(self, actions) -> None:
        actions = torch.as_tensor(actions, dtype=i32, device=self.device)
        if actions.shape != (self.num,):
            raise ValueError(
                f"actions must have shape ({self.num},), got {tuple(actions.shape)}"
            )
        for gi, sub in enumerate(self.subs):
            sub.act(actions[gi::self.k])

    def observe(self):
        """The sub-games' (obs, reward, done, info) interleaved, the info
        the union of their keys."""
        live = [sub.carry.states for sub in self.subs]
        if self._cached is None or any(
            a is not b for a, b in zip(live, self._cached_for)
        ):
            results = [sub.observe() for sub in self.subs]
            obs, rew, first = (interleave([r[i] for r in results]) for i in range(3))
            info = _pad_union_infos([r[3] for r in results])
            self._cached = (obs, rew, first, info)
            self._cached_for = live
        return self._cached

    def set_latent_state(self, latents: list) -> None:
        if len(latents) != self.num:
            raise ValueError(f"need {self.num} latent dicts, got {len(latents)}")
        for gi, sub in enumerate(self.subs):
            sub.set_latent_state(latents[gi::self.k])
        self._cached = None

    def get_state_blobs(self) -> list:
        out = [None] * self.num
        for gi, sub in enumerate(self.subs):
            out[gi::self.k] = sub.get_state_blobs()
        return out

    def set_state_blobs(self, blobs) -> None:
        blobs = list(blobs)
        if len(blobs) != self.num:
            raise ValueError(f"need {self.num} state blobs, got {len(blobs)}")
        for gi, sub in enumerate(self.subs):
            sub.set_state_blobs(blobs[gi::self.k])
        self._cached = None
