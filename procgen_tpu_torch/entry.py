"""The flagship program: one game (maze by default, or another of
``ENV_NAMES``), easy mode, N envs, frames left on the
device.  ``make_env_fns`` is the counterpart of ``__graft_entry__._make_env_fns`` of the JAX
package, line for line: game logic, pooled auto-reset with the hybrid
per-step replenish, and the 64x64 frame render.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import lifecycle
from .core.constants import EASY_MODE, INT32_MAX
from .core.options import GameOptions
from .games.registry import make_game
from .parallel.vec import Carry, render_batch, step_pool
from .utils.host_mt import HostMT19937


def make_env_fns(num_envs: int, game_name: str = "maze", device="cuda"):
    """(init, step, seeds) on the production path.

    ``init(seeds) -> carry``; ``step(carry, actions) -> (carry, obs, rew,
    done)`` with ``carry`` a ``parallel.vec.Carry`` (states, pool, pool
    validity, step count) and ``obs`` uint8 [N, 64, 64, 3] on ``device``.
    ``device="cuda"`` without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not available")

    game = make_game(game_name, GameOptions(distribution_mode=EASY_MODE))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX

    master = HostMT19937(0)
    seeds = torch.as_tensor(
        np.array([master.next_u32() for _ in range(num_envs)], np.int64),
        device=device,
    )
    k = max(1, min(num_envs, 64))

    def init(seeds):
        states = lifecycle.initial_state(game, seeds)
        states = lifecycle.env_reset(game, states)
        pool = lifecycle.env_reset(game, states)
        valid = torch.ones((num_envs,), dtype=torch.bool, device=device)
        return Carry(states, pool, valid, 0)

    def step(carry, actions):
        carry = step_pool(game, carry, actions.to(device), k)
        obs = render_batch(game, carry.states, 64)
        return carry, obs, carry.states.reward, carry.states.done

    return init, step, seeds
