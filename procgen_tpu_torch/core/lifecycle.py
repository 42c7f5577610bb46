"""Episode lifecycle: Game::reset / Game::step as batched transitions.

Reference: procgen/src/game.cpp:109-171; JAX counterpart
procgen_tpu/core/lifecycle.py.  Rendering is a separate stage (render
package) and auto-reset is the vector runtime's job (parallel/vec.py).
"""

from __future__ import annotations

import torch

from . import assetgen, rng
from .entities import Entities
from .game import BasicAbstractGame, BasicState, tree_where

f32 = torch.float32
i32 = torch.int32


def initial_state(game: BasicAbstractGame, lsrg_seeds: torch.Tensor) -> BasicState:
    """Freshly constructed Games (ctor defaults, pre-first-reset), one per
    seed in ``lsrg_seeds`` (uint32 values, any int dtype; the tensor's
    device is the state's device)."""
    n = lsrg_seeds.shape[0]
    dev = lsrg_seeds.device
    wmax, hmax = game.WORLD_DIM_MAX

    def full(v, dtype):
        return torch.full((n,), v, dtype=dtype, device=dev)

    return BasicState(
        level_seed_rand_gen=rng.seed(lsrg_seeds),
        rand_gen=rng.unseeded(n, dev),
        current_level_seed=full(0, i32),
        prev_level_seed=full(0, i32),
        episodes_remaining=full(0, i32),
        episode_done=full(False, torch.bool),
        reward=full(0.0, f32),
        done=full(True, torch.bool),  # step_data.done = true at ctor
        level_complete=full(False, torch.bool),
        action=full(0, i32),
        cur_time=full(0, i32),
        last_reward_timer=full(0, i32),
        last_reward=full(-1.0, f32),
        total_reward=full(0.0, f32),
        reset_count=full(0, i32),
        grid=torch.zeros((n, hmax, wmax), dtype=i32, device=dev),
        main_width=full(wmax, i32),
        main_height=full(hmax, i32),
        ents=Entities.zeros(n, game.ENT_CAP, dev),
        bg_pct_x=full(0.0, f32),
        background_index=full(0, i32),
        last_move_action=full(7, i32),  # cpp ctor (:39)
        move_action=full(0, i32),
        special_action=full(0, i32),
        mixrate=full(game.mixrate, f32),
        maxspeed=full(game.maxspeed, f32),
        max_jump=full(game.max_jump, f32),
        action_vx=full(0.0, f32),
        action_vy=full(0.0, f32),
        action_vrot=full(0.0, f32),
        step_rand_int=full(0, i32),
        visibility=full(game.visibility, f32),
        step_draws=full(0, i32),
        decor=Entities.zeros(n, game.DECOR_CAP, dev) if game.DECOR_CAP else None,
        bg_canvas=(
            torch.zeros((n, assetgen.CAN, assetgen.CAN, 3), dtype=torch.uint8,
                        device=dev)
            if game.uses_procgen_background else None
        ),
        frame=(
            torch.zeros((n, 64, 64, 3), dtype=torch.uint8, device=dev)
            if game.static_prefix else None
        ),
        game=game.game_init_state(n, dev),
    )


def env_reset(game: BasicAbstractGame, s: BasicState) -> BasicState:
    """Game::reset (game.cpp:109-134) for every env of the batch."""
    s = s.replace(reset_count=s.reset_count + 1)
    need_new = s.episodes_remaining == 0

    lsr2, drawn = rng.randint(
        s.level_seed_rand_gen, game.level_seed_low, game.level_seed_high
    )
    if game.options.use_sequential_levels:
        take_seq = s.level_complete
        new_seed = torch.where(take_seq, s.current_level_seed + 997, drawn)
        lsr = tree_where(need_new & ~take_seq, lsr2, s.level_seed_rand_gen)
    else:
        new_seed = drawn
        lsr = tree_where(need_new, lsr2, s.level_seed_rand_gen)

    cur = torch.where(need_new, new_seed, s.current_level_seed)
    s = s.replace(
        level_seed_rand_gen=lsr,
        current_level_seed=cur,
        episodes_remaining=torch.where(need_new, 1, s.episodes_remaining).to(i32),
        # the else-branch clears step_data; the new-seed branch keeps it
        # (so the final step's reward survives into observe)
        reward=torch.where(need_new, s.reward, 0.0),
        done=torch.where(need_new, s.done, False),
        level_complete=torch.where(need_new, s.level_complete, False),
        rand_gen=rng.seed(rng.as_u32(cur)),
    )
    s = game.game_reset(s)
    # normalize the stream so env_step's peek pays a single twist
    s = s.replace(rand_gen=rng.normalize(s.rand_gen))
    if game.static_prefix:
        # compose the per-level static render prefix once (bg + grid +
        # colored cells); the per-step render pays only the sprite suffix
        from ..render.renderer import render_obs

        s = s.replace(frame=render_obs(game, s, 64, prefix_only=True))
    return s.replace(
        cur_time=torch.zeros_like(s.cur_time),
        total_reward=torch.zeros_like(s.total_reward),
        episodes_remaining=s.episodes_remaining - 1,
        action=torch.full_like(s.action, game.default_action),
    )


def env_step(game: BasicAbstractGame, s: BasicState, action: torch.Tensor):
    """Game::step (game.cpp:136-171) minus observe.  Returns
    ``(state, needs_reset)``."""
    s = s.replace(action=action.to(i32), cur_time=s.cur_time + 1)
    will_force = s.action == -1
    s = s.replace(
        action=torch.where(will_force, game.default_action, s.action).to(i32),
        reward=torch.zeros_like(s.reward),
        done=torch.zeros_like(s.done),
        level_complete=torch.zeros_like(s.level_complete),
    )

    draws, norm_rg = rng.peek_block(
        s.rand_gen, game.MAX_STEP_DRAWS, assume_normalized=True
    )
    s = s.replace(rand_gen=norm_rg)
    s, draws = game.game_step(s, draws)
    s = s.replace(rand_gen=rng.commit(s.rand_gen, draws), step_draws=draws.cursor)

    done = s.done | will_force | (s.cur_time >= game.timeout)
    s = s.replace(done=done, total_reward=s.total_reward + s.reward)
    got_r = s.reward != 0
    s = s.replace(
        last_reward_timer=torch.where(got_r, 10, s.last_reward_timer).to(i32),
        last_reward=torch.where(got_r, s.reward, s.last_reward),
        prev_level_seed=s.current_level_seed,
    )

    needs_reset = s.done
    if game.options.use_sequential_levels:
        s = s.replace(done=torch.where(s.level_complete, False, s.done))
    s = s.replace(episode_done=s.done)
    return s, needs_reset
