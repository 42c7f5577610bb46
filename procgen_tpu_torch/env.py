"""User-facing vectorized env API (reference: procgen/env.py); the
counterpart of ``procgen_tpu.env``, with a ``device=`` keyword that
defaults to ``"cuda"`` (without a card construction raises; pass
``device="cpu"`` to run on the CPU).  ``ProcgenGym3Env`` mirrors the gym3
surface: observe / act / get_info / keys_to_act, get_state / set_state
(per-env state blobs, byte-compatible with the JAX package's), callmethod
``get_state`` / ``set_state`` / ``set_latent_state``, ``render_mode=
"rgb_array"`` (the 512x512 frame in ``info["rgb"]``) and joint games (a
comma-separated ``env_name``; env n runs game n % k).  ``ProcgenEnv`` is
the baselines-VecEnv-style wrapper.  The games that force the static
camera (plunder, leaper, bigfish, bossfight, chaser) keep it under the
gym3 default ``center_agent=True``.  Not ported: the multi-device mesh
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

import numpy as np

from .core.options import VecOptions, parse_game_options
from .games.registry import make_game
from .parallel.vec import JointTorchVecGame, TorchVecGame


def create_random_seed():
    """env.py:73-82 (single process)."""
    return random.SystemRandom().randint(0, 2**31 - 1)


def get_combos():
    """env.py:179-196."""
    return [
        ("LEFT", "DOWN"),
        ("LEFT",),
        ("LEFT", "UP"),
        ("DOWN",),
        (),
        ("UP",),
        ("RIGHT", "DOWN"),
        ("RIGHT",),
        ("RIGHT", "UP"),
        ("D",),
        ("A",),
        ("W",),
        ("S",),
        ("Q",),
        ("E",),
    ]


class BaseProcgenEnv:
    """env.py:85-226 equivalent over the torch vec runtime."""

    def __init__(
        self,
        num,
        env_name,
        options,
        debug=False,
        rand_seed=None,
        num_levels=0,
        start_level=0,
        use_sequential_levels=False,
        debug_mode=0,
        resource_root=None,
        num_threads=4,  # accepted for API parity
        render_mode=None,
        device="cuda",
    ):
        self.combos = self.get_combos()
        self.num = num
        self.env_name = env_name
        if render_mode is None:
            render_human = False
        elif render_mode == "rgb_array":
            render_human = True
        else:
            raise ValueError(f"invalid render mode {render_mode}")
        if rand_seed is None:
            rand_seed = create_random_seed()

        options = dict(options)
        options.update(
            {
                "use_sequential_levels": bool(use_sequential_levels),
                "debug_mode": debug_mode,
            }
        )
        games = []
        for name in env_name.split(","):  # joint-game mode (vecgame.cpp:343-347)
            opts = VecOptions(dict(options))
            game_options, game_type = parse_game_options(name, opts)
            game = make_game(name, game_options)
            game.game_type = game_type
            games.append(game)
        kw = dict(rand_seed=rand_seed, num_levels=num_levels,
                  start_level=start_level, render_human=render_human, device=device)
        if len(games) == 1:
            self._vec = TorchVecGame(num=num, game=games[0], **kw)
        else:
            self._vec = JointTorchVecGame(num=num, games=games, **kw)
        self.options = options

    # -- gym3 surface -------------------------------------------------------

    def observe(self):
        obs, rew, first, _ = self._vec.observe()
        return (
            rew.cpu().numpy(),
            {"rgb": obs.cpu().numpy()},
            first.cpu().numpy(),
        )

    def act(self, ac):
        ac = np.asarray(ac)
        if ac.dtype.kind not in "iu":
            raise TypeError("actions must be integers")
        self._vec.act(ac.astype(np.int32))

    def get_info(self):
        _, _, _, info = self._vec.observe()
        info = {k: v.cpu().numpy() for k, v in info.items()}
        return [{k: v[i] for k, v in info.items()} for i in range(self.num)]

    def callmethod(self, method: str, *args):
        if method == "get_state":
            return self.get_state()
        if method == "set_state":
            return self.set_state(*args)
        if method == "set_latent_state":
            return self._vec.set_latent_state(*args)
        raise AttributeError(f"unknown method {method}")

    # -- checkpointing ------------------------------------------------------

    def get_state(self):
        """Per-env opaque state blobs (utils/serialization.py)."""
        return self._vec.get_state_blobs()

    def set_state(self, states):
        if len(states) != self.num:
            raise ValueError(f"need {self.num} state blobs, got {len(states)}")
        self._vec.set_state_blobs(states)

    def get_combos(self):
        return get_combos()

    def keys_to_act(
        self, keys_list: Sequence[Sequence[str]]
    ) -> List[Optional[np.ndarray]]:
        """env.py:198-221: longest fully-pressed combo wins."""
        result = []
        for keys in keys_list:
            action = None
            max_len = -1
            for i, combo in enumerate(self.get_combos()):
                pressed = all(key in keys for key in combo)
                if pressed and (max_len < len(combo)):
                    action = i
                    max_len = len(combo)
            if action is not None:
                action = np.array([action])
            result.append(action)
        return result


class ProcgenGym3Env(BaseProcgenEnv):
    """env.py:229-273."""

    def __init__(
        self,
        num,
        env_name,
        center_agent=True,
        use_backgrounds=True,
        use_monochrome_assets=False,
        restrict_themes=False,
        use_generated_assets=False,
        paint_vel_info=False,
        distribution_mode="hard",
        **kwargs,
    ):
        from . import DISTRIBUTION_MODE_DICT, EXPLORATION_LEVEL_SEEDS

        assert distribution_mode in DISTRIBUTION_MODE_DICT, (
            f'"{distribution_mode}" is not a valid distribution mode.'
        )
        if distribution_mode == "exploration":
            assert env_name in EXPLORATION_LEVEL_SEEDS, (
                f"{env_name} does not support exploration mode"
            )
            distribution_mode = DISTRIBUTION_MODE_DICT["hard"]
            assert "num_levels" not in kwargs
            kwargs["num_levels"] = 1
            assert "start_level" not in kwargs
            kwargs["start_level"] = EXPLORATION_LEVEL_SEEDS[env_name]
        else:
            distribution_mode = DISTRIBUTION_MODE_DICT[distribution_mode]

        options = {
            "center_agent": bool(center_agent),
            "use_generated_assets": bool(use_generated_assets),
            "use_monochrome_assets": bool(use_monochrome_assets),
            "restrict_themes": bool(restrict_themes),
            "use_backgrounds": bool(use_backgrounds),
            "paint_vel_info": bool(paint_vel_info),
            "distribution_mode": distribution_mode,
        }
        super().__init__(num, env_name, options, **kwargs)


class _ToBaselinesVecEnv:
    """Minimal baselines-VecEnv adapter (env.py:276-290)."""

    metadata = {
        "render.modes": ["human", "rgb_array"],
        "video.frames_per_second": 15,
    }

    def __init__(self, env: BaseProcgenEnv):
        self.env = env
        self.num_envs = env.num
        self._last_ac = None

    def reset(self):
        _, ob, _ = self.env.observe()
        return ob

    def step_async(self, actions):
        self._last_ac = actions

    def step_wait(self):
        self.env.act(self._last_ac)
        rew, ob, first = self.env.observe()
        infos = self.env.get_info()
        return ob, rew, first, infos

    def step(self, actions):
        self.step_async(actions)
        return self.step_wait()

    def render(self, mode="human"):
        info = self.env.get_info()[0]
        _, ob, _ = self.env.observe()
        if mode == "rgb_array":
            if "rgb" in info:
                return info["rgb"]
            return ob["rgb"][0]

    def close(self):
        pass


def ProcgenEnv(num_envs, env_name, **kwargs):
    return _ToBaselinesVecEnv(
        ProcgenGym3Env(num=num_envs, env_name=env_name, **kwargs)
    )
