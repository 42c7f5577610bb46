"""Replay a recorded reference trajectory through the port.

The recordings in tests/data/conformance/*.json come from the C++ engine
(the format tools/conformance.py of the JAX package reads): actions per
step, and per step the rewards, firsts, level seeds, previous-level info
and latents.  ``replay`` steps a ``ProcgenGym3Env`` of the port (on the
card unless ``device="cpu"``; a joint env for a comma-separated
``env_name``) with the recorded actions and returns the first divergence,
or None.  Every comparison is exact.
"""

from __future__ import annotations

import numpy as np

from .env import ProcgenGym3Env


def _exact(got, want) -> bool:
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        return False
    if got.dtype.kind == "f" or want.dtype.kind == "f":
        return bool(np.all(np.float32(got) == np.float32(want)))
    return bool(np.all(got == want))


def _latents_diverge(lat: dict, want: dict, wmax: int, with_exit: bool):
    """First (field, got, want) where one step's latents differ, or None."""
    for e in range(len(want["grid_widths"])):
        w, h = (int(v) for v in lat["grid_size"][e])
        if w != want["grid_widths"][e] or h != want["grid_heights"][e]:
            return ("latent_grid_size", (w, h),
                    (want["grid_widths"][e], want["grid_heights"][e]))
        grid = np.asarray(lat["grid"][e]).reshape(-1, wmax)[:h, :w].reshape(-1)
        if not _exact(grid, want["grids"][e]):
            return ("latent_grid", grid.tolist(), want["grids"][e])
        agent = lat["agent_pos"][e]
        if not _exact(agent, [want["agent_xs"][e], want["agent_ys"][e]]):
            return ("latent_agent_pos", agent.tolist(),
                    [want["agent_xs"][e], want["agent_ys"][e]])
        if with_exit and not _exact(
            lat["exit_pos"][e], [want["exit_xs"][e], want["exit_ys"][e]]
        ):
            return ("latent_exit_pos", lat["exit_pos"][e].tolist(),
                    [want["exit_xs"][e], want["exit_ys"][e]])
    return None


def replay(rec: dict, device="cuda") -> dict:
    """Replay one recording; returns {"steps", "checked",
    "first_divergence"}."""
    actions = np.asarray(rec["actions"], np.int32)
    T, num = actions.shape
    mode = rec.get("distribution_mode", "hard")
    level_kwargs = (
        {} if mode == "exploration" else {
            "num_levels": rec.get("num_levels", 0),
            "start_level": rec.get("start_level", 0),
        }
    )
    env = ProcgenGym3Env(
        num=num, env_name=rec["env_name"], rand_seed=rec["rand_seed"],
        distribution_mode=mode, device=device, **level_kwargs,
        **rec.get("options", {}),
    )
    vec = env._vec
    # joint recordings (a comma-separated env_name) carry no latents
    game = getattr(vec, "game", None)
    wmax = int(game.WORLD_DIM_MAX[0]) if game is not None else 0
    with_exit = rec["env_name"] == "miner"
    result = {"steps": T, "checked": 0, "first_divergence": None}

    def diverge(step, field, got, want):
        result["first_divergence"] = {
            "step": step, "field": field,
            "got": np.asarray(got).tolist(), "want": np.asarray(want).tolist(),
        }
        return result

    def info_np():
        info = vec.observe()[3]
        return {k: v.cpu().numpy() for k, v in info.items()}

    info = info_np()
    if "init_level_seeds" in rec and not _exact(
        info["level_seed"], rec["init_level_seeds"]
    ):
        return diverge(-1, "init_level_seed", info["level_seed"],
                       rec["init_level_seeds"])
    if "init_latents" in rec:
        bad = _latents_diverge(info, rec["init_latents"], wmax, with_exit)
        if bad:
            return diverge(-1, *bad)

    for t in range(T):
        env.act(actions[t])
        rew, _obs, first = env.observe()
        info = info_np()
        checks = [
            ("reward", rew, rec["rewards"][t]),
            ("first", first.astype(bool), rec["firsts"][t]),
            ("level_seed", info["level_seed"], rec["level_seeds"][t]),
        ]
        if "prev_level_seeds" in rec:
            checks.append(("prev_level_seed", info["prev_level_seed"],
                           rec["prev_level_seeds"][t]))
        if "prev_level_completes" in rec:
            checks.append(("prev_level_complete",
                           info["prev_level_complete"].astype(bool),
                           rec["prev_level_completes"][t]))
        for name, got, want in checks:
            if not _exact(got, want):
                return diverge(t, name, got, want)
        if "latents" in rec:
            bad = _latents_diverge(info, rec["latents"][t], wmax, with_exit)
            if bad:
                return diverge(t, *bad)
        result["checked"] = t + 1
    return result
