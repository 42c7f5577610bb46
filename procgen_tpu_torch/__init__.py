"""procgen_tpu_torch — the PyTorch and CUDA port of procgen_tpu.

A second package beside the JAX one: the same batched Procgen environments
as eager torch tensors on one device, with the JAX package's per-step
Pallas frame kernel rewritten as CUDA kernels for NVIDIA Hopper:
csrc/render_suffix.cu (the sprite suffix over a cached per-level frame:
maze, leaper, bigfish, and plunder, dodgeball and bossfight with their
decor pools) and csrc/render_frame.cu (the whole frame of a game that is
not static: miner, coinrun, fruitbot, starpilot, climber, ninja, chaser,
heist, jumper, caveflyer, memory mode); csrc/assetgen_bg.cu paints the
generated-assets background at the reset.  It imports torch and
numpy, never jax or procgen_tpu.  The entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.  It covers
all sixteen games in every distribution mode, generated and monochrome
assets, the gym3 surface with get_state / set_state, ``render_mode=
"rgb_array"`` and joint games; ROADMAP.md lists what comes next.
"""

__version__ = "0.1.0"

ENV_NAMES = ["maze", "miner", "coinrun", "fruitbot", "starpilot", "plunder", "leaper",
             "bigfish", "dodgeball", "bossfight", "climber", "ninja", "chaser", "heist",
             "jumper", "caveflyer"]

# Python-only "exploration" distribution mode fixes one hard level
# (reference: procgen/env.py:52-61).
EXPLORATION_LEVEL_SEEDS = {
    "coinrun": 1949448038,
    "caveflyer": 1259048185,
    "leaper": 1318677581,
    "jumper": 1434825276,
    "maze": 158988835,
    "heist": 876640971,
    "climber": 1561126160,
    "ninja": 1123500215,
}

DISTRIBUTION_MODE_DICT = {
    "easy": 0,
    "hard": 1,
    "extreme": 2,
    "memory": 10,
    "exploration": 20,
}

from .env import ProcgenGym3Env, ProcgenEnv  # noqa: E402,F401
