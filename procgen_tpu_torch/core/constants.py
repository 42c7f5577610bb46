"""Shared constants (reference: procgen/src/object-ids.h, game.h:25-39,
basic-abstract-game.cpp:6-20).

A copy of ``procgen_tpu.core.constants``; tests/test_torch_host.py holds the
two equal."""

# Observation space — constants forever (game.h:25-28).
RES_W = 64
RES_H = 64
RENDER_RES = 512

# Object ids (object-ids.h).
INVALID_OBJ = -1
INVALID_IDX = -2
PLAYER = 0
SPACE = 100
WALL_OBJ = 51
EXIT_OBJ = 52
AGENT_OBJ = 53
EXPLOSION = 54
EXPLOSION2 = 55
EXPLOSION3 = 56
EXPLOSION4 = 57
EXPLOSION5 = 58
TRAIL = 59
DOOR_OBJ = 200
KEY_OBJ = 300

# Distribution modes (game.h:34-39).
EASY_MODE = 0
HARD_MODE = 1
EXTREME_MODE = 2
MEMORY_MODE = 10

# Physics / render tuning (basic-abstract-game.cpp:6-20).
MAXVTHETA = 15 * 3.14159265358979323846 / 180
MIXRATEROT = 0.5
POS_EPS = -0.001
RENDER_EPS = 0.02
USE_ASSET_THRESHOLD = 100
MAX_ASSETS = USE_ASSET_THRESHOLD
MAX_IMAGE_THEMES = 10

SERIALIZE_VERSION = 0
MAX_STATE_SIZE = 2**20  # env.py:13
END_OF_BUFFER = 0xCAFECAFE  # vecgame.cpp:6
INT32_MAX = 2**31 - 1


def fnv1a_32(s: str) -> int:
    """System-independent string hash used for fixed_asset_seed
    (vecgame.cpp:156-167)."""
    h = 0x811C9DC5
    for ch in s.encode():
        h = (h ^ ch) * 0x01000193 % (1 << 32)
    return h
