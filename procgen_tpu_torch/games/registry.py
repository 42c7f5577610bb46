"""Game registry (reference: procgen/src/game-registry.{h,cpp}).

Games self-register via ``@register(name)``; ``make_game(name, options)``
replaces ``globalGameRegistry->at(name)()``.  The port carries all 16
games: maze, miner, coinrun, fruitbot, starpilot, plunder, leaper, bigfish,
dodgeball, bossfight, climber, ninja, chaser, heist, jumper and caveflyer.
"""

from __future__ import annotations

import importlib

_REGISTRY: dict[str, type] = {}

# modules that register games on import (grown as games are ported)
_GAME_MODULES = ["maze", "miner", "coinrun", "fruitbot", "starpilot", "plunder",
                 "leaper", "bigfish", "dodgeball", "bossfight", "climber", "ninja",
                 "chaser", "heist", "jumper", "caveflyer"]


def register(name: str):
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def _ensure_loaded():
    for mod in _GAME_MODULES:
        importlib.import_module(f".{mod}", __package__)


def available_games() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def make_game(name: str, options):
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown env_name {name!r}; ported: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](options)
