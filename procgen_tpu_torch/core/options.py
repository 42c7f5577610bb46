"""Static per-env-instance configuration.

Mirrors GameOptions (game.h:47-62) + the VecOptions consume-and-fail-on-
unknown semantics (vecoptions.cpp:49-81): every option passed by the user
must be consumed by exactly one consumer, otherwise construction fails.

A copy of ``procgen_tpu.core.options`` (tests/test_torch_host.py holds the
two equal).  Options are static per game instance: branches on them are
plain Python ``if``s in the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .constants import EASY_MODE, EXTREME_MODE, HARD_MODE, MEMORY_MODE


@dataclasses.dataclass(frozen=True)
class GameOptions:
    paint_vel_info: bool = False
    use_generated_assets: bool = False
    use_monochrome_assets: bool = False
    restrict_themes: bool = False
    use_backgrounds: bool = True
    center_agent: bool = False
    debug_mode: int = 0
    distribution_mode: int = HARD_MODE
    use_sequential_levels: bool = False
    # coinrun_old compat (game.h:58-61)
    use_easy_jump: bool = False
    plain_assets: int = 0
    physics_mode: int = 0


class VecOptions:
    """Typed option dict with consume semantics (vecoptions.cpp:49-81)."""

    def __init__(self, opts: dict[str, Any]):
        self._opts = dict(opts)

    def consume_bool(self, name: str, default: bool) -> bool:
        return bool(self._consume(name, default))

    def consume_int(self, name: str, default: int) -> int:
        return int(self._consume(name, default))

    def consume_float(self, name: str, default: float) -> float:
        return float(self._consume(name, default))

    def consume_string(self, name: str, default: str) -> str:
        return str(self._consume(name, default))

    def _consume(self, name, default):
        if name in self._opts:
            return self._opts.pop(name)
        return default

    def ensure_empty(self):
        if self._opts:
            raise ValueError(
                f"unused options: {sorted(self._opts)} — every option must be "
                "consumed (vecoptions.cpp:75-81 semantics)"
            )


def parse_game_options(name: str, opts: VecOptions) -> tuple[GameOptions, int]:
    """Game::parse_options (game.cpp:62-95).  Returns (options, game_type)."""
    o = GameOptions(
        use_easy_jump=opts.consume_bool("use_easy_jump", False),
        paint_vel_info=opts.consume_bool("paint_vel_info", False),
        use_generated_assets=opts.consume_bool("use_generated_assets", False),
        use_monochrome_assets=opts.consume_bool("use_monochrome_assets", False),
        restrict_themes=opts.consume_bool("restrict_themes", False),
        use_backgrounds=opts.consume_bool("use_backgrounds", True),
        center_agent=opts.consume_bool("center_agent", False),
        use_sequential_levels=opts.consume_bool("use_sequential_levels", False),
        distribution_mode=opts.consume_int("distribution_mode", EASY_MODE),
        plain_assets=opts.consume_int("plain_assets", 0),
        physics_mode=opts.consume_int("physics_mode", 0),
        debug_mode=opts.consume_int("debug_mode", 0),
    )
    game_type = opts.consume_int("game_type", 0)

    mode = o.distribution_mode
    if mode == EASY_MODE:
        assert name != "coinrun_old"
    elif mode == HARD_MODE:
        pass
    elif mode == EXTREME_MODE:
        assert name in ("chaser", "dodgeball", "leaper", "starpilot"), (
            f"{name} does not support extreme mode"
        )
    elif mode == MEMORY_MODE:
        assert name in (
            "caveflyer", "dodgeball", "heist", "jumper", "maze", "miner"
        ), f"{name} does not support memory mode"
    else:
        raise ValueError(f"invalid distribution_mode {mode}")

    opts.ensure_empty()
    return o, game_type
