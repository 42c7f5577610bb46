"""The input domains over which the port's f64 expressions of a draw are
checked: every value ``rand01`` takes, and every speed a starpilot spawner
takes.  ``tools/torch_libm_sweep.py`` holds the port's functions on them
against glibc's, and ``chip_smoke.py`` holds the card against the CPU."""

import numpy as np
import torch


def distinct_rand01() -> torch.Tensor:
    """Every value ``rand01`` takes, ``f32(word) * 2^-32``, ascending, as
    an f32 CPU tensor: the integers below 2^24, each binade's floats from
    2^24 to 2^31, and 2^32 (83,886,081 values)."""
    parts = [torch.arange(1 << 24, dtype=torch.float64)]
    for k in range(24, 32):
        parts.append(2.0**k + torch.arange(1 << 23, dtype=torch.float64) * 2.0**(k - 23))
    parts.append(torch.tensor([2.0**32], dtype=torch.float64))
    return (torch.cat(parts) * 2.0**-32).to(torch.float32)


def spawner_speeds() -> list[float]:
    """Every f32 speed ``v_scale * V_SCALE`` a starpilot spawner takes in
    any mode (starpilot.cpp:259-300): with the headings, the domain of
    ``libm.sincos_times`` in the spawners."""
    from procgen_tpu_torch.core.constants import EASY_MODE, EXTREME_MODE, HARD_MODE
    from procgen_tpu_torch.core.options import GameOptions
    from procgen_tpu_torch.games import starpilot as sp

    f32 = np.float32
    out = set()
    for mode in (EASY_MODE, HARD_MODE, EXTREME_MODE):
        g = sp.Starpilot(GameOptions(distribution_mode=mode))
        for v in [g.hp_vs[t] for t in (sp.FLYER, sp.FAST_FLYER, sp.METEOR, sp.CLOUD,
                                       sp.TURRET)] + [g.hp_slow_v]:
            out.add(float(f32(f32(v) * f32(sp.V_SCALE))))
    return sorted(out)
