"""Lossless state bridge between the JAX package and the port.

The JAX package's state, as ``flax.serialization.to_state_dict`` gives it
for a batched ``BasicState`` after ``np.asarray`` on every leaf, is a
nested dict of numpy arrays keyed by field name.  ``state_from_numpy``
turns it into the port's ``BasicState`` on a device and
``state_to_numpy`` turns the port's state back into the same dict.  The
only dtype that differs is the mt19937 word: uint32 in JAX, int64 words
below 2**32 in the port.  This bridge and atlases baked from the same
asset artifact are everything the two packages share at run time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.entities import Entities
from .core.game import BasicState
from .core.rng import MTState


def _to_torch(v, device):
    if v is None:
        return None
    a = np.array(v)  # a writable copy
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def _build(cls, d: dict, device):
    return cls(**{
        f.name: _to_torch(d[f.name], device) for f in dataclasses.fields(cls)
    })


def _build_like(template, d, device):
    """``d`` in the shape of ``template``: a dataclass's fields built
    recursively (a game state may hold an entity pool, as starpilot's
    spawners), tensors from their arrays."""
    if not dataclasses.is_dataclass(template):
        return _to_torch(d, device)
    return type(template)(**{
        f.name: _build_like(getattr(template, f.name), d[f.name], device)
        for f in dataclasses.fields(template)
    })


def state_from_numpy(tree: dict, game, device="cpu") -> BasicState:
    """The port's batched state from the JAX package's state dict."""
    kw = {}
    for f in dataclasses.fields(BasicState):
        v = tree[f.name]
        if f.name in ("level_seed_rand_gen", "rand_gen"):
            kw[f.name] = _build(MTState, v, device)
        elif f.name in ("ents", "decor"):
            kw[f.name] = None if v is None else _build(Entities, v, device)
        elif f.name == "game":
            if v is None:
                kw[f.name] = None
            else:
                n = np.asarray(tree["reward"]).shape[0]
                kw[f.name] = _build_like(game.game_init_state(n, "cpu"), v, device)
        else:
            kw[f.name] = _to_torch(v, device)
    return BasicState(**kw)


def _to_numpy(v, field_name: str = ""):
    if v is None:
        return None
    if dataclasses.is_dataclass(v):
        return {
            f.name: _to_numpy(getattr(v, f.name), f.name)
            for f in dataclasses.fields(v)
        }
    a = v.detach().cpu().numpy()
    if field_name == "mt":
        a = a.astype(np.uint32)
    return a


def state_to_numpy(state: BasicState) -> dict:
    """The JAX package's state dict (numpy leaves) from the port's state."""
    return _to_numpy(state)
