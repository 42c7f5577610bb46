"""Entity storage as a fixed-capacity structure-of-arrays, batch-first.

The counterpart of ``procgen_tpu.core.entities``: every field is an
``[N, cap]`` tensor, slots ``[0, count)`` are live and keep the C++ vector
order (the agent is slot 0), and erase is a stable compaction.  The field
order is the JAX package's; the state bridge (bridge.py) relies on it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .constants import EXPLOSION, EXPLOSION5, TRAIL

f32 = torch.float32
i32 = torch.int32

FLOAT_FIELDS = (
    "x", "y", "vx", "vy", "rx", "ry", "collision_margin", "rotation", "vrot",
    "friction", "alpha", "health", "theta", "grow_rate", "alpha_decay",
    "climber_spawn_x",
)
INT_FIELDS = (
    "type", "image_type", "image_theme", "render_z", "fire_time",
    "spawn_time", "life_time", "expire_time",
)
BOOL_FIELDS = (
    "will_erase", "collides_with_entities", "is_reflected", "use_abs_coords",
    "smart_step", "avoids_collisions", "auto_erase",
)
SLOT_FIELDS = FLOAT_FIELDS + INT_FIELDS + BOOL_FIELDS


def _dtype(name: str):
    if name in FLOAT_FIELDS:
        return f32
    if name in INT_FIELDS:
        return i32
    return torch.bool


@dataclasses.dataclass
class Entities:
    # float fields (entity.h:9-48)
    x: torch.Tensor
    y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    rx: torch.Tensor
    ry: torch.Tensor
    collision_margin: torch.Tensor
    rotation: torch.Tensor
    vrot: torch.Tensor
    friction: torch.Tensor
    alpha: torch.Tensor
    health: torch.Tensor
    theta: torch.Tensor
    grow_rate: torch.Tensor
    alpha_decay: torch.Tensor
    climber_spawn_x: torch.Tensor
    # int fields
    type: torch.Tensor
    image_type: torch.Tensor
    image_theme: torch.Tensor
    render_z: torch.Tensor
    fire_time: torch.Tensor
    spawn_time: torch.Tensor
    life_time: torch.Tensor
    expire_time: torch.Tensor
    # bool fields
    will_erase: torch.Tensor
    collides_with_entities: torch.Tensor
    is_reflected: torch.Tensor
    use_abs_coords: torch.Tensor
    smart_step: torch.Tensor
    avoids_collisions: torch.Tensor
    auto_erase: torch.Tensor
    # slot bookkeeping
    count: torch.Tensor  # int32 [N]; live slots are [0, count)

    def replace(self, **kw) -> "Entities":
        return dataclasses.replace(self, **kw)

    @property
    def cap(self) -> int:
        return self.x.shape[1]

    @property
    def active(self) -> torch.Tensor:
        slots = torch.arange(self.cap, device=self.x.device)
        return slots[None, :] < self.count[:, None]

    # -- construction -------------------------------------------------------

    @classmethod
    def zeros(cls, n: int, cap: int, device) -> "Entities":
        fields = {
            k: torch.zeros((n, cap), dtype=_dtype(k), device=device)
            for k in SLOT_FIELDS
        }
        return cls(count=torch.zeros((n,), dtype=i32, device=device), **fields)

    # -- slot updates -------------------------------------------------------

    def set_fields(self, slot: int, **fields) -> "Entities":
        """Write fields of one (static) slot in every env; values are
        scalars or ``[N]`` tensors."""
        return self.set_fields_where(slot, None, **fields)

    def set_fields_where(self, slot: int, cond, **fields) -> "Entities":
        upd = {}
        for k, v in fields.items():
            arr = getattr(self, k)
            new = torch.as_tensor(v, device=arr.device).to(arr.dtype)
            new = new.expand(arr.shape[0])
            if cond is not None:
                new = torch.where(cond, new, arr[:, slot])
            col = arr.clone()
            col[:, slot] = new
            upd[k] = col
        return self.replace(**upd)

    def push(self, fields: dict[str, Any], do=None) -> "Entities":
        """Append one entity per env at slot ``count`` (where ``do``);
        drops on overflow like the bounded JAX pool."""
        n = self.count.shape[0]
        dev = self.x.device
        do = (
            torch.ones((n,), dtype=torch.bool, device=dev)
            if do is None else torch.as_tensor(do, device=dev).expand(n)
        )
        ok = do & (self.count < self.cap)
        slots = torch.arange(self.cap, device=dev)
        hit = ok[:, None] & (slots[None, :] == self.count[:, None])
        upd = {}
        for name, v in fields.items():
            arr = getattr(self, name)
            val = torch.as_tensor(v, device=dev).to(arr.dtype)
            val = val.reshape(-1, 1) if val.dim() else val
            upd[name] = torch.where(hit, val, arr)
        return self.replace(count=self.count + ok.to(i32), **upd)

    def push_many(self, fields: dict[str, Any], do: torch.Tensor) -> "Entities":
        """Append up to K entities per env in one placement: ``do`` is a
        bool [N, K] mask and each field value a scalar or an [N, K]
        tensor.  Pushes land in mask order at ``count``, ``count + 1``, ...;
        those past ``cap`` are dropped, as K sequential ``push`` calls
        drop them.  The JAX package places by a one-hot matmul; a scatter
        writes the same values."""
        n, k = do.shape
        dev = self.x.device
        slots = self.count[:, None] + torch.cumsum(do.to(i32), dim=1) - 1
        ok = do & (slots < self.cap)
        # drops go to a spare column past cap, cut off after the scatter
        idx = torch.where(ok, slots, self.cap).long()
        upd = {}
        for name, v in fields.items():
            arr = getattr(self, name)
            val = torch.as_tensor(v, device=dev).to(arr.dtype).expand(n, k)
            wide = torch.cat([arr, arr[:, :1]], dim=1)
            wide.scatter_(1, idx, val.contiguous())
            upd[name] = wide[:, :self.cap]
        return self.replace(count=self.count + ok.sum(dim=1, dtype=i32), **upd)

    # -- bulk ops -----------------------------------------------------------

    def step_all(self) -> "Entities":
        return self.step_masked(self.active)

    def step_masked(self, m: torch.Tensor) -> "Entities":
        """Entity::step (entity.cpp:57-82) where ``m`` ([N, cap])."""
        mv = m & ~self.smart_step
        x = torch.where(mv, self.x + self.vx, self.x)
        y = torch.where(mv, self.y + self.vy, self.y)
        rotation = torch.where(m, self.rotation + self.vrot, self.rotation)
        vx = torch.where(m, self.vx * self.friction, self.vx)
        vy = torch.where(m, self.vy * self.friction, self.vy)
        life = torch.where(m, self.life_time + 1, self.life_time)
        expire = m & (self.expire_time > 0) & (life > self.expire_time)
        will_erase = self.will_erase | expire
        img = torch.where(
            m & (self.type == EXPLOSION) & (self.image_type < EXPLOSION5),
            self.image_type + 1,
            self.image_type,
        )
        rx = torch.where(m, self.rx * self.grow_rate, self.rx)
        ry = torch.where(m, self.ry * self.grow_rate, self.ry)
        alpha = torch.where(m, self.alpha * self.alpha_decay, self.alpha)
        return self.replace(
            x=x, y=y, rotation=rotation, vx=vx, vy=vy, life_time=life,
            will_erase=will_erase, image_type=img, rx=rx, ry=ry, alpha=alpha,
        )

    def compact(self, keep: torch.Tensor) -> "Entities":
        """Stable-erase slots where ``keep`` is False (live slots only):
        kept slots pack to the front in order, the rest follow in order.
        The JAX package permutes by a one-hot matmul; a gather moves the
        same values."""
        keep = keep & self.active
        ki = keep.to(i32)
        new_count = ki.sum(dim=1, dtype=i32)
        newpos = torch.where(
            keep,
            torch.cumsum(ki, dim=1) - 1,
            new_count[:, None] + torch.cumsum(1 - ki, dim=1) - 1,
        ).long()
        src = torch.empty_like(newpos)
        src.scatter_(1, newpos, torch.arange(
            self.cap, device=newpos.device).expand_as(newpos).contiguous())
        upd = {k: getattr(self, k).gather(1, src) for k in SLOT_FIELDS}
        return self.replace(count=new_count, **upd)


def stack_records(recs: list[dict], n: int, device) -> dict:
    """[N, K] tensors, field by field, of K records whose values are
    scalars or [N] tensors (each field in its entity dtype), for
    ``Entities.push_many``.  A field that is a scalar in every record
    becomes one tensor, not K."""
    out = {}
    for k in recs[0]:
        vals = [r[k] for r in recs]
        dt = _dtype(k)
        if any(torch.is_tensor(v) for v in vals):
            out[k] = torch.stack([
                torch.as_tensor(v, device=device).to(dt).expand(n) for v in vals
            ], dim=1)
        else:
            out[k] = torch.tensor(vals, dtype=dt, device=device).expand(n, len(vals))
    return out


def default_fields(x, y, vx, vy, rx, ry, type_) -> dict[str, Any]:
    """Entity constructor defaults (entity.cpp:8-52); ``type_`` is a
    Python int here (the maze slice spawns only static types)."""
    is_expl = type_ == EXPLOSION
    is_trail = type_ == TRAIL
    grow = 1.4 if is_expl else (1.05 if is_trail else 1.0)
    expire = 4 if is_expl else -1
    adecay = 0.8 if is_trail else 1.0
    return dict(
        x=x, y=y, vx=vx, vy=vy, rx=rx, ry=ry, type=type_, image_type=type_,
        image_theme=0, will_erase=False, collides_with_entities=False,
        collision_margin=0.0, rotation=0.0, is_reflected=False, vrot=0.0,
        alpha=1.0, grow_rate=grow, alpha_decay=adecay, fire_time=-1,
        spawn_time=-1, expire_time=expire, life_time=0, health=1.0,
        theta=-100.0, friction=1.0, smart_step=False, avoids_collisions=False,
        auto_erase=True, render_z=0, use_abs_coords=False, climber_spawn_x=0.0,
    )
