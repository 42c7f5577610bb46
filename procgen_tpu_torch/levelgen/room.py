"""Cellular-automata room generation, batched over envs (reference:
procgen/src/roomgen.cpp; JAX counterpart procgen_tpu/levelgen/room.py).

Shared by jumper and caveflyer: CA smoothing, the biggest room by
connected-component labelling, the exact queue-order BFS path, and room
dilation.  Grids are int32 ``[N, dim, dim]`` (rows in ascending y), masks
bool ``[N, dim, dim]`` or flat ``[N, dim * dim]``, cells flat row-major
indices.
"""

from __future__ import annotations

import torch

from ..core.game import first_true

i32 = torch.int32

# the BFS's neighbour push order (dx, dy) (roomgen.cpp:80-84)
PUSH_ORDER = ((-1, 0), (0, -1), (0, 1), (1, 0))
# label propagation rounds between two convergence reads (one host read
# each): a round past the fixed point changes nothing
_CONVERGENCE_CHECK = 4


def _padded(m: torch.Tensor, value) -> torch.Tensor:
    """``m`` [N, dim, dim] with a one-cell border of ``value``."""
    n, h, w = m.shape
    out = torch.full((n, h + 2, w + 2), value, dtype=m.dtype, device=m.device)
    out[:, 1:-1, 1:-1] = m
    return out


def _shifted(p: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = m[y + dy, x + dx] of a ``_padded`` ``m``."""
    h, w = p.shape[1] - 2, p.shape[2] - 2
    return p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def ca_update(grid: torch.Tensor, wall_type: int, space_type: int) -> torch.Tensor:
    """One CA iteration: wall where 5 or more of the 3x3 neighbourhood
    (the cell included) are walls, cells outside the grid counting as
    walls (roomgen.cpp:21-36)."""
    p = _padded((grid == wall_type).to(i32), 1)
    cnt = sum(_shifted(p, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return torch.where(cnt >= 5, wall_type, space_type).to(i32)


def best_room_mask(grid: torch.Tensor, space_type: int):
    """The biggest 4-connected ``space_type`` component (roomgen.cpp:
    126-145): each cell's label becomes the smallest flat index of its
    component, and the room is the smallest label among the largest
    rooms, the C++ rule (rooms are found in ascending order of their first
    cell).  The labels propagate to their neighbours and jump to their
    label's label (each label is a cell of the same component, so both
    keep it one); at a fixed point every cell holds its component's
    smallest index, read every ``_CONVERGENCE_CHECK`` rounds."""
    n, dim, _ = grid.shape
    A = dim * dim
    dev = grid.device
    space = grid == space_type
    idx = torch.arange(A, device=dev).reshape(1, dim, dim)
    labels = torch.where(space, idx, A)
    while True:
        before = labels
        for _ in range(_CONVERGENCE_CHECK):
            p = _padded(labels, A)
            best = labels
            for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                best = torch.minimum(best, _shifted(p, dy, dx))
            best = torch.where(space, best, A).reshape(n, A)
            ext = torch.cat([best, torch.full((n, 1), A, dtype=best.dtype, device=dev)], 1)
            labels = torch.minimum(best, ext.gather(1, best)).reshape(n, dim, dim)
        if bool((labels == before).all()):
            break
    flat = labels.reshape(n, A)
    counts = torch.zeros((n, A + 1), dtype=i32, device=dev)
    counts.scatter_add_(1, flat, space.reshape(n, A).to(i32))
    counts = counts[:, :A]
    best_label = first_true(counts == counts.amax(dim=1, keepdim=True))
    return space & (labels == best_label[:, None, None])


def bfs_path_mask(grid: torch.Tensor, space_type: int, src: torch.Tensor,
                  dst: torch.Tensor) -> torch.Tensor:
    """The C++ path from ``src`` to ``dst`` (roomgen.cpp:71-124), a flat
    bool [N, dim * dim] mask.

    The reference pops one queue cell at a time and pushes its uncovered
    SPACE neighbours in the order of ``PUSH_ORDER``; the path walks the
    parents back from ``dst``.  Here the BFS runs a level at a time: a
    cell's parent is the neighbour of the previous level that comes first
    by (queue position, push order), and the new level's queue positions
    are the ranks of that key, so the parents, and the path, are the
    reference's.  The reference leaves ``src`` uncovered, so its
    neighbours push it again; that second entry pushes nothing (its
    neighbours are covered) and keeps the others' order, so ``src``
    counts as covered here.  The levels run until every env has reached
    ``dst`` or has nothing left to expand (one host read a level); an env
    that never reaches it gets an empty mask."""
    n, dim, _ = grid.shape
    A = dim * dim
    dev = grid.device
    space = (grid == space_type).reshape(n, A)
    cells = torch.arange(A, device=dev)
    cx, cy = cells % dim, cells // dim
    # per push direction d: the cell that pushes cell c (c - offset), and
    # whether it lies in the grid; [A, 4]
    px = torch.stack([cx - dx for dx, _ in PUSH_ORDER], 1)
    py = torch.stack([cy - dy for _, dy in PUSH_ORDER], 1)
    oks = (px >= 0) & (px < dim) & (py >= 0) & (py < dim)
    srcs = py.clamp(0, dim - 1) * dim + px.clamp(0, dim - 1)
    order = torch.arange(4, device=dev)
    big = 4 * A
    src = src.long()
    dst = dst.long()
    rows = torch.arange(n, device=dev)
    covered = torch.zeros((n, A), dtype=torch.bool, device=dev)
    covered[rows, src] = True
    frontier = covered.clone()
    qpos = torch.zeros((n, A), dtype=torch.int64, device=dev)
    parent = torch.full((n, A), -1, dtype=torch.int64, device=dev)
    found = src == dst
    levels = 0
    steps = torch.zeros((n,), dtype=torch.int64, device=dev)  # dst's level
    while True:
        live = ~found & frontier.any(dim=1)
        if not bool(live.any()):
            break
        levels += 1
        # each cell's key (queue position, push order) from every frontier
        # cell that pushes it, the least one winning
        kq = torch.where(frontier, qpos * 4, big)
        k = torch.where(oks, kq[:, srcs] + order, big)  # [N, A, 4]
        key, d = k.min(dim=2)
        new = (key < big) & space & ~covered & live[:, None]
        covered = covered | new
        parent = torch.where(new, srcs.expand(n, A, 4).gather(2, d[..., None])[..., 0], parent)
        qpos = torch.empty_like(qpos).scatter_(
            1, torch.argsort(torch.where(new, key, big), dim=1), cells.expand(n, A).contiguous())
        frontier = new
        reached = new[rows, dst]
        steps = torch.where(reached, levels, steps)
        found = found | reached
    mask = torch.zeros((n, A + 1), dtype=torch.bool, device=dev)
    cur = torch.where(found, dst, -1)
    for _ in range(int(steps.max()) + 1):
        mask[rows, torch.where(cur >= 0, cur, A)] = True
        cur = torch.where(cur >= 0, parent.gather(1, cur.clamp_min(0)[:, None])[:, 0], -1)
    return mask[:, :A]


def expand_mask(mask_flat: torch.Tensor, space_flat: torch.Tensor, n_rounds: int,
                dim: int) -> torch.Tensor:
    """expand_room(set, n) (roomgen.cpp:147-177): ``n_rounds`` rounds of
    8-neighbourhood dilation restricted to SPACE cells; flat [N, dim *
    dim] masks."""
    n = mask_flat.shape[0]
    wide = mask_flat
    curr = mask_flat
    for _ in range(n_rounds):
        p = _padded(curr.reshape(n, dim, dim), False)
        dil = torch.zeros((n, dim, dim), dtype=torch.bool, device=mask_flat.device)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    dil = dil | _shifted(p, dy, dx)
        newly = dil.reshape(n, -1) & space_flat & ~wide
        wide = wide | newly
        curr = newly
    return wide
