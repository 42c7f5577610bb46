"""Kruskal maze generation, batched over envs (reference:
procgen/src/mazegen.cpp; JAX counterpart procgen_tpu/levelgen/maze.py).

The C++ loop draws ``randn(walls.size())`` every iteration and erases that
wall whether or not it is removed, so the draw count equals the wall count.
Every env runs the same static number of iterations (the wall list of the
largest maze); iterations past an env's own wall count are masked off, as
the JAX ``fori_loop`` masks them.  Union-find sets are the per-cell set ids
in ``idxs``; a merge rewrites ids.  The maze grid is flat with the dynamic
stride ``array_dim = maze_dim + 2`` over a static ``(mdim_max+2)^2``
buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rng
from ..core.constants import SPACE, WALL_OBJ
from ..core.game import first_true

i32 = torch.int32

MAZE_OFFSET = 1  # mazegen.h:14


def _wall_candidates(mdim_max: int):
    """Static wall list in C++ construction order (mazegen.cpp:135-149)."""
    walls = []  # (x1, y1, x2, y2, kind, i, j); kind 0 = first loop
    for i in range(1, mdim_max, 2):
        for j in range(0, mdim_max, 2):
            walls.append((i - 1, j, i + 1, j, 0, i, j))
    for i in range(0, mdim_max, 2):
        for j in range(1, mdim_max, 2):
            walls.append((i, j - 1, i, j + 1, 1, i, j))
    return np.asarray(walls, np.int64)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[n, idx[n]] for [N, L] ``a`` and [N] ``idx`` (clamped, as a JAX
    gather clamps)."""
    idx = idx.long().clamp(0, a.shape[1] - 1)
    return a.gather(1, idx[:, None])[:, 0]


def _put(a: torch.Tensor, idx: torch.Tensor, val: torch.Tensor, cond) -> None:
    """In place: a[n, idx[n]] = val[n] where ``cond`` (an out-of-range
    index with ``cond`` False writes back the old value)."""
    idx = idx.long().clamp(0, a.shape[1] - 1)
    old = a.gather(1, idx[:, None])[:, 0]
    a.scatter_(1, idx[:, None], torch.where(cond, val, old).to(a.dtype)[:, None])


def generate_maze(g: rng.MTState, maze_dim: torch.Tensor, mdim_max: int):
    """Returns (g, grid, free_cells, num_free, in_free); ``maze_dim`` is
    int32 [N]; grid is int32 [N, (mdim_max+2)^2] with stride array_dim."""
    dev = maze_dim.device
    n = maze_dim.shape[0]
    adim_max = mdim_max + 2
    array_dim = maze_dim + 2
    mcells = mdim_max * mdim_max

    grid = torch.full((n, adim_max * adim_max), WALL_OBJ, dtype=i32, device=dev)
    _put(grid, MAZE_OFFSET * array_dim + MAZE_OFFSET,
         torch.zeros_like(maze_dim), torch.ones_like(maze_dim, dtype=torch.bool))

    idxs = torch.arange(mcells, dtype=i32, device=dev).repeat(n, 1)
    in_free = torch.zeros((n, mcells), dtype=torch.bool, device=dev)
    num_free = torch.zeros((n,), dtype=i32, device=dev)

    cands = torch.as_tensor(_wall_candidates(mdim_max), device=dev)
    c = [cands[:, j].to(i32) for j in range(7)]
    cx1, cy1, cx2, cy2, kind, ci, cj = c
    md = maze_dim[:, None]
    valid = torch.where(
        kind[None, :] == 0,
        (ci[None, :] < md - 1) & (cj[None, :] < md),
        (ci[None, :] < md) & (cj[None, :] < md - 1),
    )
    # stable compaction keeps C++ ordering among valid walls
    perm = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    wx1, wy1, wx2, wy2 = (a[perm] for a in (cx1, cy1, cx2, cy2))
    wall_count = valid.sum(dim=1, dtype=i32)
    w_static = cands.shape[0]

    assert w_static <= rng.N, "wall list exceeds one MT block"
    g, wall_draws = rng.draw_n(g, w_static, wall_count)

    # per-wall cell indices, in each env's wall order: cells (x1,y1),
    # (x0,y0), (x2,y2) in the maze's cell space and in the grid, where
    # (x0,y0) is the wall between the two cells
    x0w = torch.div(wx1 + wx2, 2, rounding_mode="floor")
    y0w = torch.div(wy1 + wy2, 2, rounding_mode="floor")
    ad = array_dim[:, None]
    walls = torch.stack([
        md * wy1 + wx1, md * y0w + x0w, md * wy2 + wx2,
        (wy1 + MAZE_OFFSET) * ad + (wx1 + MAZE_OFFSET),
        (y0w + MAZE_OFFSET) * ad + (x0w + MAZE_OFFSET),
        (wy2 + MAZE_OFFSET) * ad + (wx2 + MAZE_OFFSET),
    ], dim=2).long()  # [N, W, 6]
    walls[..., :3].clamp_(0, mcells - 1)
    walls[..., 3:].clamp_(0, adim_max * adim_max - 1)

    # free_cells gets a trailing scratch column: writes that JAX drops (no
    # new cell, or past the buffer end) land there
    free_cells = torch.zeros((n, mcells + 1), dtype=i32, device=dev)
    trash = torch.full((n, 3), mcells, dtype=torch.int64, device=dev)
    alive = torch.arange(w_static, device=dev)[None, :] < wall_count[:, None]
    for t in range(w_static):
        live = t < wall_count
        nsel = rng._randn_from(wall_draws[:, t], wall_count - t)

        # select the n-th alive wall in original order, then kill it
        ranks = torch.cumsum(alive.to(i32), dim=1) - 1
        sel = alive & (ranks == nsel[:, None])
        widx = first_true(sel)
        alive = alive & ~sel

        w = walls.gather(1, widx[:, None, None].expand(-1, 1, 6))[:, 0]
        cells, gps = w[:, :3], w[:, 3:]
        s01 = idxs.gather(1, cells[:, 0::2])  # set ids of (x1,y1), (x2,y2)
        s0_idx, s1_idx = s01[:, 0], s01[:, 1]
        old = grid.gather(1, gps)
        can_remove = live & (old[:, 1] == WALL_OBJ) & (s0_idx != s1_idx)
        cr = can_remove[:, None]

        # set_free_cell for the three cells in order (cpp:27-36); they are
        # distinct, so each one's "already free" test reads the old flags
        grid.scatter_(1, gps, torch.where(cr, SPACE, old))
        fl = in_free.gather(1, cells)
        isnew = cr & ~fl
        pos = num_free[:, None] + torch.cumsum(isnew.to(i32), dim=1) - 1
        ok = isnew & (pos < mcells)
        free_cells.scatter_(1, torch.where(ok, pos.long(), trash),
                            cells.to(i32))
        in_free.scatter_(1, cells, fl | isnew)
        num_free = num_free + isnew.sum(dim=1, dtype=i32)

        # merge s0 into s1 (+ the wall cell) — cpp:170-177
        idxs = torch.where(cr & (idxs == s0_idx[:, None]), s1_idx[:, None], idxs)
        _put(idxs, cells[:, 1], s1_idx, can_remove)

    free_cells = free_cells[:, :mcells].contiguous()
    return g, grid, free_cells, num_free, in_free


def place_objects(g, grid, free_cells, num_free, maze_dim, mdim_max: int,
                  start_obj: int, num_objs: int):
    """mazegen.cpp:292-306 — objects on distinct carved cells, excluding
    the agent corner cell (stored cell id 0).  The redraw loop runs while
    any env still needs a draw, each env drawing only while it does (the
    JAX while_loop under vmap)."""
    array_dim = maze_dim + 2
    grid = grid.clone()
    free_cells = free_cells.clone()

    for j in range(num_objs):
        g, m = rng.randn(g, num_free)
        while True:
            v = _take(free_cells, m)
            need = (v == -1) | (v == 0)
            if not bool(need.any()):
                break
            g2, m2 = rng.randn(g, num_free)
            g = rng._sel(need, g2, g)
            m = torch.where(need, m2, m)
        cell = _take(free_cells, m)
        _put(free_cells, m, torch.full_like(m, -1), torch.ones_like(need))
        gp = (torch.div(cell, maze_dim, rounding_mode="floor") + MAZE_OFFSET) * array_dim + (
            torch.remainder(cell, maze_dim) + MAZE_OFFSET
        )
        _put(grid, gp, torch.full_like(gp, start_obj + j), torch.ones_like(need))

    return g, grid, free_cells


def _dead_end_cells(dims, mdim_max: int):
    """The maze cells ``generate_maze_no_dead_ends`` can open a wall at,
    as (x, y) maze coordinates in ascending order, for mazes of the
    sizes ``dims``.  A Kruskal maze carves every room (both coordinates
    even) and never a pillar (both odd); a carved passage between two
    rooms always has those two as SPACE neighbours, so it is never a dead
    end, and a fix opens only a wall next to the cell it fixes.  So only
    rooms can be fixed, and, in a maze of even size, the cells of its last
    row and column, which no wall of the list carves."""
    cells = set()
    for dim in dims:
        for y in range(dim):
            for x in range(dim):
                room = x % 2 == 0 and y % 2 == 0
                strip = dim % 2 == 0 and (x == dim - 1 or y == dim - 1)
                if room or strip:
                    cells.add((y, x))
    assert all(x < mdim_max and y < mdim_max for y, x in cells)
    return [(x, y) for y, x in sorted(cells)]


def generate_maze_no_dead_ends(g: rng.MTState, maze_dim: torch.Tensor, mdim_max: int):
    """mazegen.cpp:190-211: ``generate_maze``, then at every dead end (a
    SPACE cell with one SPACE neighbour and a wall) open one of its walls
    at random, in ascending cell order, later cells seeing earlier
    fixes.  Returns what ``generate_maze`` returns.

    The draws, one a dead end, come from one upfront block of a stream
    (``rng.draw_block``), which then advances by the count consumed.  The
    JAX package walks every cell of the buffer; only the cells of
    ``_dead_end_cells`` can be fixed, so the loop visits those, in the
    same order, each iteration batched over the envs.  Neighbours outside
    the maze's interior read as -1, as there: the walk runs on a copy of
    the grid whose border is -1."""
    g, grid, free_cells, num_free, in_free = generate_maze(g, maze_dim, mdim_max)
    dev = maze_dim.device
    n = maze_dim.shape[0]
    adim_max = mdim_max + 2
    array_dim = (maze_dim + 2)[:, None]

    # the interior of each env's maze in the flat buffer (stride array_dim)
    flat = torch.arange(adim_max * adim_max, device=dev)[None, :]
    fx = torch.remainder(flat, array_dim)
    fy = torch.div(flat, array_dim, rounding_mode="floor")
    interior = ((fx > 0) & (fx < array_dim - 1) & (fy > 0) & (fy < array_dim - 1)
                & (flat < array_dim * array_dim))
    work = torch.where(interior, grid, -1)

    dims = sorted(set(maze_dim.tolist()))
    cells = torch.as_tensor(_dead_end_cells(dims, mdim_max), device=dev)  # [K, 2]
    # get_neighbors order (mazegen.cpp:50-69): the cell, then its four
    offs = torch.as_tensor([(0, 0), (-1, 0), (0, -1), (0, 1), (1, 0)], device=dev)
    px = cells[:, None, 0] + MAZE_OFFSET + offs[None, :, 0]  # [K, 5]
    py = cells[:, None, 1] + MAZE_OFFSET + offs[None, :, 1]
    idx = (py[None] * array_dim[:, :, None] + px[None]).clamp(0, adim_max * adim_max - 1)
    ok = (cells[None, :, 0] < maze_dim[:, None]) & (cells[None, :, 1] < maze_dim[:, None])

    draws, ctx = rng.draw_block(g, rng.N)
    cursor = torch.zeros((n,), dtype=i32, device=dev)
    for k in range(cells.shape[0]):
        v = work.gather(1, idx[:, k])  # [N, 5]
        nb = v[:, 1:]
        wall = nb == WALL_OBJ
        n_wall = wall.sum(dim=1, dtype=i32)
        fix = (ok[:, k] & (v[:, 0] == SPACE) & ((nb == SPACE).sum(dim=1) == 1)
               & (n_wall > 0))
        word = draws.gather(1, cursor.clamp(0, rng.N - 1).long()[:, None])[:, 0]
        r = rng._randn_from(word, n_wall.clamp_min(1))
        cursor = cursor + fix.to(i32)
        sel = first_true(wall & (torch.cumsum(wall.to(i32), dim=1) - 1 == r[:, None]))
        tgt = idx[:, k, 1:].gather(1, sel[:, None])
        old = work.gather(1, tgt)
        work.scatter_(1, tgt, torch.where(fix[:, None], SPACE, old))
    grid = torch.where(interior, work, grid).to(i32)
    return rng.advance_block(g, ctx, cursor), grid, free_cells, num_free, in_free


def _neighbour_index(n: int, A: int, shift, dev) -> torch.Tensor:
    """Gather indices [N, A] of ``jnp.roll(m, shift)`` along a flat axis
    of length ``A``: ``roll(m, k)[i] = m[(i - k) mod A]``, ``shift`` an
    int or int [N]."""
    shift = torch.as_tensor(shift, device=dev).reshape(-1, 1).long()
    return torch.remainder(torch.arange(A, device=dev)[None, :] - shift, A).expand(n, A)


def _flat_neighbours(n: int, A: int, array_dim: torch.Tensor):
    """The gather indices of the four flat-buffer neighbours, in the order
    left, up, down, right: rolls by 1, ``array_dim``, ``-array_dim`` and
    -1 over the buffer's length, wrapping as ``jnp.roll`` wraps (the
    interior mask keeps a wrapped neighbour from counting)."""
    dev = array_dim.device
    return [_neighbour_index(n, A, k, dev) for k in (1, array_dim, -array_dim, -1)]


def _any_neighbour(m: torch.Tensor, nbrs) -> torch.Tensor:
    out = torch.zeros_like(m)
    for idx in nbrs:
        out = out | m.gather(1, idx)
    return out


def _expand_to_type(grid, s0, s1, target_type: int, interior, array_dim, nbrs, do):
    """mazegen.cpp:72-101 (JAX: procgen_tpu/levelgen/maze.py:191-253),
    batched: a BFS from ``s0`` over the maze's SPACE, accumulating ``s1``, that
    stops at the first frontier cell (ascending) with a neighbour of
    ``target_type``; the frontier cells after that one add no neighbours.
    Each env runs its own number of rounds; the loop runs while any env
    has not stopped (one host read a round), a stopped env's frontier
    empty, so that its rounds change nothing.  Returns (s1, found,
    rounds): ``found`` the hit cell's first target neighbour in the order
    left, up, down, right, or -1."""
    n, A = grid.shape
    dev = grid.device
    tmask = (grid == target_type) & interior
    has_t = _any_neighbour(tmask, nbrs)
    free = (grid == SPACE) & interior & ~s0
    do = torch.as_tensor(do, device=dev).expand(n)
    curr = s0 & do[:, None]
    stop = ~do
    hits = torch.zeros_like(curr)  # the frontier's hits in the round an env stopped on one
    rounds = 0
    while not bool(stop.all()):
        rounds += 1
        hit = curr & has_t
        any_hit = hit.any(dim=1)
        # the frontier up to its first hit
        processed = curr & (torch.cumsum(hit, dim=1) - hit.to(torch.int64) == 0)
        newly = _any_neighbour(processed, nbrs) & free & ~s1
        s1 = s1 | newly
        hits = torch.where(any_hit[:, None], hit, hits)
        stop = stop | any_hit | ~newly.any(dim=1)
        curr = newly & ~stop[:, None]
    ad = array_dim[:, None].long()
    f = first_true(hits)[:, None]
    nb = torch.cat([f - 1, f - ad, f + ad, f + 1], dim=1).clamp(0, A - 1)
    found = nb.gather(1, first_true(tmask.gather(1, nb))[:, None])[:, 0].to(i32)
    return s1, torch.where(hits.any(dim=1), found, -1), rounds


def generate_maze_with_doors(g: rng.MTState, maze_dim: torch.Tensor, mdim_max: int,
                             num_doors: torch.Tensor, stats: dict = None):
    """mazegen.cpp:213-290 (JAX: procgen_tpu/levelgen/maze.py:256-365),
    batched over envs: a Kruskal maze; ``num_doors`` doors at forks
    (``choose_n``, which draws nothing when the forks are fewer: then all
    become doors); the agent on a SPACE cell with no door beside it, by
    rejection (masked rounds, one host read each); then for each door the
    BFS ``_expand_to_type`` colours the door it reaches, and a key of
    that colour goes on a random cell of the region it covered; the exit
    last.  ``maze_dim`` and ``num_doors`` are int32 [N].  Returns (g,
    grid, actual_num_doors), the grid flat with stride ``maze_dim + 2``;
    with ``stats``, the BFS rounds run are added to ``stats["rounds"]``."""
    from ..core.constants import AGENT_OBJ, DOOR_OBJ, EXIT_OBJ, KEY_OBJ

    g, grid, _, _, _ = generate_maze(g, maze_dim, mdim_max)
    n, A = grid.shape
    dev = grid.device
    array_dim = maze_dim + 2
    idxs = torch.arange(A, device=dev)[None, :]
    ad = array_dim[:, None]
    x = torch.remainder(idxs, ad)
    y = torch.div(idxs, ad, rounding_mode="floor")
    interior = (x > 0) & (x < ad - 1) & (y > 0) & (y < ad - 1) & (idxs < ad * ad)
    nbrs = _flat_neighbours(n, A, array_dim)

    def nb_count(m):
        return sum(m.gather(1, idx).to(i32) for idx in nbrs)

    def pick(m, r):
        """The ``r``-th (per env) True cell of ``m``, ascending."""
        ranks = torch.cumsum(m.to(i32), dim=1) - 1
        return first_true(m & (ranks == r[:, None]))

    space = (grid == SPACE) & interior
    forks = space & (nb_count(space) > 2)
    fsize = forks.sum(dim=1, dtype=i32)

    # choose_n(forks, num_doors) (randgen.cpp:49-68)
    take_all = num_doors > fsize
    alive = forks.clone()
    chosen = torch.zeros_like(forks)
    for j in range(3):
        do = ~take_all & (j < num_doors)
        cnt = alive.sum(dim=1, dtype=i32)
        g2, r = rng.randn(g, cnt.clamp_min(1))
        g = rng._sel(do, g2, g)
        p = pick(alive, r)
        _put(chosen, p, torch.ones_like(do), do)
        _put(alive, p, torch.zeros_like(do), do)
    chosen = torch.where(take_all[:, None], forks, chosen)
    actual_doors = torch.where(take_all, fsize, num_doors).to(i32)
    grid = torch.where(chosen, DOOR_OBJ, grid).to(i32)

    # the agent cell: a random SPACE cell with no door beside it (cpp:245-258)
    space2 = (grid == SPACE) & interior
    cnt2 = space2.sum(dim=1, dtype=i32).clamp_min(1)
    door_adj = nb_count((grid == DOOR_OBJ) & interior) > 0
    g, r = rng.randn(g, cnt2)
    cell = pick(space2, r)
    while True:
        need = _take(door_adj, cell)
        if not bool(need.any()):
            break
        g2, r = rng.randn(g, cnt2)
        g = rng._sel(need, g2, g)
        cell = torch.where(need, pick(space2, r), cell)
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    _put(grid, cell, torch.full_like(cell, AGENT_OBJ), ones)

    # each door's region, its colour and key; the exit last
    s0 = torch.zeros((n, A), dtype=torch.bool, device=dev)
    _put(s0, cell, ones, ones)
    rounds = 0
    for door_num in range(4):  # at most 3 doors, then the exit's round
        it_on = door_num < actual_doors + 1
        do_door = door_num < actual_doors
        s1 = torch.zeros_like(s0)
        s1, found, k = _expand_to_type(grid, s0, s1, DOOR_OBJ, interior, array_dim, nbrs,
                                       do_door)
        rounds += k
        ok_found = do_door & (found >= 0)
        fcell = found.clamp_min(0)
        _put(grid, fcell, torch.full_like(fcell, DOOR_OBJ + door_num + 1), ok_found)
        s0 = s0 | (s1 & do_door[:, None])

        s1, _, k = _expand_to_type(grid, s0, s1, -999, interior, array_dim, nbrs, it_on)
        rounds += k
        g2, r1 = rng.randn(g, s1.sum(dim=1, dtype=i32).clamp_min(1))
        g = rng._sel(it_on, g2, g)
        key_cell = pick(s1, r1)
        val = torch.where(door_num == actual_doors, EXIT_OBJ, KEY_OBJ + door_num + 1)
        _put(grid, key_cell, val, it_on)
        s0 = s0 | (s1 & it_on[:, None])
        _put(s0, fcell, torch.ones_like(ok_found), ok_found)
    if stats is not None:
        stats["rounds"] = stats.get("rounds", 0) + rounds
    return g, grid, actual_doors
